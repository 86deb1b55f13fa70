"""Offline decode of a recorded IQ capture to an 8 kHz wav (port of
``radiocapture_tpu.tools.file_to_wav``).

Replaces the reference's ``file_to_wav.py`` (:36-122) — the only
reference path runnable with no radio hardware (SURVEY.md §4): a
recorded complex64 ``.dat`` is channel-extracted, then either NBFM
audio-demodulated (deemphasis + band-pass, file_to_wav.py:106-122) or
P25 C4FM-demodulated into IMBE voice frames (file_to_wav.py:61-105),
and written as 8 kHz mono PCM. The pipelines run on the first CUDA
device (the bank, the voice and the fsk tracker kernels) unless the
caller passes another ``device``; the capture goes there in float32
wire blocks of ``decim·1024`` samples.

Also usable as a CLI:
    python -m radiocapture_tpu_torch.tools.file_to_wav in.dat out.wav \
        --samp-rate 2400000 --offset -500000 --modulation analog
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from radiocapture_tpu_torch.audio.wav import WavWriter
from radiocapture_tpu_torch.audio.recorder import get_default_vocoder
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.device import resolve, wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                      ControlPipeline)
from radiocapture_tpu_torch.protocol import p25 as P

AUDIO_RATE = 8000


def read_iq(path: str) -> np.ndarray:
    """complex64 .dat (GR file_sink layout, file_to_wav.py:40)."""
    return np.fromfile(path, np.complex64)


def _resample_8k(audio: np.ndarray, from_rate: float) -> np.ndarray:
    from scipy import signal as _sig
    import math
    up, down = int(AUDIO_RATE), int(round(from_rate))
    g = math.gcd(up, down)
    return _sig.resample_poly(audio, up // g, down // g)


def _blocks(pipe, iq: np.ndarray, offset_hz: float, samp_rate: float,
            dev):
    """(offsets [1, 1] on ``dev``, the block length decim·1024, and the
    capture as float32 [T, 2] re/im)."""
    offs = torch.as_tensor(
        np.asarray([[offset_hz / samp_rate]], np.float32), device=dev)
    x = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    return offs, pipe.decim * 1024, x


def decode_analog(iq: np.ndarray, samp_rate: float, offset_hz: float = 0.0,
                  device=None) -> np.ndarray:
    """NBFM chain → 8 kHz float audio (file_to_wav.py:106-122)."""
    dev = resolve(device)
    pipe = AnalogVoicePipeline(num_slots=1, samp_rate=samp_rate)
    state = pipe.init(1, dev)
    offs, blk, x = _blocks(pipe, iq, offset_hz, samp_rate, dev)
    chunks = []
    for i in range(len(iq) // blk):
        state, (audio, _power) = pipe.step(
            state, wire_from_numpy(x[None, i * blk:(i + 1) * blk], dev),
            offs)
        chunks.append(audio[0, 0].cpu().numpy())
    if not chunks:
        return np.zeros(0, np.float32)
    y = _resample_8k(np.concatenate(chunks), pipe.channel_fs)
    # voice band-pass at 8 kHz: the pipeline does not band-pass per slot
    # (it's per-call work, CallRecorder._to_8k does it in the capture
    # path), so the offline chain applies the same 300 Hz HP + 3.4 kHz LP
    # here (reference file_to_wav.py:106-122 filters too: CTCSS/PL tones
    # and discriminator DC must not reach the wav).
    from radiocapture_tpu_torch.ops.taps import voice_bandpass
    bp = voice_bandpass(float(AUDIO_RATE))
    return np.convolve(y, bp, "same").astype(np.float32)


def decode_p25(iq: np.ndarray, samp_rate: float, offset_hz: float = 0.0,
               vocoder=None, device=None) -> tuple[np.ndarray, dict]:
    """C4FM chain → voice frames (+ PCM when a vocoder is installed)
    (file_to_wav.py:61-105). Returns (audio8k, stats)."""
    dev = resolve(device)
    pipe = ControlPipeline.p25_c4fm(num_slots=1, samp_rate=samp_rate)
    state = pipe.init(1, dev)
    offs, blk, x = _blocks(pipe, iq, offset_hz, samp_rate, dev)
    framer = Framer()
    if vocoder is None:
        vocoder = get_default_vocoder()
    if vocoder is None:
        # The reference always voice-decodes this path (file_to_wav.py:92,
        # op25 repeater.vocoder); build/load the in-repo native vocoder.
        try:
            from radiocapture_tpu_torch.audio.imbe import ImbeVocoder
            vocoder = ImbeVocoder()
        except Exception:
            vocoder = None      # g++ missing: frame stats only
    pcm: list[np.ndarray] = []
    stats = {"frames": 0, "ldu": 0, "imbe": 0, "errors": 0}
    for i in range(len(iq) // blk):
        state, (_syms, valid, dib) = pipe.step(
            state, wire_from_numpy(x[None, i * blk:(i + 1) * blk], dev),
            offs)
        v = valid[0, 0].cpu().numpy().astype(bool)
        for fb in framer.feed(dib[0, 0].cpu().numpy()[v].astype(np.uint8)):
            stats["frames"] += 1
            try:
                fr = P.parse_frame(fb)
            except Exception:
                stats["errors"] += 1
                continue
            stats["errors"] += fr.errors
            if fr.duid in (P.DUID_LDU1, P.DUID_LDU2):
                stats["ldu"] += 1
                for vc in fr.fields.get("vc", []):
                    stats["imbe"] += 1
                    if vocoder is not None and vocoder.available:
                        try:
                            pcm.append(vocoder.decode(vc))
                        except Exception:
                            stats["errors"] += 1
    audio = (np.concatenate(pcm).astype(np.float32) / 32768.0
             if pcm else np.zeros(0, np.float32))
    return audio, stats


def file_to_wav(in_path: str, out_path: str, samp_rate: float,
                offset_hz: float = 0.0, modulation: str = "analog",
                device=None) -> dict:
    dev = resolve(device)
    iq = read_iq(in_path)
    if modulation == "analog":
        audio = decode_analog(iq, samp_rate, offset_hz, device=dev)
        stats = {"samples": len(audio)}
    elif modulation in ("p25", "c4fm"):
        audio, stats = decode_p25(iq, samp_rate, offset_hz, device=dev)
    else:
        raise ValueError("modulation must be analog|p25 (provoice needs "
                         "the optional DSD host decoder, not bundled)")
    w = WavWriter(out_path, AUDIO_RATE)
    w.write(audio)
    w.close()
    stats["duration_s"] = len(audio) / AUDIO_RATE
    return stats


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--samp-rate", type=float, required=True)
    ap.add_argument("--offset", type=float, default=0.0,
                    help="channel offset from capture center, Hz")
    ap.add_argument("--modulation", default="analog",
                    choices=["analog", "p25", "c4fm"])
    args = ap.parse_args(argv)
    stats = file_to_wav(args.input, args.output, args.samp_rate,
                        args.offset, args.modulation, device=device)
    print(stats)


if __name__ == "__main__":
    main()
