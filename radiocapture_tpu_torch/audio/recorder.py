"""Per-call voice recorder — the reference's ``logging_receiver``
(logging_receiver.py:43-661) re-architected for the batched pipelines.

The reference builds one GNU Radio flowgraph per call. Here the overseer
owns the batched voice pipelines; a ``CallRecorder`` claims a channel
slot and is *fed* that slot's per-block outputs:

- analog modulations (``analog``, ``analog_edacs``): ``feed_audio(audio,
  power)`` — squelch-gated (power mask, replacing ``pwr_squelch_cc``),
  rational-resampled to 8 kHz, streamed to the wav sink.
- P25 (``p25``, ``p25_tdma``, ``p25_cqpsk``, ``p25_cqpsk_tdma``):
  ``feed_dibits(dibits)`` — framed, LDU/TLC parsed; LDU link-control
  keep-alives and TLC terminations publish to ``/topic/raw_voice/<uuid>``
  exactly like the reference's ``p25_sensor`` thread
  (logging_receiver.py:381-473); IMBE voice codewords go through the
  pluggable vocoder to PCM (and to a ``.imbe`` sidecar when no vocoder
  is installed). TDMA slots select frames by slot id with the
  ``p25p2_lfsr`` keystream for descrambling.
- ``provoice`` / ``dsd_p25``: the reference shells out to DSD
  (logging_receiver.py:334-351); gated the same way — without a decoder
  the raw bits are preserved in a sidecar.

``close(patches)`` finalizes the wav, runs sox/lame/id3v2 post-processing
and emits the durable ``/queue/call_management/call_complete`` event
(logging_receiver.py:524-553).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from radiocapture_tpu_torch.audio import postproc
from radiocapture_tpu_torch.audio.wav import WavWriter
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.protocol import p25 as P

log = logging.getLogger(__name__)

P25_MODS = ("p25", "p25_cqpsk", "p25_tdma", "p25_cqpsk_tdma")
TDMA_MODS = ("p25_tdma", "p25_cqpsk_tdma")


class Vocoder:
    """IMBE 7200x4400 decode interface (op25 ``repeater.vocoder`` role,
    logging_receiver.py:253). ``decode(codeword144) -> 160 int16 PCM
    samples at 8 kHz`` per voice frame. The default implementation is
    unavailable; installs (e.g. the C++ host decoder) register via
    ``set_default_vocoder``."""

    available = False

    def decode(self, codeword144: np.ndarray) -> np.ndarray:
        raise NotImplementedError("no IMBE vocoder installed")


_default_vocoder: Vocoder | None = None


def set_default_vocoder(v: Vocoder | None) -> None:
    global _default_vocoder
    _default_vocoder = v


def get_default_vocoder() -> Vocoder | None:
    return _default_vocoder


class CallRecorder:
    AUDIO_RATE = 8000

    def __init__(self, cdr: dict, bus, audio_dir: str = "audio",
                 channel_fs: float = 25000.0, squelch_db: float = -40.0,
                 vocoder: Vocoder | None = None,
                 keep_wav: bool = False,
                 now_fn=time.time):
        self.cdr = dict(cdr)
        self.bus = bus
        self.audio_dir = audio_dir
        self.channel_fs = channel_fs
        self.squelch_pow = 10.0 ** (squelch_db / 10.0)
        self.vocoder = vocoder if vocoder is not None \
            else get_default_vocoder()
        self.keep_wav = keep_wav
        self.now = now_fn
        self.modulation = cdr.get("modulation_type", "analog")
        self.instance_uuid = cdr["instance_uuid"]
        self.call_uuid = cdr["call_uuid"]
        self.time_last_activity = self.now()
        self.errors = 0.0
        self.closed = False
        self.wav: WavWriter | None = None
        self.filename = postproc.audio_path(
            audio_dir, self.instance_uuid, cdr["system_group_local"],
            self.call_uuid, cdr.get("time_open", self.now()))

        self._resample_state = None
        self._resample_taps = None
        self._imbe_frames: list[np.ndarray] = []
        self._slot = int(cdr.get("slot", 0) or 0)
        self._framer = None
        self._tdma = None
        self._provoice = None
        if self.modulation == "provoice":
            # EDACS digital voice: sync + codeword extraction on the
            # 9600 Bd bit stream (demod.provoice; the reference shells
            # out to DSD here, logging_receiver.py:334-351).
            from radiocapture_tpu_torch.demod.provoice import ProVoiceReceiver
            self._provoice = ProVoiceReceiver()
        elif self.modulation in TDMA_MODS:
            # Phase 2: slot-selective burst receiver with the scrambler
            # seeded from the call's (NAC, SYSID, WACN). CDR keys follow
            # the reference's wire format (p25_call_manager.py:212-214:
            # p25_nac/p25_system_id/p25_wacn; read at
            # logging_receiver.py:116); bare names accepted as fallback.
            from radiocapture_tpu_torch.demod.tdma import TdmaVoiceReceiver

            def _k(*names):
                for n in names:
                    v = cdr.get(n)
                    if v:
                        # site_detail carries WACN/SysID as hex strings
                        # (engines.py NET_STS handler, mirroring the
                        # reference's hex() formatting)
                        return int(v, 0) if isinstance(v, str) else int(v)
                return 0
            self._tdma = TdmaVoiceReceiver(
                _k("p25_nac", "nac"),
                _k("p25_system_id", "sysid"),
                _k("p25_wacn", "wacn"), self._slot)
        elif self.modulation in P25_MODS:
            self._framer = Framer()

    # ---- lifecycle ----
    def open(self) -> "CallRecorder":
        self.wav = WavWriter(self.filename, self.AUDIO_RATE)
        log.info("OPEN %s %s -> %s", self.instance_uuid, self.call_uuid,
                 self.filename)
        return self

    def activity(self) -> None:
        self.time_last_activity = self.now()

    # ---- analog path ----
    def feed_audio(self, audio: np.ndarray, power: float) -> None:
        """One block of channel-rate demodulated audio + its mean IQ
        power (the squelch meter from AnalogVoicePipeline)."""
        if self.closed or self.wav is None:
            return
        audio = np.asarray(audio, np.float32)
        if power < self.squelch_pow:
            audio = np.zeros_like(audio)   # gated, like pwr_squelch
        else:
            self.activity()
        self.wav.write(self._to_8k(audio))

    def _to_8k(self, audio: np.ndarray) -> np.ndarray:
        """Rational resample channel_fs → 8 kHz + the voice band-pass
        (300 Hz high-pass, logging_receiver.py:215, + 3.4 kHz low-pass),
        staging a remainder so every processed chunk satisfies
        ``len * interp % decim == 0`` (the streaming resampler's
        static-shape contract). The band-pass runs HERE, per active
        call at 8 kHz — exactly where the reference's per-call
        flowgraph ran it — instead of per slot at channel rate in the
        batched pipeline (PERF.md §11). The resampler runs on CPU tensors:
        the audio is already on the host, and a device kernel would add
        a host → device → host round trip per call per block."""
        from radiocapture_tpu_torch.ops import resample as R
        import torch
        interp, decim = R.resample_ratio(self.channel_fs, self.AUDIO_RATE)
        if self._resample_taps is None:
            self._resample_taps = R.design_resampler_taps(interp, decim)
            self._resample_state = R.resampler_init(self._resample_taps,
                                                    interp)
            self._stage = np.zeros(0, np.float32)
            from radiocapture_tpu_torch.ops.taps import voice_bandpass
            self._post_taps = voice_bandpass(float(self.AUDIO_RATE))
            self._post_hist = np.zeros(len(self._post_taps) - 1,
                                       np.float32)
        # Chunk granularity: smallest L with L*interp % decim == 0.
        import math
        gran = decim // math.gcd(interp, decim)
        x = np.concatenate([self._stage, audio])
        usable = (len(x) // gran) * gran
        self._stage = x[usable:]
        if usable == 0:
            return np.zeros(0, np.float32)
        st, y = R.rational_resample(self._resample_state,
                                    torch.from_numpy(x[:usable]),
                                    torch.from_numpy(self._resample_taps),
                                    interp, decim)
        self._resample_state = st
        # streaming voice band-pass at 8 kHz (history-carried FIR)
        z = np.concatenate([self._post_hist, y.numpy()])
        out = np.convolve(z, self._post_taps, "valid")
        self._post_hist = z[len(z) - (len(self._post_taps) - 1):]
        return out.astype(np.float32)

    # ---- P25 digital path ----
    def feed_dibits(self, dibits: np.ndarray) -> None:
        if self.closed:
            return
        if self._provoice is not None:
            if self._provoice.feed(np.asarray(dibits, np.uint8)):
                self.activity()
            self.errors = float(self._provoice.sync_losses)
            return
        if self._tdma is not None:
            was_ended = self._tdma.ended
            if self._tdma.feed(np.asarray(dibits, np.uint8)):
                self.activity()
            self.errors = float(self._tdma.errors)
            if self._tdma.ended and not was_ended:
                # MAC END_PTT/IDLE on our slot's SACCH is the Phase 2
                # call termination — publish it in the same TLC shape
                # the call manager's early-close path consumes (the
                # reference's p25_sensor does this for Phase 1 TLC,
                # logging_receiver.py:465-470).
                self._publish_voice_raw(
                    {"short": "TLC",
                     "lc": {"lcf_long":
                            "Call Termination / Cancellation"}})
            return
        if self._framer is None:
            return
        for fb in self._framer.feed(np.asarray(dibits, np.uint8)):
            try:
                fr = P.parse_frame(fb)
            except Exception:
                self.errors += 1
                continue
            self._handle_frame(fr)

    def _handle_frame(self, fr) -> None:
        self.errors += fr.errors
        if fr.duid in (P.DUID_LDU1, P.DUID_LDU2):
            self.activity()
            if fr.duid == P.DUID_LDU1 and "lc" in fr.fields:
                self._publish_voice(fr, fr.fields["lc"])
            for vc in fr.fields.get("vc", []):
                self._voice_codeword(vc)
        elif fr.duid == P.DUID_TLC:
            lc = fr.fields.get("lc", {})
            self._publish_voice(fr, lc)

    def _publish_voice(self, fr, lc: dict) -> None:
        """raw_voice event, same shape the call manager consumes
        (p25_call_manager.py:347-372; emitted by the reference's
        p25_sensor at logging_receiver.py:431-470)."""
        self._publish_voice_raw({"short": fr.short, "lc": lc})

    def _publish_voice_raw(self, packet: dict) -> None:
        self.bus.send_event_lazy(
            f"/topic/raw_voice/{self.instance_uuid}",
            {"instance_uuid": self.instance_uuid,
             "call_uuid": self.call_uuid,
             "packet": packet})

    def _voice_codeword(self, vc: np.ndarray) -> None:
        self._imbe_frames.append(np.asarray(vc, np.uint8))
        if self.wav is None:
            return
        if self.vocoder is not None and self.vocoder.available:
            try:
                pcm = self.vocoder.decode(vc)
                self.wav.write_pcm16(pcm)
                return
            except Exception:
                self.errors += 1


    def _write_codeword_sidecar(self, ext: str, frames: list,
                                meta: dict) -> None:
        """Packed raw codewords + a self-describing JSON companion
        (counts, sizes, per-modulation fields)."""
        import json as _json
        sidecar = self.filename[:-4] + ext
        np.packbits(np.concatenate(frames)).tofile(sidecar)
        with open(sidecar + ".json", "w") as f:
            _json.dump({"codewords": len(frames), **meta}, f)

    # ---- teardown ----
    def close(self, patches: dict | None = None) -> dict:
        """Finalize; returns the completed CDR. Emits call_complete."""
        if self.closed:
            return self.cdr
        self.closed = True
        self.cdr["time_close"] = self.now()
        if self.modulation in P25_MODS:
            self.cdr["errors"] = self.errors
            if self._imbe_frames and (self.vocoder is None or
                                      not self.vocoder.available):
                sidecar = self.filename[:-4] + ".imbe"
                np.packbits(np.concatenate(self._imbe_frames)).tofile(
                    sidecar)
        if self._provoice is not None:
            # IMBE 7100x4400 synthesis is out of scope (the native
            # vocoder is 7200x4400); structured codewords + counts keep
            # the recording's evidentiary value.
            self.cdr["provoice_superframes"] = self._provoice.superframes
            self.cdr["provoice_codewords"] = len(
                self._provoice.voice_frames)
            self.cdr["provoice_variant"] = self._provoice.variant
            # measured inter-sync cadence (self-calibrated when the
            # stream contradicts the reconstructed 768-bit superframe)
            self.cdr["provoice_cadence_bits"] = \
                self._provoice.cadence_bits
            self.cdr["provoice_cadence_adapted"] = \
                self._provoice.cadence_adapted
            self.cdr["errors"] = self.errors
            if self._provoice.voice_frames:
                self._write_codeword_sidecar(
                    ".pv", self._provoice.voice_frames, {
                        "variant": self._provoice.variant,
                        "cadence_bits": self._provoice.cadence_bits,
                        "cadence_adapted":
                            self._provoice.cadence_adapted,
                        "superframes": self._provoice.superframes,
                        "codeword_bits": 168})
        if self._tdma is not None and self._tdma.voice_frames:
            # AMBE+2 audio decode is out of scope (imbe.h); keep the raw
            # voice codewords so the recording retains evidentiary value.
            self._write_codeword_sidecar(
                ".vb", self._tdma.voice_frames, {
                    "slot": self._slot,
                    "codeword_bits": 72,
                    "algid": (self._tdma.ess or {}).get("algid"),
                    "keyid": (self._tdma.ess or {}).get("keyid")})
            self.cdr["errors"] = self.errors
        if self._tdma is not None and self._tdma.ess is not None:
            # ESS-A from the slot's 2V bursts: tag encrypted calls at
            # capture time (ALGID 0x80 = clear per TIA-102; anything
            # else means the .vb sidecar holds ciphertext). Evidentiary
            # metadata the reference never extracted.
            self.cdr["algid"] = self._tdma.ess["algid"]
            self.cdr["keyid"] = self._tdma.ess["keyid"]
            self.cdr["p25_mi"] = f"0x{self._tdma.ess['mi']:018x}"
        filename = self.filename
        if self.wav is not None:
            self.wav.close()
            filename = postproc.process_call_audio(
                self.filename, self.cdr, patches or {},
                keep_wav=self.keep_wav)
        self.bus.send_event_hopeful(
            "/queue/call_management/call_complete",
            {"cdr": self.cdr, "filename": filename,
             "uuid": self.call_uuid})
        log.info("CLOSE %s %s (%s)", self.instance_uuid, self.call_uuid,
                 filename)
        return self.cdr
