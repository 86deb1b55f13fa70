"""Fixture streams with known content, and the decode that checks them:
P25 TSDU dibit streams carrying numbered grants, the impaired CQPSK
modulations of the JAX package's ``tests/test_cqpsk_chain.py``, a Phase 2
TDMA superframe, and the channel-rate IQ of two granted calls for the
site runtime (P25 C4FM voice, EDACS analog). Numpy only, built from the
port's copies of the protocol modules, so ``chip_smoke.py`` and the card
tests run where JAX is not installed.
"""

from __future__ import annotations

import numpy as np

from radiocapture_tpu_torch.demod import tdma
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.fec import bits
from radiocapture_tpu_torch.protocol import edacs, p25
from radiocapture_tpu_torch.testing import modulators as M

#: (NAC, system ID, WACN) of the TDMA fixture: the scrambler's seed
TDMA_KEY = (0x293, 0x2C1, 0xBEE00)
CQPSK_FIXTURES = ("clean", "offset_noise", "clock_drift")


def p25_control_stream(n_frames: int, nac: int = 0x293,
                       channel: int = 0x2000, group: int = 200,
                       source: int = 777000):
    """TSDU frames, each a GRP_V_CH_GRANT numbered from (channel, group,
    source) and an RFSS_STS_BCST. Returns (dibits, expected grants)."""
    frames, expected = [], []
    for i in range(n_frames):
        t1 = p25.pack_tsbk("GRP_V_CH_GRANT", mfid=0, **{
            "Service Options": 0, "Channel": channel + i,
            "Group Address": group + i, "Source Address": source + i})
        t2 = p25.pack_tsbk("RFSS_STS_BCST", mfid=0, **{
            "LRA": 1, "System ID": 0x2C1, "RF Sub-system ID": 3,
            "Site ID": 12, "Channel": 0x2100, "System Service Class": 0x70})
        frames.append(p25.build_tsdu_frame(nac, [t1, t2]))
        expected.append((channel + i, group + i, source + i))
    return bits.bits_to_dibits(np.concatenate(frames)), expected


def grants(dibits: np.ndarray, nac: int | None = None) -> list:
    """(channel, group, source) of every CRC-clean GRP_V_CH_GRANT in a
    dibit stream (of frames with ``nac``, if given)."""
    out = []
    for fb in Framer().feed(np.asarray(dibits, np.uint8)):
        fr = p25.parse_frame(fb)
        if nac is not None and fr.nac != nac:
            continue
        out.extend((t["Channel"], t["Group Address"], t["Source Address"])
                   for t in fr.tsbks
                   if t.get("crc") == 0 and t["name"] == "GRP_V_CH_GRANT")
    return out


def cqpsk_fixture(kind: str, fs: float = 25000.0):
    """The CQPSK control-channel fixtures of test_cqpsk_chain.py at
    ``fs``: "clean" (6 frames), "offset_noise" (8 frames, +400 Hz, 15 dB
    SNR), "clock_drift" (8 frames, 0.05% symbol-clock error). Returns
    (iq complex64, expected grants)."""
    if kind == "clean":
        dib, expected = p25_control_stream(6)
        return M.cqpsk_modulate(dib, fs=fs), expected
    dib, expected = p25_control_stream(8)
    if kind == "offset_noise":
        return M.awgn(M.freq_shift(M.cqpsk_modulate(dib, fs=fs), fs, 400.0),
                      15.0), expected
    if kind == "clock_drift":
        return M.cqpsk_modulate(dib, fs=fs * 1.0005), expected
    raise ValueError(f"unknown CQPSK fixture {kind!r}")


def tdma_superframe(seed: int = 5):
    """One scrambled Phase 2 superframe (with lead-in) carrying 18 random
    voice codewords per TDMA channel. Returns (dibits, voice)."""
    rng = np.random.default_rng(seed)
    voice = {c: [rng.integers(0, 2, 72).astype(np.uint8) for _ in range(18)]
             for c in (0, 1)}
    return tdma.build_tdma_stream(*TDMA_KEY, voice), voice


def tdma_bursts(dibits: np.ndarray, framer=None) -> list:
    """(seq, kind, slot, voice codewords) of every burst a TdmaFramer
    (the port's copy unless ``framer`` is given) frames from ``dibits``."""
    framer = framer or tdma.TdmaFramer(*TDMA_KEY)
    return [(b.seq, b.kind, b.slot, [v.tolist() for v in b.voice])
            for b in framer.feed(np.asarray(dibits, np.uint8))]


def tdma_voice_ok(bursts: list, voice: dict) -> bool:
    """All 12 bursts of the superframe, each channel's voice codewords
    as sent."""
    rx = {0: [], 1: []}
    for _, _, slot, vcs in bursts:
        rx[slot].extend(vcs)
    return len(bursts) == 12 and all(
        rx[c] == [v.tolist() for v in voice[c]] for c in (0, 1))


def p25_voice_call(vc_freq: float, seconds: float, group: int = 500,
                   source: int = 42, nac: int = 0x293, seed: int = 7):
    """A P25 C4FM call at 25 kS/s: a control channel repeating IDEN_UP
    (channel 0x1000 ↦ ``vc_freq``, a multiple of 5 Hz) and a
    GRP_V_CH_GRANT of channel 0x1000 for (``group``, ``source``), and the
    voice channel's LDU1 stream carrying random IMBE codewords, both
    ``seconds`` long. Returns (control IQ, voice IQ, codewords sent
    [n, 144] uint8 in order)."""
    iden = p25.pack_tsbk("IDEN_UP", **{
        "Identifier": 1, "BW": 100, "Base Frequency": int(vc_freq / 5),
        "Channel Spacing": 50, "Transmit Offset": 0x1B4})
    grant = p25.pack_tsbk("GRP_V_CH_GRANT", last_block=True, **{
        "Channel": 0x1000, "Group Address": group,
        "Source Address": source})
    pair = [p25.build_tsdu_frame(nac, [iden]),
            p25.build_tsdu_frame(nac, [grant])]
    n = int(seconds * 25000.0)
    cc = M.c4fm_modulate(bits.bits_to_dibits(np.concatenate(
        pair * (n // (len(np.concatenate(pair)) * 5 // 2) + 1))),
        fs=25000.0)[:n]
    rng = np.random.default_rng(seed)
    lc = p25.make_link_control(0x0, tgid=group, source_id=source)
    sent, ldus = [], []
    while sum(map(len, ldus)) * 5 // 2 < n:         # 5 samples per bit
        vcs = rng.integers(0, 2, (9, 144)).astype(np.uint8)
        sent.append(vcs)
        ldus.append(p25.build_ldu1_frame(nac, lc, vcs))
    vc = M.c4fm_modulate(bits.bits_to_dibits(np.concatenate(ldus)),
                         fs=25000.0)[:n]
    return cc, vc, np.concatenate(sent)


def codewords_ok(got: list, sent: np.ndarray, least: int) -> bool:
    """``got`` holds at least ``least`` codewords and is a contiguous run
    of ``sent``."""
    if len(got) < least:
        return False
    got = np.asarray(got, np.uint8)
    starts = [i for i in range(len(sent) - len(got) + 1)
              if np.array_equal(sent[i], got[0])]
    return any(np.array_equal(sent[i:i + len(got)], got) for i in starts)


def edacs_analog_call(seconds: float, keyup_s: float, tone_hz: float,
                      lcn: int = 3, group: int = 321,
                      logical_id: int = 4567):
    """An EDACS analog call at 25 kS/s: a 9600 Bd control channel
    repeating the call assignment (``lcn``, ``group``, ``logical_id``),
    and the granted channel carrying an FM tone (0.8 of a 2.5 kHz
    deviation) from ``keyup_s`` on, both ``seconds`` long. Returns
    (control IQ, voice IQ)."""
    n = int(seconds * 25000.0)
    frame = edacs.build_frame(*edacs.make_call_assignment(
        lcn=lcn, group=group, logical_id=logical_id))
    n_frames = int(seconds * 9600.0) // len(frame) + 1
    cc_bits = np.concatenate([np.tile(np.array([0, 1], np.uint8), 40)]
                             + [frame] * n_frames)
    cc = M.fsk2_modulate(cc_bits, 25000.0, baud=9600.0, dev_hz=3000.0)[:n]
    t = np.arange(n) / 25000.0
    on = t >= keyup_s
    audio = np.where(on, 0.8 * np.sin(2 * np.pi * tone_hz * t), 0.0)
    vc = M.fm_modulate(audio.astype(np.float32), 25000.0, 2500.0) * on
    return cc, vc.astype(np.complex64)
