"""Fixture streams with known content, and the decode that checks them:
P25 TSDU dibit streams carrying numbered grants, the impaired CQPSK
modulations of the JAX package's ``tests/test_cqpsk_chain.py``, and a
Phase 2 TDMA superframe. Numpy only, built from the port's copies of the
protocol modules, so ``chip_smoke.py`` and the card tests run where JAX
is not installed.
"""

from __future__ import annotations

import numpy as np

from radiocapture_tpu_torch.demod import tdma
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.fec import bits
from radiocapture_tpu_torch.protocol import p25
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
