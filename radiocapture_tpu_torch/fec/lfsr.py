"""P25 Phase 2 TDMA scrambler keystream (TIA-102.BBAC).

The Phase 2 air interface scrambles each 4320-bit superframe with a
44-bit Galois LFSR, generator x^44 + x^40 + x^35 + x^29 + x^24 + x^10 + 1,
seeded from (WACN << 24) | (SYSID << 12) | NAC and pre-whitened by
multiplying the seed by the tap polynomial. The reference reaches the
same keystream through an op25-derived segmented-register walk
(p25p2_lfsr.py:50-88); this is an independent flat-register
implementation of the same generator.

Output is the per-superframe dibit XOR mask applied by the TDMA frame
assembler before decoding (reference usage: logging_receiver.py:353-363).
"""

from __future__ import annotations

import numpy as np

# Galois tap injection positions, indexed from the register MSB.
# (distance-from-LSB form: 40, 35, 29, 24, 10.)
_TAP_OFFSETS = (0, 4, 9, 15, 20, 34)
_INJECT_POS = (3, 8, 14, 19, 33)
_REG_BITS = 44
_SUPERFRAME_BITS = 4320


def _seed_bits(nac: int, sysid: int, wacn: int) -> np.ndarray:
    seed = ((wacn & 0xFFFFF) << 24) | ((sysid & 0xFFF) << 12) | (nac & 0xFFF)
    return np.array([(seed >> (_REG_BITS - 1 - i)) & 1
                     for i in range(_REG_BITS)], np.uint8)


def _whiten(seed: np.ndarray) -> np.ndarray:
    """Initial register state: seed polynomial times the tap mask."""
    state = np.zeros(_REG_BITS, np.uint8)
    for d in _TAP_OFFSETS:
        state[d:] ^= seed[: _REG_BITS - d]
    return state


def keystream_bits(nac: int, sysid: int, wacn: int,
                   n: int = _SUPERFRAME_BITS) -> np.ndarray:
    """n keystream bits for one (NAC, SYSID, WACN) tuple."""
    b = _whiten(_seed_bits(nac, sysid, wacn))
    out = np.empty(n, np.uint8)
    for i in range(n):
        fb = b[0]
        out[i] = fb
        b = np.roll(b, -1)
        b[-1] = fb
        for p in _INJECT_POS:
            b[p] ^= fb
    return out


def keystream_dibits(nac: int, sysid: int, wacn: int) -> np.ndarray:
    """2160 xor dibits covering one Phase 2 superframe — the mask the
    voice-channel frame assembler applies per slot."""
    bits = keystream_bits(nac, sysid, wacn)
    return (bits[0::2] << 1 | bits[1::2]).astype(np.uint8)
