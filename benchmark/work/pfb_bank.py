"""The pfb frontend's work a block, in float32: the coarse combiner (P
real taps a complex input sample, 4 FLOP each), an M-point IDFT a row
(5·M·log2 M, the FFT count), the bins' rotation (6 a bin), then each
slot's fine filter (8 FLOP a complex tap, N outputs of K2 taps). Bytes:
the wire block read once, the coarse and fine histories and the fine
phases read and written once, the taps once, the planes written once."""

import math


def count(sh: dict) -> dict:
    s, t, c, wb = sh["sources"], sh["block"], sh["slots"], sh["wire_bytes"]
    m, p = sh["branches"], sh["branch_taps"]
    k2, n = sh["fine_taps"], sh["n_out"]
    coarse = 4.0 * p * s * t + 5.0 * s * t * math.log2(m) + 6.0 * s * t
    fine = 8.0 * s * c * n * k2
    return {"flop": {"float32": coarse + fine},
            "bytes": (s * t * 2 * wb + 2 * s * (p - 1) * m * 2 * wb
                      + 2 * s * c * (k2 - 1) * 8 + 2 * s * c * 4
                      + (p * m + k2) * 4 + s * n * c * 8)}
