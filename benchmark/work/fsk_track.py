"""The C4FM demodulator's work a block, bound by bytes: the float32
planes (re, im) of every lane read once; symbols (float32), valid and
dibits (int32) of the M = N / sym_decim tracked samples written once; the
lane state (previous sample, boxcar history, clock, fine frequency, the
8-sample interpolator history) read and written once."""


def count(sh: dict) -> dict:
    lanes, n = sh["lanes"], sh["n_out"]
    m = n // sh["sym_decim"]
    state = 8 + 4 * (sh["sym_taps"] - 1) + 4 + 4 + 4 * 8
    return {"flop": {}, "bytes": lanes * (n * 8 + 3 * m * 4 + 2 * state)}
