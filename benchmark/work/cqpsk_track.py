"""The CQPSK demodulator's work a block (the AGC gain and the tracker),
bound by bytes: the float32 planes of every lane read once; symbols,
valid and dibits of each of the N samples written once; the lane state
(t, omega, freq, phase, the previous symbol and the 24-sample complex
history) read and written once."""


def count(sh: dict) -> dict:
    lanes, n = sh["lanes"], sh["n_out"]
    state = 4 * (4 + 2 + 2 * 24)
    return {"flop": {}, "bytes": lanes * (n * 8 + 3 * n * 4 + 2 * state)}
