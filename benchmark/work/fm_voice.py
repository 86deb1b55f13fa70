"""The analog voice tracker's work a block (``fm_voice``: discriminator,
de-emphasis, power), bound by bytes: the float32 planes (re, im) of every
lane read once; the float32 audio of each of the N samples written once;
the float32 power a lane written once; the lane state (the previous
sample, complex64; the de-emphasis' last output and last input, float32)
read and written once. At 8192 lanes × 2500 samples: 246 MB."""


def count(sh: dict) -> dict:
    lanes, n = sh["lanes"], sh["n_out"]
    state = 8 + 4 + 4
    return {"flop": {}, "bytes": lanes * (n * 8 + n * 4 + 4 + 2 * state)}
