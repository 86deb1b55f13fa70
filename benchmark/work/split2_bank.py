"""receiver_split2's channelizer a block: the 2-slot float32 complex bank
(decim 2, K1 taps: 8 FLOP a complex tap, T/2 outputs of each half), then
the bfloat16-operand wire bank on the 2S halves (C slots, N outputs of K
taps). Bytes: the wire block read once, the split's history (wire
samples) and the bank's history (float32 half samples) read and written
once, the mixer phases, the taps once, the planes written once; the
halves between the two banks are the implementation's and not counted."""


def count(sh: dict) -> dict:
    s, t, c, wb = sh["sources"], sh["block"], sh["slots"], sh["wire_bytes"]
    k1, k, n = sh["split_taps"], sh["taps"], sh["n_out"]
    return {"flop": {"float32": 8.0 * s * 2 * (t // 2) * k1,
                     "bfloat16": 8.0 * 2 * s * c * n * k},
            "bytes": (s * t * 2 * wb + 2 * s * (k1 - 1) * 2 * wb
                      + 2 * 2 * s * (k - 1) * 8 + 2 * (s * 2 + 2 * s * c) * 4
                      + (k1 + k) * 4 + 2 * s * n * c * 8)}
