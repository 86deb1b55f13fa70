"""The wire bank's work a block: C slots of S sources, each N outputs of a
K-tap complex FIR on the decimated grid (8 FLOP a complex tap, in
bfloat16 operands). Bytes: the wire block and the history read once, the
new history and the mixer phases written once, the prototype taps once,
the float32 planes written once."""


def count(sh: dict) -> dict:
    s, t, c = sh["sources"], sh["block"], sh["slots"]
    k, n, wb = sh["taps"], sh["n_out"], sh["wire_bytes"]
    return {"flop": {"bfloat16": 8.0 * s * c * n * k},
            "bytes": (s * t * 2 * wb + 2 * s * (k - 1) * 2 * wb
                      + 2 * s * c * 4 + k * 4 + s * n * c * 8)}
