"""Decide ``correct`` for a path whose answers are audio and power (the
analog voice chain): the kept blocks of the run against the plain
reference (``benchmark/reference``), stage by stage, as ``core/judge.py``
does for symbol streams.

For every kept block the reference channelizer works out the channel
samples and the carried state from the wire blocks alone, on every lane.
The reference demodulator (``reference/demod_<name>.py``) starts each pair
from the program's state before it (its own initial state for the start
pair, whose state is the program's too) and carries its own state into the
pair's second block, on the channel samples the program's channelizer
produced. The chain takes no decision and its one recurrence, the
de-emphasis, is linear and stable (|z1| < 1), so float32 and float64 copies
stay within rounding on every lane and from the initial state: the start
pair is judged as the window pairs are.

The numbers, each the largest over the blocks:

- ``chan_err``, ``carry_err``: as ``core/judge.py`` reads them.
- ``audio_err``: on the lanes that carry a channel, max |audio - reference|
  over max |reference|.
- ``noise_off``: on the lanes of noise alone, the share of audio samples
  off the reference by more than ``NOISE_TOL`` of the largest reference
  sample there. A phase step near ±π may fall on the other side of the
  branch cut in the program (a step of 2π · gain in the discriminator,
  which the de-emphasis spreads over ~20 samples), so these lanes are
  judged by a share and not by the largest error.
- ``power_err``: on every lane, |power - reference| / reference.
- ``track_err``: the demodulator's carried state after the block:
  ``quad.prev`` (a channel sample) on every lane exactly, 1 where any
  differs; ``deemph.y_last`` and ``deemph.x_last`` on the channel lanes,
  max |Δ| / max |ref| a tensor. The program's ``x_last`` is its float32
  discriminator value and the reference's a float64 one: on the card the
  kernel's equals the program's own plain version bit for bit, but the
  rounding of a float32 complex product is the device's and, on the CPU,
  even the memory layout's, so the reference holds it to rounding.
"""

from __future__ import annotations

import torch

from benchmark.core import judge as _judge
from benchmark.core.judge import rel_err, state_err

NUMBERS = ("chan_err", "carry_err", "audio_err", "noise_off", "power_err",
           "track_err")
NOISE_TOL = 1e-4     # of the noise lanes' largest reference audio sample
DEEMPH = ("deemph.y_last", "deemph.x_last")


def differs(got: torch.Tensor, want: torch.Tensor) -> float:
    """1.0 where any value of ``got`` differs from ``want``'s, else 0.0."""
    return float(not torch.equal(got.to(want.dtype), want))


class Judge(_judge.Judge):
    """The reference side of one voice cell: ``core/judge.py``'s channelizer
    and demodulator modules (``path.reference``, ``path.demod``), with the
    signal lanes as a mask."""

    def __init__(self, path, ring: torch.Tensor, signal_lanes, dev):
        super().__init__(path, ring, signal_lanes, dev)
        lanes = self.sig
        self.sig = torch.zeros(path.lanes, dtype=torch.bool, device=dev)
        self.sig[lanes] = True

    def start_state(self, pre) -> dict:
        """The reference's state before a pair: its initial state, or the
        program's in float64 (complex128)."""
        if pre is None:
            return self.demod.init(self.path.lanes, self.prm, self.dev)
        return {k: v.to(self.dev).to(torch.complex128 if v.is_complex()
                                      else torch.float64)
                for k, v in pre["demod"].items()}

    def run(self, pairs: list) -> list[dict]:
        """Per-block numbers, in the order of ``pairs``' blocks."""
        path, sig = self.path, self.sig
        out = []
        for p in pairs:
            state = self.start_state(p["pre"])
            for b in p["blocks"]:
                y_ref, st_ref = self.block(b["k"])
                y = path.lane_planes(b["planes"])
                n = {"chan_err": rel_err(y, y_ref),
                     "carry_err": state_err(b["post"]["chan"], st_ref, {})}
                del y_ref
                state, a_ref, p_ref = self.demod.track(y, state, self.prm)
                audio, power = path.lane_outputs(b["outs"])
                da, dp = self.demod.gaps((audio, power), a_ref, p_ref)
                n["audio_err"] = float(da[sig].max()) / float(
                    a_ref[sig].abs().max())
                noise = ~sig
                d = (audio[noise].to(torch.float64) - a_ref[noise]).abs()
                tol = NOISE_TOL * float(a_ref[noise].abs().max())
                n["noise_off"] = float((d > tol).to(torch.float64).mean())
                n["power_err"] = float(dp.max())
                got = {q: v.to(self.dev) for q, v in
                       b["post"]["demod"].items()}
                n["track_err"] = max(
                    differs(got["quad.prev"], state["quad.prev"]),
                    state_err({q: got[q][sig] for q in DEEMPH},
                              {q: state[q][sig] for q in DEEMPH}, {}))
                out.append(n)
                del y, a_ref, audio
        return out
