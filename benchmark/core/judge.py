"""Decide ``correct``: the kept blocks of the run against the plain
reference (``benchmark/reference``), stage by stage.

Kept blocks come in pairs of consecutive blocks: the run's first two
blocks from the initial state (the start pair), and pairs at seeded times
in the window. For every kept block the reference works out the
channelizer's output and carried state from the wire blocks alone, on
every lane. The demodulator's carried state runs through a feedback loop
from the stream's start, so it cannot be worked out again thousands of
blocks in: the reference demodulator starts each pair from the program's
state before it (its own initial state for the start pair) and carries
its own state into the pair's second block, on the channel samples the
program's channelizer produced (judged on their own by ``chan_err``),
taking the program's decisions, on the lanes that carry a synthesized
channel. On a lane of noise alone the fsk4 loop is chaotic (its timing
gain times the squared slope of the interpolated noise is far above 1),
so float32 and float64 copies of it part within a few symbols whatever
decisions they share; a locked lane's loop contracts, and there the two
agree to rounding. While a loop acquires lock (the start pair, from the
initial state) it can part the same way on a few lanes, so the start
pair's demodulator is judged by the share of its lanes that part.

The numbers, each the largest over the blocks it is read on:

- ``chan_err``: max |y - y_ref| / max |y_ref| of the channel samples.
- ``carry_err``: the channelizer's carried state after the block, max
  |Δ| / max |ref| a tensor; a mixer phase that differs at all reads 1.
- ``sym_gap`` (window pairs): max |symbol - reference symbol|, every
  sample of the channel lanes.
- ``dibit_gap`` (window pairs): how far a reference symbol lies outside
  the slicer region of the program's dibit.
- ``valid_gap`` (window pairs): how far the reference loop's clock lay
  from its threshold where the program's emit decision went the other
  way.
- ``track_err`` (window pairs): the demodulator's carried state after the
  block, max |Δ| / max |ref| a tensor (angles on the circle).
- ``start_off`` (start pair): the share of channel lanes whose symbols
  leave the reference's by more than ``START_TOL`` anywhere in the block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.core import spec

# the numbers of this judge; a path whose answers need another comparison
# names its own judge class (``Path.Judge``) and its cell's limits file
# lists that judge's numbers
NUMBERS = ("chan_err", "carry_err", "sym_gap", "dibit_gap", "valid_gap",
           "track_err", "start_off")
START_TOL = 0.1      # symbol units: a level is 2 (C4FM), a quarter-pi 1


def rel_err(got: torch.Tensor, want: torch.Tensor, circle: float = 0.0
            ) -> float:
    """max |got - want| / max |want|; integers compare exactly (1.0 when
    any differs); with ``circle`` the difference is taken modulo it."""
    got = torch.as_tensor(got).to(want.device if torch.is_tensor(want)
                                  else got.device)
    want = torch.as_tensor(want, device=got.device)
    if got.shape != want.shape:
        return math.inf
    if not got.is_floating_point() and not got.is_complex():
        return float(bool((got.to(torch.int64) != want.to(torch.int64))
                          .any()))
    wd = torch.complex128 if (got.is_complex() or want.is_complex()) \
        else torch.float64
    g, w = got.to(wd), want.to(wd)
    d = g - w
    if circle:
        d = d - circle * torch.round(d / circle)
    scale = float(w.abs().max()) if w.numel() else 0.0
    num = float(d.abs().max()) if d.numel() else 0.0
    if not math.isfinite(num):
        return math.inf
    return num / scale if scale > 0 else (0.0 if num == 0 else math.inf)


def state_err(got: dict, want: dict, circles: dict) -> float:
    worst = 0.0
    for name, w in want.items():
        if name not in got:
            return math.inf
        worst = max(worst, rel_err(got[name], w, circles.get(name, 0.0)))
    return worst


class Judge:
    """The reference side of one cell: the channelizer and demodulator
    modules the path names (``path.reference``, ``path.demod``)."""

    def __init__(self, path, ring: torch.Tensor, signal_lanes, dev):
        self.path, self.ring, self.dev = path, ring, dev
        self.sig = torch.as_tensor(np.asarray(signal_lanes), device=dev)
        self.chan = spec.chan_module(path.reference).Chan(
            path.cfg, path.traffic["samp_rate"], path.sources, path.block,
            dev)
        self.demod = spec.demod_module(path.demod)
        self.prm = self.demod.Params(path.cfg, path.channel_fs)

    def block(self, k: int):
        r = self.ring.shape[0]
        prev = self.ring[(k - 1) % r] if k > 0 else None
        return self.chan(prev, self.ring[k % r], k)

    def run(self, pairs: list) -> list[dict]:
        """Per-block numbers, in the order of ``pairs``' blocks."""
        path = self.path
        out = [[{} for _ in p["blocks"]] for p in pairs]
        for i, p in enumerate(pairs):
            for j, b in enumerate(p["blocks"]):
                y_ref, st_ref = self.block(b["k"])
                y = path.lane_planes(b["planes"])
                out[i][j]["chan_err"] = rel_err(y, y_ref)
                out[i][j]["carry_err"] = state_err(b["post"]["chan"], st_ref,
                                                   {})
                del y_ref, y
        sig = self.sig
        lanes = len(sig)
        pre = []
        for p in pairs:
            pre.append(self.demod.init(lanes, self.prm, self.dev)
                       if p["pre"] is None else
                       {k: v.to(self.dev)[sig] for k, v in
                        p["pre"]["demod"].items()})
        state = {k: torch.cat([s[k].to(torch.complex128 if s[k].is_complex()
                                       else torch.float64) for s in pre])
                 for k in pre[0]}
        for j in range(max(len(p["blocks"]) for p in pairs)):
            blocks = [p["blocks"][j] for p in pairs]
            planes = torch.cat([path.lane_planes(b["planes"])[sig]
                                for b in blocks])
            outs = [tuple(o[sig] for o in path.lane_outputs(b["outs"]))
                    for b in blocks]
            forced = tuple(torch.cat([self.demod.forced(o, self.prm)[q]
                                      for o in outs]) for q in range(2))
            state, y_ref, _, vgap = self.demod.track(planes, state, self.prm,
                                                     forced)
            for i, (p, b, o) in enumerate(zip(pairs, blocks, outs)):
                sl = slice(i * lanes, (i + 1) * lanes)
                sg, dg = self.demod.gaps(o, y_ref[sl])
                if p["pre"] is None:
                    out[i][j]["start_off"] = float(
                        (sg > START_TOL).to(torch.float64).mean())
                    continue
                mine = {k: v[sl] for k, v in state.items()}
                got = {k: v.to(self.dev)[sig]
                       for k, v in b["post"]["demod"].items()}
                out[i][j].update(
                    sym_gap=float(sg.max()), dibit_gap=float(dg.max()),
                    valid_gap=float(vgap[sl].max()),
                    track_err=state_err(got, mine, self.demod.CIRCLES))
            del planes, y_ref
        return [n for blocks in out for n in blocks]


def numbers(limits: dict) -> list[str]:
    """The numbers a cell compares: the entries of its limits file."""
    return [n for n in limits if not n.startswith("_")]


def verdict(per_block: list[dict], limits: dict) -> tuple[dict, int, bool]:
    """(the largest reading of each number of ``limits`` over the blocks
    it is read on, infinite where none reads it; blocks with a number over
    its limit; correct)."""
    names = numbers(limits)
    worst = {n: max((b[n] for b in per_block if n in b), default=math.inf)
             for n in names}
    failed = sum(1 for b in per_block
                 if any(not (v <= limits[n]["limit"]) for n, v in b.items()))
    ok = all(worst[n] <= limits[n]["limit"] for n in names)
    return worst, failed, ok
