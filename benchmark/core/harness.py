"""One run of one cell: set-up, the measured window, the traced segment,
the import fence and the correctness check, as a result dict.

The window (the same for every cell; the traffic file sets its numbers):
the ring of wire blocks is on the device before it opens; the host
dispatches block k's step and then waits for block k - (in_flight - 1),
so ``in_flight`` blocks are queued or running; the streaming state
carries from block to block. A block's completion is an event recorded
after its step. The window closes at the first completion seen after
``seconds``; every block dispatched counts, and the last one's completion
ends the window.
"""

from __future__ import annotations

import math
import sys
import time
from collections import deque

import numpy as np
import torch

from benchmark.core import judge as _judge
from benchmark.core import trace as _trace
from benchmark.core.probe import Probe
from benchmark.core.traffic import make_ring

START_BLOCKS = 2     # blocks from the initial state the reference follows
PAIRS = 3            # pairs of window blocks compared, at seeded times
PAIR_SPAN = (0.05, 0.85)   # where in the window the pairs start
WARM_BLOCKS = 4      # further set-up blocks before the window
FORBIDDEN = ("jax", "jaxlib", "flax", "radiocapture_tpu")


class FenceError(RuntimeError):
    """A forbidden module was loaded by the time the window closed."""


class HostEvent:
    """A completion mark for CPU runs (the tests): the CPU path is
    synchronous, so a block is done when its step returns."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, other: "HostEvent") -> float:
        return (other.t - self.t) * 1e3


def done_event(dev):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return HostEvent()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def seed64(seed: int) -> int:
    return seed & ((1 << 64) - 1)


class Run:
    def __init__(self, cell, seed: int, seconds: float, trace: bool, dev,
                 log=None, wrap_step=None):
        self.cell, self.seed, self.seconds = cell, seed64(seed), seconds
        self.trace, self.dev = trace, torch.device(dev)
        self.log = log or (lambda *a: print(*a, file=sys.stderr,
                                            flush=True))
        self.traffic = cell.traffic
        self.marks = [("harness loaded", time.perf_counter())]
        self.path = cell.path_module().Path(cell.cfg, cell.traffic, self.dev)
        self.marks.append(("pipeline built", time.perf_counter()))
        self.probe = Probe(trace, self.dev)
        self.path.attach(self.probe)
        self.step = self.path.step if wrap_step is None else \
            wrap_step(self.path, self.path.step)
        self.ring, self.signal_lanes = make_ring(
            cell.cfg, cell.traffic, self.seed, self.dev, self.path.block,
            self.path.slot_hz)
        self.sync()
        self.marks.append(("ring made", time.perf_counter()))
        self.pairs: list[dict] = []
        self.ends: dict = {}
        self.k = 0

    def dispatch(self, state, keep: bool, timed: list | None = None):
        probe = self.probe
        probe.keep, probe.kept = keep, None
        probe.begin_block()
        t0 = time.perf_counter()
        state, outs = self.step(state, self.ring[self.k % self.ring.shape[0]])
        if timed is not None:
            timed.append(time.perf_counter() - t0)
        probe.keep = False
        self.ends[self.k] = done_event(self.dev)
        self.k += 1
        return state, outs

    def kept_block(self, state, outs) -> dict:
        return {"k": self.k - 1, "planes": self.probe.kept, "outs": outs,
                "post": self.path.state_dict(state)}

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self):
        """The start pair from the initial state, then warm blocks, one
        round of the window's keeping (so its buffers are in the
        allocator's cache), all of the cell's shapes built and warmed."""
        state = self.path.init()
        start = {"pre": None, "blocks": []}
        for _ in range(START_BLOCKS):
            state, outs = self.dispatch(state, True)
            start["blocks"].append(self.kept_block(state, outs))
        self.pairs.append(start)
        spare = []
        for i in range(WARM_BLOCKS + 2 * PAIRS):
            keep = i >= WARM_BLOCKS
            pre = self.path.state_dict(state) if keep else None
            state, outs = self.dispatch(state, keep)
            if keep:
                spare.append((pre, self.kept_block(state, outs)))
        self.sync()
        del spare
        return state

    def window(self, state):
        """The measured window. Returns (state, blocks, window_s, latency
        ms of each block, dispatch seconds of each block)."""
        inflight = self.traffic["in_flight"]
        rng = np.random.default_rng([self.seed, 1])
        fracs = sorted(rng.uniform(*PAIR_SPAN, PAIRS))
        self.probe.active = self.trace
        first = self.k
        pending: deque = deque()
        timed: list = []
        pair, n_pair = None, 0
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        while True:
            now = time.perf_counter()
            if now >= deadline and pair is None:
                break
            keep = pair is not None
            if not keep and n_pair < PAIRS and \
                    now >= t0 + fracs[n_pair] * self.seconds:
                pair = {"pre": self.path.state_dict(state), "blocks": []}
                keep = True
            state, outs = self.dispatch(state, keep, timed)
            if keep:
                pair["blocks"].append(self.kept_block(state, outs))
                if len(pair["blocks"]) == 2:
                    self.pairs.append(pair)
                    pair, n_pair = None, n_pair + 1
            pending.append(self.k - 1)
            if len(pending) >= inflight:
                self.ends[pending.popleft()].synchronize()
        while pending:
            self.ends[pending.popleft()].synchronize()
        t_end = time.perf_counter()
        self.probe.active = False
        self.probe.begin_block()
        blocks = self.k - first
        lat = [self.ends[j - inflight].elapsed_time(self.ends[j])
               for j in range(first, self.k)]
        return state, blocks, t_end - t0, lat, timed

    def traced_segment(self, state):
        """``trace_blocks`` more blocks under ``torch.profiler``, the same
        loop with its host spans named."""
        from torch.profiler import ProfilerActivity, profile, record_function
        inflight = self.traffic["in_flight"]
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        pending: deque = deque()
        with profile(activities=acts) as prof:
            for _ in range(self.traffic["trace_blocks"]):
                with record_function("bench.dispatch"):
                    state, _ = self.dispatch(state, False)
                pending.append(self.k - 1)
                if len(pending) >= inflight:
                    with record_function("bench.wait"):
                        self.ends[pending.popleft()].synchronize()
            with record_function("bench.wait"):
                while pending:
                    self.ends[pending.popleft()].synchronize()
        return state, _trace.read(prof)

    def device_info(self) -> dict:
        """The cards the cell asks for, and the peak on the fullest: the
        path's own ``memory_peak_bytes()`` where it has one (ranks in
        other processes), else this process's on each card."""
        chips = int(self.cell.entry["chips"])
        if self.dev.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": chips,
                    "memory_peak_bytes": 0}
        peak = getattr(self.path, "memory_peak_bytes", None)
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.dev),
                "count": chips,
                "memory_peak_bytes": int(peak()) if peak else max(
                    torch.cuda.max_memory_allocated(i)
                    for i in range(chips))}


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, log=None, wrap_step=None,
             marks: list | None = None) -> dict:
    """One run; returns the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced,
    ``checks`` last), or raises ``FenceError`` when a forbidden module is
    loaded once the window has closed. ``marks`` are (name, time) of the
    set-up before the call, logged with the run's own."""
    run = Run(cell, seed, seconds, trace, dev, log, wrap_step)
    run.marks[:0] = marks or []
    state = run.setup()
    if run.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.dev)
    setup_s = time.perf_counter() - t_start
    run.marks.append(("warmed", time.perf_counter()))
    run.log("set-up: " + ", ".join(
        f"{name} {t - t_start:.3f} s" for name, t in run.marks))
    state, blocks, window_s, lat, timed = run.window(state)
    device = run.device_info()
    found = forbidden_modules()
    if found:
        raise FenceError(f"loaded when the window closed: {found}")
    path = run.path
    metrics: dict = {}
    ctx = {"path": path, "cell": cell}
    if trace:
        state, tr = run.traced_segment(state)
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        ctx.update(probe=run.probe, dispatch_s=timed, trace=tr)
    else:
        values = {"msps": blocks * path.samples_per_block / window_s / 1e6,
                  "block_p95_ms": float(np.percentile(lat, 95.0)),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    del state
    for b in run.ends.values():
        b.synchronize()
    run.ends.clear()
    judge = getattr(path, "Judge", _judge.Judge)(
        path, run.ring, run.signal_lanes, run.dev)
    names = _judge.numbers(cell.limits)
    if trace:
        ctx["work"] = work_counts(cell, path, judge)
        for m in cell.per_layer:
            v = cell.metric_module(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    try:
        per_block = judge.run(run.pairs)
    except (RuntimeError, ValueError, KeyError, IndexError) as e:
        run.log(f"reference comparison failed: {type(e).__name__}: {e}")
        per_block = [{n: math.inf for n in names}]
    for k, b in zip((b["k"] for p in run.pairs for b in p["blocks"]),
                    per_block):
        run.log(f"block {k}: " + " ".join(f"{n}={b.get(n, float('nan')):.3e}"
                                          for n in names))
    worst, failed, ok = _judge.verdict(per_block, cell.limits)
    # a number no block read, or one that is not finite, prints as null
    checks = {n: {"value": worst[n] if math.isfinite(worst[n]) else None,
                  "limit": cell.limits[n]["limit"]}
              for n in names}
    result = {"correct": bool(ok), "attempted": blocks, "failed": failed,
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                               "idle_gaps": ctx["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result


def work_counts(cell, path, judge) -> dict:
    """Each stage's FLOP by precision and bytes, from ``work/<stage>.py``
    at the cell's shapes (the reference channelizer's and demodulator's
    ``sizes``: their filter design)."""
    sh = {"sources": path.sources, "block": path.block, "slots": path.slots,
          "lanes": path.lanes,
          "wire_bytes": 2 if cell.traffic["wire"] == "bfloat16" else 4}
    sh.update(judge.chan.sizes())
    sh.update(judge.demod.sizes(judge.prm))
    return {stage: cell.work_module(name).count(sh)
            for stage, name in path.work.items()}

