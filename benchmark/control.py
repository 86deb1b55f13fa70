"""The control of the correctness check: the plain reference put in the
program's place, one precision step below what the configuration states
(float8 e4m3 operands for the bfloat16 wire banks, TF32 operands for the
float32 complex banks and the PFB, bfloat16 for the float32 trackers),
judged by the same comparison as the program. The benchmark's own runs
never run it.

    python benchmark/control.py --workload <name> --seeds 1,2,3 [--blocks 8]

runs it on the chip at the cell's own size and prints each number of
each seed beside its limit, one JSON line a seed. It carries its own
state from the initial state through ``blocks`` blocks of the cell's
ring; the blocks are compared in pairs, as a run compares its start pair
and its window pairs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.core import judge as _judge  # noqa: E402
from benchmark.core import spec  # noqa: E402
from benchmark.core.traffic import block_len, make_ring  # noqa: E402


class ControlPath:
    """What the judge reads of a path, for the control: the reference and
    demodulator names of the cell's own path (``paths/<kind>.py``), the
    sizes from the reference channelizer; its outputs are already
    lane-major."""

    def __init__(self, cell):
        prog = cell.path_module().Path
        self.reference, self.demod = prog.reference, prog.demod
        chan = spec.chan_module(self.reference).Chan
        self.cfg, self.traffic = cell.cfg, cell.traffic
        rate = cell.traffic["samp_rate"]
        self.sources = cell.traffic["sources"]
        self.lanes = self.sources * chan.n_lanes(cell.cfg)
        self.block = block_len(cell.traffic, 1)
        self.channel_fs = chan.channel_fs(cell.cfg, rate)
        self.slot_hz = chan.slot_hz(cell.cfg, rate)

    def lane_planes(self, planes):
        return planes

    def lane_outputs(self, outs):
        return outs


def f64(state: dict) -> dict:
    return {k: v.to(torch.complex128 if v.is_complex() else torch.float64)
            for k, v in state.items()}


def control_run(cell, seed: int, dev, blocks: int = 8) -> list[dict]:
    """The control's per-block numbers over ``blocks`` blocks (pairs)."""
    path = ControlPath(cell)
    ring, signal = make_ring(cell.cfg, cell.traffic, seed, dev, path.block,
                             path.slot_hz)
    judge = _judge.Judge(path, ring, signal, dev)
    demod, prm = judge.demod, judge.prm
    state = demod.init(path.lanes, prm, dev)
    pairs = []
    for k in range(blocks):
        pre = {"demod": f64(state)}
        planes, chan_state = judge.chan(
            ring[(k - 1) % ring.shape[0]] if k > 0 else None,
            ring[k % ring.shape[0]], k, prec="control")
        state, syms, valid, _ = demod.track(planes, state, prm, None,
                                           dtype=torch.bfloat16)
        syms = syms.to(torch.float32)
        block = {"k": k, "planes": planes.to(torch.complex64),
                 "outs": (syms, valid, demod.dibits(syms)),
                 "post": {"chan": chan_state, "demod": f64(state)}}
        if k % 2 == 0:
            pairs.append({"pre": None if k == 0 else pre, "blocks": [block]})
        else:
            pairs[-1]["blocks"].append(block)
    return judge.run(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--blocks", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.manifest(ROOT), args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        per_block = control_run(cell, seed, dev, args.blocks)
        worst, failed, ok = _judge.verdict(per_block, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok, "failed_blocks": failed,
                          "seconds": time.perf_counter() - t0,
                          "numbers": worst, "per_block": per_block}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
