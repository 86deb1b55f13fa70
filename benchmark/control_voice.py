"""The control of the voice cells' correctness check: the plain reference
put in the program's place, one precision step below what the
configuration states (float8 e4m3 operands for the bfloat16 wire bank,
bfloat16 for the float32 discriminator, de-emphasis and power), judged by
the voice judge (``core/voice.py``) as the program is. The benchmark's own
runs never run it.

    python benchmark/control_voice.py --workload <name> --seeds 1,2,3 [--blocks 8]

runs it on the chip at the cell's own size and prints each number of each
seed, one JSON line a seed, as ``control.py`` does for the cells of symbol
streams. It carries its own state from the initial state through
``blocks`` blocks of the cell's ring; the blocks are compared in pairs, as
a run compares its start pair and its window pairs.
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

from benchmark.control import ControlPath  # noqa: E402
from benchmark.core import judge as _judge  # noqa: E402
from benchmark.core import spec, voice  # noqa: E402
from benchmark.core.traffic import make_ring  # noqa: E402


def control_run(cell, seed: int, dev, blocks: int = 8) -> list[dict]:
    """The control's per-block numbers over ``blocks`` blocks (pairs)."""
    path = ControlPath(cell)
    ring, signal = make_ring(cell.cfg, cell.traffic, seed, dev, path.block,
                             path.slot_hz)
    judge = voice.Judge(path, ring, signal, dev)
    demod, prm = judge.demod, judge.prm
    state = demod.init(path.lanes, prm, dev)
    pairs = []
    for k in range(blocks):
        pre = {"demod": state}
        planes, chan_state = judge.chan(
            ring[(k - 1) % ring.shape[0]] if k > 0 else None,
            ring[k % ring.shape[0]], k, prec="control")
        state, audio, power = demod.track(planes, state, prm,
                                          dtype=torch.bfloat16)
        block = {"k": k, "planes": planes.to(torch.complex64),
                 "outs": (audio.to(torch.float32), power.to(torch.float32)),
                 "post": {"chan": chan_state, "demod": state}}
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
