"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU. Prints
the result as one JSON object, the last line of standard output, and the
numbers that decide ``correct`` beside their limits as the last lines of
standard error. Exits 2 without a result when PyTorch sees no CUDA device
or fewer than the cell needs, and 3 when a JAX module or the JAX package
is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
# every kernel cache of the run at a fixed path inside the checkout (the
# kernel library itself builds into radiocapture_tpu_torch/_build/)
CACHE = ROOT / "benchmark" / ".cache"
os.environ["TORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    marks = [("torch imported", time.perf_counter())]
    from benchmark.core import spec
    cell = spec.Cell(spec.manifest(ROOT), args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); PyTorch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    marks.append(("CUDA found", time.perf_counter()))
    from benchmark.core.harness import FenceError, forbidden_modules, run_cell
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START, log,
                          marks=marks)
    except FenceError as e:
        log(f"import fence: {e}")
        return 3
    found = forbidden_modules()
    if found:
        log(f"import fence: loaded at the end of the run: {found}")
        return 3
    dev = result["device"]
    print(f"peak device memory (max_memory_allocated over the window): "
          f"{dev['memory_peak_bytes']} bytes on {dev['kind']}", flush=True)
    for name, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'OVER'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
