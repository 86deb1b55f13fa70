"""Time builds of the complex bank kernel (``csrc/xlat_complex.cu``) with
another plan or part of the work changed against the package's build, on
one CUDA card at the split2 bench shape (128 sources × 240,000 bf16 wire
samples, mid-stream after three steps, as
``track_turns.complex_bench_operands`` makes them).

Each variant rewrites a copy of the source:

- ``r=N``: N outputs per lane (odd; the package's 7);
- ``warps=N``: N warps per block (the package's 4);
- ``stages=N``: a copy ring of N stages per warp (the package's 2);
- ``blocks=N``: ``__launch_bounds__`` asks for N blocks per SM (the
  package's 4, so at most 128 registers);
- ``taps_held``: the taps kept in registers for the warp's whole run in a
  source, not loaded from shared memory for each tile;
- ``sincos``: one ``sincosf`` per output and slot, not split2's two
  phasors per slot;

and, wrong on purpose, to show what one part of the work costs:

- ``fma1``: one FMA per tap and slot instead of four.

::

    python3 -m radiocapture_tpu_torch.tools.complex_variants \\
        r=5 r=9 blocks=3 taps_held sincos fma1

Every variant is built with the package's flags (all at once, one nvcc
process each) into ``_build/variants/``; for each its ptxas line (the
bf16 instance of the split2 kernel), the count of outputs bit-identical
to the package's, and its ms in ROUNDS rounds (the order reversed every
other round, ITERS launches each timed by CUDA events). Prints the
card's ``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.tools.track_turns import (card_line,
                                                      complex_bench_operands,
                                                      cuda_ms,
                                                      identical_outputs)

ITERS = 20
ROUNDS = 4

TAPS_PER_TILE = """    float2 gr[C][K];
#pragma unroll
    for (int i = 0; i < C * K; ++i) gr[i / K][i % K] = taps[i];
"""
TAPS_HELD = """    if (fresh) {
#pragma unroll
      for (int i = 0; i < C * K; ++i) gr[i / K][i % K] = taps[i];
      fresh = false;
    }
"""
FMA4 = """            ar[r][c] = fmaf(gv.x, zv.x, ar[r][c]);
            ar[r][c] = fmaf(-gv.y, zv.y, ar[r][c]);
            ai[r][c] = fmaf(gv.x, zv.y, ai[r][c]);
            ai[r][c] = fmaf(gv.y, zv.x, ai[r][c]);
"""
FMA1 = """            ar[r][c] = fmaf(gv.x, zv.x, ar[r][c]);
"""

# name -> [(text of the source, its replacement)]
EDITS = {
    "taps_held": [("  uint32_t p0[C], st[C];\n",
                   "  uint32_t p0[C], st[C];\n  float2 gr[C][K];\n"
                   "  bool fresh = false;\n"),
                  ("      cur = s;\n", "      cur = s;\n      fresh = true;\n"),
                  (TAPS_PER_TILE, TAPS_HELD)],
    "sincos": [("\n    if (two) {\n", "\n    if (false) {\n")],
    "fma1": [(FMA4, FMA1)],
}
SIZED = {"r": ("constexpr int R = {};", 7),
         "warps": ("constexpr int WARPS = {};", 4),
         "stages": ("constexpr int STAGES = {};", 2),
         "blocks": ("__launch_bounds__(WARPS * 32, {})", 4)}


def variant_source(src: str, name: str) -> str:
    """The package's source with the variant ``name``'s edits; each edited
    text must occur once."""
    key, _, size = name.partition("=")
    if key in SIZED and size.isdigit():
        text, package = SIZED[key]
        edits = [(text.format(package), text.format(int(size)))]
    elif name in EDITS:
        edits = EDITS[name]
    else:
        raise SystemExit(f"unknown variant {name!r}\n{__doc__}")
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source does not hold {old!r} "
                               f"once")
        src = src.replace(old, new)
    return src


def build(names: list) -> tuple:
    """({variant: its ``xlat_complex_launch``}, {variant: its ptxas line
    for the bf16 split2 kernel})."""
    src = (kernels.CSRC / "xlat_complex.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"xlat_complex_{name.replace('=', '')}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(variant_source(src, name))
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lines = text.splitlines()
        at = max(i for i, l in enumerate(lines)
                 if "xlat_complex_split2" in l and "Bf16Pair" in l)
        ptxas[name] = " | ".join(l.split(":", 1)[-1].strip()
                                 for l in lines[at + 1:at + 3])
        print(name, ptxas[name], flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "xlat_complex_launch")
        fn.argtypes = list(kernels._SIGNATURES["xlat_complex_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def main(argv: list[str]) -> None:
    if not argv:
        raise SystemExit(__doc__)
    dev = require_cuda()
    x, hist, grev, phase0, step, d = complex_bench_operands(dev)
    fns, ptxas = build(argv)
    fns["package"] = kernels.load().xlat_complex_launch
    s, t = x.shape[:2]
    c, k = grev.shape[1:]
    n = t // d
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(name):
        y = torch.empty((s, c, n), dtype=torch.complex64, device=dev)
        kernels.check(fns[name](
            x.data_ptr(), hist.data_ptr(), grev.data_ptr(), phase0.data_ptr(),
            step.data_ptr(), y.data_ptr(), s, t, n, k, d, c, 1, stream),
            f"xlat_complex {name}")
        return y

    keys = ["package"] + argv
    ref = run("package")
    res = {key: {"ptxas": ptxas.get(key), "ms": [],
                 "identical_outputs": identical_outputs(run(key), ref)}
           for key in keys}
    for r in range(ROUNDS):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            res[key]["ms"].append(cuda_ms(lambda: run(key), ITERS))
    for key in keys:
        print(key, "ms", " ".join(f"{v:.4f}" for v in res[key]["ms"]),
              "identical outputs", res[key]["identical_outputs"], "of",
              ref.numel())
    print(card_line())
    print(json.dumps({"shape": [s, t, c, k, d], "outputs": ref.numel(),
                      "variants": res}))


if __name__ == "__main__":
    main(sys.argv[1:])
