"""Time builds of the complex bank kernel (``csrc/xlat_complex.cu``) with
another plan or part of the work changed against the package's build, on
one CUDA card at the split2 bench shape (128 sources × 240,000 bf16 wire
samples, mid-stream after three steps, as
``track_turns.complex_bench_operands`` makes them), or with ``--shape
mesh`` first at the general path's, the time-sharded mesh step's bank
(``track_turns.complex_mesh_operands``).

Each variant rewrites a copy of the source (``a+b`` applies both;
``base`` is the source as it is):

- ``r=N``: N outputs per lane (odd; the package's 7);
- ``warps=N``: N warps per block (the package's 4);
- ``stages=N``: a copy ring of N stages per warp (the package's 2);
- ``blocks=N``: ``__launch_bounds__`` asks for N blocks per SM (the
  package's 4, so at most 128 registers);
- ``taps_held``: the taps kept in registers for the warp's whole run in a
  source, not loaded from shared memory for each tile;
- ``sincos``: one ``sincosf`` per output and slot, not split2's two
  phasors per slot;
- ``wide_unroll2``: the wide plan's loop over tap pairs unrolled by two;
- the general path's wide plan: ``wide_r=N`` outputs and ``wide_rc=N``
  slots per thread, ``wide_warps=N`` warps per block at most,
  ``wide_kc=N`` taps per staged chunk (the package's 4, 8, 8, 96);

and, wrong on purpose, to show what one part of the work costs:

- ``fma1``: one FMA per tap and slot instead of four in split2's loop;
  ``fma1_general`` the same in the general path's ``fma4``.

::

    python3 -m radiocapture_tpu_torch.tools.complex_variants \\
        r=5 r=9 blocks=3 taps_held sincos fma1
    python3 -m radiocapture_tpu_torch.tools.complex_variants --shape mesh \\
        wide_r=2 wide_kc=48 fma1_general

Every variant is built with the package's flags (all at once, one nvcc
process each) into ``_build/variants/``; for each its ptxas line (the
bf16 instance of the split2 kernel; at ``mesh`` the float32 wide
kernel), the count of outputs bit-identical to the package's, and its
ms in ROUNDS rounds (the order reversed every other round, ITERS
launches each timed by CUDA events). The compared outputs are filled
first, the package's with NaN and each variant's with infinity, so an
output a variant skips does not count as identical. Prints the card's
``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.tools.track_turns import (
    card_line, complex_bench_operands, complex_mesh_operands, cuda_ms,
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
GENERAL_FMA4 = """  ar = fmaf(gv.x, zv.x, ar);
  ar = fmaf(-gv.y, zv.y, ar);
  ai = fmaf(gv.x, zv.y, ai);
  ai = fmaf(gv.y, zv.x, ai);
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
    "fma1_general": [(GENERAL_FMA4, "  ar = fmaf(gv.x, zv.x, ar);\n")],
    "wide_unroll2": [("      for (; kk + 1 < kc; kk += 2) {\n",
                      "#pragma unroll 2\n"
                      "      for (; kk + 1 < kc; kk += 2) {\n")],
}
SIZED = {"r": "constexpr int R = {};",
         "warps": "constexpr int WARPS = {};",
         "stages": "constexpr int STAGES = {};",
         "blocks": "__launch_bounds__(WARPS * 32, {})",
         "wide_r": "constexpr int WIDE_R = {};",
         "wide_rc": "constexpr int WIDE_RC = {};",
         "wide_warps": "constexpr int WIDE_WARPS = {};",
         "wide_kc": "constexpr int WIDE_KC = {};"}
# the kernel whose ptxas line a shape's run prints: its name and its wire
PTXAS_OF = {"split2": ("xlat_complex_split2", "Bf16Pair"),
            "mesh": ("xlat_complex_wide", "F32Pair")}


def variant_source(src: str, name: str) -> str:
    """``src`` with the variant ``name``'s edits (``a+b``: both); each
    edited text must occur once."""
    edits = []
    for part in name.split("+"):
        key, _, size = part.partition("=")
        if key in SIZED and size.isdigit():
            text = SIZED[key]
            found = re.search(re.escape(text).replace(r"\{\}", r"(\d+)"),
                              src)
            if found is None:
                raise RuntimeError(f"{part}: the source has no {text!r}")
            edits.append((found.group(0), text.format(int(size))))
        elif part in EDITS:
            edits += EDITS[part]
        elif part != "base":
            raise SystemExit(f"unknown variant {part!r}\n{__doc__}")
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source does not hold {old!r} "
                               f"once")
        src = src.replace(old, new)
    return src


def build(names: list, shape: str = "split2") -> tuple:
    """({variant: its ``xlat_complex_launch``}, {variant: its ptxas line
    for ``shape``'s kernel, ``PTXAS_OF``}), each variant a rewrite of the
    package's ``csrc/xlat_complex.cu``."""
    src = (kernels.CSRC / "xlat_complex.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"xlat_complex_{name.replace('=', '')}.cu"
        cu = cu.with_name(cu.name.replace("+", "_"))
        so = cu.with_suffix(".so")
        cu.write_text(variant_source(src, name))
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns, ptxas = {}, {}
    kernel, wire = PTXAS_OF[shape]
    for name, (so, proc) in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        so.with_suffix(".ptxas.txt").write_text(text)
        lines = text.splitlines()
        at = min(i for i, l in enumerate(lines) if "entry function" in l
                 and kernel in l and wire in l)
        ptxas[name] = " | ".join(
            next(l for l in lines[at:] if key in l).split(":", 1)[-1].strip()
            for key in ("spill", "Used"))
        print(name, ptxas[name], flush=True)
        fn = getattr(ctypes.CDLL(str(so)), "xlat_complex_launch")
        fn.argtypes = list(kernels._SIGNATURES["xlat_complex_launch"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def main(argv: list[str]) -> None:
    shape = "split2"
    if argv[:1] == ["--shape"] and len(argv) > 1:
        shape, argv = argv[1], argv[2:]
    if not argv or shape not in PTXAS_OF:
        raise SystemExit(__doc__)
    dev = require_cuda()
    x, hist, grev, phase0, step, d = (
        complex_bench_operands(dev) if shape == "split2"
        else complex_mesh_operands(dev))
    fns, ptxas = build(argv, shape)
    fns["package"] = kernels.load().xlat_complex_launch
    t = x.shape[1]
    s, c, k = grev.shape
    n = t // d
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(name, fill=None):
        y = torch.empty((s, c, n), dtype=torch.complex64, device=dev)
        if fill is not None:
            y.fill_(fill)
        kernels.check(fns[name](
            x.data_ptr(), hist.data_ptr(), grev.data_ptr(), phase0.data_ptr(),
            step.data_ptr(), y.data_ptr(), s, t, n, k, d, c,
            int(x.dtype == torch.bfloat16), stream),
            f"xlat_complex {name}")
        return y

    keys = ["package"] + argv
    ref = run("package", float("nan"))
    res = {key: {"ptxas": ptxas.get(key), "ms": [],
                 "identical_outputs": identical_outputs(
                     run(key, float("inf")), ref)}
           for key in keys}
    for r in range(ROUNDS):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            res[key]["ms"].append(cuda_ms(lambda: run(key), ITERS))
    for key in keys:
        print(key, "ms", " ".join(f"{v:.4f}" for v in res[key]["ms"]),
              "identical outputs", res[key]["identical_outputs"], "of",
              ref.numel())
    print(card_line())
    print(json.dumps({"shape": [s, t, c, k, d],
                      "outputs": ref.numel(),
                      "variants": res}))


if __name__ == "__main__":
    main(sys.argv[1:])
