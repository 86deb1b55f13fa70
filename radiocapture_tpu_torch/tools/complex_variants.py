"""Time builds of the complex bank kernel (``csrc/xlat_complex.cu``) with
another plan or part of the work changed against the package's build, on
one CUDA card at the split2 bench shape (128 sources × 240,000 bf16 wire
samples, mid-stream after three steps, as
``track_turns.complex_bench_operands`` makes them), or with ``--shape
mesh`` or ``--shape pfb`` first at a shape of the general path
(``track_turns.complex_general_operands``). ``--source FILE`` (before
the shape) rewrites another source with the package's entry, such as
``tools/xlat_complex_2cf31c4.cu``, the narrow plan before its redesign.

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
- ``index_branch``: the general plans' row address chosen at run time
  (``xrow ? xrow[s] : s``) in every kernel, in place of the compile-time
  choice between a kernel with the row index and one without: the same
  outputs at ``--shape mesh`` (no index) and ``--shape pfb`` (the
  index);
- the general path's plans: ``wide_r=N`` outputs and ``wide_rc=N``
  slots per thread, ``wide_warps=N`` warps per block at most,
  ``wide_kc=N`` taps per staged chunk (the package's 4, 8, 8, 96);
  ``narrow_r=N`` outputs per lane (odd), ``narrow_warps=N`` warps per
  block at most, ``narrow_blocks=N`` blocks per SM asked of the
  compiler, ``narrow_rows=N`` bank rows a block at most (the package's
  5, 8, 1, 64; commit 2cf31c4's 3, 4, 3 and one row);

and, wrong on purpose, to show what one part of the work costs:

- ``fma1``: one FMA per tap and slot instead of four in split2's loop;
  ``fma1_general`` the same in the general plans' ``fma4``;
- ``stage_only``: the narrow plan stages its span and taps and computes
  nothing, stores nothing;
- ``no_stores``: the narrow plan computes and rotates every output but
  stores none;
- ``no_tail``: the narrow plan without its last group of tap rows.

::

    python3 -m radiocapture_tpu_torch.tools.complex_variants \\
        r=5 r=9 blocks=3 taps_held sincos fma1
    python3 -m radiocapture_tpu_torch.tools.complex_variants --shape pfb \\
        narrow_r=7 narrow_warps=2
    python3 -m radiocapture_tpu_torch.tools.complex_variants --source \\
        radiocapture_tpu_torch/tools/xlat_complex_2cf31c4.cu --shape pfb \\
        base stage_only fma1_general

Every variant is built with the package's flags (all at once, one nvcc
process each) into ``_build/variants/``; for each its ptxas line (the
bf16 instance of the split2 kernel; at ``mesh`` the float32 wide kernel
without a row index, at ``pfb`` the float32 narrow one with it), the
count of outputs bit-identical to the package's, and its ms in ROUNDS
rounds (the order reversed every other round, ITERS launches each timed
by CUDA events). The compared outputs are filled first, the package's
with NaN and each variant's with infinity, so an output a variant skips
does not count as identical. Prints the card's ``nvidia-smi`` name and
power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.tools.track_turns import (
    card_line, complex_bench_operands, complex_general_operands, cuda_ms,
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
NARROW_STORE = """        if (n < N)
          y[sc * N + n] = rotate(ar[r], ai[r], p0 + st * (uint32_t)n);
"""
# the rotated value is compared, so the FMAs and the rotation stay
NARROW_NO_STORE = (
    "        const float2 v = rotate(ar[r], ai[r], p0 + st * (uint32_t)n);\n"
    "        if (n < N && v.x == 1.25e-38f && v.y == 1.25e-38f)\n"
    "          y[sc * N + n] = v;\n")

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
    "stage_only": [("    if (active) {\n      float ar[R], ai[R];\n",
                    "    if (false) {\n"
                    "      float ar[R], ai[R];\n")],
    "no_stores": [(NARROW_STORE, NARROW_NO_STORE)],
    "no_tail": [("        if (q + u < QF) tap_row(u, q + u, D);\n",
                 "        if (false) tap_row(u, q + u, D);\n"),
                ("        if (q + u == QF && QF < Q) tap_row(u, QF, JL);\n",
                 "        if (false) tap_row(u, QF, JL);\n")],
    "index_branch": [("  if constexpr (kRows)\n"
                      "    return x + __ldg(xrow + s) * T;\n"
                      "  else\n"
                      "    return x + (long long)s * T;\n",
                      "  return x + (xrow ? __ldg(xrow + s) : (long long)s)"
                      " * T;\n")],
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
         "wide_kc": "constexpr int WIDE_KC = {};",
         "narrow_r": "constexpr int NARROW_R = {};",
         "narrow_warps": "constexpr int NARROW_WARPS = {};",
         "narrow_blocks": "constexpr int NARROW_BLOCKS = {};",
         "narrow_rows": "constexpr int NARROW_ROWS = {};"}
# the kernel whose ptxas line a shape's run prints: its name and the
# mangled template arguments (the wire; the general plans' row index,
# Lb1E with one, as at pfb, Lb0E without)
PTXAS_OF = {"split2": ("xlat_complex_split2", "Bf16Pair"),
            "mesh": ("xlat_complex_wide", "F32PairELb0E"),
            "pfb": ("xlat_complex_narrow", "F32PairELb1E")}


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


def build(names: list, shape: str = "split2",
          source: Path = kernels.CSRC / "xlat_complex.cu") -> tuple:
    """({variant: its ``xlat_complex_launch``}, {variant: its ptxas line
    for ``shape``'s kernel, ``PTXAS_OF``}), each variant a rewrite of
    ``source``."""
    src = Path(source).read_text()
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
    shape, source = "split2", kernels.CSRC / "xlat_complex.cu"
    if argv[:1] == ["--source"] and len(argv) > 1:
        source, argv = Path(argv[1]), argv[2:]
    if argv[:1] == ["--shape"] and len(argv) > 1:
        shape, argv = argv[1], argv[2:]
    if not argv or shape not in PTXAS_OF:
        raise SystemExit(__doc__)
    dev = require_cuda()
    x, hist, grev, phase0, step, d, rows = (
        complex_bench_operands(dev) + (None,) if shape == "split2"
        else complex_general_operands(dev, shape))
    fns, ptxas = build(argv, shape, source)
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
            x.data_ptr(), None if rows is None else rows.data_ptr(),
            hist.data_ptr(), grev.data_ptr(), phase0.data_ptr(),
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
    print(json.dumps({"source": str(source), "shape": [s, t, c, k, d],
                      "outputs": ref.numel(),
                      "variants": res}))


if __name__ == "__main__":
    main(sys.argv[1:])
