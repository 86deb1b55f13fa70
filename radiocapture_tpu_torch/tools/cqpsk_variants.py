"""Time builds of the CQPSK tracker kernel (``csrc/cqpsk_track.cu``) with
another launch shape, ring depth or part of the chain changed against the
package's build, on one CUDA card at the split2 → CQPSK bench shape (256
halves × 64 slots × 2500 samples of the CQPSK bank's output, mid-stream
after three steps, as ``track_turns.cqpsk_bench_planes`` makes them).

Each variant rewrites a copy of the source:

- ``threads=N``: N-thread blocks (the package's are 64);
- ``ring=N``: a ring of N rows per warp (16, 32 or 64; the package's 64);
- ``flush1``, ``flush4``: the ring's flush turns one or four rows at a
  time into symbols (the package's two);
- ``libm_fmod``: ``fmodf`` for every ``floor_mod``, without the exact
  fast path;
- ``nco_inline``: each sample's NCO at the head of ``take_sample``, not
  the next sample's beside this one's outputs;

and, each wrong on purpose, to show what one part of the chain costs:

- ``no_sincos``: the NCO's ``sincosf`` replaced by two cheap operations;
- ``no_atan``: ``atan2f`` replaced by a subtraction (symbols and AFC);
- ``no_div``: the two IEEE divisions (by pi/4 and by omega) replaced by
  products;
- ``no_shift``: the 23-register history shift replaced by one add.

::

    python3 -m radiocapture_tpu_torch.tools.cqpsk_variants \\
        threads=32 threads=128 ring=32 flush1 no_sincos no_atan

Every variant is built with the package's flags (all at once, one nvcc
process each) into ``_build/variants/``; for each its ptxas line (the
bench's instantiation), whether its outputs and state are bit-identical
to the package's on every lane, its kernel ms in ROUNDS rounds (the
order reversed every other round, ITERS launches each timed by CUDA
events) and the clock64 cycles of its chain probe (``chip_smoke.py``'s
32 lanes and rows, median of 3) against the package's. Prints the card's
``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.demod import cqpsk as cq
from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.tools.track_turns import (card_line,
                                                      cqpsk_bench_planes,
                                                      cqpsk_same_lanes,
                                                      cuda_ms)

ITERS = 10
ROUNDS = 4

FLUSH2 = """      for (; r + 1 < hi; r += 2) {
        const float a0 = arg_of(z_at(r));
        const float a1 = arg_of(z_at(r + 1));
        store_row(r, a0);
        store_row(r + 1, a1);
      }
      if (r < hi) store_row(r, arg_of(z_at(r)));"""
FLUSH1 = "      for (; r < hi; ++r) store_row(r, arg_of(z_at(r)));"
FLUSH4 = """      for (; r + 3 < hi; r += 4) {
        float g[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) g[k] = arg_of(z_at(r + k));
#pragma unroll
        for (int k = 0; k < 4; ++k) store_row(r + k, g[k]);
      }
      for (; r < hi; ++r) store_row(r, arg_of(z_at(r)));"""
SHIFT = """#pragma unroll
  for (int j = 0; j < HIST - 1; ++j) {
    L.hr[j] = L.hr[j + 1];
    L.hi[j] = L.hi[j + 1];
  }
  L.hr[HIST - 1] = xr;
  L.hi[HIST - 1] = xi;"""
NO_SHIFT = """  L.hr[HIST - 1] = __fadd_rn(L.hr[HIST - 1], xr);
  L.hi[HIST - 1] = __fadd_rn(L.hi[HIST - 1], xi);"""

# name -> [(text of the source, its replacement)]
EDITS = {
    "flush1": [(FLUSH2, FLUSH1)],
    "flush4": [(FLUSH2, FLUSH4)],
    "libm_fmod": [("  const float ax = fabsf(x);\n",
                   "  return fmodf(x, y);\n  const float ax = fabsf(x);\n")],
    "no_sincos": [("  sincosf(q.phase, &q.sn, &q.cs);",
                   "  q.sn = q.phase;\n  q.cs = __fsub_rn(1.0f, q.phase);")],
    "no_atan": [("atan2f(z.i, z.r)", "__fsub_rn(z.i, z.r)")],
    "no_div": [("__fdiv_rn(atan2f(z.i, z.r), kQuarterPi)",
                "__fmul_rn(atan2f(z.i, z.r), kQuarterPi)"),
               ("__fdiv_rn(__fmul_rn(lc.k_f, err),",
                "__fmul_rn(__fmul_rn(lc.k_f, err),")],
    "no_shift": [(SHIFT, NO_SHIFT)],
    # take_sample runs its own NCO; the one handed to it goes unused
    "nco_inline": [
        ("  L.phase = q.phase;\n  const float sn = q.sn, cs = q.cs;\n",
         "  const Nco own = next_nco(L);\n  L.phase = own.phase;\n"
         "  const float sn = own.sn, cs = own.cs;\n"),
        ("      Nco q = next_nco(L);\n      for (;;) {",
         "      const Nco q{};\n      for (;;) {"),
        ("        q = next_nco(L);                  // beside this sample's "
         "outputs\n", ""),
        ("    Nco q = next_nco(L);\n    while (i < steps) {",
         "    const Nco q{};\n    while (i < steps) {"),
        ("      q = next_nco(L);\n      ++i;", "      ++i;")],
}
SIZED = {"threads": "constexpr int THREADS = {};",
         "ring": "constexpr int RING = {};"}


def variant_source(src: str, name: str) -> str:
    """The package's source with the variant ``name``'s edits; each edited
    text must occur once."""
    key, _, size = name.partition("=")
    if key in SIZED and size.isdigit():
        edits = [(SIZED[key].format(64), SIZED[key].format(int(size)))]
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


def build(names: list, n0_first: int) -> tuple:
    """({variant: (its ``cqpsk_track_launch``, its
    ``cqpsk_chain_probe_launch``)}, {variant: its ptxas line for the
    kernel instance ``n0_first``})."""
    src = (kernels.CSRC / "cqpsk_track.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"cqpsk_track_{name.replace('=', '')}.cu"
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
                 if f"cqpsk_track_kernelILi{n0_first}E" in l)
        ptxas[name] = " | ".join(l.split(":", 1)[-1].strip()
                                 for l in lines[at + 1:at + 3])
        print(name, ptxas[name], flush=True)
        lib = ctypes.CDLL(str(so))
        pair = []
        for entry in ("cqpsk_track_launch", "cqpsk_chain_probe_launch"):
            fn = getattr(lib, entry)
            fn.argtypes = list(kernels._SIGNATURES[entry])
            fn.restype = ctypes.c_int
            pair.append(fn)
        fns[name] = tuple(pair)
    return fns, ptxas


def main(argv: list[str]) -> None:
    if not argv:
        raise SystemExit(__doc__)
    dev = require_cuda()
    y_re, y_im, scale, state, pipe = cqpsk_bench_planes(dev)
    fs, baud = pipe.channel_fs, pipe.symbol_rate
    fns, ptxas = build(argv, cq.cqpsk_params(fs, baud).half_n0s[0])
    lib = kernels.load()
    fns["package"] = (lib.cqpsk_track_launch, lib.cqpsk_chain_probe_launch)

    def fresh():
        return type(state)(*(t.clone() for t in state))

    def run(k, st):
        args, outs = cqk.kernel_args(y_re, y_im, scale, st, fs, baud)
        kernels.check(fns[k][0](*args), f"cqpsk_track {k}")
        return outs

    lanes = type(state)(*(t[0, :32].contiguous() for t in state))
    rows = [(p[0, :cqk.PROBE_ROWS, :32] * scale[0, None, :32]).contiguous()
            for p in (y_re, y_im)]

    def cycles(k):
        def probe():
            return cqk.chain_probe(*rows, type(lanes)(*(t.clone()
                                                        for t in lanes)),
                                   y_re.shape[1], fs, baud, fns[k][1])
        probe()
        return sorted(probe() for _ in range(3))[1]

    keys = ["package"] + argv
    ref_st = fresh()
    ref = run("package", ref_st)
    res = {k: {"ptxas": ptxas.get(k), "cycles": cycles(k), "ms": []}
           for k in keys}
    for k in argv:
        st = fresh()
        outs = run(k, st)
        same = cqpsk_same_lanes(outs, st, ref, ref_st)
        res[k]["identical_lanes"] = int(same.sum())
    states = {k: fresh() for k in keys}
    for r in range(ROUNDS):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            res[k]["ms"].append(cuda_ms(lambda: run(k, states[k]), ITERS))
    lanes_n = y_re.shape[0] * y_re.shape[2]
    for k in keys:
        print(k, "ms", " ".join(f"{t:.4f}" for t in res[k]["ms"]),
              "cycles", res[k]["cycles"], "identical lanes",
              res[k].get("identical_lanes", lanes_n), "of", lanes_n)
    print(card_line())
    print(json.dumps({"shape": list(y_re.shape), "lanes": lanes_n,
                      "variants": res}))


if __name__ == "__main__":
    main(sys.argv[1:])
