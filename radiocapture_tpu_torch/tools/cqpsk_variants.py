"""Time builds of the CQPSK tracker kernel (``csrc/cqpsk_track.cu``) with
another block shape, ring or part of the work changed against the
package's build, on one CUDA card at the split2 → CQPSK bench shape (256
halves × 64 slots × 2500 samples of the CQPSK bank's output, mid-stream
after three steps, as ``track_turns.cqpsk_bench_planes`` makes them).

Each variant rewrites a copy of the source:

- ``tiles=N``: at most N 32-lane tiles a block (the package's 4);
- ``stage=N``: stages of N rows (the package's 24);
- ``stages=N``: N stages in a tile's ring (the package's 4);
- ``group=N``: the producer warps take N rows at a time (the package's
  4);
- ``symbol_warps=N``: N warps a tile for the symbols' atan2f and stores
  (the package's 2);
- ``libm_fmod``: ``fmodf`` for every ``floor_mod``, without the exact
  fast path;
- ``nco_inline``: each sample's NCO at the head of ``take_sample``, not
  the next sample's after this one;

and, each wrong on purpose, to show what one part of the work costs:

- ``consumer_alone``: the producer warps fill the ring and turn no rows
  into symbols: the feedback loop, its hand-over and the copies (no
  outputs are written, so its count of identical lanes says nothing);
- ``producers_alone``: the consumers hand each stage over as it lands,
  with no feedback loop (the producer warps turn the planes' samples,
  with no emits): the copies, interpolation, atan2f and stores;
- ``probe_store``: the chain probe with the consumer's two shared-memory
  stores a sample (the probe's cycles are the ones that change);
- ``no_gain``: the consumer takes the planes' samples without the AGC
  gain;
- ``no_sincos``: the NCO's ``sincosf`` replaced by two cheap operations;
- ``no_atan``: ``atan2f`` replaced by a subtraction (symbols and AFC);
- ``no_div``: the two IEEE divisions (by pi/4 and by omega) replaced by
  products;
- ``no_shift``: the 23-register history shift replaced by one add.

::

    python3 -m radiocapture_tpu_torch.tools.cqpsk_variants \\
        consumer_alone producers_alone probe_store tiles=1 group=2

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

SHIFT = """#pragma unroll
  for (int j = 0; j < HIST - 1; ++j) {
    L.hr[j] = L.hr[j + 1];
    L.hi[j] = L.hi[j + 1];
  }
  L.hr[HIST - 1] = xr;
  L.hi[HIST - 1] = xi;"""
NO_SHIFT = """  L.hr[HIST - 1] = __fadd_rn(L.hr[HIST - 1], xr);
  L.hi[HIST - 1] = __fadd_rn(L.hi[HIST - 1], xi);"""
CONSUME = ("  consume<N0F>(sm, L, scale[li], active ? N : 0, N, kc, lc, "
           "lane);\n")
# every stage handed over as it lands, no loop
PASS_THROUGH = """  for (int k = 0; k < (N + STAGE - 1) / STAGE; ++k) {
    mbar_wait(&sm.full[k % STAGES], parity_of(k));
    mbar_arrive(&sm.handed[k % STAGES]);
  }
"""
PROBE_TAKE = ("      if (take_sample(L, q, rows_re[r][lane], "
              "rows_im[r][lane])) {")
PROBE_TAKE_STORE = """      const bool e =
          take_sample(L, q, rows_re[r][lane], rows_im[r][lane]);
      sink_re[r][lane] = L.hr[HIST - 1];
      sink_im[r][lane] = L.hi[HIST - 1];
      if (e) {"""
PROBE_ROWS_DECL = ("  __shared__ float rows_re[PROBE_ROWS][32], "
                   "rows_im[PROBE_ROWS][32];\n")

# name -> [(text of the source, its replacement)]
EDITS = {
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
        ("        q = next_nco(L);\n        if (++i >= lim) break;",
         "        if (++i >= lim) break;"),
        ("    Nco q = next_nco(L);\n    while (i < steps) {",
         "    const Nco q{};\n    while (i < steps) {"),
        ("      q = next_nco(L);\n      ++i;", "      ++i;")],
    "consumer_alone": [("    if (active)\n      interpolate_rows(",
                        "    if (false)\n      interpolate_rows("),
                       ("    if (active)\n      store_symbols(",
                        "    if (false)\n      store_symbols(")],
    "producers_alone": [(CONSUME, PASS_THROUGH)],
    "no_gain": [("take_sample(L, q, __fmul_rn(are, gain), __fmul_rn(aim, "
                 "gain))", "take_sample(L, q, are, aim)")],
    "probe_store": [(PROBE_TAKE, PROBE_TAKE_STORE),
                    (PROBE_ROWS_DECL, PROBE_ROWS_DECL.replace(
                        ";", ",\n      sink_re[PROBE_ROWS][32], "
                        "sink_im[PROBE_ROWS][32];"))],
}
# name -> (the constant's line, the package's value)
SIZED = {"tiles": ("constexpr int MAX_TILES = {};", 4),
         "stage": ("constexpr int STAGE = {};", 24),
         "stages": ("constexpr int STAGES = {};", 4),
         "group": ("constexpr int GROUP = {};", 4),
         "symbol_warps": ("constexpr int SYMBOL_WARPS = {};", 2)}


def variant_source(src: str, name: str) -> str:
    """The package's source with the variant ``name``'s edits; each edited
    text must occur once."""
    key, _, size = name.partition("=")
    if key in SIZED and size.isdigit():
        line, value = SIZED[key]
        edits = [(line.format(value), line.format(int(size)))]
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
