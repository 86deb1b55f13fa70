"""Time builds of the analog voice kernel (``csrc/fm_voice.cu``) with
other plan constants against the package's build, on one CUDA card at the
bench shape (128 sources × 64 slots × 2500 samples of the analog bank's
output, random-normal bf16 wire, mid-stream after three steps).

Each variant is ``CHUNK,WARPS,MINBLOCKS`` (samples per thread per time
tile, chunks per time tile, the ``__launch_bounds__`` minimum of blocks
per SM), optionally followed by ``,probe``: the discriminator's
``atan2f`` replaced by a product, which gives wrong audio and shows what
the arithmetic costs::

    python3 -m radiocapture_tpu_torch.tools.voice_variants \\
        16,16,2 8,16,2 12,16,2 16,8,2 16,16,2,probe

Every variant is built with the package's flags (all at once, one nvcc
process each) into ``_build/variants/`` and checked against the
package's build from a zero lane state (largest audio difference over
max|audio|, ``x_last`` identical). The kernels then run in three rounds,
the order reversed in the second, ITERS launches each timed by CUDA
events. Prints each variant's ptxas register/spill line, the checks, the
times, the card's ``nvidia-smi`` name and power limit, then one JSON
line.
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
from radiocapture_tpu_torch.ops import fm
from radiocapture_tpu_torch.ops import fm_kernel as fk
from radiocapture_tpu_torch.tools.track_turns import (SLOTS, SOURCES,
                                                      card_line, cuda_ms,
                                                      voice_bench_planes)

ITERS = 20
ROUNDS = 3


def parse(spec: str) -> tuple:
    parts = spec.split(",")
    if len(parts) not in (3, 4) or parts[3:] not in ([], ["probe"]):
        raise SystemExit(__doc__)
    return (int(parts[0]), int(parts[1]), int(parts[2])) + tuple(parts[3:])


def variant_source(src: str, v: tuple) -> str:
    chunk, warps, min_blocks = v[:3]
    out = re.sub(r"constexpr int CHUNK = \d+;",
                 f"constexpr int CHUNK = {chunk};", src)
    out = re.sub(r"constexpr int WARPS = \d+;",
                 f"constexpr int WARPS = {warps};", out)
    out = out.replace("__launch_bounds__(THREADS, 2)",
                      f"__launch_bounds__(THREADS, {min_blocks})")
    if "probe" in v:
        out = out.replace("atan2f(dim, dre)", "(dim * dre)")
    return out


def build(variants: list) -> dict:
    """Each variant's ``fm_voice_launch``, and its ptxas line."""
    src = (kernels.CSRC / "fm_voice.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in variants:
        tag = "_".join(map(str, v))
        cu = out_dir / f"fm_voice_{tag}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(variant_source(src, v))
        procs[v] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for v, (so, proc) in procs.items():
        text = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {v}:\n{text}")
        lines = text.splitlines()
        at = max(i for i, l in enumerate(lines) if "fm_voice_kernel" in l)
        print(v, " | ".join(l.strip() for l in lines[at + 1:at + 3]))
        fn = ctypes.CDLL(str(so)).fm_voice_launch
        fn.argtypes = list(kernels._SIGNATURES["fm_voice_launch"])
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def main(argv: list[str]) -> None:
    if not argv:
        raise SystemExit(__doc__)
    variants = [parse(a) for a in argv]
    dev = require_cuda()
    fns = build(variants)
    fns["package"] = kernels.load().fm_voice_launch
    y_re, y_im, pipe = voice_bench_planes(dev)

    def fresh():
        return (fm.quad_demod_init((SOURCES, SLOTS), dev),
                fm.deemph_init((SOURCES, SLOTS), dev))

    def run(k, st):
        args, outs = fk.kernel_args(y_re, y_im, *st, pipe.gain,
                                    pipe.channel_fs)
        if k != "package":          # the variant's own plan constants
            args = args[:13] + (k[0], k[1]) + args[15:]
        kernels.check(fns[k](*args), f"fm_voice {k}")
        return outs

    keys = ["package"] + variants
    ref_st = fresh()
    ref = run("package", ref_st)[0]
    checks = {}
    for k in variants:
        st = fresh()
        audio = run(k, st)[0]
        torch.cuda.synchronize()
        checks[str(k)] = {
            "audio_rel_diff": float((audio - ref).abs().max()
                                    / ref.abs().max()),
            "x_last_identical": bool(torch.equal(st[1].x_last,
                                                 ref_st[1].x_last))}
        print("check", k, checks[str(k)])
    states = {str(k): fresh() for k in keys}
    ms = {str(k): [] for k in keys}
    for r in range(ROUNDS):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            ms[str(k)].append(cuda_ms(lambda: run(k, states[str(k)]),
                                      ITERS))
    for k in keys:
        print("ms", k, " ".join(f"{t:.4f}" for t in ms[str(k)]))
    print(card_line())
    print(json.dumps({"shape": list(y_re.shape),
                      "ms": ms, "checks": checks}))


if __name__ == "__main__":
    main(sys.argv[1:])
