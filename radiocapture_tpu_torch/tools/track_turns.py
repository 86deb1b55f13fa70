"""Time another build of the fsk tracker kernel against the package's,
in turns, on one CUDA card at the C4FM bench shape, and count the lanes
whose outputs and carried state are bit-identical between the two (and
the share of samples whose symbol, emit flag and dibit agree).

The other source (an earlier ``csrc/fsk_track.cu``, for instance) must
export ``fsk_track_launch`` with the package's C signature::

    git show <commit>:radiocapture_tpu_torch/csrc/fsk_track.cu > old.cu
    python3 -m radiocapture_tpu_torch.tools.track_turns old.cu

The planes are the bank's output at the bench shape (128 sources × 64
slots × 2500 samples, random-normal bf16 wire, mid-stream after three
steps), as ``chip_smoke.py`` times them. Kernels run in the order other,
package, package, other, each over ITERS launches timed by CUDA events.
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.demod import track_kernel as tk
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
from radiocapture_tpu_torch.ops import channelizer_kernel as ck

SOURCES, SLOTS, BLOCK, SAMP_RATE = 128, 64, 240_000, 2.4e6
ITERS = 10


def build_other(src: Path):
    """``src`` compiled with the package's flags into its own library;
    its ``fsk_track_launch`` bound with the package's signature."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = kernels.BUILD_DIR / "turns" / f"libfsk_track_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                    "-o", str(out), str(src)], check=True, timeout=600)
    fn = ctypes.CDLL(str(out)).fsk_track_launch
    fn.argtypes = list(kernels._SIGNATURES["fsk_track_launch"])
    fn.restype = ctypes.c_int
    return fn


def leaves(state) -> tuple:
    """The tracker's lane state as real [S, C, ...] tensors."""
    quad, sym_hist, fsk4 = state
    return (torch.view_as_real(quad.prev), sym_hist, *fsk4)


def cuda_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv: list[str]) -> None:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    other = build_other(Path(argv[0]))
    pipe = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((SOURCES, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = ((torch.arange(SLOTS, device=dev) - SLOTS // 2) * 25e3
            / SAMP_RATE).expand(SOURCES, SLOTS).contiguous()
    state = pipe.init(SOURCES, dev)
    for _ in range(3):
        state, _ = pipe.step(state, x, offs)
    n = BLOCK // pipe.decim
    z2, gk, step = pipe.bank.operands(state.bank, x, offs)
    y_re, y_im = ck.bank_fused(z2, gk, state.bank.phase, step, n,
                               pipe.bank.p, pipe.decim)
    prm = pipe.track_params

    def lane_state():
        return (state.quad._replace(prev=state.quad.prev.clone()),
                state.sym_hist.clone(),
                type(state.fsk4)(*(t.clone() for t in state.fsk4)))

    def run(launch, st):
        args, outs = tk.kernel_args(y_re, y_im, *st, prm)
        kernels.check(launch(*args), "fsk_track")
        return outs

    package = kernels.load().fsk_track_launch
    timed = {"other": lane_state(), "package": lane_state()}
    launch = {"other": other, "package": package}
    ms = {"other": [], "package": []}
    for k in ("other", "package", "package", "other"):
        ms[k].append(cuda_ms(lambda: run(launch[k], timed[k]), ITERS))
    st = {k: lane_state() for k in launch}
    outs = {k: run(launch[k], st[k]) for k in launch}
    torch.cuda.synchronize()
    same = torch.ones((SOURCES, SLOTS), dtype=torch.bool, device=dev)
    for a, b in zip(outs["other"], outs["package"]):      # [S, M, C]
        same &= (a == b).all(1)
    for a, b in zip(leaves(st["other"]), leaves(st["package"])):
        same &= (a == b).reshape(SOURCES, SLOTS, -1).all(-1)
    agree = {name: float((a == b).float().mean()) for name, a, b in zip(
        ("syms", "valid", "dibits"), outs["other"], outs["package"])}
    print(card)
    print(json.dumps({
        "shape": [SOURCES, n, SLOTS], "other": argv[0],
        "other_ms": ms["other"], "package_ms": ms["package"],
        "speedup": sum(ms["other"]) / sum(ms["package"]),
        "identical_lanes": int(same.sum()), "lanes": same.numel(),
        "identical_lane_share": float(same.float().mean()),
        "sample_agreement": agree}))


if __name__ == "__main__":
    main(sys.argv[1:])
