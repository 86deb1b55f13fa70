"""Time another build of a tracker kernel against the package's, in
turns, on one CUDA card at the bench shape, and compare their outputs.

``--kernel fsk_track`` (the default): the other source (an earlier
``csrc/fsk_track.cu``, for instance) must export ``fsk_track_launch``
with the package's C signature; the tool counts the lanes whose outputs
and carried state are bit-identical between the two (and the share of
samples whose symbol, emit flag and dibit agree)::

    git show <commit>:radiocapture_tpu_torch/csrc/fsk_track.cu > old.cu
    python3 -m radiocapture_tpu_torch.tools.track_turns old.cu

``fsk_track_3e03d30.cu`` beside this module is the tracker as commit
3e03d30 had it, before the stream entry was added to the file; the
package's ``fsk_track`` must give its outputs bit for bit
(``chip_smoke.py`` and ``tests/test_torch_card.py`` call ``fsk_turns``).

``--kernel fm_voice``: the other source must export ``fm_voice_launch``
with the one-thread-per-lane kernel's signature (the package's without
``chunk`` and ``warps``); ``fm_voice_334afe8.cu`` beside this module is
that kernel as commit 334afe8 had it. The tool gives the largest audio
difference over max|audio|, the share of lanes whose ``x_last`` is
bit-identical and the largest relative power difference::

    python3 -m radiocapture_tpu_torch.tools.track_turns --kernel fm_voice \
        radiocapture_tpu_torch/tools/fm_voice_334afe8.cu

``--kernel cqpsk_track``: the other source must export
``cqpsk_track_launch`` with the package's C signature;
``cqpsk_track_54b2cf5.cu`` beside this module is the per-sample-loop
kernel as commit 54b2cf5 had it, and ``cqpsk_track_b498eb2.cu`` the
symbol-major kernel with one thread a lane doing all the work, as commit
b498eb2 had it, before the producer warps. The tool counts the lanes
whose three outputs and eight state tensors are bit-identical::

    python3 -m radiocapture_tpu_torch.tools.track_turns --kernel \
        cqpsk_track radiocapture_tpu_torch/tools/cqpsk_track_b498eb2.cu

``--kernel xlat_complex``: the other source must export
``xlat_complex_launch`` with the signature of the kernel the package's
replaced, which reads history ++ block as one complex64 ``z``
(``COMPLEX_Z_SIGNATURE``); ``xlat_complex_54b2cf5.cu`` beside this module
is that kernel as commit 54b2cf5 had it. The tool times that kernel's
chain (the block converted to float32, concatenated behind the history,
then the other kernel) against the package's ``bank_complex`` on the
block in place, then the two kernels alone on the same complex64 values,
and counts the outputs that are bit-identical::

    python3 -m radiocapture_tpu_torch.tools.track_turns --kernel \
        xlat_complex radiocapture_tpu_torch/tools/xlat_complex_54b2cf5.cu

``--shape mesh`` (after ``--kernel xlat_complex``) takes the complex
bank's general path instead, the kernels alone on the same complex64
values: the time-sharded mesh step's bank (128 sources × 64 slots × 2503
outputs, K = 1440, D = 96, a float32 block); 54b2cf5's kernel is the
general path the package's replaced, the same loop::

    python3 -m radiocapture_tpu_torch.tools.track_turns --kernel \
        xlat_complex --shape mesh \
        radiocapture_tpu_torch/tools/xlat_complex_54b2cf5.cu

``--kernel pfb_bins``: the other source must export ``pfb_bins_launch``
with the signature of commit ef6af1a (the direct [M, M] table, no
factors: ``BINS_DIRECT_SIGNATURE``), driven with the direct table's plan;
``pfb_rows_ef6af1a.cu`` beside this module is that kernel, driven with
that commit's plan (``ef6af1a_plan``). The tool times
it against the package's ``pfb_bins`` on the same operands at the cases
of ``pfb_variants.py`` (M = 6 at the bench shape, 128 sources × 240,000
bf16 samples; M = 8 to 100 at 16 sources × 100 ms), and gives the
largest difference between their bins over max|bins| and whether their
new histories are bit-identical::

    python3 -m radiocapture_tpu_torch.tools.track_turns --kernel \
        pfb_bins radiocapture_tpu_torch/tools/pfb_rows_ef6af1a.cu

``--kernel pfb_fine``: the other source must export ``pfb_fine_launch``
with the signature the kernel had before it wrote the trackers' planes
(one complex64 row a slot: ``FINE_ROWS_SIGNATURE``), as the parent
commit's ``csrc/pfb_fine.cu`` has it; take it from that commit's
``git archive``. On the fine stage's bench operands
(``fine_bench_operands``) and their first 256 and 64 rows (the
runtime's groups), each kernel at its own plan's rows a block (the
other's ``fine_rows_plan``, the package's ``fine_plan``), the tool
times the two kernels alone in turns, then the other kernel followed by
``planes()`` (the step's path before) against the package's, and counts
the plane elements that are bit-identical to ``planes()`` of the other's
rows::

    mkdir -p _chip/parent && git archive <commit> \
        radiocapture_tpu_torch/csrc/pfb_fine.cu | tar -x -C _chip/parent
    python3 -m radiocapture_tpu_torch.tools.track_turns --kernel \
        pfb_fine _chip/parent/radiocapture_tpu_torch/csrc/pfb_fine.cu

The planes are the bank's output at the bench shape (128 sources × 64
slots × 2500 samples, random-normal bf16 wire, mid-stream after three
steps; for ``cqpsk_track`` the split2 → CQPSK shape, 256 halves × 64
slots × 2500 samples; for ``xlat_complex`` split2's own operands, 128
sources × 240,000 bf16 wire samples), as ``chip_smoke.py`` times them;
``chip_smoke.py`` calls ``voice_turns``, ``cqpsk_turns``,
``complex_turns`` and ``bins_turns`` on its own operands. Kernels run in
the order other, package, package, other, each over ITERS launches timed
by CUDA events. Prints the card's ``nvidia-smi`` name and power limit,
then one JSON line.
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
from radiocapture_tpu_torch.demod import cqpsk as cq
from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
from radiocapture_tpu_torch.demod import track_kernel as tk
from radiocapture_tpu_torch.device import require_cuda
from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                      ControlPipeline,
                                                      CqpskControlPipeline,
                                                      SpectrumSplit2,
                                                      split2_sources)
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.channelizer import planes
from radiocapture_tpu_torch.ops import fm
from radiocapture_tpu_torch.ops import fm_kernel as fk
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.fir import phase_step_u32

SOURCES, SLOTS, BLOCK, SAMP_RATE = 128, 64, 240_000, 2.4e6
ITERS = 10
EARLIER_VOICE = Path(__file__).with_name("fm_voice_334afe8.cu")
EARLIER_CQPSK = Path(__file__).with_name("cqpsk_track_54b2cf5.cu")
SYMBOL_MAJOR_CQPSK = Path(__file__).with_name("cqpsk_track_b498eb2.cu")
EARLIER_COMPLEX = Path(__file__).with_name("xlat_complex_54b2cf5.cu")
EARLIER_FSK = Path(__file__).with_name("fsk_track_3e03d30.cu")
EARLIER_BINS = Path(__file__).with_name("pfb_rows_ef6af1a.cu")
CQ_GRID_HZ = 12.5e3      # the CQPSK slot grid around each split2 half
# fm_voice_launch of the one-thread-per-lane kernel: y_re, y_im, prev,
# y_last, x_last, audio, power, S, N, C, gain, z1, b0, stream
VOICE_LANE_SIGNATURE = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3
                        + (ctypes.c_float,) * 3 + (ctypes.c_void_p,))
# xlat_complex_launch of commit 54b2cf5: z, g, phase0, step, y, S, N, K, D,
# C, z_len, stream
COMPLEX_Z_SIGNATURE = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
                       + (ctypes.c_longlong, ctypes.c_void_p))
# pfb_bins_launch of commit ef6af1a: hist, x, hp2, table, bins, new_hist,
# S, T, M, P, x_bf16, k, wb, slabs, stream
BINS_DIRECT_SIGNATURE = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 8
                         + (ctypes.c_void_p,))
# pfb_fine_launch before the planes store: x, xrow, hist, taps, fine,
# phase0, step, y, S, T, N, K, rb, stream
FINE_ROWS_SIGNATURE = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5
                       + (ctypes.c_void_p,))
FINE_ROWS = (8192, 256, 64)   # the bench's slot rows, the runtime's groups


def build_other(src: Path, entry: str = "fsk_track_launch",
                argtypes: tuple | None = None):
    """``src`` compiled with the package's flags into its own library
    (once: the library's name holds the hash of the source and flags);
    its ``entry`` bound with ``argtypes`` (the package's signature of
    ``entry`` by default)."""
    tag = hashlib.sha256(Path(src).read_bytes() + " ".join(
        kernels.NVCC_FLAGS).encode()).hexdigest()[:16]
    out = kernels.BUILD_DIR / "turns" / f"lib{Path(src).stem}_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        tmp = out.with_suffix(".tmp.so")
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared",
                        "-o", str(tmp), str(src)], check=True, timeout=600)
        tmp.replace(out)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = list(argtypes or kernels._SIGNATURES[entry])
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


def voice_turns(src: Path, y_re: torch.Tensor, y_im: torch.Tensor,
                gain: float, samp_rate: float, iters: int = ITERS) -> dict:
    """The fm_voice kernel built from ``src`` (the one-thread-per-lane
    signature) against the package's on the CUDA planes y_re, y_im
    [S, N, C], each from a zero lane state: ms of each in turns (other,
    package, package, other), the speedup, the largest audio difference
    over max|audio|, the share of lanes whose ``x_last`` is bit-identical
    and the largest relative power difference."""
    other = build_other(Path(src), "fm_voice_launch", VOICE_LANE_SIGNATURE)
    launch = {"other": other, "package": kernels.load().fm_voice_launch}
    s, _n, c = y_re.shape

    def fresh():
        return (fm.quad_demod_init((s, c), y_re.device),
                fm.deemph_init((s, c), y_re.device))

    def run(k, st):
        args, outs = fk.kernel_args(y_re, y_im, *st, gain, samp_rate)
        if k == "other":            # no chunk, warps
            args = args[:13] + args[15:]
        kernels.check(launch[k](*args), "fm_voice")
        return outs

    timed = {k: fresh() for k in launch}
    ms = {"other": [], "package": []}
    for k in ("other", "package", "package", "other"):
        ms[k].append(cuda_ms(lambda: run(k, timed[k]), iters))
    st = {k: fresh() for k in launch}
    outs = {k: run(k, st[k]) for k in launch}
    torch.cuda.synchronize()
    (a_o, p_o), (a_p, p_p) = outs["other"], outs["package"]
    return {"shape": list(y_re.shape), "other": str(src),
            "other_ms": ms["other"], "package_ms": ms["package"],
            "speedup": sum(ms["other"]) / sum(ms["package"]),
            "audio_rel_diff": float((a_o - a_p).abs().max()
                                    / a_p.abs().max()),
            "x_last_identical_share": float(
                (st["other"][1].x_last == st["package"][1].x_last)
                .float().mean()),
            "power_rel_diff": float(((p_o - p_p).abs() / p_p.abs()).max())}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """float32 as its int32 bits, so that -0.0 and 0.0 differ."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def cqpsk_same_lanes(outs_a, st_a, outs_b, st_b) -> torch.Tensor:
    """[S, C] bool: the lanes whose three outputs (time-major [S, N, C])
    and eight state tensors ([S, C, ...]) are bit-identical in two runs."""
    s, _n, c = outs_a[0].shape
    same = torch.ones((s, c), dtype=torch.bool, device=outs_a[0].device)
    for a, b in zip(outs_a, outs_b):
        same &= (_bits(a) == _bits(b)).all(1)
    for a, b in zip(st_a, st_b):
        same &= (_bits(a) == _bits(b)).reshape(s, c, -1).all(-1)
    return same


def cqpsk_turns(src: Path, y_re: torch.Tensor, y_im: torch.Tensor,
                scale: torch.Tensor, state_fn, samp_rate: float,
                symbol_rate: float, iters: int = ITERS) -> dict:
    """The cqpsk_track kernel built from ``src`` (the package's C
    signature) against the package's on the CUDA planes y_re, y_im
    [S, N, C] with AGC gain ``scale`` [S, C], each from a fresh copy ``state_fn()`` of the lane state (both update it in
    place): ms of each in turns (other, package, package, other), the
    speedup, the lanes whose three outputs and eight state tensors are
    bit-identical, and the share of samples whose outputs are."""
    other = build_other(Path(src), "cqpsk_track_launch")
    launch = {"other": other, "package": kernels.load().cqpsk_track_launch}
    s, n, c = y_re.shape

    def run(k, st):
        args, outs = cqk.kernel_args(y_re, y_im, scale, st, samp_rate,
                                     symbol_rate)
        kernels.check(launch[k](*args), "cqpsk_track")
        return outs

    timed = {k: state_fn() for k in launch}
    ms = {"other": [], "package": []}
    for k in ("other", "package", "package", "other"):
        ms[k].append(cuda_ms(lambda: run(k, timed[k]), iters))
    st = {k: state_fn() for k in launch}
    outs = {k: run(k, st[k]) for k in launch}
    torch.cuda.synchronize()
    same = cqpsk_same_lanes(outs["other"], st["other"], outs["package"],
                            st["package"])
    return {"shape": [s, n, c], "other": str(src),
            "other_ms": ms["other"], "package_ms": ms["package"],
            "speedup": sum(ms["other"]) / sum(ms["package"]),
            "identical_lanes": int(same.sum()), "lanes": same.numel(),
            "identical_lane_share": float(same.float().mean()),
            "sample_agreement": {
                name: float((_bits(a) == _bits(b)).float().mean())
                for name, a, b in zip(("syms", "valid", "dibits"),
                                      outs["other"], outs["package"])}}


def identical_outputs(a: torch.Tensor, b: torch.Tensor) -> int:
    """The complex64 outputs whose real and imaginary bits both agree."""
    return int((_bits(torch.view_as_real(a)) == _bits(torch.view_as_real(b)))
               .all(-1).sum())


def complex_turns(src: Path, x: torch.Tensor, history: torch.Tensor,
                  grev: torch.Tensor, phase0: torch.Tensor,
                  step: torch.Tensor, d: int, iters: int = ITERS,
                  pairings: tuple = ("chain", "kernel")) -> dict:
    """The complex bank built from ``src`` (commit 54b2cf5's signature, one
    complex64 z) against the package's on the CUDA operands of one step:
    the wire block x [S, T, 2] and the history [S, K-1]. In turns (other,
    package, package, other), for each of ``pairings``: ``chain``, that
    kernel's chain (x to float32, history ++ block, the other kernel)
    against ``bank_complex`` on x in place; ``kernel``, the two kernels
    alone on the same complex64 values (the other on z, the package on
    the block's float32 view and the history). Counts the outputs that
    are bit-identical in each pairing."""
    other = build_other(Path(src), "xlat_complex_launch",
                        COMPLEX_Z_SIGNATURE)
    t = x.shape[1]
    s, c, k = grev.shape
    n = t // d
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def old_kernel(z):
        y = torch.empty((s, c, n), dtype=torch.complex64, device=x.device)
        kernels.check(other(z.data_ptr(), grev.data_ptr(), phase0.data_ptr(),
                            step.data_ptr(), y.data_ptr(), s, n, k, d, c,
                            z.shape[1], stream), "xlat_complex")
        return y

    z = ck.complex_z(x, history)
    xz = torch.view_as_real(z[:, k - 1:].contiguous())  # z's block, f32
    pairs = {"chain": (lambda: old_kernel(ck.complex_z(x, history)),
                       lambda: ck.bank_complex(x, history, grev, phase0,
                                               step, d)),
             "kernel": (lambda: old_kernel(z),
                        lambda: ck.bank_complex(xz, history, grev, phase0,
                                                step, d))}
    res = {"shape": [s, t, c, k, d], "wire": str(x.dtype).split(".")[-1],
           "other": str(src), "outputs": s * c * n}
    for name in pairings:
        old, new = pairs[name]
        ms = {"other": [], "package": []}
        for who, fn in (("other", old), ("package", new), ("package", new),
                        ("other", old)):
            ms[who].append(cuda_ms(fn, iters))
        res[f"{name}_other_ms"] = ms["other"]
        res[f"{name}_package_ms"] = ms["package"]
        res[f"{name}_speedup"] = sum(ms["other"]) / sum(ms["package"])
        res[f"{name}_identical_outputs"] = identical_outputs(old(), new())
    return res


def ef6af1a_plan(m: int, p: int, bf16: bool) -> tuple[int, int, int]:
    """The plan commit ef6af1a's ``pfb_bins`` took: (k, wb, slabs), ⌈M/16⌉
    rounds of wb = ⌈M/rounds⌉ warps, the wire's K unless its planes and
    [M, M] table (padded to chunks of 8 channels) pass the shared memory
    a block can use, then K_SMALL."""
    wb = -(-m // -(-m // pk.MB_MAX))
    slabs = 1 if wb >= pk.WARPS_MAX else pk.WARPS_MAX // wb
    cpad = -(-m // 8) * 8
    for k in (pk.WIRE_K[bf16], pk.K_SMALL):
        if 8 * m * (cpad + slabs * 32 * k + p - 1) + 4 * m * p <= pk.SMEM_MAX:
            return k, wb, slabs
    raise ValueError(f"pfb_bins of ef6af1a: no plan for M={m}, P={p}")


def _direct_bins(other, hist: torch.Tensor, x: torch.Tensor,
                 hp2: torch.Tensor):
    """(bins, new history) from ``other``, a ``pfb_bins_launch`` of commit
    ef6af1a's signature, on that commit's plan (``ef6af1a_plan``)."""
    m, p = hp2.shape
    xr = torch.view_as_real(x) if x.is_complex() else x
    s, t = xr.shape[:2]
    bf16 = xr.dtype == torch.bfloat16
    k, wb, slabs = ef6af1a_plan(m, p, bf16)
    table = pk.device_table(m, 1, m, x.device)
    bins = torch.empty((s, m, t // m), dtype=torch.complex64,
                       device=x.device)
    nh = torch.empty_like(hist)
    kernels.check(other(hist.data_ptr(), xr.data_ptr(), hp2.data_ptr(),
                        table.data_ptr(), bins.data_ptr(), nh.data_ptr(), s,
                        t, m, p, int(bf16), k, wb, slabs,
                        torch.cuda.current_stream(x.device).cuda_stream),
                  "pfb_bins")
    return bins, nh


def bins_turns(src: Path, hist: torch.Tensor, x: torch.Tensor,
               hp2: torch.Tensor, iters: int = ITERS) -> dict:
    """``pfb_bins`` built from ``src`` (commit ef6af1a's signature, driven
    with that commit's plan) against the package's on the
    same CUDA operands: the history [S, (P-1)·M], the block x (an [S, T,
    2] wire block or [S, T] complex64) and the taps hp2 [M, P]. Returns
    the ms of each in turns (other, package, package, other), after one
    untimed run of each, the speedup, the largest difference between
    their bins over max|bins| and whether their new histories are
    bit-identical."""
    other = build_other(Path(src), "pfb_bins_launch", BINS_DIRECT_SIGNATURE)

    def old():
        return _direct_bins(other, hist, x, hp2)

    def new():
        return pk.pfb_bins(hist, x, hp2)

    for fn in (old, new):                     # the card's clocks up
        cuda_ms(fn, iters)
    ms = {"other": [], "package": []}
    for who, fn in (("other", old), ("package", new), ("package", new),
                    ("other", old)):
        ms[who].append(cuda_ms(fn, iters))
    (yo, ho), (yp, hpk) = old(), new()
    return {"other": str(src), "other_ms": ms["other"],
            "package_ms": ms["package"],
            "speedup": sum(ms["other"]) / sum(ms["package"]),
            "max_rel_diff": float((yo - yp).abs().max() / yo.abs().max()),
            "history_identical": torch.equal(_bits(torch.view_as_real(ho)),
                                             _bits(torch.view_as_real(hpk)))}


def bins_step_turns(src: Path, samp_rate: float, sources: int = SOURCES,
                    iters: int = 3) -> dict:
    """The pfb pipeline's step (``ControlPipeline.p25_c4fm(64, samp_rate,
    frontend="pfb")``, ``sources`` sources × 100 ms of random-normal bf16
    wire, the 25 kHz slot grid) with ``PfbChannelizer.bins`` on the
    package's ``pfb_bins`` or on the kernel built from ``src`` (commit
    ef6af1a's signature, the direct table's plan), in turns (other,
    package, package, other): step ms by CUDA events, ``iters`` steps
    each after one untimed step, and the speedup."""
    from radiocapture_tpu_torch.ops import channelizer
    other = build_other(Path(src), "pfb_bins_launch", BINS_DIRECT_SIGNATURE)
    dev = require_cuda()
    pipe = ControlPipeline.p25_c4fm(SLOTS, samp_rate, frontend="pfb")
    bm = pipe.block_multiple
    blk = bm * max(1, round(samp_rate * 0.1) // bm)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((sources, blk, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = ((torch.arange(SLOTS, device=dev) - SLOTS // 2) * 25e3
            / samp_rate).expand(sources, SLOTS).contiguous()
    box = [pipe.init(sources, dev)]
    kernel = {"other": lambda h, xx, t: _direct_bins(other, h, xx, t),
              "package": channelizer.pfb_bins}

    def step():
        box[0], _ = pipe.step(box[0], x, offs)

    ms = {"other": [], "package": []}
    try:
        for who in ("other", "package", "package", "other"):
            channelizer.pfb_bins = kernel[who]
            ms[who].append(cuda_ms(step, iters))
    finally:
        channelizer.pfb_bins = kernel["package"]
    return {"samp_rate": samp_rate, "M": pipe.bank.m, "sources": sources,
            "block": blk, "other": str(src), "other_step_ms": ms["other"],
            "package_step_ms": ms["package"],
            "speedup": sum(ms["other"]) / sum(ms["package"])}


def complex_bench_operands(dev):
    """The complex bank's operands at the split2 bench shape (128 sources
    × 240,000 random-normal bf16 wire samples), mid-stream after three
    steps: (x, history, grev, phase0, step, D)."""
    sp = SpectrumSplit2(SAMP_RATE)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((SOURCES, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    st = sp.init(SOURCES, dev)
    for _ in range(3):
        st, _ = sp.step(st, x)
    offs = torch.as_tensor(sp.offsets, device=dev).expand(SOURCES, 2)
    offs = offs.contiguous()
    return (x, st.history, sp.bank.modulated_taps(offs), st.phase,
            phase_step_u32(offs, sp.bank.decim), sp.bank.decim)


def complex_mesh_operands(dev):
    """The complex bank's operands where its general path runs at the
    bench shape: the time-sharded step's bank at world size 1 (128
    sources × 64 slots, K = 1440, D = 96, the 100 ms block and the
    sym-filter halo before it, a random-normal float32 block and history,
    random phases). Returns (x, history, grev, phase0, step, D)."""
    pipe = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE)
    bank = pipe.bank
    d, k = bank.decim, bank.ntaps
    t = BLOCK + len(pipe.sym_taps) * d
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((SOURCES, t, 2), generator=gen, device=dev)
    hist = torch.view_as_complex(torch.randn((SOURCES, k - 1, 2),
                                             generator=gen, device=dev))
    offs = grid_offsets(SOURCES, dev)
    phase0 = torch.randint(0, 2 ** 32, (SOURCES, SLOTS), generator=gen,
                           device=dev, dtype=torch.int64)
    return (x, hist, bank.modulated_taps(offs).contiguous(), phase0,
            phase_step_u32(offs, d), d)


def fine_bench_operands(dev):
    """The pfb fine stage's operands at the bench shape: 128 sources × 64
    slots = 8192 rows over the 768 bin rows of one 100 ms block, from
    ``PfbXlatBank.fine_operands`` after two steps of a random-normal bf16
    block, and the prototype: (bins [768, 40000, 2], rows, history,
    taps, fine, phase0, step, D)."""
    bank = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE, frontend="pfb").bank
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((SOURCES, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(SOURCES, dev)
    state = bank.init(SOURCES, dev)
    for _ in range(2):
        state, _ = bank(state, x, offs)
    _, xb, rows, hist, fine, phase0, step = bank.fine_operands(state, x,
                                                               offs)
    return (xb, rows, hist, bank.device_taps(dev), fine, phase0, step,
            bank.decim2)


def fine_rows_plan(rows: int, n: int, sms: int) -> int:
    """The rows a block the fine stage's kernel took before it wrote the
    planes (commit 149010e's ``fine_plan``): the most, up to 16, that
    leaves four waves of blocks of three an SM, at least one."""
    blocks = rows * -(-n // pk.FINE_NB)
    return max(1, min(16, blocks // (4 * sms * pk.FINE_BLOCKS)))


def fine_turns(src: Path, ops: tuple, d: int, c: int = SLOTS,
               iters: int = ITERS, row_counts: tuple = FINE_ROWS) -> dict:
    """``pfb_fine`` built from ``src`` (one complex64 row a slot,
    ``FINE_ROWS_SIGNATURE``) against the package's, which writes the
    [S/c, N, c] planes, on the fine stage's CUDA operands ``ops`` (bins,
    rows, history, taps, fine, phase0, step) cut to their first R rows
    for each R of ``row_counts``, each at its own plan's rows a block
    (``fine_rows_plan``, ``fine_plan``).
    In turns (other, package, package, other), after one untimed run of
    each: ``kernel``, the two launches alone on arguments built once;
    ``chain``, the other launch followed by ``planes()`` of its rows (the
    step's path before) against the package's launch. Then counts the
    plane elements bit-identical to ``planes()`` of the other's rows."""
    other = build_other(Path(src), "pfb_fine_launch", FINE_ROWS_SIGNATURE)
    package = kernels.load().pfb_fine_launch
    xb, rows, hist, taps, fine, phase0, step = ops
    res = {"other": str(src)}
    for r in row_counts:
        args, (y_re, y_im) = pk.pfb_fine_args(
            xb, rows[:r], hist[:r], taps, fine[:r], phase0[:r], step[:r],
            d, c)
        t, n, k, rb, stream = args[10], args[11], args[12], args[14], args[15]
        rb_other = fine_rows_plan(
            r, n, torch.cuda.get_device_properties(xb.device)
            .multi_processor_count)
        y = torch.empty((r, n), dtype=torch.complex64, device=xb.device)
        old_args = args[:7] + (y.data_ptr(), r, t, n, k, rb_other, stream)

        def old():
            kernels.check(other(*old_args), "pfb_fine")

        def new():
            kernels.check(package(*args), "pfb_fine")

        def old_chain():
            old()
            return planes(y.view(r // c, c, n))

        for fn in (old, new):                 # the card's clocks up
            cuda_ms(fn, iters)
        out = {"rows": r, "rb": rb, "other_rb": rb_other}
        for name, (o, p) in (("kernel", (old, new)),
                             ("chain", (old_chain, new))):
            ms = {"other": [], "package": []}
            for who, fn in (("other", o), ("package", p), ("package", p),
                            ("other", o)):
                ms[who].append(cuda_ms(fn, iters))
            out[f"{name}_other_ms"] = ms["other"]
            out[f"{name}_package_ms"] = ms["package"]
            out[f"{name}_speedup"] = sum(ms["other"]) / sum(ms["package"])
        y_re.fill_(float("nan"))
        y_im.fill_(float("nan"))
        new()
        want_re, want_im = old_chain()
        out["identical_planes"] = int(
            ((_bits(y_re) == _bits(want_re))
             & (_bits(y_im) == _bits(want_im))).sum())
        out["plane_elements"] = y_re.numel()
        res[str(r)] = out
    return res


def grid_offsets(n_sources: int, dev) -> torch.Tensor:
    """The bench's slot grid: 25 kHz spacing around the centre."""
    return ((torch.arange(SLOTS, device=dev) - SLOTS // 2) * 25e3
            / SAMP_RATE).expand(n_sources, SLOTS).contiguous()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bench_state(pipe, dev):
    """(state, wire block, offsets) of ``pipe`` at the bench shape after
    three steps of one random-normal bf16 block on the 25 kHz slot grid."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((SOURCES, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = grid_offsets(SOURCES, dev)
    state = pipe.init(SOURCES, dev)
    for _ in range(3):
        state, _ = pipe.step(state, x, offs)
    return state, x, offs


def voice_bench_planes(dev):
    """The analog bank's planes (y_re, y_im) [S, N, C] at the bench
    shape, and the pipeline (its ``gain`` and ``channel_fs``)."""
    pipe = AnalogVoicePipeline(SLOTS, SAMP_RATE)
    state, x, offs = bench_state(pipe, dev)
    _bs, y_re, y_im = pipe.bank.call_planes(state.bank, x, offs)
    return y_re, y_im, pipe


def cqpsk_bench_planes(dev):
    """The CQPSK bank's planes (y_re, y_im) [S, N, C], their AGC gain
    [S, C], the lane state and the pipeline at the split2 → CQPSK bench
    shape (the sources split into 256 halves × 64 slots on a 12.5 kHz
    grid), mid-stream after three steps of one random-normal bf16 block."""
    sp = SpectrumSplit2(SAMP_RATE)
    pipe = CqpskControlPipeline.p25_cqpsk(SLOTS, SAMP_RATE / 2)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((SOURCES, BLOCK, 2), generator=gen, device=dev).to(
        torch.bfloat16)
    offs = ((torch.arange(SLOTS, device=dev) - SLOTS // 2) * CQ_GRID_HZ
            / (SAMP_RATE / 2)).expand(2 * SOURCES, SLOTS).contiguous()
    sst, cst = sp.init(SOURCES, dev), pipe.init(2 * SOURCES, dev)
    for _ in range(3):
        sst, halves = sp.step(sst, x)
        cst, _ = pipe.step(cst, split2_sources(halves), offs)
    sst, halves = sp.step(sst, x)
    _bs, y_re, y_im = pipe.bank.call_planes(cst.bank, split2_sources(halves),
                                            offs)
    return y_re, y_im, cq.agc_scale(y_re, y_im, dim=1), cst.cqpsk, pipe


def main_voice(src: str) -> None:
    y_re, y_im, pipe = voice_bench_planes(require_cuda())
    res = voice_turns(Path(src), y_re, y_im, pipe.gain, pipe.channel_fs)
    print(card_line())
    print(json.dumps(res))


def main_cqpsk(src: str) -> None:
    y_re, y_im, scale, state, pipe = cqpsk_bench_planes(require_cuda())
    res = cqpsk_turns(Path(src), y_re, y_im, scale,
                      lambda: type(state)(*(t.clone() for t in state)),
                      pipe.channel_fs, pipe.symbol_rate)
    print(card_line())
    print(json.dumps(res))


def main_complex(src: str, shape: str | None = None) -> None:
    dev = require_cuda()
    if shape is None:
        res = complex_turns(Path(src), *complex_bench_operands(dev))
    else:
        res = complex_turns(Path(src), *complex_mesh_operands(dev),
                            pairings=("kernel",))
    print(card_line())
    print(json.dumps(res))


def fsk_turns(src: Path, y_re: torch.Tensor, y_im: torch.Tensor, state,
              prm, iters: int = ITERS) -> dict:
    """The fsk tracker built from ``src`` (exporting ``fsk_track_launch``
    with the package's signature) and the package's, in turns (other,
    package, package, other) on the [S, N, C] planes from a pipeline
    ``state``'s lane state, each with its own copy of it; then each once
    more from a fresh copy. Returns both ms lists, the speedup, the lanes
    whose outputs and carried state are bit-identical and the share of
    samples whose symbol, emit flag and dibit agree."""
    other = build_other(src)
    s, _, c = y_re.shape

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
        ms[k].append(cuda_ms(lambda: run(launch[k], timed[k]), iters))
    st = {k: lane_state() for k in launch}
    outs = {k: run(launch[k], st[k]) for k in launch}
    torch.cuda.synchronize()
    same = torch.ones((s, c), dtype=torch.bool, device=y_re.device)
    for a, b in zip(outs["other"], outs["package"]):      # [S, M, C]
        same &= (a == b).all(1)
    for a, b in zip(leaves(st["other"]), leaves(st["package"])):
        same &= (a == b).reshape(s, c, -1).all(-1)
    agree = {name: float((a == b).float().mean()) for name, a, b in zip(
        ("syms", "valid", "dibits"), outs["other"], outs["package"])}
    return {"other_ms": ms["other"], "package_ms": ms["package"],
            "speedup": sum(ms["other"]) / sum(ms["package"]),
            "identical_lanes": int(same.sum()), "lanes": same.numel(),
            "identical_lane_share": float(same.float().mean()),
            "sample_agreement": agree}


def main_bins(src: str) -> None:
    from radiocapture_tpu_torch.tools import pfb_variants
    dev = require_cuda()
    res = {}
    for m in pfb_variants.CASES:
        res[m] = bins_turns(Path(src), *pfb_variants.case_operands(m, dev))
        print(f"M={m}", json.dumps(res[m]), flush=True)
    print(card_line())
    print(json.dumps(res))


def main_fine(src: str) -> None:
    ops = fine_bench_operands(require_cuda())
    res = fine_turns(Path(src), ops[:7], ops[7])
    print(card_line())
    print(json.dumps(res))


def main(argv: list[str]) -> None:
    if argv[:1] == ["--kernel"] and len(argv) >= 3 and argv[1] in (
            "fsk_track", "fm_voice", "cqpsk_track", "xlat_complex",
            "pfb_bins", "pfb_fine"):
        kernel, argv = argv[1], argv[2:]
    else:
        kernel = "fsk_track"
    shape = None
    if kernel == "xlat_complex" and argv[:1] == ["--shape"] and len(argv) > 1:
        shape, argv = argv[1], argv[2:]
    if len(argv) != 1 or shape not in (None, "mesh"):
        raise SystemExit(__doc__)
    if kernel == "fm_voice":
        return main_voice(argv[0])
    if kernel == "cqpsk_track":
        return main_cqpsk(argv[0])
    if kernel == "xlat_complex":
        return main_complex(argv[0], shape)
    if kernel == "pfb_bins":
        return main_bins(argv[0])
    if kernel == "pfb_fine":
        return main_fine(argv[0])
    dev = require_cuda()
    card = card_line()
    pipe = ControlPipeline.p25_c4fm(SLOTS, SAMP_RATE)
    state, x, offs = bench_state(pipe, dev)
    n = BLOCK // pipe.decim
    z2, gk, step = pipe.bank.operands(state.bank, x, offs)
    y_re, y_im = ck.bank_fused(z2, gk, state.bank.phase, step, n,
                               pipe.bank.p, pipe.decim)
    res = fsk_turns(Path(argv[0]), y_re, y_im, state, pipe.track_params)
    print(card)
    print(json.dumps({"shape": [SOURCES, n, SLOTS], "other": argv[0],
                      **res}))


if __name__ == "__main__":
    main(sys.argv[1:])
