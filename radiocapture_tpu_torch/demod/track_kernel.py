"""The fused per-lane tracker: discriminator → boxcar → symbol tracking →
slicer, for every (source, slot) lane of the bank output.

Replaces the chain after the bank in ``radiocapture_tpu.frontend.
pipeline.ControlPipeline._step_impl`` (pipeline.py:198-212):
``fm.quadrature_demod``, ``_batched_fir``, the ``fsk4.fsk4_demod``
``lax.scan`` and ``slice_dibits_jax``. In eager PyTorch the scan would
launch ~30 tiny kernels per sample; the CUDA kernel
(``csrc/fsk_track.cu``) gives each block a tile of 32 neighbouring slots
of one source: one warp runs the fsk4 feedback loop, one lane per thread,
while producer warps load the time-major bank planes and compute the
discriminator and boxcar into a shared-memory ring ahead of it.
``track_stream`` is the same loop on a track-rate stream that is already
discriminated and filtered (the time-sharded mesh step's), the kernel's
second entry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.demod import fsk4 as _fsk4
from radiocapture_tpu_torch.ops import fm as _fm
from radiocapture_tpu_torch.ops.fir import batched_fir

MAX_SYM_TAPS = 8   # the kernel keeps the boxcar window in registers
SEGMENT = 16       # input samples per producer segment (csrc SEG)
PROBE_ROWS = 64    # boxcar outputs the chain probe replays (csrc)


class TrackParams(NamedTuple):
    """Per-pipeline-class constants of the tracker."""
    gain: float              # discriminator gain, fs / (2π·deviation)
    sym_taps: np.ndarray     # boxcar symbol filter taps
    sym_decim: int           # boxcar output stride
    track_fs: float          # sample rate into the tracking loop
    symbol_rate: float
    levels: tuple            # uniformly spaced decision alphabet


def track_plain(y_re: torch.Tensor, y_im: torch.Tensor,
                quad: _fm.QuadDemodState, sym_hist: torch.Tensor,
                fsk4: _fsk4.Fsk4State, prm: TrackParams, block: int = 0):
    """Plain PyTorch version of the tracker.

    y_re, y_im [S, N, C] float32 bank planes. Returns (quad, sym_hist,
    fsk4, syms [S, C, M] f32, valid [S, C, M] int32, dibits [S, C, M]
    int32), M = N // sym_decim; the states are new tensors. ``block`` > 1
    tracks with ``fsk4_demod_block`` (``ControlPipeline.fsk4_block``),
    which has no kernel: this chain runs it on either device."""
    x = torch.complex(y_re, y_im).transpose(1, 2)          # [S, C, N]
    quad, disc = _fm.quadrature_demod(quad, x, prm.gain)
    sym_hist, filt = batched_fir(sym_hist, disc, prm.sym_taps,
                                 prm.sym_decim)
    if block > 1:
        fsk4, (syms, valid) = _fsk4.fsk4_demod_block(
            fsk4, filt, prm.track_fs, prm.symbol_rate, levels=prm.levels,
            block=block)
    else:
        fsk4, (syms, valid) = _fsk4.fsk4_demod(
            fsk4, filt, prm.track_fs, prm.symbol_rate, levels=prm.levels)
    return quad, sym_hist, fsk4, syms, valid.to(torch.int32), dibits_of(
        syms, prm.levels)


def dibits_of(syms: torch.Tensor, levels: tuple) -> torch.Tensor:
    """The slicer after the fsk4 loop: C4FM dibits for a 4-level
    alphabet, the sign bit for a binary one (int32)."""
    if len(levels) == 4:
        return _fsk4.slice_dibits_torch(syms)
    return (syms > 0.0).to(torch.int32)


def kernel_args(y_re: torch.Tensor, y_im: torch.Tensor,
                quad: _fm.QuadDemodState, sym_hist: torch.Tensor,
                fsk4: _fsk4.Fsk4State, prm: TrackParams):
    """Validate CUDA operands and allocate the outputs: (the arguments of
    the C entry point ``fsk_track_launch``, (syms, valid, dibits)
    time-major [S, M, C]). The constants go as the numpy array's ctypes
    view, which keeps the array alive as long as the arguments. Raises
    ValueError on what the kernel does not take."""
    s, n, c = y_re.shape
    nt = len(prm.sym_taps)
    if not 1 <= nt <= MAX_SYM_TAPS:
        raise ValueError(f"track: {nt} symbol taps, kernel takes "
                         f"1..{MAX_SYM_TAPS}")
    if prm.sym_decim < 1 or SEGMENT % prm.sym_decim:
        raise ValueError(f"track: sym_decim {prm.sym_decim} must divide "
                         f"{SEGMENT}")
    if n % prm.sym_decim:
        raise ValueError(f"track: N={n} not a multiple of sym_decim "
                         f"{prm.sym_decim}")
    lo, spacing = _fsk4.uniform_alphabet(prm.levels)
    prev = torch.view_as_real(quad.prev)
    for name, t, shape in (
            ("y_re", y_re, (s, n, c)), ("y_im", y_im, (s, n, c)),
            ("quad.prev", prev, (s, c, 2)),
            ("sym_hist", sym_hist, (s, c, nt - 1)),
            ("fsk4.clock", fsk4.clock, (s, c)),
            ("fsk4.fine_freq", fsk4.fine_freq, (s, c)),
            ("fsk4.hist", fsk4.hist, (s, c, _fsk4.HIST))):
        if (t.device != y_re.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"track: {name} must be a contiguous float32 "
                             f"tensor of shape {shape} on {y_re.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    m = n // prm.sym_decim
    syms = torch.empty((s, m, c), dtype=torch.float32, device=y_re.device)
    valid = torch.empty((s, m, c), dtype=torch.int32, device=y_re.device)
    dibits = torch.empty_like(valid)
    args = (y_re.data_ptr(), y_im.data_ptr(), prev.data_ptr(),
            sym_hist.data_ptr(), fsk4.clock.data_ptr(),
            fsk4.fine_freq.data_ptr(), fsk4.hist.data_ptr(),
            syms.data_ptr(), valid.data_ptr(), dibits.data_ptr(),
            consts(prm).ctypes, s, n, c, nt, prm.sym_decim,
            _fsk4.f32(prm.gain), _fsk4.f32(prm.symbol_rate / prm.track_fs),
            lo, spacing, len(prm.levels), _fsk4.f32(_fsk4.K_FINE_FREQ),
            _fsk4.f32(_fsk4.K_TIMING),
            torch.cuda.current_stream(y_re.device).cuda_stream)
    return args, (syms, valid, dibits)


def consts(prm: TrackParams) -> np.ndarray:
    """The Farrow table then the boxcar taps, as the kernel takes them by
    value (its constant bank: no copy on the stream)."""
    out = np.zeros(_fsk4._FARROW.size + MAX_SYM_TAPS, np.float32)
    out[:_fsk4._FARROW.size] = _fsk4._FARROW.ravel()
    out[_fsk4._FARROW.size:_fsk4._FARROW.size + len(prm.sym_taps)] = \
        prm.sym_taps
    return out


def track(y_re: torch.Tensor, y_im: torch.Tensor,
          quad: _fm.QuadDemodState, sym_hist: torch.Tensor,
          fsk4: _fsk4.Fsk4State, prm: TrackParams):
    """The fused tracker: ``track_plain`` on CPU tensors, the CUDA kernel
    on CUDA tensors. On CUDA the lane state (``quad.prev``, ``sym_hist``,
    ``fsk4.*``) is updated IN PLACE and the same tensors are returned;
    the outputs are [S, C, M] views of time-major [S, M, C] buffers.

    What bounds the kernel on the H100 is the latency of the fsk4
    feedback chain, not bytes or FLOPs: ~1250 dependent steps per lane
    per 100 ms block. The kernel keeps that chain alone on one warp per
    32-lane tile and feeds it from a shared-memory ring that producer
    warps fill (loads, atan2 discriminator, boxcar), so neither memory
    latency nor the feed-forward arithmetic sits on it; S·⌈C/32⌉ blocks
    spread the tiles over every SM. ``sym_decim`` must divide 16."""
    if y_re.device.type == "cpu":
        return track_plain(y_re, y_im, quad, sym_hist, fsk4, prm)
    if y_re.device.type != "cuda":
        raise ValueError(f"track: unsupported device {y_re.device}")
    from radiocapture_tpu_torch import kernels
    args, (syms, valid, dibits) = kernel_args(y_re, y_im, quad, sym_hist,
                                              fsk4, prm)
    kernels.launch("fsk_track", *args)
    return (quad, sym_hist, fsk4, syms.transpose(1, 2),
            valid.transpose(1, 2), dibits.transpose(1, 2))


def track_stream_plain(x: torch.Tensor, fsk4: _fsk4.Fsk4State,
                       prm: TrackParams):
    """Plain version of the stream tracker: ``fsk4_demod`` and the slicer
    on x [S, C, M] float32, a track-rate stream already discriminated and
    boxcar-filtered (what the JAX time-sharded step runs after its
    all_to_all, parallel/mesh.py:315-321). Returns (fsk4, syms [S, C, M]
    f32, valid [S, C, M] int32, dibits [S, C, M] int32); the state is
    new tensors."""
    fsk4, (syms, valid) = _fsk4.fsk4_demod(
        fsk4, x, prm.track_fs, prm.symbol_rate, levels=prm.levels)
    return fsk4, syms, valid.to(torch.int32), dibits_of(syms, prm.levels)


def track_stream(x: torch.Tensor, fsk4: _fsk4.Fsk4State, prm: TrackParams):
    """The tracker on a track-rate stream: ``track_stream_plain`` on CPU
    tensors, the CUDA kernel (``fsk_track_stream_launch`` in
    ``csrc/fsk_track.cu``: ``track``'s consumer loop, its producer warps
    copying x into the ring) on CUDA tensors. On CUDA the fsk4 state is
    updated IN PLACE and returned; the outputs are [S, C, M] views of
    time-major [S, M, C] buffers. x must be a contiguous float32
    [S, C, M] tensor; another dtype, layout or device raises."""
    if x.device.type == "cpu":
        return track_stream_plain(x, fsk4, prm)
    if x.device.type != "cuda":
        raise ValueError(f"track_stream: unsupported device {x.device}")
    from radiocapture_tpu_torch import kernels
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"track_stream: x must be a contiguous float32 "
                         f"[S, C, M] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    s, c, m = x.shape
    for name, t, shape in (
            ("fsk4.clock", fsk4.clock, (s, c)),
            ("fsk4.fine_freq", fsk4.fine_freq, (s, c)),
            ("fsk4.hist", fsk4.hist, (s, c, _fsk4.HIST))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"track_stream: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    syms = torch.empty((s, m, c), dtype=torch.float32, device=x.device)
    valid = torch.empty((s, m, c), dtype=torch.int32, device=x.device)
    dibits = torch.empty_like(valid)
    lo, spacing = _fsk4.uniform_alphabet(prm.levels)
    kernels.launch(
        "fsk_track_stream", x.data_ptr(), fsk4.clock.data_ptr(),
        fsk4.fine_freq.data_ptr(), fsk4.hist.data_ptr(), syms.data_ptr(),
        valid.data_ptr(), dibits.data_ptr(), consts(prm).ctypes, s, m, c,
        _fsk4.f32(prm.symbol_rate / prm.track_fs), lo, spacing,
        len(prm.levels), _fsk4.f32(_fsk4.K_FINE_FREQ),
        _fsk4.f32(_fsk4.K_TIMING),
        torch.cuda.current_stream(x.device).cuda_stream)
    return (fsk4, syms.transpose(1, 2), valid.transpose(1, 2),
            dibits.transpose(1, 2))


def chain_probe(xn: torch.Tensor, steps: int, prm: TrackParams) -> int:
    """The fsk4 loop of the kernel alone: one warp of 32 lanes, from a
    zero state, replays the boxcar outputs ``xn`` [PROBE_ROWS, 32] (CUDA
    float32, rows in time) from shared memory for ``steps`` tracked
    samples.
    Returns the clock64() cycles of that loop: the latency floor of the
    tracker's serial chain, with no load, discriminator or hand-off on
    it. A measurement aid; not a launch of ``track``."""
    from radiocapture_tpu_torch import kernels
    if (xn.device.type != "cuda" or xn.dtype != torch.float32
            or tuple(xn.shape) != (PROBE_ROWS, 32)
            or not xn.is_contiguous()):
        raise ValueError(f"chain_probe: xn must be a contiguous CUDA "
                         f"float32 [{PROBE_ROWS}, 32] tensor")
    dev = xn.device
    syms = torch.empty((steps, 32), dtype=torch.float32, device=dev)
    valid = torch.empty((steps, 32), dtype=torch.int32, device=dev)
    dibits = torch.empty_like(valid)
    state = torch.empty((2, 32), dtype=torch.float32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    lo, spacing = _fsk4.uniform_alphabet(prm.levels)
    kernels.check(kernels.load().fsk_chain_probe_launch(
        xn.data_ptr(), steps, syms.data_ptr(), valid.data_ptr(),
        dibits.data_ptr(), state.data_ptr(), cycles.data_ptr(),
        consts(prm).ctypes, _fsk4.f32(prm.symbol_rate / prm.track_fs), lo,
        spacing, len(prm.levels), _fsk4.f32(_fsk4.K_FINE_FREQ),
        _fsk4.f32(_fsk4.K_TIMING),
        torch.cuda.current_stream(dev).cuda_stream), "fsk_chain_probe")
    return int(cycles.item())
