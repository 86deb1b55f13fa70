"""The fused per-lane CQPSK tracker: AGC gain → carrier NCO → Gardner
timing → differential phase → ×4 AFC → slicer, for every (source, slot)
lane of the bank output.

Replaces the chain after the bank in ``radiocapture_tpu.frontend.
pipeline.CqpskControlPipeline._step_impl`` (pipeline.py:340-350): the
``cqpsk.cqpsk_demod`` ``lax.scan`` and ``slice_dibits_jax``, with the
per-lane gain of ``cqpsk.block_agc`` applied as samples are read; the
gain itself is one reduction over the planes (``agc_scale_kernel``,
``csrc/agc.cu``). In eager PyTorch the scan would launch ~110 tiny
kernels per sample; the CUDA kernel (``csrc/cqpsk_track.cu``) runs each
lane's loop in one thread with the lane's whole state in registers,
symbol by symbol, with the rest of the work in other warps, and reads
the time-major bank planes once.
"""

from __future__ import annotations

import numpy as np
import torch

from radiocapture_tpu_torch.demod import cqpsk as _cq
from radiocapture_tpu_torch.demod.fsk4 import slice_dibits_torch

MAX_CANDIDATES = 3   # mid-symbol windows the kernel picks among (csrc)
PROBE_ROWS = 64      # samples the chain probe replays (csrc)


def track_cqpsk_plain(y_re: torch.Tensor, y_im: torch.Tensor,
                      scale: torch.Tensor, state: _cq.CqpskState,
                      samp_rate: float, symbol_rate: float):
    """Plain PyTorch version of the tracker.

    y_re, y_im [S, N, C] float32 bank planes; scale [S, C] float32 AGC
    gain. Returns (state, syms [S, C, N] float32, valid [S, C, N] int32,
    dibits [S, C, N] int32); the state holds new tensors."""
    g = scale[:, None, :]
    x = torch.complex(y_re * g, y_im * g).transpose(1, 2)   # [S, C, N]
    state, (syms, valid) = _cq.cqpsk_demod(state, x, samp_rate, symbol_rate)
    return state, syms, valid.to(torch.int32), slice_dibits_torch(syms)


def _check(what: str, dev, checks) -> None:
    for name, t, shape in checks:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _state_checks(state: _cq.CqpskState, lanes: tuple) -> list:
    return [(f"state.{name}", t,
             lanes + (_cq.HIST_C,) if name.startswith("hist") else lanes)
            for name, t in zip(_cq.CqpskState._fields, state)]


def _loop_args(prm: _cq.CqpskParams) -> tuple:
    if not 1 <= len(prm.half_n0s) <= MAX_CANDIDATES:
        raise ValueError(f"track_cqpsk: {len(prm.half_n0s)} mid-symbol "
                         f"candidates, the kernel takes 1..{MAX_CANDIDATES}")
    return (prm.half_n0s[0], len(prm.half_n0s), prm.omega_lo, prm.omega_hi,
            prm.fmax, prm.k_mu, prm.k_om, prm.k_f)


def _consts():
    """The Farrow value taps as the kernel takes them by value (its
    constant bank); the ctypes view keeps the array alive as long as the
    arguments that hold it."""
    return np.ascontiguousarray(_cq._VAL_FARROW, np.float32).ctypes


def kernel_args(y_re: torch.Tensor, y_im: torch.Tensor, scale: torch.Tensor,
                state: _cq.CqpskState, samp_rate: float, symbol_rate: float):
    """Validate CUDA operands and allocate the outputs: (the arguments of
    the C entry point ``cqpsk_track_launch``, (syms, valid, dibits)
    time-major [S, N, C]). Raises ValueError on what the kernel does not
    take."""
    prm = _cq.cqpsk_params(samp_rate, symbol_rate)
    s, n, c = y_re.shape
    _check("track_cqpsk", y_re.device,
           [("y_re", y_re, (s, n, c)), ("y_im", y_im, (s, n, c)),
            ("scale", scale, (s, c))] + _state_checks(state, (s, c)))
    syms = torch.empty((s, n, c), dtype=torch.float32, device=y_re.device)
    valid = torch.empty((s, n, c), dtype=torch.int32, device=y_re.device)
    dibits = torch.empty_like(valid)
    args = (y_re.data_ptr(), y_im.data_ptr(), scale.data_ptr(),
            *(t.data_ptr() for t in state), syms.data_ptr(),
            valid.data_ptr(), dibits.data_ptr(), _consts(), s, n, c,
            *_loop_args(prm),
            torch.cuda.current_stream(y_re.device).cuda_stream)
    return args, (syms, valid, dibits)


def agc_args(y_re: torch.Tensor, y_im: torch.Tensor):
    """Validate the AGC kernel's planes and allocate its output: (the
    arguments of the C entry point ``agc_launch``, scale [S, C]). Raises
    ValueError on what the kernel does not take: another dtype or shape,
    a non-contiguous plane, planes on different devices or off the
    card."""
    if y_re.dim() != 3:
        raise ValueError(f"agc_scale_kernel: y_re must be [S, N, C], got "
                         f"{tuple(y_re.shape)}")
    s, n, c = y_re.shape
    _check("agc_scale_kernel", y_re.device,
           [("y_re", y_re, (s, n, c)), ("y_im", y_im, (s, n, c))])
    if y_re.device.type != "cuda":
        raise ValueError(f"agc_scale_kernel: the kernel takes CUDA "
                         f"tensors, got {y_re.device}")
    scale = torch.empty((s, c), dtype=torch.float32, device=y_re.device)
    return (y_re.data_ptr(), y_im.data_ptr(), scale.data_ptr(), s, n, c,
            torch.cuda.current_stream(y_re.device).cuda_stream), scale


def agc_scale_kernel(y_re: torch.Tensor, y_im: torch.Tensor
                     ) -> torch.Tensor:
    """The per-lane AGC gain of a block of [S, N, C] float32 bank planes,
    ``1 / max(rms over N, 1e-9)`` as [S, C] float32: ``cqpsk.agc_scale``
    (dim 1) on CPU tensors, the CUDA kernel ``csrc/agc.cu`` on CUDA
    tensors, which reads each plane once and sums re² + im² in float32 in
    a fixed order (not the plain version's: the gain agrees within a
    stated bound, not bit for bit). On CUDA what the kernel does not take
    raises (``agc_args``)."""
    if y_re.device.type == "cpu":
        return _cq.agc_scale(y_re, y_im, dim=1)
    from radiocapture_tpu_torch import kernels
    args, scale = agc_args(y_re, y_im)
    kernels.launch("agc", *args)
    return scale


def track_cqpsk(y_re: torch.Tensor, y_im: torch.Tensor, scale: torch.Tensor,
                state: _cq.CqpskState, samp_rate: float, symbol_rate: float):
    """The fused tracker: ``track_cqpsk_plain`` on CPU tensors, the CUDA
    kernel on CUDA tensors. On CUDA the lane state is updated IN PLACE
    and the same tensors are returned; the outputs are [S, C, N] views of
    time-major [S, N, C] buffers.

    What bounds the kernel on the H100 is latency: 16384 lanes give one
    warp per scheduler, and each lane is a serial feedback chain. The
    lanes of a warp are independent channels whose symbol instants do not
    line up, so a loop over samples would run the symbol instant's work
    (a second Farrow evaluation, the mid-symbol window, Gardner, atan2,
    the AFC division) on nearly every sample for some lane of the warp.
    The kernel runs the loop symbol by symbol instead, in one consumer
    warp per 32-lane tile: each lane takes its own samples up to its next
    symbol instant (NCO, rotation, history shift), then the warp runs the
    emit step for all its lanes at once. The mid-symbol window is picked
    by selects among at most ``MAX_CANDIDATES`` windows, not by a
    divergent switch. Everything off the loop runs in producer warps of
    the same block, behind mbarriers, through a shared-memory ring each
    lane reads and writes in its own column: symbol warps fill it with the
    planes by cp.async; the consumer writes each rotated sample and each
    emit's symbol value back; an interpolation warp forms every sample's
    value interpolation (taps held for the launch) and y·conj(prev) with
    the prev in force; the symbol warps turn those into symbols (atan2,
    dibit) and store them coalesced. Outputs and lane state are
    bit-identical to the per-sample loop's. What the chain alone takes is
    ``chain_probe``'s count."""
    if y_re.device.type == "cpu":
        return track_cqpsk_plain(y_re, y_im, scale, state, samp_rate,
                                 symbol_rate)
    if y_re.device.type != "cuda":
        raise ValueError(f"track_cqpsk: unsupported device {y_re.device}")
    from radiocapture_tpu_torch import kernels
    args, (syms, valid, dibits) = kernel_args(y_re, y_im, scale, state,
                                              samp_rate, symbol_rate)
    kernels.launch("cqpsk_track", *args)
    return (state, syms.transpose(1, 2), valid.transpose(1, 2),
            dibits.transpose(1, 2))


def chain_probe(x_re: torch.Tensor, x_im: torch.Tensor,
                state: _cq.CqpskState, steps: int, samp_rate: float,
                symbol_rate: float, launch=None) -> int:
    """The tracker's feedback chain alone: one warp of 32 lanes from
    ``state`` (CUDA, [32] and [32, HIST_C]; updated in place) replays the
    gained samples ``x_re``, ``x_im`` [PROBE_ROWS, 32] (CUDA float32,
    rows in time) from shared memory for ``steps`` samples, running the
    NCO, rotation and history shift of each and the emit step once per
    symbol, with no non-emit interpolation, atan2 or store. Returns the
    clock64() cycles of that loop: the floor of the kernel's serial
    chain. ``launch`` is the C entry point ``cqpsk_chain_probe_launch``
    of another build (the package's by default). A measurement aid; not a
    launch of ``track_cqpsk``."""
    from radiocapture_tpu_torch import kernels
    dev = x_re.device
    if dev.type != "cuda":
        raise ValueError(f"chain_probe: unsupported device {dev}")
    _check("chain_probe", dev,
           [("x_re", x_re, (PROBE_ROWS, 32)), ("x_im", x_im, (PROBE_ROWS, 32))]
           + _state_checks(state, (32,)))
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    launch = launch or kernels.load().cqpsk_chain_probe_launch
    kernels.check(launch(
        x_re.data_ptr(), x_im.data_ptr(), *(t.data_ptr() for t in state),
        cycles.data_ptr(), _consts(), steps,
        *_loop_args(_cq.cqpsk_params(samp_rate, symbol_rate)),
        torch.cuda.current_stream(dev).cuda_stream), "cqpsk_chain_probe")
    return int(cycles.item())
