"""The fused per-lane CQPSK tracker: AGC gain → carrier NCO → Gardner
timing → differential phase → ×4 AFC → slicer, for every (source, slot)
lane of the bank output.

Replaces the chain after the bank in ``radiocapture_tpu.frontend.
pipeline.CqpskControlPipeline._step_impl`` (pipeline.py:340-350): the
``cqpsk.cqpsk_demod`` ``lax.scan`` and ``slice_dibits_jax``, with the
per-lane gain of ``cqpsk.block_agc`` applied as samples are read. In
eager PyTorch the scan would launch ~110 tiny kernels per sample; the
CUDA kernel (``csrc/cqpsk_track.cu``) runs one thread per lane with the
lane's whole state in registers and reads the time-major bank planes
once.
"""

from __future__ import annotations

import numpy as np
import torch

from radiocapture_tpu_torch.demod import cqpsk as _cq
from radiocapture_tpu_torch.demod.fsk4 import slice_dibits_torch


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


def track_cqpsk(y_re: torch.Tensor, y_im: torch.Tensor, scale: torch.Tensor,
                state: _cq.CqpskState, samp_rate: float, symbol_rate: float):
    """The fused tracker: ``track_cqpsk_plain`` on CPU tensors, the CUDA
    kernel on CUDA tensors. On CUDA the lane state is updated IN PLACE
    and the same tensors are returned; the outputs are [S, C, N] views of
    time-major [S, N, C] buffers.

    What bounds the kernel on the H100 is latency: each lane is a serial
    chain (sincos → three Farrow evaluations → Gardner error → atan2 →
    AFC update) over 2500 samples per 100 ms block, and 16384 lanes give
    one warp per scheduler. The design keeps every lane variable,
    the 24-sample complex history included, in registers (windows taken
    at compile-time indices), loads the next sample one step ahead with
    coalesced reads of the time-major planes, and writes time-major
    outputs. Several lanes per thread to hide the chain latency is a
    later lever."""
    if y_re.device.type == "cpu":
        return track_cqpsk_plain(y_re, y_im, scale, state, samp_rate,
                                 symbol_rate)
    if y_re.device.type != "cuda":
        raise ValueError(f"track_cqpsk: unsupported device {y_re.device}")
    from radiocapture_tpu_torch import kernels
    prm = _cq.cqpsk_params(samp_rate, symbol_rate)
    s, n, c = y_re.shape
    checks = [("y_re", y_re, (s, n, c)), ("y_im", y_im, (s, n, c)),
              ("scale", scale, (s, c))]
    for name, t in zip(_cq.CqpskState._fields, state):
        hist = name.startswith("hist")
        checks.append((f"state.{name}", t,
                       (s, c, _cq.HIST_C) if hist else (s, c)))
    for name, t, shape in checks:
        if (t.device != y_re.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"track_cqpsk: {name} must be a contiguous "
                             f"float32 tensor of shape {shape} on "
                             f"{y_re.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    syms = torch.empty((s, n, c), dtype=torch.float32, device=y_re.device)
    valid = torch.empty((s, n, c), dtype=torch.int32, device=y_re.device)
    dibits = torch.empty_like(valid)
    # the Farrow value taps travel by value (the kernel's constant bank)
    consts = np.ascontiguousarray(_cq._VAL_FARROW, np.float32)
    err = kernels.load().cqpsk_track_launch(
        y_re.data_ptr(), y_im.data_ptr(), scale.data_ptr(),
        *(t.data_ptr() for t in state), syms.data_ptr(), valid.data_ptr(),
        dibits.data_ptr(), consts.ctypes.data, s, n, c, prm.half_n0s[0],
        len(prm.half_n0s), prm.omega_lo, prm.omega_hi, prm.fmax, prm.k_mu,
        prm.k_om, prm.k_f, torch.cuda.current_stream(y_re.device).cuda_stream)
    kernels.check(err, "cqpsk_track")
    track_cqpsk.launches += 1
    return (state, syms.transpose(1, 2), valid.transpose(1, 2),
            dibits.transpose(1, 2))


track_cqpsk.launches = 0
