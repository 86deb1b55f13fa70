"""Streaming FIR / frequency-translating FIR helpers.

Port of ``radiocapture_tpu.ops.fir``: the streaming ``fir_filter`` with
its carried history, the exact fixed-point mixer phase, the
single-channel ``freq_xlating_fir``, the batched real FIR that feeds the
symbol tracker and ``design_channel_taps``.

The mixer phase is uint32 fixed point (cycles × 2^32) in the JAX package.
PyTorch's CPU build has no uint32 arithmetic, so the port carries it as
int64 masked with ``0xFFFFFFFF`` after every add: the same value mod
2^32, bit-exact across block splits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from radiocapture_tpu_torch.device import resolve
from radiocapture_tpu_torch.ops import taps as _taps

U32_MASK = 0xFFFFFFFF
_PHASE_SCALE = 4294967296.0  # 2^32
# float32(2π / 2^32): the same rounded constant the JAX package and the
# CUDA bank kernel multiply by.
ANGLE_PER_U32 = float(np.float32(2.0 * np.pi / _PHASE_SCALE))


class FirState(NamedTuple):
    """Carried state of a streaming FIR: the trailing ntaps-1 inputs."""
    history: torch.Tensor   # [ntaps-1], the stream's dtype


def fir_init(taps, dtype: torch.dtype = torch.complex64,
             device=None) -> FirState:
    """Zero history for ``taps`` on ``device`` (``None``: the card)."""
    return FirState(history=torch.zeros(len(taps) - 1, dtype=dtype,
                                        device=resolve(device)))


def _conv1d(x: torch.Tensor, taps: torch.Tensor, stride: int
            ) -> torch.Tensor:
    """Causal 1-D convolution ``y[n] = Σ_k h[k] x[n·stride - k + K - 1]``
    over ``x`` [T] that already holds K-1 samples of history in front:
    ``(T - K + 1) // stride`` valid outputs (the JAX ``_conv1d``,
    fir.py:32-66). One ``conv1d`` (a correlation, so the taps go in
    reversed); complex input is its two re/im channels, with real taps a
    diagonal 2→2 kernel and with complex taps the 2→2 rotation kernel."""
    hrev = taps.flip(0)
    if x.is_complex():
        xr = torch.stack([x.real, x.imag]).to(torch.float32)     # [2, T]
        if hrev.is_complex():
            kern = torch.stack([torch.stack([hrev.real, -hrev.imag]),
                                torch.stack([hrev.imag, hrev.real])])
        else:
            eye = torch.eye(2, dtype=hrev.dtype, device=hrev.device)
            kern = eye[:, :, None] * hrev[None, None, :]
        out = F.conv1d(xr[None], kern.to(torch.float32), stride=stride)[0]
        return torch.complex(out[0], out[1])
    return F.conv1d(x[None, None].to(torch.float32),
                    hrev[None, None].to(torch.float32), stride=stride)[0, 0]


def fir_filter(state: FirState, x: torch.Tensor, taps, decim: int = 1
               ) -> tuple[FirState, torch.Tensor]:
    """Streaming, optionally decimating FIR over ``x`` [T] (complex or
    real) with ``taps`` (numpy or a tensor, real or complex): returns
    ``T // decim`` outputs; T must be a multiple of ``decim``."""
    taps = torch.as_tensor(taps, device=x.device)
    k = taps.shape[0]
    z = torch.cat([state.history, x])
    y = _conv1d(z, taps, decim)
    new_hist = z[z.shape[0] - (k - 1):] if k > 1 else state.history
    return FirState(history=new_hist), y


def design_channel_taps(samp_rate: float, channel_rate: float,
                        transition_frac: float = 0.2) -> np.ndarray:
    """Channel-extraction taps: low-pass at channel_rate/2 with a
    transition band of ``transition_frac·channel_rate``, 60 dB (the
    reference's per-channel filter intent, rc_frontend/channel.py:33)."""
    return _taps.low_pass_2(1.0, samp_rate, channel_rate / 2.0,
                            transition_frac * channel_rate, 60.0)


def phase_step_u32(offset_norm: torch.Tensor, decim: int) -> torch.Tensor:
    """Per-output-sample mixer step, cycles × 2^32, as int64 in [0, 2^32).

    Matches JAX's ``_phase_step_u32`` bit for bit, saturation included:
    float32 ``mod(-f·D, 1)`` can round up to exactly 1.0 (e.g. f = +1e-12),
    and JAX's float→uint32 cast clamps that to 0xFFFFFFFF."""
    step = torch.remainder(-offset_norm.to(torch.float32) * decim, 1.0)
    return (step * _PHASE_SCALE).to(torch.int64).clamp_(0, U32_MASK)


def u32_to_angle(u: torch.Tensor) -> torch.Tensor:
    """uint32 phase (held in int64) → radians, float32."""
    return u.to(torch.float32) * ANGLE_PER_U32


def rotate(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``y · e^{j·u32_to_angle(u)}`` for complex64 ``y``."""
    a = u32_to_angle(u)
    return y * torch.complex(torch.cos(a), torch.sin(a))


class XlatState(NamedTuple):
    """Single-channel freq-xlating FIR state (see ops.fir in the JAX
    package): input history and the uint32 mixer phase (int64 here)."""
    history: torch.Tensor   # [ntaps-1] complex64
    phase: torch.Tensor     # scalar int64, cycles × 2^32


def xlat_init(ntaps: int, device) -> XlatState:
    return XlatState(
        history=torch.zeros(ntaps - 1, dtype=torch.complex64, device=device),
        phase=torch.zeros((), dtype=torch.int64, device=device))


def freq_xlating_fir(state: XlatState, x: torch.Tensor, taps: np.ndarray,
                     offset_norm: float, decim: int
                     ) -> tuple[XlatState, torch.Tensor]:
    """One channel of the reference's ``freq_xlating_fir_filter_ccc``:
    mix ``x`` down by ``offset_norm`` cycles/sample, low-pass with
    ``taps``, decimate by ``decim``. Tap modulation g[k] = h[k]·e^{jwk}
    keeps the filter static while the uint32 ramp carries the tune."""
    dev = x.device
    k = len(taps)
    off = torch.tensor(offset_norm, dtype=torch.float32, device=dev)
    kk = torch.arange(k, dtype=torch.float32, device=dev)
    ang = (2.0 * np.pi) * off * kk
    g = (torch.as_tensor(np.asarray(taps, np.float32), device=dev)
         * torch.complex(torch.cos(ang), torch.sin(ang)))
    z = torch.cat([state.history, x.to(torch.complex64)])
    # correlation with reversed taps == causal convolution
    win = torch.view_as_real(z).unfold(0, k, decim)      # [N, 2, K]
    grev = g.flip(0)
    y = torch.complex(win[:, 0] @ grev.real - win[:, 1] @ grev.imag,
                      win[:, 0] @ grev.imag + win[:, 1] @ grev.real)
    n_out = y.shape[0]
    step = phase_step_u32(off, decim)
    ramp = (state.phase + step * torch.arange(n_out, device=dev)) & U32_MASK
    y = rotate(y, ramp)
    new_phase = (state.phase + step * n_out) & U32_MASK
    return XlatState(history=z[z.shape[0] - (k - 1):], phase=new_phase), y


def batched_fir(hist: torch.Tensor, x: torch.Tensor, taps: np.ndarray,
                stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming FIR over ``[..., T]`` with shared real taps, decimating
    by ``stride`` (``radiocapture_tpu.frontend.pipeline._batched_fir``).

    ``y[m] = Σ_k taps[K-1-k] · z[m·stride + k]`` with ``z = hist ++ x``,
    summed in k order — the order the CUDA tracker sums in.
    Returns (new_hist [..., K-1], y [..., T // stride])."""
    k = len(taps)
    z = torch.cat([hist, x.to(torch.float32)], dim=-1)
    win = z.unfold(-1, k, stride)                        # [..., M, K]
    y = None
    for j, t in enumerate(np.asarray(taps, np.float32)[::-1]):
        term = float(t) * win[..., j]
        y = term if y is None else y + term
    return z[..., z.shape[-1] - (k - 1):], y
