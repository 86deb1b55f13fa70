"""FM quadrature discriminator, de-emphasis and the NBFM voice chain
(port of ``radiocapture_tpu.ops.fm``).

On the card the discriminator and the de-emphasis run fused inside
tracker kernels: the discriminator in ``demod.track_kernel`` (control
channels) and ``ops.fm_kernel`` (analog voice, with the de-emphasis);
this is their plain PyTorch form. ``nbfm_demod`` chains them with the
audio ``fir_filter`` in plain torch on either device: no capture path
runs it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.device import resolve
from radiocapture_tpu_torch.ops.fir import FirState, fir_filter


class QuadDemodState(NamedTuple):
    prev: torch.Tensor  # [...] complex64, last sample of the previous block


def quad_demod_init(batch_shape=(), device="cpu") -> QuadDemodState:
    return QuadDemodState(prev=torch.zeros(batch_shape, dtype=torch.complex64,
                                           device=device))


def quadrature_demod(state: QuadDemodState, x: torch.Tensor, gain: float
                     ) -> tuple[QuadDemodState, torch.Tensor]:
    """``y[n] = gain · arg(x[n] · conj(x[n-1]))`` over the last axis,
    batched over leading dims; ``gain`` is usually
    ``samp_rate / (2π·max_deviation)``."""
    xm1 = torch.cat([state.prev[..., None], x[..., :-1]], dim=-1)
    d = x * torch.conj(xm1)
    y = gain * torch.atan2(d.imag, d.real)
    return QuadDemodState(prev=x[..., -1]), y


def first_order_iir(x: torch.Tensor, a: float, b: float,
                    y0: torch.Tensor) -> torch.Tensor:
    """``y[n] = a·y[n-1] + b·x[n]`` along the last axis, ``y[-1] = y0``.

    As the JAX ``associative_scan`` does, ``y0`` is folded into the first
    element (``b·x[0] + a·y0``); the prefix is then taken by a log-depth
    doubling scan (``y[n] += a^d · y[n-d]`` for d = 1, 2, 4, ...), about
    12 vectorised passes for a 2500-sample block. ``a`` and ``b`` are
    float32 values (see :func:`deemph_coefs`)."""
    a32 = torch.tensor(a, dtype=torch.float32)
    y = b * x.to(torch.float32)
    y = torch.cat([y[..., :1] + a32 * y0[..., None], y[..., 1:]], dim=-1)
    ad, d, n = a32, 1, y.shape[-1]
    while d < n:
        y = torch.cat([y[..., :d], y[..., d:] + ad * y[..., :-d]], dim=-1)
        ad, d = ad * ad, 2 * d
    return y


class DeemphState(NamedTuple):
    y_last: torch.Tensor   # [...] float32, last output of the previous block
    x_last: torch.Tensor   # [...] float32, last input of the previous block


def deemph_init(batch_shape=(), device="cpu") -> DeemphState:
    return DeemphState(
        y_last=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        x_last=torch.zeros(batch_shape, dtype=torch.float32, device=device))


def deemph_coefs(samp_rate: float,
                 tau: float = 75e-6) -> tuple[float, float]:
    """(z1, b0) of the bilinear-matched one-pole de-emphasis
    ``H(z) = b0 (1 + z⁻¹) / (1 − z1 z⁻¹)``: computed in float64, rounded
    once to float32, as the JAX package's ``jnp.float32(z1)`` does."""
    w_c = 1.0 / tau
    w_ca = 2.0 * samp_rate * math.tan(w_c / (2.0 * samp_rate))
    k = -w_ca / (2.0 * samp_rate)
    z1 = (1.0 + k) / (1.0 - k)
    b0 = -k / (1.0 - k)
    return float(np.float32(z1)), float(np.float32(b0))


def fm_deemphasis(state: DeemphState, x: torch.Tensor, samp_rate: float,
                  tau: float = 75e-6) -> tuple[DeemphState, torch.Tensor]:
    """Single-pole de-emphasis over the last axis:
    ``y[n] = z1·y[n-1] + b0·(x[n] + x[n-1])``."""
    z1, b0 = deemph_coefs(samp_rate, tau)
    xprev = torch.cat([state.x_last[..., None], x[..., :-1]], dim=-1)
    y = first_order_iir(x + xprev, z1, b0, state.y_last)
    return DeemphState(y_last=y[..., -1], x_last=x[..., -1]), y


class NbfmState(NamedTuple):
    quad: QuadDemodState
    deemph: DeemphState
    audio_fir: FirState


def nbfm_init(audio_taps, device=None) -> NbfmState:
    """Zero state of one NBFM channel on ``device`` (``None``: the card)."""
    dev = resolve(device)
    return NbfmState(quad=quad_demod_init((), dev),
                     deemph=deemph_init((), dev),
                     audio_fir=FirState(history=torch.zeros(
                         len(audio_taps) - 1, dtype=torch.float32,
                         device=dev)))


def nbfm_demod(state: NbfmState, x: torch.Tensor, samp_rate: float,
               max_dev: float, audio_taps, audio_decim: int = 1,
               tau: float = 75e-6) -> tuple[NbfmState, torch.Tensor]:
    """Narrowband FM voice demod over ``x`` [T] complex: discriminator →
    de-emphasis → audio low-pass, the reference's analog voice chain
    (logging_receiver.py:210-222) up to the resampler."""
    gain = samp_rate / (2.0 * math.pi * max_dev)
    qs, disc = quadrature_demod(state.quad, x, gain)
    ds, de = fm_deemphasis(state.deemph, disc, samp_rate, tau)
    fs, audio = fir_filter(state.audio_fir, de, audio_taps, audio_decim)
    return NbfmState(quad=qs, deemph=ds, audio_fir=fs), audio
