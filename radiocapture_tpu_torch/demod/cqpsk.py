"""CQPSK (P25 LSM) symbol recovery: plain PyTorch port of
``radiocapture_tpu.demod.cqpsk`` (op25 ``gardner_costas_cc`` →
``diff_phasor_cc`` → ``complex_to_arg`` stand-in).

Joint Gardner timing recovery and a ×4 power-law AFC on the complex
baseband, differential phase detection, output in quarter-pi units so
the 4-level slicer of the C4FM path applies unchanged. The tracker is a
per-sample feedback loop; here it is a Python loop over samples, each
step a few batched tensor ops over every lane, following the JAX scan
body (``cqpsk.py:176-237``) op for op. It is the reference the CUDA
tracker (``demod.cqpsk_kernel``) is checked against. The JAX scan's
W-sample unroll only amortized scan dispatch, so it is not copied.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.demod import fsk4 as _fsk4
from radiocapture_tpu_torch.demod.fsk4 import f32

#: 8-tap windowed-sinc interpolator, NPHASES phases (``_interp`` only)
_VAL_BANK = _fsk4._interp_banks()[0]
#: value-tap Farrow polynomials: the first HIST columns of the fsk4
#: combined table, [degree+1, 8], highest power first
_VAL_FARROW = np.ascontiguousarray(_fsk4._FARROW[:, :8])
NPHASES = _fsk4.NPHASES

GAIN_MU = 0.025
GAIN_OMEGA = 0.1 * GAIN_MU * GAIN_MU
K_FREQ = 0.02          # diff-domain AFC integrator gain
FMAX_HZ = 1200.0       # carrier pull-in clamp (reference fmax)
OMEGA_REL = 0.02       # omega clamp, +/-2% of nominal
HIST_C = 24            # complex history span (samples)
_DELAY = 4.0           # fixed interpolator group delay (samples)
FRAC_MAX = f32(0.999)
TWO_PI = f32(2.0 * math.pi)
PI = f32(math.pi)
QUARTER_PI = f32(math.pi / 4.0)


class CqpskState(NamedTuple):
    t: torch.Tensor        # [...], samples since last symbol instant
    omega: torch.Tensor    # [...], samples/symbol estimate
    freq: torch.Tensor     # [...], carrier correction (rad/sample)
    phase: torch.Tensor    # [...], NCO phase (rad)
    hist_re: torch.Tensor  # [..., HIST_C]
    hist_im: torch.Tensor  # [..., HIST_C]
    prev_re: torch.Tensor  # [...], last emitted symbol
    prev_im: torch.Tensor


def cqpsk_init(samp_rate: float, symbol_rate: float, batch_shape=(),
               device="cpu") -> CqpskState:
    """Start state: omega at the nominal samples/symbol, the rest zero."""
    def zeros(shape=()):
        return torch.zeros(tuple(batch_shape) + shape, dtype=torch.float32,
                           device=device)
    omega0 = float(samp_rate) / float(symbol_rate)
    return CqpskState(
        t=zeros(), omega=torch.full(tuple(batch_shape), omega0,
                                    dtype=torch.float32, device=device),
        freq=zeros(), phase=zeros(), hist_re=zeros((HIST_C,)),
        hist_im=zeros((HIST_C,)), prev_re=zeros(), prev_im=zeros())


class CqpskParams(NamedTuple):
    """The loop's constants for one (sample rate, symbol rate), each the
    float32 value the JAX scan computes."""
    omega_lo: float
    omega_hi: float
    fmax: float
    k_mu: float
    k_om: float
    k_f: float
    half_n0s: tuple     # candidate integer windows of the mid-symbol point


def cqpsk_params(samp_rate: float, symbol_rate: float) -> CqpskParams:
    """Raises ``ValueError`` above ~28 samples/symbol, where the
    mid-symbol window would leave the ``HIST_C``-sample history."""
    omega_n = np.float32(samp_rate / symbol_rate)
    # static integer-window candidates for p_half = p_sym + omega/2:
    # omega is clamped to ±OMEGA_REL, so the range is known up front
    omega0 = samp_rate / symbol_rate
    half_lo = _DELAY + omega0 * (1.0 - OMEGA_REL) * 0.5
    half_hi = _DELAY + 0.999 + omega0 * (1.0 + OMEGA_REL) * 0.5
    half_n0s = tuple(range(int(math.floor(half_lo)),
                           int(math.floor(half_hi)) + 1))
    if half_n0s and not (3 <= half_n0s[0]
                         and half_n0s[-1] <= HIST_C - 5):
        raise ValueError(
            f"samples/symbol {omega0:.1f} needs mid-symbol window "
            f"n0∈{list(half_n0s)} outside the {HIST_C}-sample history; "
            "raise HIST_C for rates above ~28 samples/symbol")
    return CqpskParams(
        omega_lo=float(omega_n * np.float32(1.0 - OMEGA_REL)),
        omega_hi=float(omega_n * np.float32(1.0 + OMEGA_REL)),
        fmax=f32(2.0 * math.pi * FMAX_HZ / samp_rate),
        k_mu=f32(GAIN_MU), k_om=f32(GAIN_OMEGA), k_f=f32(K_FREQ),
        half_n0s=half_n0s)


def _interp(hist_re: torch.Tensor, hist_im: torch.Tensor, p: torch.Tensor):
    """Evaluate the complex history ``p`` samples before the newest one
    with a per-lane dynamic window and polyphase-table taps (the JAX
    package's reference interpolator; the loop uses ``_interp_fixed``)."""
    n0 = torch.clamp(torch.floor(p), 0.0, HIST_C - 9.0)
    frac = torch.clamp(p - n0, 0.0, FRAC_MAX)
    ph = (frac * NPHASES).to(torch.int64)
    taps = torch.as_tensor(_VAL_BANK, device=p.device)[ph]     # [..., 8]
    s = (HIST_C - 5 - n0).to(torch.int64)
    idx = s[..., None] + torch.arange(8, device=p.device)
    w_re = torch.gather(hist_re, -1, idx)
    w_im = torch.gather(hist_im, -1, idx)
    return (w_re * taps).sum(-1), (w_im * taps).sum(-1)


def _interp_fixed(hist_re: torch.Tensor, hist_im: torch.Tensor, n0: int,
                  frac: torch.Tensor, cf: torch.Tensor | None = None):
    """Farrow interpolation at ``n0 + frac`` samples before the newest
    history sample, for a static integer ``n0``: a fixed window slice and
    polynomial taps. ``cf`` is ``_VAL_FARROW`` on the device, if the
    caller already holds it."""
    s = HIST_C - 5 - n0
    w_re = hist_re[..., s:s + 8]
    w_im = hist_im[..., s:s + 8]
    if cf is None:
        cf = torch.as_tensor(_VAL_FARROW, device=frac.device)
    tt = cf[0]
    fr = frac[..., None]
    for j in range(1, cf.shape[0]):
        tt = tt * fr + cf[j]                                   # [..., 8]
    return (w_re * tt).sum(-1), (w_im * tt).sum(-1)


def cqpsk_demod(state: CqpskState, x: torch.Tensor, samp_rate: float,
                symbol_rate: float
                ) -> tuple[CqpskState, tuple[torch.Tensor, torch.Tensor]]:
    """Recover differential-phase symbols from a complex baseband block.

    x: [..., n] complex64, roughly unit RMS (see :func:`block_agc`).
    Returns (state, (symbols [..., n] float32 in quarter-pi units,
    valid [..., n] bool))."""
    prm = cqpsk_params(samp_rate, symbol_rate)
    cf = torch.as_tensor(_VAL_FARROW, device=x.device)
    x_re, x_im = x.real, x.imag
    t, omega, freq, phase, h_re, h_im, p_re, p_im = state
    ys, emits = [], []
    for i in range(x.shape[-1]):
        xr_n, xi_n = x_re[..., i], x_im[..., i]
        # carrier NCO de-rotation: x · e^{-i·phase}
        phase = torch.remainder(phase + freq + TWO_PI, TWO_PI)
        c, s = torch.cos(phase), torch.sin(phase)
        xr = xr_n * c + xi_n * s
        xi = xi_n * c - xr_n * s
        h_re = torch.cat([h_re[..., 1:], xr[..., None]], -1)
        h_im = torch.cat([h_im[..., 1:], xi[..., None]], -1)

        t = t + 1.0
        emit = t >= omega
        frac_late = torch.where(emit, t - omega, 0.0)
        p_sym = frac_late + _DELAY
        p_half = p_sym + omega * 0.5
        y_re, y_im = _interp_fixed(
            h_re, h_im, int(_DELAY),
            torch.clamp(p_sym - _DELAY, 0.0, FRAC_MAX), cf)
        m_re = m_im = None
        for n0 in prm.half_n0s:
            fr = torch.clamp(p_half - float(n0), 0.0, FRAC_MAX)
            c_re, c_im = _interp_fixed(h_re, h_im, n0, fr, cf)
            if m_re is None:
                m_re, m_im = c_re, c_im
            else:
                sel = p_half >= float(n0)
                m_re = torch.where(sel, c_re, m_re)
                m_im = torch.where(sel, c_im, m_im)

        # Gardner timing error Re{(y_k - y_{k-1}) conj(y_mid)}
        e_t = (y_re - p_re) * m_re + (y_im - p_im) * m_im
        e_t = torch.clamp(e_t, -1.0, 1.0)
        omega = torch.where(emit, torch.clamp(omega - prm.k_om * e_t,
                                              prm.omega_lo, prm.omega_hi),
                            omega)
        t = torch.where(emit, frac_late + prm.k_mu * e_t, t)

        # differential phase in quarter-pi units, ×4 power-law AFC
        z_re = y_re * p_re + y_im * p_im              # y · conj(prev)
        z_im = y_im * p_re - y_re * p_im
        arg = torch.atan2(z_im, z_re) / QUARTER_PI
        err4 = torch.remainder(arg * PI - PI + PI, TWO_PI) - PI
        err = err4 * 0.25
        freq = torch.where(emit, torch.clamp(freq + prm.k_f * err / omega,
                                             -prm.fmax, prm.fmax), freq)
        p_re = torch.where(emit, y_re, p_re)
        p_im = torch.where(emit, y_im, p_im)
        ys.append(arg)
        emits.append(emit)
    new = CqpskState(t, omega, freq, phase, h_re, h_im, p_re, p_im)
    return new, (torch.stack(ys, -1), torch.stack(emits, -1))


def agc_scale(x_re: torch.Tensor, x_im: torch.Tensor, dim: int = -1
              ) -> torch.Tensor:
    """Feedforward AGC gain ``1 / max(rms, 1e-9)`` of a block, the
    RMS taken over ``dim`` of the complex samples ``x_re + i·x_im``."""
    rms = torch.sqrt(torch.mean(torch.hypot(x_re, x_im) ** 2, dim=dim))
    # the numerator filled on the device: a scalar tensor copied from the
    # host would synchronize the stream
    return torch.ones_like(rms) / torch.clamp_min(rms, 1e-9)


def block_agc(x: torch.Tensor) -> torch.Tensor:
    """Normalize block RMS per batch row (the reference's
    ``analog.feedforward_agc_cc(1024, 1.0)``); x [..., n] complex64."""
    return x * agc_scale(x.real, x.imag, -1)[..., None]
