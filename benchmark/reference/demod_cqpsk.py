"""Plain reference of the CQPSK (P25 LSM) demodulator: a block RMS gain a
lane, then the carrier NCO, Gardner timing, the differential phase in
quarter-pi units and the ×4 power-law AFC, a lane at a time over every
lane at once.

Float64 from the configuration's float32 constants. The loop's
decisions are the emit instant (``t >= omega``) and the AFC's branch of
``mod(arg·π, 2π)``, which flips where the symbol's phase crosses a
multiple of π/2. Judging the program, the loop takes its emit mask and
the branch its own symbol falls in (worked out in float32 from the
symbol it emitted, as the float32 loop works it out), and its own
symbol is taken on the branch of the program's (the phase is a circle:
+4 and -4 quarter-pi are one symbol). ``dtype=torch.bfloat16`` runs the
chain in bfloat16 with its own decisions: the control. The module has
the demodulator interface that ``demod_fsk4`` describes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import demod_fsk4 as _fsk4

GAIN_MU = 0.025
GAIN_OMEGA = 0.1 * GAIN_MU * GAIN_MU
K_FREQ = 0.02
FMAX_HZ = 1200.0
OMEGA_REL = 0.02
HIST_C = 24
DELAY = 4.0
f32 = _fsk4.f32
FRAC_MAX = f32(0.999)
TWO_PI = f32(2.0 * math.pi)
PI = f32(math.pi)
QUARTER_PI = f32(math.pi / 4.0)


class Params:
    def __init__(self, cfg: dict, channel_fs: float):
        baud = cfg["symbol_rate"]
        self.channel_fs, self.baud = channel_fs, baud
        omega_n = np.float32(channel_fs / baud)
        self.omega0 = float(channel_fs) / float(baud)
        half_lo = DELAY + self.omega0 * (1.0 - OMEGA_REL) * 0.5
        half_hi = DELAY + 0.999 + self.omega0 * (1.0 + OMEGA_REL) * 0.5
        self.half_n0s = tuple(range(int(math.floor(half_lo)),
                                    int(math.floor(half_hi)) + 1))
        self.omega_lo = float(omega_n * np.float32(1.0 - OMEGA_REL))
        self.omega_hi = float(omega_n * np.float32(1.0 + OMEGA_REL))
        self.fmax = f32(2.0 * math.pi * FMAX_HZ / channel_fs)
        self.k_mu, self.k_om, self.k_f = (f32(GAIN_MU), f32(GAIN_OMEGA),
                                          f32(K_FREQ))
        self.farrow = np.ascontiguousarray(_fsk4.farrow()[:, :8])


STATE = ("t", "omega", "freq", "phase", "hist_re", "hist_im", "prev_re",
         "prev_im")
CIRCLES = {"phase": 2.0 * math.pi}   # the NCO phase compares on its circle
dibits = _fsk4.dibits                # the same slicer, in quarter-pi units


def sizes(prm: Params) -> dict:
    return {}


def init(lanes: int, prm: Params, dev) -> dict:
    def z(*shape):
        return torch.zeros((lanes,) + shape, dtype=torch.float64, device=dev)
    return {"t": z(), "omega": torch.full((lanes,), prm.omega0,
                                          dtype=torch.float64, device=dev),
            "freq": z(), "phase": z(), "hist_re": z(HIST_C),
            "hist_im": z(HIST_C), "prev_re": z(), "prev_im": z()}


def forced_wraps(syms: torch.Tensor) -> torch.Tensor:
    """The number of 2π the float32 loop takes off ``arg·π`` for its AFC
    error (``mod``, by C fmod and a sign fix), from the symbol ``arg`` it
    emitted: ((arg·π - π) + π) in float32, then the fmod of a value
    under 2.5·2π by whole subtractions."""
    pi, two_pi = np.float32(PI), np.float32(TWO_PI)
    v = ((syms.to(torch.float32) * pi) - pi) + pi
    ax = v.abs()
    y2 = np.float32(2.0) * two_pi
    n = (ax >= two_pi).to(torch.float32) + (ax >= y2).to(torch.float32)
    m = torch.where(ax < two_pi, ax, torch.where(ax < y2, ax - two_pi,
                                                  ax - y2))
    w = torch.where(v < 0, -n, n)
    neg = (torch.where(v < 0, -m, m) < 0) & (m != 0)
    return (w - neg.to(torch.float32)).to(torch.float64)


def _interp(h_re, h_im, n0: int, frac, cf):
    s = HIST_C - 5 - n0
    tt = cf[0]
    fr = frac[..., None]
    for j in range(1, cf.shape[0]):
        tt = tt * fr + cf[j]
    return ((h_re[:, s:s + 8] * tt).sum(-1), (h_im[:, s:s + 8] * tt).sum(-1))


def agc(planes: torch.Tensor, dtype) -> torch.Tensor:
    """The block gain 1 / max(rms, 1e-9) a lane."""
    if dtype == torch.float64:
        p = planes.to(torch.complex128)
        rms = torch.sqrt((p.real ** 2 + p.imag ** 2).mean(-1))
    else:
        re, im = planes.real.to(dtype), planes.imag.to(dtype)
        rms = torch.sqrt((re * re + im * im).mean(-1))
    return 1.0 / torch.clamp_min(rms, 1e-9)


def track(planes: torch.Tensor, state: dict, prm: Params,
          forced: tuple | None = None, dtype=torch.float64):
    """One block on lane-major samples ``planes`` [L, N] complex.
    ``forced`` = (valid [L, N] bool, symbols [L, N] of the program).
    Returns (state after, syms [L, N], valid [L, N] bool, valid_gap [L],
    as ``demod_fsk4.track``'s with ``t - omega`` for the clock)."""
    dev = planes.device
    g = agc(planes, dtype)
    x_re = planes.real.to(dtype) * g[:, None]
    x_im = planes.imag.to(dtype) * g[:, None]
    cf = torch.as_tensor(prm.farrow, device=dev).to(dtype)
    st = {k: v.to(dtype) for k, v in state.items()}
    t, omega, freq, phase = st["t"], st["omega"], st["freq"], st["phase"]
    h_re, h_im = st["hist_re"], st["hist_im"]
    p_re, p_im = st["prev_re"], st["prev_im"]
    if forced is not None:
        wraps = forced_wraps(forced[1])
        fsym = forced[1].to(torch.float64)
    ys, emits = [], []
    vgap = torch.zeros(planes.shape[0], dtype=torch.float64, device=dev)
    for i in range(planes.shape[1]):
        xr_n, xi_n = x_re[:, i], x_im[:, i]
        phase = torch.remainder(phase + freq + TWO_PI, TWO_PI)
        c, s = torch.cos(phase), torch.sin(phase)
        xr = xr_n * c + xi_n * s
        xi = xi_n * c - xr_n * s
        h_re = torch.cat([h_re[:, 1:], xr[:, None]], 1)
        h_im = torch.cat([h_im[:, 1:], xi[:, None]], 1)
        t = t + 1.0
        own = t >= omega
        if forced is None:
            emit = own
        else:
            emit = forced[0][:, i]
            vgap = torch.maximum(vgap, torch.where(
                emit != own, (t - omega).to(torch.float64).abs(), 0.0))
        frac_late = torch.where(emit, t - omega, 0.0)
        p_sym = frac_late + DELAY
        p_half = p_sym + omega * 0.5
        y_re, y_im = _interp(h_re, h_im, int(DELAY),
                             torch.clamp(p_sym - DELAY, 0.0, FRAC_MAX), cf)
        m_re = m_im = None
        for n0 in prm.half_n0s:
            c_re, c_im = _interp(h_re, h_im, n0, torch.clamp(
                p_half - float(n0), 0.0, FRAC_MAX), cf)
            if m_re is None:
                m_re, m_im = c_re, c_im
            else:
                sel = p_half >= float(n0)
                m_re = torch.where(sel, c_re, m_re)
                m_im = torch.where(sel, c_im, m_im)
        e_t = torch.clamp((y_re - p_re) * m_re + (y_im - p_im) * m_im,
                          -1.0, 1.0)
        omega = torch.where(emit, torch.clamp(omega - prm.k_om * e_t,
                                              prm.omega_lo, prm.omega_hi),
                            omega)
        t = torch.where(emit, frac_late + prm.k_mu * e_t, t)
        z_re = y_re * p_re + y_im * p_im
        z_im = y_im * p_re - y_re * p_im
        arg = torch.atan2(z_im, z_re) / QUARTER_PI
        if forced is None:
            err4 = torch.remainder(arg * PI - PI + PI, TWO_PI) - PI
        else:
            arg = arg + 8.0 * torch.round((fsym[:, i] - arg) / 8.0)
            err4 = arg * PI - TWO_PI * wraps[:, i] - PI
        err = err4 * 0.25
        freq = torch.where(emit, torch.clamp(freq + prm.k_f * err / omega,
                                             -prm.fmax, prm.fmax), freq)
        p_re = torch.where(emit, y_re, p_re)
        p_im = torch.where(emit, y_im, p_im)
        ys.append(arg)
        emits.append(emit)
    new = {"t": t, "omega": omega, "freq": freq, "phase": phase,
           "hist_re": h_re, "hist_im": h_im, "prev_re": p_re,
           "prev_im": p_im}
    return new, torch.stack(ys, 1), torch.stack(emits, 1), vgap


def circ(d: torch.Tensor) -> torch.Tensor:
    """A difference of symbols on the circle of 8 quarter-pi units."""
    return d - 8.0 * torch.round(d / 8.0)


def lane_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """max |got - want| of each lane on the circle, [L]."""
    return circ(got.to(torch.float64) - want.to(torch.float64)).abs() \
        .amax(-1)


def dibit_gaps(dib: torch.Tensor, y: torch.Tensor,
               got: torch.Tensor) -> torch.Tensor:
    """``demod_fsk4.dibit_gaps`` on the circle: the reference's symbol taken on
    the turn of the program's symbol ``got``."""
    yy = got.to(torch.float64) - circ(got.to(torch.float64)
                                      - y.to(torch.float64))
    return _fsk4.dibit_gaps(dib, yy)


def forced(outs: tuple, prm: Params) -> tuple:
    """The program's emit mask and symbols, which fix the loop's
    decisions (``track``'s ``forced``)."""
    syms, valid, _ = outs
    return valid, syms


def gaps(outs: tuple, y_ref: torch.Tensor) -> tuple:
    """(symbol gap, dibit gap) of each lane on the circle, [L] each."""
    syms, _, dib = outs
    return lane_gaps(syms, y_ref), dibit_gaps(dib, y_ref, syms)
