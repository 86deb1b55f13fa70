"""Plain reference of the C4FM demodulator: quadrature discriminator →
boxcar symbol filter → fsk4 symbol tracking (fine frequency and decision-
directed timing) → slicer, a lane at a time over every lane at once.

Computed in float64 from the configuration's constants rounded to
float32 (the values the configuration states for the float32 tracker).
The discriminator's complex product ``x · conj(x_prev)`` is taken in
complex64, as the configuration's float32 tracker takes it, so that a
phase step of π falls on the same side of the branch cut as the
program's; everything after it is float64.

The tracker is a feedback loop with two decisions a symbol: whether the
clock emits, and which level the symbol is. Judging the program, the
loop takes the program's decisions (``forced``: its emit mask and the
level its own symbol rounds to), as a served model's reference is run
over the tokens the model served; a decision the reference would have
made otherwise is measured by how far it lay from the threshold.
``dtype=torch.bfloat16`` runs the same chain in bfloat16 with its own
decisions: the control of the correctness check.

The judge and the control find this module by the name a path gives
(``reference/demod_<name>.py``) and use only what every demodulator
module has: ``Params``, ``STATE``, ``CIRCLES``, ``init``, ``track``,
``forced``, ``gaps``, ``dibits`` and ``sizes``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

K_FINE_FREQ = 0.002
K_TIMING = 0.025
HIST = 8
NPHASES = 128


def f32(v: float) -> float:
    return float(np.float32(v))


def _interp_banks() -> tuple[np.ndarray, np.ndarray]:
    """8-tap windowed-sinc interpolator and its derivative, NPHASES
    phases."""
    val = np.zeros((NPHASES, HIST), np.float32)
    dval = np.zeros((NPHASES, HIST), np.float32)
    win = np.hamming(HIST)
    eps = 1e-4

    def sinc_taps(pos):
        t = np.arange(HIST) - pos
        h = np.sinc(t) * win
        return h / np.sum(h)

    for p in range(NPHASES):
        frac = p / NPHASES
        val[p] = sinc_taps(4.0 - frac)
        dval[p] = (sinc_taps(4.0 - (frac + eps))
                   - sinc_taps(4.0 - (frac - eps))) / (2 * eps)
    return val, dval


def farrow(degree: int = 4) -> np.ndarray:
    """The value and derivative taps as degree-4 polynomials in the
    fractional phase, [degree+1, 2·HIST] float32, highest power first."""
    val, dval = _interp_banks()
    comb = np.concatenate([val, dval], axis=1)
    ph = np.arange(NPHASES) / NPHASES
    return np.stack([np.polyfit(ph, comb[:, k], degree)
                     for k in range(2 * HIST)], axis=1).astype(np.float32)


class Params:
    """The tracker's constants for one configuration at one channel
    rate."""

    def __init__(self, cfg: dict, channel_fs: float):
        baud, dev = cfg["symbol_rate"], cfg["deviation_hz"]
        self.gain = f32(channel_fs / (2.0 * math.pi * dev))
        n = max(1, int(round(channel_fs / baud / 2.0)))
        self.sym_taps = np.full(n, 1.0 / n, np.float32)
        self.sym_decim = 2 if channel_fs / 2.0 >= 2.2 * baud else 1
        self.track_fs = channel_fs / self.sym_decim
        self.step = f32(baud / self.track_fs)
        lv = np.asarray(cfg["levels"], np.float32)
        self.lo, self.spacing = float(lv[0]), float(lv[1] - lv[0])
        self.top = float(len(lv) - 1)
        self.k_ff, self.k_t = f32(K_FINE_FREQ), f32(K_TIMING)
        self.frac_max = f32(0.999)
        self.farrow = farrow()


STATE = ("quad.prev", "sym_hist", "fsk4.clock", "fsk4.fine_freq",
         "fsk4.hist")
CIRCLES: dict = {}   # no angle in the carried state


def sizes(prm: Params) -> dict:
    """The tracker's shapes that ``work/`` counts need."""
    return {"sym_taps": len(prm.sym_taps), "sym_decim": prm.sym_decim}


def init(lanes: int, prm: Params, dev) -> dict:
    z = torch.zeros(lanes, dtype=torch.float64, device=dev)
    return {"quad.prev": torch.zeros(lanes, dtype=torch.complex128,
                                     device=dev),
            "sym_hist": torch.zeros(lanes, len(prm.sym_taps) - 1,
                                    dtype=torch.float64, device=dev),
            "fsk4.clock": z, "fsk4.fine_freq": z.clone(),
            "fsk4.hist": torch.zeros(lanes, HIST, dtype=torch.float64,
                                     device=dev)}


def forced_levels(syms: torch.Tensor, prm: Params) -> torch.Tensor:
    """The level index the program's tracker takes for its symbol y:
    ``clamp(rint((y - lo) / spacing), 0, top)`` in float32, as the
    float32 loop computes it from the y it emits."""
    y = syms.to(torch.float32)
    q = (y - np.float32(prm.lo)) / np.float32(prm.spacing)
    return torch.clamp(torch.round(q), 0.0, prm.top).to(torch.float64)


def discriminator(x: torch.Tensor, prev: torch.Tensor, prm: Params,
                  dtype) -> torch.Tensor:
    """gain · arg(x[n] · conj(x[n-1])) over [L, N] complex samples."""
    xm1 = torch.cat([prev[:, None], x[:, :-1]], dim=1)
    if dtype == torch.float64:
        d = x.to(torch.complex64) * torch.conj(xm1.to(torch.complex64))
        return prm.gain * torch.atan2(d.imag.to(torch.float64),
                                      d.real.to(torch.float64))
    a, b = x.real.to(dtype), x.imag.to(dtype)
    c, e = xm1.real.to(dtype), (-xm1.imag).to(dtype)
    return prm.gain * torch.atan2(b * c + a * e, a * c - b * e)


def track(planes: torch.Tensor, state: dict, prm: Params,
          forced: tuple | None = None, dtype=torch.float64):
    """One block of the demodulator on lane-major channel samples
    ``planes`` [L, N] (complex) from ``state``. ``forced`` = (valid [L, M]
    bool, level index [L, M]) makes the loop take those decisions.
    Returns (state after, syms [L, M], valid [L, M] bool, valid_gap [L]:
    the largest distance of a lane's clock from its threshold where a
    forced emit decision went against it)."""
    dev = planes.device
    nt = len(prm.sym_taps)
    disc = discriminator(planes, state["quad.prev"], prm, dtype)
    z = torch.cat([state["sym_hist"].to(dtype), disc], dim=1)
    sd = prm.sym_decim
    m_out = planes.shape[1] // sd
    filt = None
    for j, t in enumerate(prm.sym_taps[::-1]):
        term = float(t) * z[:, j:j + sd * (m_out - 1) + 1:sd]
        filt = term if filt is None else filt + term
    cf = torch.as_tensor(prm.farrow, device=dev).to(dtype)
    clock = state["fsk4.clock"].to(dtype)
    ff = state["fsk4.fine_freq"].to(dtype)
    hist = state["fsk4.hist"].to(dtype)
    ys, emits = [], []
    vgap = torch.zeros(planes.shape[0], dtype=torch.float64, device=dev)
    for i in range(m_out):
        hist = torch.cat([hist[:, 1:], (filt[:, i] - ff)[:, None]], 1)
        clock = clock + prm.step
        own = clock >= 1.0
        if forced is None:
            emit = own
        else:
            emit = forced[0][:, i]
            miss = (emit != own)
            vgap = torch.maximum(vgap, torch.where(
                miss, (clock.to(torch.float64) - 1.0).abs(), 0.0))
        clockw = torch.where(emit, clock - 1.0, clock)
        frac = torch.clamp(clockw / prm.step, 0.0, prm.frac_max)[:, None]
        tt = cf[0]
        for j in range(1, cf.shape[0]):
            tt = tt * frac + cf[j]
        y = (hist * tt[:, :HIST]).sum(-1)
        dy = (hist * tt[:, HIST:]).sum(-1)
        if forced is None:
            idx = torch.clamp(torch.round((y - prm.lo) / prm.spacing),
                              0.0, prm.top)
        else:
            idx = forced[1][:, i].to(dtype)
        err = y - (prm.lo + prm.spacing * idx)
        ff = torch.where(emit, ff + prm.k_ff * err, ff)
        clock = torch.where(emit, clockw - prm.k_t * torch.tanh(err * dy),
                            clockw)
        ys.append(y)
        emits.append(emit)
    new = {"quad.prev": planes[:, -1].to(torch.complex128),
           "sym_hist": z[:, z.shape[1] - (nt - 1):],
           "fsk4.clock": clock, "fsk4.fine_freq": ff, "fsk4.hist": hist}
    return new, torch.stack(ys, 1), torch.stack(emits, 1), vgap


def dibits(syms: torch.Tensor) -> torch.Tensor:
    """The C4FM slicer: +3 → 1, +1 → 0, -1 → 2, -3 → 3."""
    s = syms
    return torch.where(s > 2.0, 1, torch.where(
        s > 0.0, 0, torch.where(s > -2.0, 2, 3))).to(torch.int32)


def dibit_gaps(dib: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """How far the reference's symbols lie outside the regions of the
    program's dibits (0 where each lies inside), the largest a lane, [L]:
    the slicer's regions (2, ∞), (0, 2], (-2, 0], (-∞, -2] of dibits 1, 0,
    2, 3."""
    lo = torch.tensor([0.0, 2.0, -2.0, -math.inf], dtype=torch.float64,
                      device=y.device)[dib.long()]
    hi = torch.tensor([2.0, math.inf, 0.0, -2.0], dtype=torch.float64,
                      device=y.device)[dib.long()]
    yy = y.to(torch.float64)
    return torch.maximum(lo - yy, yy - hi).clamp_min(0.0).amax(-1)


def lane_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """max |got - want| of each lane, [L]."""
    return (got.to(torch.float64) - want.to(torch.float64)).abs().amax(-1)


def forced(outs: tuple, prm: Params) -> tuple:
    """The decisions the reference loop takes from the program's lane-
    major outputs (syms, valid, dibits): its emit mask and levels."""
    syms, valid, _ = outs
    return valid, forced_levels(syms, prm)


def gaps(outs: tuple, y_ref: torch.Tensor) -> tuple:
    """(symbol gap, dibit gap) of each lane, [L] each."""
    syms, _, dib = outs
    return lane_gaps(syms, y_ref), dibit_gaps(dib, y_ref)
