"""C4FM / binary-FSK symbol recovery: plain PyTorch port of
``radiocapture_tpu.demod.fsk4`` (op25 ``fsk4_demod_ff`` stand-in).

The tracker is a per-sample feedback loop (fine frequency + decision-
directed timing). Here it is a Python loop over samples, each step a few
batched tensor ops over every lane — the reference the CUDA tracker
(``demod.track_kernel``) is checked against. The JAX scan's W-sample
unroll only amortized scan dispatch, so it is not copied.

Contract: input is the FM discriminator output scaled so the levels sit
at the alphabet (−3,−1,+1,+3 for C4FM), boxcar-filtered over ~half a
symbol. Output is one value per input sample plus an emit mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

K_FINE_FREQ = 0.002
K_TIMING = 0.025
HIST = 8          # interpolator span (samples)
NPHASES = 128     # polyphase interpolation resolution of the fitted table


def _interp_banks() -> tuple[np.ndarray, np.ndarray]:
    """8-tap windowed-sinc interpolator + its derivative, NPHASES phases
    (identical to the JAX package's table)."""
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


def _farrow_coeffs(degree: int = 4) -> np.ndarray:
    """The 2·HIST value+derivative taps as degree-4 polynomials in the
    fractional phase, [degree+1, 2·HIST], highest power first."""
    val, dval = _interp_banks()
    comb = np.concatenate([val, dval], axis=1)
    ph = np.arange(NPHASES) / NPHASES
    return np.stack([np.polyfit(ph, comb[:, k], degree)
                     for k in range(2 * HIST)], axis=1).astype(np.float32)


_FARROW = _farrow_coeffs()


def f32(v: float) -> float:
    """A Python float holding exactly the float32 rounding of ``v``: the
    constants the JAX package takes as float32."""
    return float(np.float32(v))


class Fsk4State(NamedTuple):
    clock: torch.Tensor      # [...], symbol-phase accumulator in [0, 1)
    fine_freq: torch.Tensor  # [...], DC offset tracker (symbol units)
    hist: torch.Tensor       # [..., HIST] recent input samples


def fsk4_init(batch_shape=(), device="cpu") -> Fsk4State:
    return Fsk4State(
        clock=torch.zeros(batch_shape, dtype=torch.float32, device=device),
        fine_freq=torch.zeros(batch_shape, dtype=torch.float32,
                              device=device),
        hist=torch.zeros(tuple(batch_shape) + (HIST,), dtype=torch.float32,
                         device=device))


def uniform_alphabet(levels) -> tuple[float, float]:
    """(lowest level, spacing) of a uniformly spaced alphabet; every
    pipeline class (C4FM, EDACS, Moto) uses one."""
    lv = np.asarray(levels, np.float32)
    spacing = np.diff(lv)
    if len(lv) < 2 or not np.allclose(spacing, spacing[0]):
        raise ValueError(f"levels must be uniformly spaced, got {levels}")
    return float(lv[0]), float(spacing[0])


def fsk4_demod(state: Fsk4State, x: torch.Tensor, samp_rate: float,
               symbol_rate: float, levels: tuple = (-3.0, -1.0, 1.0, 3.0),
               k_fine_freq: float = K_FINE_FREQ, k_timing: float = K_TIMING,
               ) -> tuple[Fsk4State, tuple[torch.Tensor, torch.Tensor]]:
    """Track and sample symbols from a block.

    x: [..., n] discriminator samples. Returns (state, (symbols [..., n],
    valid [..., n] bool)): at most one symbol per input sample. ``levels``
    (−1, 1) gives the binary clock recovery of the EDACS/Moto paths."""
    step = f32(symbol_rate / samp_rate)
    lo, s0 = uniform_alphabet(levels)
    top = float(len(levels) - 1)
    k_ff, k_t = f32(k_fine_freq), f32(k_timing)
    frac_max = f32(0.999)
    cf = torch.as_tensor(_FARROW, device=x.device)        # [5, 2·HIST]
    clock, ff, hist = state
    ys, emits = [], []
    for i in range(x.shape[-1]):
        hist = torch.cat([hist[..., 1:], (x[..., i] - ff)[..., None]], -1)
        clock = clock + step
        emit = clock >= 1.0
        clockw = torch.where(emit, clock - 1.0, clock)
        frac = torch.clamp(clockw / step, 0.0, frac_max)[..., None]
        tt = cf[0]
        for j in range(1, cf.shape[0]):
            tt = tt * frac + cf[j]                         # [..., 2·HIST]
        y = (hist * tt[..., :HIST]).sum(-1)
        dy = (hist * tt[..., HIST:]).sum(-1)
        idx = torch.clamp(torch.round((y - lo) / s0), 0.0, top)
        err = y - (lo + s0 * idx)
        ff = torch.where(emit, ff + k_ff * err, ff)
        clock = torch.where(emit, clockw - k_t * torch.tanh(err * dy),
                            clockw)
        ys.append(y)
        emits.append(emit)
    return (Fsk4State(clock, ff, hist),
            (torch.stack(ys, -1), torch.stack(emits, -1)))


def fsk4_demod_block(state: Fsk4State, x: torch.Tensor, samp_rate: float,
                     symbol_rate: float,
                     levels: tuple = (-3.0, -1.0, 1.0, 3.0),
                     k_fine_freq: float = K_FINE_FREQ,
                     k_timing: float = K_TIMING, block: int = 10,
                     ) -> tuple[Fsk4State, tuple[torch.Tensor, torch.Tensor]]:
    """Block-feedback variant of :func:`fsk4_demod` (the JAX
    ``fsk4_demod_block``, fsk4.py:208-298): the fine-frequency and timing
    feedback are held constant within each chunk of ``block`` samples, so
    a chunk's interpolations and decisions are computed at once and the
    corrections accumulated over it apply at its end. The loops' time
    constants (500 and 40 symbols) dwarf the few-symbol delay.

    Emission is exact: with the clock frozen in a chunk, sample i emits
    when ``floor(b_i) > floor(b_{i-1})``, ``b_i = clock0 + (i+1)·step``;
    the first sample's baseline ``floor(clock0)`` is clamped to ≤ 0, since
    a chunk-end timing correction can leave clock0 ≥ 1 with an emission
    pending. Same contract as :func:`fsk4_demod`; plain PyTorch on either
    device, ~25 tensor ops per chunk."""
    step = f32(symbol_rate / samp_rate)
    lo, s0 = uniform_alphabet(levels)
    top = float(len(levels) - 1)
    k_ff, k_t = f32(k_fine_freq), f32(k_timing)
    frac_max = f32(0.999)
    n = x.shape[-1]
    w = next(b for b in (block, 10, 8, 5, 4, 2, 1) if n % b == 0)
    cf = torch.as_tensor(_FARROW, device=x.device)        # [5, 2·HIST]
    i1 = torch.arange(1, w + 1, dtype=torch.float32, device=x.device)
    clock, ff, hist = state
    ys, emits = [], []
    for c0 in range(0, n, w):
        buf = torch.cat([hist, x[..., c0:c0 + w] - ff[..., None]], -1)
        h = buf.unfold(-1, HIST, 1)[..., 1:, :]            # [..., w, HIST]
        b = clock[..., None] + i1 * step
        fl = torch.floor(b)
        fl_prev = torch.cat([torch.clamp(torch.floor(clock), max=0.0)[
            ..., None], fl[..., :-1]], -1)
        emit = (fl > fl_prev) & (fl >= 1.0)
        clockw = b - torch.clamp(fl, min=0.0)
        frac = torch.clamp(clockw / step, 0.0, frac_max)[..., None]
        tt = cf[0]
        for j in range(1, cf.shape[0]):
            tt = tt * frac + cf[j]                         # [..., w, 2·HIST]
        y = (h * tt[..., :HIST]).sum(-1)
        dy = (h * tt[..., HIST:]).sum(-1)
        idx = torch.clamp(torch.round((y - lo) / s0), 0.0, top)
        err = torch.where(emit, y - (lo + s0 * idx), 0.0)
        ff = ff + k_ff * err.sum(-1)
        clock = clockw[..., -1] - k_t * torch.where(
            emit, torch.tanh(err * dy), 0.0).sum(-1)
        hist = buf[..., w:]
        ys.append(y)
        emits.append(emit)
    return (Fsk4State(clock, ff, hist.contiguous()),
            (torch.cat(ys, -1), torch.cat(emits, -1)))


def compact_symbols(symbols, valid):
    """Host-side: keep only emitted symbols (1-D, or a list per row)."""
    symbols = np.asarray(symbols)
    valid = np.asarray(valid).astype(bool)
    if symbols.ndim == 1:
        return symbols[valid]
    return [row[v] for row, v in zip(symbols, valid)]


def slice_dibits(symbols: np.ndarray) -> np.ndarray:
    """C4FM slicer, levels [-2, 0, 2] (op25 fsk4_slicer_fb contract):
    +3→1, +1→0, -1→2, -3→3."""
    s = np.asarray(symbols)
    return np.where(s > 2.0, 1,
                    np.where(s > 0.0, 0,
                             np.where(s > -2.0, 2, 3))).astype(np.uint8)


def slice_dibits_torch(symbols: torch.Tensor) -> torch.Tensor:
    """The same slicer on a tensor, int32 dibits."""
    s = symbols
    return torch.where(s > 2.0, 1,
                       torch.where(s > 0.0, 0,
                                   torch.where(s > -2.0, 2, 3))
                       ).to(torch.int32)


def boxcar_taps(samp_rate: float, symbol_rate: float) -> np.ndarray:
    """Integrate-and-dump symbol filter over half a symbol (the C4FM
    shaping filter's x/sin(x) term pre-compensates a T/2 integrator)."""
    n = max(1, int(round(samp_rate / symbol_rate / 2.0)))
    return np.full(n, 1.0 / n, np.float32)
