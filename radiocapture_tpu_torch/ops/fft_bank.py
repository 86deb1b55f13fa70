"""Overlap-save FFT channelizer bank, ``frontend_mode`` 'fft' (port of
``radiocapture_tpu.ops.fft_bank``): the F-engine form of ``XlatBank``.

Same contract as the xlat bank (``(state, x[S, T], offsets_norm[S, C]) ->
(state, y[S, C, T//D])``, slot offsets are runtime data), but per window
of ``n_fft = D·N_blk`` samples the work is one forward FFT plus a band
extraction per slot:

    z = hist(V) ++ x(T)                  N_fft = V + T = D·N_blk
    X = FFT(z)                           (cuFFT on CUDA: 3·2^16 at 2.4 MS/s)
    per slot c:  b_c = round(f_c·N_fft)
      Y_c[k''] = X[(b_c + k'') mod N_fft] · Hband[k'']   (N_blk bins)
      y_c[n]   = IFFT_{N_blk}(Y_c)[n] · e^{i·u32angle(phase + comb·n)}

``Hband`` folds the channel filter's DFT, the overlap-save time shift and
the 1/D; ``comb`` folds the xlat mixer step with the exact (power-of-two
denominator) ``b_c/N_blk`` extraction rotation, so the slot lands at DC
with the xlat bank's uint32 phase continuity. Inside the extracted band
the response is the FIR's exactly; outside it the rejection is infinite
instead of the FIR's stopband (the JAX module's docstring, :22-31).
No hand kernel: the FFTs are cuFFT's, the rest torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.ops import taps as _taps
from radiocapture_tpu_torch.ops.channelizer import (as_complex, device_const,
                                                    planes)
from radiocapture_tpu_torch.ops.fir import (U32_MASK, phase_step_u32,
                                            u32_to_angle)


class FftXlatBankState(NamedTuple):
    history: torch.Tensor  # [S, V] complex64 wideband history
    phase: torch.Tensor    # [S, num_slots] int64: uint32 mixer phase


class FftXlatBank:
    """Drop-in for ``XlatBank`` built on overlap-save FFTs.

    ``block_multiple`` is the per-window valid length T = D·N_blk − V;
    blocks may be any multiple of it (windows chain through the history
    state exactly like xlat blocks)."""

    def __init__(self, num_slots: int, decim: int, taps: np.ndarray,
                 n_blk: int = 2048):
        if n_blk & (n_blk - 1):
            raise ValueError("n_blk must be a power of two")
        self.num_slots = num_slots
        self.decim = decim
        self.n_blk = n_blk
        self.n_fft = decim * n_blk
        k = len(taps)
        if k >= self.n_fft // 2:
            raise ValueError("taps too long for the FFT window")
        self.ntaps = k
        # overlap: the smallest multiple of D covering the filter history
        self.v = -((-(k - 1)) // decim) * decim
        self.t_window = self.n_fft - self.v
        if self.t_window <= 0:
            raise ValueError("filter longer than the FFT window")
        self.block_multiple = self.t_window
        # Hband[k'] = H(koff)·e^{2πi·koff·V/N_fft}/D, natural IFFT order
        # (host float64 → complex64, as the JAX package builds it)
        hfull = np.fft.fft(np.asarray(taps, np.float64), self.n_fft)
        kp = np.arange(n_blk)
        koff = np.where(kp < n_blk // 2, kp, kp - n_blk)
        self.hband = (hfull[koff % self.n_fft]
                      * np.exp(2j * np.pi * koff * self.v / self.n_fft)
                      / decim).astype(np.complex64)
        self.koff = koff.astype(np.int64)
        self._consts: dict = {}

    @classmethod
    def for_rates(cls, num_slots: int, samp_rate: float,
                  channel_rate: float,
                  out_per_channel_rate: float | None = None,
                  n_blk: int = 2048) -> "FftXlatBank":
        """The ``XlatBank.for_rates`` taps and rates (channel IQ at 2×
        channel_rate)."""
        out_rate = out_per_channel_rate or 2.0 * channel_rate
        decim = int(round(samp_rate / out_rate))
        taps = _taps.low_pass_2(1.0, samp_rate, channel_rate / 2.0,
                                0.5 * channel_rate, 60.0)
        return cls(num_slots, decim, taps, n_blk=n_blk)

    def init(self, n_sources: int, device) -> FftXlatBankState:
        return FftXlatBankState(
            history=torch.zeros((n_sources, self.v), dtype=torch.complex64,
                                device=device),
            phase=torch.zeros((n_sources, self.num_slots),
                              dtype=torch.int64, device=device))

    def _window(self, hist: torch.Tensor, x: torch.Tensor,
                phase: torch.Tensor, offsets_norm: torch.Tensor):
        """One overlap-save window: hist [S, V] ++ x [S, T] → (hist, phase,
        y [S, C, T//D])."""
        d, nb, nf = self.decim, self.n_blk, self.n_fft
        n_out = self.t_window // d
        dev = x.device
        off = offsets_norm.to(torch.float32)
        z = torch.cat([hist, x], dim=1)                      # [S, N_fft]
        xf = torch.fft.fft(z, dim=-1)
        # integer-bin slot centres, in float32: the JAX package asks for
        # float64, which it has only with jax_enable_x64, and the repo
        # never enables it
        bc = torch.round(off * float(np.float32(nf))).to(torch.int64)
        koff = device_const(self._consts, "koff", self.koff, dev)
        idx = torch.remainder(bc[..., None] + koff, nf)      # [S, C, N_blk]
        s, c = bc.shape
        yb = torch.gather(xf, 1, idx.reshape(s, c * nb)).view(s, c, nb)
        w = torch.fft.ifft(
            yb * device_const(self._consts, "hband", self.hband, dev),
            dim=-1)[..., :n_out]
        # mixer: the xlat bank's exact uint32 ramp plus the pow2-exact
        # extraction terms b_c·n/N_blk and b_c·(V/D)/N_blk
        shift = 32 - int(np.log2(nb))
        step = phase_step_u32(off, d)
        comb = (step + (torch.remainder(bc, nb) << shift)) & U32_MASK
        const = (torch.remainder(bc * (self.v // d), nb) << shift) & U32_MASK
        ramp = (((phase + const) & U32_MASK)[..., None]
                + comb[..., None] * torch.arange(n_out, device=dev)
                ) & U32_MASK
        # filter-centring phase: the band filter sits at b_c/N_fft, δ_c off
        # the slot centre; its linear phase gives −2πδ_c(K−1)/2
        delta = off - bc.to(torch.float32) / float(np.float32(nf))
        phi = (float(np.float32(2.0 * np.pi)) * delta
               * float(np.float32((self.ntaps - 1) / 2.0)))
        ang = u32_to_angle(ramp) + phi[..., None]
        y = w * torch.complex(torch.cos(ang), torch.sin(ang))
        new_phase = (phase + step * n_out) & U32_MASK
        return z[:, nf - self.v:].contiguous(), new_phase, y

    def __call__(self, state: FftXlatBankState, x: torch.Tensor,
                 offsets_norm: torch.Tensor
                 ) -> tuple[FftXlatBankState, torch.Tensor]:
        """x [S, T] complex64 (or an [S, T, 2] wire block), T %
        block_multiple == 0 → (state, y [S, C, T//decim] complex64)."""
        x = as_complex(x)
        t = x.shape[1]
        if t % self.t_window:
            raise ValueError(
                f"block {t} not a multiple of window {self.t_window}")
        hist, phase = state.history, state.phase
        outs = []
        for w0 in range(0, t, self.t_window):
            hist, phase, y = self._window(
                hist, x[:, w0:w0 + self.t_window], phase, offsets_norm)
            outs.append(y)
        y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return FftXlatBankState(history=hist, phase=phase), y

    call_wire = __call__   # the JAX contract's name; takes either layout

    def call_planes(self, state: FftXlatBankState, x: torch.Tensor,
                    offsets_norm: torch.Tensor
                    ) -> tuple[FftXlatBankState, torch.Tensor, torch.Tensor]:
        """``__call__`` with the channels as time-major float32 planes
        y_re, y_im [S, T//decim, C], the layout the trackers read."""
        state, y = self(state, x, offsets_norm)
        return (state, *planes(y))
