"""The plain reference of ``receiver_split2``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import chan_xlat as _xlat
from benchmark.reference import taps as _taps
from benchmark.reference.channelize import (bank, grid_hz, lanes,
                                            modulated, padded, phase_at,
                                            phase_step, ramp, rounded,
                                            tail, wire_complex)


class Chan:
    """``receiver_split2``: each source into two half-rate sources at ∓fs/4
    by a 2-slot complex bank (decim 2), then the wire bank of the CQPSK
    configuration on each half."""

    def __init__(self, cfg: dict, samp_rate: float, n_sources: int,
                 block: int, dev):
        half = samp_rate / 2.0
        bw = half / 2.0
        self.h1 = padded(_taps.low_pass(1.0, samp_rate, bw, 0.5 * bw), 2)
        self.k1 = len(self.h1)
        offs1 = np.tile(np.array([-0.25, 0.25], np.float32), (n_sources, 1))
        self.step1 = phase_step(offs1, 2)
        self.grev1 = modulated(self.h1, torch.as_tensor(offs1, device=dev))
        self.half = block // 2
        self.xl = _xlat.Chan(cfg, half, 2 * n_sources, self.half, dev)
        self.dev = dev

    def sizes(self) -> dict:
        return {"split_taps": self.k1, "half": self.half, "taps": self.xl.k,
                "decim": self.xl.d, "n_out": self.xl.n}

    @staticmethod
    def n_lanes(cfg: dict) -> int:
        """Channel lanes a physical source: both halves' slots."""
        return 2 * cfg["slots"]

    @staticmethod
    def slot_hz(cfg: dict, samp_rate: float) -> np.ndarray:
        g = grid_hz(cfg)
        return np.concatenate([g - samp_rate / 4.0, g + samp_rate / 4.0])

    @staticmethod
    def channel_fs(cfg: dict, samp_rate: float) -> float:
        return _xlat.Chan.channel_fs(cfg, samp_rate / 2.0)

    def __call__(self, prev, x, k: int, prec: str | None = None):
        xc, pc = wire_complex(x), None if prev is None else wire_complex(prev)
        k1, k2, t2 = self.k1, self.xl.k, self.half
        lead = 2 * (k2 - 1) + k1
        z = torch.cat([tail(pc, xc, lead), xc], dim=1)[:, 1:]
        n = (k2 - 1) + t2
        y = bank(z, self.grev1, 2, n, None if prec is None else "tf32")
        first = k * t2 - (k2 - 1)
        rot = ramp(phase_at(self.step1, first), self.step1, n, self.dev)
        y = y * (rot if prec is None else rot.to(torch.complex64))
        if prev is None:                      # the halves before block 0
            y[..., :k2 - 1] = 0
        s = y.shape[0]
        src = y.reshape(2 * s, n)             # logical source 2·phys + half
        planes = self.xl.planes(src, k, prec)
        if prec is not None:
            src = rounded(src, "fp8")
        state = {"split2.history": xc[:, xc.shape[1] - (k1 - 1):],
                 "split2.phase": phase_at(self.step1, t2 * (k + 1)),
                 "bank.history": src[:, n - (k2 - 1):],
                 "bank.phase": phase_at(self.xl.step, self.xl.n * (k + 1))}
        return lanes(planes), state
