"""The plain reference of the wire bank (frontend ``xlat``)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import taps as _taps
from benchmark.reference.channelize import (bank, grid_hz, lanes,
                                            modulated, padded, phase_at,
                                            phase_step, ramp, rounded,
                                            slot_offsets, tail,
                                            wire_complex)


class Chan:
    """The wire bank (``frontend`` xlat): C slots of each source by a
    frequency-translating decimating FIR at twice the channel rate."""

    def __init__(self, cfg: dict, samp_rate: float, n_sources: int,
                 block: int, dev):
        ch = cfg["channel_rate"]
        self.d = int(round(samp_rate / (2.0 * ch)))
        self.h = padded(_taps.low_pass_2(1.0, samp_rate, ch / 2.0,
                                         0.5 * ch, 60.0), self.d)
        self.k = len(self.h)
        self.n = block // self.d
        offs = slot_offsets(cfg, samp_rate, n_sources)
        self.step = phase_step(offs, self.d)
        self.grev = modulated(self.h, torch.as_tensor(offs, device=dev))
        self.dev = dev

    def sizes(self) -> dict:
        return {"taps": self.k, "decim": self.d, "n_out": self.n}

    @staticmethod
    def n_lanes(cfg: dict) -> int:
        """Channel lanes a source."""
        return cfg["slots"]

    @staticmethod
    def slot_hz(cfg: dict, samp_rate: float) -> np.ndarray:
        """Wideband offsets of the slots a channel may sit on, Hz."""
        return grid_hz(cfg)

    @staticmethod
    def channel_fs(cfg: dict, samp_rate: float) -> float:
        return samp_rate / int(round(samp_rate / (2.0 * cfg["channel_rate"])))

    def planes(self, z: torch.Tensor, k: int, prec: str | None,
               n: int | None = None) -> torch.Tensor:
        n = self.n if n is None else n
        y = bank(z, self.grev, self.d, n,
                 None if prec is None else "fp8")
        rot = ramp(phase_at(self.step, self.n * k), self.step, n, self.dev)
        return y * (rot if prec is None else rot.to(torch.complex64))

    def __call__(self, prev, x, k: int, prec: str | None = None):
        """(planes [S·C, N], state after block k)."""
        xc, pc = wire_complex(x), None if prev is None else wire_complex(prev)
        z = torch.cat([tail(pc, xc, self.k - 1), xc], dim=1)
        y = self.planes(z, k, prec)
        if prec is not None:
            xc = rounded(xc, "fp8")
        state = {"bank.history": xc[:, xc.shape[1] - (self.k - 1):],
                 "bank.phase": phase_at(self.step, self.n * (k + 1))}
        return lanes(y), state
