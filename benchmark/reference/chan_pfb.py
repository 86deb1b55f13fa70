"""The plain reference of the pfb frontend."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import chan_xlat as _xlat
from benchmark.reference import taps as _taps
from benchmark.reference.channelize import (bank, lanes, modulated, padded,
                                            phase_at, phase_step, ramp,
                                            round_tf32, rounded,
                                            slot_offsets, tail,
                                            wire_complex)


class Chan:
    """The pfb frontend: the coarse M-branch polyphase FFT channelizer
    into ``pfb_bin_rate`` bins, then a fine xlat filter a slot from its
    bin, at twice the channel rate."""

    def __init__(self, cfg: dict, samp_rate: float, n_sources: int,
                 block: int, dev):
        bin_rate, ch = cfg["pfb_bin_rate"], cfg["channel_rate"]
        m = self.m = int(round(samp_rate / bin_rate))
        bw = samp_rate / m
        taps = padded(_taps.optimal_low_pass(
            1.0, samp_rate, 0.40 * bw, 0.55 * bw, stopband_atten_db=80.0), m)
        self.p = len(taps) // m
        # h[q, m'] = taps[q·M + m']: branch m' of polyphase tap q
        self.hq = torch.as_tensor(taps.reshape(self.p, m).astype(np.float64),
                                  device=dev)
        self.d2 = int(round(bin_rate / (2.0 * ch)))
        self.h2 = _taps.low_pass_2(1.0, bin_rate, ch / 2.0, 0.25 * ch, 60.0)
        self.k2 = len(self.h2)
        self.rows = block // m
        self.n = self.rows // self.d2
        offs = slot_offsets(cfg, samp_rate, n_sources)
        cyc = offs * np.float32(m)
        chan = np.round(cyc)
        fine = (cyc - chan).astype(np.float32)
        self.bin = np.remainder(chan.astype(np.int64), m)       # [S, C]
        self.step = phase_step(fine, self.d2)
        self.grev = modulated(self.h2, torch.as_tensor(fine, device=dev)
                              .reshape(-1, 1))                 # [S·C, 1, K2]
        self.dev = dev

    def sizes(self) -> dict:
        return {"branches": self.m, "branch_taps": self.p,
                "fine_taps": self.k2, "fine_decim": self.d2,
                "bin_rows": self.rows, "n_out": self.n}

    slot_hz = _xlat.Chan.slot_hz
    n_lanes = _xlat.Chan.n_lanes

    @staticmethod
    def channel_fs(cfg: dict, samp_rate: float) -> float:
        bin_rate = cfg["pfb_bin_rate"]
        return bin_rate / int(round(bin_rate / (2.0 * cfg["channel_rate"])))

    def bins(self, z: torch.Tensor, prec: str | None) -> torch.Tensor:
        """Coarse bins [S, M, rows - P + 1] of the wideband z [S, L], L a
        multiple of M, for the rows whose window lies inside z: bin c of
        row t is ``e^{j2πc/M} Σ_m' e^{j2πc(M-1-m')/M} v'[t, m']``, ``v'[t,
        m'] = Σ_q h[q, M-1-m'] · z[(t-q)·M + m']``."""
        s, length = z.shape
        m, p = self.m, self.p
        if prec is not None:
            z = rounded(z, "tf32")
        zr = z.reshape(s, length // m, m)
        n = length // m - p + 1
        hq = self.hq.flip(1)                          # h[q, M-1-m']
        if prec is not None:
            hq = round_tf32(hq.to(torch.float32))
        v = None
        for q in range(p):
            t = zr[:, p - 1 - q:p - 1 - q + n] * hq[q]
            v = t if v is None else v + t
        c = torch.arange(m, device=z.device, dtype=torch.float64)
        mm = m - 1 - torch.arange(m, device=z.device, dtype=torch.float64)
        w = torch.polar(torch.ones(m, m, dtype=torch.float64, device=z.device),
                        2.0 * math.pi * c[:, None] * (mm[None, :] + 1) / m)
        if prec is not None:
            w = w.to(torch.complex64)
        return torch.einsum("stm,cm->sct", v, w)

    def __call__(self, prev, x, k: int, prec: str | None = None):
        xc, pc = wire_complex(x), None if prev is None else wire_complex(prev)
        m, p, k2 = self.m, self.p, self.k2
        lead = (p - 1 + k2 - 1) * m
        b = self.bins(torch.cat([tail(pc, xc, lead), xc], dim=1), prec)
        s, _, nb = b.shape
        sel = torch.as_tensor(self.bin, device=self.dev)      # [S, C]
        rows = b[torch.arange(s, device=self.dev)[:, None], sel]  # [S,C,nb]
        c = sel.shape[1]
        z = rows.reshape(s * c, nb)
        y = bank(z, self.grev, self.d2, self.n,
                 None if prec is None else "tf32")
        rot = ramp(phase_at(self.step.reshape(-1, 1), self.n * k),
                   self.step.reshape(-1, 1), self.n, self.dev)
        y = y * (rot if prec is None else rot.to(torch.complex64))
        state = {"pfb.history": xc[:, xc.shape[1] - (p - 1) * m:],
                 "fine.history": z[:, nb - (k2 - 1):].reshape(s, c, k2 - 1),
                 "fine.phase": phase_at(self.step, self.n * (k + 1))}
        return lanes(y), state
