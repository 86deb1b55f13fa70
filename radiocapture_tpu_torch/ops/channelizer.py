"""The xlat channelizer bank (port of ``radiocapture_tpu.ops.channelizer.
XlatBank``): C channel slots extracted from each of S wideband sources by
a bank of frequency-translating decimating FIRs.

Slot offsets are runtime data, so channel create/release/retune needs no
rebuild. The JAX package vmaps one source; here the source axis ``S``
leads every tensor. The wire entry points (``call_wire``,
``call_planes``) go through the fused bf16 bank (kernel
``csrc/xlat_bank.cu``); the entry point ``__call__`` (complex or wire
blocks) goes through the float32 complex bank (kernel
``csrc/xlat_complex.cu``) and carries its history in complex64, as the
JAX ``__call__`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.ops import taps as _taps
from radiocapture_tpu_torch.ops.channelizer_kernel import (
    bank_complex, bank_fused, kernel_tap_matrix, tap_matrix)
from radiocapture_tpu_torch.ops.fir import U32_MASK, phase_step_u32


class XlatBankState(NamedTuple):
    history: torch.Tensor  # [S, ntaps-1] complex64 wideband history
    phase: torch.Tensor    # [S, num_slots] int64: uint32 mixer phase


def carried_history(history: torch.Tensor, x2: torch.Tensor
                     ) -> torch.Tensor:
    """The wire bank's new history: the last K-1 samples of history ++ x2
    [S, T, 2], with the history first taken to the wire's dtype, as
    complex64 [S, K-1] (the JAX ``XlatBank.call_wire``,
    channelizer.py:218-231). For T ≥ K-1 that is the block's last K-1
    samples; a shorter block keeps the history's tail in front. Device
    independent: the kernel's bf16 z2 never feeds it, so a float32 wire
    carries its float32 samples exactly. Always a copy: the caller may
    reuse x2's memory for the next block."""
    k1 = history.shape[1]
    t = x2.shape[1]
    if t >= k1:
        tail = x2[:, t - k1:]
    else:
        hist2 = torch.view_as_real(history).to(x2.dtype)
        tail = torch.cat([hist2[:, t:], x2], dim=1)
    return torch.view_as_complex(
        tail.to(torch.float32, copy=True).contiguous())


def complex_history(history: torch.Tensor, x2: torch.Tensor
                    ) -> torch.Tensor:
    """``XlatBank.__call__``'s new history: the last K-1 samples of
    history ++ x2 [S, T, 2] as complex64 [S, K-1], exactly (the JAX
    ``__call__``, channelizer.py:123, 171). A block shorter than K-1 keeps
    the history's own float32 samples in front, where
    ``carried_history`` would round them to the wire's dtype. Always a
    copy."""
    k1, t = history.shape[1], x2.shape[1]
    tail = torch.view_as_complex(
        x2[:, max(t - k1, 0):].to(torch.float32, copy=True).contiguous())
    if t >= k1:
        return tail
    return torch.cat([history[:, t:], tail], dim=1)


class XlatBank:
    """A bank of ``num_slots`` freq-xlating decimating FIR channels per
    source. All slots share taps and decimation (every channel is 12.5 kHz
    at 2× channel rate, as in the reference)."""

    def __init__(self, num_slots: int, decim: int, taps: np.ndarray):
        # taps padded to a multiple of decim: P polyphase branches of D
        pad = (-len(taps)) % decim
        if pad:
            taps = np.concatenate([taps, np.zeros(pad, taps.dtype)])
        self.num_slots = num_slots
        self.decim = decim
        self.taps = np.asarray(taps, np.float32)
        self.ntaps = len(taps)
        self.p = self.ntaps // decim
        self._device_taps: dict = {}     # device -> taps tensor

    @classmethod
    def for_rates(cls, num_slots: int, samp_rate: float, channel_rate: float,
                  out_per_channel_rate: float | None = None) -> "XlatBank":
        """IQ at 2× channel_rate; 60 dB stopband, half-channel transition
        (same design as the JAX package)."""
        out_rate = out_per_channel_rate or 2.0 * channel_rate
        decim = int(round(samp_rate / out_rate))
        taps = _taps.low_pass_2(1.0, samp_rate, channel_rate / 2.0,
                                0.5 * channel_rate, 60.0)
        return cls(num_slots, decim, taps)

    def init(self, n_sources: int, device) -> XlatBankState:
        return XlatBankState(
            history=torch.zeros((n_sources, self.ntaps - 1),
                                dtype=torch.complex64, device=device),
            phase=torch.zeros((n_sources, self.num_slots),
                              dtype=torch.int64, device=device))

    def operands(self, state: XlatBankState, x2: torch.Tensor,
                 offsets_norm: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The fused bank's operands for one wire block x2 [S, T, 2]:
        (z2 [S, (K+T)·2] history ++ block ++ one zero sample, g2 the tap
        matrix, step [S, C] uint32 phase step as int64).

        The zero sample makes z2's row (N+P)·2D values long, N = T/D: a
        whole number of 2D-value rows, which the kernel's tensor map reads
        in place (its per-source stride must be a multiple of 16 bytes;
        history ++ block alone is 2 values short of one). On CUDA z2 is
        bf16 and g2 the bf16 tap matrix in the kernel's slot-group layout
        (``kernel_tap_matrix``); on CPU z2 keeps the wire dtype and g2 is
        the float32 [S, P·2D, 2C] ``tap_matrix``, the plain version's."""
        cuda = x2.device.type == "cuda"
        hist2 = torch.view_as_real(state.history).to(
            torch.bfloat16 if cuda else x2.dtype)
        z2 = torch.cat([hist2, x2.to(hist2.dtype),
                        hist2.new_zeros((x2.shape[0], 1, 2))], dim=1)
        build = kernel_tap_matrix if cuda else tap_matrix
        g2 = build(self.device_taps(x2.device), offsets_norm, self.p,
                   self.decim)
        return (z2.reshape(x2.shape[0], -1), g2,
                phase_step_u32(offsets_norm, self.decim))

    def call_planes(self, state: XlatBankState, x2: torch.Tensor,
                    offsets_norm: torch.Tensor
                    ) -> tuple[XlatBankState, torch.Tensor, torch.Tensor]:
        """x2 [S, T, 2] float32/bf16 wire block, T % decim == 0;
        offsets_norm [S, C] float32 cycles/sample.
        Returns (state, y_re, y_im) with time-major planes [S, T//decim, C]
        float32 — the layout the tracker kernel reads. The new history is
        ``carried_history``: history ++ x2 in the wire's dtype, not the
        kernel's bf16 z2."""
        d, p = self.decim, self.p
        t = x2.shape[1]
        if t % d or x2.shape[-1] != 2 or x2.dim() != 3:
            raise ValueError(f"x2 must be [S, T, 2] with T % {d} == 0, "
                             f"got {tuple(x2.shape)}")
        n_out = t // d
        z2, g2, step = self.operands(state, x2, offsets_norm)
        y_re, y_im = bank_fused(z2, g2, state.phase, step, n_out, p, d)
        new_phase = (state.phase + step * n_out) & U32_MASK
        return (XlatBankState(history=carried_history(state.history, x2),
                              phase=new_phase), y_re, y_im)

    def call_wire(self, state: XlatBankState, x2: torch.Tensor,
                  offsets_norm: torch.Tensor
                  ) -> tuple[XlatBankState, torch.Tensor]:
        """The JAX contract: x2 [S, T, 2] → channels [S, C, T//decim]
        complex64."""
        state, y_re, y_im = self.call_planes(state, x2, offsets_norm)
        return state, torch.complex(y_re, y_im).transpose(1, 2)

    def device_taps(self, device) -> torch.Tensor:
        """The prototype taps [K] float32 on ``device``, copied there once:
        PyTorch follows a host→device copy of pageable memory with a
        stream synchronize, which would stall every step."""
        device = torch.device(device)
        h = self._device_taps.get(device)
        if h is None:
            h = self._device_taps[device] = torch.as_tensor(self.taps,
                                                            device=device)
        return h

    def modulated_taps(self, offsets_norm: torch.Tensor) -> torch.Tensor:
        """Per-slot modulated taps ``g[s, c, k] = h[k]·e^{j2πf·k}``,
        correlation-reversed: [S, C, K] complex64. Built with one
        sin/cos per tap, as the JAX ``__call__`` builds them
        (channelizer.py:117-122)."""
        dev = offsets_norm.device
        kk = torch.arange(self.ntaps, dtype=torch.float32, device=dev)
        ang = float(np.float32(2.0 * np.pi)) * offsets_norm.to(
            torch.float32)[..., None] * kk
        h = self.device_taps(dev)
        return torch.complex(h * torch.cos(ang), h * torch.sin(ang)).flip(-1)

    def __call__(self, state: XlatBankState, x: torch.Tensor,
                 offsets_norm: torch.Tensor
                 ) -> tuple[XlatBankState, torch.Tensor]:
        """x [S, T] complex64, or an [S, T, 2] bf16/float32 wire block,
        T % decim == 0; offsets_norm [S, C] float32 cycles/sample →
        channels [S, C, T//decim] complex64, in float32 throughout. The
        block and the history go to the kernel as they are (a complex64
        block as its float32 view); the new history is the last K-1
        samples of history ++ x as complex64, exactly
        (``complex_history``)."""
        return self.call_taps(state, x, self.modulated_taps(offsets_norm),
                              phase_step_u32(offsets_norm, self.decim))

    def call_taps(self, state: XlatBankState, x: torch.Tensor,
                  grev: torch.Tensor, step: torch.Tensor
                  ) -> tuple[XlatBankState, torch.Tensor]:
        """``__call__`` with the offsets' operands given: grev [S, C, K]
        (``modulated_taps``) and step [S, C] (``phase_step_u32``), which a
        caller whose offsets never change builds once."""
        d = self.decim
        if x.is_complex():
            x = torch.view_as_real(x.to(torch.complex64))
        if x.dim() != 3 or x.shape[-1] != 2 or x.shape[1] % d:
            raise ValueError(f"x must be [S, T] complex or [S, T, 2] wire "
                             f"with T % {d} == 0, got {tuple(x.shape)}")
        y = bank_complex(x, state.history, grev, state.phase, step, d)
        new_phase = (state.phase + step * (x.shape[1] // d)) & U32_MASK
        return XlatBankState(history=complex_history(state.history, x),
                             phase=new_phase), y
