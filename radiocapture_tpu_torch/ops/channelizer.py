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

Also the ``pfb`` frontend mode: ``PfbChannelizer`` (the coarse polyphase
FFT channelizer, its bins one launch of ``csrc/pfb_rows.cu``'s
``pfb_bins`` kernel) and
``PfbXlatBank`` (its bins, then each slot's bin mixed to the slot's
offset and filtered by the one real prototype, ``csrc/pfb_fine.cu``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.ops import taps as _taps
from radiocapture_tpu_torch.ops.channelizer_kernel import (
    bank_complex, bank_fused, bank_operands, bank_operands_plain, tap_matrix,
    wire_z2)
from radiocapture_tpu_torch.ops.fir import U32_MASK, XlatState, phase_step_u32
from radiocapture_tpu_torch.ops.pfb_kernel import (pfb_bins, pfb_fine,
                                                   pfb_rows, rotation)
from radiocapture_tpu_torch.utils import trace


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


def row_history(history: torch.Tensor, x: torch.Tensor, rows: torch.Tensor
                ) -> torch.Tensor:
    """``complex_history(history, x[rows])`` without gathering x: history
    [S', K-1] complex64, x [R, T, 2], rows [S'] int64 (``pfb_fine``'s
    row index). Only the last K-1 samples of each indexed row are
    selected (``index_select``: one [S', K-1] copy); a block shorter than
    K-1 keeps the history's own samples in front. Bit for bit
    ``complex_history(history, x[rows])`` on every device."""
    k1, t = history.shape[1], x.shape[1]
    tail = torch.view_as_complex(torch.index_select(
        x[:, max(t - k1, 0):], 0, rows).to(torch.float32).contiguous())
    if t >= k1:
        return tail
    return torch.cat([history[:, t:], tail], dim=1)


def modulated_taps(h: torch.Tensor, offsets_norm: torch.Tensor
                   ) -> torch.Tensor:
    """Per-slot modulated taps ``g[..., k] = h[k]·e^{j2πf·k}`` of the real
    taps h [K] (on the offsets' device), correlation-reversed:
    [..., K] complex64 for offsets [...]. Built with one sin/cos per tap,
    as the JAX ``XlatBank.__call__`` and ``ops.fir.freq_xlating_fir``
    build them (channelizer.py:117-122, fir.py:131-133)."""
    kk = torch.arange(h.shape[0], dtype=torch.float32, device=h.device)
    ang = float(np.float32(2.0 * np.pi)) * offsets_norm.to(
        torch.float32)[..., None] * kk
    return torch.complex(h * torch.cos(ang), h * torch.sin(ang)).flip(-1)


def device_const(cache: dict, name: str, value: np.ndarray,
                 device) -> torch.Tensor:
    """``value`` on ``device``, copied there once and kept in ``cache``:
    PyTorch follows a host→device copy of pageable memory with a stream
    synchronize, which would stall every step. A copy made counts its
    host seconds in ``setup.plans_s``."""
    key = (name, torch.device(device))
    t = cache.get(key)
    if t is None:
        with trace.timed("setup.plans_s"):
            t = cache[key] = torch.as_tensor(value, device=device)
    return t


def as_complex(x: torch.Tensor) -> torch.Tensor:
    """[S, T] complex or an [S, T, 2] wire block → [S, T] complex64 (the
    JAX ``_bank_step``'s complexify; bf16 → float32 is exact)."""
    if x.is_complex():
        return x.to(torch.complex64)
    return torch.view_as_complex(x.to(torch.float32).contiguous())


def planes(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Channels [S, C, N] complex64 → the time-major float32 planes
    y_re, y_im [S, N, C] the trackers read."""
    yt = y.transpose(1, 2)
    return yt.real.contiguous(), yt.imag.contiguous()


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
        self._consts: dict = {}          # device copies (device_const)

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
        history ++ block alone is 2 values short of one). On CUDA one
        launch of the operands kernel (``bank_operands``) writes all three:
        z2 in bf16 and g2 in the bank kernel's slot-group layout, bit for
        bit :meth:`operands_plain`'s. On CPU this is
        :meth:`operands_plain`."""
        if x2.device.type == "cpu":
            return self.operands_plain(state, x2, offsets_norm)
        return bank_operands(state.history, x2, offsets_norm,
                             self.device_taps(x2.device), self.p, self.decim)

    def operands_plain(self, state: XlatBankState, x2: torch.Tensor,
                       offsets_norm: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`operands` in plain PyTorch. On CUDA tensors the
        operands kernel's plain version (``bank_operands_plain``: bf16 z2,
        bf16 g2 in the kernel's layout, ``kernel_tap_matrix``); on CPU z2
        keeps the wire dtype and g2 is the float32 [S, P·2D, 2C]
        ``tap_matrix``, the plain bank's."""
        taps = self.device_taps(x2.device)
        if x2.device.type == "cuda":
            return bank_operands_plain(state.history, x2, offsets_norm, taps,
                                       self.p, self.decim)
        return (wire_z2(state.history, x2, x2.dtype),
                tap_matrix(taps, offsets_norm, self.p, self.decim),
                phase_step_u32(offsets_norm, self.decim))

    def call_planes(self, state: XlatBankState, x2: torch.Tensor,
                    offsets_norm: torch.Tensor
                    ) -> tuple[XlatBankState, torch.Tensor, torch.Tensor]:
        """x2 [S, T, 2] float32/bf16 wire block (an [S, T] complex block
        as its float32 view), T % decim == 0; offsets_norm [S, C] float32
        cycles/sample.
        Returns (state, y_re, y_im) with time-major planes [S, T//decim, C]
        float32 — the layout the tracker kernel reads. The new history is
        ``carried_history``: history ++ x2 in the wire's dtype, not the
        kernel's bf16 z2."""
        d, p = self.decim, self.p
        if x2.is_complex():
            x2 = torch.view_as_real(x2.to(torch.complex64))
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
        """The prototype taps [K] float32 on ``device``, copied there once
        (``device_const``)."""
        return device_const(self._consts, "taps", self.taps, device)

    def modulated_taps(self, offsets_norm: torch.Tensor) -> torch.Tensor:
        """``modulated_taps`` of this bank's prototype taps."""
        return modulated_taps(self.device_taps(offsets_norm.device),
                              offsets_norm)

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


class PfbState(NamedTuple):
    history: torch.Tensor  # [S, (P-1)·M] complex64


class PfbChannelizer:
    """Critically sampled M-channel polyphase FFT channelizer (port of the
    JAX ``PfbChannelizer``, channelizer.py:239-301): channel ``c`` is
    centred at ``+c·fs/M`` (FFT bin order; c > M/2 aliases to negative
    offsets) and delivered at ``fs/M``, the contract of the reference's
    ``pfb.channelizer_ccf`` with oversample 1 (rc_frontend/receiver.py:
    249-261)."""

    def __init__(self, num_channels: int, taps: np.ndarray):
        m = num_channels
        pad = (-len(taps)) % m
        if pad:
            taps = np.concatenate([taps, np.zeros(pad, taps.dtype)])
        self.num_channels = m
        self.ntaps = len(taps)
        self.p = self.ntaps // m
        hp = np.asarray(taps, np.float32).reshape(self.p, m).T  # [M, P]
        # branch m sees x[nM - m - pM]; rows of M samples arrive with the
        # branch index reversed, so keep the reversed-row polyphase matrix
        self.hp2 = np.ascontiguousarray(hp[::-1])  # [M, P], row M-1-m
        self.rot = rotation(m)   # e^{j2πc/M}, the K-1 group delay's
        self._consts: dict = {}

    @classmethod
    def for_rates(cls, samp_rate: float, num_channels: int,
                  atten_db: float = 60.0) -> "PfbChannelizer":
        bin_bw = samp_rate / num_channels
        taps = _taps.optimal_low_pass(1.0, samp_rate, 0.40 * bin_bw,
                                      0.55 * bin_bw,
                                      stopband_atten_db=atten_db)
        return cls(num_channels, taps)

    def init(self, n_sources: int, device) -> PfbState:
        return PfbState(history=torch.zeros(
            (n_sources, (self.p - 1) * self.num_channels),
            dtype=torch.complex64, device=device))

    def device_hp2(self, device) -> torch.Tensor:
        """The reversed-row polyphase taps [M, P] float32 on ``device``,
        copied there once (``device_const``)."""
        return device_const(self._consts, "hp2", self.hp2, device)

    def _idft(self, state: PfbState, x: torch.Tensor
              ) -> tuple[PfbState, torch.Tensor, torch.Tensor]:
        """The combiner and the IDFT of ``rows``: (state, the IDFT's
        time-major [S, T//M, M] complex64, the rotation [M])."""
        m = self.num_channels
        if x.shape[1] % m:
            raise ValueError(f"block {x.shape[1]} is not a multiple of "
                             f"M={m}")
        v, hist = pfb_rows(state.history, x, self.device_hp2(x.device))
        # the branch combiner is an IDFT: y[n, c] = Σ_m v[n, m] e^{+j2πcm/M}
        return (PfbState(history=hist),
                torch.fft.ifft(v, dim=-1, norm="forward"),
                device_const(self._consts, "rot", self.rot, x.device))

    def rows(self, state: PfbState, x: torch.Tensor
             ) -> tuple[PfbState, torch.Tensor]:
        """x [S, T] complex64 or an [S, T, 2] bf16/float32 wire block,
        T % M == 0 → (state, channels time-major [S, T//M, M] complex64).

        The polyphase combiner is ``pfb_rows``: on CUDA one launch of
        ``csrc/pfb_rows.cu``, which reads the block and the history where
        they lie and writes the flipped branch rows and the new history; on
        CPU its plain version. Then one M-point inverse FFT per row (cuFFT
        on CUDA) and the per-channel rotation."""
        state, f, rot = self._idft(state, x)
        return state, f * rot

    def bins(self, state: PfbState, x: torch.Tensor
             ) -> tuple[PfbState, torch.Tensor]:
        """``rows`` with the channels bin-major: (state, [S, M, T//M]
        complex64, contiguous), each bin a contiguous row that the fine
        stage reads in place. ``pfb_bins``: on CUDA one launch of
        ``csrc/pfb_rows.cu``'s ``pfb_bins`` kernel (the combiner, the
        IDFT and the rotation from the block and the history where they
        lie, the new history bit for bit ``rows``', the channels within a
        few float32 ulps of ``rows``' transposed); on the CPU its plain
        version, ``rows``' channels transposed bit for bit."""
        m = self.num_channels
        if x.shape[1] % m:
            raise ValueError(f"block {x.shape[1]} is not a multiple of "
                             f"M={m}")
        y, hist = pfb_bins(state.history, x, self.device_hp2(x.device))
        return PfbState(history=hist), y

    def __call__(self, state: PfbState, x: torch.Tensor
                 ) -> tuple[PfbState, torch.Tensor]:
        """x [S, T] complex64 (or an [S, T, 2] wire block), T % M == 0 →
        channels [S, M, T//M] (``bins``)."""
        return self.bins(state, x)

    def channel_offset_hz(self, c: int, samp_rate: float) -> float:
        m = self.num_channels
        return ((c + m // 2) % m - m // 2) * samp_rate / m


class PfbXlatBankState(NamedTuple):
    pfb: PfbState
    fine: XlatState   # history [S, C, K2-1] complex64, phase [S, C] int64


class PfbXlatBank:
    """``frontend_mode`` 'pfb' (port of the JAX ``PfbXlatBank``,
    channelizer.py:309-366): the coarse PFB into ``bin_rate`` bins, then a
    fine freq-xlating FIR per slot from its bin, the reference's two-stage
    path (``channelizer_ccf`` bins at 400 kS/s feeding per-channel xlat
    filters at ``offset - chan·pfb_rate``, rc_frontend/receiver.py:
    242-261, 343-423). The ``XlatBank`` contract; the slot → bin routing
    is computed from ``offsets_norm`` every step.

    The fine stage is ``pfb_fine`` (``csrc/pfb_fine.cu``), each slot a
    row: S·C rows of the K2-tap prototype ``fine_taps``, decimating by
    ``decim2``. The JAX ``vmap(freq_xlating_fir)`` (ops/fir.py:117-143)
    modulates the prototype to each slot's fine offset and correlates;
    since every slot's taps are that one real prototype, the kernel mixes
    each bin sample to the slot's offset by the phasor of an exact uint32
    ramp, filters with the real taps (2 FMAs a tap, not 4) and folds the
    per-output factor into the rotation: the same function up to the
    rounding of the modulation's angle. On the CPU the fine stage is the
    JAX form itself (``modulated_taps`` on ``bank_complex``'s plain
    version of the gathered bins), which the parity tests hold to JAX's
    float32 arithmetic: the port's chaotic noise lanes agree with JAX's
    only where the channels round as JAX's do. On the card each row reads
    its slot's bin in place from the PFB's bin-major bins by a row index,
    as the JAX step's ``bins[chan]`` gather (channelizer.py:362) selects
    it; no gathered [S·C, T/M] block is built, and the kernel writes the
    trackers' planes itself (``call_planes``), so no [S, C, T//decim]
    complex channels are built on the step's path either."""

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float, bin_rate: float = 400e3,
                 out_per_channel_rate: float | None = None):
        m = int(round(samp_rate / bin_rate))
        if m < 1 or abs(samp_rate - m * bin_rate) > 1e-3:
            raise ValueError("samp_rate not round enough"
                             f" for {bin_rate} Hz bins: {samp_rate}")
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.bin_rate = float(bin_rate)
        self.m = m
        self.pfb = PfbChannelizer.for_rates(samp_rate, m, atten_db=80.0)
        out_rate = out_per_channel_rate or 2.0 * channel_rate
        self.decim2 = int(round(bin_rate / out_rate))
        self.decim = m * self.decim2
        self.fine_taps = np.asarray(_taps.low_pass_2(
            1.0, bin_rate, channel_rate / 2.0, 0.25 * channel_rate, 60.0),
            np.float32)
        self.ntaps2 = len(self.fine_taps)
        self._consts: dict = {}

    def init(self, n_sources: int, device) -> PfbXlatBankState:
        sc = (n_sources, self.num_slots)
        return PfbXlatBankState(
            pfb=self.pfb.init(n_sources, device),
            fine=XlatState(
                history=torch.zeros(sc + (self.ntaps2 - 1,),
                                    dtype=torch.complex64, device=device),
                phase=torch.zeros(sc, dtype=torch.int64, device=device)))

    def route(self, offsets_norm: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Slot → bin routing (reference ``chan = round(offset /
        pfb_rate)``, negative bins wrapped, rc_frontend/receiver.py:
        394-400): (bin [S, C] int64 in [0, M), fine offset [S, C] float32
        in cycles per bin sample). In float32 as the JAX package computes
        it, so a slot half a bin off rounds (half to even) as there."""
        cyc = offsets_norm.to(torch.float32) * float(np.float32(self.m))
        chan = torch.round(cyc)
        return torch.remainder(chan.to(torch.int64), self.m), cyc - chan

    def device_taps(self, device) -> torch.Tensor:
        """The fine stage's prototype ``fine_taps`` [K2] float32 on
        ``device``, copied there once (``device_const``)."""
        return device_const(self._consts, "taps", self.fine_taps, device)

    def fine_operands(self, state: PfbXlatBankState, x: torch.Tensor,
                      offsets_norm: torch.Tensor) -> tuple:
        """The coarse PFB step, then the fine stage's ``pfb_fine``
        operands but the taps, each slot a row: (PFB state, the bins
        [S·M, T/M, 2] float32, a view of ``PfbChannelizer.bins``, the row
        index [S·C] int64 ``s·M + bin[s, c]``, history [S·C, K2-1], the
        fine offsets [S·C] float32, phase0 and step [S·C])."""
        ps, bins = self.pfb.bins(state.pfb, x)               # [S, M, T/M]
        chan, fine = self.route(offsets_norm)
        s, m, n = bins.shape
        rows = (torch.arange(s, device=chan.device)[:, None] * m
                + chan).reshape(-1)
        c = chan.shape[1]
        return (ps, torch.view_as_real(bins).view(s * m, n, 2), rows,
                state.fine.history.reshape(s * c, -1), fine.reshape(-1),
                state.fine.phase.reshape(-1),
                phase_step_u32(fine, self.decim2).reshape(-1))

    @staticmethod
    def _carried(state: PfbXlatBankState, ps: PfbState, xb: torch.Tensor,
                 rows: torch.Tensor, hist: torch.Tensor,
                 phase0: torch.Tensor, step: torch.Tensor,
                 n: int) -> PfbXlatBankState:
        """The state after ``state``'s step of N outputs: the PFB's ``ps``,
        each slot's fine history (``row_history``) and phase."""
        s, c = state.fine.phase.shape
        return PfbXlatBankState(pfb=ps, fine=XlatState(
            history=row_history(hist, xb, rows).view(s, c, -1),
            phase=((phase0 + step * n) & U32_MASK).view(s, c)))

    def __call__(self, state: PfbXlatBankState, x: torch.Tensor,
                 offsets_norm: torch.Tensor
                 ) -> tuple[PfbXlatBankState, torch.Tensor]:
        """x [S, T] complex64 (or an [S, T, 2] wire block), T % decim ==
        0; offsets_norm [S, C] cycles/input sample → channels [S, C,
        T//decim] complex64. On the card, ``call_planes``' planes packed
        into complex channels (a copy, off the step's path)."""
        if x.device.type != "cpu":
            state, y_re, y_im = self.call_planes(state, x, offsets_norm)
            return state, torch.complex(y_re, y_im).transpose(1, 2
                                                              ).contiguous()
        ps, xb, rows, hist, fine, phase0, step = self.fine_operands(
            state, x, offsets_norm)
        # the JAX form, the parity reference
        y = bank_complex(xb[rows], hist,
                         modulated_taps(self.device_taps(xb.device),
                                        fine[:, None]),
                         phase0[:, None], step[:, None], self.decim2)
        s, c = state.fine.phase.shape
        n = y.shape[-1]
        return (self._carried(state, ps, xb, rows, hist, phase0, step, n),
                y.view(s, c, n))

    def call_planes(self, state: PfbXlatBankState, x: torch.Tensor,
                    offsets_norm: torch.Tensor
                    ) -> tuple[PfbXlatBankState, torch.Tensor, torch.Tensor]:
        """``__call__`` with the channels as time-major float32 planes
        y_re, y_im [S, T//decim, C], the layout the trackers read: on the
        card ``pfb_fine``'s own output, on the CPU ``planes()`` of the JAX
        form's channels."""
        if x.device.type == "cpu":
            state, y = self(state, x, offsets_norm)
            return (state, *planes(y))
        ps, xb, rows, hist, fine, phase0, step = self.fine_operands(
            state, x, offsets_norm)
        y_re, y_im = pfb_fine(xb, rows, hist, self.device_taps(xb.device),
                              fine, phase0, step, self.decim2,
                              state.fine.phase.shape[1])
        return (self._carried(state, ps, xb, rows, hist, phase0, step,
                              y_re.shape[1]), y_re, y_im)
