"""Batched capture pipelines: wideband blocks of S sources → per-slot
symbol streams (port of ``radiocapture_tpu.frontend.pipeline``).

    ControlPipeline:       bank  →  fused tracker (demod.track_kernel:
      discriminator → boxcar → fsk4 → slicer)
    CqpskControlPipeline:  bank  →  AGC gain  →  fused CQPSK tracker
      (demod.cqpsk_kernel: NCO → Gardner → diff phase → ×4 AFC → slicer)
    AnalogVoicePipeline:   bank  →  fused voice tracker
      (ops.fm_kernel: discriminator → 75 µs de-emphasis → power)
    SpectrumSplit2:        one 2-slot complex bank per physical source
      (``receiver_split2``): two half-rate logical sources

The bank is the config's ``frontend_mode`` (``_make_bank``): 'xlat' the
wire bank on the bf16/float32 wire block (ops.channelizer_kernel), 'pfb'
the coarse PFB then the per-slot fine filters on the complex bank kernel
(``PfbXlatBank``), 'fft' the overlap-save FFT bank (``FftXlatBank``); the
last two take the block as complex64.

One ``ControlPipeline`` is specialized to one air-interface class
(symbol rate + decision alphabet): P25 C4FM 4800 Bd 4-level, EDACS
9600 Bd binary, Motorola 3600 Bd binary, or the 6000 Bd C4FM-TDMA
variant through the generic constructor; ``CqpskControlPipeline`` to P25
LSM at 4800 Bd or its 6000 Bd Phase 2 TDMA variant. Slot frequencies are
runtime data. The JAX package vmaps sources; here every tensor leads
with the source axis ``S``.

On CUDA the step updates the streaming state in place (the trackers'
lane state is written back by the kernel); on CPU it builds new tensors.
Either way, use the state the step returns.

Each step is a request to the tracer (``utils/trace.py``): the root span
``pipeline.step`` (``split2.step`` for the split), inside it
``channelize`` around the bank and ``demod`` around the tracker, inside
those the hand kernels' ``kernel.<name>``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from radiocapture_tpu_torch.demod import cqpsk as _cqpsk
from radiocapture_tpu_torch.demod import fsk4 as _fsk4
from radiocapture_tpu_torch.demod.cqpsk_kernel import (agc_scale_kernel,
                                                      track_cqpsk)
from radiocapture_tpu_torch.demod.track_kernel import (TrackParams, track,
                                                      track_plain)
from radiocapture_tpu_torch.ops import taps as _taps
from radiocapture_tpu_torch.ops import fm as _fm
from radiocapture_tpu_torch.ops.channelizer import (PfbXlatBank, XlatBank,
                                                    XlatBankState)
from radiocapture_tpu_torch.ops.fft_bank import FftXlatBank
from radiocapture_tpu_torch.ops.fir import batched_fir, phase_step_u32
from radiocapture_tpu_torch.ops.fm_kernel import voice_track
from radiocapture_tpu_torch.utils import trace


def _make_bank(frontend: str, num_slots: int, samp_rate: float,
               channel_rate: float):
    """The channel-extraction stage of the config's ``frontend_mode``
    (rc_frontend/receiver.py:242: 'xlat' per-channel filters, 'pfb' coarse
    polyphase bins + fine xlat; 'fft' the overlap-save form of xlat, the
    same filter), as the JAX ``_make_bank`` (pipeline.py:57-71). The
    filter design's host seconds count in ``setup.design_s``."""
    with trace.timed("setup.design_s"):
        if frontend == "pfb":
            return PfbXlatBank(num_slots, samp_rate, channel_rate)
        if frontend == "xlat":
            return XlatBank.for_rates(num_slots, samp_rate, channel_rate)
        if frontend == "fft":
            return FftXlatBank.for_rates(num_slots, samp_rate, channel_rate)
    raise ValueError(f"unknown frontend_mode {frontend!r}")


def _block_multiple(bank) -> int:
    return int(getattr(bank, "block_multiple", bank.decim))


def _check_block(x: torch.Tensor, multiple: int) -> None:
    if x.shape[1] % multiple:
        raise ValueError(f"block length {x.shape[1]} is not a multiple "
                         f"of {multiple}")


def _offsets_for(freqs_hz: np.ndarray, center_hz: float,
                 samp_rate: float) -> np.ndarray:
    return ((np.asarray(freqs_hz, np.float64) - center_hz)
            / samp_rate).astype(np.float32)


class ControlPipelineState(NamedTuple):
    bank: tuple     # XlatBankState, PfbXlatBankState or FftXlatBankState
    quad: _fm.QuadDemodState         # prev: [S, C] complex64
    sym_hist: torch.Tensor           # [S, C, sym_ntaps-1] float32
    fsk4: _fsk4.Fsk4State            # batch (S, C)


class ControlPipeline:
    """Wideband blocks [S, T] → per-slot (symbols, valid, dibits)."""

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float = 12500.0,
                 symbol_rate: float = 4800.0,
                 levels: tuple = (-3.0, -1.0, 1.0, 3.0),
                 deviation_hz: float = 600.0,
                 frontend: str = "xlat"):
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.channel_rate = float(channel_rate)
        self.symbol_rate = float(symbol_rate)
        self.levels = tuple(levels)
        self.deviation_hz = float(deviation_hz)
        self.bank = _make_bank(frontend, num_slots, samp_rate, channel_rate)
        self.channel_fs = self.samp_rate / self.bank.decim
        # ±deviation ↦ the outer slicer levels
        self.disc_gain = (self.channel_fs
                          / (2.0 * math.pi * float(deviation_hz)))
        self.sym_taps = _fsk4.boxcar_taps(self.channel_fs, self.symbol_rate)
        # track at half rate when ≥ 2.2 samples/symbol survive (P25 at
        # 12.5 kS/s; EDACS stays at 25 kS/s): the tracker is a serial
        # per-sample loop, so its cost follows the tracked rate.
        self.sym_decim = 2 if (self.channel_fs / 2.0
                               >= 2.2 * self.symbol_rate) else 1
        self.track_fs = self.channel_fs / self.sym_decim
        self.track_params = TrackParams(
            gain=self.disc_gain, sym_taps=self.sym_taps,
            sym_decim=self.sym_decim, track_fs=self.track_fs,
            symbol_rate=self.symbol_rate, levels=self.levels)
        # > 1: track with fsk4_demod_block, the loop feedback held within
        # chunks of this many samples (plain torch on either device, no
        # kernel); 0/1: the exact per-sample loop of the tracker kernel
        self.fsk4_block = 0

    @classmethod
    def p25_c4fm(cls, num_slots: int, samp_rate: float,
                 frontend: str = "xlat") -> "ControlPipeline":
        return cls(num_slots, samp_rate, 12500.0, 4800.0,
                   (-3.0, -1.0, 1.0, 3.0), 600.0, frontend=frontend)

    @classmethod
    def edacs(cls, num_slots: int, samp_rate: float,
              frontend: str = "xlat") -> "ControlPipeline":
        # 9600 Bd binary FSK, discriminator scaled so ±dev → ±1
        return cls(num_slots, samp_rate, 12500.0, 9600.0,
                   (-1.0, 1.0), 4000.0, frontend=frontend)

    @classmethod
    def moto(cls, num_slots: int, samp_rate: float,
             frontend: str = "xlat") -> "ControlPipeline":
        # 3600 Bd binary FSK
        return cls(num_slots, samp_rate, 12500.0, 3600.0,
                   (-1.0, 1.0), 4000.0, frontend=frontend)

    @property
    def decim(self) -> int:
        return self.bank.decim

    @property
    def block_multiple(self) -> int:
        """Input block length must be a multiple of this: the bank's own
        (the fft bank's window) and decim · sym_decim."""
        return int(np.lcm(_block_multiple(self.bank),
                          self.bank.decim * self.sym_decim))

    def init(self, n_sources: int, device) -> ControlPipelineState:
        """All-zero streaming state for ``n_sources`` sources."""
        sc = (n_sources, self.num_slots)
        return ControlPipelineState(
            bank=self.bank.init(n_sources, device),
            quad=_fm.quad_demod_init(sc, device),
            sym_hist=torch.zeros(sc + (len(self.sym_taps) - 1,),
                                 dtype=torch.float32, device=device),
            fsk4=_fsk4.fsk4_init(sc, device))

    def step(self, state: ControlPipelineState, x: torch.Tensor,
             offsets_norm: torch.Tensor):
        """One streaming step for S sources.

        x: [S, T, 2] bf16/float32 re/im wire block, or [S, T] complex64;
        T % block_multiple == 0. offsets_norm: [S, num_slots] float32,
        slot centre offset in cycles/input-sample (offset_hz / samp_rate).
        Returns (state, (symbols [S, C, M] f32, valid [S, C, M] int32 0/1,
        dibits [S, C, M] int32)) with M = T // (decim · sym_decim)."""
        with trace.span("pipeline.step", cuda=x.is_cuda):
            _check_block(x, self.block_multiple)
            with trace.span("channelize"):
                bs, y_re, y_im = self.bank.call_planes(state.bank, x,
                                                       offsets_norm)
            return self._track(state, bs, y_re, y_im)

    def step_debug(self, state: ControlPipelineState, x: torch.Tensor,
                   offsets_norm: torch.Tensor):
        """Like :meth:`step`, with a 4th output: the pre-scan track-rate
        stream [S, C, M] (channelized, discriminated, boxcar-filtered,
        before the fsk4 loop), as the JAX ``step_debug``
        (pipeline.py:235-242). The tracker kernel fuses the discriminator
        and the boxcar, so on the card that stream never exists: it is
        computed beside the step from the bank's planes by the plain ops
        (:meth:`prescan`), before the tracker updates the lane state in
        place. A debug and test surface; :meth:`step` is unchanged."""
        _check_block(x, self.block_multiple)
        bs, y_re, y_im = self.bank.call_planes(state.bank, x, offsets_norm)
        trk = self.prescan(torch.complex(y_re, y_im).transpose(1, 2),
                           state.quad, state.sym_hist)
        new_state, outs = self._track(state, bs, y_re, y_im)
        return new_state, outs + (trk,)

    def prescan(self, y: torch.Tensor, quad: _fm.QuadDemodState,
                sym_hist: torch.Tensor) -> torch.Tensor:
        """Channels y [S, C, N] complex64 → the track-rate stream
        [S, C, N // sym_decim]: discriminator, then the boxcar at stride
        ``sym_decim`` (the JAX ``_step_impl``, pipeline.py:198-201), in
        plain torch, the ops ``track_plain`` runs. The states are read,
        not updated."""
        _, disc = _fm.quadrature_demod(quad, y, self.disc_gain)
        _, filt = batched_fir(sym_hist, disc, self.sym_taps, self.sym_decim)
        return filt

    def _track(self, state: ControlPipelineState, bs, y_re: torch.Tensor,
               y_im: torch.Tensor):
        with trace.span("demod"):
            if self.fsk4_block > 1:
                quad, sym_hist, fsk4, syms, valid, dibits = track_plain(
                    y_re, y_im, state.quad, state.sym_hist, state.fsk4,
                    self.track_params, block=self.fsk4_block)
            else:
                quad, sym_hist, fsk4, syms, valid, dibits = track(
                    y_re, y_im, state.quad, state.sym_hist, state.fsk4,
                    self.track_params)
        new_state = ControlPipelineState(bank=bs, quad=quad,
                                         sym_hist=sym_hist, fsk4=fsk4)
        return new_state, (syms, valid, dibits)

    def offsets_for(self, freqs_hz: np.ndarray, center_hz: float
                    ) -> np.ndarray:
        """Per-slot ``offsets_norm`` for absolute channel frequencies."""
        return _offsets_for(freqs_hz, center_hz, self.samp_rate)

    def fine_freq_hz(self, state: ControlPipelineState) -> np.ndarray:
        """Per-slot tracked residual carrier offset in Hz (the tracker's
        ``fine_freq`` carry in deviation units, scaled back)."""
        return state.fsk4.fine_freq.detach().cpu().numpy() * self.deviation_hz

    def apply_freq_shift(self, state: ControlPipelineState,
                         delta_hz) -> ControlPipelineState:
        """Fold a source AFC retune of ``delta_hz`` (scalar, or broadcasting
        against the [S, C] carry, e.g. [S, 1]) into every slot's
        fine-frequency carry so the loop does not re-correct an offset the
        mixer bank already removed."""
        ff = state.fsk4.fine_freq
        delta = torch.as_tensor(
            np.asarray(delta_hz, np.float32) / np.float32(self.deviation_hz),
            device=ff.device)
        return state._replace(fsk4=state.fsk4._replace(fine_freq=ff + delta))


class CqpskPipelineState(NamedTuple):
    bank: tuple     # the bank's state, as ControlPipelineState.bank
    cqpsk: _cqpsk.CqpskState         # batch (S, C)


class CqpskControlPipeline:
    """Wideband blocks [S, T] → per-slot (symbols, valid, dibits) for
    P25 LSM (CQPSK) control and voice channels.

    The reference chain prefilter → feedforward AGC → gardner_costas →
    diff_phasor → complex_to_arg → ×1/(π/4) → slicer
    (p25_control_demod.py:136-168): here the bank, a per-block RMS gain
    per lane, and the fused tracker. Output dibits use the C4FM slicer
    levels [-2, 0, 2], so the frame layer is shared."""

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float = 12500.0,
                 symbol_rate: float = 4800.0,
                 frontend: str = "xlat"):
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.channel_rate = float(channel_rate)
        self.symbol_rate = float(symbol_rate)
        self.bank = _make_bank(frontend, num_slots, samp_rate, channel_rate)
        self.channel_fs = self.samp_rate / self.bank.decim
        # fails loudly above ~28 samples/symbol (cqpsk.HIST_C)
        _cqpsk.cqpsk_params(self.channel_fs, self.symbol_rate)

    @classmethod
    def p25_cqpsk(cls, num_slots: int, samp_rate: float, tdma: bool = False,
                  frontend: str = "xlat") -> "CqpskControlPipeline":
        # TDMA voice channels run 6000 Bd (logging_receiver.py:285-287)
        return cls(num_slots, samp_rate, 12500.0,
                   6000.0 if tdma else 4800.0, frontend=frontend)

    @property
    def decim(self) -> int:
        return self.bank.decim

    @property
    def block_multiple(self) -> int:
        """Input block length must be a multiple of this."""
        return _block_multiple(self.bank)

    def init(self, n_sources: int, device) -> CqpskPipelineState:
        """Start state for ``n_sources`` sources: not all-zero, omega
        starts at the nominal samples/symbol."""
        return CqpskPipelineState(
            bank=self.bank.init(n_sources, device),
            cqpsk=_cqpsk.cqpsk_init(self.channel_fs, self.symbol_rate,
                                    (n_sources, self.num_slots), device))

    def step(self, state: CqpskPipelineState, x: torch.Tensor,
             offsets_norm: torch.Tensor):
        """Same contract as :meth:`ControlPipeline.step`; here
        M = T // decim (one output per channel sample)."""
        with trace.span("pipeline.step", cuda=x.is_cuda):
            _check_block(x, self.block_multiple)
            with trace.span("channelize"):
                bs, y_re, y_im = self.bank.call_planes(state.bank, x,
                                                       offsets_norm)
            with trace.span("demod"):
                scale = agc_scale_kernel(y_re, y_im)             # [S, C]
                cs, syms, valid, dibits = track_cqpsk(
                    y_re, y_im, scale, state.cqpsk, self.channel_fs,
                    self.symbol_rate)
        return CqpskPipelineState(bank=bs, cqpsk=cs), (syms, valid, dibits)

    def offsets_for(self, freqs_hz: np.ndarray, center_hz: float
                    ) -> np.ndarray:
        return _offsets_for(freqs_hz, center_hz, self.samp_rate)


class VoicePipelineState(NamedTuple):
    bank: tuple     # the bank's state, as ControlPipelineState.bank
    quad: _fm.QuadDemodState         # prev: [S, C] complex64
    deemph: _fm.DeemphState          # y_last, x_last: [S, C] float32


class AnalogVoicePipeline:
    """Wideband blocks [S, T] → per-slot NBFM audio at the channel rate
    and a squelch power meter (the reference's per-call ``analog``
    flowgraph, logging_receiver.py:210-222). The resample to 8 kHz and
    the voice band-pass run per open call in the recorder
    (``audio/recorder.py::CallRecorder._to_8k``); squelch is applied
    there as a power mask."""

    def __init__(self, num_slots: int, samp_rate: float,
                 channel_rate: float = 12500.0, max_dev: float = 5000.0,
                 frontend: str = "xlat"):
        self.num_slots = num_slots
        self.samp_rate = float(samp_rate)
        self.bank = _make_bank(frontend, num_slots, samp_rate, channel_rate)
        self.channel_fs = self.samp_rate / self.bank.decim
        self.max_dev = float(max_dev)
        self.gain = self.channel_fs / (2.0 * math.pi * self.max_dev)

    @property
    def decim(self) -> int:
        return self.bank.decim

    @property
    def block_multiple(self) -> int:
        """Input block length must be a multiple of this."""
        return _block_multiple(self.bank)

    def init(self, n_sources: int, device) -> VoicePipelineState:
        """All-zero streaming state for ``n_sources`` sources."""
        sc = (n_sources, self.num_slots)
        return VoicePipelineState(bank=self.bank.init(n_sources, device),
                                  quad=_fm.quad_demod_init(sc, device),
                                  deemph=_fm.deemph_init(sc, device))

    def step(self, state: VoicePipelineState, x: torch.Tensor,
             offsets_norm: torch.Tensor):
        """x: [S, T, 2] wire block or [S, T] complex64, T %
        block_multiple == 0;
        offsets_norm [S, num_slots] → (state, (audio [S, C, T//decim]
        float32, power [S, C] float32 mean |chan|²))."""
        with trace.span("pipeline.step", cuda=x.is_cuda):
            _check_block(x, self.block_multiple)
            with trace.span("channelize"):
                bs, y_re, y_im = self.bank.call_planes(state.bank, x,
                                                       offsets_norm)
            with trace.span("demod"):
                quad, deemph, audio, power = voice_track(
                    y_re, y_im, state.quad, state.deemph, self.gain,
                    self.channel_fs)
        return (VoicePipelineState(bank=bs, quad=quad, deemph=deemph),
                (audio, power))


class SpectrumSplit2:
    """``receiver_split2`` mode: each wideband source → two half-rate
    sources centred at ∓fs/4 (reference rc_frontend/receiver.py:205-237,
    a pair of ``freq_xlating_fir_filter_ccc(decim=2, ±fs/4)``): one
    2-slot complex ``XlatBank`` step per block, in float32, through the
    complex bank kernel. Tap design as the reference:
    ``firdes.low_pass(1, fs, (fs/2)/2, 0.5·(fs/2)/2)``."""

    def __init__(self, samp_rate: float):
        self.samp_rate = float(samp_rate)
        channel_rate = (samp_rate / 2.0) / 2.0
        with trace.timed("setup.design_s"):
            taps = _taps.low_pass(1.0, samp_rate, channel_rate,
                                  0.5 * channel_rate)
            self.bank = XlatBank(2, 2, taps)
        # halves at centre - fs/4 (index 0) and centre + fs/4 (index 1),
        # the reference's newsource1/newsource2 ordering
        self.offsets = np.array([-0.25, 0.25], np.float32)
        # (device, S) -> the bank's taps [S, 2, K] and phase steps [S, 2]
        # for these fixed offsets, built once: a host→device copy per step
        # would synchronize the stream, and the taps never change
        self._ops: dict = {}

    def init(self, n_sources: int, device) -> XlatBankState:
        return self.bank.init(n_sources, device)

    def half_center(self, center_freq: float, idx: int) -> float:
        return center_freq + (idx * 2 - 1) * self.samp_rate / 4.0

    def step(self, state: XlatBankState, x: torch.Tensor):
        """x: [S, T] complex64, or an [S, T, 2] float32/bf16 wire block,
        read in place by the bank; T % 2 == 0 → (state, halves
        [S, 2, T//2, 2] float32 re/im)."""
        with trace.span("split2.step", cuda=x.is_cuda):
            key = (x.device, x.shape[0])
            if key not in self._ops:
                with trace.timed("setup.plans_s"):
                    offs = torch.as_tensor(
                        np.tile(self.offsets, (x.shape[0], 1)),
                        device=x.device)
                    self._ops[key] = (self.bank.modulated_taps(offs),
                                      phase_step_u32(offs, self.bank.decim))
            state, y = self.bank.call_taps(state, x, *self._ops[key])
            return state, torch.view_as_real(y)                # [S,2,T/2]


def split2_sources(halves: torch.Tensor) -> torch.Tensor:
    """[S, 2, N, 2] split2 halves → [2S, N, 2] logical wire sources,
    logical source ``2·phys + half`` (the numbering of the runtime's
    ``receiver_split2`` rewrite, runtime.py:293-314). A view."""
    s, two, n, _ = halves.shape
    return halves.reshape(s * two, n, 2)
