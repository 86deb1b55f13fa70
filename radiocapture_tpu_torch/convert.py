"""Streaming state between the JAX package and the port.

The JAX pipelines keep their state wire-encoded (its ``utils/wire.py``):
complex values as trailing ``[..., 2]`` float32, uint32 values as int32
bits. These functions map that layout, taken as numpy arrays in the JAX
NamedTuples (or any objects with the same field names), to the port's
state and back, for ``ControlPipeline``, ``CqpskControlPipeline`` and
``SpectrumSplit2`` (whose state is the bank's ``XlatBankState``). The
state has a leading source axis ``S`` on both sides (the JAX grouped,
vmapped form).
"""

from __future__ import annotations

import numpy as np
import torch

from radiocapture_tpu_torch.demod.cqpsk import CqpskState
from radiocapture_tpu_torch.demod.fsk4 import Fsk4State
from radiocapture_tpu_torch.frontend.pipeline import (CqpskControlPipeline,
                                                      CqpskPipelineState,
                                                      ControlPipelineState,
                                                      SpectrumSplit2)
from radiocapture_tpu_torch.ops.channelizer import XlatBank, XlatBankState
from radiocapture_tpu_torch.ops.fir import U32_MASK
from radiocapture_tpu_torch.ops.fm import QuadDemodState


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _complex(a, device) -> torch.Tensor:
    return torch.view_as_complex(_f32(a, device).contiguous())


def _u32(a, device) -> torch.Tensor:
    bits = np.asarray(a).astype(np.int32).view(np.uint32)
    return torch.from_numpy(bits.astype(np.int64)).to(device)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _np_complex(t) -> np.ndarray:
    return _np(torch.view_as_real(t.detach().cpu().resolve_conj()))


def _bank_from_jax(bank: XlatBank, arrays, device) -> XlatBankState:
    st = XlatBankState(history=_complex(arrays.history, device),
                       phase=_u32(arrays.phase, device))
    s, c = st.phase.shape
    if c != bank.num_slots or tuple(st.history.shape) != (s, bank.ntaps - 1):
        raise ValueError("JAX state does not match the pipeline: phase "
                         f"{tuple(st.phase.shape)}, history "
                         f"{tuple(st.history.shape)}")
    return st


def _bank_to_jax(bank: XlatBank, state: XlatBankState) -> XlatBankState:
    if state.phase.shape[-1] != bank.num_slots:
        raise ValueError("state does not match the pipeline's slot count")
    phase = ((state.phase.detach().cpu().numpy() & U32_MASK)
             .astype(np.uint32).view(np.int32))
    return XlatBankState(history=_np_complex(state.history), phase=phase)


def cqpsk_state_from_jax(arrays, device) -> CqpskState:
    """JAX ``CqpskState`` (all float32, numpy leaves) → the port's."""
    return CqpskState(*(_f32(getattr(arrays, f), device)
                        for f in CqpskState._fields))


def cqpsk_state_to_jax(state: CqpskState) -> CqpskState:
    return CqpskState(*(_np(t) for t in state))


def state_from_jax(pipe, arrays, device):
    """JAX wire-encoded pipeline state (numpy leaves, leading source
    axis) → the port's state of ``pipe`` on ``device``."""
    if isinstance(pipe, SpectrumSplit2):
        return _bank_from_jax(pipe.bank, arrays, device)
    bank = _bank_from_jax(pipe.bank, arrays.bank, device)
    if isinstance(pipe, CqpskControlPipeline):
        return CqpskPipelineState(
            bank=bank, cqpsk=cqpsk_state_from_jax(arrays.cqpsk, device))
    return ControlPipelineState(
        bank=bank,
        quad=QuadDemodState(prev=_complex(arrays.quad.prev, device)),
        sym_hist=_f32(arrays.sym_hist, device),
        fsk4=Fsk4State(clock=_f32(arrays.fsk4.clock, device),
                       fine_freq=_f32(arrays.fsk4.fine_freq, device),
                       hist=_f32(arrays.fsk4.hist, device)))


def state_to_jax(pipe, state):
    """Inverse of :func:`state_from_jax`: the port's state → numpy arrays
    in the JAX wire encoding, in the port's NamedTuples (same field
    names and order as the JAX ones, so ``JaxCls(*fields)`` rebuilds
    them)."""
    if isinstance(pipe, SpectrumSplit2):
        return _bank_to_jax(pipe.bank, state)
    bank = _bank_to_jax(pipe.bank, state.bank)
    if isinstance(pipe, CqpskControlPipeline):
        return CqpskPipelineState(bank=bank,
                                  cqpsk=cqpsk_state_to_jax(state.cqpsk))
    return ControlPipelineState(
        bank=bank,
        quad=QuadDemodState(prev=_np_complex(state.quad.prev)),
        sym_hist=_np(state.sym_hist),
        fsk4=Fsk4State(clock=_np(state.fsk4.clock),
                       fine_freq=_np(state.fsk4.fine_freq),
                       hist=_np(state.fsk4.hist)))
