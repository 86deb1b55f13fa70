"""Streaming state between the JAX package and the port.

The JAX pipelines keep their state wire-encoded (its ``utils/wire.py``):
complex values as trailing ``[..., 2]`` float32, uint32 values as int32
bits. These functions map that layout, taken as numpy arrays in the JAX
NamedTuples (or any objects with the same field names), to the port's
state and back, for ``ControlPipeline``, ``CqpskControlPipeline``,
``AnalogVoicePipeline`` and ``SpectrumSplit2`` (whose state is the bank's
``XlatBankState``), with any of the three banks (``XlatBankState``,
``PfbXlatBankState`` with its ``PfbState`` and per-slot ``XlatState``,
``FftXlatBankState``). The state has a leading source axis ``S`` on both
sides (the JAX grouped, vmapped form: a runtime group's stacked state).

The scan and NBFM states (``SpectrumState``, ``FirState``, ``NbfmState``)
are held in native dtypes on both sides, complex as complex64: the
``*_state_from_jax`` / ``native_state_to_jax`` pair maps them.
"""

from __future__ import annotations

import numpy as np
import torch

from radiocapture_tpu_torch.demod.cqpsk import CqpskState
from radiocapture_tpu_torch.ops.fir import U32_MASK, fir_init
from radiocapture_tpu_torch.ops.fm import nbfm_init


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


def _first_leaf(tree):
    while not hasattr(tree, "shape"):
        tree = tree[0]
    return tree


def _from_spec(spec, arrays, device):
    """The JAX wire arrays as the tensors of ``spec`` (a state of the
    port's built on the meta device: its NamedTuple layout, each leaf's
    dtype and shape): complex64 from [..., 2] float32, uint32 held in
    int64 from int32 bits, float32 as is."""
    if isinstance(spec, torch.Tensor):
        conv = {torch.complex64: _complex, torch.int64: _u32}.get(
            spec.dtype, _f32)
        t = conv(arrays, device)
        if t.shape != spec.shape:
            raise ValueError(f"JAX state does not match the pipeline: "
                             f"{tuple(t.shape)}, want {tuple(spec.shape)}")
        return t
    return type(spec)(*(_from_spec(leaf, getattr(arrays, name), device)
                        for name, leaf in zip(spec._fields, spec)))


def _to_wire(state):
    """The port's state → numpy in the JAX wire encoding, leaf by leaf."""
    if isinstance(state, torch.Tensor):
        if state.is_complex():
            return _np_complex(state)
        if state.dtype == torch.int64:
            return ((state.detach().cpu().numpy() & U32_MASK)
                    .astype(np.uint32).view(np.int32))
        return _np(state)
    return type(state)(*(_to_wire(leaf) for leaf in state))


def _shapes(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tuple(tree.shape)]
    return [sh for leaf in tree for sh in _shapes(leaf)]


def cqpsk_state_from_jax(arrays, device) -> CqpskState:
    """JAX ``CqpskState`` (all float32, numpy leaves) → the port's."""
    return CqpskState(*(_f32(getattr(arrays, f), device)
                        for f in CqpskState._fields))


def cqpsk_state_to_jax(state: CqpskState) -> CqpskState:
    return CqpskState(*(_np(t) for t in state))


def state_from_jax(pipe, arrays, device):
    """JAX wire-encoded pipeline state (numpy leaves, leading source
    axis) → the port's state of ``pipe`` on ``device``, checked leaf by
    leaf against the pipeline's own layout for that many sources."""
    spec = pipe.init(_first_leaf(arrays).shape[0], "meta")
    return _from_spec(spec, arrays, device)


def state_to_jax(pipe, state):
    """Inverse of :func:`state_from_jax`: the port's state → numpy arrays
    in the JAX wire encoding, in the port's NamedTuples (same field
    names and order as the JAX ones, so ``JaxCls(*fields)`` rebuilds
    them)."""
    spec = pipe.init(_first_leaf(state).shape[0], "meta")
    if _shapes(spec) != _shapes(state):
        raise ValueError("state does not match the pipeline: "
                         f"{_shapes(state)}, want {_shapes(spec)}")
    return _to_wire(state)


def _native_from(spec, arrays, device):
    """The JAX arrays of a native-dtype state as the tensors of ``spec``
    (the port's state built on the meta device), shapes checked."""
    if isinstance(spec, torch.Tensor):
        want = np.complex64 if spec.is_complex() else np.float32
        t = torch.from_numpy(np.array(arrays, want)).to(device)
        if t.shape != spec.shape:
            raise ValueError(f"JAX state does not match: "
                             f"{tuple(t.shape)}, want {tuple(spec.shape)}")
        return t
    return type(spec)(*(_native_from(leaf, getattr(arrays, name), device)
                        for name, leaf in zip(spec._fields, spec)))


def native_state_to_jax(state):
    """A scan or NBFM state of the port's → numpy leaves in its
    NamedTuples (complex64 / float32, the JAX NamedTuples' field names and
    order, so ``JaxCls(*fields)`` rebuilds them)."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().resolve_conj().numpy()
    return type(state)(*(native_state_to_jax(leaf) for leaf in state))


def spectrum_state_from_jax(scanner, arrays, device):
    """JAX ``SpectrumState`` (acc [fft_len], count []) → the port's, for
    ``scanner`` (a ``scan.spectrum.SpectrumScanner``)."""
    return _native_from(scanner.init("meta"), arrays, device)


def fir_state_from_jax(taps, arrays, device):
    """JAX ``FirState`` → the port's; the history keeps its stream's
    dtype (complex64 or float32)."""
    dtype = (torch.complex64 if np.iscomplexobj(arrays.history)
             else torch.float32)
    return _native_from(fir_init(taps, dtype, "meta"), arrays, device)


def nbfm_state_from_jax(audio_taps, arrays, device):
    """JAX ``NbfmState`` (quad, deemph, audio_fir) → the port's."""
    return _native_from(nbfm_init(audio_taps, "meta"), arrays, device)
