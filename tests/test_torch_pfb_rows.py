"""Port parity of the pfb frontend's coarse polyphase combiner
(``ops/pfb_kernel.py``, kernel ``csrc/pfb_rows.cu``):

- ``pfb_rows_plain`` and ``PfbChannelizer.rows`` on bf16 and float32 wire
  blocks give bit for bit what the eager ``rows`` gave before the kernel
  on the same samples as complex64;
- the port's ``PfbChannelizer`` at the pfb mode's own bank (2.4 MS/s,
  80 dB: M = 6, P = 24) within PFB_REL of the JAX ``PfbChannelizer`` over
  a full block and a run of blocks shorter than (P-1)·M, the history
  carried exactly;
- the CUDA entry's validation, which refuses what the kernel does not take
  before any launch.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.ops import channelizer as JC
from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.channelizer import PfbChannelizer, PfbState

torch.set_num_threads(1)   # six test workers share the machine

PFB_REL = 1e-4     # test_torch_frontends.py: × max|y| (float32, sum order)
FS, M = 2.4e6, 6   # PfbXlatBank(…, 2.4e6, …).pfb: 400 kHz bins, 80 dB
CSRC = Path(pk.__file__).resolve().parents[1] / "csrc"


def _cnormal(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _bits(t):
    return torch.view_as_real(t).view(torch.int32)


def _rows_before(pfb, state, x):
    """``PfbChannelizer.rows`` as the port ran it before the kernel, on an
    [S, T] complex block."""
    m, p = pfb.num_channels, pfb.p
    s, t = x.shape
    n = t // m
    z = torch.cat([state.history, x.to(torch.complex64)], dim=1)
    zr = torch.view_as_real(z).view(s, n + p - 1, m, 2)
    hp2 = torch.as_tensor(pfb.hp2)[..., None]
    acc = zr[:, p - 1:p - 1 + n] * hp2[:, 0]
    for q in range(1, p):
        acc.addcmul_(zr[:, p - 1 - q:p - 1 - q + n], hp2[:, q])
    v = torch.view_as_complex(acc.contiguous()).flip(-1)
    y = torch.fft.ifft(v, dim=-1, norm="forward") * torch.as_tensor(pfb.rot)
    return PfbState(history=z[:, z.shape[1] - (p - 1) * m:].contiguous()), y


def _wire(x, dtype):
    """[S, T] complex64 → the [S, T, 2] wire block in ``dtype`` and its
    samples as complex64 (bf16 → float32 is exact)."""
    w = torch.view_as_real(torch.from_numpy(x)).to(dtype).contiguous()
    return w, torch.view_as_complex(w.float())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [M * 400, 60])
def test_plain_on_wire_is_rows_before(dtype, t):
    """A wire block (a full one, and one shorter than (P-1)·M) through
    ``pfb_rows_plain``, the CPU wrapper and ``PfbChannelizer.rows`` gives
    the rows, channels and history the eager ``rows`` gave on the same
    samples as complex64, bit for bit; so does a complex64 block."""
    rng = np.random.default_rng(t + (dtype == torch.bfloat16))
    pfb = PfbChannelizer.for_rates(FS, M, atten_db=80.0)
    assert (pfb.num_channels, pfb.p) == (M, 24)
    state = PfbState(history=torch.from_numpy(
        _cnormal(rng, (3, (pfb.p - 1) * M))))
    w, xc = _wire(_cnormal(rng, (3, t)), dtype)
    want_state, want_y = _rows_before(pfb, state, xc)
    hp2 = pfb.device_hp2("cpu")
    v, hist = pk.pfb_rows_plain(state.history, w, hp2)
    v2, hist2 = pk.pfb_rows(state.history, w, hp2)
    assert v.shape == (3, t // M, M)
    assert torch.equal(_bits(v), _bits(v2))
    assert torch.equal(_bits(hist), _bits(want_state.history))
    assert torch.equal(_bits(hist2), _bits(want_state.history))
    for x in (w, xc):
        got_state, got_y = pfb.rows(state, x)
        assert torch.equal(_bits(got_y), _bits(want_y))
        assert torch.equal(_bits(got_state.history),
                           _bits(want_state.history))


@pytest.mark.parametrize("wire", ["complex64", "float32", "bfloat16"])
def test_pfb_80db_matches_jax_over_short_blocks(wire):
    """Two sources through the pfb mode's own bank: a full block, then
    blocks of 60, 6 and 132 samples (each shorter than (P-1)·M = 138, so
    the new history spans the old one and the block) and a longer one.
    Every block's channels within PFB_REL·max|y| of the JAX
    ``PfbChannelizer``'s (one source at a time), the history equal to
    JAX's after every block."""
    rng = np.random.default_rng(17)
    jp = JC.PfbChannelizer.for_rates(FS, M, atten_db=80.0)
    tp = PfbChannelizer.for_rates(FS, M, atten_db=80.0)
    assert (tp.p, tp.ntaps) == (jp.p, jp.ntaps) == (24, 144)
    np.testing.assert_array_equal(tp.hp2, jp.hp2)
    x = _cnormal(rng, (2, 3600))
    if wire == "bfloat16":       # JAX takes the rounded samples
        x = _wire(x, torch.bfloat16)[1].numpy()
    jst = [jp.init() for _ in range(2)]
    st = tp.init(2, "cpu")
    lo = 0
    for size in (2400, 60, 6, 132, 1002):
        blk = x[:, lo:lo + size]
        lo += size
        want = []
        for s in range(2):
            jst[s], y = jp(jst[s], jnp.asarray(blk[s]))
            want.append(np.asarray(y))
        want = np.stack(want)
        xb = (torch.from_numpy(blk) if wire == "complex64" else
              _wire(blk, getattr(torch, wire))[0])
        st, y = tp(st, xb)
        assert y.shape == (2, M, size // M)
        np.testing.assert_allclose(y.numpy(), want,
                                   atol=PFB_REL * np.abs(want).max())
        np.testing.assert_array_equal(
            st.history.numpy(), np.stack([np.asarray(j.history)
                                          for j in jst]))
    assert lo == x.shape[1]


def _operands(**bad):
    """Valid CPU inputs of the kernel entry (2 sources, M = 3, P = 4,
    a 12-sample bf16 block), with the named ones replaced."""
    s, m, p = 2, 3, 4
    ops = dict(history=torch.zeros((s, (p - 1) * m), dtype=torch.complex64),
               x=torch.zeros((s, 12, 2), dtype=torch.bfloat16),
               hp2=torch.zeros((m, p)))
    ops.update(bad)
    return ops


@pytest.mark.parametrize("bad,match", [
    ({"x": torch.zeros((2, 12, 2), dtype=torch.float16)}, "x must be"),
    ({"x": torch.zeros((2, 12), dtype=torch.complex128)}, "x must be"),
    ({"x": torch.zeros((2, 2, 12)).transpose(1, 2)}, "x must be"),
    ({"x": torch.zeros((2, 24), dtype=torch.complex64)[:, ::2]},
     "x must be"),
    ({"x": torch.zeros((2, 12, 3))}, "x must be"),
    ({"x": torch.zeros(2 * 12 * 2 + 1)[1:].view(2, 12, 2)}, "x must be"),
    ({"x": torch.zeros((2, 13, 2))}, "not a multiple of M=3"),
    ({"hp2": torch.zeros((3, 4), dtype=torch.float64)}, "hp2 must be"),
    ({"hp2": torch.zeros(12)}, "hp2 must be"),
    ({"hp2": torch.zeros((4, 3)).T}, "hp2 must be"),
    ({"history": torch.zeros((2, 9), dtype=torch.complex128)},
     "history must be"),
    ({"history": torch.zeros((2, 8), dtype=torch.complex64)},
     "history must be"),
    ({"history": torch.zeros((3, 9), dtype=torch.complex64)},
     "history must be"),
    ({"history": torch.zeros((2, 18), dtype=torch.complex64)[:, ::2]},
     "history must be"),
    ({}, "takes CUDA tensors"),
    ({"x": torch.zeros((2, 12, 2))}, "takes CUDA tensors"),
    ({"x": torch.zeros((2, 12), dtype=torch.complex64)},
     "takes CUDA tensors")])
def test_pfb_rows_entry_refuses(bad, match):
    """The kernel's entry validates before any launch: another dtype,
    shape or layout, a misaligned block or T % M ≠ 0 raises, and so do CPU
    tensors (the wrapper sends those to the plain version; the kernel
    never gets them)."""
    ops = _operands(**bad)
    with pytest.raises(ValueError, match=match):
        pk.pfb_rows_args(ops["history"], ops["x"], ops["hp2"])


def test_pfb_rows_refuses_other_devices():
    """A tensor on neither the CPU nor a card is refused, never computed
    by the plain version."""
    ops = {k: v.to("meta") for k, v in _operands().items()}
    with pytest.raises(ValueError, match="takes CUDA tensors, got meta"):
        pk.pfb_rows(ops["history"], ops["x"], ops["hp2"])


def test_entry_signature_matches_the_source():
    """The ctypes signature has one argument per parameter of the C entry
    point."""
    text = (CSRC / "pfb_rows.cu").read_text()
    params = re.search(r'extern "C" int pfb_rows_launch\(([^)]*)\)',
                       text).group(1)
    assert len(params.split(",")) == len(kernels._SIGNATURES[
        "pfb_rows_launch"])
