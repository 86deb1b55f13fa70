"""The pfb fine stage reading its bins in place: ``PfbChannelizer.bins``
(the channels bin-major) and ``row_history``, on the CPU.

- ``PfbXlatBank`` against the JAX ``PfbXlatBank`` (its fine stage the
  CPU conv, as ``test_torch_frontends.py`` runs it) over three steps,
  through the routing cases the gathered block used to hide: a slot
  retuned to another bin between steps, negative offsets wrapping to bin
  M-1, every slot of a source on one bin, two sources on different bins
  and a block shorter than K2-1 bin samples;
- the bin-major bins equal to ``rows``' time-major channels transposed,
  exactly;
- ``row_history`` equal to ``complex_history`` on the gathered rows,
  exactly."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from radiocapture_tpu.ops import channelizer as JC
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.ops import channelizer as TC
from test_torch_frontends import PFB_BANK_ATOL

torch.set_num_threads(1)   # six test workers share the machine

FS = 2.4e6
HIST_ATOL = 1e-6   # the carried fine history: PFB bins, float32 sum order


def _cnormal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t).contiguous().view(torch.int32)


def test_pfb_xlat_bank_routing_matches_jax():
    """Two sources × four slots, blocks of 1024, 256 (< K2-1 = 466) and
    1024 bin samples: source 0's slots on bins 5, 5 (−410 and −395 kHz,
    wrapped from −1), 0 and 2, source 1's all on bin 1. Before the last
    block source 0's slot 2 moves from bin 0 to bin 2 and source 1's
    slot 0 from bin 1 to bin 4 (−790 kHz); each keeps its own fine
    history, as JAX's vmapped state does. The port's channels within
    PFB_BANK_ATOL of JAX's each step, the routing JAX's, the phase equal
    and the fine history within HIST_ATOL."""
    jb, tb = JC.PfbXlatBank(4, FS, 12500.0), TC.PfbXlatBank(4, FS, 12500.0)
    offs = (np.array([[-410e3, -395e3, 12.5e3, 790e3],
                      [400e3, 390e3, 410e3, 450e3]]) / FS).astype(np.float32)
    later = offs.copy()
    later[0, 2], later[1, 0] = 805e3 / FS, -790e3 / FS
    bins = tb.route(torch.from_numpy(offs))[0]
    assert bins.tolist() == [[5, 5, 0, 2], [1, 1, 1, 1]]
    assert tb.route(torch.from_numpy(later))[0].tolist() == [[5, 5, 2, 2],
                                                             [4, 1, 1, 1]]
    rng = np.random.default_rng(18)
    jstep = jax.jit(jax.vmap(jb.__call__))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                       jb.init())
    tst = tb.init(2, "cpu")
    for b, n_bin in enumerate((1024, 256, 1024)):
        o = later if b == 2 else offs
        xb = _cnormal(rng, (2, n_bin * tb.m))
        jst, jy = jstep(jst, jnp.asarray(xb), jnp.asarray(o))
        tst, ty = tb(tst, torch.from_numpy(xb), torch.from_numpy(o))
        assert ty.shape == (2, 4, n_bin // tb.decim2)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=PFB_BANK_ATOL)
        np.testing.assert_array_equal(
            tst.fine.phase.numpy().astype(np.uint32),
            np.asarray(jst.fine.phase))
        np.testing.assert_allclose(tst.fine.history.numpy(),
                                   np.asarray(jst.fine.history),
                                   atol=HIST_ATOL)
    np.testing.assert_array_equal(tst.pfb.history.numpy(),
                                  np.asarray(jst.pfb.history))


@pytest.mark.parametrize("fs,m,atten,wire", [
    (FS, 6, 80.0, "bf16"), (FS, 6, 80.0, "float32"),
    (800e3, 8, 60.0, "complex64"), (1.6e6, 16, 60.0, "float32")])
def test_bins_are_rows_transposed(fs, m, atten, wire):
    """``PfbChannelizer.bins`` is ``rows``' time-major channels
    transposed, every value bit for bit, contiguous [S, M, T/M] (M = 8
    and 16 are where the CPU's vectorized and strided complex multiplies
    round apart), with the same new history; ``__call__`` returns it."""
    pfb = TC.PfbChannelizer.for_rates(fs, m, atten_db=atten)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((3, m * 700, 2)).astype(np.float32)
    if wire == "bf16":
        x = wire_from_numpy(x.astype(ml_dtypes.bfloat16), "cpu")
    elif wire == "complex64":
        x = torch.view_as_complex(torch.from_numpy(x))
    else:
        x = torch.from_numpy(x)
    st = pfb.init(3, "cpu")._replace(history=torch.from_numpy(
        _cnormal(rng, (3, (pfb.p - 1) * m))))
    st_r, yr = pfb.rows(st, x)
    st_b, yb = pfb.bins(st, x)
    assert yb.shape == (3, m, 700) and yb.is_contiguous()
    assert torch.equal(_bits(yb), _bits(yr.transpose(1, 2)))
    assert torch.equal(_bits(st_b.history), _bits(st_r.history))
    assert torch.equal(_bits(pfb(st, x)[1]), _bits(yb))


def _fine_rows(rng, r, t, k, wire, rows):
    x = rng.standard_normal((r, t, 2)).astype(np.float32)
    x = (wire_from_numpy(x.astype(ml_dtypes.bfloat16), "cpu")
         if wire == "bf16" else torch.from_numpy(x))
    return (x, torch.from_numpy(_cnormal(rng, (len(rows), k - 1))),
            torch.as_tensor(rows, dtype=torch.int64))


@pytest.mark.parametrize("t,wire,rows", [
    (4000, "float32", [3, 0, 0, 5, 2, 5, 1]),
    (160, "float32", [1, 1, 1]),
    (480, "bf16", [2, 0, 1, 2])])
def test_row_history_is_the_gather(t, wire, rows):
    """``row_history`` equals ``complex_history`` on the gathered rows,
    bit for bit: permuted and repeated rows, a block longer than K2-1 =
    466, one shorter (the old history's samples in front) and a bf16
    one."""
    bank = TC.PfbXlatBank(len(rows), FS, 12500.0)
    k = bank.ntaps2
    rng = np.random.default_rng(t)
    x, hist, idx = _fine_rows(rng, 6, t, k, wire, rows)
    new = TC.row_history(hist, x, idx)
    assert new.shape == (len(rows), k - 1)
    assert torch.equal(_bits(new),
                       _bits(TC.complex_history(hist, x[idx])))
