"""The pfb step's coarse PFB in one kernel: ``pfb_bins`` (``csrc/
pfb_rows.cu``'s second entry, ``ops/pfb_kernel.py``) folds the M-point
IDFT and the channel rotation into the combiner. On the CPU:

- ``pfb_bins_plain`` and ``PfbChannelizer.bins`` against the JAX
  ``PfbChannelizer`` at M = 6, 8, 16, 20 and 25 (the pfb mode's 80 dB
  banks at 2.4, 3.2, 6.4, 8 and 10 MS/s) on bf16, float32 and complex64
  blocks, within PFB_REL, the history exact; ``PfbXlatBank`` against
  JAX's at the live config's 8 and 10 MS/s sources (M = 20, 25);
- a numpy model of the kernel's epilogue (the folded table W, its sum
  order, one ``fmaf`` per step) on the plain sums, against
  ``pfb_bins_plain`` within ``BINS_REL`` (the card's bound) and JAX
  within PFB_REL;
- ``bins_table`` against e^{2jπ((c·m) mod M)/M}·rot[c] in float64;
- the kernel's plan emulated (the launcher's rounds of warps over the
  branches, the sums written back over their planes after each round's
  barrier, the epilogue's chunks of CB channels over the padded table),
  every bin and history sample written once and bit for bit the model;
- the wrapper's refusals, and the plan's constants against the source.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.ops import channelizer as JC
from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.channelizer import (PfbChannelizer,
                                                    PfbXlatBank)
from test_torch_complex_tiles import fmaf
from test_torch_frontends import PFB_BANK_ATOL, PFB_REL
from test_torch_pfb_rows import _operands
from test_torch_pfb_tiles import WIRE_VEC, branch_sums, fmaf_chain, stage

torch.set_num_threads(1)   # six test workers share the machine

BIN_RATE = 400e3
_SRC = (kernels.CSRC / "pfb_rows.cu").read_text()


def _cnormal(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _block(rng, s, t, wire):
    """(the block in ``wire``'s form, its samples as numpy complex64)."""
    xf = torch.empty((s, t, 2)).copy_(torch.from_numpy(
        rng.standard_normal((s, t, 2)).astype(np.float32)))
    if wire == "bf16":
        xf = xf.to(torch.bfloat16)
    xc = torch.view_as_complex(xf.float().contiguous()).numpy()
    return (torch.view_as_complex(xf) if wire == "complex64" else xf), xc


def _jax_bins(jp, states, blk):
    """JAX's channels [S, M, T/M] one source at a time; updates states."""
    out = []
    for s in range(blk.shape[0]):
        states[s], y = jp(states[s], jnp.asarray(blk[s]))
        out.append(np.asarray(y))
    return np.stack(out)


def model(vp: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The kernel's epilogue on the unflipped sums v' [S, n, M]: per
    channel c, m' ascending from zero, re = fma(-v.im, w.im, fma(v.re,
    w.re, re)), im = fma(v.im, w.re, fma(v.re, w.im, im)); [S, M, n]."""
    s, n, m = vp.shape
    vr, vi = vp.real.astype(np.float32), vp.imag.astype(np.float32)
    out = np.empty((s, m, n), np.complex64)
    for c in range(m):
        ar = np.zeros((s, n), np.float32)
        ai = np.zeros((s, n), np.float32)
        for mp in range(m):
            wr, wi = np.float32(table[c, mp].real), np.float32(
                table[c, mp].imag)
            ar = fmaf(-vi[..., mp], wi, fmaf(vr[..., mp], wr, ar))
            ai = fmaf(vi[..., mp], wr, fmaf(vr[..., mp], wi, ai))
        out[:, c] = ar + 1j * ai
    return out


@pytest.mark.parametrize("wire", ["bf16", "float32", "complex64"])
@pytest.mark.parametrize("m", [6, 8, 16, 20, 25])
def test_bins_match_jax(m, wire):
    """Two sources through the pfb mode's 80 dB bank at M·400 kHz: a
    block of 256 rows, then one of 10 (< P-1, so the history spans the
    old one and the block). ``PfbChannelizer.bins`` is ``pfb_bins_plain``
    bit for bit, within PFB_REL·max|y| of JAX's channels, the history
    equal to JAX's after each block."""
    fs = m * BIN_RATE
    jp = JC.PfbChannelizer.for_rates(fs, m, atten_db=80.0)
    tp = PfbChannelizer.for_rates(fs, m, atten_db=80.0)
    np.testing.assert_array_equal(tp.hp2, jp.hp2)
    rng = np.random.default_rng(m * 10 + len(wire))
    jst = [jp.init() for _ in range(2)]
    st = tp.init(2, "cpu")
    hp2 = tp.device_hp2("cpu")
    for rows in (256, 10):
        x, xc = _block(rng, 2, rows * m, wire)
        want = _jax_bins(jp, jst, xc)
        y, hist = pk.pfb_bins_plain(st.history, x, hp2)
        st, yb = tp.bins(st, x)
        assert yb.shape == (2, m, rows) and yb.is_contiguous()
        assert torch.equal(torch.view_as_real(yb), torch.view_as_real(y))
        assert torch.equal(torch.view_as_real(st.history),
                           torch.view_as_real(hist))
        np.testing.assert_allclose(yb.numpy(), want,
                                   atol=PFB_REL * np.abs(want).max())
        np.testing.assert_array_equal(
            st.history.numpy(), np.stack([np.asarray(j.history)
                                          for j in jst]))


@pytest.mark.parametrize("m", [20, 25])
def test_pfb_xlat_bank_matches_jax_at_live_rates(m):
    """The live config's 8 and 10 MS/s pfb sources (M = 20, 25): two
    sources × four slots (a slot on bin 0, one on a negative bin, two
    sharing a bin) over a block of 512 bin samples and one of 128 (< K2-1)
    through ``PfbXlatBank``, within PFB_BANK_ATOL of the JAX bank's, the
    phase equal and the PFB history exact."""
    fs = m * BIN_RATE
    jb, tb = JC.PfbXlatBank(4, fs, 12500.0), PfbXlatBank(4, fs, 12500.0)
    assert (tb.m, tb.pfb.p) == (jb.m, jb.pfb.p) == (m, 24)
    offs = (np.array([[12.5e3, -1.21e6, 2.4e6, 2.41e6],
                      [-3.2e6, 400e3, 780e3, -25e3]]) / fs).astype(
        np.float32)
    rng = np.random.default_rng(m)
    jstep = jax.jit(jax.vmap(jb.__call__))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                       jb.init())
    tst = tb.init(2, "cpu")
    for n_bin in (512, 128):
        xb = _cnormal(rng, (2, n_bin * m))
        jst, jy = jstep(jst, jnp.asarray(xb), jnp.asarray(offs))
        tst, ty = tb(tst, torch.from_numpy(xb), torch.from_numpy(offs))
        assert ty.shape == (2, 4, n_bin // tb.decim2)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=PFB_BANK_ATOL)
        np.testing.assert_array_equal(
            tst.fine.phase.numpy().astype(np.uint32),
            np.asarray(jst.fine.phase))
        np.testing.assert_array_equal(tst.pfb.history.numpy(),
                                      np.asarray(jst.pfb.history))


@pytest.mark.parametrize("m", [6, 8, 16, 20, 25, 50])
def test_epilogue_model(m):
    """The kernel's epilogue, modelled in numpy on ``pfb_rows_plain``'s
    sums with ``bins_table`` and the kernel's sum order: within
    BINS_REL·max|bins| of ``pfb_bins_plain`` (what the card is held to)
    and within PFB_REL·max|y| of the JAX channelizer."""
    fs = m * BIN_RATE
    jp = JC.PfbChannelizer.for_rates(fs, m, atten_db=80.0)
    tp = PfbChannelizer.for_rates(fs, m, atten_db=80.0)
    rng = np.random.default_rng(m)
    hist = torch.from_numpy(_cnormal(rng, (2, (tp.p - 1) * m)))
    x, xc = _block(rng, 2, 300 * m, "float32")
    hp2 = tp.device_hp2("cpu")
    v, _ = pk.pfb_rows_plain(hist, x, hp2)
    got = model(np.ascontiguousarray(v.numpy()[..., ::-1]),
                pk.bins_table(m))
    plain, _ = pk.pfb_bins_plain(hist, x, hp2)
    scale = float(plain.abs().max())
    err = float(np.abs(got - plain.numpy()).max())
    assert err <= pk.BINS_REL * scale, (err / scale, pk.BINS_REL)
    jst = [jp.init()._replace(history=jnp.asarray(h)) for h in hist.numpy()]
    want = _jax_bins(jp, jst, xc)
    np.testing.assert_allclose(got, want, atol=PFB_REL * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 2, 3, 6, 7, 20, 25, 50])
def test_bins_table(m):
    """``bins_table`` is e^{2jπ((c·m) mod M)/M}·rot[c] at m = M-1-m' in
    float64 (rot[c] from ``rotation``'s float32 angles), rounded once to
    complex64; its last column is ``rotation`` itself, which is
    ``PfbChannelizer.rot``; and Σ_m' v'·W is M·ifft(flip(v'))·rot in
    float64 on random sums."""
    w = pk.bins_table(m)
    assert w.shape == (m, m) and w.dtype == np.complex64
    ang = (np.float32(2.0 * np.pi / m) * np.arange(m, dtype=np.float32)
           ).astype(np.float64)
    c = np.arange(m)[:, None]
    mm = (m - 1 - np.arange(m))[None, :]
    ref = np.exp(2j * np.pi * ((c * mm) % m) / m) * np.exp(1j * ang)[:, None]
    np.testing.assert_array_equal(w, ref.astype(np.complex64))
    assert np.abs(w - ref).max() <= 2.0 ** -24 * np.sqrt(2.0)
    np.testing.assert_array_equal(w[:, m - 1], pk.rotation(m))
    np.testing.assert_array_equal(pk.rotation(m),
                                  PfbChannelizer(m, np.ones(m)).rot)
    rng = np.random.default_rng(m)
    vp = rng.standard_normal((5, m)) + 1j * rng.standard_normal((5, m))
    want = np.fft.ifft(vp[:, ::-1], axis=-1) * m * np.exp(1j * ang)
    np.testing.assert_allclose(vp @ w.astype(np.complex128).T, want,
                               atol=1e-6 * np.abs(want).max())


def emulate_bins(hist, x, hp2, wire, base_off):
    """``pfb_bins`` as the kernel's plan computes it: (bins, new history,
    per-bin write counts)."""
    s_n, h = hist.shape
    m, p = hp2.shape
    xc = x.numpy() if x.is_complex() else torch.view_as_complex(
        x.float().contiguous()).numpy()
    t = xc.shape[1]
    z = np.concatenate([hist.numpy(), xc], axis=1)
    k, wb, slabs, _ = pk.bins_plan(m, p, wire == "bf16")
    vec = WIRE_VEC["Bf16Wire" if wire == "bf16" else "F32Wire"]
    r_rows, n = slabs * 32 * k, t // m
    tiles = -(-n // r_rows) if n else 1
    pitch = r_rows + p - 1
    cpad = -(-m // pk.CB) * pk.CB
    wt = np.zeros((m, cpad), np.complex64)        # [m'][c], zero-padded
    wt[:, :m] = pk.bins_table(m).T
    taps = hp2.numpy()
    bins = np.full((s_n, m, n), np.nan, np.complex64)
    count = np.zeros((s_n, m, n), np.int64)
    nh = np.full((s_n, h), np.nan, np.complex64)
    lanes = np.arange(32)
    for s in range(s_n):
        off = (base_off + s * t) % vec
        for tile in range(tiles):
            t0 = tile * r_rows
            if tile == tiles - 1:
                nh[s] = z[s, n * m:n * m + h]
            span = min(r_rows + p - 1, n + p - 1 - t0)
            planes = stage(z, s, t, m, p, t0, span, 0, m, pitch, vec, off)
            for m0 in range(0, m, wb):
                done = []        # a round's sums, written after its barrier
                for warp in range(wb * slabs):
                    ml, slab = m0 + warp % wb, warp // wb
                    if ml < m and t0 + slab * 32 * k < n:
                        done.append((ml, *branch_sums(
                            planes[ml], taps[ml], slab * 32 * k + lanes * k,
                            p, k)))
                for ml, rows, val in done:
                    planes[ml, rows] = val
            r = np.arange(min(r_rows, n - t0))
            for ch in range(cpad // pk.CB):
                acc = np.zeros((pk.CB, 2, len(r)), np.float32)
                for mp in range(m):
                    v = planes[mp, r]
                    for kk in range(pk.CB):
                        w = wt[mp, ch * pk.CB + kk]
                        wr, wi = np.float32(w.real), np.float32(w.imag)
                        acc[kk, 0] = fmaf(-v.imag, wi,
                                          fmaf(v.real, wr, acc[kk, 0]))
                        acc[kk, 1] = fmaf(v.imag, wr,
                                          fmaf(v.real, wi, acc[kk, 1]))
                for kk in range(pk.CB):
                    c = ch * pk.CB + kk
                    if c < m:
                        bins[s, c, t0 + r] = acc[kk, 0] + 1j * acc[kk, 1]
                        count[s, c, t0 + r] += 1
    return bins, nh, count


# (M, sources, samples, wire): the bench bank over a partial last tile,
# M = 3 (two slabs sharing each plane), 8 and 16 (one round), 20 and 25
# (two rounds of 10 and 13 warps), 50 (four rounds; the planes ~177 KB),
# 100 (K_SMALL: the wire's K does not fit), a block of 10 rows (< P-1)
# and an empty one
EMU_CASES = [(6, 2, 6 * 400, "bf16"), (3, 2, 3 * 800, "float32"),
             (8, 1, 8 * 300, "complex64"), (16, 1, 16 * 100, "float32"),
             (20, 1, 20 * 400, "bf16"), (25, 1, 25 * 150, "float32"),
             (50, 1, 50 * 40, "bf16"), (100, 1, 100 * 40, "float32"),
             (6, 3, 60, "bf16"), (6, 2, 0, "float32")]


@pytest.mark.parametrize("m,s,t,wire", EMU_CASES)
def test_plan_matches_the_model(m, s, t, wire):
    """Every bin and history sample written once; the bins bit for bit
    the epilogue model on the sums' ``fmaf`` chain, the history
    ``pfb_rows_plain``'s; the block one sample past a 16-byte boundary."""
    pfb = PfbChannelizer.for_rates(m * BIN_RATE, m, atten_db=80.0)
    rng = np.random.default_rng(m * 100 + t)
    hist = torch.from_numpy(_cnormal(rng, (s, (pfb.p - 1) * m)))
    x, _ = _block(rng, s, t, wire)
    hp2 = pfb.device_hp2("cpu")
    bins, nh, count = emulate_bins(hist, x, hp2, wire, 1)
    assert (count == 1).all()
    np.testing.assert_array_equal(
        nh.view(np.int32), pk.pfb_rows_plain(hist, x, hp2)[1].numpy().view(
            np.int32))
    if t:
        chain = np.ascontiguousarray(fmaf_chain(hist, x, hp2)[..., ::-1])
        np.testing.assert_array_equal(
            bins.view(np.int32), model(chain, pk.bins_table(m)).view(
                np.int32))


def test_plan_constants():
    """The plan's constants are the kernel source's; for every M the
    planes, the padded table and the taps fit a block's shared memory at
    P = 24, the warps cover the branches within 32·MB_MAX threads, the
    rows a lane are odd; M = 116 is refused."""
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 _SRC).group(1))
             for name in ("MB_MAX", "WARPS_MAX", "K_SMALL", "CB",
                          "SMEM_MAX")}
    assert const == {"MB_MAX": pk.MB_MAX, "WARPS_MAX": pk.WARPS_MAX,
                     "K_SMALL": pk.K_SMALL, "CB": pk.CB,
                     "SMEM_MAX": pk.SMEM_MAX}
    for bf16, wire in ((True, "Bf16Wire"), (False, "F32Wire")):
        k = int(re.search(rf"struct {wire} {{.*?static constexpr int K = "
                          rf"(\d+);", _SRC, re.S).group(1))
        assert pk.WIRE_K[bf16] == k
        for m in range(1, 116):
            kk, wb, slabs, shared = pk.bins_plan(m, 24, bf16)
            assert kk in (k, pk.K_SMALL) and kk % 2 == 1
            assert shared <= pk.SMEM_MAX and wb * slabs <= pk.MB_MAX
            assert -(-m // wb) * wb >= m and -(-m // wb) == -(-m // pk.MB_MAX)
        with pytest.raises(ValueError, match="M=116, P=24 needs"):
            pk.bins_plan(116, 24, bf16)


@pytest.mark.parametrize("bad,match", [
    ({"x": torch.zeros((2, 12, 2), dtype=torch.float16)}, "x must be"),
    ({"x": torch.zeros((2, 12), dtype=torch.complex128)}, "x must be"),
    ({"x": torch.zeros((2, 2, 12)).transpose(1, 2)}, "x must be"),
    ({"x": torch.zeros((2, 24), dtype=torch.complex64)[:, ::2]},
     "x must be"),
    ({"x": torch.zeros(2 * 12 * 2 + 1)[1:].view(2, 12, 2)}, "x must be"),
    ({"x": torch.zeros((2, 13, 2))}, "not a multiple of M=3"),
    ({"hp2": torch.zeros((3, 4), dtype=torch.float64)}, "hp2 must be"),
    ({"hp2": torch.zeros((4, 3)).T}, "hp2 must be"),
    ({"history": torch.zeros((2, 8), dtype=torch.complex64)},
     "history must be"),
    ({"history": torch.zeros((2, 18), dtype=torch.complex64)[:, ::2]},
     "history must be"),
    ({}, "takes CUDA tensors"),
    ({"x": torch.zeros((2, 12), dtype=torch.complex64)},
     "takes CUDA tensors")])
def test_pfb_bins_entry_refuses(bad, match):
    """``pfb_bins_args`` validates before any launch: another dtype, shape
    or layout, a misaligned block or T % M ≠ 0 raises, and so do CPU
    tensors (the wrapper sends those to the plain version)."""
    ops = _operands(**bad)
    with pytest.raises(ValueError, match=f"pfb_bins: .*{match}"):
        pk.pfb_bins_args(ops["history"], ops["x"], ops["hp2"])


def test_pfb_bins_refuses_other_devices():
    """A tensor on neither the CPU nor a card is refused, never computed
    by the plain version; so is a block that is not whole rows, before
    the wrapper is reached."""
    ops = {k: v.to("meta") for k, v in _operands().items()}
    with pytest.raises(ValueError, match="takes CUDA tensors, got meta"):
        pk.pfb_bins(ops["history"], ops["x"], ops["hp2"])
    pfb = PfbChannelizer.for_rates(2.4e6, 6, atten_db=80.0)
    with pytest.raises(ValueError, match="not a multiple of M=6"):
        pfb.bins(pfb.init(1, "cpu"), torch.zeros((1, 61, 2)))


def test_bins_entry_signature_matches_the_source():
    """The ctypes signature has one argument per parameter of the C entry
    point."""
    params = re.search(r'extern "C" int pfb_bins_launch\(([^)]*)\)',
                       _SRC).group(1)
    assert len(params.split(",")) == len(kernels._SIGNATURES[
        "pfb_bins_launch"])
