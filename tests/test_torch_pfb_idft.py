"""The pfb step's coarse PFB in one kernel: ``pfb_bins`` (``csrc/
pfb_rows.cu``'s second entry, ``ops/pfb_kernel.py``) folds the M-point
IDFT and the channel rotation into the combiner, the IDFT factored as
M = M1·M2 where the plan factors M. On the CPU:

- ``pfb_bins_plain`` and ``PfbChannelizer.bins`` against the JAX
  ``PfbChannelizer`` at M = 6, 8, 16, 20 and 25 (the pfb mode's 80 dB
  banks at 2.4, 3.2, 6.4, 8 and 10 MS/s) on bf16, float32 and complex64
  blocks, within PFB_REL, the history exact; ``PfbXlatBank`` against
  JAX's at the live config's 8 and 10 MS/s sources (M = 20, 25);
- a numpy model of the kernel's epilogue on the plain sums (the factored
  plan's two stages with ``factored_tables``, or the direct path's folded
  table W; each output one ``fmaf`` chain over its inputs as the kernel
  sums them) at M = 6, 8, 16, 20, 25, 50, 100 and on the direct path at
  M = 7 and 11, on the three wires, against ``pfb_bins_plain`` within
  ``BINS_REL`` (the card's bound) and JAX within PFB_REL;
- ``bins_table`` and ``factored_tables`` against their definitions in
  float64, the factored sum against the M-point inverse FFT;
- the kernel's plan emulated (the launcher's rounds of warps over the
  branches, the sums written back over their planes after each round's
  barrier; the factored epilogue's first stage in place over the planes,
  then its second stage, or the direct epilogue's chunks of CB channels
  over the padded table), every bin and history sample written once and
  bit for bit the model;
- the plan's factors, shared memory and refusals, the wrapper's
  refusals, and the plan's constants and the entry's signature against
  the source.
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


def fma_sum(ins, ws):
    """One output of the kernel's epilogue: Σ_j ins[j]·ws[j], j ascending
    from zero, re = fma(-v.im, w.im, fma(v.re, w.re, re)) and im =
    fma(v.im, w.re, fma(v.re, w.im, im)) from zero; ins are (re, im)
    float32 arrays, ws complex64 constants. Returns (re, im)."""
    re = np.zeros_like(ins[0][0])
    im = np.zeros_like(ins[0][0])
    for (vr, vi), w in zip(ins, ws):
        wr, wi = np.float32(w.real), np.float32(w.imag)
        re = fmaf(-vi, wi, fmaf(vr, wr, re))
        im = fmaf(vi, wr, fmaf(vr, wi, im))
    return re, im


def _parts(v):
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def factored_rows(m: int, m1: int, m2: int):
    """``factored_tables`` split as the kernel reads it: W1 [M1, M1] and
    T2 [M, M2] out of rows padded to an even length."""
    tab = pk.factored_tables(m, m1, m2)
    m1p, m2p = m1 + m1 % 2, m2 + m2 % 2
    assert tab.shape == (m1 * m1p + m * m2p,)
    return (tab[:m1 * m1p].reshape(m1, m1p)[:, :m1],
            tab[m1 * m1p:].reshape(m, m2p)[:, :m2])


def model(vp: np.ndarray, m1: int = 1, m2: int = 0) -> np.ndarray:
    """The kernel's epilogue on the unflipped sums v' [S, n, M] → [S, M,
    n]. Direct (M1 = 1): channel c from every m' ascending through
    ``bins_table``. Factored: for each m2, the first stage's M1 outputs
    A[c1, m2] from u[M2·m1 + m2] = v'[M-1-M2·m1-m2], m1 ascending, with
    W1[c1]; then channel c = c1 + M1·c2 from A[c1, m2], m2 ascending,
    with T2[c]. Each output one ``fma_sum``."""
    s, n, m = vp.shape
    v = [_parts(vp[..., i]) for i in range(m)]
    out = np.empty((s, m, n), np.complex64)
    if m1 == 1:
        table = pk.bins_table(m)
        for c in range(m):
            re, im = fma_sum(v, table[c])
            out[:, c] = re + 1j * im
        return out
    w1, t2 = factored_rows(m, m1, m2)
    a = {}
    for q in range(m2):
        col = [v[m - 1 - m2 * j - q] for j in range(m1)]
        for c1 in range(m1):
            a[c1, q] = fma_sum(col, w1[c1])
    for c1 in range(m1):
        col = [a[c1, q] for q in range(m2)]
        for c2 in range(m2):
            re, im = fma_sum(col, t2[c1 + m1 * c2])
            out[:, c1 + m1 * c2] = re + 1j * im
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


# M of the model: the factored plan's (4·4, 4·5, 5·5, 5·10, 10·10), the
# direct path's at M = 6 and 8 (DIRECT_M; 2·3 and 2·4 modelled beside it)
# and at the primes 7 and 11
MODEL_M = [6, 8, 16, 20, 25, 50, 100, 7, 11]


def least_pair(m: int):
    """The factor pair (M1 ≤ M2 ≤ FACTOR_MAX) of least sum, DIRECT_M
    aside, or None."""
    pairs = [(a, m // a) for a in range(2, m) if m % a == 0
             and a <= m // a <= pk.FACTOR_MAX]
    return min(pairs, key=sum) if pairs else None


@pytest.mark.parametrize("m,wire", [
    pytest.param(m, wire, id=str(m) if wire == "float32" else f"{m}-{wire}")
    for m in MODEL_M for wire in ("float32", "bf16", "complex64")])
def test_epilogue_model(m, wire):
    """The kernel's epilogue, modelled in numpy on ``pfb_rows_plain``'s
    sums with the least factor pair (the plan's, ``idft_factors``, except
    at DIRECT_M) and on the direct table: each within BINS_REL·max|bins|
    of ``pfb_bins_plain`` (what the card is held to) and within
    PFB_REL·max|y| of the JAX channelizer."""
    fs = m * BIN_RATE
    jp = JC.PfbChannelizer.for_rates(fs, m, atten_db=80.0)
    tp = PfbChannelizer.for_rates(fs, m, atten_db=80.0)
    rng = np.random.default_rng(m * 10 + len(wire))
    hist = torch.from_numpy(_cnormal(rng, (2, (tp.p - 1) * m)))
    x, xc = _block(rng, 2, 300 * m, wire)
    hp2 = tp.device_hp2("cpu")
    v, _ = pk.pfb_rows_plain(hist, x, hp2)
    vp = np.ascontiguousarray(v.numpy()[..., ::-1])
    plain, _ = pk.pfb_bins_plain(hist, x, hp2)
    scale = float(plain.abs().max())
    jst = [jp.init()._replace(history=jnp.asarray(h)) for h in hist.numpy()]
    want = _jax_bins(jp, jst, xc)
    pair = least_pair(m)
    assert pk.idft_factors(m) == (
        (1, m) if pair is None or m in pk.DIRECT_M else pair)
    assert (pair is None) == (m in (7, 11))
    for got in [model(vp)] + ([model(vp, *pair)] if pair else []):
        err = float(np.abs(got - plain.numpy()).max())
        assert err <= pk.BINS_REL * scale, (err / scale, pk.BINS_REL)
        np.testing.assert_allclose(got, want,
                                   atol=PFB_REL * np.abs(want).max())


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


# M -> the plan's (M1, M2): the least M1 + M2, both factors at most
# FACTOR_MAX; (1, M) the direct table, also at DIRECT_M's 6 and 8
FACTORS = {2: (1, 2), 3: (1, 3), 4: (2, 2), 6: (1, 6), 7: (1, 7),
           8: (1, 8), 11: (1, 11), 12: (3, 4), 13: (1, 13), 16: (4, 4),
           20: (4, 5), 25: (5, 5), 34: (1, 34), 36: (6, 6), 50: (5, 10),
           64: (8, 8), 100: (10, 10), 112: (8, 14), 113: (1, 113),
           115: (1, 115)}


@pytest.mark.parametrize("m", sorted(FACTORS))
def test_idft_factors(m):
    """The plan factors M as the least M1 + M2 with M1 ≤ M2 ≤ FACTOR_MAX
    and leaves a prime, an M whose cofactor passes FACTOR_MAX (34 = 2·17,
    115 = 5·23) and DIRECT_M on the direct table; ``bins_plan`` returns
    them."""
    assert pk.idft_factors(m) == FACTORS[m]
    assert pk.bins_plan(m, 24, True)[3:5] == FACTORS[m]


@pytest.mark.parametrize("m", [4, 6, 8, 20, 25, 50, 100])
def test_factored_tables(m):
    """``factored_tables``: W1 = e^{2jπ((c1·m1) mod M1)/M1} and T2 =
    e^{2jπ((c·m2) mod M)/M}·rot[c] (``rotation``'s float32 angles) in
    float64, rounded once to complex64, the rows' padding zero; the two
    stages in float64 on random sums are M·ifft(flip(v'))·rot."""
    m1, m2 = pk.idft_factors(m)
    tab = pk.factored_tables(m, m1, m2)
    assert tab.dtype == np.complex64
    m1p, m2p = m1 + m1 % 2, m2 + m2 % 2
    pads = np.concatenate([tab[:m1 * m1p].reshape(m1, m1p)[:, m1:].ravel(),
                           tab[m1 * m1p:].reshape(m, m2p)[:, m2:].ravel()])
    assert not pads.any()
    w1, t2 = factored_rows(m, m1, m2)
    ang = (np.float32(2.0 * np.pi / m) * np.arange(m, dtype=np.float32)
           ).astype(np.float64)
    k1 = np.arange(m1)
    ref1 = np.exp(2j * np.pi * ((k1[:, None] * k1) % m1) / m1)
    c = np.arange(m)[:, None]
    ref2 = (np.exp(2j * np.pi * ((c * np.arange(m2)) % m) / m)
            * np.exp(1j * ang)[:, None])
    np.testing.assert_array_equal(w1, ref1.astype(np.complex64))
    np.testing.assert_array_equal(t2, ref2.astype(np.complex64))
    rng = np.random.default_rng(m)
    vp = rng.standard_normal((5, m)) + 1j * rng.standard_normal((5, m))
    u = vp[:, ::-1]
    a = np.stack([u[:, q::m2] @ ref1.T for q in range(m2)], -1)  # [., c1, q]
    got = np.empty_like(vp)
    for cc in range(m):
        got[:, cc] = a[:, cc % m1] @ ref2[cc]
    want = np.fft.ifft(u, axis=-1) * m * np.exp(1j * ang)
    np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("m,factors", [(16, (3, 5)), (16, (2, 9)),
                                       (34, (2, 17)), (16, (1, 15)),
                                       (6, (3, 2)), (6, (0, 6))])
def test_bins_plan_refuses_factors(m, factors):
    """A plan whose factors do not multiply to M, are out of order, or
    pass FACTOR_MAX is refused, as the C entry refuses it."""
    with pytest.raises(ValueError, match=f"no plan factors M={m}"):
        pk.bins_plan(m, 24, True, factors)


def emulate_bins(hist, x, hp2, wire, base_off, factors=None):
    """``pfb_bins`` as the kernel's plan computes it (``bins_plan``, with
    ``factors`` if given): (bins, new history, per-bin write counts)."""
    s_n, h = hist.shape
    m, p = hp2.shape
    xc = x.numpy() if x.is_complex() else torch.view_as_complex(
        x.float().contiguous()).numpy()
    t = xc.shape[1]
    z = np.concatenate([hist.numpy(), xc], axis=1)
    k, wb, slabs, m1, m2, _ = pk.bins_plan(m, p, wire == "bf16", factors)
    vec = WIRE_VEC["Bf16Wire" if wire == "bf16" else "F32Wire"]
    r_rows, n = slabs * 32 * k, t // m
    tiles = -(-n // r_rows) if n else 1
    pitch = r_rows + p - 1
    cb = pk.direct_chunk(m)
    cpad = -(-m // cb) * cb
    table = pk.plan_table(m, m1, m2)   # as the kernel copies it in
    m1p, m2p = m1 + m1 % 2, m2 + m2 % 2
    if m1 == 1:
        wt = np.zeros((m, cpad), np.complex64)    # [m'][c], zero-padded
        wt[:, :m] = table.T
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
            if m1 > 1:
                # first stage: a thread per (row, q = m2), in place over
                # planes M-1-q - M2·j; the tasks' planes are disjoint
                touched = np.zeros(m, np.int64)
                for q in range(m2):
                    col = [m - 1 - q - m2 * j for j in range(m1)]
                    touched[col] += 1
                    ins = [_parts(planes[pl, r]) for pl in col]
                    outs = [fma_sum(ins, table[kk * m1p:kk * m1p + m1])
                            for kk in range(m1)]
                    for pl, (re, im) in zip(col, outs):
                        planes[pl, r] = re + 1j * im
                assert (touched == 1).all()
                # second stage: a thread per (row, c1), T2 row c1 + M1·c2
                t2 = m1 * m1p
                for c1 in range(m1):
                    ins = [_parts(planes[m - 1 - m2 * c1 - j, r])
                           for j in range(m2)]
                    for c2 in range(m2):
                        c = c1 + m1 * c2
                        re, im = fma_sum(ins, table[t2 + c * m2p:
                                                    t2 + c * m2p + m2])
                        bins[s, c, t0 + r] = re + 1j * im
                        count[s, c, t0 + r] += 1
                continue
            for ch in range(cpad // cb):
                acc = np.zeros((cb, 2, len(r)), np.float32)
                for mp in range(m):
                    v = planes[mp, r]
                    for kk in range(cb):
                        w = wt[mp, ch * cb + kk]
                        wr, wi = np.float32(w.real), np.float32(w.imag)
                        acc[kk, 0] = fmaf(-v.imag, wi,
                                          fmaf(v.real, wr, acc[kk, 0]))
                        acc[kk, 1] = fmaf(v.imag, wr,
                                          fmaf(v.real, wi, acc[kk, 1]))
                for kk in range(cb):
                    c = ch * cb + kk
                    if c < m:
                        bins[s, c, t0 + r] = acc[kk, 0] + 1j * acc[kk, 1]
                        count[s, c, t0 + r] += 1
    return bins, nh, count


# (M, sources, samples, wire): the bench bank over a partial last tile
# (direct, 6 channels a thread), M = 3 (direct: two slabs sharing each
# plane), 8 (one round; direct) and 16 (4·4; two rounds of 8 warps), 20
# and 25 (K_MID rows on bf16, three and four rounds of 8 warps; 4·5,
# 5·5), 50 (5·10; K_MID rows, 16 warps over 4 rounds; one tile and
# five), 100 on float32 and bf16 (10·10, K_SMALL, 16 warps), a block of
# 10 rows (< P-1), an empty one, the direct path at M = 7 and 11 and at
# M = 113 (K_SMALL beside the [M, M] table), and the largest factors the
# plan takes below M = 116: 7·15 (odd rows of constants) and 8·14
EMU_CASES = [(6, 2, 6 * 400, "bf16"), (3, 2, 3 * 800, "float32"),
             (8, 1, 8 * 300, "complex64"), (16, 1, 16 * 100, "float32"),
             (20, 1, 20 * 400, "bf16"), (25, 1, 25 * 150, "float32"),
             (50, 1, 50 * 40, "bf16"), (100, 1, 100 * 40, "float32"),
             (6, 3, 60, "bf16"), (6, 2, 0, "float32"),
             (50, 1, 50 * 200, "bf16"), (100, 1, 100 * 40, "bf16"),
             (100, 1, 100 * 250, "float32"), (7, 1, 7 * 500, "bf16"),
             (11, 1, 11 * 100, "complex64"), (113, 1, 113 * 20, "float32"),
             (105, 1, 105 * 20, "bf16"), (112, 1, 112 * 20, "float32")]


def check_plan_against_model(m, s, t, wire, factors=None):
    """``emulate_bins`` on a block one sample past a 16-byte boundary:
    every bin and history sample written once, the bins bit for bit the
    epilogue model on the sums' ``fmaf`` chain, the history
    ``pfb_rows_plain``'s."""
    pfb = PfbChannelizer.for_rates(m * BIN_RATE, m, atten_db=80.0)
    rng = np.random.default_rng(m * 100 + t)
    hist = torch.from_numpy(_cnormal(rng, (s, (pfb.p - 1) * m)))
    x, _ = _block(rng, s, t, wire)
    hp2 = pfb.device_hp2("cpu")
    bins, nh, count = emulate_bins(hist, x, hp2, wire, 1, factors)
    assert (count == 1).all()
    np.testing.assert_array_equal(
        nh.view(np.int32), pk.pfb_rows_plain(hist, x, hp2)[1].numpy().view(
            np.int32))
    if t:
        chain = np.ascontiguousarray(fmaf_chain(hist, x, hp2)[..., ::-1])
        m1, m2 = factors or pk.idft_factors(m)
        np.testing.assert_array_equal(
            bins.view(np.int32), model(chain, m1, m2).view(np.int32))


@pytest.mark.parametrize("m,s,t,wire", EMU_CASES)
def test_plan_matches_the_model(m, s, t, wire):
    """The kernel's plan at ``EMU_CASES``, emulated: every bin and history
    sample written once; the bins bit for bit the epilogue model, the
    history ``pfb_rows_plain``'s; the block one sample past a 16-byte
    boundary."""
    check_plan_against_model(m, s, t, wire)


@pytest.mark.parametrize("m,s,t,wire,factors", [
    (6, 2, 6 * 400, "bf16", (2, 3)), (8, 1, 8 * 300, "complex64", (2, 4))])
def test_factored_plan_matches_the_model(m, s, t, wire, factors):
    """The factored epilogue where the plan keeps the direct table (the
    bench bank's 2·3 over a partial last tile, 2·4), emulated as
    ``test_plan_matches_the_model`` does: what a plan with these factors
    computes on the card."""
    check_plan_against_model(m, s, t, wire, factors)


def test_plan_constants():
    """The plan's constants are the kernel source's; for every M the
    planes, the IDFT's table and the taps fit a block's shared memory at
    P = 24, the warps cover the branches within 32·MB_MAX threads, the
    rows a lane are odd; M = 116 is refused (4·29: the direct table).
    The plan takes the rows a lane and warps a slab an SM holds the most
    working warps of, then more than K_SMALL rows, then the most blocks:
    M = 6 on bf16 the wire's 11 rows and 6 warps (five blocks an SM),
    M = 25 7 rows and 8 warps (four), M = 50 7 rows and 16 warps (two),
    M = 100 3 rows and 16 warps (two; 7 rows leave one)."""
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 _SRC).group(1))
             for name in ("MB_MAX", "WARPS_MAX", "K_SMALL", "K_MID", "CB",
                          "CB_NARROW", "FACTOR_MAX", "SMEM_MAX")}
    assert const == {"MB_MAX": pk.MB_MAX, "WARPS_MAX": pk.WARPS_MAX,
                     "K_SMALL": pk.K_SMALL, "K_MID": pk.K_MID, "CB": pk.CB,
                     "CB_NARROW": pk.CB_NARROW,
                     "FACTOR_MAX": pk.FACTOR_MAX, "SMEM_MAX": pk.SMEM_MAX}
    assert re.search(r"__launch_bounds__\(32 \* MB_MAX, 2\)\n"
                     r"pfb_bins_kernel", _SRC)
    assert pk.REGS * 32 * pk.MB_MAX * 2 == pk.SM_REGS
    for bf16, wire in ((True, "Bf16Wire"), (False, "F32Wire")):
        k = int(re.search(rf"struct {wire} {{.*?static constexpr int K = "
                          rf"(\d+);", _SRC, re.S).group(1))
        assert pk.WIRE_K[bf16] == k
        for m in range(1, 116):
            kk, wb, slabs, m1, m2, shared = pk.bins_plan(m, 24, bf16)
            assert kk in (k, pk.K_MID, pk.K_SMALL) and kk % 2 == 1
            assert shared <= pk.SMEM_MAX and wb * slabs <= pk.MB_MAX
            assert wb in (-(-m // -(-m // pk.MB_MAX)), 8, pk.MB_MAX)
            assert slabs == (1 if wb >= 8 else 8 // wb)
            assert m1 * m2 == m and (m1 == 1 or m1 <= m2 <= pk.FACTOR_MAX)
        with pytest.raises(ValueError, match="M=116, P=24 needs"):
            pk.bins_plan(116, 24, bf16)
    assert pk.bins_plan(6, 24, True) == (11, 6, 1, 1, 6, 18864)
    assert pk.bins_plan(25, 24, True) == (7, 8, 1, 5, 5, 53240)
    for bf16 in (True, False):
        assert pk.bins_plan(50, 24, bf16) == (7, 16, 1, 5, 10, 107840)
        assert pk.bins_plan(100, 24, bf16) == (3, 16, 1, 10, 10, 113600)
    assert pk.bins_plan(100, 24, True, (1, 100))[::5] == (3, 186400)
    assert [pk.direct_chunk(m) for m in (6, 7, 8, 11, 20, 25, 100)] == [
        6, 8, 8, 6, 6, 6, 6]


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


@pytest.mark.parametrize("name", [
    "stores_only", "product_only", "no_epilogue", "cb=6", "f_stores_only",
    "f_product_only", "f_unroll=2", "ksmall=7+k=7+wb=8", "direct",
    "factors=2x3", "kwire"])
def test_variants_edit_the_sources(name):
    """Every edit of ``tools/pfb_variants.py`` finds its text once in the
    source it applies to: the direct epilogue's in the package's and in
    commit ef6af1a's copy, the factored epilogue's and the plan's in the
    package's, whose entry alone takes M1 and M2."""
    from radiocapture_tpu_torch.tools import pfb_variants as pv
    from radiocapture_tpu_torch.tools.track_turns import EARLIER_BINS
    old = EARLIER_BINS.read_text()
    assert pv.factored_entry(_SRC) and not pv.factored_entry(old)
    edits = pv.split(name)[0]
    assert pv.variant_source(_SRC, edits) != _SRC or not edits
    if not name.startswith(("f_", "ksmall", "direct", "factors", "kwire")):
        assert pv.variant_source(old, edits) != old


def test_bins_entry_signature_matches_the_source():
    """The ctypes signature has one argument per parameter of the C entry
    point."""
    params = re.search(r'extern "C" int pfb_bins_launch\(([^)]*)\)',
                       _SRC).group(1)
    assert len(params.split(",")) == len(kernels._SIGNATURES[
        "pfb_bins_launch"])
