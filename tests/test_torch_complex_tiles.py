"""The complex bank kernel's split2 plan (``csrc/xlat_complex.cu``),
emulated on the CPU against the plain version and the JAX reference.

The plan: persistent warps, each over a contiguous run of warp tiles of
32·R outputs of one source in source-major order; a tile's wire samples
copied into a ring of STAGES stages; the span converted to float32 and
deinterleaved into D polyphase planes, the first K-1 samples of a
source's first tile taken from the history; lane l computes outputs
l·R .. l·R+R-1 of the tile for every slot from rows l·R .. l·R+R+P-2 of
the planes, in the kernel's loop order (row m, plane j, output r, slot
c, four ``fmaf`` per tap); a partial last tile per source. The CUDA
kernel cannot run here: this holds the index arithmetic it shares with
the emulation, at the constants the kernel is built with, to
``bank_complex_plain``: every output is written once, its window holds
the plain version's samples bit for bit, and its accumulators are those
of one ``fmaf`` chain per output in k order (the order of the kernel
it replaced, ``tools/xlat_complex_54b2cf5.cu``) bit for bit, with ``fmaf`` emulated exactly in float64. Then the
wrapper's CPU path against the JAX ``XlatBank.__call__`` on bf16,
float32 and complex64 blocks."""

import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from radiocapture_tpu.ops.channelizer import XlatBank as JBank
from radiocapture_tpu.ops.channelizer import XlatBankState as JState
from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import SpectrumSplit2
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.channelizer import XlatBank, XlatBankState
from radiocapture_tpu_torch.ops.fir import U32_MASK, phase_step_u32, rotate

torch.set_num_threads(1)   # six test workers share the machine

# the plan's constants, as the kernel is built with them
_SRC = (kernels.CSRC / "xlat_complex.cu").read_text()
P, D, C, R, STAGES = (int(re.search(rf"constexpr int {name} = (\d+);",
                                    _SRC).group(1))
                      for name in ("FAST_P", "FAST_D", "FAST_C", "R",
                                   "STAGES"))
K = P * D
TILE = 32 * R
# float32 sums in another order than the plain version's GEMM, × max|y|
COMPLEX_REL = 1e-4
ATOL = 2e-3     # tests/test_torch_split2.py: against the JAX __call__


def fmaf(a, b, c):
    """float32 a·b + c rounded once, as CUDA's ``fmaf``: the product is
    exact in float64; where the float64 sum lands on a float32 rounding
    midpoint that the exact sum does not, the sum's rounding error
    (TwoSum) decides the direction."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    t = p + c64
    bp = t - p
    e = (p - (t - bp)) + (c64 - bp)
    r = t.astype(np.float32)
    r64 = r.astype(np.float64)
    side = np.where(t > r64, np.float32(np.inf), np.float32(-np.inf))
    nb = np.nextafter(r, side)
    mid = (t != r64) & ((r64 + nb.astype(np.float64)) * 0.5 == t) & (e != 0)
    fix = np.where(e > 0, np.maximum(r, nb), np.minimum(r, nb))
    return np.where(mid, fix, r).astype(np.float32)


def _round32(exact):
    """The float32 nearest the rational ``exact``, ties to even."""
    from fractions import Fraction
    r = np.float32(float(exact))
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))


def test_fmaf_rounds_once():
    """The emulation against exact rational arithmetic: random cases, and
    cases whose float64 sum lands on a float32 midpoint that the exact
    sum misses by 2^-54 relative (a·b = 2^-24 - 2^-54 for a = 2^-24(1 +
    2^-15), b = 1 - 2^-15, c = 1 + 2^-23, scaled and negated), where
    rounding the float64 sum to float32 would err."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = list(rng.standard_normal(300).astype(np.float32))
    b = list(rng.standard_normal(300).astype(np.float32))
    c = list(rng.standard_normal(300).astype(np.float32))
    crafted = 0
    for k in (-20, 0, 7):
        for sign in (1.0, -1.0):
            a.append(np.float32(sign * 2.0 ** (k - 24) * (1 + 2.0 ** -15)))
            b.append(np.float32(1 - 2.0 ** -15))
            c.append(np.float32(sign * 2.0 ** k * (1 + 2.0 ** -23)))
            crafted += 1
    a, b, c = (np.array(v, np.float32) for v in (a, b, c))
    got = fmaf(a, b, c)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        assert got[i] == _round32(exact), (i, a[i], b[i], c[i])
    assert (got[-crafted:] != naive[-crafted:]).all()


def _warp_runs(total, warps):
    """The launcher's split of ``total`` tiles: a run of ⌈total/warps⌉
    consecutive tiles per warp (the last runs shorter or empty)."""
    per = -(-total // warps)
    return [(w * per, min(per, total - w * per)) for w in range(warps)
            if total - w * per > 0]


def _plan(x, history, grev, warps):
    """The kernel's plan on x [S, T, 2] float32 (the wire's values),
    history [S, K-1] complex64, grev [S, C, K] complex64. Returns the
    accumulators (ar, ai) [S, C, N] float32, the windows each output
    read [S, N, K] complex64, and how often each output was written."""
    s_n, t = x.shape[:2]
    n = t // D
    tiles = -(-n // TILE)
    xc = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    planes, where = [], []
    for t0, run in _warp_runs(s_n * tiles, warps):
        s, n0 = divmod(t0, tiles)
        n0 *= TILE
        ring = np.zeros((STAGES, (TILE + P - 1) * D), np.complex64)
        for it in range(run):           # copies land one tile ahead
            count = min(TILE, n - n0)
            lo = max(0, n0 * D - (K - 1))
            hi = (n0 + count + P - 1) * D - (K - 1)
            assert 0 < hi - lo <= ring.shape[1] and hi <= t
            ring[it % STAGES, :hi - lo] = xc[s, lo:hi]
            i = np.arange((count + P - 1) * D)
            zi = n0 * D + i
            v = np.where(zi < K - 1, history[s, np.minimum(zi, K - 2)],
                         ring[it % STAGES, np.maximum(zi - (K - 1) - lo, 0)])
            pl = np.zeros((D, TILE + P - 1), np.complex64)
            pl[i % D, i // D] = v
            planes.append(pl)
            where.append((s, n0, count))
            n0 += TILE
            if n0 >= n:
                s, n0 = s + 1, 0
    planes = np.stack(planes)                       # [tiles, D, rows]
    tile_s = np.array([w[0] for w in where])
    g = grev[tile_s]                                # [tiles, C, K]
    base = np.arange(32) * R                        # lane l's first row
    ar = np.zeros((R, C, len(planes), 32), np.float32)
    ai = np.zeros_like(ar)
    win = np.zeros((len(planes), 32, R, K), np.complex64)
    for m in range(R + P - 1):
        for j in range(D):
            zv = planes[:, j, base + m]             # [tiles, 32]
            zr, zim = zv.real.astype(np.float32), zv.imag.astype(np.float32)
            for r in range(R):
                q = m - r
                if not 0 <= q < P:
                    continue
                win[:, :, r, q * D + j] = zv
                for c in range(C):
                    gr = g[:, c, q * D + j].real[:, None].astype(np.float32)
                    gi = g[:, c, q * D + j].imag[:, None].astype(np.float32)
                    ar[r, c] = fmaf(gr, zr, ar[r, c])
                    ar[r, c] = fmaf(-gi, zim, ar[r, c])
                    ai[r, c] = fmaf(gr, zim, ai[r, c])
                    ai[r, c] = fmaf(gi, zr, ai[r, c])
    acc_r = np.zeros((s_n, C, n), np.float32)
    acc_i = np.zeros_like(acc_r)
    windows = np.zeros((s_n, n, K), np.complex64)
    writes = np.zeros((s_n, n), np.int64)
    for ti, (s, n0, count) in enumerate(where):
        for r in range(R):
            out = base + r
            ok = out < count
            acc_r[s][:, n0 + out[ok]] = ar[r][:, ti][:, ok]
            acc_i[s][:, n0 + out[ok]] = ai[r][:, ti][:, ok]
            windows[s, n0 + out[ok]] = win[ti, ok, r]
            writes[s, n0 + out[ok]] += 1
    return acc_r, acc_i, windows, writes


def _chain(z, grev, n):
    """One ``fmaf`` chain per output and slot in k order, the replaced
    kernel's order: accumulators [S, C, n] from z [S, L] complex64."""
    s_n = z.shape[0]
    ar = np.zeros((s_n, C, n), np.float32)
    ai = np.zeros_like(ar)
    for k in range(K):
        zk = z[:, k + D * np.arange(n)][:, None, :]        # [S, 1, n]
        zr, zi = zk.real.astype(np.float32), zk.imag.astype(np.float32)
        gr = grev[:, :, k].real[..., None].astype(np.float32)
        gi = grev[:, :, k].imag[..., None].astype(np.float32)
        ar = fmaf(np.broadcast_to(gr, ar.shape), zr, ar)
        ar = fmaf(np.broadcast_to(-gi, ar.shape), zi, ar)
        ai = fmaf(np.broadcast_to(gr, ai.shape), zi, ai)
        ai = fmaf(np.broadcast_to(gi, ai.shape), zr, ai)
    return ar, ai


def _operands(rng, s, t, wire):
    """Split2's own operands: a wire block (its float32 values and the
    tensor the wrapper gets), a random history, split2's taps and phase
    steps, a random uint32 phase."""
    x = rng.standard_normal((s, t, 2)).astype(np.float32)
    if wire == "bf16":
        xw = wire_from_numpy(x.astype(ml_dtypes.bfloat16), "cpu")
        x = xw.float().numpy()
    elif wire == "complex64":
        xw = torch.view_as_complex(torch.from_numpy(x))
    else:
        xw = torch.from_numpy(x)
    hist = (rng.standard_normal((s, K - 1))
            + 1j * rng.standard_normal((s, K - 1))).astype(np.complex64)
    sp = SpectrumSplit2(2.4e6)
    offs = torch.as_tensor(np.tile(sp.offsets, (s, 1)))
    grev = sp.bank.modulated_taps(offs)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, C)))
    return x, xw, hist, grev, phase0, phase_step_u32(offs, D)


@pytest.mark.parametrize("s,t,warps", [(1, 4800, 5), (3, 2002, 4),
                                       (2, 10, 3), (2, 24000, 64)])
def test_complex_tile_plan_matches_plain(s, t, warps):
    """The plan at the launcher's constants: every output written once,
    its window the plain version's samples bit for bit (history-fed
    first tiles, a ragged last tile, a block shorter than K-1, fewer and
    more warps than tiles), its accumulators those of the replaced
    kernel's per-output chain bit for bit, and the rotated outputs within COMPLEX_REL·max|y|
    of ``bank_complex_plain``. Split2's phase step is π per output, so
    the kernel's two phasors per slot, by the parity of n, give every
    output's exact uint32 phase."""
    rng = np.random.default_rng(s * t + warps)
    x, _, hist, grev, phase0, step = _operands(rng, s, t, "float32")
    n = t // D
    ar, ai, windows, writes = _plan(x, hist, grev.numpy(), warps)
    assert (writes == 1).all()
    z = ck.complex_z(torch.from_numpy(x), torch.from_numpy(hist)).numpy()
    want_w = np.ascontiguousarray(z[:, D * np.arange(n)[:, None]
                                    + np.arange(K)])
    assert np.array_equal(windows.view(np.uint32), want_w.view(np.uint32))
    cr, ci = _chain(z, grev.numpy(), n)
    assert np.array_equal(ar.view(np.uint32), cr.view(np.uint32))
    assert np.array_equal(ai.view(np.uint32), ci.view(np.uint32))

    assert bool(((step << 1) & U32_MASK == 0).all())
    nn = torch.arange(n)
    ramp = (phase0[:, :, None] + step[:, :, None] * nn) & U32_MASK
    assert torch.equal(ramp, (phase0[:, :, None]
                              + step[:, :, None] * (nn & 1)) & U32_MASK)
    y = rotate(torch.complex(torch.from_numpy(ar), torch.from_numpy(ai)),
               ramp)
    want = ck.bank_complex_plain(torch.from_numpy(z), grev, phase0, step, n,
                                 D)
    scale = float(want.abs().max())
    assert float((y - want).abs().max()) <= COMPLEX_REL * scale


def test_launcher_sends_split2_to_the_plan():
    """The launcher takes the plan for exactly the fast shape, which is
    SpectrumSplit2's bank, and the plan's lanes read at an odd stride."""
    assert "if (K == FAST_P * FAST_D && D == FAST_D && C == FAST_C)" in _SRC
    sp = SpectrumSplit2(2.4e6)
    assert (sp.bank.p, sp.bank.decim, sp.bank.num_slots) == (P, D, C)
    assert R % 2 == 1


@pytest.mark.parametrize("wire", ["bf16", "float32", "complex64"])
def test_wrapper_cpu_path_matches_jax_call(wire):
    """``XlatBank.__call__`` (the wrapper's CPU path) on three blocks in a
    row from a random history and uint32 phase, the second shorter than
    K-1, against the JAX ``__call__`` on the same values as complex64:
    channels within ATOL, phase and history carried exactly (the short
    block keeps the history's float32 samples in front)."""
    rng = np.random.default_rng(len(wire))
    sp = SpectrumSplit2(2.4e6)
    taps = sp.bank.taps
    offs = np.tile(sp.offsets, (2, 1))
    _, _, hist, _, phase0, _ = _operands(rng, 2, 10, wire)
    tb = XlatBank(C, D, taps)
    tst = XlatBankState(history=torch.from_numpy(hist), phase=phase0)
    jb = JBank(C, D, taps)
    jst = [JState(history=jnp.asarray(hist[i]),
                  phase=jnp.asarray(phase0[i].numpy().astype(np.uint32)))
           for i in range(2)]
    for t in (4800, 10, 2002):
        x, xw, _, _, _, _ = _operands(rng, 2, t, wire)
        tst, ty = tb(tst, xw, torch.from_numpy(offs))
        assert ty.shape == (2, C, t // D) and ty.dtype == torch.complex64
        xc = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
        for i in range(2):
            jst[i], jy = jb(jst[i], jnp.asarray(xc[i]),
                            jnp.asarray(offs[i]))
            np.testing.assert_allclose(ty[i].numpy(), np.asarray(jy),
                                       atol=ATOL)
            np.testing.assert_array_equal(
                tst.phase[i].numpy(),
                np.asarray(jst[i].phase).astype(np.int64))
            np.testing.assert_array_equal(
                tst.history[i].numpy().view(np.uint32),
                np.asarray(jst[i].history).view(np.uint32))
        assert tst.history.dtype == torch.complex64


@pytest.mark.parametrize("name,made", [
    ("r=5", "constexpr int R = 5;"), ("blocks=3", "(WARPS * 32, 3)"),
    ("taps_held", "    if (fresh) {"), ("sincos", "    if (false) {"),
    ("fma1", None)])
def test_variant_builds_change_only_their_part(name, made):
    """``tools/complex_variants.py`` rewrites the kernel's plan constants
    or one part of its work: each edited text occurs once in the source,
    so no variant silently times the package's build."""
    from radiocapture_tpu_torch.tools import complex_variants as cv
    src = (kernels.CSRC / "xlat_complex.cu").read_text()
    out = cv.variant_source(src, name)
    assert out != src
    if made is None:
        assert out.count("fmaf(") == src.count("fmaf(") - 3
    else:
        assert made in out and made not in src
