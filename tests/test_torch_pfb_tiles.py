"""The pfb combiner kernel's plan (``csrc/pfb_rows.cu``), emulated on the
CPU.

The plan: a block per (source, tile of R = 32·K·slabs rows, group of at
most MB_MAX branches), the launcher's choice of groups and slabs; the
tile's span of history ++ block staged into float32 planes, the wire in
16-byte vectors aligned to the block's address (partial vectors at the
ends sample by sample); one warp per (branch, slab), lane l computing
rows K·l .. K·l+K-1 from a register window of K+Q-1 plane rows that
carries its K-1 lowest rows from one Q-tap window to the next, the last
window guarded; the sums staged flipped and stored as rows; the new
history from the source's last tile. The CUDA kernel cannot run here:
this holds the index arithmetic, at the constants the kernel is built
with, to one ``fmaf`` chain per output in q order (what the kernel and
the eager chain compute on the card) bit for bit, every output and
history sample written once, and to ``pfb_rows_plain`` on the CPU.
"""

import re

import numpy as np
import pytest
import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.channelizer import PfbChannelizer
from test_torch_complex_tiles import fmaf

torch.set_num_threads(1)   # six test workers share the machine

_SRC = (kernels.CSRC / "pfb_rows.cu").read_text()
Q, MB_MAX, WARPS_MAX = (int(re.search(rf"constexpr int {name} = (\d+);",
                                      _SRC).group(1))
                        for name in ("Q", "MB_MAX", "WARPS_MAX"))
WIRE_K = {wire: int(re.search(rf"struct {wire} {{.*?static constexpr int "
                              rf"K = (\d+);", _SRC, re.S).group(1))
          for wire in ("Bf16Wire", "F32Wire")}
WIRE_VEC = {"Bf16Wire": 4, "F32Wire": 2}   # samples per 16-byte vector
# the CPU's eager chain rounds each product apart; the kernel's fma once
PLAIN_REL = 1e-6


def plan(t, m, p, k):
    """The launcher's plan: (groups, branches a block, slabs, R, n,
    tiles)."""
    groups = -(-m // MB_MAX)
    mb_w = -(-m // groups)
    slabs = 1 if mb_w >= WARPS_MAX else WARPS_MAX // mb_w
    r = slabs * 32 * k
    n = t // m
    return groups, mb_w, slabs, r, n, (-(-n // r) if n else 1)


def _complex(x):
    """The block as numpy complex64 [S, T] (bf16 → float32 is exact)."""
    if x.is_complex():
        return x.numpy()
    xf = x.float().numpy()
    return (xf[..., 0] + 1j * xf[..., 1]).astype(np.complex64)


def stage(z, s, t, m, p, t0, span, mb, mb_n, pitch, vec, off):
    """The block's planes [mb_n, pitch] from source s's z = history ++
    block (flat complex64), as the kernel's ``stage`` fills them (NaN where
    it writes nothing); ``off`` is the sample offset of the source's block
    from a 16-byte boundary."""
    h = (p - 1) * m
    planes = np.full((mb_n, pitch), np.nan, np.complex64)
    writes = np.zeros((mb_n, pitch), np.int64)

    def put(i):
        r, c = divmod(i, m)
        if mb <= c < mb + mb_n:
            planes[c - mb, r - t0] = z[s, i]
            writes[c - mb, r - t0] += 1

    z0, z1 = t0 * m, (t0 + span) * m
    for i in range(z0, min(z1, h)):
        put(i)
    j0, j1 = max(z0, h) - h, z1 - h
    if j0 < j1:
        for v in range((j0 + off) // vec, (j1 - 1 + off) // vec + 1):
            b = v * vec - off
            for kk in range(vec):     # a whole vector or the in-range part
                if j0 <= b + kk < j1:
                    put(h + b + kk)
    assert writes.max() <= 1
    return planes


def branch_sums(pl, hq, base, p, k):
    """A warp's sums of one branch (the kernel's ``branch_sums``), lane l
    at row base[l]: the first tap's products, then Q-tap register windows
    carrying their K-1 lowest rows, the last window guarded. Returns (the
    rows [32, K], their sums complex64)."""
    rows = base[:, None] + np.arange(k)
    first = pl[rows + p - 1]
    re = first.real * hq[0]          # float32 products
    im = first.imag * hq[0]
    w = np.zeros((len(base), k + Q - 1), np.complex64)
    w[:, Q:Q + k - 1] = first[:, :k - 1]
    q0 = 1
    while q0 < p:
        guard = q0 + Q > p
        idx = (base + p - 1 - (q0 + Q - 1))[:, None] + np.arange(Q)
        if guard:
            idx = np.maximum(idx, 0)
        assert 0 <= idx.min() and idx.max() < len(pl)
        w[:, :Q] = pl[idx]
        for q in range(Q):
            if guard and q0 + q >= p:
                continue
            win = w[:, Q - 1 - q:Q - 1 - q + k]
            c = np.float32(hq[q0 + q])
            re = fmaf(win.real, c, re)
            im = fmaf(win.imag, c, im)
        w[:, Q:Q + k - 1] = w[:, :k - 1].copy()
        q0 += Q
    return rows, (re + 1j * im).astype(np.complex64)


def emulate(hist, x, hp2, wire, base_off):
    """``pfb_rows`` as the kernel's plan computes it: (v, new history,
    per-output write counts)."""
    s_n, h = hist.shape
    m, p = hp2.shape
    xc = _complex(x)
    t = xc.shape[1]
    z = np.concatenate([hist.numpy(), xc], axis=1)
    k, vec = WIRE_K[wire], WIRE_VEC[wire]
    groups, mb_w, slabs, r_rows, n, tiles = plan(t, m, p, k)
    taps = hp2.numpy()
    v = np.full((s_n, n, m), np.nan, np.complex64)
    count = np.zeros((s_n, n, m), np.int64)
    nh = np.full((s_n, h), np.nan, np.complex64)
    pitch = r_rows + p - 1
    lanes = np.arange(32)
    for s in range(s_n):
        off = (base_off + s * t) % vec
        for tile in range(tiles):
            t0 = tile * r_rows
            if tile == tiles - 1:
                nh[s] = z[s, n * m:n * m + h]
            span = min(r_rows + p - 1, n + p - 1 - t0)
            for grp in range(groups):
                mb = grp * mb_w
                mb_n = min(mb_w, m - mb)
                planes = stage(z, s, t, m, p, t0, span, mb, mb_n, pitch, vec,
                               off)
                out = np.full(r_rows * mb_w, np.nan, np.complex64)
                for warp in range(mb_w * slabs):
                    ml, slab = warp % mb_w, warp // mb_w
                    if ml >= mb_n or t0 + slab * 32 * k >= n:
                        continue
                    rows, val = branch_sums(planes[ml], taps[mb + ml],
                                            slab * 32 * k + lanes * k, p, k)
                    out[rows * mb_w + (mb_w - 1 - ml)] = val
                rows_out = min(r_rows, n - t0)
                if mb_w == m:
                    idx = np.arange(rows_out * m)
                    v[s, t0 + idx // m, idx % m] = out[idx]
                    count[s, t0 + idx // m, idx % m] += 1
                else:
                    col = m - mb - mb_w
                    for i in range(max(rows_out, 0) * mb_w):
                        rr, c = divmod(i, mb_w)
                        if col + c >= 0:
                            v[s, t0 + rr, col + c] = out[i]
                            count[s, t0 + rr, col + c] += 1
    return v, nh, count


def fmaf_chain(hist, x, hp2):
    """One ``fmaf`` chain per output, q ascending from one product: the
    rows v [S, n, M], flipped, from the definition."""
    m, p = hp2.shape
    xc = _complex(x)
    z = np.concatenate([hist.numpy(), xc], axis=1)
    n = xc.shape[1] // m
    zr = z.reshape(z.shape[0], n + p - 1, m)
    h = hp2.numpy()
    re = zr[:, p - 1:p - 1 + n].real * h[:, 0]
    im = zr[:, p - 1:p - 1 + n].imag * h[:, 0]
    for q in range(1, p):
        zq = zr[:, p - 1 - q:p - 1 - q + n]
        re = fmaf(zq.real, h[:, q], re)
        im = fmaf(zq.imag, h[:, q], im)
    v = (re + 1j * im).astype(np.complex64)
    return np.ascontiguousarray(v[..., ::-1])


# (fs, M, atten dB, sources, samples, wire): the bench bank at a few
# tiles and a partial one, M = 3 (two slabs a block), the tests' M = 8 and
# 16 banks, M = 17 and 40 (branch groups, a short last group), a block of
# 10 rows (< P-1) and an empty one
CASES = [(2.4e6, 6, 80.0, 2, 6 * 800, "bf16"),
         (2.4e6, 6, 80.0, 2, 6 * 500, "f32"),
         (1.2e6, 3, 80.0, 2, 3 * 1000, "bf16"),
         (800e3, 8, 60.0, 2, 8 * 300, "c64"),
         (1.6e6, 16, 60.0, 1, 16 * 250, "f32"),
         (6.8e6, 17, 60.0, 1, 17 * 300, "bf16"),
         (16e6, 40, 60.0, 1, 40 * 100, "c64"),
         (2.4e6, 6, 80.0, 3, 60, "bf16"),
         (2.4e6, 6, 80.0, 2, 0, "f32")]


@pytest.mark.parametrize("fs,m,atten,s,t,wire", CASES)
@pytest.mark.parametrize("base_off", [0, 1])
def test_plan_matches_the_fmaf_chain(fs, m, atten, s, t, wire, base_off):
    """Every output and history sample written once; the rows equal one
    ``fmaf`` chain per output bit for bit, and ``pfb_rows_plain`` within
    PLAIN_REL·max|v| (the CPU rounds each product apart); the block at a
    16-byte boundary and one sample past it."""
    pfb = PfbChannelizer.for_rates(fs, m, atten_db=atten)
    rng = np.random.default_rng(m * 1000 + t + base_off)
    hist = torch.from_numpy((rng.standard_normal((s, (pfb.p - 1) * m))
                             + 1j * rng.standard_normal(
                                 (s, (pfb.p - 1) * m))).astype(np.complex64))
    x = torch.empty((s, t, 2)).copy_(torch.from_numpy(
        rng.standard_normal((s, t, 2)).astype(np.float32)))
    if wire == "bf16":
        x = x.to(torch.bfloat16)
    elif wire == "c64":
        x = torch.view_as_complex(x)
    hp2 = pfb.device_hp2("cpu")
    v, nh, count = emulate(hist, x, hp2,
                           "Bf16Wire" if wire == "bf16" else "F32Wire",
                           base_off)
    assert (count == 1).all()
    want_v, want_h = pk.pfb_rows_plain(hist, x, hp2)
    np.testing.assert_array_equal(nh.view(np.int32),
                                  want_h.numpy().view(np.int32))
    np.testing.assert_array_equal(v.view(np.int32),
                                  fmaf_chain(hist, x, hp2).view(np.int32))
    if t:
        scale = float(want_v.abs().max())
        np.testing.assert_allclose(v, want_v.numpy(), rtol=0,
                                   atol=PLAIN_REL * scale)


def test_plan_constants():
    """The plan the emulation reads: odd K per wire (conflict-free lane
    loads at stride K), blocks within the kernel's 32·MB_MAX threads."""
    assert all(k % 2 == 1 for k in WIRE_K.values())
    assert f"__launch_bounds__(32 * MB_MAX, 2)" in _SRC
    for m in range(1, 70):
        groups, mb_w, slabs, *_ = plan(1, m, 24, 7)
        assert mb_w <= MB_MAX and (groups - 1) * mb_w < m
        assert 32 * mb_w * slabs <= 32 * MB_MAX
