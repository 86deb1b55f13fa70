"""The complex bank kernel's general path (``csrc/xlat_complex.cu``),
emulated on the CPU against the plain version.

The launcher sends split2's shape to the fast path and every other shape
to the general path, which picks one of three plans by the slot count,
D and the shared memory the span needs:

- wide (any shape the narrow plan does not take): a block of WN × WC
  warps takes 32·WIDE_R·WN outputs × WIDE_RC·WC slots of one source; it
  stages the span of its
  outputs as D polyphase planes (plane j row m = z[(n0+m)·D + j], history
  for the first K-1 samples), and streams the taps through shared memory
  in chunks of WIDE_KC, one chunk ahead; a thread holds outputs lane +
  32·r (r < WIDE_R) of its warp's rows × its warp's WIDE_RC slots and
  walks the taps of each chunk in pairs, each (q, j) stepped on by one;
- narrow (C < WIDE_RC at D = NARROW_D): a block of NW warps takes
  32·NARROW_R·NW outputs of one source, stages the same planes, and for
  each slot in turn its taps; lane l of warp w holds the NARROW_R
  consecutive outputs from w·32·R + l·R and walks rows m of its span,
  each row feeding output r its tap row q = m - r (a partial last row: K
  % D taps); the rows where every r has a full tap row go in groups of R
  from a row m = R-1 (mod R), with tap row q held in slot q % R of a
  register window for the R rows that use it; the other rows clamp q and
  skip the taps past each r's row;
- direct (a span too large for shared memory): one thread per (output,
  slot) over a block of DIRECT_BM outputs, z read from device memory.

Each plan reads bank row s's block samples from row ``xrow[s]`` of x:
row s without a row index, the slot's bin with one (the pfb fine stage).

The CUDA kernel cannot run here: this holds its index arithmetic, at the
constants the kernel is built with (read from the ``.cu``), and its loop
order to ``bank_complex_plain``: every output is written once, its
window holds the plain version's samples bit for bit, and its
accumulators are those of one ``fmaf`` chain per output in k order (the
order of the kernel the path replaced, ``tools/xlat_complex_54b2cf5.cu``)
bit for bit, with ``fmaf`` emulated exactly in float64. Unstaged plane
rows and tap entries are NaN, so an output that read one would show."""

import re

import ml_dtypes
import numpy as np
import pytest
import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import (ControlPipeline,
                                                      SpectrumSplit2)
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.fir import phase_step_u32, rotate
from test_torch_complex_tiles import fmaf

torch.set_num_threads(1)   # six test workers share the machine

_SRC = (kernels.CSRC / "xlat_complex.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


(FAST_P, FAST_D, FAST_C, WIDE_R, WIDE_RC, WIDE_WARPS, WIDE_KC, NARROW_R,
 NARROW_WARPS, NARROW_D, DIRECT_BM, DIRECT_THREADS) = (
    _const(n) for n in ("FAST_P", "FAST_D", "FAST_C", "WIDE_R", "WIDE_RC",
                        "WIDE_WARPS", "WIDE_KC", "NARROW_R", "NARROW_WARPS",
                        "NARROW_D", "DIRECT_BM", "DIRECT_THREADS"))
H100_SMEM = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
COMPLEX_REL = 1e-4   # float32 sums in another order than the plain GEMM's
NAN = np.complex64(complex(np.nan, np.nan))


def _floats2(d: int, pitch: int) -> int:
    """``plane_floats2``: the planes' float2s, rounded up to even."""
    return (d * pitch + 1) & ~1


def plan(k: int, d: int, c: int, smem_max: int = H100_SMEM) -> dict:
    """The launcher's choice for taps K, decimation D and C slots, as
    ``launch`` and ``launch_general`` make it."""
    if (k, d, c) == (FAST_P * FAST_D, FAST_D, FAST_C):
        return {"path": "split2"}
    q = -(-k // d)
    if c < WIDE_RC and d == NARROW_D:
        for nw in range(NARROW_WARPS, 0, -1):
            nb = nw * 32 * NARROW_R
            pitch = (nb + q - 1) | 1
            smem = 8 * (_floats2(d, pitch) + q * d)
            if smem <= smem_max:
                return {"path": "narrow", "nb": nb, "pitch": pitch,
                        "threads": 32 * nw, "smem": smem}
    wc = min(WIDE_WARPS, -(-c // WIDE_RC))
    for wn in range(WIDE_WARPS // wc, 0, -1):
        nb = wn * 32 * WIDE_R
        pitch = (nb + q - 1) | 1
        smem = 8 * (_floats2(d, pitch) + 2 * wc * WIDE_RC * WIDE_KC)
        if smem <= smem_max:
            return {"path": "wide", "wn": wn, "wc": wc, "nb": nb,
                    "cb": wc * WIDE_RC, "pitch": pitch,
                    "threads": 32 * wn * wc, "smem": smem}
    return {"path": "direct"}


def _stage(xc, xrow, hist, s, n0, count, d, k, pitch, nthreads):
    """``stage_planes`` for the block (s, n0), its block samples from row
    ``xrow[s]`` of xc (``x_row``): each thread steps its (row, plane) by
    the block's thread count; returns planes [D, pitch] with NaN where
    nothing was staged."""
    span = (count - 1) * d + k
    planes = np.full((d, pitch), NAN, np.complex64)
    i = np.arange(nthreads)
    m, j = i // d, i % d
    dm, dj = divmod(nthreads, d)
    while (live := i < span).any():
        assert np.array_equal(m[live] * d + j[live], i[live])
        zi = n0 * d + i[live]
        xi = zi - (k - 1)
        assert (xi < xc.shape[1]).all()
        planes[j[live], m[live]] = np.where(
            zi < k - 1, hist[s, np.minimum(zi, k - 2)],
            xc[xrow[s], np.maximum(xi, 0)])
        i = i + nthreads
        m, j = m + dm, j + dj
        m, j = m + (j >= d), np.where(j >= d, j - d, j)
    return planes


def _fma4(ar, ai, g, z):
    """The kernel's ``fma4``: the four ``fmaf`` of one tap, in order."""
    gr, gi = g.real.astype(np.float32), g.imag.astype(np.float32)
    zr, zi = z.real.astype(np.float32), z.imag.astype(np.float32)
    ar = fmaf(gr, zr, ar)
    ar = fmaf(-gi, zi, ar)
    ai = fmaf(gr, zi, ai)
    ai = fmaf(gi, zr, ai)
    return ar, ai


class _Out:
    """The accumulators each output got, how often it was written, and
    the window slot 0 (or the first slot group) read: the plane rows a
    thread reads do not depend on its slots."""

    def __init__(self, s, c, n, k):
        self.ar = np.zeros((s, c, n), np.float32)
        self.ai = np.zeros_like(self.ar)
        self.writes = np.zeros((s, c, n), np.int64)
        self.win = np.full((s, n, k), NAN, np.complex64)   # slot 0's

    def store(self, s, cc, n, ar, ai, ok):
        s, cc, n = (np.broadcast_to(v, ok.shape)[ok] for v in (s, cc, n))
        self.ar[s, cc, n] = ar[ok]
        self.ai[s, cc, n] = ai[ok]
        np.add.at(self.writes, (s, cc, n), 1)


def _wide(xc, xrow, hist, grev, d, p, out):
    s_n, c_n, k = grev.shape
    n = xc.shape[1] // d
    nb, cb, wn_w, pitch, nt = p["nb"], p["cb"], p["wn"], p["pitch"], \
        p["threads"]
    blocks = [(s, bx * nb, by * cb) for s in range(s_n)
              for by in range(-(-c_n // cb)) for bx in range(-(-n // nb))]
    bs = np.array([b[0] for b in blocks])[:, None]
    bn0 = np.array([b[1] for b in blocks])[:, None]
    bc0 = np.array([b[2] for b in blocks])[:, None]
    count, cn = np.minimum(nb, n - bn0), np.minimum(cb, c_n - bc0)
    planes = np.stack([_stage(xc, xrow, hist, s, n0, min(nb, n - n0), d, k,
                              pitch, nt)
                       for s, n0, _ in blocks])              # [B, D, pitch]
    tid = np.arange(nt)
    lane, warp = tid % 32, tid // 32
    wn, wc = warp % wn_w, warp // wn_w
    row0 = wn * 32 * WIDE_R + lane
    active = (wc * WIDE_RC < cn) & (wn * 32 * WIDE_R < count)   # [B, nt]
    rows = row0[:, None] + 32 * np.arange(WIDE_R)                # [nt, R]
    slots = wc[:, None] * WIDE_RC + np.arange(WIDE_RC)           # [nt, RC]
    ar = np.zeros((len(blocks), nt, WIDE_R, WIDE_RC), np.float32)
    ai = np.zeros_like(ar)
    for ch in range(-(-k // WIDE_KC)):
        k0 = ch * WIDE_KC
        kc = min(WIDE_KC, k - k0)
        tb = np.full((len(blocks), cb, WIDE_KC), NAN, np.complex64)
        for b, (s, _, c0) in enumerate(blocks):
            m = min(cb, c_n - c0)
            tb[b, :m, :kc] = grev[s, c0:c0 + m, k0:k0 + kc]
        q, j = divmod(k0, d)
        for kk in range(kc):            # pairs, then an odd last tap
            zv = planes[:, j, q + rows]                      # [B, nt, R]
            gv = tb[:, slots, kk]                            # [B, nt, RC]
            ar, ai = _fma4(ar, ai, gv[:, :, None, :], zv[..., None])
            # wc = 0 warps' windows (the others read the same rows)
            own = active[:, :, None] & (wc == 0)[None, :, None] \
                & (rows < count[:, :, None])
            bi, ti, ri = np.nonzero(own)
            out.win[bs[bi, 0], bn0[bi, 0] + rows[ti, ri], k0 + kk] = \
                zv[bi, ti, ri]
            j += 1
            if j == d:
                j, q = 0, q + 1
    ok = (active[:, :, None, None] & (rows < count[:, :, None])[..., None]
          & (slots[None, :, None, :] < cn[:, :, None, None]))
    out.store(bs[:, :, None, None], bc0[:, :, None, None]
              + slots[None, :, None, :], bn0[:, :, None, None]
              + rows[None, :, :, None], ar, ai, ok)


def _narrow(xc, xrow, hist, grev, d, p, out):
    s_n, c_n, k = grev.shape
    n = xc.shape[1] // d
    nb, pitch, nt, rr = p["nb"], p["pitch"], p["threads"], NARROW_R
    big_q = -(-k // d)
    jl = k - (big_q - 1) * d
    qf = big_q if jl == d else big_q - 1          # full tap rows
    blocks = [(s, bx * nb) for s in range(s_n) for bx in range(-(-n // nb))]
    bs = np.array([b[0] for b in blocks])[:, None]
    bn0 = np.array([b[1] for b in blocks])[:, None]
    count = np.minimum(nb, n - bn0)
    planes = np.stack([_stage(xc, xrow, hist, s, n0, min(nb, n - n0), d, k,
                              pitch, nt) for s, n0 in blocks])
    tid = np.arange(nt)
    base = (tid // 32) * 32 * rr + (tid % 32) * rr
    active = (tid // 32) * 32 * rr < count                      # [B, nt]
    for c in range(c_n):
        taps = np.full((len(blocks), big_q * d), NAN, np.complex64)
        taps[:, :k] = grev[bs[:, 0], c]                   # [B, Q·D], K staged
        ar = np.zeros((len(blocks), nt, rr), np.float32)
        ai = np.zeros_like(ar)

        def tap(r, kt, g, zv):
            """fma4 of tap kt (value g [B]) into output r; slot 0 records
            the window."""
            ar[..., r], ai[..., r] = _fma4(ar[..., r], ai[..., r],
                                           g[:, None], zv)
            if c == 0:
                bi, ti = np.nonzero(active & (base + r < count))
                out.win[bs[bi, 0], bn0[bi, 0] + base[ti] + r, kt] = \
                    zv[bi, ti]

        def edge_row(m):                   # q clamped, taps past a row skipped
            zr = planes[:, :, base + m]                          # [B, D, nt]
            q = m - np.arange(rr)
            lim = np.where((q < 0) | (q >= big_q), 0,
                           np.where(q < big_q - 1, d, jl))
            qc = np.clip(q, 0, big_q - 1)
            for j in range(0, d, 2):
                for r in range(rr):
                    for jj in (j, j + 1):
                        if jj < lim[r]:
                            tap(r, q[r] * d + jj, taps[:, qc[r] * d + jj],
                                zr[:, jj])

        m = 0
        while m < rr - 1:
            edge_row(m)
            m += 1
        if m + rr <= qf:                   # tap rows in a register window
            gw = [None] * rr               # slot q % R: (row q, its taps)
            for q in range(rr - 1):
                gw[q] = (q, taps[:, q * d:(q + 1) * d])
            while m + rr <= qf:
                assert m % rr == rr - 1
                for u in range(rr):
                    mm = m + u
                    gw[(rr - 1 + u) % rr] = (mm, taps[:, mm * d:(mm + 1) * d])
                    zr = planes[:, :, base + mm]
                    for j in range(d):
                        for r in range(rr):
                            row, g = gw[(rr - 1 + u - r) % rr]
                            assert row == mm - r
                            tap(r, row * d + j, g[:, j], zr[:, j])
                m += rr
        while m < rr + big_q - 1:
            edge_row(m)
            m += 1
        rows = base[:, None] + np.arange(rr)                     # [nt, R]
        ok = active[..., None] & (rows < count[..., None])
        out.store(bs[..., None], c, bn0[..., None] + rows, ar, ai, ok)


def _direct(xc, xrow, hist, grev, d, out):
    s_n, c_n, k = grev.shape
    n = xc.shape[1] // d
    for s in range(s_n):
        for n0 in range(0, n, DIRECT_BM):
            rows = min(DIRECT_BM, n - n0)
            idx = np.arange(rows * c_n)       # each thread's strided share
            c, r = idx // rows, idx % rows
            ar = np.zeros(len(idx), np.float32)
            ai = np.zeros_like(ar)
            for kk in range(k):
                zi = (n0 + r) * d + kk
                zv = np.where(zi < k - 1, hist[s, np.minimum(zi, k - 2)],
                              xc[xrow[s], np.maximum(zi - (k - 1), 0)])
                ar, ai = _fma4(ar, ai, grev[s, c, kk], zv)
                out.win[s, (n0 + r)[c == 0], kk] = zv[c == 0]
            out.store(s, c, n0 + r, ar, ai, np.ones(len(idx), bool))


def _chain(z, grev, n, d):
    """One ``fmaf`` chain per output and slot in k order, the replaced
    kernel's: accumulators [S, C, n] from z [S, L] complex64."""
    s_n, c_n, k = grev.shape
    ar = np.zeros((s_n, c_n, n), np.float32)
    ai = np.zeros_like(ar)
    for kk in range(k):
        zk = z[:, kk + d * np.arange(n)][:, None, :]
        ar, ai = _fma4(ar, ai, grev[:, :, kk][..., None], zk)
    return ar, ai


def _operands(rng, s, n, k, d, c, wire, r=None):
    """The bank's operands for S bank rows: x [R, N·D, 2] (R = S without
    a row index), history, taps, phase and step."""
    x = rng.standard_normal((r or s, n * d, 2)).astype(np.float32)
    if wire == "bf16":
        x = wire_from_numpy(x.astype(ml_dtypes.bfloat16), "cpu").float() \
            .numpy()
    hist = (rng.standard_normal((s, k - 1))
            + 1j * rng.standard_normal((s, k - 1))).astype(np.complex64)
    grev = ((rng.standard_normal((s, c, k)) + 1j
             * rng.standard_normal((s, c, k))) * k ** -0.5).astype(
        np.complex64)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, c)))
    offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (s, c)).astype(
        np.float32))
    return x, hist, grev, phase0, phase_step_u32(offs, d)


@pytest.mark.parametrize("path,s,n,k,d,c,wire,smem", [
    ("wide", 1, 150, 1440, 96, 64, "float32", H100_SMEM),
    ("wide", 1, 150, 1440, 96, 40, "bf16", H100_SMEM),
    ("wide", 2, 5, 1440, 96, 64, "float32", H100_SMEM),
    ("wide", 2, 333, 47, 3, 12, "float32", H100_SMEM),
    ("narrow", 3, 700, 467, 16, 1, "float32", H100_SMEM),
    ("narrow", 2, 5, 467, 16, 1, "bf16", H100_SMEM),
    ("wide", 2, 50, 21, 5, 3, "float32", H100_SMEM),
    ("narrow", 2, 300, 467, 16, 3, "bf16", H100_SMEM),
    ("direct", 2, 40, 31, 3, 2, "float32", 0)])
def test_general_plan_matches_plain(path, s, n, k, d, c, wire, smem):
    """Each plan at the launcher's constants: the mesh step's C = 64 and the
    card tests' C = 40 (five slot groups) at K = 1440, D = 96 and a ragged
    N; a block shorter than K-1 (N = 5); K % D ≠ 0 with an odd D, an odd
    chunk and a part-filled slot tile; the pfb fine stage's C = 1, K = 467,
    D = 16 over a ragged last block and with three slots; a few slots at
    another D on the wide plan; the direct kernel (forced by a card with no
    shared memory). Every output written once, its window the plain
    version's samples, its accumulators the replaced kernel's chain bit for
    bit, its rotated value within COMPLEX_REL·max|y| of
    ``bank_complex_plain``."""
    check_plan(path, s, n, k, d, c, wire, smem)


@pytest.mark.parametrize("path,s,r,n,k,d,c,wire,smem,order", [
    ("narrow", 6, 4, 300, 467, 16, 1, "float32", H100_SMEM, "permuted"),
    ("narrow", 5, 2, 5, 467, 16, 1, "float32", H100_SMEM, "repeated"),
    ("narrow", 4, 3, 333, 467, 16, 3, "bf16", H100_SMEM, "repeated"),
    ("wide", 3, 3, 150, 1440, 96, 40, "float32", H100_SMEM, "permuted"),
    ("wide", 4, 2, 333, 47, 3, 12, "bf16", H100_SMEM, "repeated"),
    ("direct", 3, 2, 40, 31, 3, 2, "float32", 0, "repeated")])
def test_general_plan_reads_through_row_index(path, s, r, n, k, d, c, wire,
                                              smem, order):
    """Each plan with a row index (``x_row``): bank row s stages its block
    samples from row ``xrow[s]`` of an R-row block, the index a
    permutation of the rows or repeating rows (every slot of the pfb fine
    stage on one bin); history, taps and phase stay row s's. The same
    checks as ``test_general_plan_matches_plain``, against the plain
    version on the gathered rows."""
    rng = np.random.default_rng(r + n + k)
    xrow = (rng.permutation(s) % r if order == "permuted"
            else rng.integers(0, r, s))
    if order == "repeated":
        xrow[: 2] = xrow[0]
    check_plan(path, s, n, k, d, c, wire, smem, xrow, r)


def check_plan(path, s, n, k, d, c, wire, smem, xrow=None, r=None):
    """The emulated plan ``path`` against the plain version and the
    replaced kernel's chain, bank row s reading x row ``xrow[s]``."""
    rng = np.random.default_rng(n + k + c)
    x, hist, grev, phase0, step = _operands(rng, s, n, k, d, c, wire, r)
    xrow = np.arange(s) if xrow is None else np.asarray(xrow)
    p = plan(k, d, c, smem)
    assert p["path"] == path
    xc = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    out = _Out(s, c, n, k)
    with np.errstate(invalid="ignore"):
        if path == "wide":
            _wide(xc, xrow, hist, grev, d, p, out)
        elif path == "narrow":
            _narrow(xc, xrow, hist, grev, d, p, out)
        else:
            _direct(xc, xrow, hist, grev, d, out)
    assert (out.writes == 1).all()
    z = ck.complex_z(torch.from_numpy(x[xrow]), torch.from_numpy(hist)
                     ).numpy()
    want_w = z[:, d * np.arange(n)[:, None] + np.arange(k)]       # [S, n, K]
    assert np.array_equal(out.win.view(np.uint32),
                          np.ascontiguousarray(want_w).view(np.uint32))
    cr, ci = _chain(z, grev, n, d)
    assert np.array_equal(out.ar.view(np.uint32), cr.view(np.uint32))
    assert np.array_equal(out.ai.view(np.uint32), ci.view(np.uint32))
    ramp = (phase0[:, :, None] + step[:, :, None] * torch.arange(n)) \
        & 0xFFFFFFFF
    y = rotate(torch.complex(torch.from_numpy(out.ar),
                             torch.from_numpy(out.ai)), ramp)
    want = ck.bank_complex_plain(torch.from_numpy(z), torch.from_numpy(grev),
                                 phase0, step, n, d)
    assert float((y - want).abs().max()) <= COMPLEX_REL * float(
        want.abs().max())


def _pfb_fine():
    bank = ControlPipeline.p25_c4fm(64, 2.4e6, frontend="pfb").bank
    return bank.ntaps2, bank.decim2, 1


def _mesh():
    bank = ControlPipeline.p25_c4fm(64, 2.4e6).bank
    return bank.ntaps, bank.decim, 64


@pytest.mark.parametrize("shape,want", [
    ("split2", {"path": "split2"}),
    ((FAST_P * FAST_D, FAST_D, FAST_C + 1), {"path": "wide", "wc": 1}),
    ((FAST_P * FAST_D + FAST_D, FAST_D, FAST_C), {"path": "wide"}),
    ((FAST_P * FAST_D, 2 * FAST_D, FAST_C), {"path": "wide"}),
    ((467, 16, 7), {"path": "narrow"}), ((467, 16, 8), {"path": "wide"}),
    ("mesh", {"path": "wide", "wn": 1, "wc": 8, "nb": 128, "cb": 64,
              "pitch": 143, "threads": 256}),
    ((1440, 96, 40), {"path": "wide", "wn": 1, "wc": 5, "threads": 160}),
    ((1440, 96, 8), {"path": "wide", "wn": 2, "wc": 1, "threads": 64}),
    ((20, 2, 8), {"path": "wide", "wn": 8, "wc": 1, "nb": 1024}),
    ("pfb", {"path": "narrow", "nb": 384, "pitch": 413, "threads": 128}),
    ((30000, 1, 1), {"path": "direct"}),
    ((30000, 1, 64), {"path": "direct"})])
def test_launcher_sends_each_shape_to_its_path(shape, want):
    """Split2's bank (K = 20, D = 2, C = 2) and no other shape takes the
    fast path; the mesh step's bank takes the wide plan in one 256-thread
    block of 128 outputs × 64 slots per source tile (planes at pitch 143,
    ~208 KB with the tap chunks), the pfb fine stage the narrow plan
    (384 outputs a block, ~57 KB: three blocks an SM), few slots at
    another D the wide plan, and a span that fits no shared memory the
    direct kernel."""
    if shape == "split2":
        sp = SpectrumSplit2(2.4e6)
        shape = (sp.bank.ntaps, sp.bank.decim, sp.bank.num_slots)
    elif shape in ("mesh", "pfb"):
        shape = _mesh() if shape == "mesh" else _pfb_fine()
    p = plan(*shape)
    assert {key: p[key] for key in want} == want
    if p["path"] in ("wide", "narrow"):
        assert p["smem"] <= H100_SMEM and p["pitch"] % 2 == 1
    if shape == _pfb_fine():    # three blocks an SM: 228 KB, 1 KB each kept
        assert 3 * (p["smem"] + 1024) <= 228 * 1024


def test_plan_model_reads_the_launcher():
    """``plan`` models these lines of the launcher, and ``_stage`` the
    row index's address in each general plan; a change there must change
    the model too."""
    for line in (
            "if (K == FAST_P * FAST_D && D == FAST_D && C == FAST_C)",
            "if (C < WIDE_RC && D == NARROW_D) {",
            "const int wc = min(WIDE_WARPS, (C + WIDE_RC - 1) / WIDE_RC);",
            "for (int wn = WIDE_WARPS / wc; wn >= 1; --wn) {",
            "const int nb = wn * 32 * WIDE_R, pitch = (nb + Q - 1) | 1;",
            "plane_floats2(D, pitch) + 2 * wc * WIDE_RC * WIDE_KC);",
            "for (int nw = NARROW_WARPS; nw >= 1; --nw) {",
            "const int nb = nw * 32 * NARROW_R, pitch = (nb + Q - 1) | 1;",
            "sizeof(float2) * (size_t)narrow_floats2(D, pitch, Q);",
            "return plane_floats2(D, pitch) + Q * D;",
            "return (D * pitch + 1) & ~1;",
            "return x + __ldg(xrow + s) * T;",
            "return x + (long long)s * T;"):
        assert line in _SRC, line
    # every general plan stages through the row index, split2 refuses one
    assert _SRC.count("x_row<kRows>(x, xrow, s, T)") == 3
    assert "if (xrow) return (int)cudaErrorInvalidValue;" in _SRC
