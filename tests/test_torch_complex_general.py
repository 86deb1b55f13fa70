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
  32·NARROW_R·NW outputs of up to NARROW_ROWS bank rows (fewer rows, and
  fewer warps, where the shape's rows and tiles would leave the card's
  SMs idle), item by item (a row's slots), the rows reading one x row
  one after another (``narrow_order``); it stages that x row's planes
  once and copies in only the span's history part for each next row
  (``_narrow_units``), through a side buffer or, where two tap buffers
  do not fit, straight into the planes, and each item's taps; lane l of
  warp w holds the NARROW_R consecutive
  outputs from w·32·R + l·R and walks the tap rows q, row q + r of its
  span feeding output r from a register window of R plane rows (row m
  in slot m % R), which takes row q + R-1 as tap row q begins; the tap
  rows go in groups of R from 0, so every slot is a constant, and the
  last group checks its bounds (a partial last row: K % D taps);
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
 NARROW_WARPS, NARROW_BLOCKS, NARROW_ROWS, NARROW_D, DIRECT_BM,
 DIRECT_THREADS) = (
    _const(n) for n in ("FAST_P", "FAST_D", "FAST_C", "WIDE_R", "WIDE_RC",
                        "WIDE_WARPS", "WIDE_KC", "NARROW_R", "NARROW_WARPS",
                        "NARROW_BLOCKS", "NARROW_ROWS", "NARROW_D",
                        "DIRECT_BM", "DIRECT_THREADS"))
H100_SMEM = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SM_SMEM = 233472   # cudaDevAttrMaxSharedMemoryPerMultiprocessor
H100_SMS = 132       # cudaDevAttrMultiProcessorCount on an H100 SXM
BENCH_S, BENCH_N = 8192, 2500   # the pfb fine stage's rows and outputs
COMPLEX_REL = 1e-4   # float32 sums in another order than the plain GEMM's
NAN = np.complex64(complex(np.nan, np.nan))


def _floats2(d: int, pitch: int) -> int:
    """``plane_floats2``: the planes' float2s, rounded up to even."""
    return (d * pitch + 1) & ~1


def plan(k: int, d: int, c: int, smem_max: int = H100_SMEM,
         s: int = BENCH_S, n: int = BENCH_N, sms: int = H100_SMS) -> dict:
    """The launcher's choice for taps K, decimation D and C slots over S
    bank rows of N outputs on a card of ``sms`` SMs, as ``launch`` and
    ``launch_general`` make it."""
    if (k, d, c) == (FAST_P * FAST_D, FAST_D, FAST_C):
        return {"path": "split2"}
    q = -(-k // d)
    if c < WIDE_RC and d == NARROW_D:
        best = None
        for bufs in (2, 1):
            for nw in range(NARROW_WARPS, 0, -1):
                nb = nw * 32 * NARROW_R
                pitch = (nb + q - 1) | 1
                smem = (8 * (_floats2(d, pitch) + bufs * q * d
                             + (((k + 1) & ~1) if bufs == 2 else 0))
                        + NARROW_ROWS * 16)
                if smem > smem_max:
                    continue
                tiles = max(1, -(-n // nb))
                per_sm = max(1, min(NARROW_WARPS * NARROW_BLOCKS // nw,
                                    H100_SM_SMEM // (smem + 1024)))
                cap = sms * per_sm
                waves = max(1, -(-(tiles * -(-s // NARROW_ROWS)) // cap))
                groups = max(1, waves * cap // tiles)
                rows = max(1, -(-s // groups))
                blocks = tiles * -(-s // rows)
                load = -(-blocks // sms) * rows * (min(nb, n) + q - 1)
                if best is None or load < best["load"]:
                    best = {"path": "narrow", "nb": nb, "pitch": pitch,
                            "threads": 32 * nw, "smem": smem, "bufs": bufs,
                            "rows": rows, "load": load,
                            "blocks": blocks}
            if best is not None:
                return best
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


def narrow_order(xr) -> list:
    """The narrow kernel's order of a block's rows, given the x row each
    reads: by the first row reading the same x row, then by row."""
    first = [next(j for j in range(i + 1) if xr[j] == xr[i])
             for i in range(len(xr))]
    order = [0] * len(xr)
    for i in range(len(xr)):
        order[sum(first[j] < first[i] or (first[j] == first[i] and j < i)
                  for j in range(len(xr)))] = i
    return order


def _narrow_units(xc, xrow, hist, k, d, c_n, nb, pitch, nt, rows):
    """The narrow kernel's work, block by block: a block takes one tile of
    nb outputs of ``rows`` bank rows, its items (slot c of each row, in
    ``narrow_order``) one after another; the planes are staged whole when
    an item's x row differs from the item's before it, else the rows'
    history part (the span's first hn samples) is copied over them when
    the bank row changes. Each item's planes must be what staging its own
    row whole gives. Returns [(s, c, n0, count, planes)]."""
    s_n = hist.shape[0]
    n = xc.shape[1] // d
    units = []
    for s0 in range(0, s_n, rows):
        xr = list(xrow[s0:s0 + rows])
        order = narrow_order(xr)
        for n0 in range(0, n, nb):
            count = min(nb, n - n0)
            z0, span = n0 * d, (count - 1) * d + k
            hn = min(max(k - 1 - z0, 0), span)
            planes, prev = None, None
            for it in range(len(xr) * c_n):
                r = order[it // c_n]
                if it == 0 or xr[r] != xr[prev]:
                    planes = _stage(xc, xrow, hist, s0 + r, n0, count, d, k,
                                    pitch, nt)
                elif r != prev and hn > 0:
                    planes = planes.copy()
                    i = np.arange(hn)
                    planes[i % d, i // d] = hist[s0 + r, z0 + i]
                own = _stage(xc, xrow, hist, s0 + r, n0, count, d, k, pitch,
                             nt)
                assert np.array_equal(planes.view(np.uint32),
                                      own.view(np.uint32))
                units.append((s0 + r, it % c_n, n0, count, planes))
                prev = r
    return units


def _narrow(xc, xrow, hist, grev, d, p, out):
    s_n, c_n, k = grev.shape
    nb, pitch, nt, rr = p["nb"], p["pitch"], p["threads"], NARROW_R
    big_q = -(-k // d)
    jl = k - (big_q - 1) * d
    qf = big_q if jl == d else big_q - 1          # full tap rows
    units = _narrow_units(xc, xrow, hist, k, d, c_n, nb, pitch, nt,
                          p["rows"])
    us, uc, un0, count = (np.array([u[i] for u in units])[:, None]
                          for i in range(4))
    planes = np.stack([u[4] for u in units])              # [U, D, pitch]
    tid = np.arange(nt)
    base = (tid // 32) * 32 * rr + (tid % 32) * rr
    assert (base + big_q + rr - 2 < pitch).all()   # the rows a lane reads
    active = (tid // 32) * 32 * rr < count                      # [U, nt]
    taps = np.full((len(units), big_q * d), NAN, np.complex64)
    taps[:, :k] = grev[us[:, 0], uc[:, 0]]                # [U, Q·D], K staged
    ar = np.zeros((len(units), nt, rr), np.float32)
    ai = np.zeros_like(ar)
    zw = [None] * rr            # slot m % R: (plane row m, [U, D, nt])
    record = active & (uc == 0)           # slot 0 records the window

    def load(m, slot):
        assert slot == m % rr
        zw[slot] = (m, planes[:, :, base + m])

    def tap_row(u, q, lim):
        """Tap row q (its first lim taps) into every output: row q + r of
        the window feeds output r, the row entering at q being q + R-1;
        per accumulator j ascending."""
        load(q + rr - 1, (u + rr - 1) % rr)
        for j in range(0, d, 2):
            for r in range(rr):
                row, zv = zw[(u + r) % rr]
                assert row == q + r
                for jj in (j, j + 1):
                    if jj < lim:
                        kt = q * d + jj
                        ar[..., r], ai[..., r] = _fma4(
                            ar[..., r], ai[..., r], taps[:, kt][:, None],
                            zv[:, jj])
                        bi, ti = np.nonzero(record & (base + r < count))
                        out.win[us[bi, 0], un0[bi, 0] + base[ti] + r,
                                kt] = zv[bi, jj, ti]

    for m in range(rr - 1):
        load(m, m)
    q = 0
    while q + rr <= qf:                    # whole groups of R tap rows
        for u in range(rr):
            tap_row(u, q + u, d)
        q += rr
    for u in range(rr):                    # the last group, bounds checked
        if q + u < big_q:
            tap_row(u, q + u, d if q + u < qf else jl)
    rows = base[:, None] + np.arange(rr)                         # [nt, R]
    ok = active[..., None] & (rows < count[..., None])
    out.store(us[..., None], uc[..., None], un0[..., None] + rows, ar, ai,
              ok)


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
    ("narrow", 1, 700, 400, 16, 2, "float32", H100_SMEM),
    ("narrow", 2, 650, 480, 16, 4, "bf16", H100_SMEM),
    ("narrow", 2, 90, 33, 16, 5, "float32", H100_SMEM),
    ("narrow", 1, 170, 47, 16, 6, "bf16", H100_SMEM),
    ("narrow", 2, 41, 95, 16, 7, "float32", H100_SMEM),
    ("direct", 2, 40, 31, 3, 2, "float32", 0)])
def test_general_plan_matches_plain(path, s, n, k, d, c, wire, smem):
    """Each plan at the launcher's constants: the mesh step's C = 64 and the
    card tests' C = 40 (five slot groups) at K = 1440, D = 96 and a ragged
    N; a block shorter than K-1 (N = 5); K % D ≠ 0 with an odd D, an odd
    chunk and a part-filled slot tile; the pfb fine stage's C = 1, K = 467,
    D = 16 over a ragged last block and with three slots; the narrow plan at
    C = 2 to 7 with K % D = 0 (400: whole groups of tap rows; 480: a last
    group of whole rows) and K % D ≠ 0 (33: every tap row in the last
    group; 47, 95), bf16 and float32; a few slots at another D on the
    wide plan; the direct kernel (forced by a card with no shared
    memory). Every output written once, its window the plain
    version's samples, its accumulators the replaced kernel's chain bit for
    bit, its rotated value within COMPLEX_REL·max|y| of
    ``bank_complex_plain``."""
    check_plan(path, s, n, k, d, c, wire, smem)


@pytest.mark.parametrize("path,s,r,n,k,d,c,wire,smem,order", [
    ("narrow", 6, 4, 300, 467, 16, 1, "float32", H100_SMEM, "permuted"),
    ("narrow", 5, 2, 5, 467, 16, 1, "float32", H100_SMEM, "repeated"),
    ("narrow", 4, 3, 333, 467, 16, 3, "bf16", H100_SMEM, "repeated"),
    ("narrow", 3, 2, 150, 47, 16, 2, "bf16", H100_SMEM, "permuted"),
    ("narrow", 70, 5, 20, 47, 16, 1, "float32", H100_SMEM, "permuted"),
    ("narrow", 4, 3, 70, 480, 16, 4, "float32", H100_SMEM, "repeated"),
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


@pytest.mark.parametrize("s,r,n,k,c,wire,smem,sms,want", [
    (6, 2, 300, 467, 1, "float32", H100_SMEM, H100_SMS,
     {"threads": 32, "rows": 1, "bufs": 2, "blocks": 12}),
    (2, 1, 700, 400, 2, "bf16", H100_SMEM, 4,
     {"threads": 96, "rows": 1, "bufs": 2, "blocks": 4}),
    (2, 2, 650, 480, 4, "float32", H100_SMEM, 4,
     {"threads": 96, "rows": 1, "bufs": 2, "blocks": 4}),
    (70, 5, 20, 47, 1, "float32", H100_SMEM, 4,
     {"threads": 256, "rows": 18, "bufs": 2, "blocks": 4}),
    (9, 2, 100, 467, 1, "float32", 30000, 1,
     {"threads": 32, "rows": 2, "bufs": 1, "blocks": 5}),
    (12, 3, 100, 95, 3, "bf16", 23000, 1,
     {"threads": 32, "rows": 2, "bufs": 1, "blocks": 6}),
    (20, 3, 60, 95, 1, "float32", 23000, 1,
     {"threads": 32, "rows": 3, "bufs": 1, "blocks": 7})])
def test_narrow_plan_fills_the_card(s, r, n, k, c, wire, smem, sms, want):
    """The narrow plan where a block of the widest width and NARROW_ROWS
    rows would leave SMs idle, on an H100's 132 SMs and on a card of 4:
    narrower blocks (one to three warps) and fewer rows a block (one to
    18, the rows evened out over the blocks); and where two tap buffers
    and the history side buffer do not fit (a card with less shared
    memory): one tap buffer, the next row's history fetched straight
    into the planes, over blocks of one and of several rows and three
    slots. Rows repeat bins, as the pfb fine stage's do. The same checks
    as ``test_general_plan_matches_plain``."""
    rng = np.random.default_rng(s + n + k)
    xrow = rng.integers(0, r, s)
    xrow[: 2] = xrow[0]
    check_plan("narrow", s, n, k, 16, c, wire, smem, xrow, r, sms, want)


def check_plan(path, s, n, k, d, c, wire, smem, xrow=None, r=None, sms=1,
               want=None):
    """The emulated plan ``path`` against the plain version and the
    replaced kernel's chain, bank row s reading x row ``xrow[s]``, on a
    card of ``sms`` SMs (one: the narrow plan's widest blocks of as many
    rows as it takes); ``want``: entries the plan must have."""
    rng = np.random.default_rng(n + k + c)
    x, hist, grev, phase0, step = _operands(rng, s, n, k, d, c, wire, r)
    xrow = np.arange(s) if xrow is None else np.asarray(xrow)
    p = plan(k, d, c, smem, s, n, sms)
    assert p["path"] == path
    assert {key: p[key] for key in want or {}} == (want or {})
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
    ("pfb", {"path": "narrow", "nb": 1280, "pitch": 1309, "threads": 256,
             "bufs": 2, "rows": 63, "blocks": 262}),
    ((30000, 1, 1), {"path": "direct"}),
    ((30000, 1, 64), {"path": "direct"}),
    ("pfb 64 rows", {"path": "narrow", "threads": 256, "rows": 1,
                     "blocks": 128}),
    ("pfb 128 rows", {"path": "narrow", "threads": 256, "rows": 2,
                      "blocks": 128}),
    ("pfb 256 rows", {"path": "narrow", "threads": 256, "rows": 4,
                      "blocks": 128}),
    ((8000, 16, 1), {"path": "narrow", "threads": 128, "bufs": 1}),
    ((13184, 16, 1), {"path": "narrow", "threads": 32, "bufs": 1}),
    ((13185, 16, 1), {"path": "wide"})])
def test_launcher_sends_each_shape_to_its_path(shape, want):
    """Split2's bank (K = 20, D = 2, C = 2) and no other shape takes the
    fast path; the mesh step's bank takes the wide plan in one 256-thread
    block of 128 outputs × 64 slots per source tile (planes at pitch 143,
    ~208 KB with the tap chunks), the pfb fine stage the narrow plan
    (1280 outputs a block, ~176 KB: one block an SM) at the bench's 8192
    rows in 63 rows a block (262 blocks, two waves of 132 SMs) and at the
    runtime's groups of 64, 128 and 256 rows (N = 2500 at every rate) in
    one wave of 128 blocks; the narrow plan with one tap buffer up to K
    = 13184 at C = 1, where the old plan's range ended near 13760 and the
    wide plan takes the rest; few slots at another D the wide plan, and
    a span that fits no shared memory the direct kernel."""
    rows = BENCH_S
    if shape == "split2":
        sp = SpectrumSplit2(2.4e6)
        shape = (sp.bank.ntaps, sp.bank.decim, sp.bank.num_slots)
    elif shape == "mesh":
        shape = _mesh()
    elif isinstance(shape, str):
        rows = int(shape.split()[1]) if " " in shape else BENCH_S
        shape = _pfb_fine()
    p = plan(*shape, s=rows)
    assert {key: p[key] for key in want} == want
    if p["path"] in ("wide", "narrow"):
        assert p["smem"] <= H100_SMEM and p["pitch"] % 2 == 1
    if shape == _pfb_fine():    # NARROW_BLOCKS an SM: 228 KB, 1 KB kept each
        assert NARROW_BLOCKS * (p["smem"] + 1024) <= 228 * 1024


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
            "for (int bufs = 2; bufs >= 1 && !nw_at; --bufs)",
            "for (int nw = NARROW_WARPS; nw >= 1; --nw) {",
            "const int nb = nw * 32 * NARROW_R, pitch = (nb + Q - 1) | 1;",
            "const int smem = narrow_bytes(D, pitch, Q, K, bufs);",
            "(plane_floats2(D, pitch) + bufs * Q * D +",
            "(bufs == 2 ? (K + 1) & ~1 : 0)) +",
            "NARROW_ROWS * (int)(sizeof(long long) + 2 * sizeof(int));",
            "const long long tiles = max(1, (N + nb - 1) / nb);",
            "min(NARROW_WARPS * NARROW_BLOCKS / nw, sm_smem / (smem + 1024))",
            "const long long cap = sms * per_sm;",
            "1LL, (tiles * ((S + NARROW_ROWS - 1) / NARROW_ROWS) + cap - 1)",
            "const long long groups = max(1LL, waves * cap / tiles);",
            "const int rb = (int)max(1LL, (S + groups - 1) / groups);",
            "const long long blocks = tiles * ((S + rb - 1) / rb);",
            "const long long load = (blocks + sms - 1) / sms * rb",
            "* (min(nb, N) + Q - 1);",
            "if (!nw_at || load < least) {",
            "const dim3 grid((N + nb - 1) / nb, (S + rb_at - 1) / rb_at);",
            "return (D * pitch + 1) & ~1;",
            "return x + __ldg(xrow + s) * T;",
            "return x + (long long)s * T;"):
        assert line in _SRC, line
    # every general plan stages through the row index, split2 refuses one
    assert _SRC.count("x_row<kRows>(x, xrow, s, T)") == 2
    assert "xr[i] = kRows ? __ldg(xrow + s0 + i) : (long long)(s0 + i);" \
        in _SRC and "x + xr[r] * T," in _SRC
    assert "if (xrow) return (int)cudaErrorInvalidValue;" in _SRC


def test_narrow_model_reads_the_kernel():
    """``_narrow`` models these lines of the narrow kernel: the window's
    first R-1 rows, the row entering each tap row and the slot each
    output reads, the groups of R tap rows and the last, bounds-checked
    group, the block's rows and its one or two tap buffers; a change
    there must change the model too. R is odd (lanes at stride R rows
    hit distinct banks)."""
    for line in (
            "for (int m = 0; m < R - 1; ++m)",
            "for (int j = 0; j < D; ++j) zw[m][j] = zl[j * pitch + m];",
            "zw[(u + R - 1) % R][j] = zl[j * pitch + qu + R - 1];",
            "fma4(ar[r], ai[r], make_float2(t.x, t.y), zw[(u + r) % R][j]);",
            "zw[(u + r) % R][j + 1]);",
            "for (; q + R <= QF; q += R) {",
            "for (int u = 0; u < R; ++u) tap_row(u, q + u, D);",
            "if (q + u < QF) tap_row(u, q + u, D);",
            "if (q + u == QF && QF < Q) tap_row(u, QF, JL);",
            "const int base = warp * 32 * R + lane * R;",
            "const int n0 = blockIdx.x * nb, s0 = blockIdx.y * rb;",
            "const int rows = min(rb, S - s0);",
            "float2* dst = tbuf + (it & (bufs - 1)) * Q * D;",
            "const float2* taps = tbuf + (it & (bufs - 1)) * Q * D;",
            "if (it + 1 < items && (bufs == 1 || new_span(it + 1))) {",
            "fetch_history(it + 1, true);"):
        assert line in _SRC, line
    assert NARROW_R % 2 == 1 and NARROW_D % 2 == 0
