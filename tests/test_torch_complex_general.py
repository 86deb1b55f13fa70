"""The complex bank kernel's general path (``csrc/xlat_complex.cu``),
emulated on the CPU against the plain version.

The launcher sends split2's shape to the fast path and every other shape
to the general path, which picks one of two plans by the shared memory
the span needs:

- wide: a block of WN × WC warps takes 32·WIDE_R·WN outputs × WIDE_RC·WC
  slots of one source; it stages the span of its outputs as D polyphase
  planes (plane j row m = z[(n0+m)·D + j], history for the first K-1
  samples), and streams the taps through shared memory in chunks of
  WIDE_KC, one chunk ahead; a thread holds outputs lane + 32·r (r <
  WIDE_R) of its warp's rows × its warp's WIDE_RC slots and walks the
  taps of each chunk in pairs, each (q, j) stepped on by one;
- direct (a span too large for shared memory): one thread per (output,
  slot) over a block of DIRECT_BM outputs, z read from device memory.

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


(FAST_P, FAST_D, FAST_C, WIDE_R, WIDE_RC, WIDE_WARPS, WIDE_KC, DIRECT_BM,
 DIRECT_THREADS) = (
    _const(n) for n in ("FAST_P", "FAST_D", "FAST_C", "WIDE_R", "WIDE_RC",
                        "WIDE_WARPS", "WIDE_KC", "DIRECT_BM",
                        "DIRECT_THREADS"))
H100_SMEM = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
BENCH_S, BENCH_N = 8192, 2500   # the pfb bench's slot rows and outputs
COMPLEX_REL = 1e-4   # float32 sums in another order than the plain GEMM's
NAN = np.complex64(complex(np.nan, np.nan))


def _floats2(d: int, pitch: int) -> int:
    """``plane_floats2``: the planes' float2s, rounded up to even."""
    return (d * pitch + 1) & ~1


def plan(k: int, d: int, c: int, smem_max: int = H100_SMEM,
         s: int = BENCH_S, n: int = BENCH_N) -> dict:
    """The launcher's choice for taps K, decimation D and C slots over S
    bank rows of N outputs, as ``launch`` and ``launch_general`` make
    it."""
    if (k, d, c) == (FAST_P * FAST_D, FAST_D, FAST_C):
        return {"path": "split2"}
    q = -(-k // d)
    wc = min(WIDE_WARPS, -(-c // WIDE_RC))
    for wn in range(WIDE_WARPS // wc, 0, -1):
        nb = wn * 32 * WIDE_R
        pitch = (nb + q - 1) | 1
        smem = 8 * (_floats2(d, pitch) + 2 * wc * WIDE_RC * WIDE_KC)
        if smem <= smem_max:
            return {"path": "wide", "wn": wn, "wc": wc, "nb": nb,
                    "cb": wc * WIDE_RC, "pitch": pitch,
                    "threads": 32 * wn * wc, "smem": smem,
                    "blocks": -(-n // nb) * -(-c // (wc * WIDE_RC)) * s}
    return {"path": "direct"}


def _stage(xc, hist, s, n0, count, d, k, pitch, nthreads):
    """``stage_planes`` for the block (s, n0): each thread steps its (row,
    plane) by the block's thread count; returns planes [D, pitch] with NaN
    where nothing was staged."""
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
            xc[s, np.maximum(xi, 0)])
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


def _wide(xc, hist, grev, d, p, out):
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
    planes = np.stack([_stage(xc, hist, s, n0, min(nb, n - n0), d, k, pitch,
                              nt)
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


def _direct(xc, hist, grev, d, out):
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
                              xc[s, np.maximum(zi - (k - 1), 0)])
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


def _operands(rng, s, n, k, d, c, wire):
    """The bank's operands for S bank rows: x [S, N·D, 2], history, taps,
    phase and step."""
    x = rng.standard_normal((s, n * d, 2)).astype(np.float32)
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
    ("wide", 3, 150, 1440, 96, 40, "float32", H100_SMEM),
    ("wide", 2, 5, 1440, 96, 64, "float32", H100_SMEM),
    ("wide", 2, 333, 47, 3, 12, "float32", H100_SMEM),
    ("wide", 4, 333, 47, 3, 12, "bf16", H100_SMEM),
    ("wide", 3, 700, 467, 16, 1, "float32", H100_SMEM),
    ("wide", 2, 5, 467, 16, 1, "bf16", H100_SMEM),
    ("wide", 2, 50, 21, 5, 3, "float32", H100_SMEM),
    ("wide", 2, 300, 467, 16, 3, "bf16", H100_SMEM),
    ("wide", 1, 700, 400, 16, 2, "float32", H100_SMEM),
    ("wide", 2, 650, 480, 16, 4, "bf16", H100_SMEM),
    ("wide", 2, 90, 33, 16, 5, "float32", H100_SMEM),
    ("wide", 1, 170, 47, 16, 6, "bf16", H100_SMEM),
    ("wide", 2, 41, 95, 16, 7, "float32", H100_SMEM),
    ("direct", 2, 40, 31, 3, 2, "float32", 0),
    ("direct", 3, 40, 31, 3, 2, "float32", 0)])
def test_general_plan_matches_plain(path, s, n, k, d, c, wire, smem):
    """Each plan at the launcher's constants: the mesh step's C = 64 and the
    card tests' C = 40 (five slot groups) at K = 1440, D = 96 and a ragged
    N, on one source and three; a block shorter than K-1 (N = 5); K % D ≠
    0 with an odd D, an odd chunk and a part-filled slot tile, float32 and
    bf16; fewer slots than a slot tile at D = 16 (C = 1, K = 467 over a
    ragged last block and a block shorter than K-1; C = 2 to 7 with K % D
    = 0, 400 and 480, and K % D ≠ 0, 33, 47 and 95), bf16 and float32; a
    few slots at another D; the direct kernel (forced by a card with no
    shared memory) on two sources and three. Every output written once,
    its window the plain version's samples, its accumulators the replaced
    kernel's chain bit for bit, its rotated value within COMPLEX_REL·max|y|
    of ``bank_complex_plain``."""
    check_plan(path, s, n, k, d, c, wire, smem)


def check_plan(path, s, n, k, d, c, wire, smem):
    """The emulated plan ``path`` against the plain version and the
    replaced kernel's chain."""
    rng = np.random.default_rng(n + k + c)
    x, hist, grev, phase0, step = _operands(rng, s, n, k, d, c, wire)
    p = plan(k, d, c, smem, s, n)
    assert p["path"] == path
    xc = (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)
    out = _Out(s, c, n, k)
    with np.errstate(invalid="ignore"):
        if path == "wide":
            _wide(xc, hist, grev, d, p, out)
        else:
            _direct(xc, hist, grev, d, out)
    assert (out.writes == 1).all()
    z = ck.complex_z(torch.from_numpy(x), torch.from_numpy(hist)).numpy()
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


# the pfb fine stage's shape (C = 1, K = 467, D = 16) on the wide plan at
# the bench's 8192 rows: three blocks a row
PFB_WIDE = {"path": "wide", "wn": 8, "wc": 1, "nb": 1024, "cb": 8,
            "pitch": 1053, "threads": 256, "smem": 147072,
            "blocks": 3 * BENCH_S}


@pytest.mark.parametrize("shape,want", [
    ("split2", {"path": "split2"}),
    ((FAST_P * FAST_D, FAST_D, FAST_C + 1), {"path": "wide", "wc": 1}),
    ((FAST_P * FAST_D + FAST_D, FAST_D, FAST_C), {"path": "wide"}),
    ((FAST_P * FAST_D, 2 * FAST_D, FAST_C), {"path": "wide"}),
    ((467, 16, 7), {"path": "wide", "wn": 8, "wc": 1}),
    ((467, 16, 8), {"path": "wide", "wn": 8, "wc": 1}),
    ("mesh", {"path": "wide", "wn": 1, "wc": 8, "nb": 128, "cb": 64,
              "pitch": 143, "threads": 256}),
    ((1440, 96, 40), {"path": "wide", "wn": 1, "wc": 5, "threads": 160}),
    ((1440, 96, 8), {"path": "wide", "wn": 2, "wc": 1, "threads": 64}),
    ((20, 2, 8), {"path": "wide", "wn": 8, "wc": 1, "nb": 1024}),
    ("pfb", PFB_WIDE),
    ((30000, 1, 1), {"path": "direct"}),
    ((30000, 1, 64), {"path": "direct"}),
    ("pfb 64 rows", {**PFB_WIDE, "blocks": 3 * 64}),
    ("pfb 128 rows", {**PFB_WIDE, "blocks": 3 * 128}),
    ("pfb 256 rows", {**PFB_WIDE, "blocks": 3 * 256}),
    ((8000, 16, 1), {"path": "wide", "wn": 8, "pitch": 1523}),
    ((13184, 16, 1), {"path": "wide", "wn": 7, "pitch": 1719}),
    ((13185, 16, 1), {"path": "wide", "wn": 6, "pitch": 1593})])
def test_launcher_sends_each_shape_to_its_path(shape, want):
    """Split2's bank (K = 20, D = 2, C = 2) and no other shape takes the
    fast path; the mesh step's bank takes the wide plan in one 256-thread
    block of 128 outputs × 64 slots per source tile (planes at pitch 143,
    ~208 KB with the tap chunks); one to eight slots at D = 16 (the pfb
    fine stage's shape, which ``pfb_fine`` now runs) one slot group of
    eight warps, 1024 outputs a block (planes at pitch 1053, ~144 KB), at
    the bench's 8192 rows and at the runtime's groups of 64, 128 and 256
    rows (N = 2500 at every rate: three blocks a row); longer filters
    narrower blocks (eight warps up to K = 8000, seven at 13184, six at
    13185), and a span that fits no shared memory the direct kernel."""
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
    if p["path"] == "wide":
        assert p["smem"] <= H100_SMEM and p["pitch"] % 2 == 1


def test_plan_model_reads_the_launcher():
    """``plan`` models these lines of the launcher; a change there must
    change the model too. The general plans read bank row s's samples
    from row s of x: no kernel takes a row index."""
    for line in (
            "if (K == FAST_P * FAST_D && D == FAST_D && C == FAST_C)",
            "const int wc = min(WIDE_WARPS, (C + WIDE_RC - 1) / WIDE_RC);",
            "for (int wn = WIDE_WARPS / wc; wn >= 1; --wn) {",
            "const int nb = wn * 32 * WIDE_R, pitch = (nb + Q - 1) | 1;",
            "plane_floats2(D, pitch) + 2 * wc * WIDE_RC * WIDE_KC);",
            "(C + wc * WIDE_RC - 1) / (wc * WIDE_RC), S);",
            "return (D * pitch + 1) & ~1;",
            "const dim3 grid((N + DIRECT_BM - 1) / DIRECT_BM, S);"):
        assert line in _SRC, line
    assert "stage_planes<W>(planes, pitch, x + (long long)s * T," in _SRC
    assert "const typename W::T* xs = x + (long long)s * T;" in _SRC
