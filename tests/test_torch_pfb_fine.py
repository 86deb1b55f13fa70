"""The pfb fine stage's mixer form (``ops/pfb_kernel.py``: ``pfb_fine``,
``csrc/pfb_fine.cu``) on the CPU.

- ``pfb_fine_plain`` against the modulated-taps form it replaces on the
  card (``bank_complex_plain`` of ``modulated_taps``) within COMPLEX_REL
  and against a float64 evaluation of the same function within FINE_REL:
  f near ±0.5, f = 0, |f| < 2^-9, a block shorter than K-1, several
  slots a bin through the row index;
- ``PfbXlatBank``'s carried fine history and phase bit for bit what the
  modulated-taps step carried;
- the kernel's plan emulated in numpy at the constants it is built with
  (read from the ``.cu``): the staged rows of D samples all inside
  history ++ bin, the in-place mixing eight threads a row (a base phasor
  times a row step), the real and imaginary halves swapped on odd rows,
  each lane's register window of O rows of four planes walked a tap row
  at a time, four lanes' partial sums met, the parts met and rotated
  once and stored into the trackers' [S/C, N, C] planes; every plane
  element written once, within FINE_REL of the plain version, at one to
  sixteen rows a block, a block's rows straddling two sources where the
  rows a block do not divide C;
- ``pfb_fine`` on the CPU returning the planes of ``pfb_fine_plain``, and
  ``PfbXlatBank.call_planes`` on the CPU bit for bit ``planes()`` of the
  bank's channels;
- the launcher's plan (``fine_plan``) at 8192, 256, 128 and 64 rows on
  an H100 and on cards of 4 SMs and 1, with the blocks' shared memory in
  budget;
- ``pfb_fine_args`` refusing what the kernel does not take."""

import re

import numpy as np
import pytest
import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.ops import channelizer as TC
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.fir import U32_MASK, phase_step_u32

torch.set_num_threads(1)   # six test workers share the machine

_SRC = (kernels.CSRC / "pfb_fine.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


O, D, MIX = _const("FINE_O"), _const("FINE_D"), _const("MIX_THREADS")
G = _const("FINE_G")
LANES = D // _const("PLANES")
K2 = 467                  # PfbXlatBank's fine prototype at 400 kHz bins
H100_SMS = 132
# The modulated-taps form rounds each tap's angle 2πf·k in float32, up to
# half an ulp of 2π·0.5·466 ≈ 1464 rad (6e-5 rad): 4.9e-5·max|y| measured
# near |f| = 0.5, under the complex bank's sum-order bound.
COMPLEX_REL = 1e-4
FINE_REL = pk.FINE_REL


def _cnormal(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _operands(rng, s, r, n, k, fine, order="repeated"):
    """Bins x [R, N·D, 2] float32, the row index, history, the prototype,
    fine offsets, phase0 and step. The index's ``order``: ``repeated``,
    drawn at random with the first two rows on one bin; ``permuted``,
    a permutation of the S rows taken mod R, so a bin's rows lie apart."""
    x = torch.from_numpy(rng.standard_normal((r, n * D, 2)).astype(
        np.float32))
    if order == "permuted":
        rows = torch.as_tensor(rng.permutation(s) % r)
    else:
        rows = torch.as_tensor(rng.integers(0, r, s))
        rows[1] = rows[0]
    hist = torch.from_numpy(_cnormal(rng, (s, k - 1)))
    taps = torch.from_numpy(TC.PfbXlatBank(4, 2.4e6, 12500.0).fine_taps
                            if k == K2 else
                            (rng.standard_normal(k) / k).astype(np.float32))
    fine = torch.as_tensor(np.asarray(fine, np.float32))
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, s))
    return x, rows, hist, taps, fine, phase0, phase_step_u32(fine, D)


def _float64(x, rows, hist, taps, fine, phase0, step):
    """The fine stage in float64: the prototype modulated exactly."""
    z = ck.complex_z(x[rows], hist).numpy().astype(np.complex128)
    k, n = taps.shape[0], x.shape[1] // D
    kk = np.arange(k)
    g = (taps.numpy().astype(np.float64)
         * np.exp(2j * np.pi * fine.numpy().astype(np.float64)[:, None]
                  * kk))[:, ::-1]
    win = np.stack([z[:, i * D:i * D + k] for i in range(n)], 1)
    u = (phase0.numpy()[:, None] + step.numpy()[:, None] * np.arange(n)) \
        % 2 ** 32
    return (win * g[:, None, :]).sum(-1) * np.exp(2j * np.pi * u / 2 ** 32)


CASES = {   # (rows, bin rows, outputs, taps, fine offsets)
    "near_half": (3, 2, 200, K2, [0.4999, -0.5, 0.5]),
    "zero": (2, 2, 150, K2, [0.0, 0.0]),
    "small": (3, 2, 150, K2, [2.0 ** -10, -3e-4, 1e-7]),
    "short_block": (3, 2, 5, K2, [0.3, -0.21, 0.0]),
    "slots_a_bin": (7, 3, 120, K2, [0.31, -0.12, 0.44, 0.0, -0.49, 0.05,
                                    0.27]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_modulated_taps(case):
    """``pfb_fine_plain`` against ``bank_complex_plain`` on the modulated
    taps (the rows gathered) within COMPLEX_REL·max|y|, and against the
    float64 function within FINE_REL·max|y|: the mixer form is the
    modulated form up to the rounding of the modulation's angle, which
    the float64 comparison shows is the modulated taps'."""
    s, r, n, k, fine = CASES[case]
    rng = np.random.default_rng(s + n)
    x, rows, hist, taps, fine, phase0, step = _operands(rng, s, r, n, k,
                                                        fine)
    y = pk.pfb_fine_plain(x, rows, hist, taps, fine, phase0, step, D)
    assert y.shape == (s, n) and y.dtype == torch.complex64
    want = ck.bank_complex_plain(
        ck.complex_z(x[rows], hist), TC.modulated_taps(taps, fine[:, None]),
        phase0[:, None], step[:, None], n, D)[:, 0]
    exact = _float64(x, rows, hist, taps, fine, phase0, step)
    scale = float(np.abs(exact).max())
    assert float((y - want).abs().max()) <= COMPLEX_REL * scale
    assert float(np.abs(y.numpy() - exact).max()) <= FINE_REL * scale


def test_mixer_sigma_rounds_half_to_even():
    """σ = round(f·2^32) mod 2^32: f = ±0.5 give 2^31, a negative f wraps,
    and a half-integer f·2^32 rounds to even."""
    f = torch.tensor([0.5, -0.5, 0.0, -2.0 ** -32, 2.0 ** -33,
                      3 * 2.0 ** -33, 0.25], dtype=torch.float32)
    assert pk.mixer_sigma(f).tolist() == [
        2 ** 31, 2 ** 31, 0, 2 ** 32 - 1, 0, 2, 2 ** 30]


@pytest.mark.parametrize("n_bin", [1024, 256])
def test_bank_carries_history_and_phase_bit_for_bit(n_bin):
    """``PfbXlatBank`` over two blocks of ``n_bin`` bin samples (256 <
    K2-1): the new fine history is ``complex_history`` of each slot's
    gathered bin, the new phase phase0 + step·N mod 2^32, bit for bit;
    ``fine_operands`` hands the kernel each slot's fine offset, not its
    modulated taps."""
    bank = TC.PfbXlatBank(4, 2.4e6, 12500.0)
    offs = torch.tensor([[-410e3, -395e3, 12.5e3, 790e3],
                         [400e3, 390e3, 410e3, 450e3]]) / 2.4e6
    rng = np.random.default_rng(n_bin)
    st = bank.init(2, "cpu")
    for _ in range(2):
        x = torch.from_numpy(_cnormal(rng, (2, n_bin * bank.m)))
        _, xb, rows, hist, fine, phase0, step = bank.fine_operands(st, x,
                                                                   offs)
        assert fine.shape == rows.shape == phase0.shape == (8,)
        assert torch.equal(fine, bank.route(offs)[1].reshape(-1))
        st, y = bank(st, x, offs)
        assert y.shape == (2, 4, n_bin // D)
        n = n_bin // D
        assert torch.equal(
            torch.view_as_real(st.fine.history.reshape(8, -1)),
            torch.view_as_real(TC.complex_history(hist, xb[rows])))
        assert torch.equal(st.fine.phase.reshape(-1),
                           (phase0 + step * n) & U32_MASK)


def _cis(u):
    """``cis``: (cos, sin) of float32(u) · float32(2π/2^32), complex64."""
    a = u.astype(np.uint32).astype(np.float32) * np.float32(2 * np.pi
                                                            / 2 ** 32)
    return (np.cos(a) + 1j * np.sin(a)).astype(np.complex64)


def _chunk(m, p, h):
    """``chunk``: the physical 16-byte chunk of row m's part p, planes
    4h .. 4h+3 (the halves swapped on odd rows)."""
    return 4 * (p ^ (m & 1)) + h


def _stage(z, z0, nrows):
    """A row's staged span: samples [z0, z0 + D·nrows) of history ++ bin
    as rows of D interleaved samples, every row inside z."""
    assert z0 + D * nrows <= z.shape[0]
    return z[z0:z0 + D * nrows].view(np.float32).reshape(nrows, 2 * D)


def _row_at(s, n0, n, c):
    """The planes' flat offset of row s's output n0: slot s % C of source
    s / C in [S/C, N, C], as the kernel's ``at`` holds it."""
    src = s // c
    return (src * n + n0) * c + (s - src * c)


def _group_store(at, n0, count, c):
    """``store_group``: a group of g = len(at) rows' outputs n0 .. n0 +
    count - 1 in thread order, idx = k·g + j (row j, output n0 + k), as
    (j, k, flat index into the planes)."""
    g = len(at)
    idx = np.arange(g * count)
    k, j = idx // g, idx % g
    return j, k, np.asarray(at)[j] + k * c


def _emulate(x, rows, hist, taps, fine, phase0, step, rb, slots):
    """The kernel's plan in numpy, block by block (one tile of NB outputs
    of rb consecutive rows each, row by row), thread by thread; float32
    arithmetic in its order up to the FMAs' single rounding. A row's span
    keeps the bin part of the row before it where both read one bin, and
    takes its own history part; shared memory a block did not write reads
    NaN. The rows are ``slots`` slots a source; each row's parts' sums
    wait in the box of its group of G rows, which is rotated and stored
    once its last row is filtered. Returns (the planes y_re, y_im [S/C, N,
    C], how often each plane element was written)."""
    s_n, t = rows.shape[0], x.shape[1]
    n, k = t // D, taps.shape[0]
    q_n = -(-(-(-k // D)) // O) * O        # whole groups of O tap rows
    nb, nt = pk.FINE_NB, pk.FINE_WP * 64
    rstride = nt // MIX
    sig = pk.mixer_sigma(fine).numpy().astype(np.uint32)
    xc = torch.view_as_complex(x).numpy()
    tp = np.zeros(q_n * D, np.float32)
    tp[:k] = taps.numpy()[::-1]
    planes = np.full((2, s_n * n), np.nan, np.float32)
    writes = np.zeros(s_n * n, np.int64)
    tid = np.arange(nt)
    c, r0 = tid % MIX, tid // MIX
    warp, lane = tid // 32, tid % 32
    part = warp // pk.FINE_WP
    g, h = lane // LANES, lane % LANES
    wbase = (warp - part * pk.FINE_WP) * (32 // LANES) * O
    base = wbase + g * O
    for s0 in range(0, s_n, rb):
        for n0 in range(0, n, nb):
            count = min(nb, n - n0)
            nrows = count + -(-k // D) - 1           # staged
            rowsp = count + q_n - 1                  # and zero rows
            z0 = n0 * D
            hn = max(0, min(k - 1 - z0, D * nrows))
            raw = np.full((nb + q_n - 1, 2 * D), np.nan, np.float32)
            mixed = np.full_like(raw, np.nan)
            box = np.full((2, nb, G), np.nan, np.float32)
            at, rot = [], []
            staged = None
            for s in range(s0, min(s0 + rb, s_n)):
                slot = (s - s0) % G
                z = np.concatenate([hist[s].numpy(), xc[rows[s]]])
                own = _stage(z, z0, nrows)
                flat = raw[:nrows].reshape(-1, 2)          # [samples, 2]
                if rows[s] != staged:
                    raw[:nrows] = own
                    staged = rows[s]
                elif hn:
                    flat[:hn] = own.reshape(-1, 2)[:hn]
                assert np.array_equal(raw[:nrows].view(np.uint32),
                                      own.view(np.uint32))
                sg = np.uint32(sig[s])
                steps = -(-rowsp // rstride)
                with np.errstate(over="ignore"):
                    ek = _cis(np.uint32(0) - sg * (np.arange(
                        steps, dtype=np.uint32) * np.uint32(D * rstride)))
                    u0 = (np.uint32(0) - sg * (z0 + D * r0 + 2 * c).astype(
                        np.uint32))
                    ph = np.stack([_cis(u0), _cis(u0 - sg)], 1)  # [nt, 2]
                m2 = mixed.reshape(-1, 16, 2)                     # a view
                for kk in range(steps):
                    r = r0 + kk * rstride
                    live = r < rowsp
                    rl, cl = r[live], c[live]
                    zc = raw.reshape(-1, 8, 4)[rl, cl]
                    zs = (zc[:, 0::2] + 1j * zc[:, 1::2]).astype(np.complex64)
                    with np.errstate(invalid="ignore"):
                        w = (zs * (ph[live] * ek[kk]).astype(np.complex64)
                             ).astype(np.complex64)
                    w[rl >= nrows] = 0
                    for p, vals in ((0, w.real), (1, w.imag)):
                        m2[rl, 2 * _chunk(rl, p, cl >> 1) + (cl & 1)] = vals
                active = wbase < count
                acc = np.zeros((nt, O), np.float32)
                win = [None] * O

                def load(m, slot):
                    assert slot == m % O
                    rr = base + m
                    win[slot] = (m, mixed.reshape(-1, 8, 4)[
                        rr, _chunk(rr, part, h)])                 # [nt, 4]

                with np.errstate(invalid="ignore"):
                    for m in range(O - 1):
                        load(m, m)
                    for q in range(0, q_n, O):
                        for u in range(O):
                            load(q + u + O - 1, (u + O - 1) % O)
                            tv = tp.reshape(-1, LANES, 4)[q + u, h]
                            for j in range(4):
                                for r in range(O):
                                    row, wv = win[(u + r) % O]
                                    assert row == q + u + r
                                    acc[:, r] = acc[:, r] + tv[:, j] * wv[
                                        :, j]
                    grp = acc.reshape(nt // LANES, LANES, O)
                    acc = np.repeat(((grp[:, 0] + grp[:, 1])
                                     + (grp[:, 2] + grp[:, 3]))[:, None],
                                    LANES, 1).reshape(nt, O)
                for r in range(O):
                    wr = active & (r % LANES == h)
                    box[part[wr], base[wr] + r, slot] = acc[wr, r]
                at.append(_row_at(s, n0, n, slots))
                rot.append((phase0[s], step[s], sg))
                if slot < G - 1 and s < min(s0 + rb, s_n) - 1:
                    continue
                j, kk, a = _group_store(at, n0, count, slots)
                nn = (n0 + kk).astype(np.uint32)
                p0, st, sgj = (np.array([r_[t] for r_ in rot], np.uint32)[j]
                               for t in range(3))
                with np.errstate(over="ignore"):
                    v = p0 + st * nn + sgj * (nn * np.uint32(D)
                                              + np.uint32(k - 1))
                yv = (box[0, kk, j] + 1j * box[1, kk, j]).astype(
                    np.complex64) * _cis(v)
                planes[0, a], planes[1, a] = yv.real, yv.imag
                np.add.at(writes, a, 1)
                box[:] = np.nan
                at, rot = [], []
    shape = (s_n // slots, n, slots)
    return (planes[0].reshape(shape), planes[1].reshape(shape),
            writes.reshape(shape))


def _plain_planes(ops, c):
    """``pfb_fine_plain``'s rows as the [S/C, N, C] planes (y_re, y_im)."""
    y = pk.pfb_fine_plain(*ops, D)
    yt = y.view(-1, c, y.shape[1]).transpose(1, 2)
    return yt.real.contiguous(), yt.imag.contiguous()


@pytest.mark.parametrize("rb,s,c,r,n,k,order", [
    (1, 3, 3, 2, 600, K2, "repeated"), (3, 5, 5, 2, 300, K2, "repeated"),
    (4, 4, 2, 3, 5, K2, "repeated"), (2, 3, 3, 2, 300, 33, "repeated"),
    (3, 3, 1, 2, 200, 47, "repeated"), (1, 2, 2, 2, 100, 641, "repeated"),
    (6, 6, 3, 4, 300, K2, "permuted"), (5, 5, 5, 2, 5, K2, "repeated"),
    (4, 12, 6, 3, 333, K2, "repeated"), (6, 6, 2, 2, 150, 47, "permuted"),
    (16, 70, 7, 5, 20, 47, "permuted"), (16, 16, 16, 3, 70, 481,
                                         "repeated")])
def test_kernel_plan_matches_plain(rb, s, c, r, n, k, order):
    """The kernel's plan at one to sixteen rows a block (the rows' bins
    repeating and changing, the last block short): ragged last tiles (the
    bench's 2500 outputs end that way too), blocks of 5 outputs (their
    span all but 3 rows in the history, taken anew for each row of a
    bin) and of 20, K = 33 and 47 (three tap rows, the last part-filled,
    padded with zero taps and zero rows to a group of O), K = 641 (41 tap
    rows: two whole groups of O, then one padded) and K = 481 (31 tap
    rows: two whole groups, then one row and 14 zero rows; 480 would be
    refused, the kernel takes odd tap counts); permuted bins, whose rows
    lie apart in a block, so a bin's span is staged again after another
    bin's (``permuted``, 70 rows over 5 bins among them), and repeated
    bins; C = 1 to 16 slots a source, the rows a block dividing C or not
    (3 rows a block of 5 slots, 4 of 6, 16 of 7: a block's rows straddle
    two or more sources). Every plane element written once and finite,
    within FINE_REL·max|y| of ``pfb_fine_plain``'s planes."""
    rng = np.random.default_rng(rb + s + n + k)
    fine = rng.uniform(-0.5, 0.5, s)
    ops = _operands(rng, s, r, n, k, fine, order)
    x, rows, hist, taps, fine, phase0, step = ops
    if order == "permuted":       # some block holds a bin's rows apart
        assert any(b[j] in b[:j - 1] and b[j] != b[j - 1]
                   for b in (rows[i:i + rb].tolist() for i in range(0, s, rb))
                   for j in range(2, len(b)))
    got_re, got_im, writes = _emulate(x, rows, hist, taps, fine,
                                      phase0.numpy(), step.numpy(), rb, c)
    assert writes.shape == (s // c, n, c)
    assert (writes == 1).all()
    assert np.isfinite(got_re).all() and np.isfinite(got_im).all()
    want_re, want_im = (p.numpy() for p in _plain_planes(ops, c))
    scale = np.abs(want_re + 1j * want_im).max()
    assert np.abs((got_re - want_re) + 1j * (got_im - want_im)).max() <= (
        FINE_REL * scale)


@pytest.mark.parametrize("rb", range(1, 17))
def test_planes_store_writes_every_element_once(rb):
    """The epilogue's store over the whole grid (blocks of rb rows in
    groups of G, one to sixteen rows a block, any of which the kernel
    takes; tiles of NB outputs, the last short) at C = 1, 3, 7, 16
    and 64 slots a source, two or three sources: every element of the
    [S/C, N, C] planes written exactly once, and with row s's output n,
    slot s % C of source s / C, as ``planes()`` of the [S/C, C, N] rows
    puts it; a full group's values of one time step are consecutive
    threads' and consecutive floats."""
    n = 2 * pk.FINE_NB + 37
    for c in (1, 3, 7, 16, 64):
        s_n = c * (2 + c % 2)
        tag = np.arange(s_n * n).reshape(s_n, n)           # row s, output n
        got = np.full(s_n * n, -1)
        writes = np.zeros(s_n * n, np.int64)
        for s0 in range(0, s_n, rb):
            for n0 in range(0, n, pk.FINE_NB):
                count = min(pk.FINE_NB, n - n0)
                last = min(s0 + rb, s_n)
                for g0 in range(s0, last, G):
                    rows_g = range(g0, min(g0 + G, last))
                    j, k, a = _group_store(
                        [_row_at(s, n0, n, c) for s in rows_g], n0, count,
                        c)
                    got[a] = tag[g0 + j, n0 + k]
                    np.add.at(writes, a, 1)
                    if len(rows_g) == G and all(
                            _row_at(s, 0, n, c) + 1 == _row_at(s + 1, 0, n, c)
                            for s in rows_g[:-1]):
                        assert (np.diff(a[:G]) == 1).all()
        assert (writes == 1).all(), (rb, c)
        want = tag.reshape(s_n // c, c, n).transpose(0, 2, 1).ravel()
        assert np.array_equal(got, want), (rb, c)


def test_pfb_fine_on_cpu_returns_plain_planes():
    """``pfb_fine`` on CPU tensors: the [S/C, N, C] float32 planes of
    ``pfb_fine_plain``'s rows, bit for bit, contiguous, at C = 3 and 1;
    rows that are not whole sources of C slots are refused."""
    rng = np.random.default_rng(29)
    ops = _operands(rng, 6, 3, 40, 47, rng.uniform(-0.5, 0.5, 6))
    y = pk.pfb_fine_plain(*ops, D)
    for c in (3, 1):
        y_re, y_im = pk.pfb_fine(*ops, D, c)
        assert y_re.shape == y_im.shape == (6 // c, 40, c)
        assert y_re.dtype == y_im.dtype == torch.float32
        assert y_re.is_contiguous() and y_im.is_contiguous()
        for j in range(6):
            assert torch.equal(y_re[j // c, :, j % c], y[j].real)
            assert torch.equal(y_im[j // c, :, j % c], y[j].imag)
    with pytest.raises(ValueError, match="whole sources"):
        pk.pfb_fine(*ops, D, 4)


@pytest.mark.parametrize("n_bin", [1024, 256])
def test_call_planes_on_cpu_is_planes_of_the_bank(n_bin):
    """``PfbXlatBank.call_planes`` on the CPU over two blocks of ``n_bin``
    bin samples: the planes bit for bit ``planes()`` of ``__call__``'s
    channels, and the same new state."""
    bank = TC.PfbXlatBank(4, 2.4e6, 12500.0)
    offs = torch.tensor([[-410e3, -395e3, 12.5e3, 790e3],
                         [400e3, 390e3, 410e3, 450e3]]) / 2.4e6
    rng = np.random.default_rng(n_bin + 1)
    st = {"call": bank.init(2, "cpu"), "planes": bank.init(2, "cpu")}
    for _ in range(2):
        x = torch.from_numpy(_cnormal(rng, (2, n_bin * bank.m)))
        st["call"], y = bank(st["call"], x, offs)
        st["planes"], y_re, y_im = bank.call_planes(st["planes"], x, offs)
        want_re, want_im = TC.planes(y)
        assert y_re.shape == (2, n_bin // D, 4)
        assert torch.equal(y_re, want_re) and torch.equal(y_im, want_im)
        for a, b in zip(st["call"].fine, st["planes"].fine):
            assert torch.equal(a, b)
        assert torch.equal(st["call"].pfb.history, st["planes"].pfb.history)


def test_kernel_constants_match_the_plan():
    """The plan's constants are the kernel's: D, O, the lanes of a group,
    the warps a part, the mixing pass's threads a row, the blocks an SM
    its ``__launch_bounds__`` ask for and the rows a store group."""
    assert (pk.FINE_D, pk.FINE_O, pk.FINE_LANES, pk.FINE_MIX) == (
        D, O, LANES, MIX)
    assert (pk.FINE_WP, pk.FINE_BLOCKS, pk.FINE_G) == (
        _const("FINE_WP"), _const("FINE_BLOCKS"), G)


@pytest.mark.parametrize("rows,n,k,sms,rb", [
    (8192, 2500, K2, H100_SMS, 12), (256, 2500, K2, H100_SMS, 2),
    (128, 2500, K2, H100_SMS, 2), (64, 2500, K2, H100_SMS, 2),
    (4, 700, 401, 4, 2), (8, 650, 479, 4, 2), (70, 20, 47, 4, 2),
    (9, 100, K2, 1, 2), (36, 100, 95, 1, 3), (20, 60, 95, 1, 2),
    (1, 2500, K2, H100_SMS, 1)])
def test_plan_fills_the_card(rows, n, k, sms, rb):
    """On an H100's 132 SMs at the bench's 8192 slot rows and the
    runtime's groups of 256, 128 and 64, 2500 outputs a row, and on cards
    of 4 SMs and of 1 with short blocks (20 to 700 outputs) and other
    prototypes: the rows a block (12 at the bench, four whole store
    groups, where a bin's span serves the slots that share it; three for
    36 rows on one SM; otherwise two, a store run of two slots, or one
    for a single row) are the most up to FINE_RB_MAX that leave four
    waves of blocks on the card, and at least FINE_RB_MIN: so the card
    gets four waves of blocks unless rb is that floor; the blocks an SM
    holds fit its shared memory together."""
    assert pk.fine_plan(rows, n, k, sms) == rb
    assert min(pk.FINE_RB_MIN, rows) <= rb <= pk.FINE_RB_MAX
    blocks = -(-rows // rb) * -(-n // pk.FINE_NB)
    assert (blocks >= 4 * sms * pk.FINE_BLOCKS
            or rb == min(pk.FINE_RB_MIN, rows))
    smem = pk.fine_bytes(k)
    assert smem <= pk.SMEM_MAX
    assert pk.FINE_BLOCKS * (smem + pk.BLOCK_RESERVED) <= pk.SM_SHARED


def test_fine_args_refusals():
    """``pfb_fine_args`` refuses bf16 or misshapen bins, D ≠ 16, an even
    tap count, operands of the wrong dtype or shape, rows that are not
    whole sources of C slots, planes of the wrong shape or not
    contiguous, and valid operands off the card."""
    s, r, n, k, c = 3, 2, 10, 47, 3
    x = torch.zeros((r, n * D, 2))
    rows = torch.zeros(s, dtype=torch.int64)
    hist = torch.zeros((s, k - 1), dtype=torch.complex64)
    taps = torch.zeros(k)
    fine = torch.zeros(s)
    ph = torch.zeros(s, dtype=torch.int64)
    good = (x, rows, hist, taps, fine, ph, ph)

    def refuse(args, d=D, match="pfb_fine", c=c, out=None):
        with pytest.raises(ValueError, match=match):
            pk.pfb_fine_args(*args, d, c, out=out)

    refuse((x.bfloat16(),) + good[1:], match="float32 bins")
    refuse((x[:, :, :1],) + good[1:], match="float32 bins")
    refuse(good, d=8, match="D = 16")
    refuse(good[:3] + (torch.zeros(k + 1),) + good[4:], match="odd tap")
    refuse(good[:1] + (rows.int(),) + good[2:], match="rows must be")
    refuse(good[:2] + (hist[:, :-1],) + good[3:], match="history must be")
    refuse(good[:4] + (fine.double(),) + good[5:], match="fine must be")
    refuse(good[:5] + (ph[:2],) + good[6:], match="phase0 must be")
    refuse(good, c=2, match="not whole sources of C = 2")
    refuse(good, c=0, match="not whole sources")
    plane = torch.zeros((s // c, n, c))
    refuse(good, out=(plane, plane.transpose(1, 2).contiguous()
                      .transpose(1, 2)), match="y_im must be")
    refuse(good, out=(plane[:, :-1], plane), match="y_re must be")
    refuse(good, out=(plane, plane.double()), match="y_im must be")
    refuse(good, c=1, out=(plane, plane), match="y_re must be")
    refuse(good, out=(plane, plane), match="the kernel takes CUDA")
    refuse(good, match="the kernel takes CUDA")
