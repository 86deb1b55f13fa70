"""The CQPSK tracker kernel's plan (``csrc/cqpsk_track.cu``), emulated on
the CPU against the plain tracker. The consumer is symbol-major, each lane
with its own sample pointer: an inner loop takes every lane's samples up
to and including its next symbol instant (NCO, rotation, history shift,
t + 1) and records each rotated sample in its tile's ring; then the emit
step runs for every emitting lane at once, with the mid-symbol window
picked by selects among the candidates after one Horner evaluation, and
records the symbol's value y. Lanes that reach N mid-symbol stop
there, and so do lanes that reach rows their tile's ring has not filled
(STAGES stages of STAGE rows past the last stage the tile's slowest lane
has handed over); they take up their symbol again on the next pass. The
producer warps turn the handed-over rows into outputs from those
records alone: per row the value interpolation over the 8 rotated
samples before it (the carried history's last 8 at the start) with the
taps held for the launch off a symbol and the recorded y on one, z =
y·conj(prev) with the prev in force at the row (the carried prev, then
each emit's y), and its atan2. The emulation checks the
hand-over: a tile hands a stage over only once its every lane has
recorded the stage's rows. The CUDA kernel cannot run here; this holds
the plan it shares with the emulation to ``track_cqpsk_plain`` bit for
bit (``torch.equal``), as the kernel is held to the kernel it replaced on
the card. Each step works on the whole [S, C] lane tensors with masks,
as the plain version's steps do, so every element takes the same code
path in both (a vectorized transcendental may round otherwise than its
scalar tail)."""

import re

import numpy as np
import pytest
import torch

from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.demod import cqpsk as CQ
from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
from radiocapture_tpu_torch.testing import modulators as M
from radiocapture_tpu_torch.testing import streams

torch.set_num_threads(1)   # six test workers share the machine

FS = 25000.0
S_VAL = CQ.HIST_C - 5 - int(CQ._DELAY)    # the symbol value's window
HEAD = 64                                  # plain samples before the blocks
CF = torch.as_tensor(CQ._VAL_FARROW)
SRC = (kernels.CSRC / "cqpsk_track.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


STAGE, STAGES = _const("STAGE"), _const("STAGES")
WARP = 32

def _horner(frac):
    """Farrow taps [..., 8] at ``frac`` [...], the scan's Horner steps."""
    tt = CF[0]
    fr = frac[..., None]
    for j in range(1, CF.shape[0]):
        tt = tt * fr + CF[j]
    return tt


def _window_sum(w_re, w_im, tt):
    return (w_re * tt).sum(-1), (w_im * tt).sum(-1)


def _mid_window(h_re, h_im, p_half, prm):
    """The kernel's mid-symbol interpolation: the candidate index k (the
    last with p_half >= n0, else the first), one Horner at
    clip(p_half - n0_k), the 8 window samples picked by selects."""
    k = torch.zeros(p_half.shape, dtype=torch.int64)
    for q in range(1, len(prm.half_n0s)):
        k = torch.where(p_half >= float(prm.half_n0s[q]), q, k)
    n0 = (prm.half_n0s[0] + k).to(torch.float32)
    tt = _horner(torch.clamp(p_half - n0, 0.0, CQ.FRAC_MAX))
    s0 = CQ.HIST_C - 5 - prm.half_n0s[0]
    w_re, w_im = h_re[..., s0:s0 + 8], h_im[..., s0:s0 + 8]
    for q in range(1, len(prm.half_n0s)):
        pick = (k == q)[..., None]
        w_re = torch.where(pick, h_re[..., s0 - q:s0 - q + 8], w_re)
        w_im = torch.where(pick, h_im[..., s0 - q:s0 - q + 8], w_im)
    return _window_sum(w_re, w_im, tt), k


def _arg(y_re, y_im, p_re, p_im):
    z_re = y_re * p_re + y_im * p_im
    z_im = y_im * p_re - y_re * p_im
    return torch.atan2(z_im, z_re) / CQ.QUARTER_PI


def _dibit(arg):
    return torch.where(arg > 2.0, 1, torch.where(
        arg > 0.0, 0, torch.where(arg > -2.0, 2, 3))).to(torch.int32)


def _plan(y_re, y_im, scale, state, baud):
    """The kernel's plan over one block; returns what
    ``track_cqpsk_plain`` returns, how often each row of each lane was
    recorded, and how many times a lane waited for its tile's ring."""
    prm = CQ.cqpsk_params(FS, baud)
    s_n, n, c_n = y_re.shape
    g = scale[:, None, :]
    x = torch.complex(y_re * g, y_im * g).transpose(1, 2)   # [S, C, N]
    x_re, x_im = x.real, x.imag
    t, omega, freq, phase, h_re, h_im, p_re, p_im = state
    carried = (h_re, h_im, p_re, p_im)       # what the producer starts from
    # the consumer's records: rotated samples, each emit's y, the pass
    rot_re = torch.zeros((s_n, c_n, n))      # each row was recorded at
    rot_im = torch.zeros((s_n, c_n, n))
    sym_re = torch.zeros((s_n, c_n, n))
    sym_im = torch.zeros((s_n, c_n, n))
    emits = torch.zeros((s_n, c_n, n), dtype=torch.bool)
    writes = torch.zeros((s_n, c_n, n), dtype=torch.int64)
    taken = torch.zeros((s_n, c_n, n), dtype=torch.int64)
    i = torch.zeros((s_n, c_n), dtype=torch.int64)   # each lane's sample
    tile = (torch.arange(s_n * c_n) // WARP).reshape(s_n, c_n)
    tiles = int(tile.max()) + 1
    stages = -(-n // STAGE)
    handed = [0] * tiles                     # stages each tile handed over
    handed_at = torch.full((tiles, stages), -1)   # and the pass of each
    waits = 0
    lane = (torch.arange(s_n)[:, None], torch.arange(c_n)[None, :])

    def record(mask, pas):
        s, c = mask.nonzero(as_tuple=True)
        writes[s, c, i[s, c]] += 1
        taken[s, c, i[s, c]] = pas

    for pas in range(n + 1):                 # one symbol of every lane
        # each tile at its slowest lane hands over the stages its lanes
        # have all passed; the producer refills each slot it has turned
        # with the stage STAGES on
        lo = torch.full((tiles,), n).scatter_reduce(
            0, tile.reshape(-1), i.reshape(-1), "amin")
        for w in range(tiles):
            while (handed[w] < stages
                   and min(n, (handed[w] + 1) * STAGE) <= int(lo[w])):
                handed_at[w, handed[w]] = pas
                handed[w] += 1
        if bool((i >= n).all()):
            break
        lim = torch.clamp(torch.tensor(handed) + STAGES, max=stages)[tile]
        lim = torch.clamp(lim * STAGE, max=n)
        emit = torch.zeros((s_n, c_n), dtype=torch.bool)
        take = i < lim
        while bool(take.any()):              # samples up to the emit
            k = i.clamp(max=n - 1)
            xr_n, xi_n = x_re[lane + (k,)], x_im[lane + (k,)]
            ph = torch.remainder(phase + freq + CQ.TWO_PI, CQ.TWO_PI)
            co, si = torch.cos(ph), torch.sin(ph)
            xr = xr_n * co + xi_n * si
            xi = xi_n * co - xr_n * si
            phase = torch.where(take, ph, phase)
            h_re = torch.where(take[..., None], torch.cat(
                [h_re[..., 1:], xr[..., None]], -1), h_re)
            h_im = torch.where(take[..., None], torch.cat(
                [h_im[..., 1:], xi[..., None]], -1), h_im)
            rot_re[lane + (k,)] = torch.where(take, xr, rot_re[lane + (k,)])
            rot_im[lane + (k,)] = torch.where(take, xi, rot_im[lane + (k,)])
            record(take, pas)
            t = torch.where(take, t + 1.0, t)
            hit = take & (t >= omega)
            emit |= hit
            quiet = take & ~hit
            i = torch.where(quiet, i + 1, i)
            take = quiet & (i < lim)
        waits += int(((i == lim) & (i < n) & ~emit).sum())
        if not bool(emit.any()):
            continue
        # the symbol instant, every emitting lane at once
        frac_late = t - omega
        p_sym = frac_late + CQ._DELAY
        p_half = p_sym + omega * 0.5
        y_r, y_i = _window_sum(
            h_re[..., S_VAL:S_VAL + 8], h_im[..., S_VAL:S_VAL + 8],
            _horner(torch.clamp(p_sym - CQ._DELAY, 0.0, CQ.FRAC_MAX)))
        (m_r, m_i), _ = _mid_window(h_re, h_im, p_half, prm)
        e_t = torch.clamp((y_r - p_re) * m_r + (y_i - p_im) * m_i, -1.0, 1.0)
        omega = torch.where(emit, torch.clamp(omega - prm.k_om * e_t,
                                              prm.omega_lo, prm.omega_hi),
                            omega)
        t = torch.where(emit, frac_late + prm.k_mu * e_t, t)
        arg = _arg(y_r, y_i, p_re, p_im)
        err4 = torch.remainder(arg * CQ.PI - CQ.PI + CQ.PI, CQ.TWO_PI) - CQ.PI
        err = err4 * 0.25
        freq = torch.where(emit, torch.clamp(freq + prm.k_f * err / omega,
                                             -prm.fmax, prm.fmax), freq)
        p_re = torch.where(emit, y_r, p_re)
        p_im = torch.where(emit, y_i, p_im)
        k = lane + (i.clamp(max=n - 1),)
        sym_re[k] = torch.where(emit, y_r, sym_re[k])
        sym_im[k] = torch.where(emit, y_i, sym_im[k])
        emits[k] |= emit
        i = torch.where(emit, i + 1, i)
    # the hand-over: every stage handed over, after the pass that
    # recorded the last of its rows in each lane of the tile
    assert bool((handed_at >= 0).all())
    rows = torch.arange(n) // STAGE
    assert bool((taken < handed_at[tile][..., rows]).all())
    out, valid = _produce(rot_re, rot_im, emits, sym_re, sym_im, *carried)
    new = CQ.CqpskState(t, omega, freq, phase, h_re, h_im, p_re, p_im)
    return (new, out, valid, _dibit(out)), writes, waits


def _produce(rot_re, rot_im, emits, sym_re, sym_im, h_re, h_im, p_re,
             p_im):
    """The producer warps, from the consumer's records and the carried
    history and prev: (syms, valid) [S, C, N]. The interpolation warp's
    window is the history's value window, as the consumer's at the same
    row."""
    held = _horner(torch.zeros(()))          # value taps at fraction 0
    out = torch.zeros(rot_re.shape)
    valid = torch.zeros(rot_re.shape, dtype=torch.int32)
    for r in range(rot_re.shape[-1]):
        h_re = torch.cat([h_re[..., 1:], rot_re[..., r, None]], -1)
        h_im = torch.cat([h_im[..., 1:], rot_im[..., r, None]], -1)
        emit = emits[..., r]
        y_r, y_i = _window_sum(h_re[..., S_VAL:S_VAL + 8],
                               h_im[..., S_VAL:S_VAL + 8], held)
        y_r = torch.where(emit, sym_re[..., r], y_r)
        y_i = torch.where(emit, sym_im[..., r], y_i)
        out[..., r] = _arg(y_r, y_i, p_re, p_im)
        valid[..., r] = emit.to(torch.int32)
        p_re = torch.where(emit, y_r, p_re)
        p_im = torch.where(emit, y_i, p_im)
    return out, valid


def _lanes(baud, s, c, n, rng):
    """[S, n, C] complex64 lanes in turn: the signal (the three fixtures
    at 4800 Bd, the Phase 2 superframe at 6000 Bd; scaled and rotated per
    lane), noise, a CQPSK stream 5% fast and one 5% slow (their omega
    starts at the low and the high clamp and stays pinned there: the most
    drift), and silence. Returns the lanes and the start omega [S, C]."""
    prm = CQ.cqpsk_params(FS, baud)
    if baud == 4800.0:
        sigs = [streams.cqpsk_fixture(k)[0] for k in streams.CQPSK_FIXTURES]
    else:
        sigs = [M.cqpsk_modulate(streams.tdma_superframe()[0], fs=FS,
                                 symbol_rate=baud)]
    nsym = int(n * 1.05 * baud / FS) + 16
    fast, slow = (M.cqpsk_modulate(rng.integers(0, 4, nsym), fs=FS,
                                   symbol_rate=baud * r)
                  for r in (1.05, 0.95))
    lanes = np.zeros((s, n, c), np.complex64)
    omega = np.full((s, c), FS / baud, np.float32)
    for lane in range(s * c):
        i, j = divmod(lane, c)
        kind = lane % 5
        if kind == 0:
            sig = sigs[(lane // 5) % len(sigs)]
            lanes[i, :, j] = (0.3 + 0.7 * (lane % 4) / 3) * np.exp(
                2j * np.pi * (lane % 7) / 7) * sig[:n]
        elif kind == 1:
            lanes[i, :, j] = (rng.standard_normal(n)
                              + 1j * rng.standard_normal(n))
        elif kind in (2, 3):
            lanes[i, :, j] = (fast, slow)[kind - 2][:n]
            omega[i, j] = (prm.omega_lo, prm.omega_hi)[kind - 2]
    return lanes, torch.from_numpy(omega)


def _planes(lanes):
    return (torch.from_numpy(np.ascontiguousarray(lanes.real)),
            torch.from_numpy(np.ascontiguousarray(lanes.imag)))


@pytest.mark.parametrize("baud,s,n,c", [
    (4800.0, 1, 2500, 64), (6000.0, 1, 2500, 40), (4800.0, 2, 1001, 33),
    (6000.0, 1, 1001, 64), (4800.0, 2, 37, 40), (6000.0, 2, 37, 33),
    (4800.0, 2, 5, 64), (6000.0, 2, 5, 40), (4800.0, 2, 1, 33),
    (6000.0, 2, 1, 64), (4800.0, 1, 2500, 45), (6000.0, 1, 2500, 45),
    (4800.0, 3, 100, 11), (6000.0, 3, 100, 11)])
def test_symbol_major_plan_matches_plain(baud, s, n, c):
    """Two blocks in a row from a mid-stream start (HEAD samples through
    the plain version): outputs and all eight state tensors of the plan
    equal the plain tracker's bit for bit, every row of every lane is
    recorded once, and a tile hands each stage over after its lanes
    have recorded it. N a whole 100 ms block (2500), off it (1001), a
    few symbols (37), about one (5), one sample (1) and a block whose
    last stage is partial (100: lanes end mid-symbol and mid-stage); C =
    64, 40, 33, and S·C = 45 and 33, whose last tile holds 13 lanes and
    one. Over a whole block the pinned lanes drift past the ring, and
    wait."""
    rng = np.random.default_rng(int(baud) + n + c)
    lanes, omega0 = _lanes(baud, s, c, HEAD + 2 * n, rng)
    st0 = CQ.cqpsk_init(FS, baud, (s, c))._replace(omega=omega0)
    y_re, y_im = _planes(lanes[:, :HEAD])
    st0 = cqk.track_cqpsk_plain(y_re, y_im, CQ.agc_scale(y_re, y_im, dim=1),
                                st0, FS, baud)[0]
    st = [st0, st0]
    emitted = waited = 0
    for b in range(2):
        y_re, y_im = _planes(lanes[:, HEAD + b * n:HEAD + (b + 1) * n])
        scale = CQ.agc_scale(y_re, y_im, dim=1)
        got, writes, waits = _plan(y_re, y_im, scale, st[0], baud)
        waited += waits
        want = cqk.track_cqpsk_plain(y_re, y_im, scale, st[1], FS, baud)
        st = [got[0], want[0]]
        assert bool((writes == 1).all())
        for g_, w_ in zip(got[1:], want[1:]):
            assert g_.dtype == w_.dtype and torch.equal(g_, w_)
        for g_, w_ in zip(got[0], want[0]):
            assert torch.equal(g_, w_)
        emitted += int(want[2].sum())
    assert emitted > 0 or n == 1
    assert (waited > 0) == (n == 2500)
    if n >= 1001:     # the pinned lanes stayed within a tenth of the
        prm = CQ.cqpsk_params(FS, baud)      # 2% span from their clamps
        flat = st[1].omega.reshape(-1)
        kinds = torch.arange(s * c) % 5
        for kind, clamp in ((2, prm.omega_lo), (3, prm.omega_hi)):
            assert float((flat[kinds == kind] - clamp).abs().max()) \
                < 0.1 * CQ.OMEGA_REL * FS / baud


@pytest.mark.parametrize("baud", [4800.0, 6000.0])
def test_held_and_picked_taps_match_the_scan(baud):
    """The value taps held for the launch equal the scan's per-sample
    Horner off a symbol instant (fraction clip((0 + 4) - 4) = 0), and the
    mid-symbol window picked by selects after one Horner at
    clip(p_half - n0) equals the scan's where-chain over every
    candidate's interpolation, bit for bit: p_half = (frac + 4) + omega/2
    for omega across the clamp and fractions across [0, 1), with every
    candidate picked somewhere, and p_half landing exactly on the second
    candidate (float32 5.2 with 0.4, 4.2 with 0.9), where p_half >= n0
    picks it."""
    prm = CQ.cqpsk_params(FS, baud)
    rng = np.random.default_rng(int(baud))
    on_n0 = {4800.0: (5.2, 0.4), 6000.0: (4.2, 0.9)}[baud]
    om, fl = torch.meshgrid(
        torch.cat([torch.linspace(prm.omega_lo, prm.omega_hi, 41),
                   torch.tensor([on_n0[0]])]),
        torch.tensor([0.0, 0.25, 0.5, 0.75, 0.999, 0.9999, on_n0[1]]),
        indexing="ij")
    h_re, h_im = (torch.from_numpy(rng.standard_normal(
        om.shape + (CQ.HIST_C,)).astype(np.float32)) for _ in range(2))
    frac0 = torch.clamp((torch.zeros_like(om) + CQ._DELAY) - CQ._DELAY,
                        0.0, CQ.FRAC_MAX)
    want = CQ._interp_fixed(h_re, h_im, int(CQ._DELAY), frac0, CF)
    got = _window_sum(h_re[..., S_VAL:S_VAL + 8], h_im[..., S_VAL:S_VAL + 8],
                      _horner(torch.zeros(())))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    p_half = (fl + CQ._DELAY) + om * 0.5
    assert float(p_half[-1, -1]) == prm.half_n0s[1]
    m_re = m_im = None
    for n0 in prm.half_n0s:                   # cqpsk_demod's where-chain
        c_re, c_im = CQ._interp_fixed(
            h_re, h_im, n0, torch.clamp(p_half - float(n0), 0.0,
                                        CQ.FRAC_MAX), CF)
        if m_re is None:
            m_re, m_im = c_re, c_im
        else:
            sel = p_half >= float(n0)
            m_re, m_im = torch.where(sel, c_re, m_re), torch.where(
                sel, c_im, m_im)
    (g_re, g_im), k = _mid_window(h_re, h_im, p_half, prm)
    assert torch.equal(g_re, m_re) and torch.equal(g_im, m_im)
    assert set(k.unique().tolist()) == set(range(len(prm.half_n0s)))


def test_kernel_constants_and_args(monkeypatch):
    """The wrapper's constants are the kernel's, ``kernel_args`` hands
    the launcher the C signature's arguments, and a rate with more
    mid-symbol candidates than the kernel picks among is refused before
    any launch."""
    assert f"constexpr int MAX_CAND = {cqk.MAX_CANDIDATES};" in SRC
    assert f"constexpr int PROBE_ROWS = {cqk.PROBE_ROWS};" in SRC
    assert STAGES >= 2 and STAGE >= 8
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    y = torch.zeros((1, 4, 2))
    st = CQ.cqpsk_init(FS, 4800.0, (1, 2))
    args, (syms, valid, dibits) = cqk.kernel_args(
        y, y, torch.ones((1, 2)), st, FS, 4800.0)
    assert len(args) == len(kernels._SIGNATURES["cqpsk_track_launch"])
    assert args[15:20] == (1, 4, 2, 6, 2)
    assert syms.shape == valid.shape == dibits.shape == (1, 4, 2)
    prm = CQ.cqpsk_params(FS, 4800.0)._replace(half_n0s=(5, 6, 7, 8))
    with pytest.raises(ValueError, match="candidates"):
        cqk._loop_args(prm)


@pytest.mark.parametrize("name", ["tiles=1", "tiles=2", "stage=16",
                                  "stages=2", "group=1", "group=2",
                                  "libm_fmod", "no_sincos", "no_atan",
                                  "no_div", "no_shift", "nco_inline",
                                  "consumer_alone", "producers_alone",
                                  "probe_store", "symbol_warps=1",
                                  "symbol_warps=4", "no_gain"])
def test_variant_builds_change_what_they_name(name):
    """``tools/cqpsk_variants.py`` rewrites a copy of the kernel: every
    text a variant edits is in the source once, so no variant silently
    times the package's kernel, and a sized variant sets its constant
    from the package's value."""
    from radiocapture_tpu_torch.tools import cqpsk_variants as cv
    out = cv.variant_source(SRC, name)
    assert out != SRC
    key, _, size = name.partition("=")
    if size:
        line, value = cv.SIZED[key]
        assert line.format(size) in out and line.format(value) in SRC
        assert _const({"tiles": "MAX_TILES"}.get(key, key.upper())) == value
