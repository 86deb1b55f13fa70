"""The fsk tracker kernel's plan (``csrc/fsk_track.cu``), emulated on the
CPU against the plain tracker: 32-lane tiles of one source, producer
segments of 16 input samples that take the carried prev sample and
boxcar history at the block start, a ring of 128-sample stages read by
the consumer in tracked-sample rows, the last NT-1 discriminator values
written by the segment that owns them. The CUDA kernel cannot run here;
this holds the index arithmetic it shares with the emulation to the
plain version on the lane counts, block lengths and tracker parameters
the card tests use."""

import numpy as np
import pytest
import torch

from radiocapture_tpu_torch.demod import fsk4 as K
from radiocapture_tpu_torch.demod import track_kernel as tk
from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
from radiocapture_tpu_torch.ops import fm
from radiocapture_tpu_torch.testing import modulators as M

torch.set_num_threads(1)   # six test workers share the machine

TILE, SEG, PRODUCERS, STAGES = 32, tk.SEGMENT, 8, 2
STAGE_IN = SEG * PRODUCERS


def _fsk4_row(xn, clock, ff, h, prm):
    """One fsk4 step on a [TILE] row, as ``fsk4.fsk4_demod`` takes it."""
    st, (y, v) = K.fsk4_demod(K.Fsk4State(clock, ff, h), xn[:, None],
                              prm.track_fs, prm.symbol_rate,
                              levels=prm.levels)
    return st, y[:, 0], v[:, 0]


def _tiled(y_re, y_im, quad, sym_hist, fsk4, prm):
    """The kernel's plan, one block after another, stages in order;
    returns what ``track_plain`` returns, and how often each output was
    written."""
    s_n, n, c_n = y_re.shape
    nt, sd = len(prm.sym_taps), prm.sym_decim
    sd_shift = sd.bit_length() - 1
    assert 1 << sd_shift == sd and SEG % sd == 0
    taps = [float(t) for t in np.asarray(prm.sym_taps, np.float32)]
    m = n // sd
    syms = torch.zeros((s_n, c_n, m))
    valid = torch.zeros((s_n, c_n, m), dtype=torch.bool)
    writes = torch.zeros((s_n, c_n, m), dtype=torch.int64)
    prev = quad.prev.clone()
    new_hist = sym_hist.clone()
    clock_o, ff_o, h_o = (t.clone() for t in fsk4)
    tiles = -(-c_n // TILE)
    n_stages = -(-n // STAGE_IN)
    rows_per_stage = STAGE_IN >> sd_shift
    for blk in range(s_n * tiles):
        s = blk // tiles
        c = (blk % tiles) * TILE + torch.arange(TILE)
        active = c < c_n
        cc = c.clamp(max=c_n - 1)
        ring = torch.zeros((STAGES, STAGE_IN, TILE))
        tail = torch.zeros((7, TILE))
        zero = torch.zeros(TILE)
        pr0 = torch.where(active, prev[s, cc].real, zero)
        pi0 = torch.where(active, prev[s, cc].imag, zero)
        sh = [torch.where(active, sym_hist[s, cc, j], zero)
              for j in range(nt - 1)]
        st = K.Fsk4State(*(t[s, cc] for t in fsk4))   # lanes past C unused
        for q in range(n_stages):
            ring_q = ring[q % STAGES]
            for p in range(PRODUCERS):
                base = q * STAGE_IN + p * SEG
                if base >= n:
                    continue
                ar, ai = [], []
                for j in range(SEG + nt):
                    k = base - nt + j
                    ok = active & (0 <= k < n)
                    kc = min(max(k, 0), n - 1)
                    ar.append(torch.where(ok, y_re[s, kc, cc], zero))
                    ai.append(torch.where(ok, y_im[s, kc, cc], zero))
                if base == 0:
                    ar[nt - 1], ai[nt - 1] = pr0, pi0
                w = [zero] * nt
                for j in range(1, SEG + nt):
                    k = base - nt + j
                    x = torch.complex(ar[j], ai[j])
                    b = torch.conj(torch.complex(ar[j - 1], ai[j - 1]))
                    prod = x * b
                    d = prm.gain * torch.atan2(prod.imag, prod.real)
                    if j < nt and base == 0:
                        d = sh[j - 1]
                    w = w[1:] + [d]
                    if (j >= nt or base == 0) and n - (nt - 1) <= k < n:
                        tail[k - (n - (nt - 1))] = d
                    if j >= nt:
                        kk = j - nt
                        if kk & (sd - 1) == 0 and k < n:
                            xn = taps[nt - 1] * w[0]
                            for i in range(1, nt):
                                xn = xn + taps[nt - 1 - i] * w[i]
                            ring_q[(p * SEG + kk) >> sd_shift] = xn
            m0 = q * rows_per_stage
            for t in range(min(rows_per_stage, m - m0)):
                st, y, v = _fsk4_row(ring_q[t], *st, prm)
                syms[s, c[active], m0 + t] = y[active]
                valid[s, c[active], m0 + t] = v[active]
                writes[s, c[active], m0 + t] += 1
        last = torch.complex(y_re[s, n - 1, cc], y_im[s, n - 1, cc])
        prev[s, c[active]] = last[active]
        for j in range(nt - 1):
            new_hist[s, c[active], j] = tail[j][active]
        clock_o[s, c[active]] = st.clock[active]
        ff_o[s, c[active]] = st.fine_freq[active]
        h_o[s, c[active]] = st.hist[active]
    if len(prm.levels) == 4:
        dibits = K.slice_dibits_torch(syms)
    else:
        dibits = (syms > 0.0).to(torch.int32)
    return ((fm.QuadDemodState(prev), new_hist,
             K.Fsk4State(clock_o, ff_o, h_o), syms, valid.to(torch.int32),
             dibits), writes)


def _lanes(pipe, ctor, s, c, n, rng):
    sps = pipe.channel_fs / pipe.symbol_rate
    nsym = int(n / sps) + 16
    if ctor == "p25_c4fm":
        sigs = [M.c4fm_modulate(rng.integers(0, 4, nsym), fs=pipe.channel_fs)
                for _ in range(3)]
    else:
        sigs = [M.fsk2_modulate(rng.integers(0, 2, nsym), pipe.channel_fs,
                                pipe.symbol_rate, 3000.0) for _ in range(3)]
    lanes = np.zeros((s, n, c), np.complex64)
    for i in range(s):
        for j in range(c):
            amp = 0.3 + 0.7 * ((i * c + j) % 5) / 4
            rot = np.exp(2j * np.pi * ((i * c + j) % 7) / 7)
            lanes[i, :, j] = amp * rot * sigs[(i * c + j) % 3][:n]
    return lanes


@pytest.mark.parametrize("s,c,nb", [(2, 5, 130), (1, 40, 64), (1, 33, 8)])
@pytest.mark.parametrize("ctor", ["p25_c4fm", "edacs"])
def test_tile_plan_matches_plain(ctor, s, c, nb):
    """Two blocks in a row from a mid-stream start: every output written
    once, decisions identical to the plain tracker's, symbols and lane
    state within 1e-4 (the emulated discriminator runs on [32] rows, the
    plain one on the whole block: the same operations, possibly other
    vector code), ``prev`` identical. Lanes off the tile (5, 33, 40), N
    off the 128-sample stage (130), shorter than one (64) and than one
    16-sample segment (8)."""
    pipe = getattr(ControlPipeline, ctor)(2, 200e3)
    prm = pipe.track_params
    rng = np.random.default_rng(nb + c)
    lanes = _lanes(pipe, ctor, s, c, 2 * nb + 40, rng)
    nt = len(prm.sym_taps)
    head = lanes[:, :40]
    st0 = tk.track_plain(torch.from_numpy(head.real.copy()),
                         torch.from_numpy(head.imag.copy()),
                         fm.quad_demod_init((s, c)),
                         torch.zeros((s, c, nt - 1)),
                         K.fsk4_init((s, c)), prm)[:3]
    st = [st0, st0]
    for b in range(2):
        blk = lanes[:, 40 + b * nb:40 + (b + 1) * nb]
        y_re = torch.from_numpy(blk.real.copy())
        y_im = torch.from_numpy(blk.imag.copy())
        got, writes = _tiled(y_re, y_im, *st[0], prm)
        want = tk.track_plain(y_re, y_im, *st[1], prm)
        st = [got[:3], want[:3]]
        assert writes.shape == (s, c, nb // prm.sym_decim)
        assert bool((writes == 1).all())
        assert torch.equal(got[4], want[4])
        assert torch.equal(got[5], want[5])
        assert float((got[3] - want[3]).abs().max()) <= 1e-4
        assert torch.equal(got[0].prev, want[0].prev)
        assert torch.allclose(got[1], want[1], rtol=0.0, atol=1e-4)
        for g_, w_ in zip(got[2], want[2]):
            assert float((g_ - w_).abs().max()) <= 1e-4



@pytest.mark.parametrize("field,value,match", [
    ("sym_decim", 3, "must divide 16"),
    ("sym_taps", np.full(9, 1 / 9, np.float32), "kernel takes 1..8")])
def test_kernel_args_refuse_what_the_kernel_cannot_take(field, value, match):
    """The kernel's operands are validated before any launch: a symbol
    decimation that does not divide the 16-sample producer segment, or a
    boxcar longer than the 8 taps the kernel keeps in registers, raises
    (the wrapper never falls back to the plain version)."""
    prm = ControlPipeline.p25_c4fm(2, 200e3).track_params._replace(
        **{field: value})
    y = torch.zeros((1, 24, 2))
    with pytest.raises(ValueError, match=match):
        tk.kernel_args(y, y, fm.quad_demod_init((1, 2)),
                       torch.zeros((1, 2, len(prm.sym_taps) - 1)),
                       K.fsk4_init((1, 2)), prm)
