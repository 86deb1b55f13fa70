"""Port parity, CQPSK (P25 LSM): the interpolators, the AGC, the plain
``cqpsk_demod`` loop and ``CqpskControlPipeline`` (4800 Bd control and
6000 Bd Phase 2 TDMA) against the JAX package on the fixtures of
``test_cqpsk_chain.py`` and ``test_tdma.py``, with the stream state
handed over mid-stream through ``convert``. Decisions must be identical
and the decoded messages the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.demod import cqpsk as JC
from radiocapture_tpu.demod import tdma as JT
from radiocapture_tpu.frontend.pipeline import CqpskControlPipeline as JPipe
from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.demod import cqpsk as TC
from radiocapture_tpu_torch.demod.fsk4 import slice_dibits
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import CqpskControlPipeline
from radiocapture_tpu_torch.testing import modulators as M
from radiocapture_tpu_torch.testing import streams
from test_cqpsk_chain import _make_control_stream

torch.set_num_threads(1)   # six test workers share the machine

FS = 25000.0
SYM_ATOL = 1e-3
# Noise lanes: the bank's sums in another order (JAX's f32 conv against
# the port's f32 GEMM) differ by ~1e-6, and the tracking loop feeds that
# back; the emit masks must still agree on this share of the samples
# (the bound of test_torch_pipeline.py).
NOISE_VALID_AGREE = 0.95
@pytest.mark.parametrize("n0", [4, 6, 7])
def test_interp_matches_jax(n0):
    """Both interpolators on the same history and positions, including
    positions the dynamic one clips: atol 1e-5."""
    rng = np.random.default_rng(n0)
    h_re = rng.standard_normal((16, TC.HIST_C)).astype(np.float32)
    h_im = rng.standard_normal((16, TC.HIST_C)).astype(np.float32)
    frac = rng.uniform(0.0, 0.999, 16).astype(np.float32)
    np.testing.assert_array_equal(TC._VAL_FARROW, JC._VAL_FARROW)
    jr, ji = JC._interp_fixed(jnp.asarray(h_re), jnp.asarray(h_im), n0,
                              jnp.asarray(frac))
    tr, ti = TC._interp_fixed(torch.from_numpy(h_re),
                              torch.from_numpy(h_im), n0,
                              torch.from_numpy(frac))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    p = np.float32(n0) + frac
    p[:3] = [3.0, 30.0, 15.2]     # the clips of n0 and frac
    jr, ji = JC._interp(jnp.asarray(h_re), jnp.asarray(h_im), jnp.asarray(p))
    tr, ti = TC._interp(torch.from_numpy(h_re), torch.from_numpy(h_im),
                        torch.from_numpy(p))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)


def test_block_agc_matches_jax():
    """Rows of different power and one silent row (the 1e-9 floor):
    rtol 1e-6."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 500)) + 1j * rng.standard_normal((4, 500))
         ) * np.array([[1e-3], [1.0], [40.0], [0.0]])
    x = x.astype(np.complex64)
    want = np.asarray(JC.block_agc(jnp.asarray(x)))
    got = TC.block_agc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def test_cqpsk_params_refuse_long_symbols():
    """The loud failure above ~28 samples/symbol is kept."""
    with pytest.raises(ValueError, match="samples/symbol"):
        TC.cqpsk_params(200e3, 4800.0)
    assert TC.cqpsk_params(25000.0, 4800.0).half_n0s == (6, 7)
    assert TC.cqpsk_params(25000.0, 6000.0).half_n0s == (6, 7)


def test_fixture_streams_match_jax_tests():
    """The port's fixture streams (used where JAX is absent) equal those
    of test_cqpsk_chain.py and of the JAX ``build_tdma_stream``."""
    for n, nac in ((6, 0x293), (5, 0x123)):
        got, want = streams.p25_control_stream(n, nac), \
            _make_control_stream(n, nac)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    dib, voice = streams.tdma_superframe()
    np.testing.assert_array_equal(
        dib, JT.build_tdma_stream(*streams.TDMA_KEY, voice))


@pytest.mark.parametrize("kind", ["clean", "offset_noise", "clock_drift"])
def test_cqpsk_demod_matches_jax(kind):
    """test_cqpsk_chain fixtures in two AGC'd blocks. JAX runs both; the
    port takes over the JAX state after the first through ``convert``
    and runs the second: identical emit masks and compacted dibits,
    symbols within 1e-3, and the grants of both blocks decode."""
    iq, expected = streams.cqpsk_fixture(kind)
    half = len(iq) // 2
    blocks = [iq[:half], iq[half:2 * half]]
    jst = JC.cqpsk_init(FS, 4800.0)
    jout = []
    for i, blk in enumerate(blocks):
        if i == 1:
            arrays = jax.tree.map(np.asarray, jst)
            tst = convert.cqpsk_state_from_jax(arrays, "cpu")
            for a, w in zip(convert.cqpsk_state_to_jax(tst), arrays):
                np.testing.assert_array_equal(a, w)
        jst, (sy, va) = JC.cqpsk_demod(jst, JC.block_agc(jnp.asarray(blk)),
                                       FS, 4800.0)
        jout.append((np.asarray(sy), np.asarray(va)))
    tst, (tsy, tva) = TC.cqpsk_demod(
        tst, TC.block_agc(torch.from_numpy(blocks[1])), FS, 4800.0)
    jsy, jva = jout[1]
    np.testing.assert_array_equal(tva.numpy(), jva)
    np.testing.assert_allclose(tsy.numpy(), jsy, atol=SYM_ATOL)
    np.testing.assert_array_equal(slice_dibits(tsy.numpy()[jva]),
                                  slice_dibits(jsy[jva]))
    for a, w in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-3)
    rx = np.concatenate([slice_dibits(jout[0][0][jout[0][1]]),
                         slice_dibits(tsy.numpy()[tva.numpy()])])
    got = streams.grants(rx)
    assert got == streams.grants(np.concatenate(
        [slice_dibits(s[v]) for s, v in jout]))
    assert len(got) >= 4 and all(g in expected for g in got)


def _jax_stream(jp, n_src, x, offs, block, tp):
    """Run the JAX pipeline (vmapped over sources) and the port's over
    the blocks of x [S, n, 2], handing the JAX state to the port after
    the first block; returns both outputs concatenated over blocks."""
    jstep = jax.jit(jax.vmap(jp._step_impl))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (n_src,) + a.shape),
                       jp.init())
    tst = tp.init(n_src, "cpu")
    toffs = torch.from_numpy(offs)
    outs = {"jax": [], "torch": []}
    for b in range(x.shape[1] // block):
        xb = x[:, b * block:(b + 1) * block]
        if b == 1:
            arrays = jax.tree.map(np.asarray, jst)
            tst = convert.state_from_jax(tp, arrays, "cpu")
            back = convert.state_to_jax(tp, tst)
            for a, w in zip(jax.tree.leaves(tuple(back)),
                            jax.tree.leaves(arrays)):
                np.testing.assert_array_equal(a, w)
        jst, jo = jstep(jst, jnp.asarray(xb), jnp.asarray(offs))
        tst, to = tp.step(tst, wire_from_numpy(xb, "cpu"), toffs)
        outs["jax"].append([np.asarray(o) for o in jo])
        outs["torch"].append([o.numpy() for o in to])
    return [[np.concatenate([o[i] for o in outs[k]], -1) for i in range(3)]
            for k in ("jax", "torch")]


def test_cqpsk_pipeline_matches_jax():
    """test_cqpsk_pipeline_wideband's shape (400 kS/s, 4 slots, NACs
    0x293 at −75 kHz and 0x123 at +50 kHz), two sources (the second with
    the systems swapped), two blocks: signal slots within 1e-3 with
    identical decisions, noise slots to NOISE_VALID_AGREE; both systems
    decode on both sources."""
    check_cqpsk_pipeline()


def check_cqpsk_pipeline(fs=400e3, frontend="xlat"):
    """``test_cqpsk_pipeline_matches_jax`` at ``fs`` with the JAX and the
    port's pipelines on ``frontend``: two blocks, each a whole number of
    the pipeline's block multiple."""
    n_src, n_slots = 2, 4
    systems = [_make_control_stream(5, nac=n) for n in (0x293, 0x123)]
    iqs = [M.upsample_to(M.cqpsk_modulate(d, fs=FS), FS, fs)
           for d, _ in systems]
    jp = JPipe.p25_cqpsk(num_slots=n_slots, samp_rate=fs, frontend=frontend)
    tp = CqpskControlPipeline.p25_cqpsk(n_slots, fs, frontend=frontend)
    assert (tp.decim, tp.block_multiple) == (jp.decim, jp.block_multiple)
    bm = tp.block_multiple
    block = max(1, -(-max(map(len, iqs)) // (2 * bm))) * bm
    wide = [M.multi_channel(fs, [(-75e3, a), (50e3, b)], 2 * block,
                            noise_floor_db=-50.0,
                            rng=np.random.default_rng(7 + i))
            for i, (a, b) in enumerate((iqs, iqs[::-1]))]
    x = np.stack([np.stack([w.real, w.imag], -1) for w in wide]
                 ).astype(np.float32)
    offs = np.tile(np.array([-75e3, 50e3, 0.0, 125e3], np.float32) / fs,
                   (n_src, 1))
    j, t = _jax_stream(jp, n_src, x, offs, block, tp)
    assert t[0].shape == (n_src, n_slots, 2 * block // tp.decim)
    for a, w in zip(t, j):
        assert a.dtype == w.dtype
    sig = np.s_[:, :2]
    if frontend == "fft":
        # a fft block is a whole FFT window: from the bursts' end on the
        # signal slots carry a near-silent tail where the loop runs on
        # rounding noise, as the noise slots do (measured: symbols off by
        # > SYM_ATOL from 14 samples before the end); held to the bursts
        # but their last millisecond
        sig = np.s_[:, :2, :max(map(len, iqs)) // tp.decim - 25]
    np.testing.assert_array_equal(t[1][sig], j[1][sig])
    np.testing.assert_array_equal(t[2][sig], j[2][sig])
    np.testing.assert_allclose(t[0][sig], j[0][sig], atol=SYM_ATOL)
    agree = np.mean(t[1][:, 2:] == j[1][:, 2:])
    assert agree >= NOISE_VALID_AGREE, agree
    for src in range(n_src):
        for slot in range(2):
            k = slot ^ src                   # which system sits there
            nac, expected = (0x293, 0x123)[k], systems[k][1]
            got = streams.grants(
                t[2][src, slot][t[1][src, slot].astype(bool)], nac)
            assert len(got) >= 3 and all(g in expected for g in got), got


def test_cqpsk_tdma_pipeline_matches_jax():
    """A 6000 Bd Phase 2 superframe (``build_tdma_stream``) through the
    ``tdma=True`` pipeline: the port's outputs framed by the port's copy
    of ``TdmaFramer`` give the same bursts as the JAX outputs through the
    JAX framer: all 12, with the voice codewords that were sent."""
    fs = 400e3
    dib, voice = streams.tdma_superframe()
    iq = M.upsample_to(M.cqpsk_modulate(dib, fs=FS, symbol_rate=6000.0),
                       FS, fs)
    jp = JPipe.p25_cqpsk(2, fs, tdma=True)
    tp = CqpskControlPipeline.p25_cqpsk(2, fs, tdma=True)
    block = len(iq) // (2 * tp.decim) * tp.decim + 8 * tp.decim
    wide = M.multi_channel(fs, [(50e3, iq)], 2 * block, noise_floor_db=-50.0)
    x = np.stack([wide.real, wide.imag], -1)[None].astype(np.float32)
    offs = np.array([[50e3 / fs, -0.2]], np.float32)
    j, t = _jax_stream(jp, 1, x, offs, block, tp)
    np.testing.assert_array_equal(t[1][0, 0], j[1][0, 0])
    np.testing.assert_array_equal(t[2][0, 0], j[2][0, 0])
    np.testing.assert_allclose(t[0][0, 0], j[0][0, 0], atol=SYM_ATOL)
    got = streams.tdma_bursts(t[2][0, 0][t[1][0, 0].astype(bool)])
    want = streams.tdma_bursts(j[2][0, 0][j[1][0, 0].astype(bool)],
                               JT.TdmaFramer(*streams.TDMA_KEY))
    assert got == want
    assert streams.tdma_voice_ok(got, voice)


def test_cqpsk_tracker_rejects_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, never
    silently computed by the plain version."""
    from radiocapture_tpu_torch.demod.cqpsk_kernel import track_cqpsk
    y = torch.zeros((1, 10, 2), device="meta")
    st = TC.cqpsk_init(FS, 4800.0, (1, 2), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        track_cqpsk(y, y, torch.ones((1, 2), device="meta"), st, FS, 4800.0)
