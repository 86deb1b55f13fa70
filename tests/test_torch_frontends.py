"""Port parity, the ``pfb`` and ``fft`` frontend modes and the block-
feedback tracker: ``PfbChannelizer``, ``PfbXlatBank``, ``FftXlatBank`` and
``fsk4_demod_block`` of the port against the JAX package's on the same
seeded inputs; the three pipelines and ``SiteRuntime`` on each mode;
``convert`` on their states. The JAX fine stage of ``PfbXlatBank`` is its
CPU conv; the port's is the complex bank's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.demod import fsk4 as JF
from radiocapture_tpu.frontend.pipeline import (AnalogVoicePipeline as JVoice,
                                                ControlPipeline as JControl,
                                                CqpskControlPipeline as JCq)
from radiocapture_tpu.ops import channelizer as JC
from radiocapture_tpu.ops import fir as JFIR
from radiocapture_tpu.ops import fm as JFM
from radiocapture_tpu.ops.fft_bank import FftXlatBank as JFft
from radiocapture_tpu.testing import modulators as JM
from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.demod import fsk4 as TF
from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                      ControlPipeline,
                                                      CqpskControlPipeline)
from radiocapture_tpu_torch.ops import channelizer as TC
from radiocapture_tpu_torch.ops.fft_bank import FftXlatBank
from test_c4fm_chain import FS as CH_FS, SYMBOL_RATE, _make_control_stream
from test_torch_cqpsk import check_cqpsk_pipeline
from test_torch_pipeline import check_control_pipeline
from test_torch_runtime import _both, _p25, _wideband_capture
from test_torch_voice import check_analog_pipeline

torch.set_num_threads(1)   # six test workers share the machine

PFB_REL = 1e-4        # PfbChannelizer: × max|y| (float32, sum order only)
PFB_BANK_ATOL = 2e-3  # PfbXlatBank: JAX's own tolerance,
#                       test_ops_channelizer.py:301
FFT_REL_RMS = 1e-4    # FftXlatBank against JAX's, relative RMS
FFT_XLAT_REL_RMS = 1.5e-2   # against the xlat bank (the FIR's stopband
#                             leakage at n_blk = 256, fft_bank.py:22-31)


def _cnormal(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("fs,m", [(800e3, 8), (1.6e6, 16)])
def test_pfb_channelizer_matches_jax(fs, m):
    """Two sources, one block and the same samples in four blocks: the
    port's channels within PFB_REL·max|y| of the JAX channelizer's (one
    source at a time), and its history carried exactly."""
    rng = np.random.default_rng(m)
    x = _cnormal(rng, (2, m * 1024))
    jp, tp = JC.PfbChannelizer.for_rates(fs, m), TC.PfbChannelizer.for_rates(
        fs, m)
    assert (tp.p, tp.ntaps) == (jp.p, jp.ntaps)
    np.testing.assert_array_equal(tp.hp2, jp.hp2)
    want, jhist = [], []
    for s in range(2):
        st, y = jp(jp.init(), jnp.asarray(x[s]))
        want.append(np.asarray(y))
        jhist.append(np.asarray(st.history))
    want = np.stack(want)
    scale = np.abs(want).max()
    st, y = tp(tp.init(2, "cpu"), torch.from_numpy(x))
    assert y.shape == (2, m, 1024)
    np.testing.assert_allclose(y.numpy(), want, atol=PFB_REL * scale)
    np.testing.assert_array_equal(st.history.numpy(), np.stack(jhist))
    st, outs = tp.init(2, "cpu"), []
    for blk in np.split(x, 4, axis=1):
        st, yb = tp(st, torch.from_numpy(blk))
        outs.append(yb.numpy())
    np.testing.assert_allclose(np.concatenate(outs, -1), want,
                               atol=PFB_REL * scale)
    assert tp.channel_offset_hz(m - 1, fs) == jp.channel_offset_hz(m - 1, fs)


def _pfb_wideband(fs, n):
    """Two sources at fs: tones in channels at +500 and −433 kHz over
    noise (the JAX tones test's), and noise alone."""
    src0 = JM.multi_channel(fs, [
        (500e3, JM.upsample_to(JM.tone(25000.0, 2000.0, 15000), 25000, fs)),
        (-433e3, JM.upsample_to(JM.tone(25000.0, -3000.0, 15000), 25000,
                                fs))], n, noise_floor_db=-30.0)
    src1 = JM.multi_channel(fs, [], n, noise_floor_db=-10.0,
                            rng=np.random.default_rng(9))
    return np.stack([src0, src1]).astype(np.complex64)


def test_pfb_xlat_bank_matches_jax():
    """2.4 MHz, three slots per source, three blocks: the port's
    ``PfbXlatBank`` within PFB_BANK_ATOL of the JAX bank (vmapped over
    sources). The slots sit exactly half a bin off (±1.5 bins: round half
    to even, bins 2 and 4 — the negative one wrapped), on a negative bin
    (−433 kHz: bin 5) and on bins 0 and 1; the routing equals JAX's.
    Before the last block slot 0 of source 0 moves to another bin and
    keeps its fine history, as in JAX."""
    fs = 2.4e6
    jb, tb = JC.PfbXlatBank(3, fs, 12500.0), TC.PfbXlatBank(3, fs, 12500.0)
    assert (tb.m, tb.decim2, tb.decim, tb.ntaps2) == (
        jb.m, jb.decim2, jb.decim, jb.ntaps2)
    np.testing.assert_array_equal(tb.fine_taps, jb.fine_taps)
    offs = np.array([[0.25, -0.25, -433e3 / fs],
                     [500e3 / fs, np.float32(1 / 12), 0.0]], np.float32)
    bins, fine = tb.route(torch.from_numpy(offs))
    assert bins.tolist() == [[2, 4, 5], [1, 0, 0]]
    cyc = jnp.asarray(offs) * jnp.float32(jb.m)
    chan = jnp.round(cyc).astype(jnp.int32)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jnp.mod(chan, 6)))
    np.testing.assert_array_equal(
        fine.numpy(), np.asarray(cyc - chan.astype(jnp.float32)))
    block = tb.decim * 256
    x = _pfb_wideband(fs, 3 * block)
    jstep = jax.jit(jax.vmap(jb.__call__))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                       jb.init())
    tst = tb.init(2, "cpu")
    for b in range(3):
        if b == 2:
            offs[0, 0] = 200e3 / fs
        xb = x[:, b * block:(b + 1) * block]
        jst, jy = jstep(jst, jnp.asarray(xb), jnp.asarray(offs))
        tst, ty = tb(tst, torch.from_numpy(xb), torch.from_numpy(offs))
        assert ty.shape == (2, 3, block // tb.decim)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=PFB_BANK_ATOL)
        st2, y_re, y_im = tb.call_planes(
            tb.init(2, "cpu"), torch.view_as_real(torch.from_numpy(xb)),
            torch.from_numpy(offs))
        assert y_re.shape == (2, block // tb.decim, 3)
    np.testing.assert_array_equal(tst.fine.phase.numpy().astype(np.uint32),
                                  np.asarray(jst.fine.phase))
    np.testing.assert_allclose(tst.fine.history.numpy(),
                               np.asarray(jst.fine.history), atol=1e-6)


def _rel_rms(a, b):
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2) / np.mean(np.abs(b) ** 2)))


def test_fft_bank_matches_jax():
    """200 kHz, five slots, n_blk = 256: the port's ``FftXlatBank`` on a
    three-window block and then window by window stays within FFT_REL_RMS
    of the JAX bank's and within FFT_XLAT_REL_RMS of the port's
    ``XlatBank``; the uint32 phase equals JAX's."""
    samp = 200e3
    xb = TC.XlatBank.for_rates(5, samp, 12.5e3)
    jf = JFft(5, xb.decim, JC.XlatBank.for_rates(5, samp, 12.5e3).taps,
              n_blk=256)
    tf = FftXlatBank(5, xb.decim, xb.taps, n_blk=256)
    assert (tf.v, tf.t_window, tf.block_multiple) == (
        jf.v, jf.t_window, jf.block_multiple)
    np.testing.assert_array_equal(tf.hband, jf._hband)
    rng = np.random.default_rng(7)
    offs = np.array([[0.0, 0.1, -0.23, 0.31, -0.05],
                     [0.2, -0.1, 0.37, -0.41, 0.013]], np.float32)
    x = _cnormal(rng, (2, 6 * tf.t_window))
    jstep = jax.jit(jax.vmap(jf.__call__))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                       jf.init())
    tst, xst = tf.init(2, "cpu"), xb.init(2, "cpu")
    toffs = torch.from_numpy(offs)
    for lo, hi in ((0, 3), (3, 4), (4, 5), (5, 6)):
        blk = x[:, lo * tf.t_window:hi * tf.t_window]
        jst, jy = jstep(jst, jnp.asarray(blk), jnp.asarray(offs))
        tst, ty = tf(tst, torch.from_numpy(blk), toffs)
        xst, xy = xb(xst, torch.from_numpy(blk), toffs)
        assert ty.shape == (2, 5, blk.shape[1] // tf.decim)
        assert _rel_rms(ty.numpy(), np.asarray(jy)) <= FFT_REL_RMS
        assert _rel_rms(ty.numpy(), xy.numpy()) <= FFT_XLAT_REL_RMS
    np.testing.assert_array_equal(tst.phase.numpy().astype(np.uint32),
                                  np.asarray(jst.phase))
    np.testing.assert_array_equal(tst.history.numpy(),
                                  np.asarray(jst.history))


def _filt(iq):
    """The chain tests' discriminator → boxcar at the channel rate, by
    the JAX package: the input both trackers take."""
    gain = CH_FS / (2 * np.pi * 600.0)
    _, disc = JFM.quadrature_demod(JFM.quad_demod_init(), jnp.asarray(iq),
                                   gain)
    taps = JF.boxcar_taps(CH_FS, SYMBOL_RATE)
    fst = JFIR.FirState(history=jnp.zeros(len(taps) - 1, jnp.float32))
    return np.asarray(JFIR.fir_filter(fst, disc, jnp.asarray(taps))[1])


@pytest.mark.parametrize("split", [None, 250])
def test_fsk4_demod_block_matches_jax(split):
    """``test_c4fm_chain.py``'s fixtures (clean, and 30 dB with a 240 Hz
    offset) as two lanes, in one block or in blocks of 250 samples: the
    port's ``fsk4_demod_block`` gives JAX's emit masks and decisions, and
    its symbols within 1e-4."""
    dibits, _ = _make_control_stream(6)
    clean = JM.c4fm_modulate(dibits, fs=CH_FS)
    rough = JM.awgn(JM.freq_shift(clean, CH_FS, 240.0), snr_db=30.0)
    x = np.stack([_filt(clean), _filt(rough)])
    step = split or x.shape[1]
    jst, tst = JF.fsk4_init((2,)), TF.fsk4_init((2,))
    jblock = jax.jit(lambda st, seg: JF.fsk4_demod_block(
        st, seg, CH_FS, SYMBOL_RATE, block=10))
    outs = {"jax": [], "torch": []}
    for i in range(0, x.shape[1], step):
        seg = x[:, i:i + step]
        jst, jo = jblock(jst, jnp.asarray(seg))
        tst, to = TF.fsk4_demod_block(tst, torch.from_numpy(seg), CH_FS,
                                      SYMBOL_RATE, block=10)
        outs["jax"].append([np.asarray(o) for o in jo])
        outs["torch"].append([o.numpy() for o in to])
    j, t = ([np.concatenate([o[k] for o in outs[w]], -1) for k in range(2)]
            for w in ("jax", "torch"))
    np.testing.assert_array_equal(t[1], j[1])
    assert t[1].sum() > 1000
    np.testing.assert_array_equal(TF.slice_dibits(t[0][t[1]]),
                                  JF.slice_dibits(j[0][j[1]]))
    np.testing.assert_allclose(t[0], j[0], atol=1e-4)
    for a, w in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5)


PIPES = {"control": (JControl.p25_c4fm, ControlPipeline.p25_c4fm),
         "cqpsk": (JCq.p25_cqpsk, CqpskControlPipeline.p25_cqpsk),
         "voice": (JVoice, AnalogVoicePipeline)}


@pytest.mark.parametrize("frontend", ["pfb", "fft"])
@pytest.mark.parametrize("kind", sorted(PIPES))
def test_convert_round_trips(kind, frontend):
    """Random JAX wire states of each pipeline on ``frontend`` (uint32
    phase bits included, the nested ``PfbState`` and per-slot
    ``XlatState`` of pfb) → the port → back, bit for bit; the port's
    start state is the JAX one."""
    jctor, tctor = PIPES[kind]
    jp, tp = jctor(4, 800e3, frontend=frontend), tctor(4, 800e3,
                                                       frontend=frontend)
    jinit = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a),
                                                   (3,) + a.shape),
                         jp.init())
    back = convert.state_to_jax(tp, tp.init(3, "cpu"))
    for a, w in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(jinit)):
        assert a.shape == w.shape
        np.testing.assert_array_equal(a, w)
    rng = np.random.default_rng(len(kind) + len(frontend))
    rand = jax.tree.map(lambda a: (
        rng.integers(-2 ** 31, 2 ** 31, a.shape).astype(np.int32)
        if a.dtype == np.int32 else
        rng.standard_normal(a.shape).astype(np.float32)), jinit)
    st = convert.state_from_jax(tp, rand, "cpu")
    assert type(st.bank) is type(tp.bank.init(3, "cpu"))
    for a, w in zip(jax.tree.leaves(tuple(convert.state_to_jax(tp, st))),
                    jax.tree.leaves(rand)):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    with pytest.raises(ValueError, match="does not match"):
        convert.state_from_jax(tctor(5, 800e3, frontend=frontend), rand,
                               "cpu")


@pytest.mark.parametrize("frontend,fs", [("pfb", 800e3), ("fft", 200e3)])
def test_control_pipeline_matches_jax(frontend, fs):
    """``test_torch_pipeline.py``'s P25 parity at a rate the frontend
    takes (pfb: 400 kHz bins): identical decisions and grants on the
    fixture lane, the JAX state handed over mid-stream."""
    check_control_pipeline("p25", fs, frontend)


@pytest.mark.parametrize("frontend,fs", [("pfb", 800e3), ("fft", 400e3)])
def test_cqpsk_pipeline_matches_jax(frontend, fs):
    check_cqpsk_pipeline(fs, frontend)


@pytest.mark.parametrize("frontend", ["pfb", "fft"])
def test_analog_pipeline_matches_jax(frontend):
    check_analog_pipeline(frontend)


def test_fsk4_block_pipeline_matches_jax():
    """``ControlPipeline.fsk4_block = 10`` in both packages (pfb bank):
    the port's step chains discriminator → boxcar → ``fsk4_demod_block``
    → slicer as the JAX step does; identical decisions and grants."""
    check_control_pipeline("p25", 800e3, "pfb", fsk4_block=10)


def test_p25_grant_recording_matches_jax(tmp_path):
    """``test_torch_runtime.py``'s P25 C4FM grant → recording with
    ``frontend_mode: pfb`` in both runtimes: the instance locks, one
    ``c4fm`` recorder opens, the CDR carries group 500 / user 42, and the
    recorder captured the same IMBE codewords as the JAX runtime's. 20
    blocks: the call and its nine voice frames end by the 16th."""
    def add(cfg, rx):
        _p25("C4FM")(cfg, rx)
        cfg.frontend_mode = "pfb"

    runs = _both(tmp_path, _wideband_capture(), add, 20)
    frames = {}
    for which, (rt, active, completed, wavs) in runs.items():
        assert type(rt.groups[(2400000, "c4fm")]["pipe"].bank).__name__ == \
            "PfbXlatBank"
        assert rt.instances[0].engine.is_locked, which
        (rec, _src, _slot, _bid, kind), = active
        assert kind == "c4fm"
        cdr = completed[0]["cdr"]
        assert (cdr["system_group_local"], cdr["system_user_local"]) == \
            (500, 42)
        frames[which] = np.array(rec._imbe_frames)
    assert len(frames["torch"]) >= 9
    np.testing.assert_array_equal(frames["torch"], frames["jax"])
