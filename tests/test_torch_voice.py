"""Port parity, the analog voice path: the de-emphasis IIR, the rational
resampler, the voice tracker's plain version, ``AnalogVoicePipeline.step``
against the JAX pipeline (vmapped over sources, as the runtime groups
them), the recorder's 8 kHz conversion, and ``convert`` round trips of the
voice state and of grouped runtime states. JAX runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.audio.recorder import CallRecorder as JRecorder
from radiocapture_tpu.frontend.pipeline import AnalogVoicePipeline as JVoice
from radiocapture_tpu.frontend.pipeline import ControlPipeline as JControl
from radiocapture_tpu.ops import fm as JFM
from radiocapture_tpu.ops import resample as JRS
from radiocapture_tpu.testing import modulators as JM
from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.audio.recorder import CallRecorder
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                      ControlPipeline)
from radiocapture_tpu_torch.ops import fm as TFM
from radiocapture_tpu_torch.ops import fm_kernel
from radiocapture_tpu_torch.ops import resample as TRS

torch.set_num_threads(1)   # six test workers share the machine

# The IIR in another association order (the JAX associative_scan against
# the port's doubling scan), float32: z1 ≈ 0.57 keeps it stable, so the
# rounding does not grow along the block.
IIR_TOL = 1e-5
# The bank's f32 sums in another order (test_ops_channelizer.py:28).
BANK_ATOL = 2e-3
# Noise lanes: where a noise sample passes near the origin or its phase
# step near ±π, the bank's ~1e-6 differences move the discriminator by
# up to 2π·gain at that sample (measured: 1 of 8000 noise-lane samples
# in one block of this fixture). Every sample of the tone lane is held
# to BANK_ATOL; of all lanes, this share.
NOISE_AUDIO_SHARE = 0.999
FS = 2.4e6
N_SRC, N_SLOTS, TONE_SLOT = 2, 8, 3
TONE_HZ, TONE_OFFSET_HZ = 1000.0, 150e3


def _blocks(rng, shape, n_blocks):
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(n_blocks)]


def test_deemphasis_matches_jax():
    """``first_order_iir`` and ``fm_deemphasis`` over three streamed
    blocks of [4, 700]: within IIR_TOL of the JAX associative scan."""
    rng = np.random.default_rng(1)
    x = _blocks(rng, (4, 700), 3)
    y0 = rng.standard_normal(4).astype(np.float32)
    got = TFM.first_order_iir(torch.from_numpy(x[0]), 0.95, 0.05,
                              torch.from_numpy(y0))
    want = JFM.first_order_iir(jnp.asarray(x[0]), jnp.float32(0.95),
                               jnp.float32(0.05), jnp.asarray(y0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=IIR_TOL, atol=IIR_TOL)
    tst, jst = TFM.deemph_init((4,)), JFM.deemph_init((4,))
    for blk in x:
        tst, got = TFM.fm_deemphasis(tst, torch.from_numpy(blk), 25000.0)
        jst, want = JFM.fm_deemphasis(jst, jnp.asarray(blk), 25000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=IIR_TOL, atol=IIR_TOL)
        for a, w in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       rtol=IIR_TOL, atol=IIR_TOL)


@pytest.mark.parametrize("rate_in", [25000.0, 12500.0])
def test_rational_resample_matches_jax(rate_in):
    """25 kS/s and 12.5 kS/s channel audio to 8 kHz, streamed in four
    blocks: identical taps, outputs within 1e-6·max|y| (float32 sums of
    the same products)."""
    interp, decim = TRS.resample_ratio(rate_in, 8000.0)
    assert (interp, decim) == JRS.resample_ratio(rate_in, 8000.0)
    taps = TRS.design_resampler_taps(interp, decim)
    np.testing.assert_array_equal(taps, JRS.design_resampler_taps(interp,
                                                                  decim))
    gran = decim // np.gcd(interp, decim)
    rng = np.random.default_rng(2)
    x = _blocks(rng, (gran * 40,), 4)
    tst, jst = TRS.resampler_init(taps, interp), JRS.resampler_init(taps,
                                                                   interp)
    for blk in x:
        tst, got = TRS.rational_resample(tst, torch.from_numpy(blk),
                                         torch.from_numpy(taps), interp,
                                         decim)
        jst, want = JRS.rational_resample(jst, jnp.asarray(blk),
                                          jnp.asarray(taps), interp, decim)
        want = np.asarray(want)
        assert got.shape == want.shape == (gran * 40 * interp // decim,)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-6 * np.abs(want).max())
        np.testing.assert_array_equal(tst.history.numpy(),
                                      np.asarray(jst.history))


def test_voice_track_plain_matches_jax():
    """The tracker's plain version against JAX ``quadrature_demod`` →
    ``fm_deemphasis`` → ``mean(|x|²)`` on [S, N, C] bank planes of an FM
    tone (lane 0) and noise, two blocks with state carried: audio within
    IIR_TOL·max|audio| on the tone lane, power within 1e-6 relative."""
    fs, n, gain = 25000.0, 1200, 25000.0 / (2 * np.pi * 5000.0)
    rng = np.random.default_rng(3)
    tone = JM.fm_modulate(0.8 * np.sin(2 * np.pi * TONE_HZ
                                       * np.arange(2 * n) / fs), fs, 2500.0)
    lanes = (rng.standard_normal((2 * n, 5))
             + 1j * rng.standard_normal((2 * n, 5))).astype(np.complex64)
    lanes[:, 0] = tone
    tq, td = TFM.quad_demod_init((1, 5)), TFM.deemph_init((1, 5))
    jq, jd = JFM.quad_demod_init((1, 5)), JFM.deemph_init((1, 5))
    for b in range(2):
        blk = lanes[None, b * n:(b + 1) * n]                  # [1, N, C]
        tq, td, audio, power = fm_kernel.voice_track_plain(
            torch.from_numpy(blk.real.copy()),
            torch.from_numpy(blk.imag.copy()), tq, td, gain, fs)
        x = jnp.asarray(blk.transpose(0, 2, 1))
        jq, disc = JFM.quadrature_demod(jq, x, gain)
        jd, want = JFM.fm_deemphasis(jd, disc, fs)
        want = np.asarray(want)
        assert audio.shape == want.shape == (1, 5, n)
        np.testing.assert_allclose(audio.numpy()[0, 0], want[0, 0],
                                   atol=IIR_TOL * np.abs(want[0, 0]).max())
        np.testing.assert_allclose(
            power.numpy(), np.asarray(jnp.mean(jnp.abs(x) ** 2, axis=-1)),
            rtol=1e-6)


def _wideband(n):
    """[S, n, 2] f32 wire: an FM 1 kHz tone at TONE_OFFSET_HZ on source
    0, noise on source 1, at FS."""
    t = np.arange(n // 96 + 1) / 25000.0
    tone = JM.fm_modulate(0.8 * np.sin(2 * np.pi * TONE_HZ * t), 25000.0,
                          2500.0)
    src0 = JM.multi_channel(FS, [(TONE_OFFSET_HZ, JM.upsample_to(
        tone, 25000.0, FS))], n, noise_floor_db=-20.0)
    src1 = JM.multi_channel(FS, [], n, noise_floor_db=-10.0,
                            rng=np.random.default_rng(4))
    return np.stack([np.stack([s.real, s.imag], -1) for s in (src0, src1)]
                    ).astype(np.float32)


def test_analog_pipeline_matches_jax():
    """``AnalogVoicePipeline.step`` against the JAX pipeline vmapped over
    2 sources × 8 slots at 2.4 MS/s, three blocks, the JAX state handed
    over mid-stream through ``convert``: audio within BANK_ATOL (tone
    lane: every sample; all lanes: NOISE_AUDIO_SHARE of them), power
    within 1e-4 relative."""
    check_analog_pipeline()


def check_analog_pipeline(frontend="xlat"):
    """``test_analog_pipeline_matches_jax`` with the JAX and the port's
    pipelines on ``frontend``: three blocks of ~20 ms (a whole number of
    the pipeline's block multiple)."""
    jp = JVoice(N_SLOTS, FS, frontend=frontend)
    tp = AnalogVoicePipeline(N_SLOTS, FS, frontend=frontend)
    assert (tp.decim, tp.block_multiple) == (jp.decim, jp.block_multiple)
    bm = tp.block_multiple
    block = bm * max(1, round(48000 / bm))
    n_out = block // tp.decim
    x = _wideband(3 * block)
    offs = np.tile(np.linspace(-0.4, 0.4, N_SLOTS, dtype=np.float32),
                   (N_SRC, 1))
    offs[:, TONE_SLOT] = TONE_OFFSET_HZ / FS
    jstep = jax.jit(jax.vmap(jp._step_impl))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (N_SRC,) + a.shape),
                       jp.init())
    tst = tp.init(N_SRC, "cpu")
    for b in range(3):
        xb = x[:, b * block:(b + 1) * block]
        if b == 1:
            arrays = jax.tree.map(np.asarray, jst)
            tst = convert.state_from_jax(tp, arrays, "cpu")
            back = convert.state_to_jax(tp, tst)
            for a, w in zip(jax.tree.leaves(tuple(back)),
                            jax.tree.leaves(arrays)):
                np.testing.assert_array_equal(a, w)
        jst, (jaudio, jpower) = jstep(jst, jnp.asarray(xb),
                                      jnp.asarray(offs))
        tst, (audio, power) = tp.step(tst, wire_from_numpy(xb, "cpu"),
                                      torch.from_numpy(offs))
        jaudio = np.asarray(jaudio)
        assert audio.shape == jaudio.shape == (N_SRC, N_SLOTS, n_out)
        err = np.abs(audio.numpy() - jaudio)
        assert float(err[0, TONE_SLOT].max()) <= BANK_ATOL
        assert float(np.mean(err <= BANK_ATOL)) >= NOISE_AUDIO_SHARE
        np.testing.assert_allclose(power.numpy(), np.asarray(jpower),
                                   rtol=1e-4)
    # the tone slot carries the 1 kHz tone
    spec = np.abs(np.fft.rfft(audio.numpy()[0, TONE_SLOT]))
    assert abs(np.argmax(spec) * tp.channel_fs / n_out - TONE_HZ) <= 50.0


def test_recorder_to_8k_matches_jax():
    """``CallRecorder._to_8k`` of the port (torch resampler) against the
    JAX recorder's on the same 25 kS/s audio, fed in ragged blocks (the
    staging remainder): equal lengths, within 1e-5."""
    cdr = {"instance_uuid": "i", "call_uuid": "c", "system_group_local": 1}
    got, want = CallRecorder(cdr, None), JRecorder(cdr, None)
    rng = np.random.default_rng(5)
    for n in (2500, 1337, 2500, 811):
        audio = (0.3 * rng.standard_normal(n)).astype(np.float32)
        a, w = got._to_8k(audio), want._to_8k(audio)
        assert a.dtype == w.dtype == np.float32
        assert len(a) == len(w)
        np.testing.assert_allclose(a, w, atol=1e-5)


@pytest.mark.parametrize("kind", ["analog", "c4fm"])
def test_grouped_state_round_trips(kind):
    """A runtime group's stacked JAX state (two sources stepped through
    the vmapped pipeline) → the port's state → JAX wire encoding again:
    bit-exact, mixer phase and bank history included."""
    if kind == "analog":
        jp, tp = JVoice(4, FS), AnalogVoicePipeline(4, FS)
    else:
        jp, tp = JControl.p25_c4fm(4, FS), ControlPipeline.p25_c4fm(4, FS)
    block = tp.block_multiple * 50
    rng = np.random.default_rng(6)
    jstep = jax.jit(jax.vmap(jp._step_impl))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                       jp.init())
    offs = jnp.asarray(rng.uniform(-0.4, 0.4, (2, 4)).astype(np.float32))
    for _ in range(2):
        jst, _out = jstep(jst, jnp.asarray(rng.standard_normal(
            (2, block, 2)).astype(np.float32)), offs)
    arrays = jax.tree.map(np.asarray, jst)
    assert np.any(arrays.bank.phase != 0)
    back = convert.state_to_jax(tp, convert.state_from_jax(tp, arrays, "cpu"))
    assert type(back).__name__ == type(arrays).__name__
    for a, w in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(arrays)):
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
