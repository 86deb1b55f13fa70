"""Port parity, small ops: tap design, modulators, mixer phase, single-
channel xlat FIR, discriminator and the batched symbol FIR, each held
against the JAX package on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiocapture_tpu.frontend import pipeline as jpipe
from radiocapture_tpu.ops import fir as JF
from radiocapture_tpu.ops import fm as JFM
from radiocapture_tpu.ops import taps as JT
from radiocapture_tpu.testing import modulators as JM
from radiocapture_tpu_torch.ops import fir as TF
from radiocapture_tpu_torch.ops import fm as TFM
from radiocapture_tpu_torch.ops import taps as TT
from radiocapture_tpu_torch.testing import modulators as TM

torch.set_num_threads(1)   # six test workers share the machine


@pytest.mark.parametrize("name,args", [
    ("low_pass", (1.0, 2.4e6, 6250.0, 3125.0)),
    ("low_pass_2", (1.0, 2.4e6, 6250.0, 6250.0, 60.0)),
    ("high_pass", (1.0, 8000.0, 300.0, 200.0)),
    ("optimal_low_pass", (1.0, 1.6e6, 40e3, 55e3)),
    ("root_raised_cosine", (1.0, 25000.0, 4800.0)),
    ("c4fm_shaping", (48000.0, 4800.0)),
    ("voice_bandpass", (8000.0,)),
])
def test_taps_identical(name, args):
    """Designed taps are bit-identical (same numpy/scipy code)."""
    np.testing.assert_array_equal(getattr(TT, name)(*args),
                                  getattr(JT, name)(*args))


def test_modulators_identical():
    rng = np.random.default_rng(11)
    dib = rng.integers(0, 4, 200)
    bits = rng.integers(0, 2, 300)
    nb = JM.c4fm_modulate(dib, fs=25000.0)
    cases = [
        (TM.c4fm_modulate(dib, fs=25000.0), nb),
        (TM.fsk2_modulate(bits, 25000.0, 9600.0, 3000.0),
         JM.fsk2_modulate(bits, 25000.0, 9600.0, 3000.0)),
        (TM.upsample_to(nb, 25000.0, 200e3),
         JM.upsample_to(nb, 25000.0, 200e3)),
        (TM.multi_channel(200e3, [(50e3, nb)], 4000),
         JM.multi_channel(200e3, [(50e3, nb)], 4000)),
        (TM.tone(25000.0, 1200.0, 500, 0.5, 0.3),
         JM.tone(25000.0, 1200.0, 500, 0.5, 0.3)),
        (TM.awgn(nb, 20.0), JM.awgn(nb, 20.0)),
        (TM.cqpsk_modulate(dib, fs=25000.0),
         JM.cqpsk_modulate(dib, fs=25000.0)),
        (TM.cqpsk_modulate(dib, fs=25000.0, symbol_rate=6000.0),
         JM.cqpsk_modulate(dib, fs=25000.0, symbol_rate=6000.0)),
        (TM.CQPSK_LEVELS, JM.CQPSK_LEVELS),
    ]
    for got, want in cases:
        np.testing.assert_array_equal(got, want)


def test_phase_step_u32_bit_exact():
    """Bit-exact with JAX, including its float→uint32 saturation: an
    offset of +1e-12 gives 0xFFFFFFFF, not 0."""
    rng = np.random.default_rng(5)
    offs = np.concatenate([
        np.array([1e-12, -1e-12, 0.0, 0.5, -0.5, 0.25, 1 / 96, -1 / 96,
                  0.49999997, -0.49999997], np.float32),
        rng.uniform(-0.5, 0.5, 500).astype(np.float32)])
    for d in (1, 2, 8, 96):
        want = np.asarray(JF._phase_step_u32(jnp.asarray(offs), d))
        got = TF.phase_step_u32(torch.from_numpy(offs), d).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    assert TF.phase_step_u32(torch.tensor([1e-12]), 96).item() == 0xFFFFFFFF


def test_freq_xlating_fir_matches_jax():
    """Single-channel xlat FIR over two blocks (phase and history carry);
    atol 2e-3 as the JAX bank tests (f32 sums in another order)."""
    rng = np.random.default_rng(2)
    taps = JT.low_pass_2(1.0, 200e3, 6250.0, 6250.0, 60.0)
    d = 8
    x = (rng.standard_normal(d * 300)
         + 1j * rng.standard_normal(d * 300)).astype(np.complex64)
    js = JF.xlat_init(len(taps))
    ts = TF.xlat_init(len(taps), "cpu")
    for blk in x.reshape(2, -1):
        js, jy = JF.freq_xlating_fir(js, jnp.asarray(blk), jnp.asarray(taps),
                                     jnp.float32(0.137), d)
        ts, ty = TF.freq_xlating_fir(ts, torch.from_numpy(blk), taps,
                                     0.137, d)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-3)
    assert int(ts.phase) == int(np.asarray(js.phase))


def test_quadrature_demod_matches_jax():
    """Two blocks in a row over a [3, n] batch; rtol/atol 1e-5."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 400))
         + 1j * rng.standard_normal((3, 400))).astype(np.complex64)
    js = JFM.quad_demod_init(batch_shape=(3,))
    ts = TFM.quad_demod_init((3,), "cpu")
    for blk in np.split(x, 2, axis=1):
        js, jy = JFM.quadrature_demod(js, jnp.asarray(blk), 3.3)
        ts, ty = TFM.quadrature_demod(ts, torch.from_numpy(blk), 3.3)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ntaps,stride", [(3, 2), (1, 1), (3, 1), (4, 2)])
def test_batched_fir_matches_jax(ntaps, stride):
    """The symbol FIR of the pipeline, streamed over two blocks;
    atol 1e-6 (f32 sums of ≤4 terms in another order)."""
    rng = np.random.default_rng(ntaps * 10 + stride)
    taps = rng.standard_normal(ntaps).astype(np.float32)
    x = rng.standard_normal((5, 200)).astype(np.float32)
    jh = jnp.zeros((5, ntaps - 1), jnp.float32)
    th = torch.zeros((5, ntaps - 1))
    for blk in np.split(x, 2, axis=1):
        jh, jy = jpipe._batched_fir(jh, jnp.asarray(blk), jnp.asarray(taps),
                                    stride)
        th, ty = TF.batched_fir(th, torch.from_numpy(blk), taps, stride)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_wire_helpers_bf16():
    """bf16 ingest arrays (ml_dtypes) move bit for bit through their
    uint16 view; complex IQ rounds to bf16 like ml_dtypes does (RNE)."""
    import ml_dtypes
    from radiocapture_tpu_torch.device import complex_to_wire, wire_from_numpy
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 50)) + 1j * rng.standard_normal((2, 50))
         ).astype(np.complex64)
    ref = np.stack([x.real, x.imag], -1).astype(ml_dtypes.bfloat16)
    got = wire_from_numpy(ref, "cpu")
    assert got.dtype == torch.bfloat16 and got.shape == (2, 50, 2)
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))
    np.testing.assert_array_equal(complex_to_wire(x, "cpu").float().numpy(),
                                  ref.astype(np.float32))
    f32 = wire_from_numpy(ref.astype(np.float32), "cpu")
    assert f32.dtype == torch.float32
