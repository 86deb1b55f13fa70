"""Port parity, ``receiver_split2``: ``SpectrumSplit2`` against the JAX
splitter from a mid-stream state, its tone routing and block split, the
complex bank's plain version against the JAX ``bank_matmul_pallas`` in
interpret mode and against the JAX ``XlatBank.__call__``, and the
``convert`` round trips of the split2 and CQPSK states."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from radiocapture_tpu.frontend.pipeline import CqpskControlPipeline as JCq
from radiocapture_tpu.frontend.pipeline import SpectrumSplit2 as JSplit
from radiocapture_tpu.ops import pallas_channelizer as pk
from radiocapture_tpu.ops.channelizer import XlatBank as JBank
from radiocapture_tpu.ops.channelizer import XlatBankState as JState
from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.frontend.pipeline import (CqpskControlPipeline,
                                                      SpectrumSplit2,
                                                      split2_sources)
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.channelizer import XlatBank, XlatBankState
from radiocapture_tpu_torch.testing import modulators as M

torch.set_num_threads(1)   # six test workers share the machine

ATOL = 2e-3     # test_pipeline_parallel.py:232 (f32 sums in another order)


def _jax_wire_state(rng, s, k, c):
    """A random mid-stream bank state in the JAX wire encoding."""
    return JState(
        history=rng.standard_normal((s, k - 1, 2)).astype(np.float32),
        phase=rng.integers(0, 2 ** 32, (s, c), dtype=np.uint64)
        .astype(np.uint32).view(np.int32))


def test_split2_matches_jax():
    """Two sources from a random mid-stream state, three blocks (complex64,
    float32 wire and bf16 wire into the port; the same values as float32
    wire into JAX): halves within ATOL, phase bit-exact, history equal."""
    fs, s, t = 2.4e6, 2, 4096
    rng = np.random.default_rng(12)
    jsp, tsp = JSplit(fs), SpectrumSplit2(fs)
    np.testing.assert_array_equal(tsp.bank.taps, jsp.bank.taps)
    arrays = _jax_wire_state(rng, s, tsp.bank.ntaps, 2)
    tst = convert.state_from_jax(tsp, arrays, "cpu")
    for a, w in zip(convert.state_to_jax(tsp, tst), arrays):
        np.testing.assert_array_equal(a, w)
    jstep = jax.jit(jax.vmap(jsp._step_impl))
    jst = JState(*map(jnp.asarray, arrays))
    x = rng.standard_normal((3, s, t, 2)).astype(np.float32)
    x[2] = x[2].astype(ml_dtypes.bfloat16).astype(np.float32)
    errs = []
    for b, entry in enumerate(("complex", "wire_f32", "wire_bf16")):
        jst, jh = jstep(jst, jnp.asarray(x[b]))
        if entry == "complex":
            xb = torch.view_as_complex(torch.from_numpy(x[b]))
        elif entry == "wire_f32":
            xb = wire_from_numpy(x[b], "cpu")
        else:
            xb = wire_from_numpy(x[b].astype(ml_dtypes.bfloat16), "cpu")
            assert xb.dtype == torch.bfloat16
        tst, th = tsp.step(tst, xb)
        assert th.shape == (s, 2, t // 2, 2) and th.dtype == torch.float32
        errs.append(float(np.abs(th.numpy() - np.asarray(jh)).max()))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    back = convert.state_to_jax(tsp, tst)
    np.testing.assert_array_equal(back.phase, np.asarray(jst.phase))
    np.testing.assert_array_equal(back.history, np.asarray(jst.history))
    assert max(errs) < 1e-4, errs      # measured ~1e-6: same f32 math


def test_split2_tone_routing_and_block_split():
    """test_spectrum_split2_tone_routing on the port: tones land in the
    right half at the right offset, halves are numbered 2·phys + half,
    and two half-blocks give the one-shot output."""
    fs = 1_600_000.0
    sp = SpectrumSplit2(fs)
    n = 4096 * 2
    wide = (M.tone(fs, -fs / 4 - 10e3, n)
            + M.tone(fs, fs / 4 + 30e3, n)).astype(np.complex64)
    x = np.stack([wide, wide * np.complex64(0.5)])       # two sources
    st, halves = sp.step(sp.init(2, "cpu"), torch.from_numpy(x))
    h = halves.numpy()
    y0 = h[0, 0, 256:, 0] + 1j * h[0, 0, 256:, 1]
    y1 = h[0, 1, 256:, 0] + 1j * h[0, 1, 256:, 1]
    fs_h = fs / 2

    def est(z):
        return float(np.mean(np.angle(z[1:] * np.conj(z[:-1])))
                     * fs_h / (2 * np.pi))

    assert abs(est(y0) + 10e3) < 200.0
    assert abs(est(y1) - 30e3) < 200.0
    assert sp.half_center(850e6, 0) == 850e6 - fs / 4
    assert sp.half_center(850e6, 1) == 850e6 + fs / 4
    logical = split2_sources(halves)
    assert logical.shape == (4, n // 2, 2)
    for phys in range(2):
        for half in range(2):
            assert torch.equal(logical[2 * phys + half], halves[phys, half])

    st2 = sp.init(2, "cpu")
    outs = []
    for blk in np.split(x, 2, axis=1):
        st2, hb = sp.step(st2, torch.from_numpy(np.ascontiguousarray(blk)))
        outs.append(hb.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=2), h, atol=ATOL)
    np.testing.assert_array_equal(st2.phase.numpy(), st.phase.numpy())
    np.testing.assert_array_equal(st2.history.numpy(), st.history.numpy())


@pytest.mark.parametrize("n,p,d,c", [(40, 5, 8, 16), (2048, 10, 2, 2)])
def test_bank_complex_plain_matches_jax(n, p, d, c):
    """The complex bank's plain version against ``bank_matmul_pallas``
    (interpret mode, float32) with the rotation at phase 0, rtol 1e-4 /
    atol 1e-3 (test_ops_channelizer.py:114-117); then ``XlatBank.
    __call__`` with these taps, a random uint32 phase and random offsets
    against the JAX ``__call__`` on the CPU, within ATOL and with the
    phase and history carried exactly."""
    rng = np.random.default_rng(n + c)
    k = p * d
    z = (rng.standard_normal((n + p - 1) * d)
         + 1j * rng.standard_normal((n + p - 1) * d)).astype(np.complex64)
    grev = (rng.standard_normal((c, k))
            + 1j * rng.standard_normal((c, k))).astype(np.complex64)
    zero = torch.zeros((1, c), dtype=torch.int64)
    y = ck.bank_complex_plain(torch.from_numpy(z)[None],
                              torch.from_numpy(grev)[None], zero, zero, n, d)
    assert y.shape == (1, c, n) and y.dtype == torch.complex64
    zf = z.reshape(n + p - 1, d)
    jr, ji = pk.bank_matmul_pallas(
        jnp.asarray(zf.real), jnp.asarray(zf.imag),
        jnp.asarray(grev.T.real.copy()), jnp.asarray(grev.T.imag.copy()),
        p, d, interpret=True, bf16=False)
    np.testing.assert_allclose(y[0].numpy().real, np.asarray(jr).T,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(y[0].numpy().imag, np.asarray(ji).T,
                               rtol=1e-4, atol=1e-3)

    taps = (rng.standard_normal(k) / np.sqrt(k)).astype(np.float32)
    offs = rng.uniform(-0.45, 0.45, (1, c)).astype(np.float32)
    phase = rng.integers(0, 2 ** 32, (1, c), dtype=np.uint64)
    x = (rng.standard_normal(n * d)
         + 1j * rng.standard_normal(n * d)).astype(np.complex64)
    hist = z[:k - 1][None]
    jst, jy = JBank(c, d, taps)(
        JState(history=jnp.asarray(hist[0]),
               phase=jnp.asarray(phase[0].astype(np.uint32))),
        jnp.asarray(x), jnp.asarray(offs[0]))
    tst, ty = XlatBank(c, d, taps)(
        XlatBankState(history=torch.from_numpy(hist),
                      phase=torch.from_numpy(phase.astype(np.int64))),
        torch.from_numpy(x)[None], torch.from_numpy(offs))
    np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(tst.phase[0].numpy(),
                                  np.asarray(jst.phase).astype(np.int64))
    np.testing.assert_array_equal(tst.history[0].numpy(),
                                  np.asarray(jst.history))


def test_convert_round_trips():
    """Random JAX wire states (uint32 phase bits included) → the port →
    back, bit for bit, for the split2 bank and the CQPSK pipeline; and
    the port's CQPSK start state is the JAX one (not all-zero)."""
    rng = np.random.default_rng(21)
    sp = SpectrumSplit2(2.4e6)
    arrays = _jax_wire_state(rng, 3, sp.bank.ntaps, 2)
    arrays = arrays._replace(phase=np.array(
        [[-1, 0], [2 ** 31 - 1, -2 ** 31], [7, -7]], np.int32))
    st = convert.state_from_jax(sp, arrays, "cpu")
    assert st.phase.dtype == torch.int64
    assert int(st.phase[0, 0]) == 0xFFFFFFFF
    for a, w in zip(convert.state_to_jax(sp, st), arrays):
        np.testing.assert_array_equal(a, w)

    tp = CqpskControlPipeline.p25_cqpsk(4, 400e3, tdma=True)
    jp = JCq.p25_cqpsk(4, 400e3, tdma=True)
    jinit = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a),
                                                   (2,) + a.shape),
                         jp.init())
    back = convert.state_to_jax(tp, tp.init(2, "cpu"))
    for a, w in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(jinit)):
        np.testing.assert_array_equal(a, w)
    rand = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jinit)
    rand = rand._replace(bank=_jax_wire_state(rng, 2, tp.bank.ntaps, 4))
    st = convert.state_from_jax(tp, rand, "cpu")
    for a, w in zip(jax.tree.leaves(tuple(convert.state_to_jax(tp, st))),
                    jax.tree.leaves(rand)):
        np.testing.assert_array_equal(a, w)


def test_complex_bank_rejects_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, never
    silently computed by the plain version."""
    x = torch.zeros((1, 30, 2), dtype=torch.bfloat16, device="meta")
    h = torch.zeros((1, 3), dtype=torch.complex64, device="meta")
    g = torch.zeros((1, 2, 4), dtype=torch.complex64, device="meta")
    ph = torch.zeros((1, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.bank_complex(x, h, g, ph, ph, 2)
