"""Port parity, channelizer bank: ``XlatBank`` (complex and wire entry
points, float32 and bf16 wire) against the JAX bank on CPU, and the fused
bank's plain reference against the JAX Pallas kernel in interpret mode."""

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiocapture_tpu.ops import pallas_channelizer as pk
from radiocapture_tpu.ops.channelizer import XlatBank as JBank
from radiocapture_tpu.ops.channelizer import XlatBankState as JState
from radiocapture_tpu.ops.fir import _phase_step_u32
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.channelizer import (XlatBank, XlatBankState,
                                                    carried_history)
from radiocapture_tpu_torch.ops.fir import phase_step_u32

torch.set_num_threads(1)   # six test workers share the machine

# JAX on CPU takes the float32 conv path (channelizer.py:145-163); the
# port's plain bank is a float32 GEMM: same math, other sum order.
ATOL = 2e-3                 # test_ops_channelizer.py:28
FUSED_REL = 0.03            # bf16 operands, test_ops_channelizer.py:176


def _mid_stream(rng, k, c, s):
    hist = (rng.standard_normal((s, k - 1))
            + 1j * rng.standard_normal((s, k - 1))).astype(np.complex64)
    phase = rng.integers(0, 2 ** 32, (s, c), dtype=np.uint64)
    return hist, phase.astype(np.uint32)


def _jax_blocks(jbank, hist, phase, blocks, offs):
    st = JState(history=jnp.asarray(hist), phase=jnp.asarray(phase))
    outs = []
    for x in blocks:
        st, y = jbank(st, jnp.asarray(x), jnp.asarray(offs))
        outs.append(np.asarray(y))
    return outs, st


@pytest.mark.parametrize("fs,n_slots", [(2.4e6, 3), (400e3, 5)])
@pytest.mark.parametrize("entry", ["complex", "wire_f32", "wire_bf16"])
def test_xlat_bank_matches_jax(fs, n_slots, entry):
    """Two sources from a mid-stream state (random history and uint32
    phase), three blocks in a row; phase bit-exact after each block."""
    rng = np.random.default_rng(int(fs) % 97 + n_slots)
    bank = XlatBank.for_rates(n_slots, fs, 12500.0)
    jbank = JBank.for_rates(n_slots, fs, 12500.0)
    s, d, k = 2, bank.decim, bank.ntaps
    np.testing.assert_array_equal(bank.taps, jbank.taps)
    offs = rng.uniform(-0.45, 0.45, (s, n_slots)).astype(np.float32)
    hist, phase = _mid_stream(rng, k, n_slots, s)
    x = (rng.standard_normal((s, 3, d * 64))
         + 1j * rng.standard_normal((s, 3, d * 64))).astype(np.complex64)
    if entry == "wire_bf16":
        # the JAX bank reads bf16 wire blocks as float32 values
        x2 = np.stack([x.real, x.imag], -1).astype(ml_dtypes.bfloat16)
        x = (x2[..., 0].astype(np.float32)
             + 1j * x2[..., 1].astype(np.float32)).astype(np.complex64)
        # a bf16 stream's history is bf16-exact too
        hist = (hist.real.astype(ml_dtypes.bfloat16).astype(np.float32)
                + 1j * hist.imag.astype(ml_dtypes.bfloat16)
                .astype(np.float32)).astype(np.complex64)
    st = XlatBankState(history=torch.from_numpy(hist),
                       phase=torch.from_numpy(phase.astype(np.int64)))
    toffs = torch.from_numpy(offs)
    ref = [_jax_blocks(jbank, hist[i], phase[i], x[i], offs[i])
           for i in range(s)]
    for b in range(3):
        if entry == "complex":
            st, y = bank(st, torch.from_numpy(x[:, b]), toffs)
        elif entry == "wire_f32":
            xw = np.stack([x[:, b].real, x[:, b].imag], -1)
            st, y = bank.call_wire(st, wire_from_numpy(xw, "cpu"), toffs)
        else:
            st, y = bank.call_wire(st, wire_from_numpy(x2[:, b], "cpu"),
                                   toffs)
        assert y.shape == (s, n_slots, 64) and y.dtype == torch.complex64
        for i in range(s):
            np.testing.assert_allclose(y[i].numpy(), ref[i][0][b],
                                       atol=ATOL)
    for i in range(s):
        jst = ref[i][1]
        np.testing.assert_array_equal(st.phase[i].numpy(),
                                      np.asarray(jst.phase).astype(np.int64))
        np.testing.assert_array_equal(st.history[i].numpy(),
                                      np.asarray(jst.history))


def test_xlat_bank_block_split():
    """One long block equals four short ones (history + phase carry)."""
    rng = np.random.default_rng(9)
    bank = XlatBank.for_rates(2, 1e6, 12500.0)
    x = (rng.standard_normal((1, bank.decim * 256))
         + 1j * rng.standard_normal((1, bank.decim * 256))
         ).astype(np.complex64)
    offs = torch.tensor([[0.07, -0.3]])
    _, y_once = bank(bank.init(1, "cpu"), torch.from_numpy(x), offs)
    st = bank.init(1, "cpu")
    outs = []
    for blk in np.split(x, 4, axis=1):
        st, yb = bank(st, torch.from_numpy(blk), offs)
        outs.append(yb.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=-1),
                               y_once.numpy(), atol=ATOL)


def test_tap_matrix_matches_jax_layout():
    """The port's g2 equals JAX's ``fused_tap_matrix`` with its 128-lane
    row padding removed, at the bf16 resolution that matrix is stored
    in: atol 1e-2·max|g2|."""
    rng = np.random.default_rng(4)
    p, d, c = 6, 16, 8
    taps = rng.standard_normal(p * d).astype(np.float32)
    offs = (rng.standard_normal(c) * 0.1).astype(np.float32)
    kk = jnp.arange(p * d, dtype=jnp.float32)
    ang = (2.0 * jnp.pi) * jnp.asarray(offs)[:, None] * kk[None, :]
    grev = (jnp.asarray(taps)[None, :] * jnp.exp(1j * ang))[:, ::-1].T
    jg2 = np.asarray(pk.fused_tap_matrix(
        jnp.real(grev).astype(jnp.float32), jnp.imag(grev).astype(
            jnp.float32), p, d).astype(jnp.float32))
    dp2 = -(-2 * d // 128) * 128
    jg2 = jg2.reshape(p, dp2, 2 * c)[:, :2 * d].reshape(p * 2 * d, 2 * c)
    g2 = ck.tap_matrix(taps, torch.from_numpy(offs)[None], p, d)[0]
    np.testing.assert_allclose(g2.numpy(), jg2,
                               atol=1e-2 * np.abs(jg2).max())


@pytest.mark.parametrize("n_out,p,d,c", [(300, 6, 16, 8), (40, 5, 8, 16)])
def test_fused_plain_matches_pallas_interpret(n_out, p, d, c):
    """The plain reference of the bank kernel vs JAX ``bank_fused_pallas``
    in interpret mode on the same z2/g2/phase: 0.03·max|y| (bf16
    operands in the Pallas kernel, float32 in the plain version)."""
    rng = np.random.default_rng(n_out + c)
    k = p * d
    taps = rng.standard_normal(k).astype(np.float32)
    offs = (rng.standard_normal((1, c)) * 0.1).astype(np.float32)
    phase0 = rng.integers(0, 2 ** 32, (1, c), dtype=np.uint64)
    z2 = rng.standard_normal(((n_out + p - 1) * d, 2)).astype(np.float32)
    g2 = ck.tap_matrix(taps, torch.from_numpy(offs), p, d)
    step = phase_step_u32(torch.from_numpy(offs), d)
    y_re, y_im = ck.bank_fused_plain(
        torch.from_numpy(z2.reshape(1, -1)), g2,
        torch.from_numpy(phase0.astype(np.int64)), step, n_out, p, d)
    dp2 = -(-2 * d // 128) * 128
    jg2 = np.zeros((p, dp2, 2 * c), np.float32)
    jg2[:, :2 * d] = g2[0].numpy().reshape(p, 2 * d, 2 * c)
    jstep = _phase_step_u32(jnp.asarray(offs[0]), d)
    np.testing.assert_array_equal(np.asarray(jstep).astype(np.int64),
                                  step[0].numpy())
    rot0, pows = pk.fused_rotation_tables(
        jnp.asarray(phase0[0].astype(np.uint32)), jstep, n_out)
    jr, ji = pk.bank_fused_pallas(
        jnp.asarray(z2.reshape(n_out + p - 1, 2 * d)),
        jnp.asarray(jg2.reshape(p * dp2, 2 * c)).astype(jnp.bfloat16),
        rot0, pows, p, d, interpret=True)
    want = (np.asarray(jr)[:, :n_out] + 1j * np.asarray(ji)[:, :n_out]).T
    got = y_re[0].numpy() + 1j * y_im[0].numpy()
    assert got.shape == (n_out, c)
    np.testing.assert_allclose(got, want,
                               atol=FUSED_REL * np.abs(want).max())


def test_tap_matrix_bf16_is_the_rounded_float32_matrix():
    """The bf16 tap matrix the card's kernel takes is the float32 one
    rounded once: identical values."""
    rng = np.random.default_rng(5)
    p, d = 15, 96
    taps = rng.standard_normal(p * d).astype(np.float32) / 30.0
    offs = torch.from_numpy(rng.uniform(-0.45, 0.45, (2, 6)).astype(
        np.float32))
    g32 = ck.tap_matrix(taps, offs, p, d)
    g16 = ck.tap_matrix(taps, offs, p, d, torch.bfloat16)
    assert g16.dtype == torch.bfloat16 and g16.shape == g32.shape
    assert torch.equal(g16, g32.to(torch.bfloat16))


@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
def test_bank_operands_on_cpu(wire):
    """``XlatBank.operands`` on CPU: z2 is history ++ block ++ one zero
    sample in the wire dtype, a whole number of 2D-value rows; g2 the
    float32 tap matrix, step the uint32 phase step."""
    rng = np.random.default_rng(6)
    bank = XlatBank.for_rates(3, 400e3, 12500.0)
    s, t = 2, bank.decim * 8
    hist, phase = _mid_stream(rng, bank.ntaps, 3, s)
    st = XlatBankState(history=torch.from_numpy(hist),
                       phase=torch.from_numpy(phase.astype(np.int64)))
    x2 = torch.from_numpy(rng.standard_normal((s, t, 2)).astype(
        np.float32)).to(wire)
    offs = torch.from_numpy(rng.uniform(-0.4, 0.4, (s, 3)).astype(
        np.float32))
    z2, g2, step = bank.operands(st, x2, offs)
    want = torch.cat([torch.view_as_real(st.history).to(wire), x2,
                      torch.zeros((s, 1, 2), dtype=wire)], 1)
    assert z2.dtype == wire and torch.equal(z2, want.reshape(s, -1))
    assert z2.shape[1] == (bank.p + t // bank.decim) * 2 * bank.decim
    assert g2.dtype == torch.float32
    assert torch.equal(g2, ck.tap_matrix(bank.taps, offs, bank.p,
                                         bank.decim))
    assert torch.equal(step, phase_step_u32(offs, bank.decim))


def test_bank_wrapper_rejects_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, never
    silently computed by the plain version."""
    z = torch.zeros((1, 64), device="meta")
    g = torch.zeros((1, 32, 4), device="meta")
    ph = torch.zeros((1, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.bank_fused(z, g, ph, ph, 2, 2, 8)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_carried_history_matches_jax_call_wire(wire):
    """The wire bank's new history (``carried_history``, which the CPU
    and CUDA paths both take) over a block longer than K-1 and one
    shorter, from a random mid-stream state: exactly the JAX
    ``call_wire``'s, and what the port's ``call_wire`` carries. A bf16
    stream's history is bf16-exact."""
    rng = np.random.default_rng(21 if wire == "float32" else 22)
    bank = XlatBank.for_rates(3, 400e3, 12500.0)
    jbank = JBank.for_rates(3, 400e3, 12500.0)
    s, d, k = 2, bank.decim, bank.ntaps
    hist, phase = _mid_stream(rng, k, 3, s)
    if wire == "bfloat16":
        hist = (hist.real.astype(ml_dtypes.bfloat16).astype(np.float32)
                + 1j * hist.imag.astype(ml_dtypes.bfloat16)
                .astype(np.float32)).astype(np.complex64)
    offs = rng.uniform(-0.45, 0.45, (s, 3)).astype(np.float32)
    lengths = (d * (-(-(k - 1) // d) + 3), 2 * d)
    assert lengths[1] < k - 1 <= lengths[0]
    st = XlatBankState(history=torch.from_numpy(hist),
                       phase=torch.from_numpy(phase.astype(np.int64)))
    jst = [JState(history=jnp.asarray(hist[i]), phase=jnp.asarray(phase[i]))
           for i in range(s)]
    for t in lengths:
        x2 = rng.standard_normal((s, t, 2)).astype(np.float32)
        if wire == "bfloat16":
            x2 = x2.astype(ml_dtypes.bfloat16)
        xw = wire_from_numpy(x2, "cpu")
        got = carried_history(st.history, xw)
        st, _ = bank.call_wire(st, xw, torch.from_numpy(offs))
        assert got.dtype == torch.complex64 and got.shape == (s, k - 1)
        assert torch.equal(st.history, got)
        for i in range(s):
            jst[i], _ = jbank.call_wire(jst[i], jnp.asarray(x2[i]),
                                        jnp.asarray(offs[i]))
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(jst[i].history))
        one = carried_history(got[:1], xw[:1])   # one source: contiguous
        xw.zero_()                  # the history does not alias the block
        assert torch.equal(st.history, got) and bool(one.abs().all())
