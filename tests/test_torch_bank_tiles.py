"""The bank kernel's tile plan on CPU: a float32 emulation of what
``csrc/xlat_bank.cu`` computes tile by tile (row offsets n0+q into z2's
rows of 2D values, 64-deep K chunks, TMA's zero fill past the data, the
slot-group tap layout and the re/im column pairing of the epilogue),
held against ``bank_fused_plain`` and, through it, the JAX bank; and the
padded z2 of ``XlatBank.operands`` against the unpadded form it
replaced."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from radiocapture_tpu.ops.channelizer import XlatBank as JBank
from radiocapture_tpu.ops.channelizer import XlatBankState as JState
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.channelizer import XlatBank, XlatBankState
from radiocapture_tpu_torch.ops.fir import U32_MASK, rotate

torch.set_num_threads(1)   # six test workers share the machine

BM, BK, GROUP = 128, 64, ck.SLOT_GROUP   # the kernel's tile
ATOL = 2e-3                 # vs JAX, test_ops_channelizer.py:28
PLAIN_REL = 1e-5            # vs the plain version: float32 sum order only


def _emulate_tiles(zb, gk, phase0, step, n, p, c):
    """The kernel's arithmetic in float32, tile by tile: block (n0, g)
    sums, over window offsets q and K chunks k0, the box
    zb[n0+q : n0+q+BM, k0 : k0+BK] times gk[g, :, q·W + k0 : +BK]^T, with
    zeros wherever TMA reads past the data; then columns j and 64+j are
    the re and im parts of slot 64g+j, rotated by the uint32 phase."""
    s, rows, w = zb.shape
    g = gk.shape[1]
    kc, tiles = -(-w // BK), -(-n // BM)
    za = F.pad(zb.float(), (0, kc * BK - w, 0,
                            max(0, tiles * BM + p - 1 - rows)))
    gb = F.pad(gk.float().reshape(s, g, 2 * GROUP, p, w), (0, kc * BK - w))
    y = torch.zeros((s, tiles * BM, g * GROUP), dtype=torch.complex64)
    for n0 in range(0, tiles * BM, BM):
        for gi in range(g):
            acc = torch.zeros((s, BM, 2 * GROUP))
            for q in range(p):
                for k0 in range(0, kc * BK, BK):
                    acc += (za[:, n0 + q:n0 + q + BM, k0:k0 + BK]
                            @ gb[:, gi, :, q, k0:k0 + BK].transpose(1, 2))
            y[:, n0:n0 + BM, gi * GROUP:(gi + 1) * GROUP] = torch.complex(
                acc[..., :GROUP], acc[..., GROUP:])
    ramp = (phase0[:, None, :]
            + step[:, None, :] * torch.arange(n)[:, None]) & U32_MASK
    y = rotate(y[:, :n, :c], ramp)
    return y.real, y.imag


def _mid_stream(rng, bank, s, c):
    hist = (rng.standard_normal((s, bank.ntaps - 1))
            + 1j * rng.standard_normal((s, bank.ntaps - 1))
            ).astype(np.complex64)
    phase = rng.integers(0, 2 ** 32, (s, c), dtype=np.uint64)
    return hist, phase.astype(np.uint32)


@pytest.mark.parametrize("fs", [2.4e6, 1.2e6])
@pytest.mark.parametrize("c", [5, 40, 64, 128])
def test_tile_plan_matches_plain_and_jax(fs, c):
    """D=96/P=15 (C4FM) and D=48/P=15 (CQPSK halves), N=150 (a ragged
    second row tile), C off and on the 64-slot group: the emulated tile
    plan equals ``bank_fused_plain`` and the JAX bank."""
    rng = np.random.default_rng(int(fs) % 89 + c)
    bank = XlatBank.for_rates(c, fs, 12500.0)
    s, d, p, n = 2, bank.decim, bank.p, 150
    assert p == 15 and d == {2.4e6: 96, 1.2e6: 48}[fs]
    hist, phase = _mid_stream(rng, bank, s, c)
    x = (rng.standard_normal((s, n * d))
         + 1j * rng.standard_normal((s, n * d))).astype(np.complex64)
    offs = rng.uniform(-0.45, 0.45, (s, c)).astype(np.float32)
    st = XlatBankState(history=torch.from_numpy(hist),
                       phase=torch.from_numpy(phase.astype(np.int64)))
    z2, g2, step = bank.operands(st, wire_from_numpy(
        np.stack([x.real, x.imag], -1), "cpu"), torch.from_numpy(offs))
    zb = ck.kernel_rows(z2, n, p, d)
    assert zb.shape[2] == 2 * d and zb.data_ptr() == z2.data_ptr()
    gk = ck.kernel_taps(g2, p, d)
    got = _emulate_tiles(zb, gk, st.phase, step, n, p, c)
    want = ck.bank_fused_plain(z2, g2, st.phase, step, n, p, d)
    scale = max(float(w.abs().max()) for w in want)
    for g_, w_ in zip(got, want):
        assert g_.shape == (s, n, c)
        assert float((g_ - w_).abs().max()) <= PLAIN_REL * scale
    jbank = JBank.for_rates(c, fs, 12500.0)
    for i in range(s):
        jst = JState(history=jnp.asarray(hist[i]),
                     phase=jnp.asarray(phase[i]))
        _, jy = jbank(jst, jnp.asarray(x[i]), jnp.asarray(offs[i]))
        np.testing.assert_allclose((got[0][i] + 1j * got[1][i]).T.numpy(),
                                   np.asarray(jy), atol=ATOL)


@pytest.mark.parametrize("d,n,c", [(41, 130, 5), (6, 300, 70)])
def test_tile_plan_on_padded_rows(d, n, c):
    """2D not a multiple of 8 (W = 2D rounded up, rows copied and
    zero-padded) and a z2 longer than the windows need: the emulated plan
    still equals the plain version."""
    rng = np.random.default_rng(d + n)
    s, p = 2, 7
    z2 = torch.from_numpy(rng.standard_normal(
        (s, (n + p + 3) * 2 * d + 6)).astype(np.float32))
    offs = torch.from_numpy(rng.uniform(-0.45, 0.45, (s, c)).astype(
        np.float32))
    g2 = ck.tap_matrix(rng.standard_normal(p * d).astype(np.float32) / 10,
                       offs, p, d)
    phase0 = torch.from_numpy(rng.integers(0, 2 ** 32, (s, c)))
    step = torch.from_numpy(rng.integers(0, 2 ** 32, (s, c)))
    zb = ck.kernel_rows(z2, n, p, d)
    w = ck.kernel_width(d)
    assert zb.shape == (s, n + p - 1, w) and zb.is_contiguous()
    assert not bool(zb[..., 2 * d:].any())
    got = _emulate_tiles(zb, ck.kernel_taps(g2, p, d), phase0, step, n,
                         p, c)
    want = ck.bank_fused_plain(z2, g2, phase0, step, n, p, d)
    scale = max(float(x.abs().max()) for x in want)
    for g_, w_ in zip(got, want):
        assert float((g_ - w_).abs().max()) <= PLAIN_REL * scale


@pytest.mark.parametrize("c", [5, 64, 130])
def test_kernel_taps_layout(c):
    """gk[s, g, j, q·W + k] is g2's re column of slot 64g+j at row
    q·2D + k, gk[s, g, 64+j, ...] its im column; zero for slots past C
    and for the pad values k ≥ 2D."""
    rng = np.random.default_rng(c)
    s, p, d = 2, 3, 5
    w = ck.kernel_width(d)
    assert w == 16
    g2 = torch.from_numpy(rng.standard_normal(
        (s, p * 2 * d, 2 * c)).astype(np.float32))
    gk = ck.kernel_taps(g2, p, d)
    g = -(-c // GROUP)
    assert gk.shape == (s, g, 2 * GROUP, p * w) and gk.is_contiguous()
    want = torch.zeros((s, g, 2 * GROUP, p, w))
    for slot in range(c):
        gi, j = divmod(slot, GROUP)
        for q in range(p):
            rows = g2[:, q * 2 * d:(q + 1) * 2 * d]
            want[:, gi, j, q, :2 * d] = rows[..., slot]
            want[:, gi, GROUP + j, q, :2 * d] = rows[..., c + slot]
    assert torch.equal(gk, want.reshape(gk.shape))


@pytest.mark.parametrize("d,c", [(96, 64), (48, 5), (41, 130)])
def test_kernel_tap_matrix_is_the_laid_out_tap_matrix(d, c):
    """``kernel_tap_matrix`` (what ``XlatBank.operands`` gives on CUDA)
    holds exactly the values of ``tap_matrix`` in bf16, laid out by
    ``kernel_taps``."""
    rng = np.random.default_rng(d + c)
    s, p = 2, 5
    taps = rng.standard_normal(p * d).astype(np.float32) / 30.0
    offs = torch.from_numpy(rng.uniform(-0.45, 0.45, (s, c)).astype(
        np.float32))
    gk = ck.kernel_tap_matrix(taps, offs, p, d)
    assert gk.dtype == torch.bfloat16
    assert torch.equal(gk, ck.kernel_taps(ck.tap_matrix(
        taps, offs, p, d, torch.bfloat16), p, d))


@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
def test_padded_operands_keep_planes_and_history(wire):
    """Three blocks through ``call_planes`` and ``call_wire``: the planes
    equal the plain bank on the unpadded history ++ block, and the carried
    history is that buffer's last K-1 samples, exactly."""
    rng = np.random.default_rng(7)
    bank = XlatBank.for_rates(6, 1.2e6, 12500.0)
    s, k, d, p = 2, bank.ntaps, bank.decim, bank.p
    hist, phase = _mid_stream(rng, bank, s, 6)
    if wire == torch.bfloat16:   # a bf16 stream's history is bf16-exact
        hist = torch.view_as_complex(torch.view_as_real(torch.from_numpy(
            hist)).to(wire).float().contiguous()).numpy()
    st = XlatBankState(history=torch.from_numpy(hist),
                       phase=torch.from_numpy(phase.astype(np.int64)))
    st_w = st
    offs = torch.from_numpy(rng.uniform(-0.45, 0.45, (s, 6)).astype(
        np.float32))
    for _ in range(3):
        x2 = torch.from_numpy(rng.standard_normal((s, 20 * d, 2)).astype(
            np.float32)).to(wire)
        old = torch.cat([torch.view_as_real(st.history).to(wire), x2], 1)
        g2, step = ck.tap_matrix(bank.taps, offs, p, d), \
            bank.operands(st, x2, offs)[2]
        want = ck.bank_fused_plain(old.reshape(s, -1), g2, st.phase, step,
                                   20, p, d)
        new, y_re, y_im = bank.call_planes(st, x2, offs)
        st_w, y = bank.call_wire(st_w, x2, offs)
        assert torch.equal(y_re, want[0]) and torch.equal(y_im, want[1])
        assert torch.equal(y, torch.complex(*want).transpose(1, 2))
        nh = torch.view_as_complex(old[:, -(k - 1):].float().contiguous())
        assert torch.equal(new.history, nh)
        assert torch.equal(st_w.history, nh)
        assert torch.equal(new.phase, st_w.phase)
        st = new
