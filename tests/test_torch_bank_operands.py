"""Port parity of the wire bank's operands and of the CQPSK AGC gain, the
two kernels that replace the eager glue around the wire bank:

- ``XlatBank.operands_plain`` and ``bank_operands`` on the CPU (the plain
  version of ``csrc/bank_operands.cu``) against the operands the JAX
  ``XlatBank.call_wire`` hands its Pallas kernel (run in interpret mode,
  as the JAX package's own tests run it), and the bank's outputs, states
  and phase steps against that call's;
- ``agc_scale_kernel`` on the CPU (the plain version of ``csrc/agc.cu``)
  against JAX ``block_agc``, a silent lane included;
- the CUDA entries' validation, which refuses what the kernels do not
  take before any launch.
"""

import re
from pathlib import Path

import ml_dtypes
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from radiocapture_tpu.demod import cqpsk as JC
from radiocapture_tpu.ops import pallas_channelizer as pk
from radiocapture_tpu.ops.channelizer import XlatBank as JBank
from radiocapture_tpu.ops.channelizer import XlatBankState as JState
from radiocapture_tpu.ops.fir import _phase_step_u32
from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops.channelizer import XlatBank, XlatBankState

torch.set_num_threads(1)   # six test workers share the machine

FUSED_REL = 0.03    # bf16 operands in the Pallas kernel, float32 here
# Tap values: XLA's and PyTorch's float32 sin/cos differ by an ulp or so,
# so two bf16 roundings may land one bf16 ulp (at most 2^-7 of the value)
# apart; the absolute part covers values near zero.
TAP_RTOL = 2.0 ** -7
TAP_ATOL = 1e-6
AGC_RTOL = 1e-6     # test_torch_cqpsk.py::test_block_agc_matches_jax
CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"


@pytest.fixture
def jax_fused(monkeypatch):
    """Send the JAX ``call_wire`` down its Pallas path, the kernel in
    interpret mode, and record the (z2, g2) operands it hands the
    kernel."""
    seen = []
    kernel = pk.bank_fused_pallas

    def spy(z2, g2, rot0, rowph, p, d, **kw):
        seen.append((np.asarray(z2), np.asarray(g2)))
        return kernel(z2, g2, rot0, rowph, p, d, interpret=True, **kw)

    monkeypatch.setattr(pk, "pallas_supported", lambda *a: True)
    monkeypatch.setattr(pk, "bank_fused_pallas", spy)
    return seen


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,n", [(64, 40), (32, 40), (64, 12)])
def test_operands_match_jax_call_wire(jax_fused, wire, c, n):
    """Two sources from a random mid-stream state, two blocks in a row
    (n = 12 outputs at D = 16 is a block shorter than K-1 = 239, so the
    second block's history keeps the first's tail in front): z2 is the
    JAX kernel's framed rows exactly, in the wire dtype (the plain bank's)
    and in bf16 (the kernel's); the tap matrix in both layouts is JAX's
    within one bf16 ulp; the phase step, the carried history and phase
    are JAX's exactly, the channels within 0.03·max|y|."""
    rng = np.random.default_rng(c + n + (wire == "bfloat16"))
    bank = XlatBank.for_rates(c, 400e3, 12500.0)
    jbank = JBank.for_rates(c, 400e3, 12500.0)
    s, d, k, p = 2, bank.decim, bank.ntaps, bank.p
    assert (d, k, p) == (16, 240, 15)
    t = n * d
    hist = (rng.standard_normal((s, k - 1))
            + 1j * rng.standard_normal((s, k - 1))).astype(np.complex64)
    phase = rng.integers(0, 2 ** 32, (s, c), dtype=np.uint64).astype(
        np.uint32)
    offs = rng.uniform(-0.45, 0.45, (s, c)).astype(np.float32)
    toffs = torch.from_numpy(offs)
    st = XlatBankState(history=torch.from_numpy(hist),
                       phase=torch.from_numpy(phase.astype(np.int64)))
    jst = [JState(history=jnp.asarray(hist[i]), phase=jnp.asarray(phase[i]))
           for i in range(s)]
    rows = n + p - 1
    for _ in range(2):
        x2 = rng.standard_normal((s, t, 2)).astype(np.float32)
        if wire == "bfloat16":
            x2 = x2.astype(ml_dtypes.bfloat16)
        xw = wire_from_numpy(x2, "cpu")
        z2, g2, step = bank.operands_plain(st, xw, toffs)
        kz2, kg2, kstep = ck.bank_operands(st.history, xw, toffs,
                                           bank.device_taps("cpu"), p, d)
        assert z2.dtype == xw.dtype and kz2.dtype == torch.bfloat16
        assert z2.shape == kz2.shape == (s, (k + t) * 2)
        assert not z2[:, -2:].any() and not kz2[:, -2:].any()
        assert torch.equal(kz2, z2.to(torch.bfloat16))
        assert torch.equal(kstep, step)
        assert kg2.shape == (s, 1, 2 * ck.SLOT_GROUP, p * 2 * d)
        gbf = ck.kernel_taps(g2.to(torch.bfloat16), p, d)
        assert torch.equal(kg2, gbf)
        new, y_re, y_im = bank.call_planes(st, xw, toffs)
        for i in range(s):
            jst[i], jy = jbank.call_wire(jst[i], jnp.asarray(x2[i]),
                                         jnp.asarray(offs[i]))
            jz, jg = jax_fused[-1]
            assert jz.shape == (rows, 2 * d) and jz.dtype == x2.dtype
            np.testing.assert_array_equal(
                _f32(z2[i, :rows * 2 * d].float()), _f32(jz).reshape(-1))
            np.testing.assert_array_equal(
                _f32(kz2[i, :rows * 2 * d].float()),
                _f32(jz.astype(ml_dtypes.bfloat16)).reshape(-1))
            dp2 = jg.shape[0] // p
            jg = _f32(jg).reshape(p, dp2, 2 * c)[:, :2 * d].reshape(
                p * 2 * d, 2 * c)
            np.testing.assert_allclose(
                _f32(g2[i].to(torch.bfloat16).float()), jg, rtol=TAP_RTOL,
                atol=TAP_ATOL * np.abs(jg).max())
            jk = ck.kernel_taps(torch.from_numpy(jg)[None], p, d)[0]
            np.testing.assert_allclose(
                kg2[i].float().numpy(), jk.numpy(), rtol=TAP_RTOL,
                atol=TAP_ATOL * np.abs(jg).max())
            np.testing.assert_array_equal(
                step[i].numpy(),
                np.asarray(_phase_step_u32(jnp.asarray(offs[i]), d)))
            want = np.asarray(jy)                          # [C, n]
            got = (y_re[i] + 1j * y_im[i]).numpy().T
            np.testing.assert_allclose(
                got, want, atol=FUSED_REL * np.abs(want).max())
            np.testing.assert_array_equal(new.history[i].numpy(),
                                          np.asarray(jst[i].history))
            np.testing.assert_array_equal(
                new.phase[i].numpy(), np.asarray(jst[i].phase, np.int64))
        st = new
    assert len(jax_fused) == 2 * s


@pytest.mark.parametrize("s,n,c", [(2, 500, 5), (3, 2500, 64)])
def test_agc_scale_matches_jax_block_agc(s, n, c):
    """The AGC wrapper on [S, N, C] planes (its plain version on the CPU)
    against JAX ``block_agc`` on the same lanes as [S, C, N] complex64:
    lanes of very different power, and a silent lane held at the 1e-9
    floor (its gain is exactly 1/1e-9 in float32)."""
    rng = np.random.default_rng(s * n + c)
    power = 10.0 ** rng.uniform(-3, 2, (s, 1, c))
    y_re = (rng.standard_normal((s, n, c)) * power).astype(np.float32)
    y_im = (rng.standard_normal((s, n, c)) * power).astype(np.float32)
    y_re[0, :, 1] = 0.0
    y_im[0, :, 1] = 0.0
    got = cqk.agc_scale_kernel(torch.from_numpy(y_re), torch.from_numpy(y_im))
    assert got.dtype == torch.float32 and got.shape == (s, c)
    assert got[0, 1] == np.float32(1.0) / np.float32(1e-9)
    x = (y_re + 1j * y_im).astype(np.complex64).transpose(0, 2, 1)
    want = np.asarray(JC.block_agc(jnp.asarray(x)))
    np.testing.assert_allclose(x * got.numpy()[..., None], want,
                               rtol=AGC_RTOL, atol=0.0)


def _operands(**bad):
    """Valid CPU operands for ``operands_args`` (P = 3, D = 4, C = 5, a
    12-sample block), with the named ones replaced."""
    p, d, s = 3, 4, 2
    ops = dict(history=torch.zeros((s, p * d - 1), dtype=torch.complex64),
               x2=torch.zeros((s, 12, 2), dtype=torch.bfloat16),
               offsets_norm=torch.zeros((s, 5)),
               taps=torch.zeros(p * d))
    ops.update(bad)
    return ops, p, d


@pytest.mark.parametrize("bad,match", [
    ({"x2": torch.zeros((2, 12, 2), dtype=torch.float16)}, "x2 must be"),
    ({"x2": torch.zeros((2, 2, 12)).transpose(1, 2)}, "x2 must be"),
    ({"x2": torch.zeros((2, 12, 3))}, "x2 must be"),
    ({"history": torch.zeros((2, 11), dtype=torch.complex128)},
     "history must be"),
    ({"history": torch.zeros((2, 12), dtype=torch.complex64)},
     "history must be"),
    ({"offsets_norm": torch.zeros((2, 5), dtype=torch.float64)},
     "offsets_norm must be"),
    ({"offsets_norm": torch.zeros((3, 5))}, "offsets_norm must be"),
    ({"taps": torch.zeros(11)}, "taps must be"),
    ({}, "takes CUDA tensors")])
def test_operands_kernel_entry_refuses(bad, match):
    """The operands kernel's entry validates before any launch: another
    dtype, shape or layout raises, and so do CPU tensors (the wrapper
    sends those to the plain version; the kernel never gets them)."""
    ops, p, d = _operands(**bad)
    with pytest.raises(ValueError, match=match):
        ck.operands_args(ops["history"], ops["x2"], ops["offsets_norm"],
                         ops["taps"], p, d)


@pytest.mark.parametrize("y_im,match", [
    (torch.zeros((2, 6, 3), dtype=torch.float64), "y_im must be"),
    (torch.zeros((2, 6, 4)), "y_im must be"),
    (torch.zeros((2, 3, 6)).transpose(1, 2), "y_im must be"),
    (torch.zeros((2, 6, 3)), "takes CUDA tensors")])
def test_agc_kernel_entry_refuses(y_im, match):
    """The AGC kernel's entry validates the planes before any launch,
    CPU planes included."""
    with pytest.raises(ValueError, match=match):
        cqk.agc_args(torch.zeros((2, 6, 3)), y_im)
    with pytest.raises(ValueError, match=r"\[S, N, C\]"):
        cqk.agc_args(torch.zeros((6, 3)), torch.zeros((6, 3)))


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card is refused, never computed
    by the plain version."""
    ops, p, d = _operands(**{k: v.to("meta") for k, v in
                             _operands()[0].items()})
    with pytest.raises(ValueError, match="takes CUDA tensors, got meta"):
        ck.bank_operands(ops["history"], ops["x2"], ops["offsets_norm"],
                         ops["taps"], p, d)
    y = torch.zeros((2, 6, 3), device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors, got meta"):
        cqk.agc_scale_kernel(y, y)


@pytest.mark.parametrize("name,source", [
    ("bank_operands_launch", "bank_operands.cu"), ("agc_launch", "agc.cu")])
def test_entry_signatures_match_the_sources(name, source):
    """The ctypes signature has one argument per parameter of the C entry
    point, and the operands kernel's slot group is the bank kernel's."""
    text = (CSRC / source).read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
    assert len(params.split(",")) == len(kernels._SIGNATURES[name])
    if name == "bank_operands_launch":
        assert f"constexpr int SLOT_GROUP = {ck.SLOT_GROUP};" in text
