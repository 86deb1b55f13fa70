"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: they skip where torch sees no CUDA device.
This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import functools
import time

import numpy as np
import pytest
import torch

from radiocapture_tpu_torch import convert, kernels
from radiocapture_tpu_torch.demod import cqpsk as CQ
from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
from radiocapture_tpu_torch.demod import fsk4 as K
from radiocapture_tpu_torch.demod import track_kernel as tk
from radiocapture_tpu_torch.device import complex_to_wire
from radiocapture_tpu_torch.frontend.pipeline import (CqpskControlPipeline,
                                                      ControlPipeline,
                                                      SpectrumSplit2,
                                                      split2_sources)
from radiocapture_tpu_torch.ops import channelizer as TCH
from radiocapture_tpu_torch.ops import channelizer_kernel as ck
from radiocapture_tpu_torch.ops import fm
from radiocapture_tpu_torch.ops import fm_kernel as fk
from radiocapture_tpu_torch.ops import pfb_kernel as pk
from radiocapture_tpu_torch.ops.fir import phase_step_u32
from radiocapture_tpu_torch.runtime import FileSource, SiteRuntime, _tree_map
from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                             SystemConfig)
from radiocapture_tpu_torch.testing import modulators as M
from radiocapture_tpu_torch.testing import streams
from radiocapture_tpu_torch.utils import trace

FUSED_REL = 0.03    # bf16 operands, test_ops_channelizer.py:176
# The complex bank is float32 in both versions: only the sum order
# differs (FMA chain in the kernel, GEMM in the plain version).
COMPLEX_REL = 1e-4
# CQPSK tracker on noise lanes: the loop amplifies ~1e-7 differences in
# sincosf/atan2f and sum order; emit masks agree on this share, and the
# first CQPSK_SYM_N symbols within CQPSK_SYM_ATOL.
CQPSK_NOISE_AGREE = 0.99
CQPSK_SYM_ATOL = 1e-3
CQPSK_SYM_N = 100
# fm_voice: audio on the FM-tone lanes within this × max|audio| (the IIR
# in another association order, float32); power within VOICE_REL.
VOICE_REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,c", [(1, 2500, 64), (2, 1001, 40),
                                   (3, 37, 5), (2, 777, 128)])
def test_bank_kernel_matches_plain(cuda_device, s, n, c):
    """Mid-stream inputs, ragged N (off the 128-row tile) and slot counts
    off and over the 64-slot group: within 0.03·max|y|."""
    rng = np.random.default_rng(n + c)
    p, d = 15, 96
    z2 = torch.as_tensor(rng.standard_normal(
        (s, (n + p - 1) * 2 * d)).astype(np.float32),
        device=cuda_device).to(torch.bfloat16)
    offs = torch.as_tensor(rng.uniform(-0.4, 0.4, (s, c)).astype(
        np.float32), device=cuda_device)
    taps = rng.standard_normal(p * d).astype(np.float32) / 30.0
    g2 = ck.tap_matrix(taps, offs, p, d, torch.bfloat16)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, c)),
                             dtype=torch.int64, device=cuda_device)
    step = phase_step_u32(offs, d)
    before = trace.counter("launch.xlat_bank")
    got = ck.bank_fused(z2, ck.kernel_taps(g2, p, d), phase0, step, n, p, d)
    assert trace.counter("launch.xlat_bank") == before + 1
    want = ck.bank_fused_plain(z2, g2, phase0, step, n, p, d)
    scale = max(float(w.abs().max()) for w in want)
    for g_, w_ in zip(got, want):
        assert g_.shape == (s, n, c)
        assert float((g_ - w_).abs().max()) <= FUSED_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["c4fm", "cqpsk"])
def test_bank_kernel_on_pipeline_operands(cuda_device, path):
    """The pipelines' own operands (``XlatBank.operands``, 3 sources, a
    100 ms bf16 block, a random history and phase): history ++ block is
    not a multiple of 16 bytes per source, the zero-padded z2 is read in
    place, the tap matrix comes in the kernel's layout; within
    0.03·max|y| of the plain version on ``tap_matrix``."""
    bank = (ControlPipeline.p25_c4fm(64, 2.4e6) if path == "c4fm" else
            CqpskControlPipeline.p25_cqpsk(64, 1.2e6)).bank
    rng = np.random.default_rng(bank.decim)
    s, k, d = 3, bank.ntaps, bank.decim
    n = 2500
    assert (k - 1 + n * d) * 2 * 2 % 16 != 0
    hist = torch.as_tensor(rng.standard_normal((s, k - 1, 2)).astype(
        np.float32), device=cuda_device).to(torch.bfloat16).float()
    st = bank.init(s, cuda_device)._replace(
        history=torch.view_as_complex(hist.contiguous()),
        phase=torch.as_tensor(rng.integers(0, 2 ** 32, (s, 64)),
                              device=cuda_device))
    x2 = torch.as_tensor(rng.standard_normal((s, n * d, 2)).astype(
        np.float32), device=cuda_device).to(torch.bfloat16)
    offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (s, 64)).astype(
        np.float32), device=cuda_device)
    z2, gk, step = bank.operands(st, x2, offs)
    assert ck.kernel_rows(z2, n, bank.p, d).data_ptr() == z2.data_ptr()
    g2 = ck.tap_matrix(bank.device_taps(cuda_device), offs, bank.p, d,
                       torch.bfloat16)
    assert torch.equal(gk, ck.kernel_taps(g2, bank.p, d))
    before = trace.counter("launch.xlat_bank")
    got = ck.bank_fused(z2, gk, st.phase, step, n, bank.p, d)
    assert trace.counter("launch.xlat_bank") == before + 1
    want = ck.bank_fused_plain(z2, g2, st.phase, step, n, bank.p, d)
    scale = max(float(w.abs().max()) for w in want)
    for g_, w_ in zip(got, want):
        assert g_.shape == (s, n, 64)
        assert float((g_ - w_).abs().max()) <= FUSED_REL * scale


@pytest.mark.cuda
def test_bank_kernel_refuses_float32_operands(cuda_device):
    """On the card the wrapper validates the bf16 operand type and never
    converts: a float32 tap matrix raises."""
    p, d, c, n = 2, 8, 4, 3
    z2 = torch.zeros((1, (n + p - 1) * 2 * d), dtype=torch.bfloat16,
                     device=cuda_device)
    g2 = torch.zeros((1, p * 2 * d, 2 * c), device=cuda_device)
    ph = torch.zeros((1, c), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="g2 must be"):
        ck.bank_fused(z2, g2, ph, ph, n, p, d)


# The CQPSK AGC kernel's gain against agc_scale's: float32 sums in
# another order (chip_smoke.py's AGC_REL_TOL).
AGC_REL = 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("bank,s,t,wire,c", [
    ("c4fm", 128, 240000, torch.bfloat16, 64),     # the C4FM bench
    ("cqpsk", 256, 120000, torch.float32, 64),     # split2's halves
    ("c4fm", 128, 240000, torch.bfloat16, 32),     # the dp x tp tile
    ("c4fm", 3, 96 * 7, torch.bfloat16, 5),        # a block < K-1
    ("cqpsk", 2, 48 * 33, torch.float32, 70)])     # two slot groups
def test_operands_kernel_is_the_plain_version(cuda_device, bank, s, t, wire,
                                              c):
    """One launch of ``csrc/bank_operands.cu`` (``XlatBank.operands``)
    against ``operands_plain`` from a random mid-stream state: z2 and the
    phase step bit-identical, g2 bit-identical up to the sign of zero, the
    wire bank's outputs on the two operand sets bit-identical."""
    bank = (ControlPipeline.p25_c4fm(64, 2.4e6) if bank == "c4fm" else
            CqpskControlPipeline.p25_cqpsk(64, 1.2e6)).bank
    g = torch.Generator(device=cuda_device).manual_seed(s + c)
    st = bank.init(s, cuda_device)._replace(
        history=torch.randn((s, bank.ntaps - 1), dtype=torch.complex64,
                            generator=g, device=cuda_device),
        phase=torch.randint(0, 2 ** 32, (s, c), generator=g,
                            device=cuda_device))
    x2 = torch.randn((s, t, 2), generator=g, device=cuda_device).to(wire)
    offs = (torch.rand((s, c), generator=g, device=cuda_device) - 0.5) * 0.9
    before = trace.counter("launch.bank_operands")
    z2, g2, step = bank.operands(st, x2, offs)
    assert trace.counter("launch.bank_operands") == before + 1
    pz2, pg2, pstep = bank.operands_plain(st, x2, offs)
    assert torch.equal(z2.view(torch.int16), pz2.view(torch.int16))
    diff = g2.view(torch.int16) != pg2.view(torch.int16)
    assert torch.equal(g2, pg2) and bool((g2[diff] == 0).all())
    assert torch.equal(step, pstep)
    n = t // bank.decim
    got = ck.bank_fused(z2, g2, st.phase, step, n, bank.p, bank.decim)
    want = ck.bank_fused(pz2, pg2, st.phase, pstep, n, bank.p, bank.decim)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,c", [(3, 37, 5), (2, 100, 70),
                                   (256, 2500, 64)])
def test_agc_kernel_within_bound(cuda_device, s, n, c):
    """``csrc/agc.cu`` against ``cqpsk.agc_scale`` on [S, N, C] planes
    with a silent lane: every gain within AGC_REL, the silent one exactly
    1/1e-9; the pipeline's wrapper launches the kernel once."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    y_re = torch.randn((s, n, c), generator=g, device=cuda_device)
    y_im = torch.randn((s, n, c), generator=g, device=cuda_device)
    y_re[0, :, 0] = 0.0
    y_im[0, :, 0] = 0.0
    before = trace.counter("launch.agc")
    got = cqk.agc_scale_kernel(y_re, y_im)
    assert trace.counter("launch.agc") == before + 1
    want = CQ.agc_scale(y_re, y_im, dim=1)
    assert got.shape == (s, c) and got.dtype == torch.float32
    assert float(((got - want).abs() / want.abs()).max()) <= AGC_REL
    assert float(got[0, 0]) == float(np.float32(1.0) / np.float32(1e-9))


@pytest.mark.cuda
def test_glue_kernels_refuse_what_they_cannot_take(cuda_device):
    """On the card the two wrappers validate and never fall back: a wrong
    dtype, a tensor on the CPU beside CUDA ones, or a mismatched plane
    raises."""
    bank = ControlPipeline.p25_c4fm(4, 2.4e6).bank
    st = bank.init(2, cuda_device)
    offs = torch.zeros((2, 4), device=cuda_device)
    x2 = torch.zeros((2, 960, 2), device=cuda_device)
    with pytest.raises(ValueError, match="x2 must be"):
        bank.operands(st, x2.half(), offs)
    with pytest.raises(ValueError, match="offsets_norm must be"):
        bank.operands(st, x2, offs.cpu())
    with pytest.raises(ValueError, match="history must be"):
        ck.bank_operands(st.history.cpu(), x2, offs,
                         bank.device_taps(cuda_device), bank.p, bank.decim)
    y = torch.zeros((2, 10, 4), device=cuda_device)
    with pytest.raises(ValueError, match="y_im must be"):
        cqk.agc_scale_kernel(y, y.cpu())
    with pytest.raises(ValueError, match="y_im must be"):
        cqk.agc_scale_kernel(y, y.double())


def _track_lanes(pipe, ctor, s, c, n, rng):
    """[S, n, C] complex64 modulated lanes at the channel rate: three
    streams of random symbols, each lane one of them at its own amplitude
    (0.3 to 1) and carrier phase."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,nb", [(1, 2, 2000), (3, 5, 1998), (2, 40, 50),
                                    (1, 64, 8)])
@pytest.mark.parametrize("ctor", ["p25_c4fm", "edacs", "moto"])
def test_track_kernel_matches_plain(cuda_device, ctor, s, c, nb):
    """Modulated lanes, three blocks in a row (state written back in
    place): identical valid masks and dibits, syms within 1e-3; after
    each block ``prev`` and the boxcar history identical, clock, fine
    frequency and the 8-sample history within 1e-3. Lane counts off the
    32-slot tile (5, 40); N off the kernel's 128-sample ring stage (2000,
    1998), shorter than one (50) and than one 16-sample producer segment
    (8); EDACS runs NT 1 at sym_decim 1, P25 and Moto NT 3 at 2."""
    pipe = getattr(ControlPipeline, ctor)(2, 200e3)
    prm = pipe.track_params
    lanes = _track_lanes(pipe, ctor, s, c, 3 * nb, np.random.default_rng(c))
    st = [(fm.quad_demod_init((s, c), cuda_device),
           torch.zeros((s, c, len(prm.sym_taps) - 1), device=cuda_device),
           K.fsk4_init((s, c), cuda_device)) for _ in range(2)]
    before = trace.counter("launch.fsk_track")
    for b in range(3):
        blk = lanes[:, b * nb:(b + 1) * nb]
        y_re = torch.as_tensor(blk.real.copy(), device=cuda_device)
        y_im = torch.as_tensor(blk.imag.copy(), device=cuda_device)
        got = tk.track(y_re, y_im, *st[0], prm)
        want = tk.track_plain(y_re, y_im, *st[1], prm)
        st = [got[:3], want[:3]]
        assert got[3].shape == (s, c, nb // prm.sym_decim)
        assert torch.equal(got[4], want[4])
        assert torch.equal(got[5], want[5])
        assert float((got[3] - want[3]).abs().max()) <= 1e-3
        assert torch.equal(got[0].prev, want[0].prev)
        assert torch.equal(got[1], want[1])
        for g_, w_ in zip(got[2], want[2]):
            assert float((g_ - w_).abs().max()) <= 1e-3
    assert trace.counter("launch.fsk_track") == before + 3


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(cuda_device):
    """One bf16 block through ``ControlPipeline.step`` on the card and on
    the CPU (plain versions): the fixture slot's decisions agree."""
    pipe = ControlPipeline.p25_c4fm(8, 200e3)
    rng = np.random.default_rng(4)
    iq = M.upsample_to(M.c4fm_modulate(rng.integers(0, 4, 900), 25000.0),
                       25000.0, 200e3)
    n = len(iq) // pipe.block_multiple * pipe.block_multiple
    wide = M.multi_channel(200e3, [(50e3, iq)], n)
    x = complex_to_wire(wide[None], "cpu")
    offs = torch.zeros((1, 8))
    offs[0, 2] = 50e3 / 200e3
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        st = pipe.init(1, dev)
        st, out = pipe.step(st, x.to(dev), offs.to(dev))
        outs.append([o.cpu() for o in out])
    agree = float((outs[0][1][0, 2] == outs[1][1][0, 2]).float().mean())
    assert agree >= 0.99
    v = outs[0][1][0, 2].bool() & outs[1][1][0, 2].bool()
    assert float((outs[0][2][0, 2][v] == outs[1][2][0, 2][v]).float()
                 .mean()) >= 0.99


def _complex_normal(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _complex_operands(rng, s, n, k, d, c, wire, dev, split2=False):
    """The complex bank's operands for an N-output block: the wire block
    as the wrapper takes it (bf16 or float32 [S, T, 2], or a complex64
    block's float32 view), a random history [S, K-1], taps [S, C, K]
    (split2's own when ``split2``), a random uint32 phase and the phase
    step of random offsets (split2's ±1/4 when ``split2``)."""
    t = n * d
    x = torch.as_tensor(rng.standard_normal((s, t, 2)).astype(np.float32),
                        device=dev)
    if wire == "bf16":
        x = x.to(torch.bfloat16)
    elif wire == "complex64":
        x = torch.view_as_real(torch.view_as_complex(x))
    hist = torch.as_tensor(_complex_normal(rng, (s, k - 1)), device=dev)
    if split2:
        sp = SpectrumSplit2(2.4e6)
        offs = torch.as_tensor(np.tile(sp.offsets, (s, 1)), device=dev)
        grev = sp.bank.modulated_taps(offs)
    else:
        offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (s, c)).astype(
            np.float32), device=dev)
        grev = torch.as_tensor(_complex_normal(rng, (s, c, k), k ** -0.5),
                               device=dev)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, c)),
                             dtype=torch.int64, device=dev)
    return x, hist, grev, phase0, phase_step_u32(offs, d)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,d,c,wire,split2", [
    (1, 120000, 20, 2, 2, "bf16", True), (4, 120000, 20, 2, 2, "bf16", True),
    (1, 120000, 20, 2, 2, "float32", True),
    (4, 120000, 20, 2, 2, "float32", False),
    (1, 120000, 20, 2, 2, "complex64", False),
    (4, 120000, 20, 2, 2, "complex64", True),
    (3, 1001, 20, 2, 2, "bf16", True), (2, 5, 20, 2, 2, "float32", True),
    (3, 1001, 1440, 96, 40, "bf16", False),
    (2, 37, 1440, 96, 40, "float32", False),
    (3, 613, 1440, 96, 64, "bf16", False),
    (3, 613, 1440, 96, 64, "float32", False),
    (2, 5, 1440, 96, 64, "float32", False),
    (64, 2500, 467, 16, 1, "float32", False),
    (3, 37, 467, 16, 1, "bf16", False)])
def test_complex_bank_kernel_matches_plain(cuda_device, s, n, k, d, c, wire,
                                           split2):
    """Split2's shape (one 100 ms block of 2.4 MS/s, 20 taps, 2 slots) at
    S = 1 and 4 on bf16, float32 and complex64 blocks read in place, with
    split2's taps and phase step (π per output) or random ones; a ragged
    N off the 224-output warp tile, a block shorter than K-1 (N = 5); the
    general path's wide plan at K = 1440 / D = 96 with C = 40 and the
    time-sharded mesh step's C = 64 (bf16 and float32, ragged N, N = 5)
    and at one slot, the pfb fine stage's C = 1 / K = 467 / D = 16 (64
    rows of a 100 ms block; K % D ≠ 0): within 1e-4·max|y| of the plain
    version on history ++ block, from a random history and uint32
    phase."""
    rng = np.random.default_rng(n + c + s)
    x, hist, grev, phase0, step = _complex_operands(
        rng, s, n, k, d, c, wire, cuda_device, split2)
    before = trace.counter("launch.xlat_complex")
    got = ck.bank_complex(x, hist, grev, phase0, step, d)
    assert trace.counter("launch.xlat_complex") == before + 1
    want = ck.bank_complex_plain(ck.complex_z(x, hist), grev, phase0, step,
                                 n, d)
    assert got.shape == (s, c, n) and got.dtype == torch.complex64
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= COMPLEX_REL * scale


@functools.cache
def _earlier_complex():
    """The complex bank as commit 54b2cf5 had it
    (``tools/xlat_complex_54b2cf5.cu``, one complex64 z per source), built
    with the package's flags."""
    from radiocapture_tpu_torch.tools import track_turns
    return track_turns.build_other(track_turns.EARLIER_COMPLEX,
                                   "xlat_complex_launch",
                                   track_turns.COMPLEX_Z_SIGNATURE)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,d,c,wire,split2", [
    (4, 120000, 20, 2, 2, "bf16", True), (3, 1001, 20, 2, 2, "float32", False),
    (2, 5, 20, 2, 2, "bf16", True), (3, 1001, 1440, 96, 40, "bf16", False),
    (3, 613, 1440, 96, 64, "bf16", False),
    (3, 613, 1440, 96, 64, "float32", False),
    (2, 5, 1440, 96, 64, "float32", False),
    (64, 2500, 467, 16, 1, "float32", False),
    (2, 5, 467, 16, 1, "bf16", False), (2, 333, 47, 3, 12, "float32", False),
    (2, 64, 30000, 1, 1, "float32", False)])
def test_complex_bank_matches_earlier_kernel(cuda_device, s, n, k, d, c,
                                             wire, split2):
    """The kernel against the one it replaced on the same values (that one
    on history ++ block as complex64): every output bit-identical, on
    split2's fast path (its two phasors per slot, and ``sincosf`` per
    output for other offsets) and on the general path's two plans: wide
    (C = 40 and the mesh step's C = 64 at K = 1440 / D = 96, bf16 and
    float32, ragged N, N = 5; K % D ≠ 0 at an odd D with C = 12; one slot
    at the pfb fine stage's C = 1 / K = 467 / D = 16) and direct (a span
    too large for shared memory)."""
    from radiocapture_tpu_torch.tools import track_turns
    rng = np.random.default_rng(n + s)
    x, hist, grev, phase0, step = _complex_operands(
        rng, s, n, k, d, c, wire, cuda_device, split2)
    got = ck.bank_complex(x, hist, grev, phase0, step, d)
    z = ck.complex_z(x, hist)
    old = torch.empty_like(got)
    kernels.check(_earlier_complex()(
        z.data_ptr(), grev.data_ptr(), phase0.data_ptr(), step.data_ptr(),
        old.data_ptr(), s, n, k, d, c, z.shape[1],
        torch.cuda.current_stream(cuda_device).cuda_stream), "xlat_complex")
    torch.cuda.synchronize()
    assert track_turns.identical_outputs(got, old) == s * c * n


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["complex64", "float32", "bf16"])
def test_complex_call_carries_complex64_history(cuda_device, wire):
    """``XlatBank.__call__`` on the card (through ``SpectrumSplit2``), on
    complex64 blocks and on float32 and bf16 wire blocks read in place:
    after each block, 4800 samples or fewer than K-1, the history is the
    last K-1 samples of history ++ block as complex64 exactly (a short
    block keeps the history's float32 samples in front) and equals the
    CPU's, ``convert.state_to_jax`` gives the JAX wire layout, and the
    halves agree with the CPU's plain path."""
    sp = SpectrumSplit2(2.4e6)
    k = sp.bank.ntaps
    rng = np.random.default_rng(3)
    xs = []
    for t in (4800, 10, 4800):
        x = torch.as_tensor(rng.standard_normal((2, t, 2)).astype(
            np.float32), device=cuda_device)
        xs.append(torch.view_as_complex(x) if wire == "complex64" else
                  x.to(torch.bfloat16) if wire == "bf16" else x)
    hist = torch.as_tensor(_complex_normal(rng, (2, k - 1)),
                           device=cuda_device)
    st = sp.init(2, cuda_device)._replace(history=hist)
    st_cpu = sp.init(2, "cpu")._replace(history=hist.cpu())
    for x in xs:
        zc = ck.complex_z(torch.view_as_real(x) if x.is_complex() else x,
                          st.history)
        st, halves = sp.step(st, x)
        st_cpu, want = sp.step(st_cpu, x.cpu())
        assert st.history.dtype == torch.complex64
        assert torch.equal(torch.view_as_real(st.history),
                           torch.view_as_real(zc[:, zc.shape[1] - (k - 1):]))
        assert torch.equal(st.history.cpu(), st_cpu.history)
        assert torch.equal(st.phase.cpu(), st_cpu.phase)
        err = float((halves.cpu() - want).abs().max())
        assert err <= COMPLEX_REL * float(want.abs().max())
    back = convert.state_to_jax(sp, st)
    assert back.history.shape == (2, k - 1, 2)
    assert back.history.dtype == np.float32
    assert back.phase.shape == (2, 2) and back.phase.dtype == np.int32
    np.testing.assert_array_equal(
        back.history, torch.view_as_real(st.history).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["c4fm", "split2+cqpsk"])
def test_wire_call_carries_float32_history(cuda_device, path):
    """A float32 wire on the card: ``ControlPipeline.step``, and
    ``CqpskControlPipeline.step`` behind ``SpectrumSplit2`` (whose halves
    are float32), carry the bank history as the block's float32 tail
    exactly, not the kernel's bf16 z2; ``convert.state_to_jax`` gives it
    unchanged."""
    rng = np.random.default_rng(8)
    pipe = (ControlPipeline.p25_c4fm(8, 2.4e6) if path == "c4fm" else
            CqpskControlPipeline.p25_cqpsk(8, 1.2e6))
    k, bm = pipe.bank.ntaps, pipe.block_multiple
    t = bm * (-(-(k - 1) // bm) + 1)             # a block longer than K-1
    st = pipe.init(2, cuda_device)
    offs = torch.as_tensor(rng.uniform(-0.4, 0.4, (2, 8)).astype(
        np.float32), device=cuda_device)
    if path == "c4fm":
        xs = [torch.as_tensor(rng.standard_normal((2, t, 2)).astype(
            np.float32), device=cuda_device) for _ in range(2)]
    else:
        sp = SpectrumSplit2(2.4e6)
        sst, xs = sp.init(1, cuda_device), []
        for _ in range(2):
            sst, halves = sp.step(sst, torch.as_tensor(
                _complex_normal(rng, (1, 2 * t)), device=cuda_device))
            xs.append(split2_sources(halves))
    for x in xs:
        assert x.dtype == torch.float32 and x.shape[1] == t
        st, _ = pipe.step(st, x, offs)
        want = torch.view_as_complex(x[:, x.shape[1] - (k - 1):].contiguous())
        assert st.bank.history.dtype == torch.complex64
        assert torch.equal(st.bank.history, want)
    back = convert.state_to_jax(pipe, st)
    np.testing.assert_array_equal(
        back.bank.history,
        xs[-1][:, xs[-1].shape[1] - (k - 1):].cpu().numpy())


@pytest.mark.cuda
def test_new_wrappers_refuse_wrong_dtypes(cuda_device):
    """The complex bank and CQPSK tracker validate and never convert: a
    float64 or float16 wire block, a non-contiguous one and a complex128
    history are refused."""
    x = torch.zeros((1, 30, 2), dtype=torch.float64, device=cuda_device)
    h = torch.zeros((1, 3), dtype=torch.complex64, device=cuda_device)
    g = torch.zeros((1, 2, 4), dtype=torch.complex64, device=cuda_device)
    ph = torch.zeros((1, 2), dtype=torch.int64, device=cuda_device)
    wide = torch.zeros((1, 30, 4), device=cuda_device)
    for bad in (x, x.half(), wide[..., :2], wide[:, ::2, :2]):
        with pytest.raises(ValueError, match="x must be"):
            ck.bank_complex(bad, h, g, ph, ph, 2)
    with pytest.raises(ValueError, match="history must be"):
        ck.bank_complex(x.float(), h.to(torch.complex128), g, ph, ph, 2)
    y = torch.zeros((1, 10, 2), dtype=torch.float64, device=cuda_device)
    st = CQ.cqpsk_init(25000.0, 4800.0, (1, 2), cuda_device)
    with pytest.raises(ValueError, match="y_re must be"):
        cqk.track_cqpsk(y, y, torch.ones((1, 2), device=cuda_device), st,
                        25000.0, 4800.0)


def _run_cqpsk(fn, planes, state, baud):
    outs = []
    for y_re, y_im in planes:
        scale = CQ.agc_scale(y_re, y_im, dim=1)
        state, *out = fn(y_re, y_im, scale, state, 25000.0, baud)
        outs.append(out)
    return [torch.cat([o[i] for o in outs], -1).cpu().numpy()
            for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("baud", [4800.0, 6000.0])
def test_cqpsk_track_kernel_matches_plain(cuda_device, baud):
    """The three CQPSK fixtures (4800 Bd) or the Phase 2 superframe
    (6000 Bd), plus two noise lanes, in two blocks (state written back
    in place): identical compacted dibits that decode, and the stated
    agreement on noise."""
    if baud == 4800.0:
        fixtures = [streams.cqpsk_fixture(k) for k in streams.CQPSK_FIXTURES]
        sigs = [iq for iq, _ in fixtures]
    else:
        dib, voice = streams.tdma_superframe()
        sigs = [M.cqpsk_modulate(dib, fs=25000.0, symbol_rate=6000.0)]
    rng = np.random.default_rng(11)
    n = max(map(len, sigs)) // 2 * 2
    lanes = np.zeros((n, len(sigs) + 2), np.complex64)
    for i, iq in enumerate(sigs):
        lanes[:min(n, len(iq)), i] = iq[:n]
    lanes[:, len(sigs):] = _complex_normal(rng, (n, 2))
    planes = [tuple(torch.as_tensor(np.ascontiguousarray(
        part(lanes[None, i * n // 2:(i + 1) * n // 2])), device=cuda_device)
        for part in (np.real, np.imag)) for i in range(2)]
    shape = (1, lanes.shape[1])
    got = _run_cqpsk(cqk.track_cqpsk, planes,
                     CQ.cqpsk_init(25000.0, baud, shape, cuda_device), baud)
    want = _run_cqpsk(cqk.track_cqpsk_plain, planes,
                      CQ.cqpsk_init(25000.0, baud, shape, cuda_device), baud)
    for i in range(len(sigs)):
        gd = got[2][0, i][got[1][0, i].astype(bool)]
        np.testing.assert_array_equal(
            gd, want[2][0, i][want[1][0, i].astype(bool)])
        if baud == 4800.0:
            g = streams.grants(gd)
            assert len(g) >= 4 and all(x in fixtures[i][1] for x in g), g
        else:
            assert streams.tdma_voice_ok(streams.tdma_bursts(gd), voice)
    noise = np.s_[0, len(sigs):]
    assert np.mean(got[1][noise] == want[1][noise]) >= CQPSK_NOISE_AGREE
    head = np.abs(got[0][noise][..., :CQPSK_SYM_N]
                  - want[0][noise][..., :CQPSK_SYM_N])
    assert float(head.max()) <= CQPSK_SYM_ATOL


@functools.cache
def _earlier_cqpsk(name):
    """An earlier CQPSK tracker kernel beside ``tools/track_turns.py``,
    built with the package's flags: ``EARLIER_CQPSK``, the per-sample
    loop (``cqpsk_track_54b2cf5.cu``), or ``SYMBOL_MAJOR_CQPSK``, the
    symbol-major kernel that did all its work in the lane's own warp
    (``cqpsk_track_b498eb2.cu``)."""
    from radiocapture_tpu_torch.tools import track_turns
    return track_turns.build_other(getattr(track_turns, name),
                                   "cqpsk_track_launch")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _cqpsk_edge_lanes(dev, baud, s, n, c):
    """Two blocks of n samples on [S, C] lanes in turn: noise, silence,
    and CQPSK streams 5% fast and 5% slow whose omega starts at the low
    and the high clamp ([S, 2n, C] complex64); and a function that gives
    a fresh lane state with those omegas on ``dev``."""
    fs = 25000.0
    prm = CQ.cqpsk_params(fs, baud)
    rng = np.random.default_rng(n + c)
    lanes = _complex_normal(rng, (s, 2 * n, c)).astype(np.complex64)
    kinds = np.arange(s * c).reshape(s, c) % 4
    by_lane = lanes.transpose(0, 2, 1)                  # a view, [S, C, n]
    by_lane[kinds == 1] = 0.0
    nsym = int(2 * n * 1.05 * baud / fs) + 16
    for kind, rate in ((2, 1.05), (3, 0.95)):
        by_lane[kinds == kind] = M.cqpsk_modulate(
            rng.integers(0, 4, nsym), fs=fs, symbol_rate=baud * rate)[:2 * n]
    omega0 = np.where(kinds == 2, prm.omega_lo, np.where(
        kinds == 3, prm.omega_hi, fs / baud)).astype(np.float32)

    def fresh():
        return CQ.cqpsk_init(fs, baud, (s, c), dev)._replace(
            omega=torch.as_tensor(omega0, device=dev))
    return lanes, fresh


def _cqpsk_block(lanes, b, n, dev):
    """Block b of the lanes as [S, n, C] float32 planes on ``dev``."""
    return tuple(torch.as_tensor(np.ascontiguousarray(
        p(lanes[:, b * n:(b + 1) * n])), device=dev)
        for p in (np.real, np.imag))


@pytest.mark.cuda
@pytest.mark.parametrize("baud,s,n,c", [
    (4800.0, 2, 2500, 40), (6000.0, 2, 2500, 40), (6000.0, 3, 37, 40),
    (4800.0, 3, 37, 33), (6000.0, 2, 1, 40), (4800.0, 2, 1, 64)])
def test_cqpsk_track_kernel_edges(cuda_device, baud, s, n, c):
    """Noise lanes, silent lanes, and CQPSK streams 5% fast and 5% slow
    whose omega starts at the low and the high clamp and stays pinned
    there (the most drift between the lanes of a warp), in two blocks
    with the state carried in place. Against the plain version: emit
    masks agree on CQPSK_NOISE_AGREE of the samples and the first
    CQPSK_SYM_N symbols lie within CQPSK_SYM_ATOL, measured on the circle
    of ±4 (a ~1e-7 difference across the branch cut moves a symbol by 8).
    Against the per-sample-loop kernel it replaced: outputs and all eight
    state tensors bit for bit. C = 40 and 33 leave part of a warp idle;
    N = 37 and 1 end blocks mid-symbol."""
    fs = 25000.0
    lanes, fresh = _cqpsk_edge_lanes(cuda_device, baud, s, n, c)
    st = {"kernel": fresh(), "earlier": fresh(), "plain": fresh()}
    outs = {k: [] for k in st}
    for b in range(2):
        y_re, y_im = _cqpsk_block(lanes, b, n, cuda_device)
        scale = CQ.agc_scale(y_re, y_im, dim=1)
        outs["kernel"].append(cqk.track_cqpsk(y_re, y_im, scale,
                                              st["kernel"], fs, baud)[1:])
        args, old = cqk.kernel_args(y_re, y_im, scale, st["earlier"], fs,
                                    baud)
        kernels.check(_earlier_cqpsk("EARLIER_CQPSK")(*args),
                      "cqpsk_track")
        outs["earlier"].append([o.transpose(1, 2) for o in old])
        want = cqk.track_cqpsk_plain(y_re, y_im, scale, st["plain"], fs,
                                     baud)
        st["plain"] = want[0]
        outs["plain"].append(want[1:])
    torch.cuda.synchronize()
    got = {k: [torch.cat([o[i] for o in v], -1) for i in range(3)]
           for k, v in outs.items()}
    for a, w in zip(got["kernel"], got["earlier"]):
        assert torch.equal(_bits(a), _bits(w))
    for a, w in zip(st["kernel"], st["earlier"]):
        assert torch.equal(_bits(a), _bits(w))
    valid = [v.cpu().numpy() for v in (got["kernel"][1], got["plain"][1])]
    assert np.mean(valid[0] == valid[1]) >= CQPSK_NOISE_AGREE
    d = (got["kernel"][0] - got["plain"][0])[..., :CQPSK_SYM_N].cpu().numpy()
    assert float(np.abs((d + 4.0) % 8.0 - 4.0).max()) <= CQPSK_SYM_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("baud,s,n,c", [
    (4800.0, 256, 2500, 64), (6000.0, 150, 100, 64), (4800.0, 80, 200, 64),
    (6000.0, 3, 2500, 64), (4800.0, 2, 2500, 20), (6000.0, 3, 37, 11),
    (4800.0, 1, 1, 45)])
def test_cqpsk_track_kernel_matches_b498eb2(cuda_device, baud, s, n, c):
    """The warp-specialised tracker against the kernel it replaced, on
    the edge lanes (noise, silence, streams pinned at both omega clamps)
    in two blocks with the state carried in place: outputs and all eight
    state tensors bit for bit. 16384 lanes (the split2 bench: 512 tiles,
    four a block), 9600 and 5120 (three and two a block), a runtime
    group of 3 sources × 64 slots, 40 and 33 lanes (a last tile of 8 and
    of one lane), N = 37 and 1 ending blocks mid-symbol."""
    fs = 25000.0
    lanes, fresh = _cqpsk_edge_lanes(cuda_device, baud, s, n, c)
    st = {"kernel": fresh(), "earlier": fresh()}
    outs = {k: [] for k in st}
    for b in range(2):
        y_re, y_im = _cqpsk_block(lanes, b, n, cuda_device)
        scale = CQ.agc_scale(y_re, y_im, dim=1)
        before = trace.counter("launch.cqpsk_track")
        outs["kernel"].append(cqk.track_cqpsk(y_re, y_im, scale,
                                              st["kernel"], fs, baud)[1:])
        assert trace.counter("launch.cqpsk_track") == before + 1
        args, old = cqk.kernel_args(y_re, y_im, scale, st["earlier"], fs,
                                    baud)
        kernels.check(_earlier_cqpsk("SYMBOL_MAJOR_CQPSK")(*args),
                      "cqpsk_track")
        outs["earlier"].append([o.transpose(1, 2) for o in old])
    torch.cuda.synchronize()
    for got, want in zip(outs["kernel"], outs["earlier"]):
        for a, w in zip(got, want):
            assert torch.equal(_bits(a), _bits(w))
    for a, w in zip(st["kernel"], st["earlier"]):
        assert torch.equal(_bits(a), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("baud", [4800.0, 6000.0])
def test_cqpsk_chain_probe_runs_the_trackers_loop(cuda_device, baud):
    """The chain probe takes the tracker's feedback loop alone: on planes
    that repeat its PROBE_ROWS rows, with unit gain, its final lane state
    equals the tracker kernel's bit for bit, and it counts cycles."""
    fs, n = 25000.0, 1001
    rows = _complex_normal(np.random.default_rng(3),
                           (cqk.PROBE_ROWS, 32)).astype(np.complex64)
    planes = np.tile(rows, (-(-n // cqk.PROBE_ROWS), 1))[None, :n]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=cuda_device)

    st_k = CQ.cqpsk_init(fs, baud, (1, 32), cuda_device)
    cqk.track_cqpsk(dev(planes.real), dev(planes.imag),
                    torch.ones((1, 32), device=cuda_device), st_k, fs, baud)
    st_p = CQ.cqpsk_init(fs, baud, (32,), cuda_device)
    assert cqk.chain_probe(dev(rows.real), dev(rows.imag), st_p, n, fs,
                           baud) > 0
    for a, w in zip(st_k, st_p):
        assert torch.equal(_bits(a.reshape(w.shape)), _bits(w))


def _voice_planes(rng, s, n, c):
    """[S, N, C] float32 planes: FM tones on every lane (2.5 kHz
    deviation at 25 kS/s, far from the atan2 branch cut) with -30 dB
    noise."""
    t = np.arange(n)[None, :, None] / 25000.0
    f = rng.uniform(300.0, 3000.0, (s, 1, c))
    audio = 0.8 * np.sin(2 * np.pi * f * t)
    x = (np.exp(2j * np.pi * 0.1 * np.cumsum(audio, 1))
         + _complex_normal(rng, (s, n, c), 0.03)).astype(np.complex64)
    return x.real.copy(), x.imag.copy()


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,c", [(1, 2500, 64), (3, 1001, 40),
                                   (2, 37, 5), (2, 9, 33), (1, 512, 32)])
def test_voice_kernel_matches_plain(cuda_device, s, n, c):
    """fm_voice against its plain version at ragged shapes, two blocks
    with the lane state carried: audio within VOICE_REL·max|audio|, power
    and the carried de-emphasis output within VOICE_REL relative, the
    carried discriminator value ``x_last`` and ``prev`` bit for bit (the
    kernel's discriminator rounds as PyTorch's). N off the kernel's
    256-sample time tile (2500, 1001), within one (37), shorter than one
    16-sample chunk (9) and a whole number of time tiles (512)."""
    rng = np.random.default_rng(n + c)
    re, im = _voice_planes(rng, s, 2 * n, c)
    gain = 25000.0 / (2 * np.pi * 5000.0)
    st = [(fm.quad_demod_init((s, c), cuda_device),
           fm.deemph_init((s, c), cuda_device)) for _ in range(2)]
    before = trace.counter("launch.fm_voice")
    for b in range(2):
        blk = [torch.as_tensor(np.ascontiguousarray(p[:, b * n:(b + 1) * n]),
                               device=cuda_device) for p in (re, im)]
        got = fk.voice_track(*blk, *st[0], gain, 25000.0)
        want = fk.voice_track_plain(*blk, *st[1], gain, 25000.0)
        st = [got[:2], want[:2]]
        assert got[2].shape == want[2].shape == (s, c, n)
        scale = float(want[2].abs().max())
        assert float((got[2] - want[2]).abs().max()) <= VOICE_REL * scale
        torch.testing.assert_close(got[3], want[3], rtol=VOICE_REL, atol=0)
        torch.testing.assert_close(got[1].y_last, want[1].y_last,
                                   rtol=0, atol=VOICE_REL * scale)
        assert torch.equal(got[1].x_last, want[1].x_last)
        assert torch.equal(got[0].prev, want[0].prev)
    assert trace.counter("launch.fm_voice") == before + 2


@pytest.mark.cuda
def test_voice_kernel_updates_state_in_place(cuda_device):
    """On CUDA the kernel writes the lane state into the tensors it was
    given, and those hold what the plain version returns."""
    rng = np.random.default_rng(9)
    re, im = (torch.as_tensor(p, device=cuda_device)
              for p in _voice_planes(rng, 2, 300, 8))
    quad, deemph = fm.quad_demod_init((2, 8), cuda_device), \
        fm.deemph_init((2, 8), cuda_device)
    want = fk.voice_track_plain(re, im, quad, deemph, 0.8, 25000.0)
    got = fk.voice_track(re, im, quad, deemph, 0.8, 25000.0)
    assert got[0].prev is quad.prev and got[1].y_last is deemph.y_last
    assert got[1].x_last is deemph.x_last
    assert torch.equal(quad.prev, want[0].prev)
    assert torch.equal(deemph.x_last, want[1].x_last)
    torch.testing.assert_close(deemph.y_last, want[1].y_last, rtol=1e-5,
                               atol=1e-6)


def _site(tmp_path, slots, n_sources=1):
    cfg = RcConfig(audio_dir=str(tmp_path / "audio"),
                   num_slots_per_source=slots, block_seconds=0.05)
    for i in range(n_sources):
        cfg.sources[i] = SourceConfig(type="file",
                                      center_freq=857e6 + i * 2.4e6,
                                      samp_rate=2.4e6)
    cfg.systems[0] = SystemConfig(type="p25", id="P25",
                                  control_channels=[857.5e6])
    return cfg


def _rows(rt, src):
    return {g: _tree_map(lambda t: t[rt.groups[g]["srcs"].index(src)].clone(),
                         st)
            for g, st in rt.pipe_state.items() if src in rt.groups[g]["srcs"]}


def _leaves(st):
    return [st] if isinstance(st, torch.Tensor) else \
        [x for part in st for x in _leaves(part)]


@pytest.mark.cuda
def test_runtime_mask_revert_with_in_place_kernels(cuda_device, tmp_path):
    """A block where source 1 delivers nothing: with the trackers writing
    lane state in place on CUDA, its state rows in the c4fm and analog
    groups stay bit-identical while source 0's advance."""
    rng = np.random.default_rng(3)
    starve = {"on": False}

    def p0(n):
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                ).astype(np.complex64)

    rt = SiteRuntime(_site(tmp_path, 8, 2),
                     {0: p0, 1: lambda n: None if starve["on"] else p0(n)},
                     cuda_device)
    try:
        rt.step()
        before = {s: _rows(rt, s) for s in (0, 1)}
        starve["on"] = True
        rt.step()
        after = {s: _rows(rt, s) for s in (0, 1)}
        assert len(before[1]) == 2
        for g in before[1]:
            assert all(torch.equal(a, b) for a, b in zip(
                _leaves(before[1][g]), _leaves(after[1][g])))
            assert not all(torch.equal(a, b) for a, b in zip(
                _leaves(before[0][g]), _leaves(after[0][g])))
    finally:
        rt.close()


@pytest.mark.cuda
def test_runtime_grant_to_recording(cuda_device, tmp_path):
    """``SiteRuntime`` on CUDA: a P25 C4FM grant opens a ``c4fm``
    recorder on the voice channel; its CDR names group 500 / user 42 and
    its codewords are a run of those sent."""
    cc, vc, sent = streams.p25_voice_call(856.2e6, 1.0)
    n = int(2.4e6)
    wide = M.multi_channel(2.4e6, [
        (f - 857e6, M.upsample_to(iq, 25000.0, 2.4e6))
        for f, iq in ((857.5e6, cc), (856.2e6, vc))], n,
        noise_floor_db=-60.0)
    rt = SiteRuntime(_site(tmp_path, 16), {0: FileSource(wide, loop=False)},
                     cuda_device, keep_wav=True)
    rt.use_stream_clock()
    done = []
    rt.bus.subscribe("/queue/call_management/call_complete", done.append)
    try:
        rt.run(n_blocks=n // rt.block_len(0))
        assert rt.instances[0].engine.is_locked
        (rec, _src, _slot, _bid, kind), = rt.recorders.active.values()
        assert kind == "c4fm"
        assert streams.codewords_ok(rec._imbe_frames, sent, 9)
    finally:
        rt.close()
    deadline = time.time() + 3.0
    while not done and time.time() < deadline:
        time.sleep(0.05)
    assert done and done[0]["cdr"]["system_group_local"] == 500
    assert done[0]["cdr"]["system_user_local"] == 42


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", [(3, 37), (5, 1001), (64, 2500)])
def test_pfb_fine_stage_kernel_matches_plain(cuda_device, s, n):
    """The complex bank's general path (the wide plan at one slot) at the
    shape of the pfb frontend's fine stage on the modulated taps, the
    form ``pfb_fine`` replaced (one slot per row, K2 = 467 taps, D = 16,
    float32 bin samples; 64 of the 8192 rows of the bench shape, ragged
    N): within 1e-4·max|y| of the plain version, one launch."""
    bank = ControlPipeline.p25_c4fm(64, 2.4e6, frontend="pfb").bank
    k, d = bank.ntaps2, bank.decim2
    assert (k, d) == (467, 16)
    rng = np.random.default_rng(s + n)
    x = torch.as_tensor(rng.standard_normal((s, n * d, 2)).astype(
        np.float32), device=cuda_device)
    hist = torch.as_tensor(_complex_normal(rng, (s, k - 1)),
                           device=cuda_device)
    fine = torch.as_tensor(rng.uniform(-0.5, 0.5, (s, 1)).astype(
        np.float32), device=cuda_device)
    grev = TCH.modulated_taps(torch.as_tensor(bank.fine_taps,
                                              device=cuda_device), fine)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, 1)),
                             dtype=torch.int64, device=cuda_device)
    step = phase_step_u32(fine, d)
    before = trace.counter("launch.xlat_complex")
    got = ck.bank_complex(x, hist, grev, phase0, step, d)
    assert trace.counter("launch.xlat_complex") == before + 1
    want = ck.bank_complex_plain(ck.complex_z(x, hist), grev, phase0, step,
                                 n, d)
    assert got.shape == (s, 1, n)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= COMPLEX_REL * scale


@pytest.mark.cuda
def test_pfb_fine_stage_in_place_at_bench_shape(cuda_device):
    """The fine stage's new history at 128 × 64 rows of one 100 ms block,
    read in place from the 768 bin rows through the row index
    (``row_history``): every sample bit for bit ``complex_history`` of
    the gathered rows."""
    from radiocapture_tpu_torch.tools import track_turns
    xb, rows, hist = track_turns.fine_bench_operands(cuda_device)[:3]
    assert xb.shape == (768, 40000, 2) and rows.shape == (8192,)
    assert torch.equal(
        torch.view_as_real(TCH.row_history(hist, xb, rows)),
        torch.view_as_real(TCH.complex_history(hist, xb[rows])))


def _fine_operands(rng, s, r, n, k, dev, fine=None):
    """The fine stage's operands on ``dev``: bins x [R, N·16, 2] float32,
    the row index (the first two rows on one bin), history, the pfb
    bank's prototype (or random taps at another K), fine offsets (uniform
    in [-0.5, 0.5] unless given), phase0 and step."""
    x = torch.as_tensor(rng.standard_normal((r, n * 16, 2)).astype(
        np.float32), device=dev)
    rows = torch.as_tensor(rng.integers(0, r, s), device=dev)
    rows[1] = rows[0]
    hist = torch.as_tensor(_complex_normal(rng, (s, k - 1)), device=dev)
    bank = TCH.PfbXlatBank(4, 2.4e6, 12500.0)
    taps = torch.as_tensor(bank.fine_taps if k == bank.ntaps2 else
                           (rng.standard_normal(k) / k).astype(np.float32),
                           device=dev)
    fine = torch.as_tensor(np.asarray(
        rng.uniform(-0.5, 0.5, s) if fine is None else fine, np.float32),
        device=dev)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, s), device=dev)
    return x, rows, hist, taps, fine, phase0, phase_step_u32(fine, 16)


def _fine_rows(y_re, y_im):
    """``pfb_fine``'s planes [S, N, C] as its rows [S·C, N] complex64."""
    return torch.complex(y_re, y_im).transpose(1, 2).reshape(
        -1, y_re.shape[1])


def _nan_planes(s, n, c, dev):
    """[S/C, N, C] float32 planes of NaN: an element the kernel skips
    stays NaN."""
    return tuple(torch.full((s // c, n, c), float("nan"), device=dev)
                 for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("rb", [None, 1, 3, 16])
@pytest.mark.parametrize("s,r,n,k,fine", [
    (3, 2, 37, 467, None), (5, 4, 1001, 467, None), (3, 2, 5, 467, None),
    (3, 2, 300, 467, [0.4999, -0.5, 0.5]), (2, 1, 300, 467, [0.0, 1e-7]),
    (64, 24, 2500, 467, None), (4, 3, 613, 33, None),
    (3, 2, 700, 401, None)])
def test_pfb_fine_kernel_matches_plain(cuda_device, s, r, n, k, fine, rb):
    """``pfb_fine`` on the card (one launch) at the launcher's plan and at
    one, three and sixteen rows a block: ragged N, N = 5 < K-1, f at ±0.5
    and 0, 64 rows of a 100 ms block over 24 bin rows as four sources of
    C = 16 slots (three rows a block straddle two sources), the other
    rows one source, K = 33 (every tap row in the last group) and 401:
    the planes [S/C, N, C] within FINE_REL·max|y| of ``planes()`` of
    ``pfb_fine_plain``'s rows, every element written, and the rows
    within 1e-4·max|y| of the complex bank on the gathered rows'
    modulated taps (the form it replaced, whose float32 angles round up
    to 4.9e-5·max|y| apart)."""
    rng = np.random.default_rng(s + n + k)
    ops = _fine_operands(rng, s, r, n, k, cuda_device, fine)
    x, rows, hist, taps, fine, phase0, step = ops
    c = 16 if s % 16 == 0 else s
    before = trace.counter("launch.pfb_fine")
    if rb is None:
        y_re, y_im = pk.pfb_fine(*ops, 16, c)
        assert trace.counter("launch.pfb_fine") == before + 1
    else:
        args, (y_re, y_im) = pk.pfb_fine_args(
            *ops, 16, c, rb=rb, out=_nan_planes(s, n, c, cuda_device))
        kernels.check(kernels.load().pfb_fine_launch(*args), "pfb_fine")
    assert y_re.shape == y_im.shape == (s // c, n, c)
    assert bool(torch.isfinite(y_re).all() and torch.isfinite(y_im).all())
    want = pk.pfb_fine_plain(*ops, 16)
    want_re, want_im = TCH.planes(want.view(s // c, c, n))
    scale = float(want.abs().max())
    assert float(torch.complex(y_re - want_re, y_im - want_im).abs().max()
                 ) <= pk.FINE_REL * scale
    old = ck.bank_complex(x[rows], hist,
                          TCH.modulated_taps(taps, fine[:, None]),
                          phase0[:, None], step[:, None], 16)[:, 0]
    assert float((_fine_rows(y_re, y_im) - old).abs().max()
                 ) <= COMPLEX_REL * scale


@pytest.mark.cuda
def test_pfb_fine_at_bench_shape(cuda_device):
    """The fine stage at 128 × 64 rows of one 100 ms block over the 768
    bin rows (``track_turns.fine_bench_operands``), at the plan's 12 rows a
    block and at one: the planes [128, 2500, 64] every element finite,
    all 8192 rows within 1e-4·max|y| of the complex bank on the gathered
    rows' modulated taps (the wide plan at one slot), and the first 64
    rows within FINE_REL·max|y| of ``pfb_fine_plain`` (all 8192 would
    need 38 GB of windows)."""
    from radiocapture_tpu_torch.tools import track_turns
    xb, rows, hist, taps, fine, phase0, step, d = \
        track_turns.fine_bench_operands(cuda_device)
    old = ck.bank_complex(xb[rows], hist,
                          TCH.modulated_taps(taps, fine[:, None]),
                          phase0[:, None], step[:, None], d)[:, 0]
    scale = float(old.abs().max())
    sub = slice(0, 64)
    want = pk.pfb_fine_plain(xb, rows[sub], hist[sub], taps, fine[sub],
                             phase0[sub], step[sub], d)
    n = xb.shape[1] // d
    for rb in (None, 1):
        args, planes = pk.pfb_fine_args(
            xb, rows, hist, taps, fine, phase0, step, d, 64, rb=rb,
            out=_nan_planes(8192, n, 64, cuda_device))
        kernels.check(kernels.load().pfb_fine_launch(*args), "pfb_fine")
        assert planes[0].shape == (128, n, 64)
        got = _fine_rows(*planes)
        assert bool(torch.isfinite(torch.view_as_real(got)).all())
        assert float((got - old).abs().max()) <= COMPLEX_REL * scale
        assert float((got[sub] - want).abs().max()) <= pk.FINE_REL * float(
            want.abs().max())


@pytest.mark.cuda
def test_pfb_step_launches_the_mixer(cuda_device):
    """One ``PfbXlatBank`` step on the card launches ``pfb_bins`` and
    ``pfb_fine`` once each and the complex bank not at all, and
    ``pfb_fine`` refuses bins it cannot read whole (bf16, off 16 bytes),
    operands off the card and rows that are not whole sources."""
    bank = TCH.PfbXlatBank(4, 2.4e6, 12500.0)
    st = bank.init(2, cuda_device)
    x = torch.zeros((2, 16 * bank.decim, 2), device=cuda_device)
    offs = torch.full((2, 4), 0.01, device=cuda_device)
    names = ("pfb_bins", "pfb_fine", "xlat_complex")
    before = [trace.counter(f"launch.{k}") for k in names]
    bank(st, x, offs)
    assert [trace.counter(f"launch.{k}") - b
            for k, b in zip(names, before)] == [1, 1, 0]
    rng = np.random.default_rng(7)
    ops = _fine_operands(rng, 3, 2, 10, 47, cuda_device)
    with pytest.raises(ValueError, match="float32 bins"):
        pk.pfb_fine(ops[0].bfloat16(), *ops[1:], 16, 3)
    with pytest.raises(ValueError, match="float32 bins"):
        pk.pfb_fine(ops[0].view(-1)[2:-2].view(2, 159, 2), *ops[1:], 16, 3)
    with pytest.raises(ValueError, match="rows must be"):
        pk.pfb_fine(ops[0], ops[1].cpu(), *ops[2:], 16, 3)
    with pytest.raises(ValueError, match="whole sources"):
        pk.pfb_fine(*ops, 16, 2)


@pytest.mark.cuda
def test_pfb_call_planes_is_the_kernels_planes(cuda_device):
    """``PfbXlatBank.call_planes`` on the card returns ``pfb_fine``'s
    planes as the kernel wrote them (one launch, no copy: the step's
    planes are the kernel's output), and ``__call__``'s complex channels
    are those planes transposed, bit for bit, with the same new state."""
    bank = TCH.PfbXlatBank(4, 2.4e6, 12500.0)
    rng = np.random.default_rng(29)
    offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (2, 4)).astype(
        np.float32), device=cuda_device)
    x = torch.as_tensor(_complex_normal(rng, (2, 1024 * bank.m)),
                        device=cuda_device)
    st = bank.init(2, cuda_device)
    before = trace.counter("launch.pfb_fine")
    st_p, y_re, y_im = bank.call_planes(st, x, offs)
    assert trace.counter("launch.pfb_fine") == before + 1
    st_c, y = bank(st, x, offs)
    assert y.shape == (2, 4, 1024 // 16) and y.is_contiguous()
    want_re, want_im = TCH.planes(y)
    assert torch.equal(_bits(y_re), _bits(want_re))
    assert torch.equal(_bits(y_im), _bits(want_im))
    for a, b in zip(st_p.fine, st_c.fine):
        assert torch.equal(a, b)


def _p25_pfb_decode(dev):
    """The P25 fixture at +50 kHz through ``ControlPipeline.p25_c4fm(8,
    800e3, frontend="pfb")`` on ``dev``, one block multiple a step: the
    fixture slot's (dibits, valid flags) over the stream."""
    fs = 800e3
    pipe = ControlPipeline.p25_c4fm(8, fs, frontend="pfb")
    dib, _expected = streams.p25_control_stream(4)
    iq = M.upsample_to(M.c4fm_modulate(dib, 25000.0), 25000.0, fs)
    bm = pipe.block_multiple
    n = -(-len(iq) // bm) * bm
    x = complex_to_wire(M.multi_channel(fs, [(50e3, iq)], n)[None], dev)
    offs = torch.zeros((1, 8), device=dev)
    offs[0, 2] = 50e3 / fs
    offs[0, 5] = -0.3
    st = pipe.init(1, dev)
    got = []
    for b in range(0, n, bm):
        st, out = pipe.step(st, x[:, b:b + bm], offs)
        got.append([o.cpu() for o in out])
    out = [torch.cat([g[i] for g in got], -1) for i in range(3)]
    return out[2][0, 2], out[1][0, 2]


@pytest.mark.cuda
def test_pfb_decode_matches_the_modulated_taps(cuda_device, monkeypatch):
    """``decode pfb``: the fixture slot's dibits and valid flags through
    the pfb step on ``pfb_fine`` identical to the same step with the fine
    stage swapped for the form it replaced (the complex bank on the
    gathered rows' modulated taps, on the card, then ``planes()``)."""
    got_dib, got_val = _p25_pfb_decode(cuda_device)

    def modulated(xb, rows, hist, taps, fine, phase0, step, d, c):
        y = ck.bank_complex(xb[rows], hist,
                            TCH.modulated_taps(taps, fine[:, None]),
                            phase0[:, None], step[:, None], d)
        return TCH.planes(y.view(-1, c, y.shape[-1]))

    monkeypatch.setattr(TCH, "pfb_fine", modulated)
    old_dib, old_val = _p25_pfb_decode(cuda_device)
    assert int(got_val.sum()) > 0
    assert torch.equal(got_val, old_val)
    assert torch.equal(got_dib[got_val.bool()], old_dib[old_val.bool()])


@pytest.mark.cuda
def test_pfb_step_profile_has_no_planes_copy(cuda_device):
    """A profiled pfb ``ControlPipeline.step`` (2 sources × 64 slots at
    2.4 MS/s, one 100 ms block, after a warm-up step) launches
    ``pfb_fine`` once and none of the device kernels that ``planes()``
    of the bank's [S, C, N] channels launches: the trackers read the
    kernel's planes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pipe = ControlPipeline.p25_c4fm(64, 2.4e6, frontend="pfb")
    x = torch.randn((2, 240000, 2), device=cuda_device).to(torch.bfloat16)
    offs = ((torch.arange(64, device=cuda_device) - 32) * 25e3 / 2.4e6
            ).expand(2, 64).contiguous()
    st = pipe.init(2, cuda_device)
    st, _ = pipe.step(st, x, offs)

    def kernels_of(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset"))}

    _, y = pipe.bank(st.bank, x, offs)
    copies = kernels_of(lambda: TCH.planes(y))
    assert copies
    step = kernels_of(lambda: pipe.step(st, x, offs))
    assert [n for k, n in step.items() if "pfb_fine" in k] == [1]
    assert not set(copies) & set(step), set(copies) & set(step)


@pytest.mark.cuda
@pytest.mark.parametrize("fs,m,atten,wire,t", [
    (2.4e6, 6, 80.0, "bf16", 240000), (2.4e6, 6, 80.0, "float32", 6000),
    (800e3, 8, 60.0, "complex64", 8000), (1.6e6, 16, 60.0, "float32", 1600),
    (20e6, 50, 80.0, "bf16", 200000), (40e6, 100, 80.0, "float32", 400000)])
def test_pfb_bins_are_ifft_rot_transposed(cuda_device, fs, m, atten, wire,
                                          t):
    """``PfbChannelizer.bins`` on the card (one ``pfb_bins`` launch) is
    ``(ifft(v) · rot)`` transposed and ``rows``' channels transposed within
    ``BINS_REL``·max|bins| (the kernel's IDFT sums in another order than
    cuFFT), with ``rows``' new history bit for bit: the bench shape (128
    sources, bf16) and small float32 and complex64 blocks at M = 6, 8 and
    16, and the 20 and 40 MS/s banks (M = 50 and 100, the IDFT factored
    as 5·10 and 10·10)."""
    pfb = TCH.PfbChannelizer.for_rates(fs, m, atten_db=atten)
    rng = np.random.default_rng(m + t)
    s = 128 if t == 240000 else 3
    x = torch.as_tensor(rng.standard_normal((s, t, 2)).astype(np.float32),
                        device=cuda_device)
    x = (x.to(torch.bfloat16) if wire == "bf16" else
         torch.view_as_complex(x) if wire == "complex64" else x)
    st = pfb.init(s, cuda_device)._replace(history=torch.as_tensor(
        _complex_normal(rng, (s, (pfb.p - 1) * m)), device=cuda_device))
    before = trace.counter("launch.pfb_bins")
    sb, yb = pfb.bins(st, x)
    assert trace.counter("launch.pfb_bins") == before + 1
    sr, yr = pfb.rows(st, x)
    v, _ = pk.pfb_rows(st.history, x, pfb.device_hp2(cuda_device))
    rot = torch.as_tensor(pfb.rot, device=cuda_device)
    want = torch.fft.ifft(v, dim=-1, norm="forward") * rot
    assert yb.shape == (s, m, t // m) and yb.is_contiguous()
    for ref in (want, yr):
        ref = ref.transpose(1, 2)
        assert float((yb - ref).abs().max()) <= pk.BINS_REL * float(
            ref.abs().max())
    assert torch.equal(torch.view_as_real(sb.history),
                       torch.view_as_real(sr.history))


@pytest.mark.cuda
def test_pfb_bank_routing_on_card_matches_cpu(cuda_device):
    """``PfbXlatBank`` on the card and on the CPU over three blocks (1024,
    256 < K2-1 and 1024 bin samples) through the routing cases of
    ``tests/test_torch_pfb_bins.py``: bins 5, 5, 0, 2 and all on bin 1,
    two slots retuned to other bins before the last block. The channels
    within 1e-4·max|y| (the card's fine stage the mixer kernel, the CPU's
    the modulated taps, whose float32 angles round up to 4.9e-5·max|y|
    apart from it), the phase equal, the fine history within 1e-5 of the
    CPU's (the kernel's bins and the CPU's FFT round apart)."""
    bank = TCH.PfbXlatBank(4, 2.4e6, 12500.0)
    offs = (np.array([[-410e3, -395e3, 12.5e3, 790e3],
                      [400e3, 390e3, 410e3, 450e3]]) / 2.4e6).astype(
        np.float32)
    later = offs.copy()
    later[0, 2], later[1, 0] = 805e3 / 2.4e6, -790e3 / 2.4e6
    rng = np.random.default_rng(18)
    st = {"cuda": bank.init(2, cuda_device), "cpu": bank.init(2, "cpu")}
    for b, n_bin in enumerate((1024, 256, 1024)):
        o = torch.from_numpy(later if b == 2 else offs)
        xb = torch.from_numpy(_complex_normal(rng, (2, n_bin * bank.m)))
        st["cuda"], got = bank(st["cuda"], xb.to(cuda_device),
                               o.to(cuda_device))
        st["cpu"], want = bank(st["cpu"], xb, o)
        scale = float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= COMPLEX_REL * scale
        assert torch.equal(st["cuda"].fine.phase.cpu(), st["cpu"].fine.phase)
        assert float((st["cuda"].fine.history.cpu()
                      - st["cpu"].fine.history).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("frontend,fs", [("pfb", 800e3), ("fft", 200e3)])
def test_frontend_pipeline_on_card_matches_cpu(cuda_device, frontend, fs):
    """A P25 fixture through ``ControlPipeline.step`` with the pfb or fft
    bank on the card and on the CPU: the banks' channels within
    1e-4·max|y| (the pfb fine stage on the mixer kernel, the CPU's on the
    modulated taps), the fixture slot's decisions agree and decode the
    same grants."""
    check_card_against_cpu(cuda_device, frontend, fs)


@pytest.mark.cuda
def test_fsk4_block_on_card_matches_cpu(cuda_device):
    """``ControlPipeline.fsk4_block = 10`` (pfb bank): the step's plain
    chain discriminator → boxcar → ``fsk4_demod_block`` → slicer on the
    card, with no tracker kernel launched, against the same step on the
    CPU: the fixture slot's decisions agree and decode the same grants."""
    check_card_against_cpu(cuda_device, "pfb", 800e3, fsk4_block=10)


def check_card_against_cpu(dev0, frontend, fs, fsk4_block=0):
    """The P25 fixture at +50 kHz through ``ControlPipeline.step`` on
    ``dev0`` and on the CPU, one block multiple at a time (with
    ``fsk4_block``, 100 multiples: 100 tracked samples at 800 kHz, ten
    chunks of the block tracker)."""
    pipe = ControlPipeline.p25_c4fm(8, fs, frontend=frontend)
    pipe.fsk4_block = fsk4_block
    dib, expected = streams.p25_control_stream(4)
    iq = M.upsample_to(M.c4fm_modulate(dib, 25000.0), 25000.0, fs)
    bm = pipe.block_multiple * (100 if fsk4_block else 1)
    n = -(-len(iq) // bm) * bm
    x = complex_to_wire(M.multi_channel(fs, [(50e3, iq)], n)[None], "cpu")
    offs = torch.zeros((1, 8))
    offs[0, 2] = 50e3 / fs
    offs[0, 5] = -0.3
    outs, chans = [], []
    for dev in (dev0, torch.device("cpu")):
        st = pipe.bank.init(1, dev)
        before = (trace.counter("launch.pfb_fine"),
                  trace.counter("launch.pfb_bins"),
                  trace.counter("launch.xlat_complex"))
        _, y = pipe.bank(st, x[:, :bm].to(dev), offs.to(dev))
        if frontend == "pfb" and dev.type == "cuda":
            assert (trace.counter("launch.pfb_fine"),
                    trace.counter("launch.pfb_bins"),
                    trace.counter("launch.xlat_complex")) == (
                        before[0] + 1, before[1] + 1, before[2])
        chans.append(y.cpu())
        st = pipe.init(1, dev)
        got = []
        tracks = trace.counter("launch.fsk_track")
        for b in range(0, n, bm):
            st, out = pipe.step(st, x[:, b:b + bm].to(dev), offs.to(dev))
            got.append([o.cpu() for o in out])
        if dev.type == "cuda":
            assert trace.counter("launch.fsk_track") - tracks == (
                0 if fsk4_block else n // bm)
        outs.append([torch.cat([g[i] for g in got], -1) for i in range(3)])
    scale = float(chans[1].abs().max())
    err = float((chans[0] - chans[1]).abs().max())
    assert err <= COMPLEX_REL * scale, (err, scale)
    # the burst's span: past it the lane runs on near-silence, where the
    # loop drifts between devices as noise lanes do
    span = len(iq) // (pipe.decim * pipe.sym_decim)
    agree = float((outs[0][1][0, 2, :span] == outs[1][1][0, 2, :span])
                  .float().mean())
    assert agree >= 0.99, agree
    g = [streams.grants(o[2][0, 2][o[1][0, 2].bool()].numpy()) for o in outs]
    assert g[0] == g[1] and len(g[0]) >= 2, g
    assert all(x in expected for x in g[0])


# ---- the pfb frontend's combiner: csrc/pfb_rows.cu

def _pfb_rows_inputs(dev, case):
    """(bank, history, block) of a ``test_pfb_rows_kernel_matches_plain``
    case: the bench shape on a bf16 or float32 wire, complex64 at the CPU
    tests' M = 8 / M = 16 banks, or 60 samples after a bench block."""
    rng = np.random.default_rng(len(case))
    m, fs, atten = {"m8": (8, 800e3, 60.0), "m16": (16, 1.6e6, 60.0)}.get(
        case, (6, 2.4e6, 80.0))
    pfb = TCH.PfbChannelizer.for_rates(fs, m, atten_db=atten)
    s = 4 if case in ("m8", "m16") else 128
    hist = torch.as_tensor(_complex_normal(rng, (s, (pfb.p - 1) * m)),
                           device=dev)
    if case in ("m8", "m16"):
        return pfb, hist, torch.as_tensor(_complex_normal(rng, (s, m * 5000)),
                                          device=dev)
    x = torch.as_tensor(rng.standard_normal((s, 240000, 2)).astype(
        np.float32), device=dev)
    if case != "bench_f32":
        x = x.to(torch.bfloat16)
    if case == "short":
        hist = pfb.rows(TCH.PfbState(history=hist), x)[0].history
        x = x[:, :60].contiguous()
    return pfb, hist, x


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bench_bf16", "bench_f32", "m8", "m16",
                                  "short"])
def test_pfb_rows_kernel_matches_plain(cuda_device, case):
    """The pfb combiner's kernel against ``pfb_rows_plain`` on the card,
    one launch: the bench shape (128 × 240000 samples, M = 6, P = 24) on
    bf16 and float32 wires, complex64 blocks at M = 8 and 16, and a
    60-sample block (n = 10 < P-1) after a bench block. The rows and the
    new history are bit-identical: the kernel keeps the eager chain's
    order and its fma."""
    pfb, hist, x = _pfb_rows_inputs(cuda_device, case)
    hp2 = pfb.device_hp2(cuda_device)
    before = trace.counter("launch.pfb_rows")
    v, nh = pk.pfb_rows(hist, x, hp2)
    assert trace.counter("launch.pfb_rows") == before + 1
    pv, pnh = pk.pfb_rows_plain(hist, x, hp2)
    assert v.shape == (x.shape[0], x.shape[1] // pfb.num_channels,
                       pfb.num_channels)
    assert torch.equal(torch.view_as_real(v).view(torch.int32),
                       torch.view_as_real(pv).view(torch.int32))
    assert torch.equal(torch.view_as_real(nh).view(torch.int32),
                       torch.view_as_real(pnh).view(torch.int32))


# ---- the pfb step's coarse PFB in one kernel: pfb_bins (csrc/pfb_rows.cu)

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bench_bf16", "bench_f32", "m8", "m16",
                                  "m20", "m25", "m50", "m100", "short",
                                  "m7", "m11", "m105", "m112"])
def test_pfb_bins_kernel_matches_plain(cuda_device, case):
    """``pfb_bins`` against ``pfb_bins_plain`` on the card, one launch:
    the bench shape (128 × 240000 samples, M = 6) on bf16 and float32
    wires, the pfb mode's 80 dB banks at M = 8 (complex64), 16 (float32),
    20 and 25 (the live config's 8 and 10 MS/s, bf16), 50 (bf16, four
    rounds of warps) and 100 (float32), the IDFT factored at each, a
    60-sample block after a bench block, the direct table at the primes
    M = 7 and 11, and the largest factors the plan takes below M = 116,
    7·15 and 8·14 (bf16). The bins within ``BINS_REL``·max|bins|, the new
    history bit-identical."""
    if case in ("bench_bf16", "bench_f32", "short"):
        pfb, hist, x = _pfb_rows_inputs(cuda_device, case)
    else:
        m = int(case[1:])
        pfb = TCH.PfbChannelizer.for_rates(m * 400e3, m, atten_db=80.0)
        rng = np.random.default_rng(m)
        hist = torch.as_tensor(_complex_normal(rng, (4, (pfb.p - 1) * m)),
                               device=cuda_device)
        x = torch.as_tensor(rng.standard_normal((4, m * 4000, 2)).astype(
            np.float32), device=cuda_device)
        x = {8: torch.view_as_complex(x), 16: x, 100: x}.get(
            m, x.to(torch.bfloat16))
    hp2 = pfb.device_hp2(cuda_device)
    before = trace.counter("launch.pfb_bins")
    y, nh = pk.pfb_bins(hist, x, hp2)
    assert trace.counter("launch.pfb_bins") == before + 1
    py, pnh = pk.pfb_bins_plain(hist, x, hp2)
    assert y.shape == py.shape and y.is_contiguous()
    scale = float(py.abs().max())
    assert float((y - py).abs().max()) <= pk.BINS_REL * scale
    assert torch.equal(torch.view_as_real(nh).view(torch.int32),
                       torch.view_as_real(pnh).view(torch.int32))


# ---- the scan slice: scan/, tools/file_to_wav.py on the card

SCAN_CENTER, SCAN_CC = 857.0e6, 857.5e6
# The analog WAV, card against CPU, as a share of PCM full scale: the
# card's bank takes bf16 operands (FUSED_REL of the channel's scale),
# which the discriminator sees as phase noise.
WAV_REL = FUSED_REL


def _trial_candidates(c):
    """``c`` candidates: the control channel 200 Hz off first, then empty
    12.5 kHz raster points (``tests/test_scan.py``'s two empties first)."""
    rest = [SCAN_CENTER - 300e3, SCAN_CENTER + 600e3] + [
        SCAN_CENTER - 900e3 + k * 12.5e3 for k in range(c)]
    return [SCAN_CC + 200.0] + rest[:c - 1]


@pytest.mark.cuda
def test_spectrum_on_card_matches_cpu(cuda_device):
    """``SpectrumScanner`` on cuFFT: the two-carrier spectrum within
    ``streams.spectrum_tolerance`` of the CPU port's, float32 kept on the
    card (no bf16 wire), and ``find_channels`` gives the same peaks."""
    from radiocapture_tpu_torch.scan import SpectrumScanner, find_channels
    wide = streams.two_carriers()
    sc = SpectrumScanner(16384)
    got, want = (sc.spectrum_db(sc.step(sc.init(dev), wide))
                 for dev in (cuda_device, "cpu"))
    assert np.all(np.abs(got - want) <= streams.spectrum_tolerance(want))
    peaks = [[p.frequency for p in find_channels(s, 2.4e6, SCAN_CENTER)]
             for s in (got, want)]
    assert peaks[0] == peaks[1] and len(peaks[0]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 40, 64])
def test_trial_lock_on_card_matches_cpu(cuda_device, c):
    """``trial_p25_lock`` with ``c`` candidate slots (off the tracker's
    32-slot tile at 1, 3 and 40) on the card decides as on the CPU: the
    same locked set and site detail, offsets within 1 Hz; the control
    channel locks at 200 Hz."""
    from radiocapture_tpu_torch.scan import trial_p25_lock
    site = streams.site_capture(SCAN_CC, SCAN_CENTER)
    cands = _trial_candidates(c)
    before = (trace.counter("launch.xlat_bank"),
              trace.counter("launch.fsk_track"))
    got = trial_p25_lock(site, 2.4e6, SCAN_CENTER, cands,
                         device=cuda_device)
    assert trace.counter("launch.xlat_bank") > before[0]
    assert trace.counter("launch.fsk_track") > before[1]
    want = trial_p25_lock(site, 2.4e6, SCAN_CENTER, cands, device="cpu")
    assert streams.same_trials(got, want)
    assert got[0].locked and abs(got[0].offset_hz - 200.0) < 1.0
    assert got[0].site_detail["Control Channel"] == int(SCAN_CC)
    assert not any(r.locked for r in got[1:])


@pytest.mark.cuda
def test_fft_scan_on_card_matches_cpu(cuda_device):
    """``run_fft_scan`` (the scan CLI's fft mode) on ``tests/
    test_scan.py``'s CLI capture: the same peaks trialled and the same
    decisions on the card as on the CPU, the control channel locked."""
    from radiocapture_tpu_torch.scan.__main__ import run_fft_scan
    cc = SCAN_CC - 100e3
    n = len(streams.site_capture(cc, SCAN_CENTER, n_frames=30))
    iq = streams.site_capture(cc, SCAN_CENTER, n_frames=30,
                              n=n // 16384 * 16384,
                              rng=np.random.default_rng(3))
    got, want = (run_fft_scan(iq, 2.4e6, SCAN_CENTER, device=dev)
                 for dev in (cuda_device, "cpu"))
    assert streams.same_trials(got, want)
    assert any(r.locked and r.site_detail["Control Channel"] == int(cc)
               for r in got)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 40])
def test_scanner_on_card_matches_cpu(cuda_device, c):
    """``ScanningReceiver`` watching ``c`` channels (an FM carrier on the
    first) on the card: the squelch cycle gives the CPU port's events and
    CDRs — new call, activity, timeout after the hang time."""
    from radiocapture_tpu_torch.scan import ScanChannel, ScanningReceiver
    freqs = [SCAN_CENTER + 100e3] + [SCAN_CENTER - 600e3 + k * 12.5e3
                                     for k in range(c - 1)]
    before = (trace.counter("launch.xlat_bank"),
              trace.counter("launch.fm_voice"))
    got, opened = streams.squelch_cycle(ScanningReceiver, ScanChannel, freqs,
                                        SCAN_CENTER, device=cuda_device)
    assert trace.counter("launch.xlat_bank") > before[0]
    assert trace.counter("launch.fm_voice") > before[1]
    want, _ = streams.squelch_cycle(ScanningReceiver, ScanChannel, freqs,
                                    SCAN_CENTER, device="cpu")
    assert got == want
    kinds = [k for k, _ in got]
    assert kinds[0] == "new" and kinds[-1] == "to" and "act" in kinds
    assert opened[0]["system_group_local"] == freqs[0]


@pytest.mark.cuda
def test_file_to_wav_on_card_matches_cpu(cuda_device, tmp_path):
    """``file_to_wav`` (C = 1) on the card: the analog WAV carries the
    700 Hz tone and is within WAV_REL of full scale of the CPU port's;
    ``decode_p25`` gives the CPU port's frame stats."""
    from radiocapture_tpu_torch.audio.wav import read_wav
    from radiocapture_tpu_torch.tools.file_to_wav import (decode_p25,
                                                          file_to_wav)
    inp = tmp_path / "cap.dat"
    streams.tone_capture(-300e3).tofile(inp)
    pcm = {}
    for name, dev in (("card", cuda_device), ("cpu", "cpu")):
        file_to_wav(str(inp), str(tmp_path / f"{name}.wav"), 2.4e6,
                    -300e3, "analog", device=dev)
        pcm[name], rate = read_wav(str(tmp_path / f"{name}.wav"))
    assert rate == 8000 and pcm["card"].shape == pcm["cpu"].shape
    err = np.abs(pcm["card"].astype(np.int64)
                 - pcm["cpu"].astype(np.int64)).max() / 32768.0
    assert err <= WAV_REL, err
    assert abs(streams.tone_peak_hz(pcm["card"]) - 700.0) < 15.0
    ldu = streams.ldu_capture(100e3)
    before = trace.counter("launch.fsk_track")
    _, got = decode_p25(ldu, 2.4e6, 100e3, device=cuda_device)
    assert trace.counter("launch.fsk_track") > before
    _, want = decode_p25(ldu, 2.4e6, 100e3, device="cpu")
    assert got == want and got["imbe"] >= 18


@pytest.mark.cuda
def test_bf16_bits_upload_on_card(cuda_device):
    """A uint16 block of bf16 bits (the port's ingest ring pops them so)
    goes to the card as ``torch.bfloat16`` with the values of the same
    block converted exactly and uploaded as float32."""
    from radiocapture_tpu_torch.device import wire_from_numpy
    from radiocapture_tpu_torch.frontend.ingest import IngestRing
    ring = IngestRing("cu8", capacity_samples=1 << 16)
    ring.push(np.random.default_rng(4).integers(0, 256, 2 * 4096)
              .astype(np.uint8))
    bits = ring.pop_bf16(4096)[None]
    ring.close()
    got = wire_from_numpy(bits, cuda_device)
    want = wire_from_numpy((bits.astype(np.uint32) << 16).view(np.float32),
                           cuda_device)
    assert got.dtype == torch.bfloat16 and got.device == want.device
    assert want.dtype == torch.float32 and got.shape == (1, 4096, 2)
    assert torch.equal(got.float(), want)


@pytest.mark.cuda
def test_live_rtl_tcp_runtime_on_card_decodes_as_cpu(cuda_device, tmp_path):
    """``SiteRuntime`` on the card, fed by ``providers_from_config`` from
    a fake rtl_tcp daemon (bf16 wire), decodes the same control messages
    as the CPU port from the same stream, the grant (Group Address 900)
    included, through the bank and tracker kernels."""
    from radiocapture_tpu_torch.frontend.rtl_tcp import FakeRtlTcpServer
    from radiocapture_tpu_torch.runtime import providers_from_config
    samp, center, cc, n_blocks = 2.4e6, 857.0e6, 857.5e6, 20
    srv = FakeRtlTcpServer(streams.live_control(), samp_rate=10 * samp,
                           realtime=True)
    msgs, dtypes = {}, {}
    before = (trace.counter("launch.xlat_bank"),
              trace.counter("launch.fsk_track"))
    try:
        for name, dev in (("card", cuda_device), ("cpu", "cpu")):
            cfg = RcConfig(audio_dir=str(tmp_path / name))
            cfg.num_slots_per_source = 8
            cfg.block_seconds = 0.05
            cfg.sources[0] = SourceConfig(
                type="rtlsdr", args=f"rtl_tcp={srv.host}:{srv.port}",
                center_freq=center, samp_rate=samp)
            cfg.systems[0] = SystemConfig(type="p25", id="LiveSys",
                                          control_channels=[cc])
            providers, live = providers_from_config(cfg)
            try:
                rt = SiteRuntime(cfg, providers, dev)
                need = n_blocks * rt.block_len(0)
                deadline = time.time() + 10.0
                while live[0].ring.available < need:
                    assert time.time() < deadline, "rtl_tcp did not fill"
                    time.sleep(0.01)
                rt.use_stream_clock()
                msgs[name] = []
                rt.bus.subscribe("/topic/raw_control/*", msgs[name].append)
                rt.run(n_blocks=n_blocks)
                rt.bus.flush()
                dtypes[name] = {g["in_dtype"] for g in rt.groups.values()}
                rt.close()
            finally:
                for s in live:
                    s.stop()
    finally:
        srv.close()
    assert trace.counter("launch.xlat_bank") > before[0]
    assert trace.counter("launch.fsk_track") > before[1]
    assert dtypes["card"] == {np.dtype(np.uint16)}
    assert any(m.get("name") == "GRP_V_CH_GRANT" and m.get("crc") == 0
               and m["Group Address"] == 900 for m in msgs["card"])
    assert msgs["card"] == msgs["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,nb", [(1, 2, 2000), (3, 5, 1998), (2, 40, 50),
                                    (1, 64, 8)])
@pytest.mark.parametrize("ctor", ["p25_c4fm", "edacs"])
def test_track_stream_kernel_matches_plain(cuda_device, ctor, s, c, nb):
    """The stream tracker (``fsk_track_stream_launch``) on the pre-scan
    stream of modulated lanes, three blocks in a row (state written back
    in place), against ``track_stream_plain``: identical valid masks and
    dibits, syms and the fsk4 state within 1e-3. Lane counts off the
    32-slot tile, M off the 128-row ring stage and shorter than one
    16-sample producer segment."""
    pipe = getattr(ControlPipeline, ctor)(2, 200e3)
    prm = pipe.track_params
    lanes = _track_lanes(pipe, ctor, s, c, 3 * nb, np.random.default_rng(c))
    y = torch.as_tensor(lanes, device=cuda_device).transpose(1, 2)
    trk = pipe.prescan(y, fm.quad_demod_init((s, c), cuda_device),
                       torch.zeros((s, c, len(prm.sym_taps) - 1),
                                   device=cuda_device))
    m = nb // prm.sym_decim
    st = [K.fsk4_init((s, c), cuda_device) for _ in range(2)]
    before = trace.counter("launch.fsk_track_stream")
    for b in range(3):
        x = trk[..., b * m:(b + 1) * m].contiguous()
        got = tk.track_stream(x, st[0], prm)
        want = tk.track_stream_plain(x, st[1], prm)
        st = [got[0], want[0]]
        assert got[1].shape == (s, c, m)
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[3], want[3])
        assert float((got[1] - want[1]).abs().max()) <= 1e-3
        for g_, w_ in zip(got[0], want[0]):
            assert float((g_ - w_).abs().max()) <= 1e-3
    assert trace.counter("launch.fsk_track_stream") == before + 3
    with pytest.raises(ValueError, match="contiguous float32"):
        tk.track_stream(trk[..., :m], st[0], prm)


@pytest.mark.cuda
def test_fsk_track_unchanged_from_3e03d30(cuda_device):
    """``fsk_track`` gives the outputs and state of the kernel as commit
    3e03d30 had it (``tools/fsk_track_3e03d30.cu``, the file before the
    stream entry) bit for bit, lane for lane."""
    from radiocapture_tpu_torch.tools import track_turns
    pipe = ControlPipeline.p25_c4fm(64, 2.4e6)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    y_re, y_im = (torch.randn((2, 2500, 64), generator=gen,
                              device=cuda_device) for _ in range(2))
    res = track_turns.fsk_turns(track_turns.EARLIER_FSK, y_re, y_im,
                                pipe.init(2, cuda_device), pipe.track_params,
                                iters=1)
    assert res["identical_lanes"] == res["lanes"] == 128


def _mesh_steps_rank(dev, slots: int) -> dict:
    """A world of one rank: the dry run's grant capture on two sources
    through ``ShardedControlStep`` on ``make_mesh(1)`` and
    ``TimeShardedControlStep.step_debug`` on ``make_mesh3(1)`` at
    ``slots`` slots (the tile a slot split leaves), float32 wire."""
    from radiocapture_tpu_torch import entry
    from radiocapture_tpu_torch.parallel import mesh as MESH
    pipe = ControlPipeline.p25_c4fm(slots, entry.DRYRUN_RATE)
    wide = entry.grant_capture()
    offs = torch.zeros((2, slots), device=dev)
    offs[:, 0] = entry.DRYRUN_OFFSET / entry.DRYRUN_RATE
    out = {}
    for name, step, blk in (
            ("dp_tp", MESH.ShardedControlStep(pipe, MESH.make_mesh(1), 2),
             pipe.block_multiple * 32),
            ("time", MESH.TimeShardedControlStep(pipe, MESH.make_mesh3(1), 2),
             pipe.block_multiple * 64)):
        st, outs = step.init(dev), []
        run = step.step_debug if name == "time" else step.step
        for i in range(len(wide) // blk):
            xb = wide[i * blk:(i + 1) * blk]
            x = torch.as_tensor(np.stack([xb.real, xb.imag], -1)[None],
                                device=dev).expand(2, -1, 2).contiguous()
            st, o = run(st, x, offs)
            outs.append([v.cpu().numpy() for v in o])
        out[name] = [np.concatenate([o[i] for o in outs], -1)
                     for i in range(len(outs[0]))]
        out[name + "_log"] = step.comm.collectives()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [4, 32])
def test_mesh_steps_on_card_match_cpu(cuda_device, slots):
    """World-size-1 mesh steps on the card (NCCL) against the same steps
    on a CPU rank, at the tiles a slot split leaves (C/tp = 4 and 32; the
    wire bank pads both to its 64-slot group): the same grants from the
    grant lane through both steps; the time-sharded pre-scan stream of
    that lane within 2e-3 (float32 complex bank, sum order only, through
    the discriminator's gain); the same collectives."""
    from radiocapture_tpu_torch.parallel import mesh as MESH
    kernels.build()     # here, so the rank only loads the library
    card = MESH.spawn(1, _mesh_steps_rank, slots)[0]
    cpu = MESH.spawn(1, _mesh_steps_rank, slots, device="cpu")[0]
    for name in ("dp_tp", "time"):
        for s in range(2):
            got = [streams.grants(r[name][2][s, 0][r[name][1][s, 0] > 0])
                   for r in (card, cpu)]
            assert len(got[0]) >= 4 and got[0] == got[1]
        assert card[name + "_log"] == cpu[name + "_log"]
    assert card["dp_tp_log"] == []
    assert float(np.abs(card["time"][3][:, 0] - cpu["time"][3][:, 0])
                 .max()) <= 2e-3
