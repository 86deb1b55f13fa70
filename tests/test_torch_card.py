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
from radiocapture_tpu_torch.ops.fir import phase_step_u32
from radiocapture_tpu_torch.runtime import FileSource, SiteRuntime, _tree_map
from radiocapture_tpu_torch.rxconfig import (RcConfig, SourceConfig,
                                             SystemConfig)
from radiocapture_tpu_torch.testing import modulators as M
from radiocapture_tpu_torch.testing import streams

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
    before = ck.bank_fused.launches
    got = ck.bank_fused(z2, ck.kernel_taps(g2, p, d), phase0, step, n, p, d)
    assert ck.bank_fused.launches == before + 1
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
    before = ck.bank_fused.launches
    got = ck.bank_fused(z2, gk, st.phase, step, n, bank.p, d)
    assert ck.bank_fused.launches == before + 1
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
    before = tk.track.launches
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
    assert tk.track.launches == before + 3


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
@pytest.mark.parametrize("s,n,p,d,c,wire,split2", [
    (1, 120000, 10, 2, 2, "bf16", True), (4, 120000, 10, 2, 2, "bf16", True),
    (1, 120000, 10, 2, 2, "float32", True),
    (4, 120000, 10, 2, 2, "float32", False),
    (1, 120000, 10, 2, 2, "complex64", False),
    (4, 120000, 10, 2, 2, "complex64", True),
    (3, 1001, 10, 2, 2, "bf16", True), (2, 5, 10, 2, 2, "float32", True),
    (3, 1001, 15, 96, 40, "bf16", False),
    (2, 37, 15, 96, 40, "float32", False)])
def test_complex_bank_kernel_matches_plain(cuda_device, s, n, p, d, c, wire,
                                           split2):
    """Split2's shape (one 100 ms block of 2.4 MS/s, 20 taps, 2 slots) at
    S = 1 and 4 on bf16, float32 and complex64 blocks read in place, with
    split2's taps and phase step (π per output) or random ones; a ragged
    N off the 224-output warp tile, a block shorter than K-1 (N = 5), and
    the wide C = 40 / K = 1440 / D = 96 case at ragged N: within
    1e-4·max|y| of the plain version on history ++ block, from a random
    history and uint32 phase."""
    rng = np.random.default_rng(n + c + s)
    k = p * d
    x, hist, grev, phase0, step = _complex_operands(
        rng, s, n, k, d, c, wire, cuda_device, split2)
    before = ck.bank_complex.launches
    got = ck.bank_complex(x, hist, grev, phase0, step, d)
    assert ck.bank_complex.launches == before + 1
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
@pytest.mark.parametrize("s,n,p,d,c,wire,split2", [
    (4, 120000, 10, 2, 2, "bf16", True), (3, 1001, 10, 2, 2, "float32", False),
    (2, 5, 10, 2, 2, "bf16", True), (3, 1001, 15, 96, 40, "bf16", False)])
def test_complex_bank_matches_earlier_kernel(cuda_device, s, n, p, d, c,
                                             wire, split2):
    """The kernel against the one it replaced on the same values (that one
    on history ++ block as complex64): every output bit-identical, on
    split2's fast path (its two phasors per slot, and ``sincosf`` per
    output for other offsets) and on the general path."""
    from radiocapture_tpu_torch.tools import track_turns
    rng = np.random.default_rng(n + s)
    k = p * d
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
def _per_sample_cqpsk():
    """The per-sample-loop CQPSK kernel the symbol-major one replaced
    (``tools/cqpsk_track_54b2cf5.cu``), built with the package's flags."""
    from radiocapture_tpu_torch.tools import track_turns
    return track_turns.build_other(track_turns.EARLIER_CQPSK,
                                   "cqpsk_track_launch")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


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
        return CQ.cqpsk_init(fs, baud, (s, c), cuda_device)._replace(
            omega=torch.as_tensor(omega0, device=cuda_device))

    st = {"kernel": fresh(), "earlier": fresh(), "plain": fresh()}
    outs = {k: [] for k in st}
    for b in range(2):
        y_re, y_im = (torch.as_tensor(np.ascontiguousarray(
            p(lanes[:, b * n:(b + 1) * n])), device=cuda_device)
            for p in (np.real, np.imag))
        scale = CQ.agc_scale(y_re, y_im, dim=1)
        outs["kernel"].append(cqk.track_cqpsk(y_re, y_im, scale,
                                              st["kernel"], fs, baud)[1:])
        args, old = cqk.kernel_args(y_re, y_im, scale, st["earlier"], fs,
                                    baud)
        kernels.check(_per_sample_cqpsk()(*args), "cqpsk_track")
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
    before = fk.voice_track.launches
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
    assert fk.voice_track.launches == before + 2


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
    """The complex bank's general path at the shape the pfb frontend's
    fine stage sends (one slot per row, K2 = 467 taps, D = 16, float32
    bin samples; 64 of the 8192 rows of the bench shape, ragged N):
    within 1e-4·max|y| of the plain version, one launch."""
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
    before = ck.bank_complex.launches
    got = ck.bank_complex(x, hist, grev, phase0, step, d)
    assert ck.bank_complex.launches == before + 1
    want = ck.bank_complex_plain(ck.complex_z(x, hist), grev, phase0, step,
                                 n, d)
    assert got.shape == (s, 1, n)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= COMPLEX_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("frontend,fs", [("pfb", 800e3), ("fft", 200e3)])
def test_frontend_pipeline_on_card_matches_cpu(cuda_device, frontend, fs):
    """A P25 fixture through ``ControlPipeline.step`` with the pfb or fft
    bank on the card and on the CPU: the banks' channels within
    1e-4·max|y| (the pfb fine stage on the complex bank kernel), the
    fixture slot's decisions agree and decode the same grants."""
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
        before = ck.bank_complex.launches
        _, y = pipe.bank(st, x[:, :bm].to(dev), offs.to(dev))
        if frontend == "pfb" and dev.type == "cuda":
            assert ck.bank_complex.launches == before + 1
        chans.append(y.cpu())
        st = pipe.init(1, dev)
        got = []
        tracks = tk.track.launches
        for b in range(0, n, bm):
            st, out = pipe.step(st, x[:, b:b + bm].to(dev), offs.to(dev))
            got.append([o.cpu() for o in out])
        if dev.type == "cuda":
            assert tk.track.launches - tracks == (0 if fsk4_block else
                                                  n // bm)
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
    before = (ck.bank_fused.launches, tk.track.launches)
    got = trial_p25_lock(site, 2.4e6, SCAN_CENTER, cands,
                         device=cuda_device)
    assert ck.bank_fused.launches > before[0]
    assert tk.track.launches > before[1]
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
    before = (ck.bank_fused.launches, fk.voice_track.launches)
    got, opened = streams.squelch_cycle(ScanningReceiver, ScanChannel, freqs,
                                        SCAN_CENTER, device=cuda_device)
    assert ck.bank_fused.launches > before[0]
    assert fk.voice_track.launches > before[1]
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
    before = tk.track.launches
    _, got = decode_p25(ldu, 2.4e6, 100e3, device=cuda_device)
    assert tk.track.launches > before
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
    before = (ck.bank_fused.launches, tk.track.launches)
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
    assert ck.bank_fused.launches > before[0]
    assert tk.track.launches > before[1]
    assert dtypes["card"] == {np.dtype(np.uint16)}
    assert any(m.get("name") == "GRP_V_CH_GRANT" and m.get("crc") == 0
               and m["Group Address"] == 900 for m in msgs["card"])
    assert msgs["card"] == msgs["cpu"]
