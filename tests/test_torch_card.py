"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: they skip where torch sees no CUDA device.
This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q
"""

import time

import numpy as np
import pytest
import torch

from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.demod import cqpsk as CQ
from radiocapture_tpu_torch.demod import cqpsk_kernel as cqk
from radiocapture_tpu_torch.demod import fsk4 as K
from radiocapture_tpu_torch.demod import track_kernel as tk
from radiocapture_tpu_torch.device import complex_to_wire
from radiocapture_tpu_torch.frontend.pipeline import (ControlPipeline,
                                                      SpectrumSplit2)
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
                                   (3, 37, 5)])
def test_bank_kernel_matches_plain(cuda_device, s, n, c):
    """Mid-stream inputs, ragged N and slot counts off the 32-slot tile:
    within 0.03·max|y|."""
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
    got = ck.bank_fused(z2, g2, phase0, step, n, p, d)
    assert ck.bank_fused.launches == before + 1
    want = ck.bank_fused_plain(z2, g2, phase0, step, n, p, d)
    scale = max(float(w.abs().max()) for w in want)
    for g_, w_ in zip(got, want):
        assert g_.shape == (s, n, c)
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


@pytest.mark.cuda
@pytest.mark.parametrize("ctor", ["p25_c4fm", "edacs", "moto"])
def test_track_kernel_matches_plain(cuda_device, ctor):
    """Identical valid masks and dibits on a modulated lane and a 0.3×
    copy, two blocks in a row (state written back in place)."""
    pipe = getattr(ControlPipeline, ctor)(2, 200e3)
    prm = pipe.track_params
    rng = np.random.default_rng(0)
    if ctor == "p25_c4fm":
        iq = M.c4fm_modulate(rng.integers(0, 4, 1200), fs=pipe.channel_fs)
    else:
        iq = M.fsk2_modulate(rng.integers(0, 2, 1200), pipe.channel_fs,
                             pipe.symbol_rate, 3000.0)
    nb = 2000
    lanes = np.stack([iq[:2 * nb], 0.3 * iq[:2 * nb]], -1)[None]
    st = [(fm.quad_demod_init((1, 2), cuda_device),
           torch.zeros((1, 2, len(prm.sym_taps) - 1), device=cuda_device),
           K.fsk4_init((1, 2), cuda_device)) for _ in range(2)]
    for b in range(2):
        blk = lanes[:, b * nb:(b + 1) * nb]
        y_re = torch.as_tensor(blk.real.astype(np.float32),
                               device=cuda_device)
        y_im = torch.as_tensor(blk.imag.astype(np.float32),
                               device=cuda_device)
        got = tk.track(y_re, y_im, *st[0], prm)
        want = tk.track_plain(y_re, y_im, *st[1], prm)
        st = [got[:3], want[:3]]
        assert torch.equal(got[4], want[4])
        assert torch.equal(got[5], want[5])
        assert float((got[3] - want[3]).abs().max()) <= 1e-3


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


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,p,d,c", [(4, 120000, 10, 2, 2),
                                       (3, 1001, 15, 96, 40)])
def test_complex_bank_kernel_matches_plain(cuda_device, s, n, p, d, c):
    """Split2's shape (one 100 ms block of 2.4 MS/s, 20 taps, 2 slots) and
    a ragged wide shape: within 1e-4·max|y|, from a random uint32 phase."""
    rng = np.random.default_rng(n + c)
    k = p * d
    z = torch.as_tensor(_complex_normal(rng, (s, (n - 1) * d + k)),
                        device=cuda_device)
    grev = torch.as_tensor(_complex_normal(rng, (s, c, k), k ** -0.5),
                           device=cuda_device)
    offs = torch.as_tensor(rng.uniform(-0.45, 0.45, (s, c)).astype(
        np.float32), device=cuda_device)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, (s, c)),
                             dtype=torch.int64, device=cuda_device)
    step = phase_step_u32(offs, d)
    before = ck.bank_complex.launches
    got = ck.bank_complex(z, grev, phase0, step, n, d)
    assert ck.bank_complex.launches == before + 1
    want = ck.bank_complex_plain(z, grev, phase0, step, n, d)
    assert got.shape == (s, c, n) and got.dtype == torch.complex64
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= COMPLEX_REL * scale


@pytest.mark.cuda
def test_complex_call_carries_complex64_history(cuda_device):
    """``XlatBank.__call__`` on the card (through ``SpectrumSplit2``):
    after each block the history is the block's last K-1 complex64
    samples exactly, ``convert.state_to_jax`` gives the JAX wire layout,
    and the halves agree with the CPU's plain path."""
    sp = SpectrumSplit2(2.4e6)
    k = sp.bank.ntaps
    rng = np.random.default_rng(3)
    xs = [torch.as_tensor(_complex_normal(rng, (2, 4800)),
                          device=cuda_device) for _ in range(2)]
    st, st_cpu = sp.init(2, cuda_device), sp.init(2, "cpu")
    for x in xs:
        st, halves = sp.step(st, x)
        st_cpu, want = sp.step(st_cpu, x.cpu())
        assert st.history.dtype == torch.complex64
        assert torch.equal(st.history, x[:, x.shape[1] - (k - 1):])
        assert torch.equal(st.phase.cpu(), st_cpu.phase)
        err = float((halves.cpu() - want).abs().max())
        assert err <= COMPLEX_REL * float(want.abs().max())
    back = convert.state_to_jax(sp, st)
    assert back.history.shape == (2, k - 1, 2)
    assert back.history.dtype == np.float32
    assert back.phase.shape == (2, 2) and back.phase.dtype == np.int32
    np.testing.assert_array_equal(
        back.history, torch.view_as_real(xs[-1][:, -(k - 1):]).cpu().numpy())


@pytest.mark.cuda
def test_new_wrappers_refuse_wrong_dtypes(cuda_device):
    """The complex bank and CQPSK tracker validate and never convert."""
    z = torch.zeros((1, 30), dtype=torch.complex128, device=cuda_device)
    g = torch.zeros((1, 2, 4), dtype=torch.complex64, device=cuda_device)
    ph = torch.zeros((1, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="z must be"):
        ck.bank_complex(z, g, ph, ph, 4, 2)
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
                                   (2, 37, 5)])
def test_voice_kernel_matches_plain(cuda_device, s, n, c):
    """fm_voice against its plain version at ragged shapes, two blocks
    with the lane state carried: audio within VOICE_REL·max|audio|, power
    and the carried de-emphasis state within VOICE_REL relative."""
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
    torch.testing.assert_close(deemph.x_last, want[1].x_last, rtol=1e-5,
                               atol=1e-6)
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
