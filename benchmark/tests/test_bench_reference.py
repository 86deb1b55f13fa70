"""The plain reference agrees with the program's plain path (its CPU
path) at tiny shapes: channel samples and carried state of each
channelizer, and each demodulator run over the program's decisions."""

import numpy as np
import pytest
import torch

from benchmark.core import spec
from benchmark.core.traffic import WIRE
from benchmark.reference import demod_cqpsk as rcq
from benchmark.reference import demod_fsk4 as rfsk
from benchmark.tests.tiny import WORKLOADS, cell


def wire(s, t, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((s, t, 2), generator=g) * 0.3
    return x.to(dtype)


def program_path(workload):
    c = cell(workload)
    return c, c.path_module().Path(c.cfg, c.traffic, torch.device("cpu"))


# float32 on the CPU path; the pfb's fine taps are modulated at float32
# angles up to ~2π·0.5·K2, which puts its channels ~1e-5 off
CHAN_REL = {"xlat": 1e-5, "split2": 1e-5, "pfb": 1e-4}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_channelizer_matches_program(workload):
    c, path = program_path(workload)
    ref = spec.chan_module(path.reference).Chan(
        c.cfg, c.traffic["samp_rate"], path.sources, path.block, "cpu")
    blocks = [wire(path.sources, path.block, i, WIRE[c.traffic["wire"]])
              for i in range(3)]
    state = path.init()
    for k, x in enumerate(blocks):
        kept = []
        path.attach(type("P", (), {"mark": lambda *a: None,
                                   "planes": lambda _, a, b: kept.append(
                                       (a, b))})())
        state, _ = path.step(state, x)
        y = path.lane_planes(kept[-1])
        y_ref, st_ref = ref(blocks[k - 1] if k else None, x, k)
        scale = float(y_ref.abs().max())
        tol = CHAN_REL[path.reference]
        assert float((y.to(torch.complex128) - y_ref).abs().max()) \
            <= tol * scale
        got = path.state_dict(state)["chan"]
        for name, want in st_ref.items():
            g = torch.as_tensor(got[name])
            w = torch.as_tensor(want)
            if not w.is_floating_point() and not w.is_complex():
                assert torch.equal(g.to(torch.int64), w.to(torch.int64)), name
            else:
                err = float((g.to(torch.complex128) - w).abs().max())
                assert err <= tol * max(float(w.abs().max()), 1e-30), name


def channel_lanes(modulation: str, lanes: int, n: int, seed: int):
    """``lanes`` lanes of a synthesized channel at 25 kS/s with a little
    noise, each from another start: [lanes, n] complex64."""
    from benchmark.reference import modulators as m
    rng = np.random.default_rng(seed)
    dib = rng.integers(0, 4, n // 4 + 64)
    mod = m.c4fm_modulate if modulation == "c4fm" else m.cqpsk_modulate
    bb = mod(dib, fs=25000.0)
    rows = [bb[i * 7:i * 7 + n] for i in range(lanes)]
    noise = (rng.standard_normal((lanes, n))
             + 1j * rng.standard_normal((lanes, n))) * 0.01
    return torch.as_tensor((np.stack(rows) + noise).astype(np.complex64))


def test_fsk4_follows_program_decisions():
    from radiocapture_tpu_torch.demod.track_kernel import (TrackParams,
                                                          track_plain)
    from radiocapture_tpu_torch.demod import fsk4 as pf
    from radiocapture_tpu_torch.ops import fm
    c, path = program_path("p25_c4fm.rtl_2m4")
    prm = rfsk.Params(c.cfg, path.channel_fs)
    assert np.array_equal(prm.farrow, pf._FARROW)
    lanes, n = 16, 400
    y = channel_lanes("c4fm", lanes, n, 3)
    tp = TrackParams(gain=prm.gain, sym_taps=prm.sym_taps,
                     sym_decim=prm.sym_decim, track_fs=prm.track_fs,
                     symbol_rate=c.cfg["symbol_rate"],
                     levels=tuple(c.cfg["levels"]))
    sc = (1, lanes)
    planes = y.T[None]
    out = track_plain(planes.real.contiguous(), planes.imag.contiguous(),
                      fm.quad_demod_init(sc, "cpu"),
                      torch.zeros(sc + (len(prm.sym_taps) - 1,)),
                      pf.fsk4_init(sc, "cpu"), tp)
    syms, valid, dib = out[3][0], out[4][0].bool(), out[5][0]
    st, y_ref, _, vgap = rfsk.track(
        y, rfsk.init(lanes, prm, "cpu"), prm,
        (valid, rfsk.forced_levels(syms, prm)))
    assert float(vgap.max()) <= 1e-5
    assert float(rfsk.lane_gaps(syms, y_ref).max()) <= 1e-3
    assert float(rfsk.dibit_gaps(dib, y_ref).max()) <= 1e-5
    assert float((st["fsk4.clock"] - out[2].clock[0]).abs().max()) <= 1e-4


def test_cqpsk_follows_program_decisions():
    from radiocapture_tpu_torch.demod.cqpsk_kernel import track_cqpsk_plain
    from radiocapture_tpu_torch.demod import cqpsk as pc
    c, path = program_path("p25_lsm_split2.rtl_2m4")
    prm = rcq.Params(c.cfg, path.channel_fs)
    lanes, n = 16, 300
    y = channel_lanes("cqpsk", lanes, n, 4)
    planes = y.T[None]
    scale = pc.agc_scale(planes.real, planes.imag, 1)
    st0 = pc.cqpsk_init(path.channel_fs, c.cfg["symbol_rate"], (1, lanes))
    st, syms, valid, dib = track_cqpsk_plain(
        planes.real.contiguous(), planes.imag.contiguous(), scale, st0,
        path.channel_fs, c.cfg["symbol_rate"])
    syms, valid, dib = syms[0], valid[0].bool(), dib[0]
    new, y_ref, _, vgap = rcq.track(y, rcq.init(lanes, prm, "cpu"), prm,
                                   (valid, syms))
    assert float(vgap.max()) <= 1e-4
    assert float(rcq.lane_gaps(syms, y_ref).max()) <= 1e-3
    assert float(rcq.dibit_gaps(dib, y_ref, syms).max()) <= 1e-4
    assert float((new["omega"] - st.omega[0]).abs().max()) <= 1e-4
