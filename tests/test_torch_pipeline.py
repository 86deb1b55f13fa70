"""Port parity, the whole slice: ``ControlPipeline.step`` of the port
against the JAX pipeline (vmapped over sources, as the production loop
runs it) on the same wire blocks and offsets, blocks in a row, with a
mid-stream hand-off of the JAX state through ``convert.state_from_jax``.
Plus: the package never loads jax, and only unknown frontends refuse."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiocapture_tpu.frontend.pipeline import ControlPipeline as JPipe
from radiocapture_tpu_torch import convert
from radiocapture_tpu_torch.demod import fsk4 as TK
from radiocapture_tpu_torch.demod.engines import (EdacsControlEngine,
                                                  MotoControlEngine)
from radiocapture_tpu_torch.demod.framer import Framer
from radiocapture_tpu_torch.device import wire_from_numpy
from radiocapture_tpu_torch.entry import entry
from radiocapture_tpu_torch.frontend.pipeline import ControlPipeline
from radiocapture_tpu_torch.protocol import p25 as P
from radiocapture_tpu_torch.testing import modulators as M
from test_c4fm_chain import _make_control_stream
from test_torch_fsk4 import _edacs_bits, _moto_bits

torch.set_num_threads(1)   # six test workers share the machine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 200e3
N_SRC, N_SLOTS, SIG_SLOT = 2, 4, 1
OFFSET_HZ = 50e3
# Noise lanes: bank sums taken in another order move the discriminator by
# ~2e-6 (median), but where a noise sample sits at the ±π branch cut of
# atan2 the two sides land on opposite sides of it (measured: up to 0.48
# after the boxcar on this fixture), and the tracking loop feeds that
# back into its timing. The emit masks must still agree on ≥ 95% of all
# samples (measured 97.8% on the P25 case).
NOISE_VALID_AGREE = 0.95
# The fixture lane also carries the noise before and after the burst,
# where the same drift shows: symbols within 1% of the decision margin
# (1.0, half a level spacing); the decisions themselves are identical.
SIG_SYM_ATOL = 1e-2


def _fixture(kind):
    """(pipeline constructors, channel-rate IQ) for one class."""
    if kind == "p25":
        dib, _ = _make_control_stream(4)
        return "p25_c4fm", M.c4fm_modulate(dib, fs=25000.0)
    if kind == "edacs":
        return "edacs", M.fsk2_modulate(_edacs_bits(), 25000.0,
                                        baud=9600.0, dev_hz=3000.0)
    if kind == "moto":
        return "moto", M.fsk2_modulate(_moto_bits(), 25000.0, baud=3600.0,
                                       dev_hz=4000.0)
    return None, np.zeros(5400, np.complex64)


def _pipes(kind, fs=FS, frontend="xlat"):
    ctor, chan = _fixture(kind)
    if ctor is None:       # the 6000 Bd C4FM-TDMA class (runtime.py:341)
        args = (N_SLOTS, fs, 12500.0, 6000.0, (-3.0, -1.0, 1.0, 3.0), 600.0)
        return (JPipe(*args, frontend=frontend),
                ControlPipeline(*args, frontend=frontend), chan)
    return (getattr(JPipe, ctor)(N_SLOTS, fs, frontend=frontend),
            getattr(ControlPipeline, ctor)(N_SLOTS, fs, frontend=frontend),
            chan)


def _wideband(chan, n_blocks, block, fs=FS):
    up = M.upsample_to(chan, 25000.0, fs)
    n = n_blocks * block
    src0 = M.multi_channel(fs, [(OFFSET_HZ, up)], n)
    src1 = M.multi_channel(fs, [], n, noise_floor_db=-10.0,
                           rng=np.random.default_rng(3))
    return np.stack([np.stack([s.real, s.imag], -1) for s in (src0, src1)]
                    ).astype(np.float32)            # [S, n, 2]


def _decode(kind, syms, valid):
    bits = syms[valid.astype(bool)]
    if kind == "p25":
        return [(t["Channel"], t["Group Address"], t["Source Address"])
                for fb in Framer().feed(TK.slice_dibits(bits))
                for t in P.parse_frame(fb).tsbks
                if t.get("crc") == 0 and t["name"] == "GRP_V_CH_GRANT"]
    got = []
    if kind == "edacs":
        eng = EdacsControlEngine(channels={3: 851e6, 4: 852e6},
                                 on_event=got.append)
    else:
        eng = MotoControlEngine(channels={0x00A: 853.1e6},
                                system_id=0x7000, on_event=got.append)
    eng.feed_bits((bits > 0).astype(np.uint8))
    return [(e["type"], e.get("group"), e.get("user_local")) for e in got]


@pytest.mark.parametrize("kind", ["p25", "edacs", "moto", "c4fm_tdma"])
def test_control_pipeline_matches_jax(kind):
    check_control_pipeline(kind)


def check_control_pipeline(kind, fs=FS, frontend="xlat", fsk4_block=0):
    """The port's ``ControlPipeline.step`` against the JAX pipeline with
    the same ``frontend_mode`` and ``fsk4_block`` at ``fs``: blocks of
    1000 tracked samples, rounded up to the bank's block multiple, the
    JAX state handed over after the first."""
    jp, tp, chan = _pipes(kind, fs, frontend)
    jp.fsk4_block = tp.fsk4_block = fsk4_block
    assert (tp.decim, tp.block_multiple) == (jp.decim, jp.block_multiple)
    bm = tp.block_multiple
    block = -(-(tp.decim * tp.sym_decim * 1000) // bm) * bm
    n_blocks = -(-len(chan) * round(fs / 25000.0) // block) + 1
    x = _wideband(chan, n_blocks, block, fs)
    offs = np.zeros((N_SRC, N_SLOTS), np.float32)
    offs[:, SIG_SLOT] = OFFSET_HZ / fs
    offs[:, 2] = -0.3
    offs[:, 3] = 0.11
    jstep = jax.jit(jax.vmap(jp._step_impl))
    jst = jax.tree.map(lambda a: jnp.broadcast_to(a, (N_SRC,) + a.shape),
                       jp.init())
    tst = tp.init(N_SRC, "cpu")
    toffs = torch.from_numpy(offs)
    outs = {"jax": [], "torch": []}
    for b in range(n_blocks):
        xb = x[:, b * block:(b + 1) * block]
        if b == 1:     # hand the JAX stream state over mid-stream
            arrays = jax.tree.map(np.asarray, jst)
            tst = convert.state_from_jax(tp, arrays, "cpu")
            back = convert.state_to_jax(tp, tst)
            for a, w in zip(jax.tree.leaves(tuple(back)),
                            jax.tree.leaves(arrays)):
                np.testing.assert_array_equal(a, w)
        jst, jo = jstep(jst, jnp.asarray(xb), jnp.asarray(offs))
        tst, to = tp.step(tst, wire_from_numpy(xb, "cpu"), toffs)
        outs["jax"].append([np.asarray(o) for o in jo])
        outs["torch"].append([o.numpy() for o in to])
    j = [np.concatenate([o[i] for o in outs["jax"]], -1) for i in range(3)]
    t = [np.concatenate([o[i] for o in outs["torch"]], -1) for i in range(3)]
    m = block // (tp.decim * tp.sym_decim)
    assert t[0].shape == (N_SRC, N_SLOTS, n_blocks * m)
    for a, w in zip(t, j):
        assert a.dtype == w.dtype
    # the fixture lane: identical decisions, symbols within SIG_SYM_ATOL.
    # A fft block is a whole FFT window (2033 tracked samples at 200 kHz),
    # so after the burst the lane carries a long near-silent tail where
    # the loop runs on rounding noise and drifts as the noise lanes do:
    # there the lane is held to the burst but its last millisecond.
    sig = (0, SIG_SLOT)
    if frontend == "fft":
        sig += (slice(0, (len(chan) - 25) // tp.sym_decim),)
    np.testing.assert_array_equal(t[1][sig], j[1][sig])
    np.testing.assert_array_equal(t[2][sig], j[2][sig])
    np.testing.assert_allclose(t[0][sig], j[0][sig], atol=SIG_SYM_ATOL)
    # noise lanes
    agree = np.mean(t[1] == j[1])
    assert agree >= NOISE_VALID_AGREE, agree
    if kind != "c4fm_tdma":
        got = _decode(kind, t[0][sig], t[1][sig])
        assert got == _decode(kind, j[0][sig], j[1][sig])
        assert len(got) >= 2, got


def test_fine_freq_and_freq_shift():
    tp = ControlPipeline.p25_c4fm(N_SLOTS, FS)
    st = tp.init(2, "cpu")
    st = tp.apply_freq_shift(st, np.array([[60.0], [-120.0]]))
    np.testing.assert_allclose(tp.fine_freq_hz(st)[:, 0], [60.0, -120.0],
                               rtol=1e-6)
    np.testing.assert_array_equal(
        tp.offsets_for(np.array([851.05e6]), 851e6), [np.float32(0.25)])


def test_unsupported_frontend_raises():
    """Every ``frontend_mode`` of the JAX package builds, with its bank;
    only an unknown mode raises, as does a rate the pfb bins do not
    divide (the JAX ``PfbXlatBank`` refuses it too)."""
    for fe, fs, bank in (("xlat", FS, "XlatBank"), ("fft", FS, "FftXlatBank"),
                         ("pfb", 4 * FS, "PfbXlatBank")):
        pipe = ControlPipeline.p25_c4fm(4, fs, frontend=fe)
        assert type(pipe.bank).__name__ == bank
        assert pipe.block_multiple == JPipe.p25_c4fm(
            4, fs, frontend=fe).block_multiple
    with pytest.raises(ValueError, match="unknown frontend_mode"):
        ControlPipeline.p25_c4fm(4, FS, frontend="nope")
    with pytest.raises(ValueError, match="not round enough"):
        ControlPipeline.p25_c4fm(4, FS, frontend="pfb")


def test_entry_step_shapes():
    fn, (state, x, offs) = entry("cpu")
    assert x.dtype == torch.bfloat16 and x.shape == (1, 96 * 512, 2)
    state, (syms, valid, dibits) = fn(state, x, offs)
    assert syms.shape == valid.shape == dibits.shape == (1, 64, 256)
    assert syms.dtype == torch.float32 and dibits.dtype == torch.int32
    assert bool(torch.isfinite(syms).all())


def test_port_never_imports_jax():
    """A fresh interpreter runs one CPU step of each path (the C4FM
    entry, split2 → CQPSK, one ``SiteRuntime.step``) and imports the host
    decode without loading jax, ml_dtypes or the JAX package."""
    code = ("import sys, torch\n"
            "from radiocapture_tpu_torch.entry import entry\n"
            "from radiocapture_tpu_torch.demod import (cqpsk, "
            "cqpsk_kernel, engines, framer, tdma)\n"
            "from radiocapture_tpu_torch.fec import lfsr\n"
            "from radiocapture_tpu_torch.frontend.pipeline import ("
            "CqpskControlPipeline, SpectrumSplit2, split2_sources)\n"
            "from radiocapture_tpu_torch import convert, kernels\n"
            "fn, args = entry('cpu')\n"
            "st, out = fn(*args)\n"
            "assert out[0].shape == (1, 64, 256)\n"
            "sp = SpectrumSplit2(800e3)\n"
            "pipe = CqpskControlPipeline.p25_cqpsk(2, 400e3, tdma=True)\n"
            "sst, halves = sp.step(sp.init(1, 'cpu'), "
            "torch.ones((1, 64), dtype=torch.complex64))\n"
            "_, out = pipe.step(pipe.init(2, 'cpu'), "
            "split2_sources(halves), torch.zeros((2, 2)))\n"
            "assert out[0].shape == (2, 2, 2)\n"
            "import numpy as np, tempfile\n"
            "from radiocapture_tpu_torch.runtime import SiteRuntime\n"
            "from radiocapture_tpu_torch.rxconfig import (RcConfig, "
            "SourceConfig, SystemConfig)\n"
            "cfg = RcConfig(audio_dir=tempfile.mkdtemp(), "
            "num_slots_per_source=4, block_seconds=0.01)\n"
            "cfg.sources[0] = SourceConfig(center_freq=857e6)\n"
            "cfg.systems[0] = SystemConfig(type='p25', "
            "control_channels=[857.5e6])\n"
            "rt = SiteRuntime(cfg, {0: lambda n: np.ones(n, np.complex64)}, "
            "'cpu')\n"
            "rt.step()\n"
            "rt.close()\n"
            "assert rt.blocks == 1 and rt.instances[0].slot is not None\n"
            "bad = [m for m in ('jax', 'jaxlib', 'ml_dtypes', "
            "'radiocapture_tpu') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
