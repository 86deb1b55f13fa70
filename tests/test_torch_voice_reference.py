"""The analog voice deployment's plain reference (``benchmark/reference``:
``chan_xlat`` then ``demod_fm``, judged by ``benchmark/core/voice.py``)
against the port's ``AnalogVoicePipeline`` on the CPU, at a tiny size: 2
sources × 8 slots of the ``analog_voice.rtl_2m4`` traffic, 10 ms blocks,
two pairs of blocks carrying state. The port is within the limits the cell
states; the same chain in bfloat16 is not; the traffic's FM modulator is
seeded."""

import numpy as np
import pytest
import torch

from benchmark.core import judge, voice
from benchmark.core.traffic import make_ring
from benchmark.reference import demod_fm, mod_fm
from benchmark.tests.tiny import cell
from radiocapture_tpu_torch.ops import fm

torch.set_num_threads(1)   # six test workers share the machine

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101
DEMOD_NUMBERS = ("audio_err", "noise_off", "power_err", "track_err")


class Keep:
    """The probe's part a run needs here: the channel planes of a step."""

    def __init__(self):
        self.kept = None

    def mark(self, name):
        pass

    def planes(self, y_re, y_im):
        self.kept = (y_re, y_im)


@pytest.fixture(scope="module")
def voice_run():
    """Four blocks of the port from its initial state, kept as the harness
    keeps them: a pair from the initial state, a pair from the carried
    state after block 1."""
    c = cell("analog_voice.rtl_2m4")
    path = c.path_module().Path(c.cfg, c.traffic, CPU)
    probe = Keep()
    path.attach(probe)
    ring, sig = make_ring(c.cfg, c.traffic, SEED, CPU, path.block,
                          path.slot_hz)
    state = path.init()
    pairs = []
    for k in range(4):
        pre = None if k == 0 else path.state_dict(state)
        state, outs = path.step(state, ring[k % ring.shape[0]])
        block = {"k": k, "planes": probe.kept, "outs": outs,
                 "post": path.state_dict(state)}
        if k % 2 == 0:
            pairs.append({"pre": pre, "blocks": [block]})
        else:
            pairs[-1]["blocks"].append(block)
    return c, voice.Judge(path, ring, sig, CPU), pairs


def test_reference_constants_are_the_pipelines():
    c = cell("analog_voice.rtl_2m4")
    path = c.path_module().Path(c.cfg, c.traffic, CPU)
    prm = demod_fm.Params(c.cfg, path.channel_fs)
    assert path.channel_fs == 25000.0
    assert (prm.z1, prm.b0) == fm.deemph_coefs(path.channel_fs)
    assert prm.gain == float(np.float32(path.pipe.gain))


def test_port_is_within_the_cells_limits(voice_run):
    c, jd, pairs = voice_run
    per_block = jd.run(pairs)
    assert len(per_block) == 4
    worst, failed, ok = judge.verdict(per_block, c.limits)
    assert ok and failed == 0, worst
    assert worst["carry_err"] == 0.0 and worst["noise_off"] == 0.0


def test_bfloat16_reference_falls_outside_them(voice_run):
    """The reference's chain in bfloat16 in the port's place, on the
    port's channel samples: every demodulator number is over its limit."""
    c, jd, pairs = voice_run
    bf = []
    for p in pairs:
        state = jd.start_state(p["pre"])
        blocks = []
        for b in p["blocks"]:
            y = jd.path.lane_planes(b["planes"])
            state, audio, power = demod_fm.track(y, state, jd.prm,
                                                 dtype=torch.bfloat16)
            blocks.append({"k": b["k"], "planes": b["planes"],
                           "outs": (audio.float(), power.float()),
                           "post": {"chan": b["post"]["chan"],
                                    "demod": state}})
        bf.append({"pre": p["pre"], "blocks": blocks})
    worst, failed, ok = judge.verdict(jd.run(bf), c.limits)
    assert not ok and failed == 4
    for n in DEMOD_NUMBERS:
        assert worst[n] > c.limits[n]["limit"], (n, worst[n])


def test_fm_modulator_is_seeded():
    def draw(seed):
        rng = np.random.default_rng(seed)
        return mod_fm.modulate(rng.integers(0, 4, 800), fs=25000.0,
                               symbol_rate=8000.0)

    a, b, other = draw(SEED), draw(SEED), draw(SEED + 1)
    assert a.dtype == np.complex64 and a.shape == (2500,)
    assert np.array_equal(a, b) and not np.array_equal(a, other)
    # constant envelope; the frequency peaks at the stated deviation
    assert np.allclose(np.abs(a), 1.0, atol=1e-6)
    f = np.angle(a[1:] * np.conj(a[:-1])) * 25000.0 / (2.0 * np.pi)
    assert 0.9 * mod_fm.PEAK_DEV_HZ < np.abs(f).max() \
        <= 1.001 * mod_fm.PEAK_DEV_HZ
