"""The harness's checks of the cells the analog voice deployment and the
RTL-SDR pfb site added, on the CPU at the tiny size of ``tiny.py``: a
sound run is correct; a voice step broken underneath, and each control,
are not; the voice tracker's work count at the bench shape."""

import time

import pytest
import torch

from benchmark.control import control_run
from benchmark.control_voice import control_run as voice_control_run
from benchmark.core import judge, spec, voice
from benchmark.core.harness import run_cell
from benchmark.tests.tiny import cell

torch.set_num_threads(1)   # test workers share the machine
CPU = torch.device("cpu")
VOICE = "analog_voice.rtl_2m4"
PFB = "p25_c4fm.rtl_2m4_pfb"


def run(workload, wrap=None, trace=False, seed=2 ** 31 + 29):
    return run_cell(cell(workload), seed, 0.3, trace, CPU,
                    time.perf_counter(), log=lambda *a: None,
                    wrap_step=wrap)


def audio_scaled(path, step):
    """A step whose audio is 1.001 times what it should be."""
    def broken(state, x):
        state, (audio, power) = step(state, x)
        return state, (audio * 1.001, power)
    return broken


def deemph_dropped(path, step):
    """A step that starts every block's de-emphasis from zero."""
    def broken(state, x):
        zero = type(state.deemph)(*(torch.zeros_like(t)
                                    for t in state.deemph))
        return step(state._replace(deemph=zero), x)
    return broken


def power_zeroed(path, step):
    """A step that reports the power of each source's first slot as 0."""
    def broken(state, x):
        state, (audio, power) = step(state, x)
        power = power.clone()
        power[:, 0] = 0.0
        return state, (audio, power)
    return broken


@pytest.mark.parametrize("workload", [VOICE, PFB])
def test_sound_run_is_correct(workload):
    res = run(workload, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    numbers = voice.NUMBERS if workload == VOICE else judge.NUMBERS
    assert set(res["checks"]) == set(numbers)
    assert res["metrics"]["pipeline.launches"]["value"] == 0.0   # plain


@pytest.mark.parametrize("fault", [audio_scaled, deemph_dropped,
                                   power_zeroed], ids=lambda f: f.__name__)
def test_broken_voice_step_is_not_correct(fault):
    res = run(VOICE, wrap=fault)
    assert not res["correct"]
    assert res["failed"] > 0


def test_voice_control_is_not_correct():
    c = cell(VOICE)
    worst, failed, ok = judge.verdict(voice_control_run(c, 7, CPU, 4),
                                      c.limits)
    assert not ok and failed > 0
    # the bfloat16 chain fails by each of the demodulator's numbers
    for n in ("audio_err", "noise_off", "power_err", "track_err"):
        assert worst[n] > c.limits[n]["limit"], n


def test_pfb_control_is_not_correct():
    c = cell(PFB)
    worst, failed, ok = judge.verdict(control_run(c, 7, CPU, blocks=4),
                                      c.limits)
    assert not ok and failed > 0


@pytest.mark.parametrize("workload", [VOICE, PFB])
def test_new_cells_find_their_files(workload):
    c = spec.Cell(spec.manifest(), workload)
    assert c.entry["chips"] == 1
    prog = c.path_module().Path
    for stage in prog.work.values():
        assert callable(c.work_module(stage).count)
    numbers = voice.NUMBERS if workload == VOICE else judge.NUMBERS
    assert judge.numbers(c.limits) == list(numbers)
    for n in numbers:
        lim = c.limits[n]
        assert lim["lower"] <= lim["limit"] <= lim["upper"]
        if lim["limit"] > 0:
            assert lim["lower"] < lim["limit"] < lim["upper"]


def test_fm_voice_bytes_at_the_bench_shape():
    c = spec.Cell(spec.manifest(), VOICE)
    w = c.work_module("fm_voice").count({"lanes": 128 * 64, "n_out": 2500})
    # planes 8192·2500·8 B read, audio 8192·2500·4 B written, power 8192·4
    # B, state (prev 8 B, y_last 4 B, x_last 4 B) read and written: the
    # ~246 MB that ops/fm_kernel.py states
    assert w == {"flop": {}, "bytes": 8192 * (20000 + 10000 + 4 + 32)}
    assert 245e6 < w["bytes"] < 247e6
