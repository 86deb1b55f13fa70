"""Whole runs of each cell on the CPU at a tiny size, the harness's look
for a card skipped: a sound run is correct; a run whose timed path is
broken underneath, and the control, are not."""

import time

import pytest
import torch

from benchmark.control import control_run
from benchmark.core import judge
from benchmark.core.harness import run_cell
from benchmark.tests.tiny import WORKLOADS, cell

CPU = torch.device("cpu")


def run(workload, wrap=None, trace=False, seed=20240611):
    return run_cell(cell(workload), seed, 0.3, trace, CPU,
                    time.perf_counter(), log=lambda *a: None,
                    wrap_step=wrap)


def state_unchanged(path, step):
    """A step that returns the state it was given."""
    def broken(state, x):
        _, outs = step(state, x)
        return state, outs
    return broken


def half_batch(path, step):
    """A step that leaves the second half of the sources out."""
    def broken(state, x):
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return step(state, x)
    return broken


def altered_answer(path, step):
    """A step whose dibits are altered where they are produced: one
    sample of every lane set to the level farthest from its symbol."""
    def broken(state, x):
        state, (syms, valid, dibits) = step(state, x)
        dibits = dibits.clone()
        m = syms.shape[-1] // 3
        dibits[..., m] = torch.where(syms[..., m] > 0, 3, 1).to(dibits.dtype)
        return state, (syms, valid, dibits)
    return broken


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res = run(workload, trace=workload.endswith("rtl_2m4"))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == set(judge.NUMBERS)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_step_is_not_correct(workload, fault):
    res = run(workload, wrap=fault)
    assert not res["correct"]
    assert res["failed"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    c = cell(workload)
    per_block = control_run(c, 7, CPU, blocks=4)
    worst, failed, ok = judge.verdict(per_block, c.limits)
    assert not ok and failed > 0
