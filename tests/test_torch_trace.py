"""The port's tracer (``radiocapture_tpu_torch/utils/trace.py``) on the
CPU: spans of the pipeline steps off, on by ``enable()`` and on under
``torch.profiler``; their nesting, roots and self time; the bound on the
records; the launch counter of ``kernels.launch``; and the benchmark's
three metrics that read the tracer, on whole tiny CPU runs."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.tests.tiny import WORKLOADS, cell
from radiocapture_tpu_torch import kernels
from radiocapture_tpu_torch.frontend.pipeline import (AnalogVoicePipeline,
                                                      ControlPipeline,
                                                      CqpskControlPipeline,
                                                      SpectrumSplit2,
                                                      split2_sources)
from radiocapture_tpu_torch.utils import trace

torch.set_num_threads(1)   # six test workers share the machine

ROOT = Path(__file__).resolve().parent.parent
RATE = 2.4e6
CPU = torch.device("cpu")
STEP_SPANS = ("pipeline.step", "channelize", "demod")
# the tiny runs' cells: tiny.py's, and the cells of the analog voice
# deployment and of the RTL-SDR pfb site
CELLS = WORKLOADS + ("analog_voice.rtl_2m4", "p25_c4fm.rtl_2m4_pfb")


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def c4fm_step():
    """One CPU step of a 2-slot P25 C4FM pipeline on one source."""
    pipe = ControlPipeline.p25_c4fm(num_slots=2, samp_rate=RATE)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (1, pipe.block_multiple * 4, 2)).astype(np.float32))
    offs = torch.tensor([[-0.01, 0.02]])
    pipe.step(pipe.init(1, CPU), x, offs)


def voice_step():
    """One CPU step of a 2-slot analog voice pipeline on one source."""
    pipe = AnalogVoicePipeline(num_slots=2, samp_rate=RATE)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (1, pipe.block_multiple * 4, 2)).astype(np.float32))
    offs = torch.tensor([[-0.01, 0.02]])
    pipe.step(pipe.init(1, CPU), x, offs)


def split2_cqpsk_step():
    """One CPU block through ``SpectrumSplit2`` then a 2-slot
    ``CqpskControlPipeline`` on the two halves."""
    split = SpectrumSplit2(RATE)
    pipe = CqpskControlPipeline.p25_cqpsk(num_slots=2, samp_rate=RATE / 2)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (1, 2 * pipe.block_multiple * 4, 2)).astype(np.float32))
    s2, halves = split.step(split.init(1, CPU), x)
    offs = torch.tensor([[-0.01, 0.02]] * 2)
    pipe.step(pipe.init(2, CPU), split2_sources(halves), offs)


def records(name):
    return [r for r in trace._records if r.name == name]


def test_off_records_no_span_and_still_counts():
    assert trace.span("pipeline.step") is trace.span("demod")
    before = trace.counter("launch.fsk_track")
    c4fm_step()
    split2_cqpsk_step()
    trace.count("launch.fsk_track")
    trace.count("launch.fsk_track", 2)
    s = trace.summary()
    assert s["spans"] == {} and s["roots"] == {}
    assert trace.counter("launch.fsk_track") == before + 3
    assert s["counters"]["setup.design_s"] > 0.0
    assert s["counters"]["setup.plans_s"] > 0.0
    trace.reset("launch.")
    assert trace.counter("launch.fsk_track") == 0
    assert "setup.design_s" in trace.summary()["counters"]


def nested_step_spans():
    """The one recorded request: ``pipeline.step`` around ``channelize``
    then ``demod``."""
    (step,) = records("pipeline.step")
    (chan,) = records("channelize")
    (demod,) = records("demod")
    assert step.parent is None and step.root == step.id
    for child in (chan, demod):
        assert child.parent == step.id and child.root == step.id
        assert step.t0 <= child.t0 <= child.t1 <= step.t1
    assert chan.t1 <= demod.t0


def test_enabled_c4fm_step_nests_its_spans():
    trace.enable()
    c4fm_step()
    nested_step_spans()
    s = trace.summary()
    assert s["roots"] == {"pipeline.step": 1}
    assert {n: v["n"] for n, v in s["spans"].items()} == dict.fromkeys(
        STEP_SPANS, 1)
    spans = s["spans"]
    children_s = spans["channelize"]["host_s"] + spans["demod"]["host_s"]
    assert spans["pipeline.step"]["self_host_s"] == pytest.approx(
        spans["pipeline.step"]["host_s"] - children_s, abs=1e-9)
    assert spans["demod"]["self_host_s"] == pytest.approx(
        spans["demod"]["host_s"], abs=1e-9)
    assert all(v["device_s"] is None for v in spans.values())


def test_enabled_voice_step_nests_its_spans():
    trace.enable()
    voice_step()
    nested_step_spans()
    s = trace.summary()
    assert s["roots"] == {"pipeline.step": 1}
    assert {n: v["n"] for n, v in s["spans"].items()} == dict.fromkeys(
        STEP_SPANS, 1)
    assert all(v["device_s"] is None for v in s["spans"].values())


def test_enabled_split2_and_cqpsk_are_two_requests():
    trace.enable()
    split2_cqpsk_step()
    (split,) = records("split2.step")
    (step,) = records("pipeline.step")
    assert split.parent is None and step.parent is None
    assert split.root != step.root
    for name in ("channelize", "demod"):
        (r,) = records(name)
        assert r.parent == step.id and r.root == step.id
        assert r.root_name == "pipeline.step"
    s = trace.summary()
    assert s["roots"] == {"split2.step": 1, "pipeline.step": 1}
    assert set(trace.summary("split2.step")["spans"]) == {"split2.step"}
    assert set(trace.summary("pipeline.step")["spans"]) == set(STEP_SPANS)
    trace.enable(False)
    c4fm_step()
    assert trace.summary()["roots"] == {"split2.step": 1, "pipeline.step": 1}


def test_profiler_turns_the_tracer_on_as_host_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c4fm_step()
    assert trace.summary()["roots"] == {"pipeline.step": 1}
    c4fm_step()
    assert trace.summary()["roots"] == {"pipeline.step": 1}
    found = {e.name: e for e in prof.events() if e.name in STEP_SPANS}
    assert set(found) == set(STEP_SPANS)
    for e in found.values():
        assert e.is_user_annotation is False
        assert e.device_type == torch.autograd.DeviceType.CPU
    assert (found["pipeline.step"].time_range.start
            <= found["channelize"].time_range.start
            <= found["demod"].time_range.end
            <= found["pipeline.step"].time_range.end)


def test_records_stay_bounded_and_drop_cut_requests():
    trace.enable()
    n = trace.RECORDS // 3 + 1         # 3 spans a request: 2 past the bound
    for _ in range(n):
        with trace.span("req"):
            with trace.span("a"):
                pass
            with trace.span("b"):
                pass
    assert len(trace._records) == trace.RECORDS
    # the first request lost both children: it is left out whole
    assert trace._records[0].name == "req"
    s = trace.summary()
    assert s["roots"] == {"req": n - 1}
    assert {k: v["n"] for k, v in s["spans"].items()} == {
        "req": n - 1, "a": n - 1, "b": n - 1}


class FakeEvent:
    """A timing event the device has always passed, 1 ms after the last."""

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 1.0


def test_one_request_in_device_every_is_timed_on_the_device(monkeypatch):
    made = []

    def event(stream):
        ev = (trace._free.get(stream.device_index) or [FakeEvent()]).pop()
        made.append(ev)
        return ev

    monkeypatch.setattr(trace, "_event", event)
    monkeypatch.setattr(trace, "_free", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(device_index=0))
    trace.enable()
    n = 2 * trace.DEVICE_EVERY + 1
    for _ in range(n):
        with trace.span("req", cuda=True):
            with trace.span("kernel.k", cuda=True):
                pass
        with trace.span("host", cuda=False):
            pass
    s = trace.summary()
    timed = -(-n // trace.DEVICE_EVERY)
    assert s["roots"] == {"req": n, "host": n}
    for name in ("req", "kernel.k"):
        assert s["spans"][name]["n"] == n
        assert s["spans"][name]["device_n"] == timed
        assert s["spans"][name]["device_s"] == pytest.approx(timed * 1e-3)
    assert s["spans"]["host"]["device_n"] == 0
    assert s["spans"]["host"]["device_s"] is None
    assert trace.requests("req") == [{"req": 1e-3, "kernel.k": 1e-3}] * timed
    assert trace.requests("host") == []
    # each timed request's four events went back for the next one
    assert len(made) == 4 * timed and len({id(e) for e in made}) == 4


class FakeLibrary:
    """A kernel library whose ``agc`` entry returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def agc_launch(self, *args):
        self.calls.append(args)
        return self.err

    def rc_error_string(self, err):
        return b"fake error"


def test_launch_counts_the_launches_that_succeed(monkeypatch):
    lib = FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    kernels.launch("agc", 1, 2, 3)
    assert lib.calls == [(1, 2, 3)]
    assert trace.counter("launch.agc") == 1
    lib.err = 700
    with pytest.raises(RuntimeError, match="agc launch failed"):
        kernels.launch("agc", 4)
    assert trace.counter("launch.agc") == 1
    assert trace.summary()["spans"] == {}


def test_glue_metric_takes_each_roots_least_timed_request(monkeypatch):
    timed = {
        "pipeline.step": [
            {"pipeline.step": 3.0e-3, "channelize": 2.0e-3,
             "kernel.a": 1.0e-3, "kernel.b": 1.0e-3},
            {"pipeline.step": 2.5e-3, "channelize": 2.0e-3,
             "kernel.a": 1.0e-3, "kernel.b": 1.0e-3},
            {"pipeline.step": 2.9e-3, "channelize": 2.0e-3,
             "kernel.a": 1.0e-3, "kernel.b": 1.0e-3}],
        "split2.step": [{"split2.step": 2.0e-3, "kernel.c": 1.75e-3}]}
    roots = {"pipeline.step": 3, "split2.step": 1}
    monkeypatch.setattr(trace, "summary", lambda root=None: {
        "spans": {}, "roots": roots, "counters": {}})
    monkeypatch.setattr(trace, "requests", lambda root: timed.get(root, []))
    metric = cell(WORKLOADS[1]).metric_module("pipeline.glue_ms")
    assert metric.read({}) == pytest.approx(0.5 + 0.25)
    del roots["split2.step"]
    assert metric.read({}) == pytest.approx(0.5)
    timed["pipeline.step"] = []            # steps, none timed on the device
    assert metric.read({}) is None


# the tiny runs go in a process of their own: the benchmark's import fence
# refuses the JAX that tests/conftest.py loads. Their window is 2 s: a
# window that closes before the first block's step returns keeps no window
# pair, and a run judged on its start pair alone reads incorrect; a tiny
# LSM step takes 0.14 s alone and over 0.3 s on a loaded machine
TINY_RUNS = """
import json, sys, time
import torch
torch.set_num_threads(1)
from benchmark.core.harness import run_cell
from benchmark.tests.tiny import cell
from radiocapture_tpu_torch.utils import trace
out = {}
for w in sys.argv[1:]:
    trace.reset()
    res = run_cell(cell(w), 2 ** 31 + 17, 2.0, True, torch.device("cpu"),
                   time.perf_counter(), log=lambda *a: None)
    out[w] = {"correct": res["correct"],
              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
              "summary": trace.summary()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tiny_runs():
    done = subprocess.run([sys.executable, "-c", TINY_RUNS, *CELLS],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, check=True)
    return json.loads(done.stdout.splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_metrics_read_the_tracer_on_a_tiny_cpu_run(tiny_runs, workload):
    run = tiny_runs[workload]
    assert run["correct"]
    metrics = run["metrics"]
    assert metrics["pipeline.launches"] == 0.0    # the plain path on CPU
    assert 0.0 < metrics["setup.program_s"] < 5.0
    assert "pipeline.glue_ms" not in metrics       # no device time here
    s = run["summary"]
    assert s["roots"]["pipeline.step"] == cell(workload).traffic[
        "trace_blocks"]
    assert all(v["device_s"] is None for v in s["spans"].values())
    assert s["counters"]["setup.design_s"] > 0.0
