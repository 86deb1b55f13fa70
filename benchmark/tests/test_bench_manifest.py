"""BENCHMARK.json keeps to its contract, and every name it holds finds
its files."""

import importlib
import json
import re

import pytest

from benchmark.core import judge, spec
from benchmark.tests.tiny import WORKLOADS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = spec.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"]
                         + MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_names_unique_and_metrics_consistent():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_finds_its_files(workload):
    cell = spec.Cell(MAN, workload)
    assert cell.entry["chips"] == 1
    assert hasattr(cell.path_module(), "Path")
    for m in cell.per_layer:
        assert callable(cell.metric_module(m["name"]).read)
    prog = cell.path_module().Path
    for stage in prog.work.values():
        assert callable(cell.work_module(stage).count)
    assert spec.chan_module(prog.reference).Chan
    assert spec.demod_module(prog.demod).Params
    assert set(cell.limits) == set(judge.NUMBERS) | {"_readings"}
    assert judge.numbers(cell.limits) == list(judge.NUMBERS)
    for n in judge.NUMBERS:
        lim = cell.limits[n]
        assert lim["lower"] <= lim["limit"] <= lim["upper"]
        if lim["limit"] > 0:
            assert lim["lower"] < lim["limit"] < lim["upper"]


def test_config_files_match_entries():
    for c in MAN["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")
        # the traffic's modulator is found by the configuration's name
        assert callable(importlib.import_module(
            f"benchmark.reference.mod_{cfg['modulation']}").modulate)


CHAN_API = ("n_lanes", "slot_hz", "channel_fs", "sizes", "__call__")
DEMOD_API = ("Params", "STATE", "CIRCLES", "init", "track", "forced",
             "gaps", "dibits", "sizes")


@pytest.mark.parametrize("py", sorted(
    [*(spec.BENCH / "reference").glob("chan_*.py"),
     *(spec.BENCH / "reference").glob("demod_*.py")]), ids=lambda p: p.stem)
def test_reference_kinds_are_found_by_name(py):
    """Every reference channelizer and demodulator file loads by its name
    alone and has the interface the judge and the control call, so a new
    kind is a new file."""
    kind, _, name = py.stem.partition("_")
    if kind == "chan":
        chan = spec.chan_module(name).Chan
        assert all(hasattr(chan, a) for a in CHAN_API)
    else:
        mod = spec.demod_module(name)
        assert all(hasattr(mod, a) for a in DEMOD_API)
        assert set(mod.CIRCLES) <= set(mod.STATE)


def test_path_kind_falls_back_to_modulation_and_frontend():
    cfg = {"modulation": "c4fm", "paths": {"xlat": "c4fm_xlat"}}
    assert spec.path_kind(cfg, "xlat") == "c4fm_xlat"
    assert spec.path_kind(cfg, "fft") == "c4fm_fft"
    assert spec.path_kind({"modulation": "fm"}, "xlat") == "fm_xlat"
