"""The import fence, and what the benchmark's sources import."""

import ast
import subprocess
import sys
import types

from benchmark.core import harness, spec

BENCH = spec.BENCH


def test_fence_finds_whole_top_level_names(monkeypatch):
    assert "radiocapture_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "radiocapture_tpu.ops",
                        types.ModuleType("radiocapture_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    assert harness.forbidden_modules() == ["jax", "radiocapture_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_program():
    jax_bench = "bench" + ".py"
    for py in BENCH.rglob("*.py"):
        found = set(_imports(py))
        assert not found & set(harness.FORBIDDEN), py
        assert jax_bench not in py.read_text(), py
        if "reference" in py.parts:
            assert "radiocapture_tpu_torch" not in found, py


def test_no_card_exits_without_result():
    r = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "p25_c4fm.rtl_2m4", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=spec.ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2
    assert r.stdout.strip() == ""
