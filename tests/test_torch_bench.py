"""``bench_torch.py``, the port's benchmark: it refuses to run without a
card, runs bench.py's quality schedule, and its quality path (run here at 4 qubits on the
CPU, through the same engine calls it makes on the card at 16) keeps the
best TVD over its phases. Its numbers come only from the card."""

import ast
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("bench_torch", ROOT / "bench_torch.py")
bench = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(bench)


def test_bench_needs_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "no CUDA device" in out


def test_quality_schedule_is_bench_py_s():
    """The quality path's phases and settings are those of ``bench.py``'s
    ``measure_quality_path`` (read from its source, which imports JAX)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(f for f in tree.body
              if isinstance(f, ast.FunctionDef) and f.name == "measure_quality_path")
    phases = next(ast.literal_eval(a.value) for a in ast.walk(fn) if isinstance(a, ast.Assign)
                  and [t.id for t in a.targets if isinstance(t, ast.Name)] == ["phases"])
    assert bench.QUALITY_PHASES == phases
    src = ast.unparse(fn)
    assert f"qbm_ansatz_layers={bench.QUALITY_LAYERS}" in src
    assert f"base_kernel_length_scale={bench.QUALITY_LENGTH_SCALE}" in src
    assert f"chunk_epochs={bench.QUALITY_CHUNK}" in src
    with pytest.raises(SystemExit):
        bench.main(["--phases", "48000:0.05"])


def test_quality_path_keeps_the_best_tvd_over_phases(monkeypatch):
    monkeypatch.setattr(bench, "N_QUBITS", 4)
    monkeypatch.setattr(bench, "QUALITY_CHUNK", 5)
    out = bench.measure_quality_path("cpu", [(15, 0.05), (10, 0.005)])
    assert out["backend"] == "circuit2d" and out["ansatz"] == "bn_structured"
    assert out["epochs"] == 25 and len(out["phases"]) == 2
    assert out["final_tvd"] == min(p["best_tvd"] for p in out["phases"])
    assert out["epochs_per_sec"] == out["phases"][0]["epochs_per_sec"]
    assert all(p["skipped"] == 0 for p in out["phases"])
