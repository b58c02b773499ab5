"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port."""

import ast
import os
import shutil
import json
import subprocess
import sys
from pathlib import Path

from portbench.tests import tiny

PB = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import portbench.harness as harness
import portbench.reference.check, portbench.trace, portbench.faults, portbench.control
spec = harness.find_cell("tiny_exact", root=__import__("pathlib").Path({pb!r}))
refused = False
try:
    harness.run_cell(spec, 5, 0.2, False, time.perf_counter(), device="cpu")
except harness.ChipMissing:
    refused = True
result = harness.run_cell(spec, 5, 0.2, True, time.perf_counter(), device="cpu",
                          require_chip=False, log=lambda *a: None)
print(json.dumps({{"refused": refused, "correct": result["correct"],
                  "loaded": sorted({{m.split(".", 1)[0] for m in sys.modules}})}}))
"""


def test_a_cell_loads_no_jax(tmp_path):
    pb = tiny.make_copy(tmp_path)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(tmp_path), repo=str(PB.parent),
                                                          pb=str(pb))],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    import torch

    assert res["refused"] != torch.cuda.is_available()
    assert "tensornetworks_tpu_torch" in res["loaded"]
    for name in ("jax", "jaxlib", "flax", "tensornetworks_tpu"):
        assert name not in res["loaded"], name


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((PB / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".", 1)[0]
            assert top not in ("tensornetworks_tpu_torch", "tensornetworks_tpu", "jax",
                               "jaxlib", "flax", "portbench"), (f.name, name)
    out = subprocess.run([sys.executable, "-c",
                          "import sys; import portbench.reference.check; "
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         capture_output=True, text=True, timeout=300, cwd=PB.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "tensornetworks_tpu_torch" not in out.stdout


def test_the_entry_point_prints_no_result_without_a_chip_or_without_the_port(tmp_path):
    import torch

    if torch.cuda.is_available():
        return
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "exact_bn8.n24", "--seed",
           str(2**33 + 1), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=PB.parent)
    assert out.returncode == 3 and out.stdout == "", out.stderr[-2000:]
    # A directory with only BENCHMARK.json and the benchmark's files.
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(PB.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == "", out.stderr[-2000:]
