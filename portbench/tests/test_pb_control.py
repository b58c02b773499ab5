"""On the chip: each cell's control (the program's own lower-precision
path, ``controls/<cell>.json``) comes out not correct under the cell's
limits, and the program as configured comes out correct, at sizes a test
run holds: 20 qubits on the grid circuit kernels, 25 on the blocked
executor."""

import json
import shutil
import sys
import time

import pytest

from portbench.tests import tiny

CASES = [("exact_bn8.n24", "n24", 20, 21, {"20": 1}),
         ("sampled_he4.n24", "n24.obs2", 20, 22, {"20": 1, "21": 0}),
         ("sampled_he4.n28", "n28", 25, 26, {"25": 1})]


@pytest.mark.chip
@pytest.mark.parametrize("cell,traffic,n,num_vars,observed", CASES)
def test_control_fails_and_program_passes(cuda_device, tmp_path, cell, traffic, n, num_vars,
                                          observed):
    pb = tiny.make_copy(tmp_path)
    t = json.loads((pb / "traffic" / f"{traffic}.json").read_text())
    t.update(num_latent=n, num_vars=num_vars, observed=observed)
    (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(t))
    sys.path.insert(0, str(tmp_path))
    try:
        import portbench.harness as harness

        for variant in ("program", "control"):
            spec = harness.find_cell(cell, root=pb)
            if variant == "control":
                spec.config.update(json.loads((pb / "controls" / f"{cell}.json").read_text()))
            res = harness.run_cell(spec, 2**33 + n, 0.0, False, time.perf_counter(),
                                   log=lambda *a: None)
            assert res["correct"] == (variant == "program"), (variant, res["numbers"])
    finally:
        sys.path.remove(str(tmp_path))
        shutil.rmtree(tmp_path, ignore_errors=True)
