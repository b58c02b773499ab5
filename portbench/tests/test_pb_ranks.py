"""A cell on four ranks through ``run_cell``: ``tiny_dist`` (``tiny.py``:
4 gloo ranks on the CPU, the distributed sampled engine, hardware_efficient
L=4 at 8 qubits, two-stage shots) comes out correct, and not correct under
every fault its driver declares, planted in every rank; its device memory
is the fullest device's; a rank that raises ends the run within 60 s with
its traceback and no result."""

import json
import subprocess
import sys
import time

import pytest

from portbench.drivers import distributed_sampled_ksd
from portbench.tests import tiny


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("pb"))


def test_a_sound_run_on_four_ranks_is_correct(copy):
    res = tiny.run(copy, "tiny_dist")
    assert res["correct"], res["checks"]
    assert res["numbers"]["shots_mismatch"] <= res["checks"]["shots_mismatch"]["limit"]
    dev = res["device"]
    assert dev["count"] == 4 and len(dev["memory_peak_bytes_per_device"]) == 4
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_per_device"])
    assert res["attempted"] >= 1 and "epochs_per_s.host_bound" in res["metrics"]


@pytest.mark.parametrize("fault", distributed_sampled_ksd.FAULTS)
def test_a_fault_planted_in_every_rank_is_not_correct(copy, fault):
    res = tiny.run(copy, "tiny_dist", faults=(fault,))
    assert not res["correct"], (fault, res["checks"])


RAISING = '''
import sys, time
import torch.distributed as dist
from portbench.drivers.distributed_sampled_ksd import DistributedSampledKSD


class Raising(DistributedSampledKSD):
    calls = 0

    def train(self, epochs):
        self.calls += 1
        if self.calls == 3 and dist.get_rank() == 3:   # rank 3's window
            print(f"raised at {time.time()!r}", file=sys.stderr, flush=True)
            raise RuntimeError("rank 3 fails in its window")
        return super().train(epochs)


DRIVER = Raising
'''

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
import portbench.harness as harness
if __name__ == "__main__":
    spec = harness.find_cell("tiny_raise", root=__import__("pathlib").Path({pb!r}))
    res = harness.run_cell(spec, 11, 0.3, False, time.perf_counter(), device="cpu",
                           require_chip=False, log=lambda *a: None)
    print(json.dumps({{"correct": res["correct"]}}))
"""


def test_a_rank_that_raises_ends_the_run(tmp_path):
    pb = tiny.make_copy(tmp_path)
    (pb / "drivers" / "raising_ksd.py").write_text(RAISING)
    cfg = json.loads((pb / "configs" / "sampled_he4_dist.json").read_text())
    cfg.update(name="raising", driver="raising_ksd")
    (pb / "configs" / "raising.json").write_text(json.dumps(cfg))
    (pb / "limits" / "tiny_raise.json").write_text((pb / "limits" / "tiny_dist.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "raising", "source": "test", "reduced": [], "why": "test",
                             "file": "portbench/configs/raising.json"})
    bench["workloads"].append({"name": "tiny_raise", "config": "raising", "traffic": "tiny_dist",
                               "chips": 4, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = tmp_path / "raise_run.py"
    script.write_text(SCRIPT.format(root=str(tmp_path), repo=str(tiny.SRC.parent), pb=str(pb)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    ended = time.time()
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout)
    assert "RuntimeError: rank 3 fails in its window" in out.stderr, out.stderr[-3000:]
    raised = float(out.stderr.split("raised at ", 1)[1].split()[0])
    assert ended - raised <= 60.0, ended - raised
