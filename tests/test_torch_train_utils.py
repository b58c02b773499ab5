"""The port's checkpoint and profiling hooks (``train/``), after the JAX
package's tests/test_train_utils.py, with the port's ``make_optimizer`` in
place of optax, plus what is the port's own: the checks of ``load_checkpoint``
against a target, and the ``torch.profiler`` trace on the CPU."""

import json
import os

import pytest
import torch

from tensornetworks_tpu_torch.engines.common import make_optimizer
from tensornetworks_tpu_torch.train import (StepTimer, debug_nans, load_checkpoint,
                                            profile_trace, save_checkpoint, training_bundle)


def test_checkpoint_roundtrip(tmp_path):
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.ones(3, dtype=torch.float32)}
    bundle = training_bundle(params, best_tvd=torch.tensor(0.01), epoch=torch.tensor(42))
    path = str(tmp_path / "ckpt")
    assert save_checkpoint(path, bundle) == os.path.abspath(path)
    assert not os.path.exists(path + ".tmp")
    restored = load_checkpoint(path, target=bundle)
    assert torch.equal(restored["params"]["w"], params["w"])
    assert float(restored["best_tvd"]) == float(torch.tensor(0.01))
    assert int(restored["epoch"]) == 42
    assert set(training_bundle(1, 2, 3, 4, 5)) == {"params", "opt_state", "best_params",
                                                   "best_tvd", "epoch"}


def test_checkpoint_resume_training(tmp_path):
    """Saved mid-training and restored, training continues exactly as it
    would have."""
    opt = make_optimizer("adam", 1e-2, 10, use_lr_scheduler=False, gradient_clip_norm=None)
    params = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    state = opt.init(params)

    def step(p, s):
        return opt.update(2.0 * p, s, p)  # the gradient of sum(p²)

    for _ in range(3):
        params, state = step(params, state)
    path = str(tmp_path / "resume")
    save_checkpoint(path, training_bundle(params, opt_state=state))
    p2, s2 = params, state
    for _ in range(2):
        p2, s2 = step(p2, s2)
    restored = load_checkpoint(path, target=training_bundle(params, opt_state=state))
    p3, s3 = restored["params"], restored["opt_state"]
    for _ in range(2):
        p3, s3 = step(p3, s3)
    assert torch.equal(p3, p2) and int(s3["count"]) == 5


def test_load_checkpoint_checks_the_target(tmp_path):
    path = str(tmp_path / "c")
    save_checkpoint(path, {"a": torch.zeros(3), "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match="keys"):
        load_checkpoint(path, target={"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="float64"):
        load_checkpoint(path, target={"a": torch.zeros(3, dtype=torch.float64),
                                      "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match=r"\(4,\)"):
        load_checkpoint(path, target={"a": torch.zeros(4), "b": [torch.ones(2)]})


def test_debug_nans_context():
    assert not torch.is_anomaly_enabled()
    with debug_nans(True):
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()
    assert not torch.is_anomaly_enabled()
    with debug_nans(False):
        assert not torch.is_anomaly_enabled()


def test_step_timer():
    t = StepTimer()
    with t:
        sum(range(1000))
    assert t.mean >= 0
    assert len(t.times) == 1


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None):
        pass
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
