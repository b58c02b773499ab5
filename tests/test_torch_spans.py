"""The program's spans (``train.span``) on the CPU, at 6 qubits through the
circuit kernels' plain versions: absent without a profiler, present and
nested as the layers are under one, and without effect on the numbers."""

import json

import numpy as np
import pytest
import torch

from tensornetworks_tpu_torch.core import get_random_chain_network
from tensornetworks_tpu_torch.engines import (QuantumKSDVariationalInference,
                                              SampledKSDVariationalInference)
from tensornetworks_tpu_torch.ops.stein import SteinOperator, score_table
from tensornetworks_tpu_torch.runners.profile_main_path import span_table
from tensornetworks_tpu_torch.train import span

N = 6
EPOCHS = 3
ENGINE_SPANS = {"engine.epoch", "engine.loss", "engine.backward", "engine.update",
                "engine.eval", "engine.sync", "engine.posterior", "born.fold",
                "circuit.forward", "circuit.backward"}
# The spans of each engine's path at 6 qubits (the exact engine's Stein
# operator is dense there: no stein.apply).
PATH_SPANS = {"exact": ENGINE_SPANS | {"engine.build_operator", "stein.build", "stein.loss"},
              "sampled": ENGINE_SPANS | {"sampled.shots", "sampled.scores", "sampled.gram"}}


def _problem():
    bn = get_random_chain_network(N + 1, seed=3)
    latent, obs = [f"V{i}" for i in range(N)], {f"V{N}": 1}
    return bn, latent, obs, bn.posterior_vector(latent, obs)


def _train(kind, trace_path=None, **kw):
    """A fresh engine of ``kind`` trained EPOCHS epochs, under
    ``torch.profiler`` when ``trace_path`` is given (the Chrome trace is
    written there); returns the engine."""
    bn, latent, obs, post = _problem()
    if kind == "exact":
        eng = QuantumKSDVariationalInference(bn, latent, list(obs), qbm_num_latent_vars=N,
                                             qbm_ansatz_layers=2, seed=5, device="cpu")
    else:
        eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=2,
                                             num_samples=32, seed=5, device="cpu")
    assert eng.born_machine.backend == "circuit2d"

    def train():
        eng.train(obs, num_epochs=EPOCHS, lr_born_machine=0.05, verbose=False,
                  true_posterior_for_tvd=post, chunk_epochs=2, **kw)

    if trace_path is None:
        train()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            train()
        prof.export_chrome_trace(str(trace_path))
    return eng


def _annotations(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_no_profiler_no_record_function(kind, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("engine.epoch"):
        pass
    _train(kind)


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_profiled_train_exports_nested_spans(kind, tmp_path):
    _train(kind, tmp_path / "trace.json")
    spans = _annotations(tmp_path / "trace.json")
    names = [e["name"] for e in spans]
    assert PATH_SPANS[kind] <= set(names), PATH_SPANS[kind] - set(names)
    assert names.count("engine.epoch") == EPOCHS
    epochs = [e for e in spans if e["name"] == "engine.epoch"]
    losses = [e for e in spans if e["name"] == "engine.loss"]
    folds = [e for e in spans if e["name"] == "born.fold"]
    for epoch in epochs:
        (loss,) = [e for e in losses if _inside(e, epoch)]
        for name in ("born.fold", "circuit.forward"):
            assert any(e["name"] == name and _inside(e, loss) for e in spans), name
    # One span per fold: the entry points do not nest in each other.
    assert not any(a is not b and _inside(a, b) for a in folds for b in folds)


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_spans_leave_the_numbers_alone(kind, tmp_path):
    plain = _train(kind)
    traced = _train(kind, tmp_path / "trace.json")
    assert torch.equal(plain.params, traced.params)
    assert np.array_equal(plain.history_["loss_ksd"], traced.history_["loss_ksd"])


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_profile_dir_traces_the_epochs(kind, tmp_path):
    _train(kind, profile_dir=str(tmp_path))
    (path,) = tmp_path.glob("*.pt.trace.json")
    assert [e["name"] for e in _annotations(path)].count("engine.epoch") == EPOCHS


def test_stein_operator_spans():
    bn, latent, obs, _ = _problem()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        op = SteinOperator(score_table(bn.conditional_joint_table(latent, obs)), N,
                           dense=False, device="cpu")
        q = torch.full((1 << N,), 1.0 / (1 << N), requires_grad=True)
        torch.autograd.grad(op.ksd_loss(q), q)
    names = {e.name for e in prof.events()}
    assert {"stein.build", "stein.loss", "stein.apply"} <= names


def test_span_table_of_a_profile(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with span("engine.epoch"):
                with span("engine.loss"):
                    torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    table = span_table(json.loads((tmp_path / "trace.json").read_text()))
    assert set(table) == {"engine.epoch", "engine.loss"}
    assert table["engine.epoch"]["calls"] == table["engine.loss"]["calls"] == 2
    assert table["engine.epoch"]["host_ms"] >= table["engine.loss"]["host_ms"] > 0
    assert table["engine.epoch"]["launches"] == 0  # no card


def test_span_table_gives_the_backward_to_the_main_thread():
    """Kernels launched on autograd's thread: in the span open there, and
    with none open there in the main thread's innermost span; a span on that
    thread nests in the main thread's span at its start."""

    def ev(cat, name, ts, dur, tid, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
                "tid": tid, "args": args}

    def kernel(ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur, "pid": 0,
                "tid": 7, "args": {"correlation": corr}}

    trace = {"traceEvents": [
        ev("user_annotation", "engine.epoch", 0, 1000, 1),
        ev("user_annotation", "engine.loss", 10, 200, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, 1, correlation=1),
        ev("user_annotation", "engine.backward", 300, 600, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 320, 2, 2, correlation=2),
        ev("user_annotation", "circuit.backward", 400, 300, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 410, 2, 2, correlation=3),
        ev("gpu_user_annotation", "circuit.backward", 450, 400, 7),
        kernel(100, 50, 1), kernel(350, 20, 2), kernel(450, 400, 3),
    ]}
    table = span_table(trace)
    ms = {name: row["device_ms"] for name, row in table.items()}
    assert ms == pytest.approx({"engine.epoch": 0.470, "engine.loss": 0.050,
                                "engine.backward": 0.420, "circuit.backward": 0.400})
    assert table["engine.backward"]["launches"] == 2
    assert table["circuit.backward"]["calls"] == 1
