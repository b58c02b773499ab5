"""Durable chunk resume and engine checkpoints of the port (ROADMAP A11),
after the JAX package's tests/test_chunked_resume.py and
tests/test_engine_checkpoint.py.

A run killed after some chunks (the fault injected as the JAX tests inject
it) and run again from its snapshot must equal an uninterrupted run bit for
bit: history, final and best parameters, best TVD and epoch. That covers
the classical engine with dropout (its generator's state is in the
snapshot), the quantum engine on the circuit2d plain path, a tempered run
resumed inside a β chunk, the adversarial engine with a classical and a
quantum Born machine, and the scale runner's lr_phases branches, where each
phase has a snapshot of its own. The early-stop break is held against the
JAX engine's uninterrupted scan, and the checkpoints' keys against the JAX
engines' checkpoints. Float64 on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensornetworks_tpu.core import get_sprinkler_network as j_sprinkler
from tensornetworks_tpu.engines import KSDVariationalInference as JKSD
from tensornetworks_tpu.engines import QuantumKSDVariationalInference as JQKSD
from tensornetworks_tpu.engines import common as jcommon
from tensornetworks_tpu.engines import ksd as jksd
from tensornetworks_tpu.ops.stein import SteinOperator as JSteinOperator
from tensornetworks_tpu.ops.stein import score_table as j_score_table
from tensornetworks_tpu.train import load_checkpoint as j_load_checkpoint
import tensornetworks_tpu_torch.engines.ksd as ksd_mod
from tensornetworks_tpu_torch.core import get_random_chain_network, get_sprinkler_network
from tensornetworks_tpu_torch.engines import (AdversarialVariationalInference,
                                              KSDVariationalInference,
                                              QuantumKSDVariationalInference)
from tensornetworks_tpu_torch.engines.common import make_optimizer
from tensornetworks_tpu_torch.models import QuantumBornMachine
from tensornetworks_tpu_torch.ops.stein import SteinOperator, score_table
from tensornetworks_tpu_torch.runners import scale as tscale
from tensornetworks_tpu_torch.train import load_checkpoint

F64 = torch.float64
SPRINKLER = (["C", "S", "R"], {"W": 1})


def _no_leftovers(path):
    assert not os.path.exists(path + ".tmp")


def _assert_same(a, b):
    """Two engines after equal runs: every history column, the final and
    best parameters, the best TVD and epoch, bit for bit."""
    ha, hb = a.history_, b.history_
    for key in ha:
        if isinstance(ha[key], list):
            np.testing.assert_array_equal(ha[key], hb[key], err_msg=key)
    assert (a.best_tvd_, a.best_epoch_) == (b.best_tvd_, b.best_epoch_)
    for name in ("params", "best_params_", "born_params", "classifier_params"):
        if hasattr(a, name):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def _killed_then_resumed(make, train, state, chunks, monkeypatch=None):
    """An engine killed after ``chunks`` chunks through the engine module's
    ``run_ksd_scan`` (or ``train``'s own ``fail_after_chunks``), then run
    again from its snapshot."""
    eng = make()
    if monkeypatch is not None:
        orig = ksd_mod.run_ksd_scan
        monkeypatch.setattr(ksd_mod, "run_ksd_scan",
                            lambda **k: orig(**k, fail_after_chunks=chunks))
        with pytest.raises(RuntimeError, match=f"fault injection: killed after {chunks} chunks"):
            train(eng, resume_state_path=state)
        monkeypatch.setattr(ksd_mod, "run_ksd_scan", orig)
    else:
        with pytest.raises(RuntimeError, match="fault injection"):
            train(eng, resume_state_path=state, fail_after_chunks=chunks)
    assert os.path.exists(state)
    _no_leftovers(state)
    train(eng, resume_state_path=state)
    assert not os.path.exists(state)  # removed on success
    _no_leftovers(state)
    return eng


def _toy_run(chunk_epochs, **overrides):
    """``run_ksd_scan`` on a softmax toy model, so that early stopping can
    trigger (the engines pin min_epochs_before_stop=300)."""
    bn = get_sprinkler_network()
    t = bn.conditional_joint_table(*SPRINKLER)
    kw = dict(probs_fn=lambda p: torch.softmax(p, 0), eval_probs_fn=lambda p: torch.softmax(p, 0),
              params0=torch.zeros(8, dtype=F64),
              op=SteinOperator(score_table(t), 3, 1.0, dtype=F64, device="cpu"),
              num_epochs=200, optimizer=make_optimizer("adam", 0.05, 200),
              posterior_vec=torch.as_tensor(bn.posterior_vector(*SPRINKLER)),
              early_stopping=True, patience=3, min_epochs_before_stop=0,
              chunk_epochs=chunk_epochs)
    kw.update(overrides)
    return ksd_mod.run_ksd_scan(**kw)


def test_chunked_early_stop_skips_remaining_chunks(tmp_path):
    """A chunked run breaks at the chunk where it stopped; its state is the
    unchunked run's, whose stop and best epoch are the JAX engine's."""
    full = _toy_run(None)
    assert full["stop_epoch"] < 200, "test setup: early stop must trigger"
    chunked = _toy_run(25)
    assert len(chunked["loss_ksd"]) < 200 and len(chunked["loss_ksd"]) % 25 == 0
    assert torch.equal(full["params"], chunked["params"])
    assert torch.equal(full["best_probs"], chunked["best_probs"])
    assert full["best_epoch"] == chunked["best_epoch"]
    assert full["stop_epoch"] == chunked["stop_epoch"]
    # The JAX engine's scan on the same toy model.
    jbn = j_sprinkler()
    jt = jbn.conditional_joint_table(*SPRINKLER)
    jpv = jnp.asarray(jbn.posterior_vector(*SPRINKLER))
    jout = jksd.run_ksd_scan(
        probs_fn=lambda p, rng: jax.nn.softmax(p), eval_probs_fn=jax.nn.softmax,
        params0=jnp.zeros(8, dtype=jnp.float64),
        op=JSteinOperator(j_score_table(jt), 3, 1.0, dtype=jnp.float64), num_epochs=200,
        optimizer=jcommon.make_optimizer("adam", 0.05, 200, True, (0.9, 0.999), 10.0),
        entropy_weight=None, posterior_vec=jpv, early_stopping=True, patience=3,
        min_epochs_before_stop=0)
    stopped = np.asarray(jout["stopped"])
    assert full["stop_epoch"] == int(stopped.argmax()) + 1
    assert full["best_epoch"] == int(jout["best_epoch"])
    np.testing.assert_allclose(full["params"].numpy(), np.asarray(jout["params"]),
                               rtol=0, atol=1e-9)
    # Killed after the stopping chunk's save: the rerun dispatches nothing.
    state = str(tmp_path / "toy.pt")
    with pytest.raises(RuntimeError):
        _toy_run(25, resume_state_path=state, fail_after_chunks=len(chunked["loss_ksd"]) // 25)
    again = _toy_run(25, resume_state_path=state)
    assert again["epochs_dispatched"] == 0
    assert torch.equal(again["params"], chunked["params"])
    np.testing.assert_array_equal(again["tvd"], chunked["tvd"])


def _classical():
    bn = get_sprinkler_network()
    return KSDVariationalInference(bn, SPRINKLER[0], ["W"],
                                   {"use_logits": True, "conditioning_dim": 1}, seed=0,
                                   dtype=F64, device="cpu")


def _train_classical(eng, **kw):
    post = get_sprinkler_network().posterior_vector(*SPRINKLER)
    return eng.train(SPRINKLER[1], num_epochs=120, lr_born_machine=0.1, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=40, **kw)


def test_classical_resume_with_dropout_is_bit_identical(tmp_path, monkeypatch):
    ref = _classical()
    assert ref.born_machine.dropout_rate > 0 and ref.born_machine.conditioning_dim == 1
    _train_classical(ref)
    eng = _killed_then_resumed(_classical, _train_classical, str(tmp_path / "c.pt"), 2,
                               monkeypatch)
    _assert_same(ref, eng)


def _quantum(n=5):
    bn = get_random_chain_network(n + 1, seed=0)
    return QuantumKSDVariationalInference(
        bn, [f"V{i}" for i in range(n)], [f"V{n}"], qbm_num_latent_vars=n, qbm_ansatz_layers=2,
        dtype=F64, device="cpu")


def _train_quantum(eng, n=5, **kw):
    bn = get_random_chain_network(n + 1, seed=0)
    post = bn.posterior_vector([f"V{i}" for i in range(n)], {f"V{n}": 1})
    return eng.train({f"V{n}": 1}, num_epochs=40, lr_born_machine=0.05, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=10, **kw)


@pytest.mark.parametrize("betas", [None, [0.5, 0.75, 1.0]])
def test_quantum_resume_is_bit_identical(tmp_path, monkeypatch, betas):
    """On the circuit2d plain path; with tempering the kill falls after the
    β = 0.5 chunk, so the resumed chunk 1 must train against β = 0.75 (the
    schedule takes the absolute chunk), and the recorded TVD stays the
    unshifted history until the last chunk."""
    ref = _quantum()
    assert ref.born_machine.backend == "circuit2d"
    _train_quantum(ref, temper_betas=betas)
    eng = _killed_then_resumed(_quantum, lambda e, **kw: _train_quantum(e, temper_betas=betas,
                                                                         **kw),
                               str(tmp_path / "q.pt"), 1 if betas else 2, monkeypatch)
    _assert_same(ref, eng)
    if betas:
        plain = _quantum()
        _train_quantum(plain)
        assert plain.history_["loss_ksd"][10:20] != ref.history_["loss_ksd"][10:20]


def _adversarial(quantum):
    bn = get_sprinkler_network()
    kw = dict(seed=0, dtype=F64, device="cpu",
              classifier_config={"hidden_dims": [8], "use_batch_norm": True})
    if quantum:
        kw["born_machine"] = QuantumBornMachine(3, 2, dtype=F64, device="cpu")
    else:
        kw["born_machine_config"] = {"conditioning_dim": 1}
    return AdversarialVariationalInference(bn, SPRINKLER[0], ["W"], **kw)


def _train_adversarial(eng, **kw):
    post = get_sprinkler_network().posterior_vector(*SPRINKLER)
    return eng.train(SPRINKLER[1], num_epochs=30, batch_size=16, lr_born_machine=0.05,
                     lr_classifier=0.05, k_classifier_steps=2, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=10, **kw)


@pytest.mark.parametrize("quantum", [False, True])
def test_adversarial_resume_is_bit_identical(tmp_path, quantum):
    """Both networks, their Adam states, the BatchNorm statistics, the
    baseline, the best snapshots and the run's generator."""
    ref = _adversarial(quantum)
    _train_adversarial(ref)
    eng = _killed_then_resumed(lambda: _adversarial(quantum), _train_adversarial,
                               str(tmp_path / "a.pt"), 2)
    _assert_same(ref, eng)
    assert torch.equal(ref.classifier_stats, eng.classifier_stats)
    assert eng.history_["epochs_dispatched"] == 10


@pytest.mark.parametrize("engine", ["classical", "quantum", "adversarial"])
def test_resume_requires_chunking(engine, tmp_path):
    kw = dict(resume_state_path=str(tmp_path / "r.pt"))
    with pytest.raises(ValueError, match="chunk_epochs"):
        if engine == "classical":
            _classical().train(SPRINKLER[1], num_epochs=10, lr_born_machine=0.1, **kw)
        elif engine == "quantum":
            _quantum().train({"V5": 1}, num_epochs=10, lr_born_machine=0.1, **kw)
        else:
            _adversarial(False).train(SPRINKLER[1], 10, 8, 0.1, 0.1, **kw)


def test_resume_refuses_another_configuration(tmp_path, monkeypatch):
    state = str(tmp_path / "q.pt")
    orig = ksd_mod.run_ksd_scan
    monkeypatch.setattr(ksd_mod, "run_ksd_scan", lambda **k: orig(**k, fail_after_chunks=1))
    with pytest.raises(RuntimeError):
        _train_quantum(_quantum(), resume_state_path=state)
    monkeypatch.setattr(ksd_mod, "run_ksd_scan", orig)
    with pytest.raises(ValueError, match="different configuration"):
        _quantum().train({"V5": 1}, num_epochs=30, lr_born_machine=0.05, verbose=False,
                         chunk_epochs=10, resume_state_path=state)
    assert os.path.exists(state)


def _scale(objective, **kw):
    phases = [(20, 0.05), (20, 0.01)] if objective == "ksd" else [(10, 0.01), (10, 0.005)]
    return tscale.run_scale_experiment(num_qubits=4, layers=2, objective=objective,
                                       lr_phases=phases, chunk_epochs=5, verbose=False,
                                       device="cpu", adv_batch_size=16, **kw)


@pytest.mark.parametrize("objective", ["ksd", "adversarial"])
def test_scale_runner_phases_resume_from_their_own_snapshots(tmp_path, monkeypatch, objective):
    """Killed in phase 2, the rerun replays phase 1 from ``S.phase0`` without
    dispatching an epoch, resumes phase 2 from ``S.phase1``, removes both,
    and ends where an uninterrupted run ends."""
    ref = _scale(objective)["model"]
    state = str(tmp_path / "s.pt")
    engine = (QuantumKSDVariationalInference if objective == "ksd"
              else AdversarialVariationalInference)
    train, scan = engine.train, ksd_mod.run_ksd_scan
    paths, dispatched, kill = [], [], {"call": 2}

    def train_spy(self, *args, **kw):
        paths.append(kw["resume_state_path"])
        if objective == "adversarial" and len(paths) == kill["call"]:
            kw["fail_after_chunks"] = 1
        out = train(self, *args, **kw)
        if objective == "adversarial":
            dispatched.append(out["epochs_dispatched"])
        return out

    def scan_spy(**kw):
        out = scan(**kw, fail_after_chunks=1 if len(paths) == kill["call"] else None)
        dispatched.append(out["epochs_dispatched"])
        return out

    monkeypatch.setattr(engine, "train", train_spy)
    monkeypatch.setattr(ksd_mod, "run_ksd_scan", scan_spy)
    with pytest.raises(RuntimeError, match="fault injection"):
        _scale(objective, resume_state_path=state)
    assert paths == [state + ".phase0", state + ".phase1"]
    assert os.path.exists(state + ".phase0") and os.path.exists(state + ".phase1")

    paths.clear()
    dispatched.clear()
    kill["call"] = None
    model = _scale(objective, resume_state_path=state)["model"]
    assert dispatched == ([0, 15] if objective == "ksd" else [0, 5])
    assert not any(os.path.exists(state + f".phase{i}") for i in range(2))
    assert not os.path.exists(state)
    assert model.best_tvd_ == ref.best_tvd_
    for key, col in ref.history_.items():
        if isinstance(col, list):
            np.testing.assert_array_equal(model.history_[key], col, err_msg=key)
    if objective == "ksd":
        assert torch.equal(model.params, ref.params)
    else:
        assert torch.equal(model.born_params, ref.born_params)
        assert torch.equal(model.classifier_params, ref.classifier_params)


def test_phase_resume_paths():
    assert tscale.phase_resume_paths(None, 3) == [None] * 3
    assert tscale.phase_resume_paths("s", 1) == ["s"]
    assert tscale.phase_resume_paths("s", 2) == ["s.phase0", "s.phase1"]


def test_engine_checkpoints_follow_the_jax_layout(tmp_path):
    """The quantum and classical engines' checkpoints: the keys of the JAX
    engines' checkpoints (read back from their Orbax directories), and the
    values the engine ends with."""
    jbn = j_sprinkler()
    post, _ = jbn.get_true_posterior(*SPRINKLER)
    jq = JQKSD(jbn, SPRINKLER[0], ["W"], qbm_num_latent_vars=3, qbm_ansatz_layers=1)
    jq.train(SPRINKLER[1], num_epochs=3, lr_born_machine=5e-3, verbose=False,
             true_posterior_for_tvd=post, checkpoint_path=str(tmp_path / "jq"))
    jc = JKSD(jbn, SPRINKLER[0], ["W"], born_machine_config={"use_logits": True})
    jc.train(SPRINKLER[1], num_epochs=3, lr_born_machine=5e-3, verbose=False,
             true_posterior_for_tvd=post, checkpoint_path=str(tmp_path / "jc"))

    bn = get_sprinkler_network()
    tq = QuantumKSDVariationalInference(bn, SPRINKLER[0], ["W"], qbm_num_latent_vars=3,
                                        qbm_ansatz_layers=1, dtype=F64, device="cpu")
    tq.train(SPRINKLER[1], num_epochs=20, lr_born_machine=5e-3, verbose=False,
             true_posterior_for_tvd=post, checkpoint_path=str(tmp_path / "tq"))
    tc = KSDVariationalInference(bn, SPRINKLER[0], ["W"], {"use_logits": True}, dtype=F64,
                                 device="cpu")
    tc.train(SPRINKLER[1], num_epochs=20, lr_born_machine=5e-3, verbose=False,
             true_posterior_for_tvd=post, checkpoint_path=str(tmp_path / "tc"))
    for eng, jpath, tpath in ((tq, "jq", "tq"), (tc, "jc", "tc")):
        got = load_checkpoint(str(tmp_path / tpath))
        assert set(got) == set(j_load_checkpoint(str(tmp_path / jpath))), tpath
        assert torch.equal(got["params"], eng.params)
        assert torch.equal(got["best_params"], eng.best_params_)
        assert float(got["best_tvd"]) == eng.best_tvd_
    assert int(load_checkpoint(str(tmp_path / "tc"))["epoch"]) == 20
    # The adversarial engine's layout: born params, the discriminator's
    # variables, the best TVD.
    adv = _adversarial(False)
    _train_adversarial(adv, checkpoint_path=str(tmp_path / "ta"))
    got = load_checkpoint(str(tmp_path / "ta"))
    assert set(got) == {"born", "classifier", "best_tvd"}
    assert torch.equal(got["born"]["params"], adv.born_params)
    assert set(got["classifier"]) == {"params", "batch_stats"}
    assert torch.equal(got["classifier"]["batch_stats"], adv.classifier_stats)
