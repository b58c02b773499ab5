"""The port's command line (``runners/cli.py``) and plotting (``utils/``),
after the JAX package's tests/test_runners_cli.py.

Parser parity: both packages' runners are replaced by recorders, and for
the same argv each CLI must call its runner with the same arguments (a
config dataclass compared field by field), the port's also with
``device``. Then ``cli.main`` runs every subcommand end to end on the CPU
at toy size, and the plotting functions write their files. The CUDA
kernels themselves run only on the card (chip_smoke.py drives the CLI
there)."""

from dataclasses import asdict, is_dataclass

import numpy as np
import pytest
import torch

import tensornetworks_tpu.runners.amortized as j_amortized
import tensornetworks_tpu.runners.scale as j_scale
import tensornetworks_tpu.runners.sprinkler_adversarial as j_adv
import tensornetworks_tpu.runners.sprinkler_ksd as j_ksd
import tensornetworks_tpu.runners.sprinkler_quantum_ksd as j_qksd
from tensornetworks_tpu.runners import cli as jcli
import tensornetworks_tpu_torch.runners.amortized as t_amortized
import tensornetworks_tpu_torch.runners.scale as t_scale
import tensornetworks_tpu_torch.runners.sprinkler_adversarial as t_adv
import tensornetworks_tpu_torch.runners.sprinkler_ksd as t_ksd
import tensornetworks_tpu_torch.runners.sprinkler_quantum_ksd as t_qksd
from tensornetworks_tpu_torch.core import get_random_chain_network
from tensornetworks_tpu_torch.runners import (AdversarialConfig, ClassicalKSDConfig,
                                              QuantumKSDConfig, ScaleConfig,
                                              run_sprinkler_experiment,
                                              run_sprinkler_ksd_experiment,
                                              run_sprinkler_quantum_ksd_experiment)
from tensornetworks_tpu_torch.runners import cli
from tensornetworks_tpu_torch.runners.cli import build_parser, main
from tensornetworks_tpu_torch.runners.scale import make_scale_problem, run_scale_experiment

RUNNERS = [(j_ksd, t_ksd, "run_sprinkler_ksd_experiment"),
           (j_qksd, t_qksd, "run_sprinkler_quantum_ksd_experiment"),
           (j_adv, t_adv, "run_sprinkler_experiment"),
           (j_scale, t_scale, "run_scale_experiment"),
           (j_amortized, t_amortized, "run_amortized_experiment")]

PARITY_ARGV = {
    "ksd": ["ksd"],
    "ksd-flags": ["ksd", "--epochs", "7", "--lr", "0.1", "--entropy-weight", "0.5",
                  "--patience", "3", "--conditioning-dim", "0", "--seed", "4", "--plot", "p.png"],
    "quantum-ksd": ["quantum-ksd"],
    "quantum-ksd-flags": ["quantum-ksd", "--epochs", "5", "--lr", "0.2", "--layers", "2",
                          "--ansatz", "basic", "--init", "zero", "--seed", "3"],
    "adversarial": ["adversarial"],
    "adversarial-flags": ["adversarial", "--epochs", "9", "--batch-size", "7", "--lr-born",
                          "0.1", "--lr-classifier", "0.2", "--k-classifier", "2", "--k-born",
                          "3", "--seed", "5", "--plot", "a.png"],
    "scale": ["scale"],
    "scale-phases": ["scale", "--qubits", "16", "--layers", "8", "--ansatz", "bn_structured",
                     "--lr-phases", "100:0.05,50:0.005", "--chunk-epochs", "50",
                     "--resume-state", "s", "--checkpoint", "c"],
    "scale-phases-ls": ["scale", "--lr-phases", "30:0.05:0.5,30:0.01:auto"],
    "scale-temper": ["scale", "--qubits", "20", "--epochs", "60", "--chunk-epochs", "20",
                     "--temper-betas", "0.5,1.0", "--track-tvd", "on"],
    "scale-warm": ["scale", "--warm-start", "marginals", "--warm-start-epochs", "10",
                   "--track-tvd", "off", "--length-scale", "auto"],
    "scale-length": ["scale", "--length-scale", "0.25", "--backend", "blocked"],
    "scale-sampled": ["scale", "--objective", "sampled-ksd", "--num-samples", "64",
                      "--grad-method", "adjoint", "--grad-baseline", "cv"],
    "scale-adversarial": ["scale", "--objective", "adversarial", "--adv-batch-size", "32",
                          "--adv-k-classifier", "2", "--adv-lr-classifier-mult", "5",
                          "--lr-phases", "10:0.01,10:0.005", "--seed", "2"],
    "amortized": ["amortized"],
    "amortized-flags": ["amortized", "--qubits", "5", "--epochs", "9", "--lr", "0.1",
                        "--layers", "2", "--quantum", "--ansatz", "bn_structured",
                        "--reupload", "--length-scale", "0.5", "--chunk-epochs", "3",
                        "--lr-phases", "5:0.1,4:0.01", "--entropy-weight", "0",
                        "--learned-embedding", "--embed-per-layer", "--seed", "1"],
}


def _record(monkeypatch):
    """Replace both packages' runners by recorders of their arguments."""
    calls = {"jax": [], "torch": []}

    def recorder(side, name):
        def run(*args, **kwargs):
            args = [asdict(a) if is_dataclass(a) else a for a in args]
            calls[side].append((name, args, kwargs))
            return {}
        return run

    for jmod, tmod, name in RUNNERS:
        monkeypatch.setattr(jmod, name, recorder("jax", name))
        monkeypatch.setattr(tmod, name, recorder("torch", name))
    return calls


@pytest.mark.parametrize("case", list(PARITY_ARGV))
def test_cli_calls_the_runner_as_the_jax_cli_does(case, monkeypatch):
    calls = _record(monkeypatch)
    argv = PARITY_ARGV[case]
    jcli.main(argv)
    main(argv + ["--device", "cpu"])
    main(argv)
    (jname, jargs, jkw), (tname, targs, tkw), (_, _, default_kw) = (
        calls["jax"] + calls["torch"])
    assert (tname, targs) == (jname, jargs)
    assert tkw.pop("device") == "cpu" and default_kw.pop("device") == "cuda"
    assert tkw == jkw == default_kw


def test_scale_mesh_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        main(["scale", "--mesh", "2", "--device", "cpu"])


def test_parse_phase():
    assert cli._parse_phase("100:0.05") == (100.0, 0.05)
    assert cli._parse_phase("6000:0.05:auto") == (6000.0, 0.05, "auto")
    assert cli._parse_phase("6000:0.05:0.25") == (6000.0, 0.05, 0.25)
    with pytest.raises(ValueError, match="epochs:lr"):
        cli._parse_phase("1:2:3:4")


def test_ksd_runner_smoke(tmp_path):
    cfg = ClassicalKSDConfig(num_epochs=30)
    out = run_sprinkler_ksd_experiment(cfg, verbose=False, plot_path=str(tmp_path / "ksd.png"),
                                       device="cpu")
    assert np.isfinite(out["final_tvd"])
    assert (tmp_path / "ksd.png").exists()
    assert len(out["history"]["loss_ksd"]) == 30


def test_quantum_runner_smoke(tmp_path):
    out = run_sprinkler_quantum_ksd_experiment(QuantumKSDConfig(num_epochs=25, ansatz_layers=2),
                                               verbose=False, device="cpu",
                                               plot_path=str(tmp_path / "q.png"))
    assert np.isfinite(out["final_tvd"]) and (tmp_path / "q.png").exists()


def test_adversarial_runner_smoke():
    out = run_sprinkler_experiment(AdversarialConfig(num_epochs=20), verbose=False, device="cpu")
    assert np.isfinite(out["final_tvd"])


def test_adversarial_scale_lr_phases():
    out = run_scale_experiment(num_qubits=4, layers=2, objective="adversarial",
                               lr_phases=[(12, 5e-3), (8, 1e-3)], verbose=False, seed=0,
                               device="cpu", adv_batch_size=64)
    model = out["model"]
    assert np.isfinite(model.best_tvd_)
    assert len(out["history"]["tvd"]) == 8
    assert model.best_tvd_ <= float(np.nanmin(out["history"]["tvd"])) + 1e-9


def test_cli_parser():
    p = build_parser()
    args = p.parse_args(["quantum-ksd", "--epochs", "5", "--layers", "2"])
    assert args.command == "quantum-ksd" and args.epochs == 5 and args.device == "cuda"
    args = p.parse_args(["scale", "--qubits", "10", "--objective", "adversarial"])
    assert args.qubits == 10


def test_cli_main_runs(tmp_path):
    out = main(["quantum-ksd", "--epochs", "5", "--layers", "1", "--device", "cpu"])
    assert out is not None and len(out["history"]["loss_ksd"]) == 5
    out = main(["ksd", "--epochs", "5", "--device", "cpu", "--plot", str(tmp_path / "k.png")])
    assert (tmp_path / "k.png").exists() and np.isfinite(out["final_tvd"])
    out = main(["adversarial", "--epochs", "3", "--device", "cpu",
                "--plot", str(tmp_path / "a.png")])
    assert (tmp_path / "a.png").exists() and np.isfinite(out["final_tvd"])


def test_scale_problem_factory():
    bn, latent, observed = make_scale_problem(6, seed=1)
    assert len(latent) == 6 and bn.num_nodes == 7
    assert abs(bn.joint_table().sum() - 1.0) < 1e-9


def test_scale_experiment_smoke():
    out = run_scale_experiment(num_qubits=5, layers=2, num_epochs=15, objective="ksd",
                               verbose=False, device="cpu")
    assert np.isfinite(out["history"]["loss_ksd"]).all()


def test_scale_config_matches_the_jax_fields():
    from tensornetworks_tpu.runners.configs import ScaleConfig as JScaleConfig

    assert asdict(ScaleConfig()) == asdict(JScaleConfig())


def test_stability_plot(tmp_path):
    from tensornetworks_tpu_torch.utils import (plot_posterior_comparison,
                                                plot_stability_analysis, plot_training_results)

    history = {"tvd": list(np.linspace(0.5, 0.01, 120)),
               "loss_ksd": list(np.linspace(10, 0.1, 120))}
    plot_stability_analysis(history, save_path=str(tmp_path / "stab.png"))
    assert (tmp_path / "stab.png").exists()
    plot_posterior_comparison({(0,): 0.3, (1,): 0.7}, {(0,): 0.25, (1,): 0.75},
                              save_path=str(tmp_path / "bar.png"))
    assert (tmp_path / "bar.png").exists()
    plot_training_results(history, save_path=str(tmp_path / "train.png"))
    assert (tmp_path / "train.png").exists()
    assert plot_training_results({"epochs_per_sec": 3.0}) is None


def test_scale_sampled_ksd_objective():
    out = run_scale_experiment(num_qubits=5, layers=2, num_epochs=15, objective="sampled-ksd",
                               verbose=False, device="cpu")
    assert np.isfinite(np.asarray(out["history"]["loss_ksd"])).all()


def test_cli_amortized_reupload_flag():
    out = main(["amortized", "--qubits", "3", "--epochs", "20", "--quantum", "--ansatz",
                "bn_structured", "--reupload", "--lr", "0.05", "--device", "cpu"])
    assert out["model"].born_machine.cond_reupload is True
    assert all(np.isfinite(v) for v in out["per_obs_tvd"].values())


def test_cli_scale_sampled_grad_method():
    out = main(["scale", "--qubits", "6", "--objective", "sampled-ksd", "--epochs", "10",
                "--num-samples", "64", "--grad-method", "adjoint", "--device", "cpu"])
    assert out["model"].born_machine.grad_method == "adjoint"


def test_cli_scale_warm_start_marginals():
    out = main(["scale", "--qubits", "5", "--ansatz", "bn_structured", "--layers", "3",
                "--epochs", "40", "--warm-start", "marginals", "--warm-start-epochs", "200",
                "--device", "cpu"])
    best = out["model"].best_tvd_
    assert np.isfinite(best) and best < 0.5


def test_cli_scale_lr_phases():
    out = main(["scale", "--qubits", "5", "--ansatz", "bn_structured", "--layers", "3",
                "--lr-phases", "60:0.05,40:0.005", "--device", "cpu"])
    eng = out["model"]
    assert np.isfinite(eng.best_tvd_)
    bn = get_random_chain_network(6, seed=0)
    post = bn.posterior_vector([f"V{i}" for i in range(5)], {"V5": 1})
    with torch.no_grad():
        q = eng.born_machine.probs(eng.params).double().numpy()
    np.testing.assert_allclose(0.5 * np.abs(q - post).sum(), eng.best_tvd_, atol=1e-5)


def test_cli_scale_length_scale():
    out = main(["scale", "--qubits", "4", "--ansatz", "bn_structured", "--layers", "2",
                "--epochs", "30", "--length-scale", "0.5", "--device", "cpu"])
    assert out["model"].base_kernel_length_scale == 0.5
    assert np.isfinite(out["model"].best_tvd_)


def test_cli_scale_length_scale_auto():
    out = main(["scale", "--qubits", "4", "--ansatz", "bn_structured", "--layers", "2",
                "--epochs", "30", "--length-scale", "auto", "--device", "cpu"])
    assert out["model"].base_kernel_length_scale == 0.25
    assert np.isfinite(out["model"].best_tvd_)


def test_cli_scale_lr_phases_with_length_scale():
    out = main(["scale", "--qubits", "4", "--ansatz", "bn_structured", "--layers", "2",
                "--lr-phases", "30:0.05:0.5,30:0.01:auto", "--device", "cpu"])
    model = out["model"]
    assert model.base_kernel_length_scale == 0.25
    assert np.isfinite(model.best_tvd_)


def test_cli_scale_resume_and_checkpoint(tmp_path):
    """The scale subcommand's --resume-state and --checkpoint: a rerun of a
    finished run trains anew (the snapshot was removed) and writes the same
    checkpoint, bit for bit."""
    from tensornetworks_tpu_torch.train import load_checkpoint

    argv = ["scale", "--qubits", "4", "--layers", "2", "--epochs", "20", "--chunk-epochs", "5",
            "--resume-state", str(tmp_path / "s"), "--device", "cpu"]
    main(argv + ["--checkpoint", str(tmp_path / "a")])
    assert not (tmp_path / "s").exists()
    main(argv + ["--checkpoint", str(tmp_path / "b")])
    a, b = load_checkpoint(str(tmp_path / "a")), load_checkpoint(str(tmp_path / "b"))
    assert set(a) == {"params", "best_params", "best_tvd"}
    for key in a:
        assert torch.equal(a[key], b[key]), key
