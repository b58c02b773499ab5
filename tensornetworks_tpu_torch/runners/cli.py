"""Command line for the port's experiments: the ``ksd``, ``quantum-ksd``,
``adversarial``, ``scale`` and ``amortized`` subcommands, with every flag
and default of ``tensornetworks_tpu/runners/cli.py``, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions).

Usage:
    python -m tensornetworks_tpu_torch.runners.cli ksd [--epochs N] [--lr F] ...
    python -m tensornetworks_tpu_torch.runners.cli quantum-ksd [--layers L] ...
    python -m tensornetworks_tpu_torch.runners.cli adversarial [--batch-size B] ...
    python -m tensornetworks_tpu_torch.runners.cli scale --qubits 16 [--objective ksd]
        [--chunk-epochs 100 --resume-state S --checkpoint C]
    python -m tensornetworks_tpu_torch.runners.cli amortized --qubits 4 [--quantum]

(``tntpu-torch`` once the package is installed.) ``main`` returns the
runner's result dict.
"""

from __future__ import annotations

import argparse

from ..engines.ksd import not_ported


def _parse_phase(spec: str):
    """epochs:lr or epochs:lr:length_scale ('auto' allowed for the scale)."""
    parts = spec.split(":")
    if len(parts) == 2:
        return (float(parts[0]), float(parts[1]))
    if len(parts) == 3:
        ls = parts[2] if parts[2] == "auto" else float(parts[2])
        return (float(parts[0]), float(parts[1]), ls)
    raise ValueError(f"bad phase spec {spec!r}; expected epochs:lr[:ls]")


def _parse_phases(specs):
    return [_parse_phase(p) for p in specs.split(",")] if specs else None


def _length_scale(v):
    return v if v == "auto" else float(v)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tensornetworks_tpu_torch",
                                description="Born-machine VI experiments on the card")
    sub = p.add_subparsers(dest="command", required=True)

    ksd = sub.add_parser("ksd", help="classical KSD VI on Sprinkler")
    ksd.add_argument("--epochs", type=int, default=2000)
    ksd.add_argument("--lr", type=float, default=3e-3)
    ksd.add_argument("--entropy-weight", type=float, default=1e-3)
    ksd.add_argument("--patience", type=int, default=200)
    ksd.add_argument("--conditioning-dim", type=int, default=1)
    ksd.add_argument("--seed", type=int, default=0)
    ksd.add_argument("--plot", type=str, default=None)

    q = sub.add_parser("quantum-ksd", help="quantum KSD VI on Sprinkler")
    q.add_argument("--epochs", type=int, default=1000)
    q.add_argument("--lr", type=float, default=5e-3)
    q.add_argument("--layers", type=int, default=4)
    q.add_argument("--ansatz", type=str, default="hardware_efficient",
                   choices=["hardware_efficient", "all_to_all", "basic"])
    q.add_argument("--init", type=str, default="small_random",
                   choices=["zero", "small_random", "random"])
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--plot", type=str, default=None)

    a = sub.add_parser("adversarial", help="adversarial VI on Sprinkler")
    a.add_argument("--epochs", type=int, default=1500)
    a.add_argument("--batch-size", type=int, default=100)
    a.add_argument("--lr-born", type=float, default=3e-3)
    a.add_argument("--lr-classifier", type=float, default=3e-2)
    a.add_argument("--k-classifier", type=int, default=5)
    a.add_argument("--k-born", type=int, default=1)
    a.add_argument("--seed", type=int, default=0)
    a.add_argument("--plot", type=str, default=None)

    s = sub.add_parser("scale", help="large-n scaling runs on the random chain network")
    s.add_argument("--qubits", type=int, default=8)
    s.add_argument("--layers", type=int, default=4)
    s.add_argument("--epochs", type=int, default=200)
    s.add_argument("--lr", type=float, default=5e-3)
    s.add_argument("--objective", type=str, default="ksd",
                   choices=["ksd", "adversarial", "sampled-ksd"])
    s.add_argument("--ansatz", type=str, default="hardware_efficient",
                   choices=["hardware_efficient", "all_to_all", "basic", "bn_structured"])
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--backend", type=str, default="auto",
                   help="circuit executor (auto|circuit2d|circuit2d_grid|blocked|blocked2d|"
                        "einsum|structured2d)")
    s.add_argument("--chunk-epochs", type=int, default=None,
                   help="epochs between host syncs (and resume snapshots)")
    s.add_argument("--resume-state", type=str, default=None,
                   help="durable chunk-resume snapshot path (with --chunk-epochs); with "
                        "several --lr-phases, phase i uses PATH.phase<i>")
    s.add_argument("--temper-betas", type=str, default=None,
                   help="comma-separated per-chunk inverse temperatures, "
                        "e.g. 0.25,0.5,0.75,1.0 (with --chunk-epochs)")
    s.add_argument("--grad-method", type=str, default="auto",
                   choices=["auto", "autodiff", "adjoint"],
                   help="circuit backward for --objective sampled-ksd: the adjoint "
                        "auto-enables at n >= 26")
    s.add_argument("--num-samples", type=int, default=1024,
                   help="shots per epoch for --objective sampled-ksd")
    s.add_argument("--grad-baseline", type=str, default="loo",
                   choices=["loo", "mean", "none", "cv"],
                   help="REINFORCE baseline for --objective sampled-ksd: loo is exactly "
                        "unbiased (default); cv adds a ridge-fit control variate")
    s.add_argument("--adv-batch-size", type=int, default=256,
                   help="samples per REINFORCE batch (adversarial objective)")
    s.add_argument("--adv-k-classifier", type=int, default=3,
                   help="discriminator steps per Born step (adversarial)")
    s.add_argument("--adv-lr-classifier-mult", type=float, default=10.0,
                   help="lr_D = mult * lr_G per phase (adversarial)")
    s.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint written after training (torch.save)")
    s.add_argument("--warm-start", type=str, default=None, choices=["marginals"],
                   help="distill toward the posterior-marginals product before KSD "
                        "training (ksd objective only)")
    s.add_argument("--warm-start-epochs", type=int, default=2000)
    s.add_argument("--length-scale", type=_length_scale, default="auto",
                   help="Hamming base-kernel length scale l in exp(-d/(n*l)); 'auto' "
                        "(default): 1/n for n<=17, 2/n from n>=18")
    s.add_argument("--lr-phases", type=str, default=None,
                   help="LR-annealed warm restarts: comma-separated epochs:lr pairs, e.g. "
                        "48000:0.05,24000:0.005,24000:0.001 (overrides --epochs/--lr; ksd "
                        "and adversarial objectives); an optional third field sets the "
                        "phase's kernel length scale, e.g. 6000:0.05:0.25,6000:0.05:auto")
    s.add_argument("--mesh", type=int, default=None,
                   help="shard the 2^n state over this many devices (not ported yet)")
    s.add_argument("--track-tvd", type=str, default="auto", choices=["auto", "on", "off"],
                   help="per-epoch exact-TVD eval against the enumerated posterior (auto: on "
                        "up to 20 qubits)")

    am = sub.add_parser("amortized", help="amortized KSD over all observations at once")
    am.add_argument("--qubits", type=int, default=4)
    am.add_argument("--epochs", type=int, default=1500)
    am.add_argument("--lr", type=float, default=3e-3)
    am.add_argument("--layers", type=int, default=4,
                    help="ansatz layers (quantum born machine)")
    am.add_argument("--quantum", action="store_true",
                    help="conditioned quantum Born machine instead of the conditional "
                         "classical one")
    am.add_argument("--ansatz", type=str, default="hardware_efficient",
                    choices=["hardware_efficient", "all_to_all", "basic", "bn_structured"])
    am.add_argument("--reupload", action="store_true",
                    help="data re-uploading: the RY(x) embedding wall precedes every layer "
                         "(conditioned bn_structured only)")
    am.add_argument("--length-scale", type=_length_scale, default="auto",
                    help="Hamming base-kernel bandwidth (as scale --length-scale)")
    am.add_argument("--chunk-epochs", type=int, default=None)
    am.add_argument("--lr-phases", type=str, default=None,
                    help="epochs:lr[:ls] phases, as in scale --lr-phases")
    am.add_argument("--entropy-weight", type=float, default=1e-3)
    am.add_argument("--learned-embedding", action="store_true",
                    help="learn the conditioning wall angles as a map over the binary "
                         "interaction basis of x")
    am.add_argument("--embed-per-layer", action="store_true",
                    help="per-layer learned scales on the embedding wall (requires "
                         "--learned-embedding and --reupload)")
    am.add_argument("--seed", type=int, default=0)

    for parser in (ksd, q, a, s, am):
        parser.add_argument("--device", type=str, default="cuda",
                            help="torch device (default cuda; cpu runs the plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command == "ksd":
        from .configs import ClassicalKSDConfig
        from .sprinkler_ksd import run_sprinkler_ksd_experiment

        cfg = ClassicalKSDConfig(num_epochs=args.epochs, lr=args.lr,
                                 entropy_weight=args.entropy_weight, patience=args.patience,
                                 conditioning_dim=args.conditioning_dim, seed=args.seed)
        return run_sprinkler_ksd_experiment(cfg, plot_path=args.plot, device=args.device)
    if args.command == "quantum-ksd":
        from .configs import QuantumKSDConfig
        from .sprinkler_quantum_ksd import run_sprinkler_quantum_ksd_experiment

        cfg = QuantumKSDConfig(num_epochs=args.epochs, lr=args.lr, ansatz_layers=args.layers,
                               ansatz_type=args.ansatz, init_method=args.init, seed=args.seed)
        return run_sprinkler_quantum_ksd_experiment(cfg, plot_path=args.plot,
                                                    device=args.device)
    if args.command == "adversarial":
        from .configs import AdversarialConfig
        from .sprinkler_adversarial import run_sprinkler_experiment

        cfg = AdversarialConfig(num_epochs=args.epochs, batch_size=args.batch_size,
                                lr_born=args.lr_born, lr_classifier=args.lr_classifier,
                                k_classifier_steps=args.k_classifier,
                                k_born_steps=args.k_born, seed=args.seed)
        return run_sprinkler_experiment(cfg, plot_path=args.plot, device=args.device)
    if args.command == "scale":
        if args.mesh:
            not_ported("scale --mesh (the distributed KSD engine)", "A12")
        from .scale import run_scale_experiment

        betas = ([float(b) for b in args.temper_betas.split(",")]
                 if args.temper_betas else None)
        return run_scale_experiment(num_qubits=args.qubits, layers=args.layers,
                                    num_epochs=args.epochs, lr=args.lr,
                                    objective=args.objective, seed=args.seed,
                                    ansatz=args.ansatz, backend=args.backend,
                                    chunk_epochs=args.chunk_epochs,
                                    resume_state_path=args.resume_state,
                                    temper_betas=betas, num_samples=args.num_samples,
                                    grad_method=args.grad_method,
                                    grad_baseline=args.grad_baseline,
                                    checkpoint_path=args.checkpoint,
                                    warm_start=args.warm_start,
                                    warm_start_epochs=args.warm_start_epochs,
                                    length_scale=args.length_scale,
                                    lr_phases=_parse_phases(args.lr_phases),
                                    track_tvd={"auto": None, "on": True,
                                               "off": False}[args.track_tvd],
                                    adv_batch_size=args.adv_batch_size,
                                    adv_k_classifier=args.adv_k_classifier,
                                    adv_lr_classifier_mult=args.adv_lr_classifier_mult,
                                    device=args.device)
    if args.command == "amortized":
        from .amortized import run_amortized_experiment

        return run_amortized_experiment(
            num_qubits=args.qubits, num_epochs=args.epochs, lr=args.lr, layers=args.layers,
            quantum=args.quantum, ansatz=args.ansatz, entropy_weight=args.entropy_weight,
            seed=args.seed, reupload=args.reupload, length_scale=args.length_scale,
            chunk_epochs=args.chunk_epochs, learned_embedding=args.learned_embedding,
            embed_per_layer=args.embed_per_layer, lr_phases=_parse_phases(args.lr_phases),
            device=args.device)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    main()
