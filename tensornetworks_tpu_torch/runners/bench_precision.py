"""The quality A/B of the precision policy on the card: the best TVD and
epochs/s of two configurations under each precision setting. Counterpart of
``scripts/bench_precision.py``, with the same two configurations:

- the 3-qubit Sprinkler oracle, quantum KSD, HE L=4, 1000 epochs at lr 5e-3
  (where the JAX package measured one bf16 pass to cost 24x);
- the 16-qubit chain (a random chain network of 18 variables, seed 7, V16=1
  and V17=0 observed), bn_structured L=8, 800 epochs at lr 0.05 in chunks
  of 400.

A setting names the kernel precision (``ops.kernels.precision``: circuit
kernels 1, 2, 5 and 6) and the matmul precision (``TNTPU_MATMUL_PRECISION``,
the engines' ``highest_matmul_precision``: torch's matmuls outside the
kernels). ``both``: the two knobs at one name, as the JAX script sets its
one; ``kernel``: the kernel knob alone, the matmul knob at its default.

    python -m tensornetworks_tpu_torch.runners.bench_precision [--settings highest:both,...]

Prints a line per configuration and setting, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..core import get_random_chain_network, get_sprinkler_network
from ..engines import QuantumKSDVariationalInference
from ..ops.kernels.precision import _kernel_precision, precision_name, set_kernel_precision

SETTINGS = (("highest", "both"), ("high", "both"), ("default", "both"), ("high", "kernel"),
            ("default", "kernel"))


def _train(bn, latent, observed, layers, ansatz, epochs, lr, chunk, device):
    post = bn.posterior_vector(latent, observed)
    eng = QuantumKSDVariationalInference(bn, latent, list(observed),
                                         qbm_num_latent_vars=len(latent),
                                         qbm_ansatz_layers=layers, qbm_ansatz_type=ansatz,
                                         seed=0, device=device)
    t0 = time.perf_counter()
    hist = eng.train(observed, num_epochs=epochs, lr_born_machine=lr, verbose=False,
                     true_posterior_for_tvd=post, chunk_epochs=chunk)
    return {"best_tvd": float(eng.best_tvd_), "final_loss": float(hist["loss_ksd"][-1]),
            "epochs_per_sec": float(hist["epochs_per_sec"]),
            "seconds": time.perf_counter() - t0, "backend": eng.born_machine.backend}


def sprinkler3(device="cuda") -> dict:
    """The 3-qubit Sprinkler oracle: HE L=4, 1000 epochs, lr 5e-3."""
    return _train(get_sprinkler_network(), ["C", "S", "R"], {"W": 1}, 4, "hardware_efficient",
                  1000, 5e-3, None, device)


def chain16(device="cuda") -> dict:
    """The 16-qubit chain: bn_structured L=8, 800 epochs, lr 0.05, chunks of 400."""
    n = 16
    return _train(get_random_chain_network(n + 2, seed=7), [f"V{i}" for i in range(n)],
                  {f"V{n}": 1, f"V{n + 1}": 0}, 8, "bn_structured", 800, 0.05, 400, device)


CONFIGS = {"sprinkler3": sprinkler3, "chain16": chain16}


def run_setting(precision: str, knobs: str, configs=tuple(CONFIGS), device="cuda") -> list:
    """Every configuration under one setting; both knobs are restored after."""
    precision = precision_name(precision)
    if knobs not in ("both", "kernel"):
        raise ValueError(f"knobs must be 'both' or 'kernel', got {knobs!r}")
    old_kernel, old_env = _kernel_precision(), os.environ.get("TNTPU_MATMUL_PRECISION")
    set_kernel_precision(precision)
    if knobs == "both":
        os.environ["TNTPU_MATMUL_PRECISION"] = precision
    else:
        os.environ.pop("TNTPU_MATMUL_PRECISION", None)
    try:
        return [{"config": c, "precision": precision, "knobs": knobs, **CONFIGS[c](device)}
                for c in configs]
    finally:
        set_kernel_precision(old_kernel)
        if old_env is None:
            os.environ.pop("TNTPU_MATMUL_PRECISION", None)
        else:
            os.environ["TNTPU_MATMUL_PRECISION"] = old_env


def run(settings=SETTINGS, configs=tuple(CONFIGS), device="cuda", verbose=True) -> list:
    rows = []
    for precision, knobs in settings:
        for row in run_setting(precision, knobs, configs, device):
            rows.append(row)
            if verbose:
                print(f"[{precision}/{knobs}] {row['config']}: best TVD {row['best_tvd']:.6f}, "
                      f"loss[-1] {row['final_loss']:.5f}, {row['epochs_per_sec']:.1f} epochs/s "
                      f"({row['seconds']:.1f} s)", flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--settings", default=",".join(f"{p}:{k}" for p, k in SETTINGS),
                    help="comma-separated precision:knobs, knobs 'both' or 'kernel'")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    settings = [tuple(s.split(":")) for s in args.settings.split(",")]
    rows = run(settings, args.configs.split(","), args.device)
    print(json.dumps({"bench_precision": rows}))


if __name__ == "__main__":
    main()
