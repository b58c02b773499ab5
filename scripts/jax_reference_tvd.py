"""The JAX package's best TVD on two configurations, on the CPU in float32:
the reference figures behind two of ``chip_smoke.py``'s limits for the
PyTorch port.

- ``classical16``: ``KSDVariationalInference`` with a 2^16 softmax table on
  ``make_scale_problem(16)``'s network (ℓ = 1, lr 5e-3, clip 5, entropy
  1e-3, patience 200, 3000 epochs). About 40-75 s on 8 CPU cores.
- ``adversarial16``: ``run_scale_experiment(16, layers=8,
  objective="adversarial", ansatz="bn_structured", lr=5e-3)`` for 1000
  epochs at seed 0. About 22 minutes on 8 CPU cores.
- ``sampled16``: ``SampledKSDVariationalInference`` on the same network
  with ``scripts/quality_sampled.py``'s defaults (bn_structured L=8, ℓ auto,
  1024 shots, loo baseline, eval on the loss forward, seed 0), one phase of
  2000 epochs at lr 0.05 in chunks of 500.
- ``amortized16``: ``AmortizedKSD`` with ``scripts/quality_amortized16.py``'s
  model (a random chain network of 18 variables, seed 0, V16 and V17
  observed, so 4 observations; one conditioned bn_structured circuit, L=8,
  re-uploading the fixed RY(π·x) wall before every layer, ℓ auto = 1/16,
  clip 10, entropy 0, seed 0), one phase of 2000 epochs at lr 0.05 in
  chunks of 500.

Usage: python scripts/jax_reference_tvd.py classical16|adversarial16|sampled16|amortized16
Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def classical16():
    from tensornetworks_tpu.engines import KSDVariationalInference
    from tensornetworks_tpu.runners.scale import make_scale_problem

    bn, latent, obs = make_scale_problem(16, 0)
    eng = KSDVariationalInference(bn, latent, list(obs), born_machine_config={"conditioning_dim": 0},
                                  base_kernel_length_scale=1.0, seed=0)
    hist = eng.train(obs, num_epochs=3000, lr_born_machine=5e-3, verbose=False,
                     true_posterior_for_tvd=bn.posterior_vector(latent, obs),
                     gradient_clip_norm=5.0, entropy_weight=1e-3, patience=200,
                     chunk_epochs=500)
    return {"best_tvd": eng.best_tvd_, "best_epoch": eng.best_epoch_,
            "epochs_run": len(hist["loss_ksd"])}


def adversarial16():
    from tensornetworks_tpu.runners.scale import run_scale_experiment

    out = run_scale_experiment(16, layers=8, num_epochs=1000, lr=5e-3, objective="adversarial",
                               ansatz="bn_structured", seed=0, verbose=False, chunk_epochs=100)
    return {"best_tvd": out["model"].best_tvd_, "best_epoch": out["model"].best_epoch_,
            "tvd_epoch0": out["history"]["tvd"][0]}


def sampled16():
    from tensornetworks_tpu.engines import SampledKSDVariationalInference
    from tensornetworks_tpu.runners.scale import make_scale_problem

    bn, latent, obs = make_scale_problem(16, 0)
    eng = SampledKSDVariationalInference(bn, latent, list(obs), qbm_ansatz_layers=8,
                                         qbm_ansatz_type="bn_structured", num_samples=1024,
                                         seed=0, base_kernel_length_scale="auto",
                                         grad_baseline="loo")
    hist = eng.train(obs, num_epochs=2000, lr_born_machine=0.05, verbose=False,
                     true_posterior_for_tvd=bn.posterior_vector(latent, obs), chunk_epochs=500,
                     reuse_loss_forward_for_eval=True, seed=0)
    return {"best_tvd": eng.best_tvd_, "best_epoch": eng.best_epoch_,
            "ustat_first": float(hist["loss_ksd"][0]), "ustat_last": float(hist["loss_ksd"][-1])}


def amortized16():
    from itertools import product

    import numpy as np

    from tensornetworks_tpu import get_random_chain_network
    from tensornetworks_tpu.engines.amortized import AmortizedKSD
    from tensornetworks_tpu.models import QuantumBornMachine
    from tensornetworks_tpu.sim.structured import latent_edges

    n = 16
    bn = get_random_chain_network(n + 2, seed=0)
    latent = [f"V{i}" for i in range(n)]
    observed = [f"V{n}", f"V{n + 1}"]
    observations = [dict(zip(observed, bits)) for bits in product((0, 1), repeat=2)]
    qbm = QuantumBornMachine(n, ansatz_layers=8, ansatz_type="bn_structured",
                             conditioning_dim=2, edges=latent_edges(bn, latent),
                             cond_reupload=True)
    eng = AmortizedKSD(bn, latent, observed, born_machine=qbm, seed=0,
                       base_kernel_length_scale="auto")
    hist = eng.train(observations, num_epochs=2000, lr=0.05, gradient_clip_norm=10.0,
                     entropy_weight=0.0, verbose=False, seed=0, chunk_epochs=500)
    return {"best_mean_tvd": eng.best_mean_tvd_, "best_epoch": eng.best_epoch_,
            "mean_tvd_epoch0": float(hist["mean_tvd"][0]),
            "loss_first": float(hist["loss"][0]), "loss_last": float(hist["loss"][-1]),
            "per_obs_tvd": [float(0.5 * np.abs(np.asarray(eng.posterior_for(o))
                                               - bn.posterior_vector(latent, o)).sum())
                            for o in observations]}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "classical16"
    t0 = time.time()
    result = {"classical16": classical16, "adversarial16": adversarial16,
              "sampled16": sampled16, "amortized16": amortized16}[which]()
    print(json.dumps({"config": which, **result, "seconds": time.time() - t0}))
