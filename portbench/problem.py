"""The general generator: a cell's inputs from its configuration, its
traffic file and the seed.

A traffic file fixes the problem's shape; the seed draws its numbers:

- ``num_latent`` latent variables (the qubits) and ``num_vars`` network
  variables in all, the last ones observed at ``observed`` values;
- the network is a random DAG in which variable i takes
  min(i, U{0..max_parents}) distinct parents among the earlier variables,
  and every CPT row p(v_i = 1 | parents) is U(cpt_low, cpt_high) (the
  scale problem of the repository's runners);
- the circuit's angles start at ``init_scale`` * N(0, 1);
- ``length_scale`` is the Hamming kernel's, a number or ``"auto"``
  (1/n below 18 variables, 2/n from 18).

The seed feeds one ``numpy.random.SeedSequence``; the network, the angles
and the program's own sampling generator each take a child of it, so one
seed gives the same inputs on every run.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def resolve_length_scale(spec, n: int) -> float:
    if spec == "auto":
        return (2.0 if n >= 18 else 1.0) / n
    return float(spec)


def random_dag(rng: np.random.Generator, num_vars: int, max_parents: int,
               low: float, high: float):
    """(parents, cpts): parents[i] a list of earlier variables, cpts[i] the
    (2^k, 2) table [p0, p1] with rows MSB-first over the listed parents."""
    parents, cpts = [], []
    for i in range(num_vars):
        k = int(min(i, rng.integers(0, max_parents + 1)))
        ps = [int(p) for p in rng.choice(i, size=k, replace=False)] if k else []
        p1 = np.array([rng.uniform(low, high) for _ in range(1 << k)], dtype=np.float64)
        parents.append(ps)
        cpts.append(np.stack([1.0 - p1, p1], axis=1))
    return parents, cpts


def make_problem(config: dict, traffic: dict, seed: int) -> Dict:
    n = int(traffic["num_latent"])
    N = int(traffic["num_vars"])
    ss = np.random.SeedSequence(int(seed))
    net_seq, theta_seq, prog_seq = ss.spawn(3)
    parents, cpts = random_dag(np.random.default_rng(net_seq), N,
                               int(traffic.get("max_parents", 2)),
                               float(traffic.get("cpt_low", 0.05)),
                               float(traffic.get("cpt_high", 0.95)))
    observed = {int(k): int(v) for k, v in traffic["observed"].items()}
    if sorted(observed) != list(range(n, N)):
        raise ValueError("the observed variables must be the last num_vars - num_latent")
    L = int(config["layers"])
    per_qubit = 3
    theta0 = float(config.get("init_scale", 0.1)) * np.random.default_rng(
        theta_seq).standard_normal(per_qubit * n * L)
    edges = [(p, c) for c in range(n) for p in parents[c] if p < n]
    return {
        "kind": config["kind"], "n": n, "num_vars": N, "layers": L,
        "ansatz": config["ansatz"], "lr": float(config["lr"]),
        "clip": float(config.get("clip", 10.0)),
        "num_samples": int(config.get("num_samples", 0)),
        "sampling": config.get("sampling", "two_stage"),
        "grad_baseline": config.get("grad_baseline", "loo"),
        "length_scale": resolve_length_scale(traffic["length_scale"], n),
        "parents": parents, "cpts": cpts, "observed": observed,
        "edges": edges if config["ansatz"] == "bn_structured" else [],
        "theta0": theta0,
        "program_seed": int(prog_seq.generate_state(1, np.uint32)[0]),
        "track_tvd": bool(traffic.get("track_tvd", False)),
        "chunk_epochs": traffic.get("chunk_epochs"),
    }
