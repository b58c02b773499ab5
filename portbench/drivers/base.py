"""What every driver does: build the program's network from the problem's
arrays, hand the program the benchmark's starting angles, and call the
engine's public ``train`` with the cell's arguments.

A driver (``drivers/<name>.py``, named by the configuration's ``driver``)
subclasses ``Driver`` and builds its engine in ``make_engine``. The
harness calls ``first_steps`` once in set-up (the steps the reference
follows), ``train`` for the rest, and ``end_state`` once the window has
closed. ``train`` is the one call and feed of the window.
"""

from __future__ import annotations

import numpy as np
import torch


def latent_names(n: int):
    return [f"V{i}" for i in range(n)]


def build_network(problem: dict):
    """The program's ``BayesianNetwork`` with the problem's parents and CPTs."""
    from tensornetworks_tpu_torch.core.bayes_net import BayesianNetwork

    bn = BayesianNetwork()
    for i, (ps, cpt) in enumerate(zip(problem["parents"], problem["cpts"])):
        k = len(ps)
        table = {}
        for row in range(1 << k):
            key = tuple((row >> (k - 1 - j)) & 1 for j in range(k))
            table[key] = {0: float(cpt[row, 0]), 1: float(cpt[row, 1])}
        bn.add_node(f"V{i}", cpt=table, parent_names=[f"V{p}" for p in ps])
    return bn


class Driver:
    def __init__(self, problem: dict, device):
        self.problem = problem
        self.device = torch.device(device)
        n = problem["n"]
        self.bn = build_network(problem)
        self.latent = latent_names(n)
        self.observed = {f"V{i}": v for i, v in problem["observed"].items()}
        self.posterior = None
        if problem["track_tvd"]:
            self.posterior = self.bn.posterior_vector(self.latent, self.observed).astype(
                np.float32)
        self.engine = self.make_engine()
        self.engine.params = torch.as_tensor(problem["theta0"], dtype=torch.float32,
                                             device=self.device)

    def make_engine(self):
        raise NotImplementedError

    def train_kwargs(self) -> dict:
        return {}

    def train(self, epochs: int) -> dict:
        p = self.problem
        return self.engine.train(self.observed, num_epochs=int(epochs), lr_born_machine=p["lr"],
                                 verbose=False, true_posterior_for_tvd=self.posterior,
                                 gradient_clip_norm=p["clip"], chunk_epochs=p["chunk_epochs"],
                                 **self.train_kwargs())

    def first_steps(self, steps: int) -> dict:
        """Train ``steps`` epochs and keep what the reference follows."""
        hist = self.train(steps)
        tracked = self.posterior is not None and np.isfinite(self.engine.best_tvd_)
        return {"losses": [float(v) for v in hist["loss_ksd"]],
                "grad_norms": [float(v) for v in hist["grad_norm"]],
                "theta_after": self.engine.params.detach().double().cpu().numpy(),
                "after_steps": int(self.engine.best_epoch_) + 1 if tracked else steps}

    def end_state(self) -> dict:
        """The parameters the window left and the program's q at them."""
        from tensornetworks_tpu_torch.engines.common import highest_matmul_precision

        params = self.engine.params.detach()
        with torch.no_grad(), highest_matmul_precision():
            q = self.engine.born_machine.probs(params).float()
        return {"theta_end": params.double().cpu().numpy(), "q_end": q.cpu().numpy()}

    def close(self):
        self.engine = None
