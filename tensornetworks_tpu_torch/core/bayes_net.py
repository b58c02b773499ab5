"""Binary Bayesian networks compiled to dense joint-probability tables.

Counterpart of ``tensornetworks_tpu/core/bayes_net.py``, re-housed so that
nothing here imports JAX. The network is compiled once into a dense
``(2^N,)`` float64 joint table ``p(v)``; the conditional joint ``p(x, z)``
and the exact posterior are axis reductions of that table. Host numpy: the
tables are built once per observation and shipped to the device by the
callers.

The random factories draw from ``np.random.default_rng`` in the same order as
the JAX package, so the same seed gives the same network in both.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .bits import all_bitstrings, bits_to_index, generate_all_binary_outcomes

CPTDict = Dict[tuple, Dict[int, float]]
CPT = Union[CPTDict, Callable[[tuple], Dict[int, float]]]


class BayesianNetwork:
    """A Bayesian network over binary variables with tabular CPTs.

    Nodes are added parents-first (topological order). CPTs are dicts mapping
    parent-value tuples to ``{0: p0, 1: p1}`` or callables with the same
    contract; callables are densified at add time.
    """

    def __init__(self):
        self.nodes: List[str] = []
        self.parents: Dict[str, List[str]] = {}
        self.cpts: Dict[str, CPT] = {}
        self.node_to_index: Dict[str, int] = {}
        # Dense CPT per node: (2^k, 2) float64, row = MSB-first parent index.
        self._cpt_arrays: Dict[str, np.ndarray] = {}
        self._joint_cache: Optional[np.ndarray] = None

    def add_node(self, name: str, cpt: CPT, parent_names: Optional[Sequence[str]] = None):
        """Add a node with its CPT. Parents must already exist and every CPT
        row must sum to 1."""
        if name in self.nodes:
            raise ValueError(f"Node {name} already exists.")
        parent_names = list(parent_names) if parent_names else []
        for p in parent_names:
            if p not in self.nodes:
                raise ValueError(f"Parent node {p} for {name} not found. Add parents first.")

        k = len(parent_names)
        table = np.zeros((2**k, 2), dtype=np.float64)
        for r, parent_bits in enumerate(all_bitstrings(k)):
            key = tuple(int(b) for b in parent_bits)
            prob_dict = cpt(key) if callable(cpt) else cpt.get(key)
            if prob_dict is None:
                raise ValueError(
                    f"CPT entry for node {name} with parent values {key} not found."
                )
            if not isinstance(prob_dict, dict) or 0 not in prob_dict or 1 not in prob_dict:
                raise ValueError(
                    f"CPT for {name} with parent values {key} must return a dict {{0: p0, 1: p1}}"
                )
            if not np.isclose(prob_dict[0] + prob_dict[1], 1.0):
                raise ValueError(
                    f"Probabilities for node {name} given parents {key} do not sum to 1: {prob_dict}"
                )
            table[r, 0] = prob_dict[0]
            table[r, 1] = prob_dict[1]

        self.nodes.append(name)
        self.node_to_index[name] = len(self.nodes) - 1
        self.parents[name] = parent_names
        self.cpts[name] = cpt
        self._cpt_arrays[name] = table
        self._joint_cache = None

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    def joint_table(self) -> np.ndarray:
        """Dense joint ``p(v)`` over all ``2^N`` assignments, float64, index
        MSB-first in ``self.nodes`` order."""
        if self._joint_cache is not None:
            return self._joint_cache
        n = self.num_nodes
        p = np.ones((2,) * n, dtype=np.float64)
        for name in self.nodes:
            # The CPT as a factor over (parents MSB-first, own value), its
            # axes moved to their nodes' positions and broadcast over the rest.
            axes = [self.node_to_index[q] for q in self.parents[name]] + [self.node_to_index[name]]
            factor = self._cpt_arrays[name].reshape((2,) * len(axes))
            shape = [1] * n
            for a in axes:
                shape[a] = 2
            p *= np.transpose(factor, np.argsort(axes)).reshape(shape)
        self._joint_cache = p.reshape(-1)
        return self._joint_cache

    def log_joint_table(self, floor: float = 1e-300) -> np.ndarray:
        """``log p(v)``, the table floored at ``floor`` so that zeros stay finite."""
        return np.log(np.maximum(self.joint_table(), floor))

    def get_joint_probability(self, full_assignment_tuple: Sequence[int]) -> float:
        """P(V = full assignment), the values in ``self.nodes`` order."""
        if len(full_assignment_tuple) != self.num_nodes:
            raise ValueError("Full assignment tuple length must match the number of nodes.")
        return float(self.joint_table()[int(bits_to_index(np.asarray(full_assignment_tuple)))])

    def marginal_table(self, var_names: Sequence[str]) -> np.ndarray:
        """p(var_names) as a ``(2^k,)`` vector, MSB-first in the given order."""
        positions = [self.node_to_index[v] for v in var_names]
        other = tuple(i for i in range(self.num_nodes) if i not in positions)
        t = self.joint_table().reshape((2,) * self.num_nodes)
        if other:
            t = t.sum(axis=other)
        # The remaining axes are in node order; permute to the caller's.
        remaining = sorted(positions)
        return np.transpose(t, [remaining.index(p) for p in positions]).reshape(-1)

    def get_prior_distribution(self, var_names_ordered: Sequence[str]) -> Dict[tuple, float]:
        """Prior ``p(vars)`` as a dict keyed by assignment tuples; warns when it
        does not sum to 1."""
        vec = self.marginal_table(var_names_ordered)
        if not np.isclose(vec.sum(), 1.0):
            print(f"Warning: Prior probabilities for {list(var_names_ordered)} sum to "
                  f"{vec.sum()}, not 1.0.")
        outcomes = generate_all_binary_outcomes(len(var_names_ordered))
        return {k: float(vec[i]) for i, k in enumerate(outcomes)}

    def conditional_joint_table(
        self, latent_names: Sequence[str], observed_dict: Dict[str, int]
    ) -> np.ndarray:
        """``t[z] = p(x_obs, z)`` over all latent assignments, marginalizing
        any other variables."""
        for v in latent_names:
            if v not in self.node_to_index:
                raise ValueError(f"Latent variable {v} not in the network.")
        for v in observed_dict:
            if v not in self.node_to_index:
                raise ValueError(f"Observed variable {v} not in the network.")
        if set(latent_names) & set(observed_dict):
            raise ValueError("Latent and observed variables must be disjoint.")

        t = self.joint_table().reshape((2,) * self.num_nodes)
        slicer = [slice(None)] * self.num_nodes
        for v, val in observed_dict.items():
            slicer[self.node_to_index[v]] = int(val)
        t = t[tuple(slicer)]
        # Remaining axes correspond to non-observed nodes in position order.
        remaining = [i for i in range(self.num_nodes) if self.nodes[i] not in observed_dict]
        latent_pos = [self.node_to_index[v] for v in latent_names]
        other_axes = [remaining.index(i) for i in remaining if i not in latent_pos]
        if other_axes:
            t = t.sum(axis=tuple(other_axes))
            remaining = [i for i in remaining if i in latent_pos]
        perm = [remaining.index(p) for p in latent_pos]
        return np.transpose(t, perm).reshape(-1)

    def get_true_posterior(
        self, latent_vars_names: Sequence[str], observed_vars_dict: Dict[str, int]
    ) -> Tuple[Dict[tuple, float], float]:
        """Exact posterior ``P(latent | observed)`` as a dict keyed by latent
        tuples, and ``P(observed)``."""
        unnorm = self.conditional_joint_table(latent_vars_names, observed_vars_dict)
        p_obs = float(unnorm.sum())
        outcomes = generate_all_binary_outcomes(len(latent_vars_names))
        if p_obs == 0:
            print(
                f"Warning: P(Observed) is zero for evidence {observed_vars_dict}. "
                "Posterior is ill-defined."
            )
            return {k: 0.0 for k in outcomes}, 0.0
        post = unnorm / p_obs
        return {k: float(post[i]) for i, k in enumerate(outcomes)}, p_obs

    def posterior_vector(
        self, latent_vars_names: Sequence[str], observed_vars_dict: Dict[str, int]
    ) -> np.ndarray:
        """Exact posterior as a dense ``(2^n,)`` float64 vector."""
        unnorm = self.conditional_joint_table(latent_vars_names, observed_vars_dict)
        s = unnorm.sum()
        return unnorm / s if s > 0 else np.zeros_like(unnorm)


    def sample_forward(self, num_samples: int = 1, seed: Optional[int] = None):
        """Ancestral sampling of ``num_samples`` full assignments, all at once
        with ``np.random.default_rng(seed)`` (one uniform per sample per node,
        in node order: the JAX package's draws). Returns (list of dicts, list
        of tuples)."""
        rng = np.random.default_rng(seed)
        n = self.num_nodes
        vals = np.zeros((num_samples, n), dtype=np.int64)
        for name in self.nodes:  # parents first
            pos = self.node_to_index[name]
            parent_pos = [self.node_to_index[q] for q in self.parents[name]]
            k = len(parent_pos)
            parent_idx = np.zeros(num_samples, dtype=np.int64)
            for j, pp in enumerate(parent_pos):
                parent_idx |= vals[:, pp] << (k - 1 - j)
            p1 = self._cpt_arrays[name][parent_idx, 1]
            vals[:, pos] = (rng.random(num_samples) < p1).astype(np.int64)
        dicts = [{self.nodes[j]: int(v[j]) for j in range(n)} for v in vals]
        tuples = [tuple(int(b) for b in v) for v in vals]
        return dicts, tuples

    def likelihood_weighted_marginals(
        self, latent_vars_names: Sequence[str], observed_vars_dict: Dict[str, int],
        num_samples: int = 1_000_000, seed: int = 0,
    ) -> Dict[str, float]:
        """Posterior single-variable marginals ``P(z_i = 1 | x)`` by likelihood
        weighting: ancestral sampling with the evidence clamped, each sample
        weighted by ``Π p(x_j | parents)``. Consistent at any network size,
        so it is the quality target where the dense ``2^n`` posterior cannot
        be built. The dict also holds the effective sample size under
        ``"__ess__"`` (the Monte-Carlo error is about ``1/sqrt(ESS)``)."""
        rng = np.random.default_rng(seed)
        m = num_samples
        vals = np.zeros((m, self.num_nodes), dtype=np.int8)
        logw = np.zeros(m, dtype=np.float64)
        for name in self.nodes:  # parents first
            pos = self.node_to_index[name]
            parent_pos = [self.node_to_index[q] for q in self.parents[name]]
            k = len(parent_pos)
            parent_idx = np.zeros(m, dtype=np.int64)
            for j, pp in enumerate(parent_pos):
                parent_idx |= vals[:, pp].astype(np.int64) << (k - 1 - j)
            p1 = self._cpt_arrays[name][parent_idx, 1]
            if name in observed_vars_dict:
                v = int(observed_vars_dict[name])
                vals[:, pos] = v
                logw += np.log(np.clip(p1 if v == 1 else 1.0 - p1, 1e-300, None))
            else:
                vals[:, pos] = rng.random(m) < p1
        w = np.exp(logw - logw.max())
        w /= w.sum()
        out = {nm: float(w @ (vals[:, self.node_to_index[nm]] == 1)) for nm in latent_vars_names}
        out["__ess__"] = float(1.0 / np.square(w).sum())
        return out


def get_sprinkler_network(random_cpts: bool = False, seed: Optional[int] = None) -> BayesianNetwork:
    """The textbook Sprinkler network C -> {S, R} -> W (``random_cpts`` draws
    each P from U(0.01, 0.99))."""
    bn = BayesianNetwork()
    if random_cpts:
        rng = np.random.default_rng(seed)

        def rp():
            return float(rng.uniform(0.01, 0.99))

        p_c = rp()
        bn.add_node("C", cpt={(): {0: 1 - p_c, 1: p_c}})
        p_s0, p_s1 = rp(), rp()
        bn.add_node(
            "S",
            cpt={(0,): {0: 1 - p_s0, 1: p_s0}, (1,): {0: 1 - p_s1, 1: p_s1}},
            parent_names=["C"],
        )
        p_r0, p_r1 = rp(), rp()
        bn.add_node(
            "R",
            cpt={(0,): {0: 1 - p_r0, 1: p_r0}, (1,): {0: 1 - p_r1, 1: p_r1}},
            parent_names=["C"],
        )
        p00, p01, p10, p11 = rp(), rp(), rp(), rp()
        bn.add_node(
            "W",
            cpt={
                (0, 0): {0: 1 - p00, 1: p00},
                (0, 1): {0: 1 - p01, 1: p01},
                (1, 0): {0: 1 - p10, 1: p10},
                (1, 1): {0: 1 - p11, 1: p11},
            },
            parent_names=["S", "R"],
        )
    else:
        bn.add_node("C", cpt={(): {0: 0.5, 1: 0.5}})
        bn.add_node(
            "S",
            cpt={(0,): {0: 0.5, 1: 0.5}, (1,): {0: 0.9, 1: 0.1}},
            parent_names=["C"],
        )
        bn.add_node(
            "R",
            cpt={(0,): {0: 0.8, 1: 0.2}, (1,): {0: 0.2, 1: 0.8}},
            parent_names=["C"],
        )
        bn.add_node(
            "W",
            cpt={
                (0, 0): {0: 0.99, 1: 0.01},
                (0, 1): {0: 0.1, 1: 0.9},
                (1, 0): {0: 0.1, 1: 0.9},
                (1, 1): {0: 0.01, 1: 0.99},
            },
            parent_names=["S", "R"],
        )
    return bn


def get_random_chain_network(
    num_vars: int, seed: int = 0, num_observed: int = 1, max_parents: int = 2
) -> BayesianNetwork:
    """Random DAG over ``num_vars`` binary variables for scaling experiments.

    Node ``i`` picks up to ``max_parents`` parents uniformly among earlier
    nodes; CPT entries are drawn from U(0.05, 0.95). The last
    ``num_observed`` nodes are conventionally the observed ones.
    """
    rng = np.random.default_rng(seed)
    bn = BayesianNetwork()
    names = [f"V{i}" for i in range(num_vars)]
    for i, name in enumerate(names):
        k = int(min(i, rng.integers(0, max_parents + 1)))
        parents = list(rng.choice(names[:i], size=k, replace=False)) if k else []
        cpt = {}
        for row in all_bitstrings(k):
            p1 = float(rng.uniform(0.05, 0.95))
            cpt[tuple(int(b) for b in row)] = {0: 1 - p1, 1: p1}
        bn.add_node(name, cpt=cpt, parent_names=parents)
    return bn
