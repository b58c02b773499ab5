"""The port's SPMD statevector primitives (``parallel/shard_state.py``,
``parallel/distributed_ansatz.py``) against the JAX package, after its
tests/test_shard_state.py.

One spawn of 4 gloo ranks on the CPU runs every case on two meshes of that
world: dp=1 (4 state shards, 2 global bits) and dp=2 (2 state shards, 1
global bit); the gathered results are held here, in float64/complex128,
against the JAX package's single-device functions on the same numpy inputs
(``apply_adjacent_block``, ``apply_cnot``, ``apply_cz``, ``kron_matvec``,
``ansatz_probs``): the JAX distributed primitives are pinned to those same
functions by the JAX tests, and compile more slowly than these run."""

import numpy as np
import jax.numpy as jnp
import pytest

from tensornetworks_tpu.ops import kron_matvec
from tensornetworks_tpu.ops.kron import apply_adjacent_block
from tensornetworks_tpu.sim import ansatz_probs, num_ansatz_params
from tensornetworks_tpu.sim.statevector import apply_cnot, apply_cz
from tensornetworks_tpu_torch.parallel import spawn

import torch_dist_ranks

# Every locality case on 2 global bits (wires 0-1 global, 2-5 local) and,
# on the dp=2 mesh, on 1: both global, control global, target global, both local.
CNOT_PAIRS = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 4), (0, 5), (4, 1), (5, 0), (3, 5), (5, 3)]
CZ_PAIRS = [(0, 1), (0, 4), (4, 0), (3, 5), (1, 2)]
ANSATZE = ("hardware_efficient", "basic", "all_to_all")
SHARDS = (4, 2)


def _complex(rng, size):
    return rng.normal(size=size) + 1j * rng.normal(size=size)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    a = float(np.exp(-1.0 / 9))
    inp = {"v7": _complex(rng, 2**7), "v6": _complex(rng, 2**6), "v9": rng.normal(size=2**9),
           "U": _complex(rng, (2, 2)), "A": np.array([[1.0, a], [a, 1.0]]),
           "cnot_pairs": CNOT_PAIRS, "cz_pairs": CZ_PAIRS,
           "ansatz_params": {name: rng.uniform(0, 2 * np.pi, num_ansatz_params(6, 2, name))
                             for name in ANSATZE}}
    out = spawn(torch_dist_ranks.shard_state_cases, 4, "gloo", "cpu", inp, timeout_s=120)
    return inp, out


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("qubit", range(7))
def test_distributed_1q_gate_all_positions(case, shards, qubit):
    inp, out = case
    want = np.asarray(apply_adjacent_block(jnp.asarray(inp["v7"]), jnp.asarray(inp["U"]), qubit,
                                           1, 7))
    np.testing.assert_allclose(out[f"1q/D{shards}/{qubit}"], want, atol=1e-12)


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_kron_matvec_matches(case, shards):
    inp, out = case
    want = np.asarray(kron_matvec(jnp.asarray(inp["v9"]), inp["A"], 9, group=3))
    np.testing.assert_allclose(out[f"kron/D{shards}"], want, rtol=1e-12)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("pair", CNOT_PAIRS)
def test_distributed_cnot_all_cases(case, shards, pair):
    inp, out = case
    c, t = pair
    want = np.asarray(apply_cnot(jnp.asarray(inp["v6"]).reshape((2,) * 6), c, t)).reshape(-1)
    np.testing.assert_allclose(out[f"cnot/D{shards}/{c},{t}"], want, atol=1e-12)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("pair", CZ_PAIRS)
def test_distributed_cz_all_cases(case, shards, pair):
    inp, out = case
    a, b = pair
    want = np.asarray(apply_cz(jnp.asarray(inp["v6"]).reshape((2,) * 6), a, b)).reshape(-1)
    np.testing.assert_allclose(out[f"cz/D{shards}/{a},{b}"], want, atol=1e-12)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("ansatz", ANSATZE)
def test_distributed_ansatz_matches_single_device(case, shards, ansatz):
    inp, out = case
    want = np.asarray(ansatz_probs(jnp.asarray(inp["ansatz_params"][ansatz]), 6, 2, ansatz,
                                   dtype=jnp.complex128))
    np.testing.assert_allclose(out[f"ansatz/D{shards}/{ansatz}"], want, atol=1e-10)
    assert out[f"shard_len/D{shards}/{ansatz}"] == 2**6 // shards
