"""The stein2d grid kernel's butterfly (``csrc/stein2d.cu``
``tn_stein2d_apply_grid``) through its torch mirror ``stein2d_butterfly_plain``,
which repeats the kernel's two-pass tile arithmetic (the offsets
``sub·2^lw + (t >> lw)·2^T + (t & (2^lw-1))`` and the low/high bit split).
The kernel itself runs only on the card, in chip_smoke.py; here small tile
sizes force both passes and every split at n ≤ 8.

Float64 on the CPU: the mirror against the dense two-sided apply to 1e-12
relative to the result's largest magnitude (summation order only), and,
with the operator's column build and recombination around it, against the
TPU grid kernel's matvec in interpret mode, which runs in float32: 1e-5
relative to the result's largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensornetworks_tpu.core import all_bitstrings as j_all_bitstrings
from tensornetworks_tpu.ops.kron import kron_power_np as j_kron_power_np
from tensornetworks_tpu.ops.pallas.stein2d import make_pallas_stein2d_matvec_grid
from tensornetworks_tpu_torch.ops import stein as tstein
from tensornetworks_tpu_torch.ops.hamming import decay_factor, resolve_length_scale
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import stein2d as tk
from tensornetworks_tpu_torch.runners import scale as tscale

F64 = torch.float64

# (n, tile_bits): pass 2 holds the n - T high bits and a run of 2^(2T - n)
# contiguous low indices; T = n/2 leaves a run of one element.
SPLITS = [(4, 2), (5, 3), (6, 3), (6, 4), (6, 5), (7, 4), (7, 5), (8, 4), (8, 5), (8, 7)]


def _close(a, b, rel):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * np.abs(b).max())


def _blocks(n, cols=5, seed=0):
    rb = (n + 1) // 2
    V = np.random.default_rng(seed).normal(size=(cols, 1 << rb, 1 << (n - rb)))
    return torch.as_tensor(V)


@pytest.mark.parametrize("n,tile_bits", SPLITS)
def test_butterfly_mirror_matches_dense_apply(n, tile_bits):
    a = 0.37
    V = _blocks(n, seed=n + tile_bits)
    _, R, C = V.shape
    Y = tk.stein2d_butterfly_plain(a, V, tile_bits)
    _close(Y, tk.stein2d_apply_plain(*tk.kron_factors(a, R, C, F64), V), rel=1e-12)
    # and the flat form the kernel computes: y_i = A^{⊗n} v_i
    K = j_kron_power_np(np.array([[1.0, a], [a, 1.0]]), n)
    _close(Y.reshape(V.shape[0], -1), V.reshape(V.shape[0], -1).numpy() @ K.T, rel=1e-12)


@pytest.mark.parametrize("n,tile_bits", [(6, 3), (7, 4), (8, 5)])
def test_butterfly_mirror_in_the_operator_matches_pallas_grid_kernel(n, tile_bits):
    """The 3n+1 column build and recombination the TPU kernel consumes
    (``stein_weight_tables``) around the butterfly against the TPU grid
    kernel's matvec."""
    bn, latent, obs = tscale.make_scale_problem(n, seed=0)
    S = tstein.score_table(bn.conditional_joint_table(latent, obs))
    q = np.random.default_rng(n).random(2**n)
    q /= q.sum()
    ls = resolve_length_scale("auto", n)
    mv = make_pallas_stein2d_matvec_grid(n, ls, interpret=True)
    y_j = mv(jnp.asarray(q), jnp.asarray(S), jnp.asarray(j_all_bitstrings(n).astype(np.float64)))
    Vw, W = (torch.as_tensor(t) for t in tstein.stein_weight_tables(S, n, ls))
    rb = (n + 1) // 2
    V = (Vw * torch.as_tensor(q)).reshape(-1, 1 << rb, 1 << (n - rb))
    Y = tk.stein2d_butterfly_plain(decay_factor(n, ls), V, tile_bits)
    _close((W * Y.reshape(W.shape)).sum(dim=0), y_j, rel=1e-5)


def test_butterfly_mirror_default_tiles_at_n18():
    """The kernel's own split: T = 13, pass 2 on runs of 2^8 at n = 18."""
    a = 0.9
    V = _blocks(18, cols=2, seed=18)
    _, R, C = V.shape
    _close(tk.stein2d_butterfly_plain(a, V),
           tk.stein2d_apply_plain(*tk.kron_factors(a, R, C, F64), V), rel=1e-12)


@pytest.mark.parametrize("n,tile_bits", [(4, 4), (4, 1), (8, 3)])
def test_butterfly_mirror_rejects_splits_it_cannot_tile(n, tile_bits):
    with pytest.raises(ValueError, match="tile_bits"):
        tk.stein2d_butterfly_plain(0.5, _blocks(n), tile_bits)


def test_grid_wrapper_on_cpu_is_the_dense_plain_version():
    a, V = 0.6, _blocks(7)
    _, R, C = V.shape
    before = dict(_lib.LAUNCHES)
    Y = tk.stein2d_apply_grid(a, V)
    assert _lib.LAUNCHES == before  # CPU tensors never reach a kernel
    Ar, Ac = tk.kron_factors(a, R, C, F64)
    assert torch.equal(Y, tk.stein2d_apply_plain(Ar, Ac, V))
    np.testing.assert_array_equal(Ar.numpy(), j_kron_power_np(np.array([[1.0, a], [a, 1.0]]), 4))


@pytest.mark.parametrize("shape,dtype,match", [
    ((3, 512, 512), torch.float64, "float32"),
    ((3, 64, 64), torch.float32, "log2"),           # n = 12: below one tile
    ((1, 8192, 4096), torch.float32, "log2"),       # n = 25: pass 2 runs too short
    ((3, 384, 512), torch.float32, "powers of two"),
    ((512, 512), torch.float32, "cols, R, C"),
])
def test_grid_wrapper_argument_checks(shape, dtype, match):
    V = torch.empty(shape, dtype=dtype, device="meta")  # shapes only, no memory
    with pytest.raises(ValueError, match=match):
        tk._check_grid(V)


def test_grid_wrapper_argument_checks_take_the_kernel_shapes():
    assert tk._check_grid(torch.empty((2, 512, 512))) == 18
    assert tk._check_grid(torch.empty((2, 1024, 512))) == 19
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_grid(torch.empty((2, 512, 1024)).transpose(1, 2))
