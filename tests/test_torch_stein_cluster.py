"""The n <= 17 stein2d kernel's cluster butterfly (``csrc/stein2d.cu``
``tn_stein2d_apply``) through its torch mirror ``stein2d_cluster_plain``,
which repeats the kernel's split: contiguous tiles of 2^T floats with the
stages of their local bits, several whole columns per tile below n = T, and
above it a cluster of 2^(n-T) tiles per column whose rank r takes slice r of
the local indices for the high stages. The kernel itself runs only on the
card, in chip_smoke.py; here small tile sizes reach every case at n <= 9.

Float64 on the CPU: the mirror against the dense two-sided apply to 1e-12
relative to the result's largest magnitude (summation order only), and,
with the operator's column build and recombination around it, against the
TPU kernel's matvec in interpret mode, which runs in float32: 1e-5 relative
to the result's largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensornetworks_tpu.core import all_bitstrings as j_all_bitstrings
from tensornetworks_tpu.ops.kron import kron_power_np as j_kron_power_np
from tensornetworks_tpu.ops.pallas.stein2d import make_pallas_stein2d_matvec
from tensornetworks_tpu_torch.ops import stein as tstein
from tensornetworks_tpu_torch.ops.kernels import _lib
from tensornetworks_tpu_torch.ops.kernels import stein2d as tk
from tensornetworks_tpu_torch.runners import scale as tscale

F64 = torch.float64

# (n, tile_bits, cols): several columns per tile, with a short last tile
# (n < T), one column per tile (n = T), clusters of 2, 4 and 8 (n = T + 1..3).
SPLITS = [(1, 4, 3), (1, 3, 4), (2, 4, 5), (3, 4, 7), (3, 5, 2), (4, 4, 3), (5, 4, 3),
          (6, 4, 5), (7, 4, 2), (6, 5, 3), (8, 5, 4), (9, 6, 3), (7, 7, 2)]


def _close(a, b, rel):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=rel * np.abs(b).max())


def _blocks(n, cols, seed=0):
    rb = (n + 1) // 2
    V = np.random.default_rng(seed).normal(size=(cols, 1 << rb, 1 << (n - rb)))
    return torch.as_tensor(V)


@pytest.mark.parametrize("n,tile_bits,cols", SPLITS)
def test_cluster_mirror_matches_dense_apply(n, tile_bits, cols):
    a = 0.41
    V = _blocks(n, cols, seed=10 * n + tile_bits)
    _, R, C = V.shape
    Y = tk.stein2d_cluster_plain(a, V, tile_bits)
    _close(Y, tk.stein2d_apply_plain(*tk.kron_factors(a, R, C, F64), V), rel=1e-12)
    # and the flat form the kernel computes: y_i = A^{⊗n} v_i
    K = j_kron_power_np(np.array([[1.0, a], [a, 1.0]]), n)
    _close(Y.reshape(cols, -1), V.reshape(cols, -1).numpy() @ K.T, rel=1e-12)


@pytest.mark.parametrize("n", [13, 15])
def test_cluster_mirror_default_tiles(n):
    """The kernel's own split: T = 14, one short tile at n = 13, clusters of
    two at n = 15."""
    a = 0.93
    V = _blocks(n, cols=3, seed=n)
    _, R, C = V.shape
    _close(tk.stein2d_cluster_plain(a, V),
           tk.stein2d_apply_plain(*tk.kron_factors(a, R, C, F64), V), rel=1e-12)


@pytest.mark.parametrize("n,tile_bits", [(8, 4), (6, 2)])
def test_cluster_mirror_rejects_clusters_above_eight(n, tile_bits):
    with pytest.raises(ValueError, match="tile_bits"):
        tk.stein2d_cluster_plain(0.5, _blocks(n, 2), tile_bits)


@pytest.mark.parametrize("n,tile_bits", [(6, 4), (13, 11)])
def test_cluster_mirror_in_the_operator_matches_pallas_kernel(n, tile_bits):
    """The operator's column build and recombination around the mirror (a
    cluster of four tiles) against the TPU kernel's matvec."""
    bn, latent, obs = tscale.make_scale_problem(n, seed=0)
    S = tstein.score_table(bn.conditional_joint_table(latent, obs))
    q = np.random.default_rng(n).random(2**n)
    q /= q.sum()
    mv = make_pallas_stein2d_matvec(n, 1.0, interpret=True)
    y_j = mv(jnp.asarray(q), jnp.asarray(S), jnp.asarray(j_all_bitstrings(n).astype(np.float64)))
    op = tstein.SteinOperator(S, n, 1.0, dtype=F64, dense=False, device="cpu")
    V = (op._Vw * torch.as_tensor(q)).reshape(-1, op._R, op._C)
    Y = tk.stein2d_cluster_plain(op._a, V, tile_bits)
    _close((op._W * Y.reshape(op._W.shape)).sum(dim=0), y_j, rel=1e-5)


def test_wrapper_on_cpu_is_the_dense_plain_version():
    a, V = 0.6, _blocks(5, 4)
    _, R, C = V.shape
    before = dict(_lib.LAUNCHES)
    Y = tk.stein2d_apply(a, V)
    assert _lib.LAUNCHES == before  # CPU tensors never reach a kernel
    assert torch.equal(Y, tk.stein2d_apply_plain(*tk.kron_factors(a, R, C, F64), V))


def test_operator_passes_the_decay_factor_alone():
    n = 13
    op = tstein.SteinOperator(np.zeros((2**n, n)), n, 0.7, dtype=F64, device="cpu")
    assert not op.dense and not op._grid
    assert not hasattr(op, "_Ar") and not hasattr(op, "_Ac")


@pytest.mark.parametrize("shape,dtype,match", [
    ((3, 256, 256), torch.float64, "float32"),
    ((3, 512, 512), torch.float32, "log2"),          # n = 18: the grid kernel's
    ((3, 1, 1), torch.float32, "log2"),              # n = 0
    ((3, 96, 64), torch.float32, "powers of two"),
    ((256, 256), torch.float32, "cols, R, C"),
])
def test_wrapper_argument_checks(shape, dtype, match):
    V = torch.empty(shape, dtype=dtype, device="meta")  # shapes only, no memory
    with pytest.raises(ValueError, match=match):
        tk._check_cluster(V)


def test_wrapper_argument_checks_take_the_kernel_shapes():
    assert tk._check_cluster(torch.empty((2, 2, 1))) == 1
    assert tk._check_cluster(torch.empty((2, 256, 256))) == 16
    assert tk._check_cluster(torch.empty((2, 512, 256))) == 17
    with pytest.raises(ValueError, match="contiguous"):
        tk._check_cluster(torch.empty((2, 256, 512)).transpose(1, 2))
    with pytest.raises(ValueError, match="aligned"):
        tk._check_cluster(torch.empty(2 * 64 + 1)[1:].reshape(2, 8, 8))
