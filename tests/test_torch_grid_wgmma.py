"""The plain versions of the grid kernels' Hopper bf16 loop
(``csrc/wgmma_bf16.cuh``): the split of an operand plane into bf16 planes,
the extended-K form of a complex product at ``high`` and ``default``, the
six product patterns of the grid launchers.

The split must be JAX's bf16 cast and the cast of the exact remainder, bit
for bit, signs included. The extended-K product sums the same bf16
products as ``circuit2d._pcmm`` in another order, so the two agree to FP32
round-off: 1e-6 of the largest magnitude at K ≤ 64. The grid plain
versions themselves stay held against the JAX kernel in
tests/test_torch_circuit_grid.py and tests/test_torch_precision.py; the
CUDA loop runs only on the card (chip_smoke.py, step 16)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensornetworks_tpu_torch.ops.kernels import circuit2d as kc
from tensornetworks_tpu_torch.ops.kernels import circuit2d_grid as kg
from tensornetworks_tpu_torch.ops.kernels import precision as kp

PRECISIONS = ("high", "default")
PATTERNS = tuple(kg.PRODUCT_PATTERNS)


def _jax_bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _values() -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(size=4096), rng.normal(size=512) * 1e-30,
                           rng.normal(size=512) * 1e30, [0.0, -0.0, 1.0, -1.0]]
                          ).astype(np.float32)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("sign", (1.0, -1.0))
def test_split_is_jax_cast_and_remainder(precision, sign):
    x = sign * _values()
    planes = kg.split_planes_plain(torch.as_tensor(x), precision)
    hi = _jax_bf16(x)
    want = (hi,) if precision == "default" else (hi, _jax_bf16(x - hi))
    assert len(planes) == len(want)
    for got, ref in zip(planes, want):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))
    # the split of a negated plane is the negated split
    neg = kg.split_planes_plain(torch.as_tensor(-x), precision)
    for a, b in zip(neg, planes):
        np.testing.assert_array_equal(a.numpy(), -b.numpy())


def _pcmm_case(case, precision):
    """The case's product by ``circuit2d._pcmm`` on the conjugated operands,
    through the case's epilogue."""
    ar, ai, br, bi = kg._case_operands(case)
    if case["conj"] & 1:
        ai = -ai
    if case["conj"] & 2:
        bi = -bi
    with kp.fp32_matmul():
        re, im = kc._pcmm(ar, ai, br, bi, precision)
    return kg._case_epilogue(case, re, im)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_extended_k_product_is_pcmm(pattern, precision):
    case = kg.product_case(pattern, 11, "cpu", seed=3)  # R = 64, C = 32
    got, got_probs = kg.grid_product_plain(case, precision)
    want, want_probs = _pcmm_case(case, precision)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    if pattern == "scatter":
        assert float((got_probs - want_probs).abs().max()) <= 1e-6 * float(want_probs.max())
    # and within the precision's distance of the exact complex product
    exact, _ = kg.grid_product_plain(case, "highest", dtype=torch.float64)
    limit = 1e-4 if precision == "high" else 2e-2
    assert float((got.double() - exact).abs().max()) <= limit * float(exact.abs().max())


@pytest.mark.parametrize("pattern", PATTERNS)
def test_product_case_strides_read_the_launchers_operands(pattern):
    """The cases read what circuit_layers.cuh's products read: each output
    equals the plain complex product of the named planes."""
    n = 7
    R, C = 1 << (n + 1) // 2, 1 << n // 2
    S = R * C
    case = kg.product_case(pattern, n, "cpu", seed=1)
    a, b = case["a"].double(), case["b"].double()
    c, probs = kg.grid_product_plain(case, "highest", dtype=torch.float64)
    if pattern == "col":  # A = B conj(Mc), x and lambda
        for i in (0, 2):
            want = torch.complex(a[i], a[i + 1]) @ torch.complex(b[0], b[1]).conj()
            torch.testing.assert_close(torch.complex(c[i], c[i + 1]), want)
    elif pattern == "row":  # B = Mr^H A
        for i in (0, 2):
            want = torch.complex(a[0], a[1]).conj().T @ torch.complex(b[i], b[i + 1])
            torch.testing.assert_close(torch.complex(c[i], c[i + 1]), want)
    elif pattern == "dmc":  # lambda^T conj(x)
        want = torch.complex(a[2], a[3]).T @ torch.complex(b[0], b[1]).conj()
        torch.testing.assert_close(torch.complex(c[0], c[1]), want)
    elif pattern == "dmr":  # lambda x^H
        want = torch.complex(a[2], a[3]) @ torch.complex(b[0], b[1]).conj().T
        torch.testing.assert_close(torch.complex(c[0], c[1]), want)
    elif pattern == "left":  # Mr X
        want = torch.complex(a[0], a[1]) @ torch.complex(b[0], b[1])
        torch.testing.assert_close(torch.complex(c[0], c[1]), want)
    else:  # X = perm/sign(tmp Mc^T), |X|^2
        prod = (torch.complex(a[0], a[1]) @ torch.complex(b[0], b[1]).T).reshape(-1)
        dst, sign = kc.expand_maps(case["rows"], case["cz"][None], "cpu")
        want = torch.zeros(S, dtype=torch.complex128)
        want[dst] = sign[0] * prod
        torch.testing.assert_close(torch.complex(c[0], c[1]).reshape(-1), want)
        torch.testing.assert_close(probs, want.abs() ** 2)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_grid_product_on_cpu_is_the_plain_version(precision):
    case = kg.product_case("col", 8, "cpu", seed=2)
    got, _ = kg.grid_product(case, precision)
    want, _ = kg.grid_product_plain(case, precision)
    assert torch.equal(got, want)
