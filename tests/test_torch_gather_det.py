"""The sampled engines' log-q gather and CDF scan, which give the same bits
on every run on the card. ``gather_2d`` indexes the flat view at ``r·C + c``:
its backward is held here against ``index_add_`` in float64 (exact sums of a
few terms agree to round-off: 1e-12 relative), with repeated indices, every
shot on one state and a single shot. ``blocked_cumsum`` (the scan the card
takes for a flat CDF) is held against float64's cumsum, with blocks small
enough to reach two and three levels of row totals and lengths that are no
multiple of the block; ``_cumsum`` on the CPU is torch.cumsum itself. The
replay on the card is checked there (chip_smoke.py: the scan and the gather
backward repeated bit for bit, sampled16 run twice)."""

import numpy as np
import pytest
import torch

from tensornetworks_tpu_torch.sim import sampling

F64 = torch.float64


def _shots(kind, R, C, M, rng):
    if kind == "repeated":
        r, c = rng.integers(0, 2, size=M), rng.integers(0, 3, size=M)  # few distinct states
    elif kind == "one_state":
        r, c = np.full(M, R - 1), np.full(M, 1)
    else:
        r, c = rng.integers(0, R, size=M), rng.integers(0, C, size=M)
    return torch.as_tensor(r), torch.as_tensor(c)


@pytest.mark.parametrize("kind, M", [("repeated", 257), ("one_state", 64), ("spread", 1),
                                     ("spread", 300), ("one_state", 1)])
def test_gather_2d_backward_is_index_add(kind, M):
    rng = np.random.default_rng(M)
    R, C = 8, 16
    P = torch.tensor(rng.random((R, C)), dtype=F64, requires_grad=True)
    r, c = _shots(kind, R, C, M, rng)
    g = torch.as_tensor(rng.normal(size=M), dtype=F64)
    out = sampling.gather_2d(P, r, c)
    torch.testing.assert_close(out, P.detach()[r, c], rtol=0, atol=0)
    (grad,) = torch.autograd.grad(out, P, g)
    want = torch.zeros(R * C, dtype=F64).index_add_(0, r * C + c, g).reshape(R, C)
    torch.testing.assert_close(grad, want, rtol=1e-12, atol=1e-12)


def test_gather_flat_sums_in_shot_order():
    """On the CPU a repeated index's cotangents are summed in the shots'
    order: with values whose float sum depends on the order, the result is
    the sequential sum over the shots that hit it."""
    P = torch.zeros((2, 2), dtype=torch.float32, requires_grad=True)
    r, c = torch.tensor([1, 0, 1, 1, 0]), torch.tensor([0, 0, 0, 0, 0])
    g = torch.tensor([1e8, 1.0, 1.0, -1e8, 3.0], dtype=torch.float32)
    (grad,) = torch.autograd.grad(sampling.gather_2d(P, r, c), P, g)
    seq = torch.zeros((), dtype=torch.float32)
    for v in (1e8, 1.0, -1e8):
        seq = seq + torch.tensor(v, dtype=torch.float32)
    assert float(grad[1, 0]) == float(seq)
    assert float(grad[0, 0]) == 4.0 and float(grad[0, 1]) == 0.0 and float(grad[1, 1]) == 0.0


@pytest.mark.parametrize("K, block", [(1, 4), (4, 4), (5, 4), (17, 4), (64, 4), (100, 4),
                                      (1000, 8), (4096, 16), (1 << 12, 1024), (1 << 16, 1024)])
def test_blocked_cumsum_is_the_prefix_sum(K, block):
    x = torch.as_tensor(np.random.default_rng(K).random(K), dtype=torch.float32)
    got = sampling.blocked_cumsum(x, block)
    assert got.shape == (K,) and got.dtype == torch.float32
    want = np.cumsum(x.double().numpy())
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6, atol=0)
    assert bool((got[1:] >= got[:-1]).all())  # non-negative terms: monotone, as searchsorted needs
    assert torch.equal(got, sampling.blocked_cumsum(x.clone(), block))


@pytest.mark.parametrize("shape", [(1,), (17,), (1, 33), (5, 33)])
def test_cdf_scan_on_cpu_is_torch_cumsum(shape):
    x = torch.as_tensor(np.random.default_rng(1).random(shape), dtype=torch.float32)
    assert torch.equal(sampling._cumsum(x), torch.cumsum(x, dim=-1))
