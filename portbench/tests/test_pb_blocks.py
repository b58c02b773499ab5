"""The reference held in 1, 2 and 4 blocks agrees with its one-block code
(``oneblock.py``) at 10 qubits: the state, q, the adjoint gradient, and
the sampled loss's shots, U-statistic and cotangent, to 1e-12 relative
(the state, q and the shots exactly; one block's gradient, loss and
cotangent bit for bit). With more than one block the gradient's inner
products are summed piece by piece, also with pieces smaller than a
block; one block is summed whole, as the one-block code sums it."""

import numpy as np
import pytest
import torch

from portbench.reference import circuit
from portbench.reference.circuit import Circuit
from portbench.reference.network import Network
from portbench.reference.sampled import Loss, two_stage_draws, ustat
from portbench.reference.stein import gram
from portbench.tests import oneblock

N, L, M = 10, 4, 64
CASES = [("hardware_efficient", ()),
         ("bn_structured", ((0, 1), (0, 5), (2, 9), (3, 4), (1, 9), (8, 2), (7, 6)))]


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("piece", [circuit.PIECE, 32])
@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("ansatz,edges", CASES)
def test_state_and_gradient_agree_with_the_one_block_code(ansatz, edges, blocks, piece,
                                                          monkeypatch):
    monkeypatch.setattr(circuit, "PIECE", piece)
    rng = np.random.default_rng(blocks)
    theta = rng.normal(size=3 * N * L)
    g = torch.as_tensor(rng.normal(size=1 << N))
    one = oneblock.Circuit(ansatz, N, L, edges)
    circ = Circuit(ansatz, N, L, edges, ["cpu"] * blocks)
    psi = circ.state(theta)
    assert len(psi) == blocks and {len(x) for x in psi} == {(1 << N) // blocks}
    assert torch.equal(torch.cat(psi), one.state(theta))
    assert torch.equal(torch.cat(circ.probs(theta)), one.probs(theta))
    grad = circ.grad(theta, list(g.chunk(blocks)), psi)
    want = one.grad(theta, g)
    assert np.abs(grad - want).max() <= 1e-12 * np.abs(want).max()
    if blocks == 1:
        assert np.array_equal(grad, want)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_sampled_loss_agrees_with_the_one_block_code(blocks):
    rng = np.random.default_rng(7)
    theta = 0.3 * rng.normal(size=3 * N * L)
    q1 = oneblock.Circuit("hardware_efficient", N, L).probs(theta)
    q = Circuit("hardware_efficient", N, L, (), ["cpu"] * blocks).probs(theta)
    gen = torch.Generator().manual_seed(blocks)
    state = gen.get_state()
    u_r = torch.rand(M, generator=gen, dtype=torch.float32)
    u_c = torch.rand(M, generator=gen, dtype=torch.float32)
    shots = oneblock.two_stage_draws(q1, u_r, u_c, N)
    assert torch.equal(two_stage_draws(q, u_r, u_c, N), shots)
    parents = [[]] + [[i - 1] for i in range(1, N + 1)]
    cpts = [np.array([[0.3, 0.7]])] + [np.array([[0.8, 0.2], [0.25, 0.75]])] * N
    net = Network(parents, cpts, N, {N: 1})
    problem = {"n": N, "length_scale": 1.0, "num_samples": M}
    loss_of = Loss(problem, {"gen_states": [state], "shots": [shots.numpy()]}, net, "cpu")
    loss, cot = loss_of(0, q)
    assert loss_of.numbers() == {"shots_mismatch": 0.0}
    Z = (shots[:, None] >> torch.arange(N - 1, -1, -1)) & 1
    lp = net.log_joint(shots)
    G = gram(torch.stack([net.score(shots, m, lp) for m in range(N)], dim=1), Z, N, 1.0)
    want_loss = float(ustat(G))
    want = oneblock.surrogate_cotangent(G, shots, q1)
    assert want_loss != 0.0 and abs(loss - want_loss) <= 1e-12 * abs(want_loss)
    assert len(cot) == blocks
    assert rel(torch.cat(cot), want) <= 1e-12
    if blocks == 1:
        assert torch.equal(cot[0], want) and loss == want_loss


def test_blocks_must_split_the_rows():
    q = Circuit("hardware_efficient", 3, 1, (), ["cpu"] * 8).probs(np.zeros(9))
    with pytest.raises(ValueError):
        two_stage_draws(q, torch.rand(4), torch.rand(4), 3)
