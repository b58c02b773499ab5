"""Work counts against hand counts at 2 and 3 qubits."""

import pytest

from portbench import counts
from portbench.counts import circuit, exact, sampled


def test_forward_by_hand():
    # n = 2, L = 1: two fused rotations, each 4 complex mult (6) + 2 complex
    # add (2) = 28 FLOPs per amplitude pair, 2 pairs: 56; |psi|^2: 3 x 4 = 12.
    assert circuit.forward("hardware_efficient", 2, 1) == {"flops": 2 * 56 + 12,
                                                            "bytes": 4 * (6 + 4)}
    # n = 3, L = 2: six rotations on 4 pairs each, 112 FLOPs apiece; 3 x 8.
    assert circuit.forward("bn_structured", 3, 2)["flops"] == 6 * 112 + 24


def test_backward_by_hand():
    # n = 2, L = 1: cotangent 2 x 4, un-compute and cotangent pass 2 x 2 x 56,
    # 6 parameters x one real inner product over 4 amplitudes (4 x 4).
    assert circuit.backward("hardware_efficient", 2, 1) == {"flops": 8 + 224 + 96,
                                                             "bytes": 4 * (4 + 6)}


def test_stein_and_gram_by_hand():
    # n = 2: 3 columns x 2 bits x 4 elements x 2 FLOPs; q, 2 scores, y read/written.
    assert exact.quadform(2) == {"flops": 48.0, "bytes": 4.0 * 4 * 4}
    # M = 4, n = 3: four (4 x 3) x (3 x 4) products of 2 x 4 x 4 x 3 FLOPs.
    assert sampled.gram(4, 3) == {"flops": 384.0, "bytes": 4.0 * (2 * 12 + 16)}


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_epoch_work_does_not_depend_on_the_backend(kind):
    base = {"kind": kind, "n": 3, "layers": 2, "ansatz": "hardware_efficient",
            "num_samples": 4}
    works = [counts.epoch_work({**base, "backend": b})
             for b in ("circuit2d", "circuit2d_grid", "blocked", "einsum")]
    assert all(w == works[0] for w in works)
    fwd, bwd = circuit.forward("hardware_efficient", 3, 2), circuit.backward(
        "hardware_efficient", 3, 2)
    assert works[0]["circuit"]["flops"] == fwd["flops"] + bwd["flops"]
    other = works[0]["stein" if kind == "exact" else "sampled"]
    assert works[0]["epoch"]["flops"] == works[0]["circuit"]["flops"] + other["flops"]
