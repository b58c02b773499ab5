"""Work a sampled KSD epoch adds to the circuit's: the sampled estimator's
(M, M) Stein Gram over n bits.

The Gram's four (M, n) x (n, M) products (X X^T, S S^T, S X^T,
(S*X) X^T) are 8 M^2 n FLOPs; the scores' factor lookups and the
U-statistic's sums are not counted. Bytes: the (M, n) bits and scores
read once and the (M, M) Gram written once, as 4-byte floats.
"""

from __future__ import annotations

WORD = 4


def gram(num_samples: int, n: int) -> dict:
    M = num_samples
    return {"flops": float(8 * M * M * n), "bytes": float(WORD * (2 * M * n + M * M))}


def work(problem: dict) -> dict:
    return {"sampled": gram(problem["num_samples"], problem["n"])}
