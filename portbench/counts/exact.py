"""Work an exact KSD epoch adds to the circuit's: the Stein quadratic form
q^T K_p q over 2^n states.

K_p q needs the base kernel K = A^(kron n) on n+1 columns, q and s_m * q
(PERF.md's count of the stein2d kernels): per column and per bit, 2 FLOPs
per element, so 2 (n+1) n 2^n FLOPs. Bytes: q and the n score columns
read once, K_p q written once, as 4-byte floats.
"""

from __future__ import annotations

WORD = 4


def quadform(n: int) -> dict:
    size = 1 << n
    return {"flops": float(2 * (n + 1) * n * size), "bytes": float(WORD * (n + 2) * size)}


def work(problem: dict) -> dict:
    return {"stein": quadform(problem["n"])}
