"""Whole-circuit forward and adjoint backward: kernels 1-2 of the port.

Replaces ``tensornetworks_tpu/ops/pallas/circuit2d.py``
(``make_pallas_circuit2d_probs``: ``kernel``/``fwd_kernel`` and
``bwd_kernel``) with ``csrc/circuit2d.cu``: tiled FP32 complex GEMMs for the
rotations, each layer's CNOTs and CZs as one exact index map with a sign,
read per layer from a (2L, n) mask table. The fixed ansätze repeat one map;
``bn_structured`` alternates its edges' CNOTs (even layers) with their CZs
(odd layers), which the JAX package runs on XLA executors instead
(``sim/structured.py`` there).
The source notes there and in ``csrc/circuit2d_bwd.cuh`` give the design; in
short:

- Bound at n=16, L=4 (R=C=256): forward 1.07 GFLOP, backward 3.22 GFLOP of
  FP32 FMA (16 µs and 48 µs at the H100's 67 TFLOP/s); a few MB moved.
- A 512 KB state plane pair does not fit a block's shared memory, so the
  state lives in L2. Each direction is one persistent cooperative kernel
  (one block per SM) whose phases are separated by grid-wide barriers: the
  forward's closed-form first product, scatter products and left products;
  the backward's unpermute, column pull-back, row pull-back and operator
  gradients. Each wrapper raises if the device refuses the cooperative
  launch; there is no other path. ``circuit2d_forward_phased_plain`` and
  ``circuit2d_backward_phased_plain`` mirror the kernels' phases, buffers
  and K-split sums for the CPU tests.

Each wrapper takes the plain torch version (same algorithm: matmuls and the
same index maps) only for CPU tensors; a CUDA tensor launches the kernel or
raises. ``Circuit2dFunction`` ties the two directions together for autograd;
``circuit_operators`` folds θ into the per-layer operators ``Mr``/``Mc`` in
plain torch, so autograd carries ``dMr``/``dMc`` back to θ.

Precision (``precision.py``): a plan carries the kernel precision current
when it was built. ``highest`` runs the kernels' FP32 loops; ``high`` and
``default`` the forward's bf16 tensor-core passes inside its units
(``csrc/mma_bf16.cuh``) and the backward's bf16 kernel of
``csrc/circuit_bf16.cuh`` (operands split once into a bf16 scratch the
wrapper allocates, ``tn_circuit2d_scratch_bytes``; TMA copies, ``mma.sync``
passes), each variant launched and counted under its own key
(``circuit2d_fwd.high``). The backward's phase mirror is
``circuit2d_backward_bf16_phased_plain``, its launch plan ``bf16_plan``
(the library's ``tn_circuit2d_bwd_bf16_plan``, ``library_bf16_plan``).
The plain versions emulate a pass exactly: ``_pcmm`` rounds (or splits)
the real and imaginary planes of both operands of every complex product
and sums in the planes' dtype, with TF32 off on the card. The index maps
and CZ signs stay exact at every precision.

A conditioned circuit runs the same kernels on other operator planes: its
RY(angles) wall is folded into them before the launch (``sim.gates.
fold_wall``: ``Mr[0]·Er`` and ``Mc[0]·Ec`` for one wall, as the JAX package
folds it outside its Pallas kernel, or ``Mr[l]·Er_l`` for every layer when
re-uploading). The input stays |+⟩^n, so the forward's closed-form first
phase still holds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...sim.blocked import _chain_gates, _cnot_map, _cz_pairs
from ...sim.gates import fold_wall, rotation_operators
from ...sim.structured import check_edges
from ...train import span
from . import _lib
from .precision import (CODES, _kernel_precision, fp32_matmul, precision_name, round_bf16,
                        split_bf16)

MIN_QUBITS, MAX_QUBITS = 2, 17
# The ansätze that start from the Hadamard wall and take 3 angles a qubit.
WALL_ANSATZE = ("hardware_efficient", "all_to_all", "bn_structured")


def gf2_rows(n: int, gates) -> np.ndarray:
    """(n,) uint32 row masks of the CNOT sequence ``gates`` applied in order:
    bit k (LSB first) of the image of flat index i is ``parity(rows[k] & i)``."""

    def f(i):
        for c, t in gates:
            i = _cnot_map(i, n, c, t)
        return i

    images = [int(f(1 << j)) for j in range(n)]  # the map is linear over GF(2)
    return np.array([sum(((images[j] >> k) & 1) << j for j in range(n)) for k in range(n)],
                    dtype=np.uint32)


def cz_masks(n: int, pairs) -> np.ndarray:
    """(n,) uint32 masks of a sequence of CZ pairs: the sign at flat index d
    is ``(-1)^(Σ_k bit_k(d)·popcount(d & masks[k]))``. A pair listed twice
    cancels, as two CZs on one pair do."""
    m = np.zeros(n, dtype=np.uint32)
    for a, b in pairs:
        m[n - 1 - a] ^= np.uint32(1 << (n - 1 - b))
    return m


def layer_masks(n: int, layers: int, ansatz_type: str, edges=None, chain=None) -> tuple:
    """(rows (L, n), cz (L, n)) uint32: each layer's CNOT map (``gf2_rows``)
    and CZ masks (``cz_masks``), the tables both circuit plans give their
    kernels. ``bn_structured`` (needs ``edges``): the edges' CNOTs in order
    and no CZ on even layers, the identity map and a CZ on every edge on odd
    layers. The fixed ansätze: the CNOT sequence ``chain`` (by default their
    whole chain) on every layer, and each layer's own CZ pairs."""
    if ansatz_type == "bn_structured":
        if edges is None:
            raise ValueError("bn_structured needs edges (see sim.structured.latent_edges)")
        edges = check_edges(n, edges)
        even = (np.arange(layers) % 2 == 0)[:, None]
        return (np.where(even, gf2_rows(n, edges), gf2_rows(n, [])),
                np.where(even, cz_masks(n, []), cz_masks(n, edges)))
    if chain is None:
        chain = (_chain_gates(n, ansatz_type)
                 if ansatz_type in ("hardware_efficient", "basic") else [])
    return (np.tile(gf2_rows(n, chain), (layers, 1)),
            np.stack([cz_masks(n, _cz_pairs(n, layer, ansatz_type))
                      for layer in range(layers)]))


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Parity of the low 32 bits (n <= 30) of each entry, by XOR folding."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def cz_sign(d: torch.Tensor, cz) -> torch.Tensor:
    """The CZ sign (±1, int64) of the n masks ``cz`` at flat indices d
    (``csrc/layer_map.cuh`` ``perm_sign``)."""
    par = torch.zeros_like(d)
    for k, mask in enumerate(cz):
        if mask:
            par ^= ((d >> k) & 1) & _parity(d & int(mask))
    return 1 - 2 * par


def expand_maps(rows: np.ndarray, cz: np.ndarray, device, index=None) -> tuple:
    """(dst (2^n,) int64, sign (K, 2^n) float64) of n row masks and K rows of
    CZ masks: the map sends flat index i to dst[i], times sign[k, i]. With
    ``index`` (int64 array), the same at those flat indices only. Computed
    on ``device`` (n² bit-parity passes over 2^n indices: minutes on a host
    at n=24)."""
    n = len(rows)
    i = (torch.arange(1 << n, dtype=torch.int64, device=device) if index is None
         else torch.as_tensor(np.asarray(index, np.int64), device=device))
    dst = torch.zeros_like(i)
    for k in range(n):
        dst |= _parity(i & int(rows[k])) << k
    sign = torch.ones((len(cz), len(i)), dtype=torch.float64, device=device)
    for row in range(len(cz)):
        sign[row] = cz_sign(dst, cz[row])
    return dst, sign


def layer_tables(rows: np.ndarray, cz: np.ndarray, device) -> tuple:
    """(dst, sign) of per-layer masks ``rows`` and ``cz`` (L, n): layer l's
    map is ``layer_map(dst, sign, l)``. One shared (2^n,) ``dst`` where all
    layers' rows are equal; else (L, 2^n), each distinct layer expanded once
    (each layer's sign is taken at its own destination). ``sign`` is
    (L, 2^n)."""
    if (rows == rows[0]).all():
        return expand_maps(rows[0], cz, device)
    n = rows.shape[1]
    keys, inv = np.unique(np.concatenate([rows, cz], axis=1), axis=0, return_inverse=True)
    per = [expand_maps(k[:n], k[None, n:], device) for k in keys]
    inv = torch.as_tensor(inv.reshape(-1), device=device)
    return torch.stack([d for d, _ in per])[inv], torch.cat([s for _, s in per])[inv]


def layer_map(dst, sign, layer: int) -> tuple:
    """Layer ``layer``'s (dst (2^n,), sign (2^n,)) from ``layer_tables``."""
    return (dst if dst.dim() == 1 else dst[layer]), sign[layer]


class CircuitPlan:
    """Static structure of one (n, layers, ansatz) circuit.

    ``rows`` (L, n) are each layer's GF(2) row masks of its composite CNOT
    map, see ``gf2_rows``: for the fixed ansätze the same chain map on every
    layer (row chain, boundary, column chain, ring — in that order); for
    ``bn_structured`` the edges' CNOTs on even layers and the identity on odd
    ones (``layer_masks``, which needs ``edges``). ``cz`` (L, n) encode
    each layer's CZ pairs, see ``cz_masks``. The CUDA kernels receive exactly
    these masks; the plain path expands them into index tables.
    ``precision``: the kernel precision of its products (``precision.py``),
    by default the one current when the plan is built.
    """

    name = "circuit2d"

    def __init__(self, num_wires: int, layers: int, ansatz_type: str, edges=None,
                 precision=None):
        n = num_wires
        if not MIN_QUBITS <= n <= MAX_QUBITS:
            raise ValueError(f"circuit2d supports {MIN_QUBITS} <= n <= {MAX_QUBITS}, got {n}")
        if layers < 1:
            raise ValueError("circuit2d needs at least one layer")
        self.n, self.layers, self.ansatz_type = n, layers, ansatz_type
        self.rb = (n + 1) // 2
        self.cb = n - self.rb
        self.R, self.C = 1 << self.rb, 1 << self.cb
        self.per_qubit = 3 if ansatz_type in WALL_ANSATZE else 2
        self.has_wall = ansatz_type in WALL_ANSATZE
        self.rows, self.cz = layer_masks(n, layers, ansatz_type, edges)
        self.precision = precision_name(precision or _kernel_precision())
        self._tables = {}

    def device_masks(self, device) -> torch.Tensor:
        """(2L, n) int32 on ``device``, the table the persistent kernels
        read: row 2l holds layer l's row masks, row 2l + 1 its CZ masks."""
        key = ("masks", str(device))
        if key not in self._tables:
            masks = np.stack([self.rows, self.cz], axis=1).reshape(-1, self.n)
            self._tables[key] = torch.as_tensor(masks.view(np.int32), device=device)
        return self._tables[key]

    def tables(self, device) -> tuple:
        """(dst, sign) expanded from the masks (``layer_tables``): the forward
        sends flat index i of layer l to dst[i], times sign[l, i], with
        ``layer_map``. HE, all_to_all and basic share one (2^n,) dst."""
        key = ("tables", str(device))
        if key not in self._tables:
            self._tables[key] = layer_tables(self.rows, self.cz, device)
        return self._tables[key]


# ------------------------------------------------------------------ plain torch


def _cmm(a_re, a_im, b_re, b_im):
    """Complex product on planes."""
    return a_re @ b_re - a_im @ b_im, a_re @ b_im + a_im @ b_re


def _pcmm(a_re, a_im, b_re, b_im, precision: str = "highest", product=_cmm):
    """Complex product on planes at a kernel precision, as the kernels'
    passes make it: ``highest``, ``product`` itself; ``default``, ``product``
    of both operands' planes rounded to bf16; ``high``, the sum of the
    three passes lo·hi + hi·lo + hi·hi of their split planes. A product of
    two bf16 values is exact in FP32, so only the order of the sums differs
    from a kernel's. ``product`` is the complex product that sums (``_cmm``,
    or the units' K-split sum)."""
    if precision == "highest":
        return product(a_re, a_im, b_re, b_im)
    if precision == "default":
        return product(*map(round_bf16, (a_re, a_im, b_re, b_im)))
    (arh, arl), (aih, ail), (brh, brl), (bih, bil) = map(split_bf16, (a_re, a_im, b_re, b_im))
    out = [product(arl, ail, brh, bih), product(arh, aih, brl, bil),
           product(arh, aih, brh, bih)]
    return out[0][0] + out[1][0] + out[2][0], out[0][1] + out[1][1] + out[2][1]


def _initial_state(plan, dt, dev) -> tuple:
    """(xr, xi) of the circuit's input: the Hadamard wall's uniform
    amplitude 2^(-n/2), or |0...0⟩ without it."""
    R, C = plan.R, plan.C
    if plan.has_wall:
        xr = torch.full((R, C), 2.0 ** (-0.5 * plan.n), dtype=dt, device=dev)
    else:
        xr = torch.zeros((R, C), dtype=dt, device=dev)
        xr[0, 0] = 1.0
    return xr, torch.zeros((R, C), dtype=dt, device=dev)


def circuit2d_forward_plain(mr_re, mr_im, mc_re, mc_im, plan: CircuitPlan):
    """probs, xr, xi, each (R, C): the forward kernel's algorithm in torch,
    at the plan's precision."""
    R, C, dt, dev, p = plan.R, plan.C, mr_re.dtype, mr_re.device, plan.precision
    dst, sign = plan.tables(dev)
    xr, xi = _initial_state(plan, dt, dev)
    with fp32_matmul():
        for layer in range(plan.layers):
            tr, ti = _pcmm(mr_re[layer], mr_im[layer], xr, xi, p)
            zr, zi = _pcmm(tr, ti, mc_re[layer].T, mc_im[layer].T, p)
            d, s = layer_map(dst, sign, layer)
            s = s.to(dt)
            xr = torch.empty_like(zr).reshape(-1).index_put_((d,), s * zr.reshape(-1))
            xi = torch.empty_like(zi).reshape(-1).index_put_((d,), s * zi.reshape(-1))
            xr, xi = xr.reshape(R, C), xi.reshape(R, C)
    return xr * xr + xi * xi, xr, xi


def rotation_pullback(planes, mr_re, mr_im, mc_re, mc_im, precision: str = "highest"):
    """One layer's rotations X ← Mr X Mcᵀ, pulled back: ``planes`` (4, R, C)
    hold the state x and the cotangent λ after the rotations; returns both
    before them, with dMr = λ·xᴴ and dMc = λᵀ·conj(x) (each cotangent taken
    after its rotation, each state before it). Every product at ``precision``."""
    ar, ai, lr_, li = planes

    def cmm(*args):
        return _pcmm(*args, precision)

    # Right rotation X Mcᵀ: pull back with conj(Mc); grad λᵀ·conj(x_before).
    xb_r, xb_i = cmm(ar, ai, mc_re, -mc_im)
    lb_r, lb_i = cmm(lr_, li, mc_re, -mc_im)
    dmc = cmm(lr_.T, li.T, xb_r, -xb_i)
    # Left rotation Mr X: pull back with Mr†; grad λ·x_beforeᴴ.
    xa_r, xa_i = cmm(mr_re.T, -mr_im.T, xb_r, xb_i)
    la_r, la_i = cmm(mr_re.T, -mr_im.T, lb_r, lb_i)
    dmr = cmm(lb_r, lb_i, xa_r.T, -xa_i.T)
    return torch.stack([xa_r, xa_i, la_r, la_i]), dmr, dmc


def circuit2d_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: CircuitPlan):
    """dMr_re, dMr_im (L,R,R), dMc_re, dMc_im (L,C,C): the backward kernel's
    adjoint sweep in torch, at the plan's precision. The state is uncomputed
    through the inverse ops; it and the cotangent λ = 2·g·ψ pull back under
    the same operators."""
    R, C = plan.R, plan.C
    dst, sign = plan.tables(mr_re.device)
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    planes = torch.stack([xr, xi, 2.0 * g * xr, 2.0 * g * xi])  # x_re, x_im, l_re, l_im
    with fp32_matmul():
        for layer in range(plan.layers - 1, -1, -1):
            d, s = layer_map(dst, sign, layer)
            planes = (s.to(planes.dtype) * planes.reshape(4, -1)[:, d]).reshape(4, R, C)
            planes, (dmr_re[layer], dmr_im[layer]), (dmc_re[layer], dmc_im[layer]) = \
                rotation_pullback(planes, mr_re[layer], mr_im[layer], mc_re[layer],
                                  mc_im[layer], plan.precision)
    return dmr_re, dmr_im, dmc_re, dmc_im


# Tile arithmetic of the kernels, in torch/numpy for the CPU tests (nothing
# on the main path calls these).

# csrc/circuit_units.cuh: GROUPS, BK, TILE; csrc/circuit2d_fwd.cuh: TN
UNIT_KSPLIT, UNIT_BK, UNIT_M, FWD_UNIT_N = 4, 16, 32, 16


def _ksplit_cmm(a_re, a_im, b_re, b_im):
    """Complex product on planes, summed as the persistent kernels sum it:
    K cut into ``UNIT_KSPLIT`` ranges of whole ``UNIT_BK``-deep steps (the
    last ones may be empty), each range's partial product added in range
    order."""
    K = a_re.shape[-1]
    steps = -(-K // UNIT_BK)
    per = -(-steps // UNIT_KSPLIT) * UNIT_BK  # k of each range
    out_re = out_im = None
    for g in range(UNIT_KSPLIT):
        lo, hi = min(K, g * per), min(K, (g + 1) * per)
        pr, pi = _cmm(a_re[..., lo:hi], a_im[..., lo:hi], b_re[..., lo:hi, :], b_im[..., lo:hi, :])
        out_re, out_im = (pr, pi) if out_re is None else (out_re + pr, out_im + pi)
    return out_re, out_im


def forward_units(M: int, N: int) -> list:
    """The forward kernel's units of an (M, N) product, in unit order:
    (m0, m1, n0, n1) of each ``UNIT_M`` x ``FWD_UNIT_N`` output tile (ragged
    at the edges)."""
    return [(m0, min(M, m0 + UNIT_M), n0, min(N, n0 + FWD_UNIT_N))
            for m0 in range(0, M, UNIT_M) for n0 in range(0, N, FWD_UNIT_N)]


def _unit_cmm(a_re, a_im, b_re, b_im):
    """(M, K) x (K, N) complex product unit by unit, each unit's tile by the
    K-split sum."""
    M, N = a_re.shape[0], b_re.shape[1]
    out_re = a_re.new_full((M, N), float("nan"))
    out_im = out_re.clone()
    for m0, m1, n0, n1 in forward_units(M, N):
        out_re[m0:m1, n0:n1], out_im[m0:m1, n0:n1] = _ksplit_cmm(
            a_re[m0:m1], a_im[m0:m1], b_re[:, n0:n1], b_im[:, n0:n1])
    return out_re, out_im


def _wall_product(m, plan):
    """(R,) Mr[0]·X0 of one plane ``m`` of Mr[0] against the wall's uniform
    amplitude a = 2^(-n/2), as the forward kernel's first phase forms it at
    the plan's precision: a·Σ_k m_k (FP32); bf16(a)·Σ_k bf16(m_k)
    (``default``); a_hi·Σ_k (m_hi + m_lo) + a_lo·Σ_k m_hi (``high``, the
    three passes regrouped)."""
    if plan.precision == "highest":
        return 2.0 ** (-0.5 * plan.n) * m.sum(dim=1)
    amp = torch.tensor(2.0 ** (-0.5 * plan.n), dtype=torch.float32)
    if plan.precision == "default":
        return float(round_bf16(amp)) * round_bf16(m).sum(dim=1)
    (a_hi, a_lo), (m_hi, m_lo) = split_bf16(amp), split_bf16(m)
    return float(a_hi) * (m_hi + m_lo).sum(dim=1) + float(a_lo) * m_hi.sum(dim=1)


def circuit2d_forward_phased_plain(mr_re, mr_im, mc_re, mc_im, plan: CircuitPlan):
    """The persistent forward kernel's phase plan in torch: the buffers X
    (returned as xr, xi) and tmp (2, R, C), the closed-form first phase, and
    the same 32x16 units and K-split sums (``csrc/circuit2d_fwd.cuh``); the
    scatter product's store sends element (m, n) to ``dst[m·C + n]`` times
    the sign there. Each phase fills what it writes with NaN before it reads
    anything, so a phase that read what it writes — a race in the kernel —
    shows as NaN here. The products at the plan's precision (``_pcmm``).
    Returns what ``circuit2d_forward_plain`` returns."""
    R, C, L, dt, dev, p = plan.R, plan.C, plan.layers, mr_re.dtype, mr_re.device, plan.precision
    dst, sign = plan.tables(dev)
    tmp = torch.empty((2, R, C), dtype=dt, device=dev)
    xr, xi, probs = (torch.empty((R, C), dtype=dt, device=dev) for _ in range(3))
    # φ0: tmp = Mr[0]·X0 in closed form
    tmp.fill_(float("nan"))
    if plan.has_wall:  # X0 = 2^(-n/2)·𝟙: the row sums of Mr[0]
        for h, m in enumerate((mr_re[0], mr_im[0])):
            tmp[h] = _wall_product(m, plan)[:, None].expand(R, C)
    else:  # X0 = e00: column 0 of Mr[0] (1 is exact in bf16)
        tmp.zero_()
        col = [mr_re[0][:, 0], mr_im[0][:, 0]]
        if p == "default":
            col = [round_bf16(c) for c in col]
        elif p == "high":
            col = [sum(split_bf16(c)) for c in col]
        tmp[0, :, 0], tmp[1, :, 0] = col
    for layer in range(L):
        # φR(l): X = scatter(tmp·Mc[l]ᵀ), |z|² on the last layer
        last = layer == L - 1
        for t in (xr, xi, probs) if last else (xr, xi):
            t.fill_(float("nan"))
        zr, zi = _pcmm(tmp[0], tmp[1], mc_re[layer].T, mc_im[layer].T, p, _unit_cmm)
        d, s = layer_map(dst, sign, layer)
        s = s.to(dt)
        xr.reshape(-1)[d] = s * zr.reshape(-1)
        xi.reshape(-1)[d] = s * zi.reshape(-1)
        if last:
            probs.reshape(-1)[d] = (zr * zr + zi * zi).reshape(-1)
            break
        # φL(l+1): tmp = Mr[l+1]·X
        tmp.fill_(float("nan"))
        tmp[0], tmp[1] = _pcmm(mr_re[layer + 1], mr_im[layer + 1], xr, xi, p, _unit_cmm)
    return probs, xr, xi


def circuit2d_backward_phased_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: CircuitPlan):
    """The persistent backward kernel's phase plan in torch: the same four
    (4, R, C) buffers U[0], U[1], V, W of one scratch, the same phases and
    K-split sums (``csrc/circuit2d_bwd.cuh``). Each phase fills the buffers
    it writes with NaN before it reads anything, so a phase that read what
    it writes — a race in the kernel — shows as NaN here. The products at
    the plan's precision (``_pcmm``). Returns what
    ``circuit2d_backward_plain`` returns. Under ``high`` and ``default``
    the mirror is ``circuit2d_backward_bf16_phased_plain``'s."""
    if plan.precision != "highest":
        return circuit2d_backward_bf16_phased_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan)
    R, C, L, dt, dev = plan.R, plan.C, plan.layers, mr_re.dtype, mr_re.device

    def cmm(*args):
        return _pcmm(*args, plan.precision, _ksplit_cmm)

    dst, sign = plan.tables(dev)
    scratch = torch.empty((4, 4, R, C), dtype=dt, device=dev)
    U, V, W = (scratch[0], scratch[1]), scratch[2], scratch[3]
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)

    def grads(layer):  # dMr = λ_V·x_Wᴴ, dMc = λ_Uᵀ·conj(x_V)
        u = U[layer % 2]
        dmr_re[layer], dmr_im[layer] = cmm(V[2], V[3], W[0].T, -W[1].T)
        dmc_re[layer], dmc_im[layer] = cmm(u[2].T, u[3].T, V[0], -V[1])

    scratch.fill_(float("nan"))
    src = torch.stack([xr, xi, 2.0 * g * xr, 2.0 * g * xi])
    for layer in range(L - 1, -1, -1):
        u = U[layer % 2]
        # φ1: the previous layer's grads; undo the map and signs into U[l % 2]
        u.fill_(float("nan"))
        if layer < L - 1:
            grads(layer + 1)
        d, s = layer_map(dst, sign, layer)
        u.copy_((s.to(dt) * src.reshape(4, -1)[:, d]).reshape(4, R, C))
        # φ2: V = U·conj(Mc[l]), state (planes 0-1) and cotangent (2-3)
        V.fill_(float("nan"))
        for h in (0, 2):
            V[h], V[h + 1] = cmm(u[h], u[h + 1], mc_re[layer], -mc_im[layer])
        # φ3: W = Mr[l]ᴴ·V
        W.fill_(float("nan"))
        for h in (0, 2):
            W[h], W[h + 1] = cmm(mr_re[layer].T, -mr_im[layer].T, V[h], V[h + 1])
        src = W
    grads(0)
    return dmr_re, dmr_im, dmc_re, dmc_im


# csrc/circuit_bf16.cuh: the bf16 variants' backward kernel. A block's
# dynamic shared memory (227 KB less 8 KB for the static tables), the share
# sums' bytes, and the H100's SMs (the plan's default card: the kernel shares
# a phase's units out in sets of cs blocks, one block an SM).
BF16_SMEM_MAX = 232448 - 8192
BF16_RED_BYTES = 8 * 32 * 16 * 4
BF16_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(x: int) -> int:
    return _cdiv(x, 16) * 16


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def bf16_warp_tiles(tm: int, tn: int, nb: int) -> int:
    """16 x 16 warp tiles of a unit's (tm, tn) output tile of nb batches."""
    return nb * (tm // 16) * (tn // 16)


def bf16_k_shares(tiles: int) -> int:
    """Warps that share one warp tile's k16 steps (8 warps a block)."""
    return 8 // tiles


def bf16_plan(n: int, precision: str, sms: int = BF16_SMS) -> dict:
    """The launch plan of the bf16 backward kernel (``bwd_plan``) on a card
    of ``sms`` SMs: ``cs`` blocks a set (each a share of the rows in tiles
    of ``t1`` = 32 or 16 rows) and sms // cs sets; the ``items`` (column
    blocks of runs of 8 columns, ``t0`` columns wide: a power of two, at
    least 16) the sets share out; ``t2`` dMc's tile rows; the shared memory
    a block takes. ``library_bf16_plan`` reads the library's."""
    np_ = 2 if precision == "high" else 1
    rb = (n + 1) // 2
    cb = n - rb
    R, C = 1 << rb, 1 << cb
    kpr, kpc = _round16(R), _round16(C)
    cs = min(8, max(1, R // 32))  # every block of a set has row tiles
    tmc = 16 if R > 256 else 32
    groups = C // 8 if C >= 8 else 1
    spread = min(groups, sms // cs)
    e = 2 * np_ * 2
    for items, tnb in ((spread, max(16, 8 * _pow2_at_least(_cdiv(groups, spread)))),
                       (max(1, groups // 2), 16)):
        for tmb in (32, 16):
            ra = max(2 * e * tmb * kpc, e * kpr * tmb, e * 32 * kpc, e * kpr * tmc)
            rbb = max(e * kpc * tnb, 2 * e * kpr * tnb, e * 32 * kpc, e * kpr * 32)
            smem = ra + rbb + BF16_RED_BYTES
            if smem <= BF16_SMEM_MAX and tmb <= max(R, 16):
                return dict(cs=cs, items=items, t0=tnb, t1=tmb, t2=tmc, smem=smem)
    raise ValueError(f"no bf16 backward plan fits n={n}")


def library_bf16_plan(n: int, precision: str, sms: int) -> dict:
    """The plan the library launches the bf16 backward with on a card of
    ``sms`` SMs (``tn_circuit2d_bwd_bf16_plan``), in ``bf16_plan``'s keys;
    needs the built library (a card)."""
    out = (ctypes.c_longlong * 6)()
    err = _lib.load("circuit2d").tn_circuit2d_bwd_bf16_plan(n, CODES[precision], sms, out)
    if err:
        raise ValueError(f"circuit2d: no bf16 plan for {precision!r}")
    return dict(zip(("cs", "items", "t0", "t1", "t2", "smem"), out))


def _span(c: int, items: int, groups: int, q: int) -> int:
    return q * (groups * c // items)


def bf16_backward_units(n: int, precision: str, sms: int = BF16_SMS) -> dict:
    """The bf16 backward's units: ``pulls``, (item, rank, m0, m1, n0, n1) of
    the column and row pull-backs (item c's columns, rank's row tiles);
    ``dmr`` and ``dmc``, (m0, m1, n0, n1) of the gradient products."""
    p = bf16_plan(n, precision, sms)
    R, C = 1 << ((n + 1) // 2), 1 << (n // 2)
    groups, q = (C // 8, 8) if C >= 8 else (1, C)
    tmb, tmc = p["t1"], p["t2"]
    pulls = [(c, r, t * tmb, min(R, (t + 1) * tmb), _span(c, p["items"], groups, q),
              _span(c + 1, p["items"], groups, q))
             for c in range(p["items"]) for r in range(p["cs"])
             for t in range(r, _cdiv(R, tmb), p["cs"])]
    dmr = [(m, min(R, m + 32), c, min(R, c + 32)) for m in range(0, R, 32) for c in range(0, R, 32)]
    dmc = [(m, min(C, m + tmc), c, min(C, c + 32)) for m in range(0, C, tmc)
           for c in range(0, C, 32)]
    return dict(pulls=pulls, dmr=dmr, dmc=dmc)


def _split_planes(x, precision: str):
    """(hi, lo) of x as the kernels store it: split (``high``) or rounded
    with a zero lo (``default``)."""
    if precision == "high":
        return split_bf16(x)
    return round_bf16(x), torch.zeros_like(x)


def _bf16_cmm(a, b, precision: str, shares: int, ca: bool = False, cb: bool = False):
    """(re, im) of a complex product of split operands a, b (each (re_hi,
    re_lo, im_hi, im_lo), (M, K) and (K, N)) as a bf16 unit sums it: K
    padded to k16 steps; each step's passes (lo·hi + hi·lo + hi·hi under
    ``high``, hi·hi under ``default``) summed from zero; step s added to
    share s % shares; the shares added in share order. ca / cb conjugate."""
    K = a[0].shape[-1]
    pad = _round16(K) - K
    if pad:
        a = [torch.nn.functional.pad(t, (0, pad)) for t in a]
        b = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in b]

    def rp(x_hi, x_lo, y_hi, y_lo):
        if precision == "high":
            return x_lo @ y_hi + x_hi @ y_lo + x_hi @ y_hi
        return x_hi @ y_hi

    sre = -1.0 if ca == cb else 1.0
    sib, sia = (-1.0 if cb else 1.0), (-1.0 if ca else 1.0)
    acc = [None] * shares
    for s in range((K + pad) // 16):
        k = slice(16 * s, 16 * s + 16)
        ar_h, ar_l, ai_h, ai_l = (t[..., k] for t in a)
        br_h, br_l, bi_h, bi_l = (t[..., k, :] for t in b)
        re = rp(ar_h, ar_l, br_h, br_l) + sre * rp(ai_h, ai_l, bi_h, bi_l)
        im = sib * rp(ar_h, ar_l, bi_h, bi_l) + sia * rp(ai_h, ai_l, br_h, br_l)
        j = s % shares
        acc[j] = (re, im) if acc[j] is None else (acc[j][0] + re, acc[j][1] + im)
    out_re, out_im = acc[0]
    for j in range(1, shares):
        if acc[j] is not None:
            out_re, out_im = out_re + acc[j][0], out_im + acc[j][1]
    return out_re, out_im


class _PhaseLog:
    """The buffers of a phased mirror: each phase names the buffers it
    writes, which are filled with NaN before it reads anything, and the
    reads are recorded by phase (``reads``, ``writes``: phase name -> set of
    buffer names)."""

    def __init__(self):
        self.bufs, self.reads, self.writes, self.phase = {}, {}, {}, None

    def begin(self, name, writes):
        self.phase = name
        self.reads[name], self.writes[name] = set(), set(writes)
        for w in writes:
            self.bufs[w].fill_(float("nan"))

    def r(self, name):
        self.reads[self.phase].add(name)
        return self.bufs[name]

    def w(self, name):
        assert name in self.writes[self.phase], (self.phase, name)
        return self.bufs[name]


def circuit2d_backward_bf16_phased_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g,
                                         plan: CircuitPlan, sms: int = BF16_SMS, log=None):
    """The bf16 backward kernel (``csrc/circuit_bf16.cuh``) in torch: split
    state buffers U[0], U[1], V, W (planes x and λ, each (hi, lo) of re and
    im) and the split Mr, Mc; for l = L-1 .. 0 a phase φ1 (the split of Mr
    and Mc and the unpermute of x and 2·g·x on the first layer; else the
    previous layer's dMr, dMc and the unpermute of W's split planes, a sign
    flipping hi and lo), a phase of V = U·conj(Mc[l]) and one of W =
    Mr[l]ᴴ·V, each over the items (``bf16_backward_units``: column
    blocks); then dMr[0], dMc[0]. Products in the units' share order; each
    phase's outputs NaN before it runs, its reads recorded in ``log``.
    Returns what ``circuit2d_backward_plain`` returns."""
    n, R, C, L, p = plan.n, plan.R, plan.C, plan.layers, plan.precision
    dt, dev = mr_re.dtype, mr_re.device
    bp = bf16_plan(n, p, sms)
    units = bf16_backward_units(n, p, sms)
    pair_shares = bf16_k_shares(bf16_warp_tiles(bp["t1"], bp["t0"], 2))
    dmc_shares = bf16_k_shares(bf16_warp_tiles(bp["t2"], 32, 1))
    dst, sign = plan.tables(dev)
    log = log if log is not None else _PhaseLog()
    state = (8, R, C)  # (x_re, x_im, l_re, l_im) x (hi, lo)
    log.bufs = {"mr": torch.empty((4, L, R, R), dtype=dt, device=dev),
                "mc": torch.empty((4, L, C, C), dtype=dt, device=dev),
                "u0": torch.empty(state, dtype=dt, device=dev),
                "u1": torch.empty(state, dtype=dt, device=dev),
                "v": torch.empty(state, dtype=dt, device=dev),
                "w": torch.empty(state, dtype=dt, device=dev),
                **{f"dmr{i}": torch.empty((2, R, R), dtype=dt, device=dev) for i in range(L)},
                **{f"dmc{i}": torch.empty((2, C, C), dtype=dt, device=dev) for i in range(L)}}

    def put(t, re, im):
        t[0], t[1] = _split_planes(re, p)
        t[2], t[3] = _split_planes(im, p)

    def grads(layer):  # dMr = λ_V·x_Wᴴ, dMc = λ_Uᵀ·conj(x_V)
        v, w, u = log.r("v"), log.r("w"), log.r(f"u{layer % 2}")
        dmr, dmc = log.w(f"dmr{layer}"), log.w(f"dmc{layer}")
        dmr[0], dmr[1] = _bf16_cmm(v[4:], w[:4].transpose(-1, -2), p, 1, cb=True)
        dmc[0], dmc[1] = _bf16_cmm(u[4:].transpose(-1, -2), v[:4], p, dmc_shares, cb=True)

    items = sorted({(u[0], u[4], u[5]) for u in units["pulls"]})
    for layer in range(L - 1, -1, -1):
        first = layer == L - 1
        writes = (f"u{layer % 2}",) + (("mr", "mc") if first
                                        else (f"dmr{layer + 1}", f"dmc{layer + 1}"))
        log.begin(f"phi1_{layer}", writes)
        if first:
            put(log.w("mr"), mr_re, mr_im)
            put(log.w("mc"), mc_re, mc_im)
        else:
            grads(layer + 1)
        d, s = layer_map(dst, sign, layer)
        s = s.to(dt)
        u = log.w(f"u{layer % 2}")
        if first:  # the forward's output: x and λ = 2·g·x
            two_g = 2.0 * g.reshape(-1)[d]
            x_r, x_i = xr.reshape(-1)[d], xi.reshape(-1)[d]
            for q, v in enumerate((s * x_r, s * x_i, s * (two_g * x_r), s * (two_g * x_i))):
                hi, lo = _split_planes(v.reshape(R, C), p)
                u[2 * q], u[2 * q + 1] = hi, lo
        else:
            u.copy_((s * log.r("w").reshape(8, -1)[:, d]).reshape(state))
        def col_pull(n0, n1):  # V[:, n0:n1] = U·conj(Mc[l][:, n0:n1])
            uu, mc = log.r(f"u{layer % 2}"), log.r("mc")
            v = log.w("v")
            for b in (0, 4):  # state, cotangent
                vr, vi = _bf16_cmm(uu[b:b + 4], mc[:, layer, :, n0:n1], p, pair_shares, cb=True)
                put(v[b:b + 4, :, n0:n1], vr, vi)

        def row_pull(n0, n1):  # W[:, n0:n1] = Mr[l]ᴴ·V[:, n0:n1]
            vv, mr = log.r("v"), log.r("mr")
            w = log.w("w")
            for b in (0, 4):
                wr, wi = _bf16_cmm(mr[:, layer].transpose(-1, -2), vv[b:b + 4, :, n0:n1], p,
                                   pair_shares, ca=True)
                put(w[b:b + 4, :, n0:n1], wr, wi)

        log.begin(f"col{layer}", ("v",))
        for _, n0, n1 in items:
            col_pull(n0, n1)
        log.begin(f"row{layer}", ("w",))
        for _, n0, n1 in items:
            row_pull(n0, n1)
    log.begin("grads0", ("dmr0", "dmc0"))
    grads(0)
    dmr = torch.stack([log.bufs[f"dmr{i}"] for i in range(L)], dim=1)
    dmc = torch.stack([log.bufs[f"dmc{i}"] for i in range(L)], dim=1)
    return dmr[0], dmr[1], dmc[0], dmc[1]


def scatter_targets(rows, cz, m, n, N):
    """(d, sign) of the scatter epilogue at outputs (m, n) of an (M, N)
    product (int64 arrays of the same shape), evaluated as the large GEMM
    loop evaluates them: ``d = dst(m·N) ⊕ dst(n)`` — N is a power of two
    above n, so m·N + n = (m·N) | n, and the CNOT map is GF(2)-linear — and
    the CZ sign of the masks ``cz`` (n,) at d."""
    nbits = len(rows)

    def parity(x):
        p = np.zeros_like(x)
        for k in range(64):
            if not (x >> k).any():
                break
            p ^= (x >> k) & 1
        return p

    def dst(i):
        return sum(parity(int(rows[k]) & i) << k for k in range(nbits))

    d = dst(np.asarray(m, dtype=np.int64) * N) ^ dst(np.asarray(n, dtype=np.int64))
    par = np.zeros_like(d)
    for k in range(nbits):
        par ^= ((d >> k) & 1) & parity(d & int(cz[k]))
    return d, 1.0 - 2.0 * par


# --------------------------------------------------------------------- wrappers


def _check(plan, **tensors) -> None:
    shapes = {"mr": (plan.layers, plan.R, plan.R), "mc": (plan.layers, plan.C, plan.C),
              "x": (plan.R, plan.C)}
    dev = None
    for name, t in tensors.items():
        want = shapes[name.split("_")[0]]
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{plan.name} kernel: {name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if tuple(t.shape) != want:
            raise ValueError(f"{plan.name} kernel: {name} has shape {tuple(t.shape)}, "
                             f"want {want}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{plan.name} kernel: tensors on different devices")
        dev = t.device


def _scratch(plan: CircuitPlan, backward: bool, device) -> torch.Tensor:
    """The scratch of one launch, as large as the library says
    (``tn_circuit2d_scratch_bytes``, asked once a plan and direction): FP32
    planes, but for the backward under ``high`` and ``default``: the bf16
    split scratch of ``csrc/circuit_bf16.cuh`` (every layer's Mr and Mc
    split, and the state's splits)."""
    key = ("scratch_bytes", backward)
    if key not in plan._tables:
        nbytes = _lib.load(plan.name).tn_circuit2d_scratch_bytes(
            plan.n, plan.layers, int(backward), CODES[plan.precision])
        if nbytes < 0:
            raise ValueError(f"{plan.name} kernel: no scratch size for {plan.precision!r}")
        plan._tables[key] = nbytes
    return torch.empty(-(-plan._tables[key] // 4), dtype=torch.float32, device=device)


def launch_forward_persistent(plan: CircuitPlan, mr_re, mr_im, mc_re, mc_im):
    """probs, xr, xi from ``csrc/circuit2d.cu``'s forward: one cooperative
    launch, which raises if the device refuses it."""
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im)
    fn = _lib.load(plan.name).tn_circuit2d_forward
    probs = torch.empty((plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    xr, xi = torch.empty_like(probs), torch.empty_like(probs)
    tmp = _scratch(plan, backward=False, device=mr_re.device)
    masks = plan.device_masks(mr_re.device)
    _lib.count_launch(_lib.launch_key("circuit2d_fwd", plan.precision))
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(probs), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(tmp), _lib.ptr(masks),
             plan.n, plan.layers, int(plan.has_wall), CODES[plan.precision],
             _lib.stream_ptr(mr_re.device))
    _lib.check(err, "tn_circuit2d_forward (cooperative launch)")
    return probs, xr, xi


def launch_backward_persistent(plan: CircuitPlan, mr_re, mr_im, mc_re, mc_im, xr, xi, g):
    """dMr_re, dMr_im, dMc_re, dMc_im from ``csrc/circuit2d.cu``'s backward:
    one cooperative launch, which raises if the device refuses it."""
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im, x_r=xr, x_i=xi, x_g=g)
    fn = _lib.load(plan.name).tn_circuit2d_backward
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    scratch = _scratch(plan, backward=True, device=mr_re.device)
    masks = plan.device_masks(mr_re.device)
    _lib.count_launch(_lib.launch_key("circuit2d_bwd", plan.precision))
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(g),
             _lib.ptr(dmr_re), _lib.ptr(dmr_im), _lib.ptr(dmc_re), _lib.ptr(dmc_im),
             _lib.ptr(scratch), _lib.ptr(masks), plan.n, plan.layers, CODES[plan.precision],
             _lib.stream_ptr(mr_re.device))
    _lib.check(err, "tn_circuit2d_backward (cooperative launch)")
    return dmr_re, dmr_im, dmc_re, dmc_im


def circuit2d_forward(mr_re, mr_im, mc_re, mc_im, plan: CircuitPlan):
    """probs, xr, xi (R, C) of the circuit with per-layer operators Mr, Mc."""
    if mr_re.device.type == "cpu":
        return circuit2d_forward_plain(mr_re, mr_im, mc_re, mc_im, plan)
    return launch_forward_persistent(plan, mr_re, mr_im, mc_re, mc_im)


def circuit2d_backward(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: CircuitPlan):
    """dMr_re, dMr_im, dMc_re, dMc_im for the cotangent g of the probs."""
    if mr_re.device.type == "cpu":
        return circuit2d_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan)
    return launch_backward_persistent(plan, mr_re, mr_im, mc_re, mc_im, xr, xi, g)


class Circuit2dFunction(torch.autograd.Function):
    """probs (R, C) of the operator planes, with the adjoint-sweep backward."""

    @staticmethod
    def forward(ctx, mr_re, mr_im, mc_re, mc_im, plan: CircuitPlan):
        probs, xr, xi = circuit2d_forward(mr_re, mr_im, mc_re, mc_im, plan)
        ctx.plan = plan
        ctx.save_for_backward(mr_re, mr_im, mc_re, mc_im, xr, xi)
        return probs

    @staticmethod
    def backward(ctx, g):
        with span("circuit.backward"):
            mr_re, mr_im, mc_re, mc_im, xr, xi = ctx.saved_tensors
            grads = circuit2d_backward(mr_re, mr_im, mc_re, mc_im, xr, xi,
                                       g.contiguous(), ctx.plan)
            return (*grads, None)


def circuit_operators(params: torch.Tensor, plan, embed_angles=None,
                      reupload: bool = False) -> tuple:
    """(Mr, Mc): the complex per-layer operators of θ, with the conditioning
    wall of ``embed_angles`` folded in when given (``sim.gates.fold_wall``)."""
    Mr, Mc = rotation_operators(params, plan.n, plan.layers, plan.per_qubit)
    if embed_angles is None:
        return Mr, Mc
    return fold_wall(Mr, Mc, embed_angles, plan.n, reupload)


def make_probs_fn(plan, planes, function, forward, conditioning: bool, reupload: bool,
                  rotations=None, wall=None):
    """probs(params[, embed_angles]) of a circuit plan: ``rotations(params)``
    gives θ's operators (by default the complex Kronecker operators (Mr,
    Mc) of ``rotation_operators``), ``wall(ops, angles)`` folds a
    conditioning wall into them (by default ``fold_wall``), ``planes(*ops)``
    the tensors ``function`` (an autograd Function) takes, and ``function``
    the (R, C) probabilities. A conditioned function also has
    ``batch(params, angles_seq)``, (X, 2^n) for X walls: the θ fold once,
    then a wall fold and a launch for each. Every function has
    ``state(params[, embed_angles])``: the flat (2^n,) final state from
    ``forward``'s planes xr, xi — the state the forward kernel writes for the
    backward, in the index order of the probabilities — with no autograd
    graph."""
    if rotations is None:
        def rotations(params):
            return rotation_operators(params, plan.n, plan.layers, plan.per_qubit)

        def wall(ops, angles):
            return fold_wall(*ops, angles, plan.n, reupload)

    def operators(params, embed_angles):
        if conditioning and embed_angles is None:
            raise ValueError("conditioning=True requires embed_angles")
        ops = rotations(params)
        return wall(ops, embed_angles) if conditioning else ops

    def launch(ops):
        with span("circuit.forward"):  # the planes' gather and copies too
            return function.apply(*planes(*ops), plan).reshape(-1)

    def probs_fn(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        return launch(operators(params, embed_angles))

    def batch(params: torch.Tensor, angles_seq) -> torch.Tensor:
        ops = rotations(params)
        return torch.stack([launch(wall(ops, a)) for a in angles_seq])

    def state(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        with torch.no_grad():
            _, xr, xi = forward(*planes(*operators(params, embed_angles)), plan)
        return torch.complex(xr, xi).reshape(-1)

    if conditioning:
        probs_fn.batch = batch
    probs_fn.state = state
    return probs_fn


def make_circuit2d_probs_fn(num_wires: int, layers: int, ansatz_type: str, edges=None,
                            conditioning: bool = False, reupload: bool = False):
    """probs(params) -> (2^n,) through the circuit kernels (``edges`` for
    bn_structured); with ``conditioning``, probs(params, embed_angles), the
    wall folded into the operator planes (``reupload``: before every
    layer). ``probs.batch`` runs several walls on one θ fold;
    ``probs.state`` gives the final state from the forward kernel."""
    plan = CircuitPlan(num_wires, layers, ansatz_type, edges)

    def planes(Mr, Mc):
        return [t.contiguous() for t in (Mr.real, Mr.imag, Mc.real, Mc.imag)]

    return make_probs_fn(plan, planes, Circuit2dFunction, circuit2d_forward, conditioning,
                         reupload)
