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

A conditioned circuit runs the same kernels on other operator planes: its
RY(angles) wall is folded into them before the launch (``sim.gates.
fold_wall``: ``Mr[0]·Er`` and ``Mc[0]·Ec`` for one wall, as the JAX package
folds it outside its Pallas kernel, or ``Mr[l]·Er_l`` for every layer when
re-uploading). The input stays |+⟩^n, so the forward's closed-form first
phase still holds.
"""

from __future__ import annotations

import numpy as np
import torch

from ...sim.blocked import _chain_gates, _cnot_map, _cz_pairs
from ...sim.gates import fold_wall, rotation_operators
from ...sim.structured import check_edges
from . import _lib

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


def expand_maps(rows: np.ndarray, cz: np.ndarray, device, index=None) -> tuple:
    """(dst (2^n,) int64, sign (K, 2^n) float64) of n row masks and K rows of
    CZ masks: the map sends flat index i to dst[i], times sign[k, i]. With
    ``index`` (int64 array), the same at those flat indices only. Computed
    on ``device`` (n² bit-parity passes over 2^n indices: minutes on a host
    at n=24)."""
    n = len(rows)
    i = (torch.arange(1 << n, dtype=torch.int64, device=device) if index is None
         else torch.as_tensor(np.asarray(index, np.int64), device=device))

    def parity(x):  # of the low 32 bits (n <= 30), by XOR folding
        for shift in (16, 8, 4, 2, 1):
            x = x ^ (x >> shift)
        return x & 1

    dst = torch.zeros_like(i)
    for k in range(n):
        dst |= parity(i & int(rows[k])) << k
    sign = torch.ones((len(cz), len(i)), dtype=torch.float64, device=device)
    for row in range(len(cz)):
        par = torch.zeros_like(i)
        for k in range(n):
            par ^= ((dst >> k) & 1) & parity(dst & int(cz[row, k]))
        sign[row] = 1.0 - 2.0 * par
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
    """

    name = "circuit2d"

    def __init__(self, num_wires: int, layers: int, ansatz_type: str, edges=None):
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


def circuit2d_forward_plain(mr_re, mr_im, mc_re, mc_im, plan: CircuitPlan):
    """probs, xr, xi, each (R, C): the forward kernel's algorithm in torch."""
    R, C, dt, dev = plan.R, plan.C, mr_re.dtype, mr_re.device
    dst, sign = plan.tables(dev)
    if plan.has_wall:
        xr = torch.full((R, C), 2.0 ** (-0.5 * plan.n), dtype=dt, device=dev)
    else:
        xr = torch.zeros((R, C), dtype=dt, device=dev)
        xr[0, 0] = 1.0
    xi = torch.zeros((R, C), dtype=dt, device=dev)
    for layer in range(plan.layers):
        tr, ti = _cmm(mr_re[layer], mr_im[layer], xr, xi)
        zr, zi = _cmm(tr, ti, mc_re[layer].T, mc_im[layer].T)
        d, s = layer_map(dst, sign, layer)
        s = s.to(dt)
        xr = torch.empty_like(zr).reshape(-1).index_put_((d,), s * zr.reshape(-1)).reshape(R, C)
        xi = torch.empty_like(zi).reshape(-1).index_put_((d,), s * zi.reshape(-1)).reshape(R, C)
    return xr * xr + xi * xi, xr, xi


def rotation_pullback(planes, mr_re, mr_im, mc_re, mc_im):
    """One layer's rotations X ← Mr X Mcᵀ, pulled back: ``planes`` (4, R, C)
    hold the state x and the cotangent λ after the rotations; returns both
    before them, with dMr = λ·xᴴ and dMc = λᵀ·conj(x) (each cotangent taken
    after its rotation, each state before it)."""
    ar, ai, lr_, li = planes
    # Right rotation X Mcᵀ: pull back with conj(Mc); grad λᵀ·conj(x_before).
    xb_r, xb_i = _cmm(ar, ai, mc_re, -mc_im)
    lb_r, lb_i = _cmm(lr_, li, mc_re, -mc_im)
    dmc = _cmm(lr_.T, li.T, xb_r, -xb_i)
    # Left rotation Mr X: pull back with Mr†; grad λ·x_beforeᴴ.
    xa_r, xa_i = _cmm(mr_re.T, -mr_im.T, xb_r, xb_i)
    la_r, la_i = _cmm(mr_re.T, -mr_im.T, lb_r, lb_i)
    dmr = _cmm(lb_r, lb_i, xa_r.T, -xa_i.T)
    return torch.stack([xa_r, xa_i, la_r, la_i]), dmr, dmc


def circuit2d_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: CircuitPlan):
    """dMr_re, dMr_im (L,R,R), dMc_re, dMc_im (L,C,C): the backward kernel's
    adjoint sweep in torch. The state is uncomputed through the inverse ops;
    it and the cotangent λ = 2·g·ψ pull back under the same operators."""
    R, C = plan.R, plan.C
    dst, sign = plan.tables(mr_re.device)
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    planes = torch.stack([xr, xi, 2.0 * g * xr, 2.0 * g * xi])  # x_re, x_im, l_re, l_im
    for layer in range(plan.layers - 1, -1, -1):
        d, s = layer_map(dst, sign, layer)
        planes = (s.to(planes.dtype) * planes.reshape(4, -1)[:, d]).reshape(4, R, C)
        planes, (dmr_re[layer], dmr_im[layer]), (dmc_re[layer], dmc_im[layer]) = \
            rotation_pullback(planes, mr_re[layer], mr_im[layer], mc_re[layer], mc_im[layer])
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


def circuit2d_forward_phased_plain(mr_re, mr_im, mc_re, mc_im, plan: CircuitPlan):
    """The persistent forward kernel's phase plan in torch: the buffers X
    (returned as xr, xi) and tmp (2, R, C), the closed-form first phase, and
    the same 32x16 units and K-split sums (``csrc/circuit2d_fwd.cuh``); the
    scatter product's store sends element (m, n) to ``dst[m·C + n]`` times
    the sign there. Each phase fills what it writes with NaN before it reads
    anything, so a phase that read what it writes — a race in the kernel —
    shows as NaN here. Returns what ``circuit2d_forward_plain`` returns."""
    R, C, L, dt, dev = plan.R, plan.C, plan.layers, mr_re.dtype, mr_re.device
    dst, sign = plan.tables(dev)
    tmp = torch.empty((2, R, C), dtype=dt, device=dev)
    xr, xi, probs = (torch.empty((R, C), dtype=dt, device=dev) for _ in range(3))
    # φ0: tmp = Mr[0]·X0 in closed form
    tmp.fill_(float("nan"))
    if plan.has_wall:  # X0 = 2^(-n/2)·𝟙: the row sums of Mr[0]
        for h, m in enumerate((mr_re[0], mr_im[0])):
            tmp[h] = (2.0 ** (-0.5 * plan.n) * m.sum(dim=1))[:, None].expand(R, C)
    else:  # X0 = e00: column 0 of Mr[0]
        tmp.zero_()
        tmp[0, :, 0], tmp[1, :, 0] = mr_re[0][:, 0], mr_im[0][:, 0]
    for layer in range(L):
        # φR(l): X = scatter(tmp·Mc[l]ᵀ), |z|² on the last layer
        last = layer == L - 1
        for t in (xr, xi, probs) if last else (xr, xi):
            t.fill_(float("nan"))
        zr, zi = _unit_cmm(tmp[0], tmp[1], mc_re[layer].T, mc_im[layer].T)
        d, s = layer_map(dst, sign, layer)
        s = s.to(dt)
        xr.reshape(-1)[d] = s * zr.reshape(-1)
        xi.reshape(-1)[d] = s * zi.reshape(-1)
        if last:
            probs.reshape(-1)[d] = (zr * zr + zi * zi).reshape(-1)
            break
        # φL(l+1): tmp = Mr[l+1]·X
        tmp.fill_(float("nan"))
        tmp[0], tmp[1] = _unit_cmm(mr_re[layer + 1], mr_im[layer + 1], xr, xi)
    return probs, xr, xi


def circuit2d_backward_phased_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: CircuitPlan):
    """The persistent backward kernel's phase plan in torch: the same four
    (4, R, C) buffers U[0], U[1], V, W of one scratch, the same phases and
    K-split sums (``csrc/circuit2d_bwd.cuh``). Each phase fills the buffers
    it writes with NaN before it reads anything, so a phase that read what
    it writes — a race in the kernel — shows as NaN here. Returns what
    ``circuit2d_backward_plain`` returns."""
    R, C, L, dt, dev = plan.R, plan.C, plan.layers, mr_re.dtype, mr_re.device
    dst, sign = plan.tables(dev)
    scratch = torch.empty((4, 4, R, C), dtype=dt, device=dev)
    U, V, W = (scratch[0], scratch[1]), scratch[2], scratch[3]
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)

    def grads(layer):  # dMr = λ_V·x_Wᴴ, dMc = λ_Uᵀ·conj(x_V)
        u = U[layer % 2]
        dmr_re[layer], dmr_im[layer] = _ksplit_cmm(V[2], V[3], W[0].T, -W[1].T)
        dmc_re[layer], dmc_im[layer] = _ksplit_cmm(u[2].T, u[3].T, V[0], -V[1])

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
            V[h], V[h + 1] = _ksplit_cmm(u[h], u[h + 1], mc_re[layer], -mc_im[layer])
        # φ3: W = Mr[l]ᴴ·V
        W.fill_(float("nan"))
        for h in (0, 2):
            W[h], W[h + 1] = _ksplit_cmm(mr_re[layer].T, -mr_im[layer].T, V[h], V[h + 1])
        src = W
    grads(0)
    return dmr_re, dmr_im, dmc_re, dmc_im


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


def launch_forward_persistent(plan: CircuitPlan, mr_re, mr_im, mc_re, mc_im):
    """probs, xr, xi from ``csrc/circuit2d.cu``'s forward: one cooperative
    launch, which raises if the device refuses it."""
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im)
    fn = _lib.load(plan.name).tn_circuit2d_forward
    probs = torch.empty((plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    xr, xi = torch.empty_like(probs), torch.empty_like(probs)
    tmp = torch.empty((2, plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    masks = plan.device_masks(mr_re.device)
    _lib.count_launch("circuit2d_fwd")
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(probs), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(tmp), _lib.ptr(masks),
             plan.n, plan.layers, int(plan.has_wall), _lib.stream_ptr(mr_re.device))
    _lib.check(err, "tn_circuit2d_forward (cooperative launch)")
    return probs, xr, xi


def launch_backward_persistent(plan: CircuitPlan, mr_re, mr_im, mc_re, mc_im, xr, xi, g):
    """dMr_re, dMr_im, dMc_re, dMc_im from ``csrc/circuit2d.cu``'s backward:
    one cooperative launch, which raises if the device refuses it."""
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im, x_r=xr, x_i=xi, x_g=g)
    fn = _lib.load(plan.name).tn_circuit2d_backward
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    scratch = torch.empty((4, 4, plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    masks = plan.device_masks(mr_re.device)
    _lib.count_launch("circuit2d_bwd")
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(g),
             _lib.ptr(dmr_re), _lib.ptr(dmr_im), _lib.ptr(dmc_re), _lib.ptr(dmc_im),
             _lib.ptr(scratch), _lib.ptr(masks), plan.n, plan.layers,
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


def make_probs_fn(plan, planes, function, forward, conditioning: bool, reupload: bool):
    """probs(params[, embed_angles]) of a circuit plan: ``planes(Mr, Mc)``
    gives the operator planes of the complex operators, ``function`` (an
    autograd Function) the (R, C) probabilities of the planes. A
    conditioned function also has ``batch(params, angles_seq)``, (X, 2^n)
    for X walls: the θ fold once, then a wall fold and a launch for each.
    Every function has ``state(params[, embed_angles])``: the flat (2^n,)
    final state from ``forward``'s planes xr, xi — the state the forward
    kernel writes for the backward, in the index order of the
    probabilities — with no autograd graph."""

    def launch(Mr, Mc):
        return function.apply(*planes(Mr, Mc), plan).reshape(-1)

    def probs_fn(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        if conditioning and embed_angles is None:
            raise ValueError("conditioning=True requires embed_angles")
        return launch(*circuit_operators(params, plan, embed_angles if conditioning else None,
                                         reupload))

    def batch(params: torch.Tensor, angles_seq) -> torch.Tensor:
        M = rotation_operators(params, plan.n, plan.layers, plan.per_qubit)
        return torch.stack([launch(*fold_wall(*M, a, plan.n, reupload)) for a in angles_seq])

    def state(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        if conditioning and embed_angles is None:
            raise ValueError("conditioning=True requires embed_angles")
        with torch.no_grad():
            M = circuit_operators(params, plan, embed_angles if conditioning else None, reupload)
            _, xr, xi = forward(*planes(*M), plan)
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
