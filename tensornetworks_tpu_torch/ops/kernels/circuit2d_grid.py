"""Grid-over-layers circuit forward and adjoint backward for n ≥ 18:
kernels 5-6 of the port.

Replaces ``tensornetworks_tpu/ops/pallas/circuit2d_grid.py``
(``make_pallas_circuit2d_grid_probs``: ``fwd_kernel`` and ``bwd_kernel``)
with ``csrc/circuit2d_grid.cu`` and its per-layer host drivers
(``csrc/circuit_layers.cuh``, which serve these kernels alone). The source
note there gives the design; in short:

- Bound at n=20, L=4 (R=C=1024): forward 6.9e10, backward 2.1e11 FLOP of
  FP32 FMA (1.03 ms and 3.08 ms at the H100's 67 TFLOP/s).
- The row-chain permutation is folded into the streamed operator, as on the
  TPU (``P_row·Mr``), here as a row gather. The boundary CNOT, the column
  chain and the ring CNOT, which the TPU ran as dense one-dot W forms,
  compose into one exact GF(2) index map applied with the CZ sign in the
  right GEMM's epilogue, read per layer with the layer's CZ masks.
- ``bn_structured`` folds nothing into Mr: its index maps alternate (the DAG
  edges' CNOTs on even layers, the identity on odd ones), and the same
  epilogue applies them, since it takes any GF(2)-linear map.
- A conditioned circuit's wall is folded into the rotation operators first
  (``circuit2d.circuit_operators``) and the row gather taken after, so the
  streamed operator is ``P_row·(Mr·Er)``: the wall acts before the
  rotations, the row chain after them, as in the JAX grid builder.

``GridPlan`` holds both forms of that structure: the masks the CUDA kernels
take, and the TPU kernel's own banks (``P_col``, the W matrices, the CZ
masks) for the plain version. ``circuit2d_grid_forward_plain`` /
``circuit2d_grid_backward_plain`` transcribe the TPU grid kernel's algebra,
a different algorithm from the CUDA kernels' index map, so that holding one
against the other on the card is a real check. The W forms exist only for
the chain, so for ``bn_structured`` the plain version is the index-map form
of ``circuit2d.py``, and the independent check is the oracle
``sim/structured.make_structured_probs_fn``. Each wrapper takes the plain
version only for CPU tensors; a CUDA tensor launches the kernel or raises.

Valid range: any 2 ≤ n ≤ ``MAX_QUBITS`` when the backend is named (the CPU
tests run it small); the ``auto`` backend takes it from ``AUTO_MIN_QUBITS``
= 18. ``MAX_QUBITS`` = 24 is set by memory: the (L, R, R) and (L, C, C)
operator planes and their gradients grow 4x per two qubits. At n=24, L=4
they are 4 planes × 4 layers × 64 MB = 1 GB each way, with the complex
Kronecker fold and its autograd about as much again; at n=26 that becomes
~16 GB and one forward ~3.5e13 dense FLOPs. (The kernels' 32-bit flat
indices would hold to n=30.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...sim.blocked import _chain_gates, _cnot_map, _cz_pairs
from ...sim.blocked2d import _cz_sign_mask, _kron_h, _perm_matrix
from . import _lib
from .circuit2d import (WALL_ANSATZE, _check, _cmm, circuit2d_backward_plain,
                        circuit2d_forward_plain, circuit_operators, layer_masks,
                        layer_tables, make_probs_fn, rotation_pullback)

MIN_QUBITS, AUTO_MIN_QUBITS, MAX_QUBITS = 2, 18, 24


def _w_matrix(nbits: int, bits: np.ndarray) -> np.ndarray:
    """W = H₀ diag(bits) H₀ over ``nbits`` wires (H on the first wire): a
    CNOT targeting that wire is ``X − 2·mask∘(W X)``."""
    H = np.real(_kron_h(nbits, 0))
    return H @ np.diag(bits.astype(np.float64)) @ H


class GridPlan:
    """Static structure of one (n, layers, ansatz) circuit in the grid form.

    - ``row_src`` (R,) int64: the row-chain permutation as a gather,
      ``(P_row M)[i] = M[row_src[i]]`` (None without a row chain).
    - ``rows`` (L, n), ``cz`` (L, n): each layer's GF(2) masks of the rest
      of its CNOT map and its CZ masks (``circuit2d.layer_masks``). For the
      fixed ansätze the same map on every layer: boundary, column chain,
      ring, in that order. For ``bn_structured`` the edges' CNOTs on even
      layers, the identity on odd ones, and nothing is folded.
    - ``index_form``: the plain version runs the index maps (bn_structured,
      whose DAG edges have no W form) rather than the TPU kernel's banks.
    """

    name = "circuit2d_grid"

    def __init__(self, num_wires: int, layers: int, ansatz_type: str, edges=None):
        n = num_wires
        if not MIN_QUBITS <= n <= MAX_QUBITS:
            raise ValueError(f"circuit2d_grid supports {MIN_QUBITS} <= n <= {MAX_QUBITS}, "
                             f"got {n}")
        if layers < 1:
            raise ValueError("circuit2d_grid needs at least one layer")
        self.n, self.layers, self.ansatz_type = n, layers, ansatz_type
        self.rb = rb = (n + 1) // 2
        self.cb = cb = n - rb
        self.R, self.C = 1 << rb, 1 << cb
        self.per_qubit = 3 if ansatz_type in WALL_ANSATZE else 2
        self.has_wall = ansatz_type in WALL_ANSATZE
        self.index_form = ansatz_type == "bn_structured"
        self.has_chain = ansatz_type in ("hardware_efficient", "basic")
        self.row_src = None
        self._cache = {}
        if self.index_form:
            self.rows, self.cz = layer_masks(n, layers, ansatz_type, edges)
            return
        chain = _chain_gates(n, ansatz_type) if self.has_chain else []
        self.row_chain = [(c, t) for c, t in chain if c < rb and t < rb]
        self.col_chain = [(c - rb, t - rb) for c, t in chain if c >= rb and t >= rb]
        self.boundary = [(c, t) for c, t in chain
                         if (c < rb) != (t < rb) and not (c == n - 1 and t == 0)]
        assert len(self.boundary) <= 1, self.boundary  # nearest-neighbour chain: one split
        self.ring = bool(chain) and n > 2
        if self.row_chain:
            idx = np.arange(self.R, dtype=np.int64)
            fwd = idx.copy()
            for c, t in self.row_chain:
                fwd = _cnot_map(idx, rb, c, t)[fwd]
            self.row_src = np.argsort(fwd)
        self.rows, self.cz = layer_masks(n, layers, ansatz_type,
                                         chain=[g for g in chain if g not in self.row_chain])

    def tables(self, device) -> tuple:
        """(dst, sign) of the per-layer masks (``circuit2d.layer_tables``),
        the index-form plain version's tables."""
        key = ("tables", str(device))
        if key not in self._cache:
            self._cache[key] = layer_tables(self.rows, self.cz, device)
        return self._cache[key]

    def row_index(self, device):
        """``row_src`` as a tensor on ``device`` (None without a row chain)."""
        key = ("row_src", str(device))
        if key not in self._cache:
            self._cache[key] = (None if self.row_src is None
                                else torch.as_tensor(self.row_src, device=device))
        return self._cache[key]

    def banks(self, device, dtype) -> dict:
        """The TPU grid kernel's constants, as dense tensors: ``p_col``
        (C, C) column-chain permutation, ``w_bound`` (C, C) and ``w_ring``
        (R, R) W matrices with their control masks ``m_bound`` (R, 1) (row
        LSB) and ``m_ring`` (1, C) (column LSB), and ``cz`` — each layer's
        (R, C) ±1 mask (None where it has no CZ), one tensor per distinct
        mask."""
        key = ("banks", str(device), dtype)
        if key not in self._cache:
            rb, cb, R, C = self.rb, self.cb, self.R, self.C

            def T(a):
                return None if a is None else torch.as_tensor(np.real(a), dtype=dtype,
                                                              device=device)

            P_col = _perm_matrix(self.col_chain, cb)
            pairs = [tuple(_cz_pairs(self.n, layer, self.ansatz_type))
                     for layer in range(self.layers)]
            signs = {p: T(_cz_sign_mask(rb, cb, list(p))) for p in set(pairs)}
            self._cache[key] = {
                "p_col": T(P_col),
                # boundary CNOT(rb-1 -> rb): control row bit rb-1, target column bit 0
                "w_bound": T(_w_matrix(cb, (np.arange(C) >> (cb - 1)) & 1)),
                "m_bound": T((np.arange(R)[:, None] & 1).astype(np.float64)),
                # ring CNOT(n-1 -> 0): control column bit cb-1, target row bit 0
                "w_ring": T(_w_matrix(rb, (np.arange(R) >> (rb - 1)) & 1)),
                "m_ring": T((np.arange(C)[None, :] & 1).astype(np.float64)),
                "cz": [signs[p] for p in pairs],
            }
        return self._cache[key]


# ------------------------------------------------------------------ plain torch


def _boundary(x, b):
    return x - 2.0 * b["m_bound"] * (x @ b["w_bound"])


def _ring(x, b):
    return x - 2.0 * b["m_ring"] * (b["w_ring"] @ x)


def circuit2d_grid_forward_plain(mr_re, mr_im, mc_re, mc_im, plan: GridPlan):
    """probs, xr, xi (R, C): the TPU grid kernel's forward in torch. ``mr``
    are the P_row-folded operators; boundary and ring CNOTs run as the one-dot
    W forms, the column chain as a permutation matmul, CZ as the layer's
    ±1 mask. For ``bn_structured`` (``plan.index_form``): the per-layer
    index maps of ``circuit2d.circuit2d_forward_plain``."""
    if plan.index_form:
        return circuit2d_forward_plain(mr_re, mr_im, mc_re, mc_im, plan)
    R, C, dt, dev = plan.R, plan.C, mr_re.dtype, mr_re.device
    b = plan.banks(dev, dt)
    if plan.has_wall:  # wall ∘ |0..0⟩ is the uniform amplitude
        xr = torch.full((R, C), 2.0 ** (-0.5 * plan.n), dtype=dt, device=dev)
    else:
        xr = torch.zeros((R, C), dtype=dt, device=dev)
        xr[0, 0] = 1.0
    xi = torch.zeros((R, C), dtype=dt, device=dev)
    for layer in range(plan.layers):
        tr, ti = _cmm(mr_re[layer], mr_im[layer], xr, xi)
        xr, xi = _cmm(tr, ti, mc_re[layer].T, mc_im[layer].T)
        planes = [xr, xi]
        if plan.has_chain:
            if plan.boundary:
                planes = [_boundary(x, b) for x in planes]
            if b["p_col"] is not None:
                planes = [x @ b["p_col"].T for x in planes]
            if plan.ring:
                planes = [_ring(x, b) for x in planes]
        s = b["cz"][layer]
        xr, xi = planes if s is None else [x * s for x in planes]
    return xr * xr + xi * xi, xr, xi


def circuit2d_grid_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: GridPlan):
    """dMr_re, dMr_im (L,R,R), dMc_re, dMc_im (L,C,C): the TPU grid kernel's
    adjoint sweep in torch. The W-form CNOTs are symmetric and involutive,
    so the state's inverse and the cotangent's pullback are the same op.
    For ``bn_structured``: ``circuit2d.circuit2d_backward_plain``."""
    if plan.index_form:
        return circuit2d_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan)
    b = plan.banks(mr_re.device, mr_re.dtype)
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    planes = torch.stack([xr, xi, 2.0 * g * xr, 2.0 * g * xi])  # x_re, x_im, l_re, l_im
    for layer in range(plan.layers - 1, -1, -1):
        s = b["cz"][layer]
        if s is not None:
            planes = planes * s
        if plan.has_chain:
            if plan.ring:
                planes = _ring(planes, b)
            if b["p_col"] is not None:  # forward X Pᵀ, inverse X P
                planes = planes @ b["p_col"]
            if plan.boundary:
                planes = _boundary(planes, b)
        planes, (dmr_re[layer], dmr_im[layer]), (dmc_re[layer], dmc_im[layer]) = \
            rotation_pullback(planes, mr_re[layer], mr_im[layer], mc_re[layer], mc_im[layer])
    return dmr_re, dmr_im, dmc_re, dmc_im


# --------------------------------------------------------------------- wrappers


def _masks(plan: GridPlan):
    """rows, cz: the (L, n) host mask tables the launchers read."""
    return (plan.rows.ctypes.data_as(ctypes.c_void_p),
            plan.cz.ctypes.data_as(ctypes.c_void_p))


def circuit2d_grid_forward(mr_re, mr_im, mc_re, mc_im, plan: GridPlan):
    """probs, xr, xi (R, C) of the circuit with P_row-folded operators. On
    the card: ``csrc/circuit2d_grid.cu``'s host launcher, with a (2, R, C)
    scratch and a (2, L, C, C) scratch for Mcᵀ (the launcher transposes Mc
    there first, so that from n = 20 the right product's B streams by
    cp.async in the large GEMM loop)."""
    if mr_re.device.type == "cpu":
        return circuit2d_grid_forward_plain(mr_re, mr_im, mc_re, mc_im, plan)
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im)
    fn = _lib.load(plan.name).tn_circuit2d_grid_forward
    probs = torch.empty((plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    xr, xi = torch.empty_like(probs), torch.empty_like(probs)
    tmp = torch.empty((2, plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    mct = torch.empty((2, plan.layers, plan.C, plan.C), dtype=torch.float32,
                      device=mr_re.device)
    _lib.count_launch("circuit2d_grid_fwd")
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(probs), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(tmp), _lib.ptr(mct),
             plan.n, plan.layers, int(plan.has_wall), *_masks(plan),
             _lib.stream_ptr(mr_re.device))
    _lib.check(err, "tn_circuit2d_grid_forward")
    return probs, xr, xi


def circuit2d_grid_backward(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: GridPlan):
    """Gradients of the P_row-folded operators for the cotangent g of the
    probs. On the card: ``csrc/circuit2d_grid.cu``'s host launcher, with two
    (4, R, C) scratch buffers."""
    if mr_re.device.type == "cpu":
        return circuit2d_grid_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan)
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im, x_r=xr, x_i=xi, x_g=g)
    fn = _lib.load(plan.name).tn_circuit2d_grid_backward
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    buf_a = torch.empty((4, plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    buf_b = torch.empty_like(buf_a)
    _lib.count_launch("circuit2d_grid_bwd")
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(g),
             _lib.ptr(dmr_re), _lib.ptr(dmr_im), _lib.ptr(dmc_re), _lib.ptr(dmc_im),
             _lib.ptr(buf_a), _lib.ptr(buf_b), plan.n, plan.layers, *_masks(plan),
             _lib.stream_ptr(mr_re.device))
    _lib.check(err, "tn_circuit2d_grid_backward")
    return dmr_re, dmr_im, dmc_re, dmc_im


class Circuit2dGridFunction(torch.autograd.Function):
    """probs (R, C) of the operator planes, with the adjoint-sweep backward."""

    @staticmethod
    def forward(ctx, mr_re, mr_im, mc_re, mc_im, plan: GridPlan):
        probs, xr, xi = circuit2d_grid_forward(mr_re, mr_im, mc_re, mc_im, plan)
        ctx.plan = plan
        ctx.save_for_backward(mr_re, mr_im, mc_re, mc_im, xr, xi)
        return probs

    @staticmethod
    def backward(ctx, g):
        mr_re, mr_im, mc_re, mc_im, xr, xi = ctx.saved_tensors
        grads = circuit2d_grid_backward(mr_re, mr_im, mc_re, mc_im, xr, xi,
                                        g.contiguous(), ctx.plan)
        return (*grads, None)


def grid_planes(Mr: torch.Tensor, Mc: torch.Tensor, plan: GridPlan) -> list:
    """[(P_row·Mr)_re, (P_row·Mr)_im, Mc_re, Mc_im] of complex operators:
    the planes the grid kernels take. P_row is a row gather, so autograd
    carries the gradient through it."""
    mr_re, mr_im = Mr.real, Mr.imag
    idx = plan.row_index(Mr.device)
    if idx is not None:
        mr_re, mr_im = mr_re[:, idx], mr_im[:, idx]
    return [t.contiguous() for t in (mr_re, mr_im, Mc.real, Mc.imag)]


def grid_operators(params: torch.Tensor, plan: GridPlan, embed_angles=None,
                   reupload: bool = False) -> list:
    """The grid kernels' operator planes of θ, the conditioning wall of
    ``embed_angles`` (if given) folded into Mr and Mc before the gather."""
    return grid_planes(*circuit_operators(params, plan, embed_angles, reupload), plan)


def make_circuit2d_grid_probs_fn(num_wires: int, layers: int, ansatz_type: str, edges=None,
                                 conditioning: bool = False, reupload: bool = False):
    """probs(params) -> (2^n,) through the grid circuit kernels (``edges``
    for bn_structured); with ``conditioning``, probs(params, embed_angles),
    the wall folded into the operator planes before the row gather
    (``reupload``: before every layer). ``probs.batch`` runs several walls
    on one θ fold; ``probs.state`` gives the final state from the forward
    kernel."""
    plan = GridPlan(num_wires, layers, ansatz_type, edges)
    return make_probs_fn(plan, lambda Mr, Mc: grid_planes(Mr, Mc, plan), Circuit2dGridFunction,
                         circuit2d_grid_forward, conditioning, reupload)
