"""Grid-over-layers circuit forward and adjoint backward for n ≥ 18:
kernels 5-6 of the port.

Replaces ``tensornetworks_tpu/ops/pallas/circuit2d_grid.py``
(``make_pallas_circuit2d_grid_probs``: ``fwd_kernel`` and ``bwd_kernel``)
with two designs, chosen by the plan's kernel precision:

- ``highest`` (FP32), the gate path: ``csrc/circuit_gates.cu`` takes each
  layer's per-qubit 2x2 gates (``sim.gates.layer_rotations``, a wall folded
  in per qubit by ``sim.gates.fold_wall_gates``) and applies them as
  butterflies on tiles of up to 4096 amplitudes in shared memory, a few
  passes a layer (``layer_gate_passes``: the plan, ``GatePass``: one pass);
  each layer's whole CNOT map (the row chain included) and CZ sign go into
  the store of its last pass. The backward is the gate-level adjoint and
  returns dU (L, n, 2, 2); autograd takes it to θ. Bound by device memory:
  at n=24 a pass moves 268 MB (80 µs at 3.35 TB/s), a layer 2-3 passes;
  the gates' 14 FLOPs an amplitude are below that. The source note gives
  the design. ``CircuitGatesFunction`` ties the two directions together;
  ``circuit_gates_forward_plain`` / ``circuit_gates_backward_plain`` run the
  same passes tile by tile in torch (``gate_pass_index``: the kernels'
  address formulas), for the CPU and as the card's yardstick.
- ``high`` and ``default``, the operator path: ``csrc/circuit2d_grid.cu``
  and its per-layer host launchers (``csrc/circuit_layers.cuh``) apply the
  Kronecker operators Mr (R×R) and Mc (C×C) of each layer as dense
  complex products on the bf16 tensor cores, X ← Mr·X·Mcᵀ. The row-chain
  permutation is folded into the streamed operator (``P_row·Mr``), as on
  the TPU, here as a row gather. The boundary CNOT, the column chain and
  the ring CNOT compose into one exact GF(2) index map applied with the CZ
  sign in the right GEMM's epilogue. ``bn_structured`` folds nothing into
  Mr: its index maps alternate (the DAG edges' CNOTs on even layers, the
  identity on odd ones). A conditioned circuit's wall is folded into the
  rotation operators first (``circuit2d.circuit_operators``) and the row
  gather taken after, so the streamed operator is ``P_row·(Mr·Er)``. The
  same kernels run in FP32 when called directly (the card's checks hold
  the gate path against them). Bound at n=20, L=4 (R=C=1024): forward
  6.9e10, backward 2.1e11 dense FLOP.

``GridPlan`` holds the structure of both: the gate path's passes, the masks
the operator kernels take, and the TPU kernel's own banks (``P_col``, the W
matrices, the CZ masks) for the operator path's plain version.
``circuit2d_grid_forward_plain`` / ``circuit2d_grid_backward_plain``
transcribe the TPU grid kernel's algebra, a different algorithm from the
CUDA kernels' index map, so that holding one against the other on the card
is a real check. The W forms exist only for the chain, so for
``bn_structured`` the plain version is the index-map form of
``circuit2d.py``, and the independent check is the oracle
``sim/structured.make_structured_probs_fn``. Each wrapper takes the plain
version only for CPU tensors; a CUDA tensor launches the kernel or raises.

Precision: as ``circuit2d.py``'s plans, a ``GridPlan`` carries the kernel
precision current when it was built; the operator path's plain versions run
the rotation products at it (``circuit2d._pcmm``) and the W forms, the
column chain and the CZ masks, which are exact maps, in FP32. Under
``high`` and ``default`` the products that the FP32 kernels' large GEMM
loop takes (every product from n = 20; at n = 19 the backward's but dMc)
run on the Hopper loop of ``csrc/wgmma_bf16.cuh`` (TMA copies of bf16
planes split once, wgmma from shared memory), the others on ``mma.sync``
passes (``csrc/mma_bf16.cuh``). The wrappers allocate the loop's bf16
scratch where it runs, as large as the library's
``tn_circuit2d_grid_split_elems`` says (0: it does not run).
``split_planes_plain`` and ``extended_k_product_plain`` are its arithmetic
in torch; ``product_case``, ``grid_product`` and ``grid_product_plain`` run
one product of the six patterns alone (the card's checks and timings).

Valid range: any 2 ≤ n ≤ ``MAX_QUBITS`` when the backend is named (the CPU
tests run it small); the ``auto`` backend takes it from ``AUTO_MIN_QUBITS``
= 18. ``MAX_QUBITS`` = 24 is set by the operator path's memory: the
(L, R, R) and (L, C, C) operator planes and their gradients grow 4x per two
qubits (at n=24, L=4, 1 GB each way, the complex Kronecker fold and its
autograd about as much again; at n=26 ~16 GB). (The kernels' 32-bit flat
indices would hold to n=30.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...sim.blocked import _chain_gates, _cnot_map, _cz_pairs
from ...sim.blocked2d import _cz_sign_mask, _kron_h, _perm_matrix
from ...sim.gates import fold_wall_gates, layer_rotations
from ...train import span
from . import _lib
from .circuit2d import (WALL_ANSATZE, _check, _initial_state, _pcmm, circuit2d_backward_plain,
                        circuit2d_forward_plain, circuit_operators, cz_sign, expand_maps,
                        layer_masks, layer_tables, make_probs_fn, rotation_pullback)
from .precision import CODES, _kernel_precision, fp32_matmul, precision_name, split_bf16

MIN_QUBITS, AUTO_MIN_QUBITS, MAX_QUBITS = 2, 18, 24
# csrc/circuit_gates.cu: kTileBits (a tile of 4096 amplitudes), kGroup (the
# gates applied together in registers), kSpecWords (one pass's record); a
# tile bit below GATE_BANK_BITS puts two of a warp's threads on one bank.
GATE_TILE_BITS, GATE_GROUP, GATE_SPEC_WORDS, GATE_BANK_BITS = 12, 3, 8 + 11 * 32, 5
GATE_NEGATE = 1 << 31  # csrc/circuit_gates.cu kNegate, in a pass's xout

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
    - ``precision``: the kernel precision of its products, by default the
      one current when the plan is built.
    """

    name = "circuit2d_grid"

    def __init__(self, num_wires: int, layers: int, ansatz_type: str, edges=None,
                 precision=None):
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
        self.precision = precision_name(precision or _kernel_precision())
        self.edges = edges
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

    def gate_passes(self) -> list:
        """The gate path's passes (``GatePass``), layer by layer
        (``layer_gate_passes`` of each layer's whole CNOT map, the row chain
        included, and CZ masks), with each gate's partials slot set."""
        if "gate_passes" not in self._cache:
            rows, cz = layer_masks(self.n, self.layers, self.ansatz_type, self.edges)
            passes = [ps for layer in range(self.layers)
                      for ps in layer_gate_passes(self.n, layer, rows[layer], cz[layer])]
            slots = np.zeros((self.layers, self.n, 2), dtype=np.int64)
            offset = 0
            for ps in passes:
                blocks = 1 << (self.n - ps.k)
                for _, q in ps.gates:
                    ps.slots.append(offset)
                    slots[ps.layer, q] = offset, blocks
                    offset += blocks
            self._cache["gate_passes"] = passes
            self._cache["gate_slots"] = slots.reshape(-1, 2)
            self._cache["gate_partials"] = offset
            self._cache["gate_records"] = np.stack([ps.record() for ps in passes])
        return self._cache["gate_passes"]

    def gate_records(self) -> np.ndarray:
        """(passes, GATE_SPEC_WORDS) uint32: the passes as the kernels read
        them (``GatePass.record``)."""
        self.gate_passes()
        return self._cache["gate_records"]

    def gate_slots(self) -> np.ndarray:
        """(L·n, 2) int64: (offset, count) of the dU partial records of
        layer l's qubit q at row l·n + q."""
        self.gate_passes()
        return self._cache["gate_slots"]

    def gate_partials(self) -> int:
        """The backward's partial records (8 floats each), all gates'."""
        self.gate_passes()
        return self._cache["gate_partials"]

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
    dt, dev, p = mr_re.dtype, mr_re.device, plan.precision
    b = plan.banks(dev, dt)
    xr, xi = _initial_state(plan, dt, dev)  # wall ∘ |0..0⟩ is the uniform amplitude
    with fp32_matmul():
        for layer in range(plan.layers):
            tr, ti = _pcmm(mr_re[layer], mr_im[layer], xr, xi, p)
            xr, xi = _pcmm(tr, ti, mc_re[layer].T, mc_im[layer].T, p)
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
    with fp32_matmul():
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
                rotation_pullback(planes, mr_re[layer], mr_im[layer], mc_re[layer],
                                  mc_im[layer], plan.precision)
    return dmr_re, dmr_im, dmc_re, dmc_im


# ------------------------------------------------------- the bf16 wgmma loop


def bf16_product_counts() -> dict:
    """The bf16 products the grid kernels have launched in this process, by
    loop (``mma_sync``: ``tn_gemm.cuh``'s passes; ``wgmma``), from the
    library's host counters (the card only)."""
    out = (ctypes.c_longlong * 2)()
    _lib.load(GridPlan.name).tn_circuit2d_grid_bf16_products(out)
    return {"mma_sync": out[0], "wgmma": out[1]}


def split_planes_plain(x: torch.Tensor, precision: str) -> tuple:
    """The split kernel's planes of x, in FP32: (hi,) under ``default``,
    (hi, lo) under ``high`` (``precision.split_bf16``). A sign goes through
    exactly: the split of -x is (-hi, -lo)."""
    hi, lo = split_bf16(x.to(torch.float32))
    return (hi,) if precision == "default" else (hi, lo)


def extended_k_product_plain(a_re, a_im, b_re, b_im, conj_a: bool, conj_b: bool,
                             precision: str) -> tuple:
    """(re, im) of opA(A)·opB(B), conjugating A or B where asked, as the
    wgmma loop forms it: each part one real product over an extended K,
        re = [Ar | s·Ai]·[Br ; Bi],  s = -ca·cb,
        im = [cb·Ar | ca·Ai]·[Bi ; Br],
    the signs ca, cb = -1 for a conjugated operand; under ``high`` that
    real product X·Y is [lo X | hi X | hi X]·[hi Y ; lo Y ; hi Y] (6K),
    under ``default`` hi X·hi Y (2K). Operands (..., M, K) and (..., K, N)."""
    ca, cb = (-1.0 if conj_a else 1.0), (-1.0 if conj_b else 1.0)

    def real(X, Y):
        sx, sy = split_planes_plain(X, precision), split_planes_plain(Y, precision)
        if precision == "default":
            return sx[0] @ sy[0]
        return (torch.cat([sx[1], sx[0], sx[0]], dim=-1)
                @ torch.cat([sy[0], sy[1], sy[0]], dim=-2))

    with fp32_matmul():
        re = real(torch.cat([a_re, -ca * cb * a_im], dim=-1), torch.cat([b_re, b_im], dim=-2))
        im = real(torch.cat([cb * a_re, ca * a_im], dim=-1), torch.cat([b_im, b_re], dim=-2))
    return re, im


# The six product patterns of the grid launchers (csrc/circuit_layers.cuh,
# tn_gemm.cuh's table): the buffers each reads and writes, as (planes,
# rows, cols) of the state (R, C) and operators (R, R) / (C, C); A's, B's
# and C's plane offsets and strides in those buffers, in units of
# S = R·C, RR = R², CC = C² (a batch stride of 2 S: two products at once);
# conj (bit 0 A, bit 1 B); M, N, K in R and C.
PRODUCT_PATTERNS = {
    # A = B conj(Mc): the state and cotangent pulled back through the columns
    "col": dict(a=("state4", (0, "S"), ("2S", "C", 1)), b=("mc", (0, "CC"), (0, "C", 1)),
                c=("state4", (0, "S"), ("2S", "C")), conj=2, mnk=("R", "C", "C"), batch=2),
    # dMc = lambda^T conj(x)
    "dmc": dict(a=("state4", ("2S", "3S"), (0, 1, "C")), b=("state4", (0, "S"), (0, "C", 1)),
                c=("mc", (0, "CC"), (0, "C")), conj=2, mnk=("C", "C", "R"), batch=1),
    # B = Mr^H A: through the rows
    "row": dict(a=("mr", (0, "RR"), (0, 1, "R")), b=("state4", (0, "S"), ("2S", "C", 1)),
                c=("state4", (0, "S"), ("2S", "C")), conj=1, mnk=("R", "C", "R"), batch=2),
    # dMr = lambda x^H
    "dmr": dict(a=("state4", ("2S", "3S"), (0, "C", 1)), b=("state4", (0, "S"), (0, 1, "C")),
                c=("mr", (0, "RR"), (0, "R")), conj=2, mnk=("R", "R", "C"), batch=1),
    # tmp = Mr X
    "left": dict(a=("mr", (0, "RR"), (0, "R", 1)), b=("state2", (0, "S"), (0, "C", 1)),
                 c=("state2", (0, "S"), (0, "C")), conj=0, mnk=("R", "C", "R"), batch=1),
    # X = perm/sign(tmp Mc^T), B[k, n] = Mc[n, k]; with |X|^2
    "scatter": dict(a=("state2", (0, "S"), (0, "C", 1)), b=("mc", (0, "CC"), (0, 1, "C")),
                    c=("state2", (0, "S"), (0, "C")), conj=0, mnk=("R", "C", "C"), batch=1),
}


def product_case(pattern: str, n: int, device, seed: int = 0) -> dict:
    """One product of ``PRODUCT_PATTERNS`` at n qubits: random FP32 buffers
    (operators scaled as unitaries' entries, 1/√dim) on ``device``, the
    offsets, strides and shape; the scatter pattern takes a hardware-
    efficient layer's index map and CZ masks (``GridPlan(n, 1, ...)``)."""
    spec = PRODUCT_PATTERNS[pattern]
    R, C = 1 << (n + 1) // 2, 1 << n // 2
    units = {"S": R * C, "2S": 2 * R * C, "3S": 3 * R * C, "RR": R * R, "CC": C * C, "R": R,
             "C": C}
    shapes = {"state4": (4, R, C), "state2": (2, R, C), "mr": (2, R, R), "mc": (2, C, C)}
    gen = torch.Generator().manual_seed(seed)

    def buf(kind, scale):
        return (scale * torch.randn(shapes[kind], generator=gen)).to(device)

    val = lambda v: units[v] if isinstance(v, str) else v  # noqa: E731
    a, b = buf(spec["a"][0], R ** -0.5), buf(spec["b"][0], C ** -0.5)
    M, N, K = (units[v] for v in spec["mnk"])
    case = dict(pattern=pattern, n=n, a=a, b=b, c=torch.zeros(shapes[spec["c"][0]], device=device),
                offs=[val(v) for v in (*spec["a"][1], *spec["b"][1], *spec["c"][1])],
                strides=[val(v) for v in (*spec["a"][2], *spec["b"][2], *spec["c"][2])],
                M=M, N=N, K=K, batch=spec["batch"], conj=spec["conj"], rows=None, cz=None)
    if pattern == "scatter":
        plan = GridPlan(n, 1, "hardware_efficient")
        case["rows"] = np.ascontiguousarray(plan.rows[0], dtype=np.uint32)
        case["cz"] = np.ascontiguousarray(plan.cz[0], dtype=np.uint32)
    return case


def _case_operands(case, dtype=None):
    """(A re, A im, B re, B im) of a case as (batch, M, K) and (batch, K, N)
    views through its offsets and strides."""
    o, st, bt = case["offs"], case["strides"], case["batch"]
    M, N, K = case["M"], case["N"], case["K"]
    a, b = case["a"].reshape(-1), case["b"].reshape(-1)
    if dtype is not None:
        a, b = a.to(dtype), b.to(dtype)
    A = [torch.as_strided(a, (bt, M, K), (st[0], st[1], st[2]), o[i]) for i in (0, 1)]
    B = [torch.as_strided(b, (bt, K, N), (st[3], st[4], st[5]), o[i]) for i in (2, 3)]
    return A[0], A[1], B[0], B[1]


def _case_epilogue(case, re, im):
    """The case's output buffer (and probs for the scatter) from the
    product's (batch, M, N) planes."""
    c = torch.zeros(case["c"].shape, dtype=re.dtype, device=re.device)
    flat = c.reshape(-1)
    o, st = case["offs"], case["strides"]
    if case["rows"] is None:
        for part, x in ((o[4], re), (o[5], im)):
            torch.as_strided(flat, x.shape, (st[6], st[7], 1), part).copy_(x)
        return c, None
    dst, sign = expand_maps(case["rows"], case["cz"][None], re.device)
    s = sign[0].to(re.dtype)
    flat[o[4] + dst] = s * re.reshape(-1)
    flat[o[5] + dst] = s * im.reshape(-1)
    probs = torch.zeros(re.numel(), dtype=re.dtype, device=re.device)
    probs[dst] = (re * re + im * im).reshape(-1)
    return c, probs


def grid_product_plain(case: dict, precision: str, dtype=torch.float32) -> tuple:
    """(c, probs or None): the case's product in torch, by
    ``extended_k_product_plain`` at ``precision`` (``highest``: the exact
    complex product in ``dtype``, the float64 yardstick)."""
    ar, ai, br, bi = _case_operands(case, dtype)
    conj_a, conj_b = bool(case["conj"] & 1), bool(case["conj"] & 2)
    if precision == "highest":
        ai, bi = (-ai if conj_a else ai), (-bi if conj_b else bi)
        with fp32_matmul():
            re, im = ar @ br - ai @ bi, ar @ bi + ai @ br
    else:
        re, im = extended_k_product_plain(ar, ai, br, bi, conj_a, conj_b, precision)
    return _case_epilogue(case, re, im)


def grid_product(case: dict, precision: str, split=None) -> tuple:
    """(c, probs or None): the case's product on the wgmma loop
    (``tn_grid_bf16_product``). ``split``: a bf16 scratch from a first call
    (``case["split"]``) to reuse without splitting again, so that a timing
    reads the product alone; by default the call splits A and B first. CPU
    tensors take ``grid_product_plain``."""
    if case["a"].device.type == "cpu":
        return grid_product_plain(case, precision)
    parts = 2 if precision == "high" else 1
    a, b, c = case["a"], case["b"], case["c"]
    do_split = split is None
    if do_split:
        split = torch.empty(parts * (a.numel() + b.numel()), dtype=torch.bfloat16,
                            device=a.device)
        case["split"] = split
    scatter = case["rows"] is not None
    probs = torch.zeros(c[0].numel(), device=a.device) if scatter else None
    offs = (ctypes.c_longlong * 6)(*case["offs"])
    strides = (ctypes.c_longlong * 8)(*case["strides"])
    fn = _lib.load(GridPlan.name).tn_grid_bf16_product
    host = [case[k].ctypes.data_as(ctypes.c_void_p) if scatter else None for k in ("rows", "cz")]
    err = fn(_lib.ptr(a), a.numel(), _lib.ptr(b), b.numel(), _lib.ptr(c),
             _lib.ptr(probs) if scatter else None, _lib.ptr(split), offs, strides, case["M"],
             case["N"], case["K"], case["batch"], case["conj"], int(do_split), CODES[precision],
             case["n"], *host, _lib.stream_ptr(a.device))
    _lib.check(err, "tn_grid_bf16_product")
    return c, probs


# ------------------------------------------------ the gate path (``highest``)


def _gf2(rows, v: int) -> int:
    """The GF(2)-linear index map of ``rows`` (LSB-first masks) at v."""
    return sum((bin(int(r) & v).count("1") & 1) << k for k, r in enumerate(rows))


class _Span:
    """A GF(2) subspace of n-bit masks in echelon form, each basis vector
    keyed by its highest set bit (its pivot) and tagged with the XOR of the
    tags of the vectors added to make it."""

    def __init__(self, vectors=(), tags=None):
        self.rows = {}
        for i, v in enumerate(vectors):
            self.add(v, 1 << i if tags is None else tags[i])

    def reduce(self, v: int, tag: int = 0) -> tuple:
        for p in sorted(self.rows, reverse=True):
            if (v >> p) & 1:
                w, t = self.rows[p]
                v, tag = v ^ w, tag ^ t
        return v, tag

    def add(self, v: int, tag: int = 0) -> int:
        """The part of v outside the span, added (0 if v was inside)."""
        v, tag = self.reduce(v, tag)
        if v:
            self.rows[v.bit_length() - 1] = (v, tag)
        return v

    def coords(self, v: int) -> int:
        r, tag = self.reduce(v)
        assert r == 0, "vector outside the span"
        return tag

    def __contains__(self, v: int) -> bool:
        return self.reduce(v)[0] == 0

    def __len__(self) -> int:
        return len(self.rows)


class GatePass:
    """One launch of the gate kernels (``csrc/circuit_gates.cu``): a tile of
    2^k amplitudes a block, over one coset of a k-dimensional subspace V of
    the flat index (GF(2) masks, LSB first), for each of the 2^(n-k) cosets.

    - ``lin`` (k): V's basis in tile order. Tile position p is loaded from
      ``base_in ^ XOR_t p_t·lin[t]``; lin[t] = 1 << t for t < m, so m low
      address bits run with the tile position (coalesced loads), and every
      gate's bit is some lin[t] (its tile bit).
    - ``cin`` (n-k): unit vectors completing V; block b's ``base_in`` is the
      XOR of cin[t] over the set bits t of b.
    - ``gates``: (tile bit, qubit) in the order applied; each a 2x2 on the
      pairs of tile positions that differ in its tile bit.
    - ``rows``, ``cz``: on a layer's last pass, its CNOT map M and CZ masks
      (None elsewhere, or where M is the identity / there is no CZ). The
      store of store index q goes to ``base_out ^ XOR_t q_t·lout[t]``
      (lout[t] = 1 << t for t < m: coalesced stores) from tile position
      ``off ^ XOR_t q_t·tq[t]``, with ``base_out``, ``off`` the XOR of
      cout[t], coff[t] over b's set bits: M sends the coset onto that of
      ``base_out``, element for element. Without M: lout = lin, tq the
      identity, cout = cin, coff = 0.
    - ``slots``: the record offset of each gate's dU partials (one 8-float
      record a block) in the backward's partials buffer.
    - ``xout``: on a map pass of a shard's plan (``shard_gates``), a
      constant XOR of the store address (``xor``, the rank's CNOT targets)
      and ``GATE_NEGATE``, a sign on every stored amplitude (the rank's
      constant CZ sign); 0 in a one-card plan.
    """

    def __init__(self, n, layer, m, lin, gates, rows=None, cz=None, xout=0):
        self.n, self.layer, self.m, self.k = n, layer, m, len(lin)
        self.lin, self.gates = list(lin), list(gates)
        self.xout = int(xout)
        if rows is None and self.xor:
            raise ValueError("a constant XOR of the store address needs a map pass")
        tile = _Span(self.lin)
        self.cin = [1 << b for b in range(n) if b not in tile.rows]
        self.rows = rows
        self.cz = None if cz is None or not np.any(cz) else np.asarray(cz, np.uint32)
        self.slots = []
        if rows is None:
            self.lout, self.cout = self.lin, self.cin
            self.tq, self.coff = [1 << t for t in range(self.k)], [0] * len(self.cin)
            return
        images = _Span([_gf2(rows, 1 << j) for j in range(n)])  # tags: M⁻¹ of an image
        low = (1 << m) - 1
        out = _Span([1 << b for b in range(m)])
        self.lout = [1 << b for b in range(m)]
        for v in self.lin:
            r = out.add(_gf2(rows, v))
            if r:
                self.lout.append(r)
        assert len(self.lout) == self.k and all(v & low == 0 for v in self.lout[m:])
        self.tq = [tile.coords(images.coords(w)) for w in self.lout]
        mc = [_gf2(rows, c) for c in self.cin]
        self.cout = [v & ~low for v in mc]
        self.coff = [tile.coords(images.coords(v & low)) for v in mc]

    @property
    def map(self) -> bool:
        return self.rows is not None

    @property
    def xor(self) -> int:
        return self.xout & ~GATE_NEGATE

    @property
    def negate(self) -> bool:
        return bool(self.xout & GATE_NEGATE)

    def record(self) -> np.ndarray:
        """The pass as the kernels' ``PassSpec`` (GATE_SPEC_WORDS uint32)."""
        rec = np.zeros(GATE_SPEC_WORDS, dtype=np.uint32)
        cz = [] if self.cz is None else [(k, int(c)) for k, c in enumerate(self.cz) if c]
        rec[:8] = (self.n, self.k, self.m, int(self.map), self.layer, len(self.gates), len(cz),
                   self.xout)
        fields = (self.lin, self.cin, self.lout, self.cout, self.coff, self.tq,
                  [t for t, _ in self.gates], [q for _, q in self.gates], self.slots,
                  [k for k, _ in cz], [c for _, c in cz])
        for i, f in enumerate(fields):
            rec[8 + 32 * i: 8 + 32 * i + len(f)] = f
        return rec


def _order_gates(bits: list, pos: dict) -> list:
    """The pass's gate bits in the order applied: groups of GATE_GROUP, each
    with as few tile bits below GATE_BANK_BITS as can be (each such bit
    halves the shared-memory banks a warp's threads spread over)."""
    low = sorted(b for b in bits if pos[b] < GATE_BANK_BITS)
    high = sorted(b for b in bits if pos[b] >= GATE_BANK_BITS)
    groups = [[] for _ in range(-(-len(bits) // GATE_GROUP))]
    for i, b in enumerate(low):
        groups[i % len(groups)].append(b)
    for g in groups:
        while len(g) < GATE_GROUP and high:
            g.append(high.pop(0))
    return [b for g in groups for b in g]


def layer_gate_passes(n: int, layer: int, rows, cz, kmax: int = GATE_TILE_BITS,
                      xout: int = 0) -> list:
    """The passes of one layer: every qubit's gate in exactly one pass, the
    layer's map M and CZ sign in the store of the last. That last pass's
    tile holds the m low bits and M⁻¹ of them (so that its stores are
    coalesced too) and as many further low bits as fit; the other bits go
    to passes of m low bits plus up to kmax - m gate bits, as evenly as
    can be. m runs from 5 to 2 low bits (128 to 16 bytes a run); a pass
    of m = 2 moves each 32-byte sector for half its bytes, so it counts
    twice, and m is the largest of those that move the fewest bytes.
    ``xout`` goes to the last pass (``GatePass``), which then maps even
    where M is the identity if it holds a constant XOR."""
    identity = all(int(rows[k]) == 1 << k for k in range(n)) and not xout & ~GATE_NEGATE
    images = _Span([_gf2(rows, 1 << j) for j in range(n)])
    best = None
    for m in range(min(5, n), 1, -1):
        V = _Span([1 << b for b in range(m)] + [images.coords(1 << b) for b in range(m)])
        if len(V) > kmax:
            continue
        for b in range(n):
            if len(V) >= kmax:
                break
            V.add(1 << b)
        own = [b for b in range(n) if (1 << b) in V]
        rest = [b for b in range(n) if (1 << b) not in V]
        count = 1 + -(-len(rest) // (kmax - m))
        cost = 1 + (count - 1) * (2 if m == 2 else 1)
        if best is None or cost < best[0]:
            best = (cost, count, m, V, own, rest)
    _, count, m, V, own, rest = best

    def make(lin, bits, rows=None, cz=None, xout=0):
        pos = {b: lin.index(1 << b) for b in bits}
        return GatePass(n, layer, m, lin, [(pos[b], n - 1 - b) for b in _order_gates(bits, pos)],
                        rows, cz, xout)

    low = [1 << b for b in range(m)]
    passes = [make(low + [1 << int(b) for b in chunk], [int(b) for b in chunk])
              for chunk in (np.array_split(np.array(rest), count - 1) if rest else ())]
    lin = low + [1 << b for b in own if b >= m]
    units = _Span(lin)
    lin += [r for r in (units.add(v) for v, _ in list(V.rows.values())) if r]
    passes.append(make(lin, own, None if identity else rows, cz, xout))
    return passes


def _span_index(idx: torch.Tensor, basis) -> torch.Tensor:
    """XOR of basis[t] over the set bits t of each entry of idx."""
    out = torch.zeros_like(idx)
    for t, v in enumerate(basis):
        out ^= ((idx >> t) & 1) * int(v)
    return out


def gate_pass_index(ps: GatePass, device, blocks=None) -> tuple:
    """(src, dst, pos), (2^(n-k), 2^k) int64 each, by the kernels' formulas:
    block b's tile position p is loaded from src[b, p]; its store index q
    is written to dst[b, q] from tile position pos[b, q]. ``blocks``: those
    blocks' rows alone (a card's check of a wide pass)."""
    if blocks is None:
        blocks = torch.arange(1 << (ps.n - ps.k), dtype=torch.int64, device=device)
    blocks = torch.as_tensor(blocks, dtype=torch.int64, device=device)[:, None]
    tile = torch.arange(1 << ps.k, dtype=torch.int64, device=device)[None, :]
    return (_span_index(blocks, ps.cin) ^ _span_index(tile, ps.lin),
            _span_index(blocks, ps.cout) ^ _span_index(tile, ps.lout) ^ ps.xor,
            _span_index(blocks, ps.coff) ^ _span_index(tile, ps.tq))


def _pair_view(tile: torch.Tensor, t: int) -> torch.Tensor:
    """(B, 2^(k-1-t), 2, 2^t): tile bit t as axis 2."""
    return tile.view(tile.shape[0], tile.shape[1] >> (t + 1), 2, 1 << t)


def _apply_gate(tile: torch.Tensor, t: int, u: torch.Tensor) -> torch.Tensor:
    """The 2x2 u on tile bit t of every tile (B, 2^k)."""
    v = _pair_view(tile, t)
    a0, a1 = v[:, :, 0], v[:, :, 1]
    return torch.stack([u[0, 0] * a0 + u[0, 1] * a1, u[1, 0] * a0 + u[1, 1] * a1],
                       dim=2).reshape(tile.shape)


def _store_sign(ps: GatePass, dst: torch.Tensor, dtype):
    """The sign of a pass's store at dst (its CZ sign and constant one), or 1."""
    s = 1 if ps.cz is None else cz_sign(dst, ps.cz).to(dtype)
    return -s if ps.negate else s


def gate_pass_forward_plain(ps: GatePass, U: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One pass of the gate kernels on the flat state x (2^n,) in torch:
    the tiles loaded, every gate of the pass in the kernels' order, the
    store through the pass's map and sign."""
    src, dst, pos = gate_pass_index(ps, x.device)
    tile = x[src]
    for t, q in ps.gates:
        tile = _apply_gate(tile, t, U[ps.layer, q])
    vals = tile.gather(1, pos)
    if ps.cz is not None or ps.negate:
        vals = vals * _store_sign(ps, dst, vals.real.dtype)
    out = torch.empty_like(x)
    out[dst.reshape(-1)] = vals.reshape(-1)
    return out


def circuit_gates_forward_plain(U: torch.Tensor, plan: GridPlan) -> tuple:
    """probs, xr, xi (R, C) of the per-layer gates U (L, n, 2, 2): the gate
    kernels' passes in torch, tile by tile, every gate in the kernels'
    order, each layer's map and CZ sign in its last pass's store."""
    n, dev = plan.n, U.device
    if plan.has_wall:
        x = torch.full((1 << n,), 2.0 ** (-0.5 * n), dtype=U.dtype, device=dev)
    else:
        x = torch.zeros(1 << n, dtype=U.dtype, device=dev)
        x[0] = 1.0
    for ps in plan.gate_passes():
        x = gate_pass_forward_plain(ps, U, x)
    xr = x.real.reshape(plan.R, plan.C).contiguous()
    xi = x.imag.reshape(plan.R, plan.C).contiguous()
    return xr * xr + xi * xi, xr, xi


def gate_pass_backward_plain(ps: GatePass, Uh: torch.Tensor, x: torch.Tensor, lam,
                             mapped: bool = True, gates: bool = True) -> tuple:
    """The adjoint of one pass in torch: (x, lam, dU) with x and lam (2^n,)
    un-computed through it (lam may be None with ``gates=False``), dU
    {(layer, qubit): (2, 2)} its gates' sums. Undo the sign and the map (not
    where ``mapped`` is False: the map is undone already), then for each
    gate, last to first, x ← Uᴴx, dU += Σ λ_r·conj(x_c) over the tile's
    pairs (one partial a tile), λ ← Uᴴλ; each gate's partials summed over
    the tiles in tile order. ``gates=False``: the map and sign only."""
    src, dst, pos = gate_pass_index(ps, x.device)
    if not mapped or not ps.map:
        dst, pos = src, torch.arange(src.shape[1], device=x.device).expand_as(src)
    s = _store_sign(ps, dst, x.real.dtype) if mapped else 1
    bufs = [x] if lam is None else [x, lam]
    tiles = []
    for v in bufs:
        t = torch.empty(src.shape, dtype=v.dtype, device=v.device)
        t.scatter_(1, pos, s * v[dst])
        tiles.append(t)
    dU = {}
    if gates:
        tx, tl = tiles
        for t, q in reversed(ps.gates):
            tx = _apply_gate(tx, t, Uh[ps.layer, q])
            vx, vl = _pair_view(tx, t), _pair_view(tl, t)
            part = torch.stack([torch.stack([(vl[:, :, r] * vx[:, :, c].conj()).sum(dim=(1, 2))
                                             for c in (0, 1)], dim=-1) for r in (0, 1)], dim=-2)
            dU[ps.layer, q] = part.sum(dim=0)
            tl = _apply_gate(tl, t, Uh[ps.layer, q])
        tiles = [tx, tl]
    outs = []
    for t in tiles:
        o = torch.empty_like(x)
        o[src.reshape(-1)] = t.reshape(-1)
        outs.append(o)
    return outs[0], (outs[1] if len(outs) > 1 else None), dU


def circuit_gates_backward_plain(U, xr, xi, g, plan: GridPlan) -> torch.Tensor:
    """dU (L, n, 2, 2): the gate kernels' adjoint in torch. From λ = 2·g·x
    the passes run in reverse (``gate_pass_backward_plain``)."""
    x = torch.complex(xr, xi).reshape(-1)
    lam = 2.0 * g.reshape(-1) * x
    dU = torch.zeros_like(U)
    Uh = U.conj().transpose(-1, -2)
    for ps in reversed(plan.gate_passes()):
        x, lam, parts = gate_pass_backward_plain(ps, Uh, x, lam)
        for (layer, q), part in parts.items():
            dU[layer, q] = part
    return dU


def _gate_tables(plan: GridPlan, device) -> tuple:
    """(spec, slots) on ``device``: the passes' records (P, GATE_SPEC_WORDS)
    and the (L·n, 2) int32 (offset, count) of each gate's partials."""
    key = ("gate_tables", str(device))
    if key not in plan._cache:
        plan._cache[key] = (torch.as_tensor(plan.gate_records().view(np.int32), device=device),
                            torch.as_tensor(plan.gate_slots().astype(np.int32), device=device))
    return plan._cache[key]


def _check_gates(plan: GridPlan, U: torch.Tensor) -> None:
    if U.device.type != "cuda" or U.dtype != torch.complex64:
        raise ValueError(f"circuit_gates kernel: U must be complex64 on a CUDA device, got "
                         f"{U.dtype} on {U.device}")
    if tuple(U.shape) != (plan.layers, plan.n, 2, 2):
        raise ValueError(f"circuit_gates kernel: U has shape {tuple(U.shape)}, want "
                         f"{(plan.layers, plan.n, 2, 2)}")


def circuit_gates_forward(U: torch.Tensor, plan: GridPlan) -> tuple:
    """probs, xr, xi (R, C) of the gates U (L, n, 2, 2). On the card:
    ``csrc/circuit_gates.cu``'s forward, one launch a pass, with a (2, R, C)
    scratch for the layers' out-of-place map stores."""
    if U.device.type == "cpu":
        return circuit_gates_forward_plain(U, plan)
    _check_gates(plan, U)
    u = torch.view_as_real(U.contiguous())
    probs = torch.empty((plan.R, plan.C), dtype=torch.float32, device=U.device)
    xr, xi = torch.empty_like(probs), torch.empty_like(probs)
    tmp = torch.empty((2, plan.R, plan.C), dtype=torch.float32, device=U.device)
    spec, _ = _gate_tables(plan, U.device)
    records = plan.gate_records()
    _lib.count_launch("circuit_gates_fwd")
    err = _lib.load("circuit_gates").tn_circuit_gates_forward(
        _lib.ptr(u), _lib.ptr(probs), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(tmp), _lib.ptr(spec),
        records.ctypes.data_as(ctypes.c_void_p), len(records), int(plan.has_wall),
        _lib.stream_ptr(U.device))
    _lib.check(err, "tn_circuit_gates_forward")
    return probs, xr, xi


def circuit_gates_backward(U, xr, xi, g, plan: GridPlan) -> torch.Tensor:
    """dU (L, n, 2, 2) for the cotangent g of the probs. On the card:
    ``csrc/circuit_gates.cu``'s backward, one launch a pass (in reverse),
    with two (4, R, C) scratch buffers and the per-tile partials, then one
    launch that sums each gate's partials in tile order."""
    if U.device.type == "cpu":
        return circuit_gates_backward_plain(U, xr, xi, g, plan)
    _check_gates(plan, U)
    u = torch.view_as_real(U.contiguous())
    du = torch.empty((plan.layers, plan.n, 2, 2, 2), dtype=torch.float32, device=U.device)
    buf_a = torch.empty((4, plan.R, plan.C), dtype=torch.float32, device=U.device)
    buf_b = torch.empty_like(buf_a)
    spec, slots = _gate_tables(plan, U.device)
    partials = torch.empty((plan.gate_partials(), 8), dtype=torch.float32, device=U.device)
    records = plan.gate_records()
    _lib.count_launch("circuit_gates_bwd")
    err = _lib.load("circuit_gates").tn_circuit_gates_backward(
        _lib.ptr(u), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(g), _lib.ptr(du), _lib.ptr(buf_a),
        _lib.ptr(buf_b), _lib.ptr(partials), _lib.ptr(slots), _lib.ptr(spec),
        records.ctypes.data_as(ctypes.c_void_p), len(records), plan.layers * plan.n,
        _lib.stream_ptr(U.device))
    _lib.check(err, "tn_circuit_gates_backward")
    return torch.view_as_complex(du)


class CircuitGatesFunction(torch.autograd.Function):
    """probs (R, C) of the per-layer gates U (L, n, 2, 2), with the
    gate-level adjoint backward (dU)."""

    @staticmethod
    def forward(ctx, U, plan: GridPlan):
        probs, xr, xi = circuit_gates_forward(U, plan)
        ctx.plan = plan
        ctx.save_for_backward(U, xr, xi)
        return probs

    @staticmethod
    def backward(ctx, g):
        with span("circuit.backward"):
            U, xr, xi = ctx.saved_tensors
            return circuit_gates_backward(U, xr, xi, g.contiguous(), ctx.plan), None


def make_circuit_gates_probs_fn(plan: GridPlan, conditioning: bool, reupload: bool):
    """``make_probs_fn``'s functions on the gate path: θ folds into the
    per-layer gates (``sim.gates.layer_rotations``), a wall into them per
    qubit (``sim.gates.fold_wall_gates``), and ``CircuitGatesFunction``
    runs the circuit."""
    return make_probs_fn(
        plan, lambda U: [U], CircuitGatesFunction, circuit_gates_forward, conditioning, reupload,
        rotations=lambda p: (layer_rotations(p, plan.n, plan.layers, plan.per_qubit),),
        wall=lambda ops, angles: (fold_wall_gates(ops[0], angles, reupload),))


# --------------------------------------------------------------------- wrappers


def _masks(plan: GridPlan):
    """rows, cz: the (L, n) host mask tables the launchers read."""
    return (plan.rows.ctypes.data_as(ctypes.c_void_p),
            plan.cz.ctypes.data_as(ctypes.c_void_p))


def _split_scratch(plan: GridPlan, backward: bool, device):
    """The wgmma loop's bf16 scratch for the plan's forward or backward, or
    None where its products do not run there."""
    elems = _lib.load(GridPlan.name).tn_circuit2d_grid_split_elems(plan.n, int(backward),
                                                                   CODES[plan.precision])
    return torch.empty(elems, dtype=torch.bfloat16, device=device) if elems else None


def circuit2d_grid_forward(mr_re, mr_im, mc_re, mc_im, plan: GridPlan):
    """probs, xr, xi (R, C) of the circuit with P_row-folded operators. On
    the card: ``csrc/circuit2d_grid.cu``'s host launcher, with a (2, R, C)
    scratch and a (2, L, C, C) scratch for Mcᵀ (the launcher transposes Mc
    there first, so that from n = 20 the right product's B streams by
    cp.async in the large GEMM loop), or, where the forward runs on the
    wgmma loop (from n = 20 under a bf16 precision), the loop's bf16 scratch
    and no Mcᵀ."""
    if mr_re.device.type == "cpu":
        return circuit2d_grid_forward_plain(mr_re, mr_im, mc_re, mc_im, plan)
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im)
    fn = _lib.load(plan.name).tn_circuit2d_grid_forward
    probs = torch.empty((plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    xr, xi = torch.empty_like(probs), torch.empty_like(probs)
    tmp = torch.empty((2, plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    split = _split_scratch(plan, False, mr_re.device)
    mct = None if split is not None else torch.empty(
        (2, plan.layers, plan.C, plan.C), dtype=torch.float32, device=mr_re.device)
    _lib.count_launch(_lib.launch_key("circuit2d_grid_fwd", plan.precision))
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(probs), _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(tmp),
             None if mct is None else _lib.ptr(mct), None if split is None else _lib.ptr(split),
             plan.n, plan.layers, int(plan.has_wall), CODES[plan.precision], *_masks(plan),
             _lib.stream_ptr(mr_re.device))
    _lib.check(err, "tn_circuit2d_grid_forward")
    return probs, xr, xi


def circuit2d_grid_backward(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan: GridPlan):
    """Gradients of the P_row-folded operators for the cotangent g of the
    probs. On the card: ``csrc/circuit2d_grid.cu``'s host launcher, with two
    (4, R, C) scratch buffers, and the wgmma loop's bf16 scratch where its
    pull-backs run there (from n = 19 under a bf16 precision)."""
    if mr_re.device.type == "cpu":
        return circuit2d_grid_backward_plain(mr_re, mr_im, mc_re, mc_im, xr, xi, g, plan)
    _check(plan, mr_re=mr_re, mr_im=mr_im, mc_re=mc_re, mc_im=mc_im, x_r=xr, x_i=xi, x_g=g)
    fn = _lib.load(plan.name).tn_circuit2d_grid_backward
    dmr_re, dmr_im = torch.empty_like(mr_re), torch.empty_like(mr_im)
    dmc_re, dmc_im = torch.empty_like(mc_re), torch.empty_like(mc_im)
    buf_a = torch.empty((4, plan.R, plan.C), dtype=torch.float32, device=mr_re.device)
    buf_b = torch.empty_like(buf_a)
    split = _split_scratch(plan, True, mr_re.device)
    _lib.count_launch(_lib.launch_key("circuit2d_grid_bwd", plan.precision))
    err = fn(_lib.ptr(mr_re), _lib.ptr(mr_im), _lib.ptr(mc_re), _lib.ptr(mc_im),
             _lib.ptr(xr), _lib.ptr(xi), _lib.ptr(g),
             _lib.ptr(dmr_re), _lib.ptr(dmr_im), _lib.ptr(dmc_re), _lib.ptr(dmc_im),
             _lib.ptr(buf_a), _lib.ptr(buf_b), None if split is None else _lib.ptr(split),
             plan.n, plan.layers, CODES[plan.precision],
             *_masks(plan), _lib.stream_ptr(mr_re.device))
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
        with span("circuit.backward"):
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
    the wall folded in (``reupload``: before every layer). ``probs.batch``
    runs several walls on one θ fold; ``probs.state`` gives the final state
    from the forward kernel. Under ``highest`` the gate path: the per-layer
    2x2 gates and ``CircuitGatesFunction``; under ``high`` and ``default``
    the operator planes (the wall folded in before the row gather) and
    ``Circuit2dGridFunction``."""
    plan = GridPlan(num_wires, layers, ansatz_type, edges)
    if plan.precision == "highest":
        return make_circuit_gates_probs_fn(plan, conditioning, reupload)
    return make_probs_fn(plan, lambda Mr, Mc: grid_planes(Mr, Mc, plan), Circuit2dGridFunction,
                         circuit2d_grid_forward, conditioning, reupload)
