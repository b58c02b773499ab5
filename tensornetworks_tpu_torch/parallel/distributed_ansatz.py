"""Whole circuits on a state-sharded register: a memory-lean adjoint executor.

Counterpart of ``tensornetworks_tpu/parallel/distributed_ansatz.py``. The
(2^n,) state is sharded over the mesh's ``state`` axis of D = 2^k ranks as
in ``shard_state``: rank i holds the 2^(n-k) amplitudes whose leading k
("global") qubits spell i, here as two planes (re, im). The circuit is the
ansatz's primitive program (``sim.adjoint.primitive_ansatz_program``) with
each layer's rotations of one qubit fused into one 2x2 gate U[l, q]
(``sim.gates.layer_rotations``; a conditioning wall folded in by
``fold_wall_gates``). A layer runs as:

1. the gates of the global qubits: each pairs this rank with the partner
   whose index differs in that bit, the partner's shard received through
   ``comm.exchange`` in pieces of ``PIECE`` amplitudes a plane and combined
   into this rank's (``ops.kernels.shard_gates.pair_forward``), so no second
   shard-sized buffer exists;
2. the layer's CNOTs between global qubits (a whole-shard swap between
   partners, in pieces) where they come first;
3. the local qubits' gates as the gate kernels' passes over the shard's
   local bits (``shard_gates.shard_layer_passes``), the last pass storing
   through the layer's CNOT map restricted to this rank: the local CNOTs,
   and a CNOT from a global control as a constant XOR on the ranks whose
   control bit is 1;
4. the CNOTs whose target is global and control local (``comm.exchange``
   and a combine taking the partner's amplitude where the control bit is
   1), and any further local CNOTs as a pass of their map alone.

CZs are diagonal and never communicate: the layer's CZ sign is carried back
through the CNOTs that follow the last local map (a GF(2) change of
variables of its quadratic form) and stored by that map's pass, restricted
to this rank (a Z on a local bit where a global partner is 1, a constant
sign where both are).

``_LeanCircuit`` is one ``torch.autograd.Function``: the forward keeps the
final shard alone (and θ's gates); the backward forms λ = 2·(dL/dq)·ψ and
runs the program in reverse on (ψ, λ), un-computing ψ while carrying λ back
and summing each gate's Σ λ_r·conj(ψ_c) into dU (a global gate's row of
this rank's bit: the rows of the other ranks come with the gradient's sum
over the ranks, ``comm.MeshReducer.grads``). State memory is ψ, λ and one
scratch shard (a map pass stores out of place) per rank. The exchanges look
``comm.exchange`` up at each call. On CPU tensors the passes and combines
run as the kernels' plain versions, in the state's dtype.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.kernels import shard_gates as sg
from ..ops.kernels.circuit2d import WALL_ANSATZE, cz_masks, gf2_rows
from ..ops.kernels.circuit2d_grid import GATE_NEGATE
from ..sim.adjoint import primitive_ansatz_program
from ..sim.gates import fold_wall_gates, layer_rotations
from ..train import span
from . import comm
from .mesh import STATE_AXIS, axis_index, axis_size
from .shard_state import num_global_bits

# Amplitudes of one plane an exchange moves at a time: 256 MiB in FP32, so
# the backward's four planes of a piece take 1 GiB.
PIECE = 1 << 26
# Pieces whose combine may be queued on the device before the host waits
# for the oldest (bounds the receive buffers in flight).
IN_FLIGHT = 2


def _parity(v: int) -> int:
    return bin(v).count("1") & 1


def _masks(a) -> List[int]:
    return [int(v) for v in a]


def _pull_back(cz: List[int], rows: List[int]) -> List[int]:
    """The CZ masks of f∘M, f the quadratic form of ``cz`` and M the linear
    map of ``rows`` (bit k of M·x is parity(rows[k] & x)):
    f(Mx) = Σ_k parity(x & rows[k])·parity(x & s_k), s_k = XOR of rows[j]
    over j in cz[k], so each bit i of rows[k] takes s_k into its mask."""
    out = [0] * len(cz)
    for k, mask in enumerate(cz):
        if not mask:
            continue
        s = 0
        for j in range(len(rows)):
            if (mask >> j) & 1:
                s ^= rows[j]
        for i in range(len(rows)):
            if (rows[k] >> i) & 1:
                out[i] ^= s
    return out


@dataclass
class _Stage:
    """One step of a layer: ``kind`` "gg" (a CNOT between global qubits),
    "lg" (global target, local control) or "map" (a pass of a local map);
    ``gate`` the CNOT's (control, target) qubits."""
    kind: str
    gate: tuple = ()
    tables: Optional[sg.PassTables] = None
    passes: list = field(default_factory=list)


class ShardProgram:
    """The schedule of one circuit on this rank (index ``idx`` of D = 2^k
    on the state axis): per layer, the global gates, the leading global
    CNOTs (``pre``), the local passes and the stages after them."""

    def __init__(self, n: int, layers: int, ansatz_type: str, k: int, idx: int, edges=None):
        self.n, self.L, self.k, self.idx = n, layers, k, idx
        self.nl = nl = n - k
        self.per_qubit = 3 if ansatz_type in WALL_ANSATZE else 2
        self.wall = ansatz_type in WALL_ANSATZE
        program = primitive_ansatz_program(n, layers, ansatz_type, edges=edges)
        ents = [[] for _ in range(layers)]
        cur = -1
        for op in program:
            if op[0] == "r":
                cur = op[3] // (self.per_qubit * n)
            elif op[0] in ("cnot", "cz"):
                ents[cur].append(op)
        self.pre, self.rest, self.passes = [], [], []
        for layer, ops in enumerate(ents):
            cnots = [(op[1], op[2]) for op in ops if op[0] == "cnot"]
            czs = [(op[1], op[2]) for op in ops if op[0] == "cz"]
            if czs and ops[-len(czs):] != [("cz", a, b) for a, b in czs]:
                raise ValueError("a layer's CZs must follow its CNOTs")
            self._plan_layer(layer, cnots, czs)
        self.slots = [sg.layer_slots(p, nl) for p in self.passes]
        self.records = [int(s[:, 1].sum()) for s in self.slots]
        self._dev = {}

    def _kind(self, c: int, t: int) -> str:
        k = self.k
        return {(True, True): "gg", (True, False): "gl", (False, True): "lg",
                (False, False): "ll"}[(c < k, t < k)]

    def _local(self, run, cz_full: Optional[List[int]]):
        """(rows, cz, xout) on the local bits of the CNOT run's map and the
        sign ``cz_full`` (at its output, full index), for this rank."""
        n, nl, g = self.n, self.nl, self.idx
        low = (1 << nl) - 1
        full = _masks(gf2_rows(n, run))
        if any(full[b] != 1 << b for b in range(nl, n)):
            raise AssertionError("a local map moves a global bit")
        rows = np.array([full[b] & low for b in range(nl)], dtype=np.uint32)
        xout = sum(_parity((full[b] >> nl) & g) << b for b in range(nl))
        cz = [0] * nl
        neg = 0
        for b, mask in enumerate(cz_full or ()):
            if not mask:
                continue
            mloc, pg = mask & low, _parity((mask >> nl) & g)
            if b < nl:
                cz[b] ^= mloc ^ (pg << b)
            elif (g >> (b - nl)) & 1:  # a global bit that is 1 here
                for j in range(nl):
                    if (mloc >> j) & 1:
                        cz[j] ^= 1 << j
                neg ^= pg
        return rows, np.array(cz, dtype=np.uint32), xout | (GATE_NEGATE if neg else 0)

    def _plan_layer(self, layer: int, cnots, czs) -> None:
        n = self.n
        items, run = [], []
        for c, t in cnots:
            kind = self._kind(c, t)
            if kind in ("ll", "gl"):
                run.append((c, t))
                continue
            if run:
                items.append(("map", run))
                run = []
            items.append((kind, (c, t)))
        if run:
            items.append(("map", run))
        first = next((i for i, it in enumerate(items) if it[0] == "map"), None)
        if first is not None and all(it[0] == "gg" for it in items[:first]):
            pre, rot_run, rest = items[:first], items[first][1], items[first + 1:]
        else:
            pre, rot_run, rest = [], [], items
        # The CZ sign goes to the last map, carried back through what follows it.
        last = max((i for i, it in enumerate(rest) if it[0] == "map"), default=None)
        cz_full = _masks(cz_masks(n, czs)) if czs else None
        if cz_full is not None:
            for kind, gate in reversed(rest[last + 1:] if last is not None else rest):
                cz_full = _pull_back(cz_full, _masks(gf2_rows(n, [gate])))
        rows, cz, xout = self._local(rot_run, cz_full if last is None else None)
        self.passes.append(sg.shard_layer_passes(self.nl, layer, rows, cz, xout))
        self.pre.append([_Stage(kind, gate) for kind, gate in pre])
        stages = []
        for i, (kind, what) in enumerate(rest):
            if kind == "map":
                rows, cz, xout = self._local(what, cz_full if i == last else None)
                stages.append(_Stage("map", passes=[sg.shard_map_pass(self.nl, layer, rows, cz,
                                                                      xout)]))
            else:
                stages.append(_Stage(kind, what))
        self.rest.append(stages)

    def tables(self, device):
        """The passes' records on ``device``: each layer's local passes, and
        the map stages' (set on the stages)."""
        key = str(device)
        if key not in self._dev:
            for stages in self.rest:
                for st in stages:
                    if st.kind == "map":
                        st.tables = sg.PassTables(st.passes, device)
            self._dev[key] = ([sg.PassTables(p, device) for p in self.passes],
                              [torch.as_tensor(s, device=device) for s in self.slots])
        return self._dev[key]


class _Runner:
    """The executor's work on one call: ``forward`` from the gates U, and
    ``backward`` from the final shard and the cotangent of its q."""

    def __init__(self, prog: ShardProgram, mesh: DeviceMesh, device):
        self.p, self.mesh = prog, mesh
        self.cuda = torch.device(device).type == "cuda"
        self.layer_tables, self.slots = prog.tables(device)
        self.events = collections.deque()

    # -- pieces and exchanges ----------------------------------------------------

    def _pieces(self, size: int):
        return [(a, min(a + PIECE, size)) for a in range(0, size, PIECE)]

    def _bit(self, q: int) -> int:
        return (self.p.idx >> (self.p.k - 1 - q)) & 1

    def _recv(self, planes: torch.Tensor, a: int, e: int, q: int):
        """The partner's (along global qubit q) planes [a, e), as a pair."""
        bit = 1 << (self.p.k - 1 - q)
        return tuple(comm.exchange(planes[h, a:e], self.mesh, bit) for h in (0, 1))

    def _throttle(self) -> None:
        """At most IN_FLIGHT pieces queued past the host."""
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > IN_FLIGHT:
            self.events.popleft().synchronize()

    def swap(self, bufs, gate) -> None:
        """CNOT(c, t) between global qubits: the ranks whose c bit is 1 take
        the partner's (along t) shard, piece by piece."""
        c, t = gate
        if not self._bit(c):
            return
        for a, e in self._pieces(bufs[0].shape[1]):
            for buf in bufs:
                for h, theirs in enumerate(self._recv(buf, a, e, t)):
                    buf[h, a:e].copy_(theirs)
            self._throttle()

    def _cnot_table(self, dtype, device):
        eye = torch.eye(2, dtype=dtype, device=device)
        return torch.stack([eye, eye.flip(0)])

    def pair(self, psi, coef, q: int, m1: int) -> None:
        b = self._bit(q)
        for a, e in self._pieces(psi.shape[1]):
            sg.pair_forward(psi[:, a:e], self._recv(psi, a, e, q), coef, a, m1, 0, b)
            self._throttle()

    def pair_adjoint(self, psi, lam, coef, q: int, m1: int, grad: bool):
        """The adjoint of ``pair``; with ``grad`` the (2, 2) dU row this rank sums."""
        b = self._bit(q)
        pieces = self._pieces(psi.shape[1])
        partials = None
        if grad and self.cuda:
            partials = torch.empty((sum(sg.pair_records(e - a) for a, e in pieces), 8),
                                   dtype=torch.float32, device=psi.device)
        dU, rec = None, 0
        for a, e in pieces:
            tx, tl = self._recv(psi, a, e, q), self._recv(lam, a, e, q)
            part = sg.pair_backward(psi[:, a:e], lam[:, a:e], tx, tl, coef, a, m1, 0, b,
                                    None if partials is None else partials[rec:], grad)
            rec += sg.pair_records(e - a)
            if part is not None:
                dU = part if dU is None else dU + part
            self._throttle()
        if partials is not None:
            slots = torch.tensor([[0, rec]], dtype=torch.int32, device=psi.device)
            dU = sg.gates_reduce(partials, slots, 1)[0]
        return dU

    # -- the circuit ----------------------------------------------------------------

    def initial(self, dtype, device) -> torch.Tensor:
        p = self.p
        psi = torch.zeros((2, 1 << p.nl), dtype=dtype, device=device)
        if p.wall:
            psi[0].fill_(2.0 ** (-0.5 * p.n))
        elif p.idx == 0:
            psi[0, 0] = 1.0
        return psi

    def _passes(self, tables, U, psi, scratch):
        for i, ps in enumerate(tables.passes):
            if ps.map:
                if scratch is None:
                    scratch = torch.empty_like(psi)
                sg.gates_forward_pass(tables, i, U, psi, scratch)
                psi, scratch = scratch, psi
            else:
                sg.gates_forward_pass(tables, i, U, psi, psi)
        return psi, scratch

    def forward(self, U: torch.Tensor) -> torch.Tensor:
        p = self.p
        psi = self.initial(U.real.dtype, U.device)
        Uloc = U[:, p.k:].contiguous()
        cnot = self._cnot_table(U.dtype, U.device)
        scratch = None
        for layer in range(p.L):
            for q in range(p.k):
                self.pair(psi, U[layer, q:q + 1], q, 0)
            for st in p.pre[layer]:
                self.swap([psi], st.gate)
            psi, scratch = self._passes(self.layer_tables[layer], Uloc, psi, scratch)
            for st in p.rest[layer]:
                if st.kind == "map":
                    psi, scratch = self._passes(st.tables, Uloc, psi, scratch)
                elif st.kind == "gg":
                    self.swap([psi], st.gate)
                else:
                    c, t = st.gate
                    self.pair(psi, cnot, t, 1 << (p.n - 1 - c))
        return psi

    def _adjoint_passes(self, tables, U, psi, lam, scratch, partials, parts):
        for i in reversed(range(len(tables.passes))):
            ps = tables.passes[i]
            if ps.map:
                if scratch is None:
                    scratch = torch.empty_like(psi)
                sg.gates_backward_pass(tables, i, U, psi, None, scratch, None, None, parts,
                                       two=True)
                psi, scratch = scratch, psi
                sg.gates_backward_pass(tables, i, U, lam, None, scratch, None, None, parts,
                                       two=True)
                lam, scratch = scratch, lam
                if ps.gates:
                    sg.gates_backward_pass(tables, i, U, psi, lam, psi, lam, partials, parts,
                                           nomap=True)
            else:
                sg.gates_backward_pass(tables, i, U, psi, lam, psi, lam, partials, parts)
        return psi, lam, scratch

    def backward(self, U: torch.Tensor, psi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        p = self.p
        lam = psi * g.to(psi.dtype)
        lam.mul_(2.0)
        dU = torch.zeros_like(U)
        Uloc = U[:, p.k:].contiguous()
        cnot = self._cnot_table(U.dtype, U.device)
        scratch = None
        for layer in reversed(range(p.L)):
            for st in reversed(p.rest[layer]):
                if st.kind == "map":
                    psi, lam, scratch = self._adjoint_passes(st.tables, Uloc, psi, lam, scratch,
                                                             None, {})
                elif st.kind == "gg":
                    self.swap([psi, lam], st.gate)
                else:
                    c, t = st.gate
                    self.pair_adjoint(psi, lam, cnot, t, 1 << (p.n - 1 - c), False)
            partials, parts = None, {}
            if self.cuda:
                partials = torch.empty((p.records[layer], 8), dtype=torch.float32,
                                       device=psi.device)
            psi, lam, scratch = self._adjoint_passes(self.layer_tables[layer], Uloc, psi, lam,
                                                     scratch, partials, parts)
            if self.cuda:
                dU[layer, p.k:] = sg.gates_reduce(partials, self.slots[layer], p.nl)
            else:
                for (_, q), part in parts.items():
                    dU[layer, p.k + q] = part
            for st in reversed(p.pre[layer]):
                self.swap([psi, lam], st.gate)
            for q in reversed(range(p.k)):
                dU[layer, q] = self.pair_adjoint(psi, lam, U[layer, q:q + 1], q, 0, True)
        return dU


class _LeanCircuit(torch.autograd.Function):
    """This rank's q = |ψ|² shard of the circuit of gates U (L, n, 2, 2),
    with the un-computing adjoint as its backward (dU)."""

    @staticmethod
    def forward(ctx, U, prog: ShardProgram, mesh):
        with span("circuit.forward"):
            runner = _Runner(prog, mesh, U.device)
            psi = runner.forward(U)
            q = psi[0].square()
            q.addcmul_(psi[1], psi[1])
        ctx.prog, ctx.mesh = prog, mesh
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(U, psi)
        return q

    @staticmethod
    def backward(ctx, g):
        with span("circuit.backward"):
            U, psi = ctx.saved_tensors
            runner = _Runner(ctx.prog, ctx.mesh, U.device)
            return runner.backward(U, psi, g.contiguous()), None, None


def make_distributed_ansatz_probs(mesh: DeviceMesh, num_wires: int, layers: int,
                                  ansatz_type: str, dtype=torch.complex64, edges=None,
                                  conditioning: bool = False):
    """``probs(params[, embed_angles])``: this rank's (2^n/D,) shard of the
    circuit's |ψ|², differentiable in ``params`` (and the angles).
    ``ansatz_type='bn_structured'`` takes ``edges``; ``conditioning=True``
    adds an RY(embed_angles[q]) wall between the Hadamard wall and the
    first rotation (the angle-embedding conditioning), and the function
    then takes the angles as its second argument. On the card the state is
    complex64 (the gate kernels are FP32)."""
    program = primitive_ansatz_program(num_wires, layers, ansatz_type, edges=edges)
    if conditioning and not any(op[0] == "r" for op in program):
        raise ValueError("conditioning requires a parameterized ansatz")
    k = num_global_bits(mesh)
    if 2**k != axis_size(mesh, STATE_AXIS):
        raise ValueError("the state axis must be a power of two")
    prog = ShardProgram(num_wires, layers, ansatz_type, k, axis_index(mesh, STATE_AXIS),
                        edges=edges)

    def run(params: torch.Tensor, embed_angles=None) -> torch.Tensor:
        U = layer_rotations(params, num_wires, layers, prog.per_qubit)
        if conditioning:
            U = fold_wall_gates(U, torch.as_tensor(embed_angles, device=params.device), False)
        return _LeanCircuit.apply(U.to(dtype), prog, mesh)

    if conditioning:
        return run
    return lambda params: run(params)
