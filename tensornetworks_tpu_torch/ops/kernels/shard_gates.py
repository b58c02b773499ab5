"""Kernels 5-6's gate path on one shard of a state sharded over ranks, and
the global-pair combines, for ``parallel/distributed_ansatz.py``.

A rank of D = 2^k holds the 2^nl amplitudes (nl = n - k local bits) whose
leading k bits spell its index, as two planes (re, im). Its local qubits'
gates run as the one-card gate kernels' passes (``csrc/circuit_gates.cu``)
over those nl bits: ``shard_layer_passes`` is ``layer_gate_passes`` on nl
bits with the layer's CNOT map and CZ sign restricted to this rank, its
global bits entering as a constant XOR of the store address and a constant
sign (``GatePass.xout``); ``shard_map_pass`` is a pass of a map alone. Each
pass launches alone (``gates_forward_pass``, ``gates_backward_pass``): in
place where it has no map, out of place where it has one. The backward of
a map pass can run as two halves: the map undone on x and on λ alone
(``two=True``, two planes, no gate), then its gates in place (``nomap=True``).

A gate on one of the k global qubits pairs this rank with the partner whose
index differs in that bit. ``pair_forward`` / ``pair_backward`` combine a
piece of this rank's planes with the partner's (received by the caller):
element i takes the 2x2 W of table entry parity(idx & m1) | parity(idx &
m2) << 1, idx its local index, so a rotation is one entry and a CNOT whose
control is a local bit two (I, X). The backward un-computes x and λ in
place and sums this rank's row of the gate's dU.

Each wrapper takes its plain version (torch, the kernels' formulas) for CPU
tensors, in any float dtype; a CUDA tensor launches the kernel or raises.
Local widths up to ``LOCAL_MAX_BITS`` = 30: the kernels' flat indices are
32-bit, and a 2^30-amplitude shard (8 GiB in complex64) is the widest that
four H100s hold at n = 32 with the adjoint's buffers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _lib
from .circuit2d_grid import (GATE_TILE_BITS, GatePass, _gf2, _Span, gate_pass_backward_plain,
                             gate_pass_forward_plain, layer_gate_passes)

LOCAL_MAX_BITS = 30
PAIR_ELEMS = 4096  # csrc/circuit_gates.cu kPairElems: the elements of one dU record
KNOMAP, KTWO = 32, 64  # the backward pass's flags (csrc/circuit_gates.cu)


def _check_width(nl: int) -> None:
    if not 2 <= nl <= LOCAL_MAX_BITS:
        raise ValueError(f"a shard's plan takes 2 to {LOCAL_MAX_BITS} local bits, got {nl}")


def shard_layer_passes(nl: int, layer: int, rows, cz, xout: int = 0) -> list:
    """The passes of one layer's local gates on nl bits, the layer's local
    map ``rows`` and sign ``cz`` (nl masks each) and ``xout`` in the last
    pass's store; each pass's gates slotted from 0 (a layer's partials)."""
    _check_width(nl)
    passes = layer_gate_passes(nl, layer, rows, cz, xout=xout)
    _slot(passes, nl)
    return passes


def shard_map_pass(nl: int, layer: int, rows, cz, xout: int = 0,
                   kmax: int = GATE_TILE_BITS) -> GatePass:
    """A pass of a map and sign alone (no gate): its tile holds the 5 low
    bits (or all, below 5) and the map's preimage of them, so that loads
    and stores are coalesced, and further low bits up to ``kmax``."""
    _check_width(nl)
    m = min(5, nl)
    images = _Span([_gf2(rows, 1 << j) for j in range(nl)])
    V = _Span([1 << b for b in range(m)] + [images.coords(1 << b) for b in range(m)])
    for b in range(nl):
        if len(V) >= kmax:
            break
        V.add(1 << b)
    lin = [1 << b for b in range(nl) if (1 << b) in V]
    units = _Span(lin)
    lin += [r for r in (units.add(v) for v, _ in list(V.rows.values())) if r]
    return GatePass(nl, layer, m, lin, [], rows, cz, xout)


def _slot(passes: list, nl: int) -> int:
    offset = 0
    for ps in passes:
        ps.slots = []
        for _ in ps.gates:
            ps.slots.append(offset)
            offset += 1 << (nl - ps.k)
    return offset


def layer_slots(passes: list, nl: int) -> np.ndarray:
    """(nl, 2) int32 (offset, count) of each local qubit's partials."""
    slots = np.zeros((nl, 2), dtype=np.int32)
    for ps in passes:
        for (_, q), off in zip(ps.gates, ps.slots):
            slots[q] = off, 1 << (nl - ps.k)
    return slots


class PassTables:
    """The records of a list of passes on the host and on ``device``."""

    def __init__(self, passes: list, device):
        self.passes = passes
        self.host = np.stack([ps.record() for ps in passes]) if passes else None
        self.dev = (torch.as_tensor(self.host.view(np.int32), device=device)
                    if passes and torch.device(device).type == "cuda" else None)

    def ptrs(self, i: int) -> tuple:
        """(device record, host record) pointers of pass i."""
        return (ctypes.c_void_p(self.dev[i].data_ptr()),
                self.host[i].ctypes.data_as(ctypes.c_void_p))


def _c(planes: torch.Tensor) -> torch.Tensor:
    return torch.complex(planes[0], planes[1])


def _set(planes: torch.Tensor, x: torch.Tensor) -> None:
    planes[0].copy_(x.real)
    planes[1].copy_(x.imag)


def _check_cuda(*ts) -> None:
    """Each (2, P) argument (a tensor or a pair of planes): float32 on the
    card, each plane contiguous."""
    for t in [p for t in ts if t is not None for p in t]:
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"shard gate kernels: want float32 planes on the card, got "
                             f"{t.dtype} on {t.device}")


def gates_forward_pass(tables: PassTables, i: int, U: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor) -> None:
    """Pass i of ``tables`` on the planes src (2, 2^nl) into dst (src itself
    where the pass has no map). U: (L, nl, 2, 2) complex, the local gates."""
    ps = tables.passes[i]
    if src.device.type == "cpu":
        _set(dst, gate_pass_forward_plain(ps, U, _c(src)))
        return
    if ps.map and dst.data_ptr() == src.data_ptr():
        raise ValueError("a map pass stores out of place")
    _check_cuda(src, dst)
    u = torch.view_as_real(U.contiguous())
    spec, host = tables.ptrs(i)
    _lib.count_launch("gates_pass_fwd")
    err = _lib.load("circuit_gates").tn_gates_forward_pass(
        _lib.ptr(u), spec, host, _lib.ptr(src[0]), _lib.ptr(src[1]), _lib.ptr(dst[0]),
        _lib.ptr(dst[1]), _lib.stream_ptr(src.device))
    _lib.check(err, "tn_gates_forward_pass")


def gates_backward_pass(tables: PassTables, i: int, U: torch.Tensor, x: torch.Tensor, lam,
                        x_out: torch.Tensor, lam_out, partials, dU_plain: dict,
                        nomap: bool = False, two: bool = False) -> None:
    """The adjoint of pass i on the planes x and lam (2, 2^nl) into x_out,
    lam_out (in place where unmapped). ``two``: the map and sign undone on
    x alone (lam None), no gate; ``nomap``: the pass's gates with its map
    taken as undone. On the card each gate's partial records go to
    ``partials`` at its slot; on the CPU its sums to ``dU_plain``."""
    ps = tables.passes[i]
    if x.device.type == "cpu":
        Uh = U.conj().transpose(-1, -2)
        xo, lo, parts = gate_pass_backward_plain(ps, Uh, _c(x), None if two else _c(lam),
                                                 mapped=not nomap, gates=not two)
        _set(x_out, xo)
        if not two:
            _set(lam_out, lo)
        dU_plain.update(parts)
        return
    _check_cuda(x, x_out, lam, lam_out)
    u = torch.view_as_real(U.contiguous())
    spec, host = tables.ptrs(i)
    src = [x[0], x[1]] + ([None, None] if two else [lam[0], lam[1]])
    dst = [x_out[0], x_out[1]] + ([None, None] if two else [lam_out[0], lam_out[1]])
    flags = (KTWO if two else 0) | (KNOMAP if nomap else 0)
    _lib.count_launch("gates_pass_bwd")
    err = _lib.load("circuit_gates").tn_gates_backward_pass(
        _lib.ptr(u), spec, host, *[None if t is None else _lib.ptr(t) for t in src + dst],
        None if partials is None else _lib.ptr(partials), flags, _lib.stream_ptr(x.device))
    _lib.check(err, "tn_gates_backward_pass")


def gates_reduce(partials: torch.Tensor, slots: torch.Tensor, nslots: int) -> torch.Tensor:
    """(nslots, 2, 2) complex64: each slot's partial records summed in order."""
    du = torch.empty((nslots, 2, 2, 2), dtype=torch.float32, device=partials.device)
    _lib.count_launch("gates_reduce")
    err = _lib.load("circuit_gates").tn_gates_reduce(
        _lib.ptr(partials), _lib.ptr(slots), _lib.ptr(du), nslots,
        _lib.stream_ptr(partials.device))
    _lib.check(err, "tn_gates_reduce")
    return torch.view_as_complex(du)


# ----------------------------------------------------------- global pairs


def _entries(n: int, offset: int, m1: int, m2: int, device) -> torch.Tensor:
    idx = offset + torch.arange(n, dtype=torch.int64, device=device)
    par = []
    for m in (m1, m2):
        p = idx & m
        for shift in (16, 8, 4, 2, 1):
            p = p ^ (p >> shift)
        par.append(p & 1)
    return par[0] | (par[1] << 1)


def pair_forward_plain(mine, theirs, coef: torch.Tensor, offset: int, m1: int, m2: int,
                       b: int) -> None:
    """``pair_forward`` in torch, on any device and float dtype."""
    W = coef[_entries(mine.shape[1], offset, m1, m2, mine.device)]
    _set(mine, W[:, b, b] * _c(mine) + W[:, b, 1 - b] * _c(theirs))


def pair_backward_plain(x, lam, tx, tl, coef: torch.Tensor, offset: int, m1: int, m2: int,
                        b: int, grad: bool = False):
    """``pair_backward`` in torch, on any device and float dtype; with
    ``grad`` the (2, 2) sum of dU (row b filled)."""
    W = coef[_entries(x.shape[1], offset, m1, m2, x.device)]
    Wh = W.conj()
    xa, la = [None, None], [None, None]
    xa[b], xa[1 - b] = _c(x), _c(tx)
    la[b], la[1 - b] = _c(lam), _c(tl)
    xb = [Wh[:, 0, c] * xa[0] + Wh[:, 1, c] * xa[1] for c in (0, 1)]
    lb = Wh[:, 0, b] * la[0] + Wh[:, 1, b] * la[1]
    dU = None
    if grad:
        dU = torch.zeros((2, 2), dtype=xb[0].dtype, device=x.device)
        dU[b] = torch.stack([(la[b] * xb[c].conj()).sum() for c in (0, 1)])
    _set(x, xb[b])
    _set(lam, lb)
    return dU


def pair_forward(mine: torch.Tensor, theirs: torch.Tensor, coef: torch.Tensor, offset: int,
                 m1: int, m2: int, b: int) -> None:
    """mine (2, P) ← W[b][b]·mine + W[b][1-b]·theirs (a pair of planes),
    element by element, W the table entry of its local index offset + i;
    coef (E, 2, 2) complex."""
    if mine.device.type == "cpu":
        pair_forward_plain(mine, theirs, coef, offset, m1, m2, b)
        return
    _check_cuda(mine, theirs)
    w = torch.view_as_real(coef.to(torch.complex64).contiguous())
    _lib.count_launch("pair_fwd")
    err = _lib.load("circuit_gates").tn_pair_forward(
        _lib.ptr(mine[0]), _lib.ptr(mine[1]), _lib.ptr(theirs[0]), _lib.ptr(theirs[1]),
        _lib.ptr(w), offset, mine.shape[1], m1, m2, b, _lib.stream_ptr(mine.device))
    _lib.check(err, "tn_pair_forward")


def pair_records(count: int) -> int:
    """The dU records ``pair_backward`` writes for ``count`` elements."""
    return -(-count // PAIR_ELEMS)


def pair_backward(x: torch.Tensor, lam: torch.Tensor, tx, tl, coef: torch.Tensor, offset: int,
                  m1: int, m2: int, b: int, partials=None, grad: bool = False):
    """The adjoint of ``pair_forward`` on x and λ (2, P) with the partner's
    pieces tx, tl (each a pair of planes): x, λ ← (Wᴴ x)_b, (Wᴴ λ)_b in
    place. ``grad`` (a gate's combine): on the card one record of dU's row
    b a ``PAIR_ELEMS`` elements into ``partials``; on the CPU the (2, 2)
    sum is returned."""
    if x.device.type == "cpu":
        return pair_backward_plain(x, lam, tx, tl, coef, offset, m1, m2, b, grad)
    _check_cuda(x, lam, tx, tl)
    w = torch.view_as_real(coef.to(torch.complex64).contiguous())
    _lib.count_launch("pair_bwd")
    err = _lib.load("circuit_gates").tn_pair_backward(
        *[_lib.ptr(t) for t in (x[0], x[1], lam[0], lam[1], tx[0], tx[1], tl[0], tl[1], w)],
        _lib.ptr(partials) if grad else None, offset, x.shape[1], m1, m2, b,
        _lib.stream_ptr(x.device))
    _lib.check(err, "tn_pair_backward")
    return None
