"""Sharded training steps over a ('dp', 'state') mesh.

Counterpart of ``tensornetworks_tpu/parallel/sharded.py``, where GSPMD
partitions a whole jitted step from sharding constraints. The port has no
partitioner: the KSD step runs the circuit and the Stein operator on the
state shards explicitly (``distributed_ansatz``, ``distributed_train``),
and the discriminator step shards its batch over ``dp`` and averages the
gradients by all-reduce.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.born_quantum import QuantumBornMachine
from ..ops.stein import SteinOperator
from .comm import MeshReducer, all_gather, all_reduce
from .distributed_ansatz import make_distributed_ansatz_probs
from .distributed_train import _DistributedQuadForm, make_distributed_stein_matvec
from .mesh import DATA_AXIS, axis_size, data_shard, state_shard


def make_sharded_ksd_step(qbm: QuantumBornMachine, op: SteinOperator, mesh: DeviceMesh,
                          optimizer):
    """One quantum-KSD step (forward → loss → gradient → update) with the
    state axis sharded over the mesh: ``step(params, opt_state) ->
    (params, opt_state, loss)``, params and loss the same on every rank.

    The circuit is ``qbm``'s ansatz run gate by gate on the shards. The
    operator is ``op``'s: a dense Gram (n ≤ 12) contributes this rank's rows
    (its matvec gathers q), the gcorr form its score rows through the
    distributed n+1-column matvec."""
    if not op.dense and op.gcorr is None:
        raise ValueError("make_sharded_ksd_step needs the gcorr-tables "
                         "operator path (dense=False, use_pallas=False)")
    if qbm.conditioning_dim:
        raise ValueError("make_sharded_ksd_step takes an unconditioned Born machine")
    n = qbm.num_latent_vars
    cdtype = torch.complex128 if qbm.dtype == torch.float64 else torch.complex64
    probs_fn = make_distributed_ansatz_probs(mesh, n, qbm.ansatz_layers, qbm.ansatz_type,
                                             dtype=cdtype, edges=qbm.edges)
    if op.dense:
        table = state_shard(op.gram, mesh)

        def matvec(q, G):
            return G @ torch.cat(all_gather(q, mesh).unbind(0))
    else:
        table = state_shard(op.S, mesh)
        matvec = make_distributed_stein_matvec(mesh, n, op.length_scale)
    reducer = MeshReducer(mesh)

    def step(params, opt_state):
        p = params.detach().requires_grad_(True)
        q = probs_fn(p).to(table.dtype)
        quad = _DistributedQuadForm.apply(q, table, matvec, mesh)
        loss = torch.sqrt(torch.clamp(quad, min=1e-12))
        (grads,) = torch.autograd.grad(loss, p)
        params, opt_state = optimizer.update(reducer.grads(grads), opt_state, params)
        return params, opt_state, loss.detach()

    return step


def make_sharded_advi_classifier_step(clf, mesh: DeviceMesh, optimizer, batch_size: int,
                                      input_dim: int):
    """The discriminator step with the batch sharded over ``dp``:
    ``step(params, opt_state, inputs, labels) -> (params, opt_state, loss)``
    on the full (B, input_dim) batch and (B, 1) labels, each rank taking
    its B/dp rows; the BCE-with-logits of the whole batch, its gradient
    averaged over ``dp`` by all-reduce."""
    del batch_size, input_dim
    dp = axis_size(mesh, DATA_AXIS)

    def step(params, opt_state, inputs, labels):
        x, y = data_shard(inputs, mesh), data_shard(labels, mesh)
        p = params.detach().requires_grad_(True)
        logits = clf.logits(p, x)[0]
        loss = (torch.clamp(logits, min=0) - logits * y
                + torch.log1p(torch.exp(-logits.abs()))).mean()
        (grads,) = torch.autograd.grad(loss, p)
        if dp > 1:
            grads = all_reduce(grads, mesh, DATA_AXIS) / dp
            loss = all_reduce(loss.detach(), mesh, DATA_AXIS) / dp
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step

