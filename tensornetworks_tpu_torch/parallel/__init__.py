"""The distributed path: every 2^n buffer sharded over a ('dp', 'state')
mesh of ranks, one process per rank, on ``torch.distributed``.

Counterpart of ``tensornetworks_tpu/parallel/``, with ``spawn`` (start the
ranks of a run) added: the JAX package runs one controller over its
devices, the port one process per rank.
"""

from .distributed_ansatz import make_distributed_ansatz_probs
from .distributed_sampled import make_distributed_two_stage_sampler
from .distributed_train import (make_distributed_ksd_train_step, make_distributed_stein_matvec,
                                make_distributed_stein_quadform, place_stein_tables)
from .launch import spawn
from .mesh import DATA_AXIS, STATE_AXIS, data_shard, gather_full, make_mesh, replicate, state_shard
from .shard_state import (distributed_apply_1q, distributed_apply_cnot, distributed_apply_cz,
                          distributed_kron_matvec)
from .sharded import make_sharded_advi_classifier_step, make_sharded_ksd_step

__all__ = [
    "DATA_AXIS",
    "STATE_AXIS",
    "data_shard",
    "distributed_apply_1q",
    "distributed_apply_cnot",
    "distributed_apply_cz",
    "distributed_kron_matvec",
    "gather_full",
    "make_distributed_ansatz_probs",
    "make_distributed_ksd_train_step",
    "make_distributed_stein_matvec",
    "make_distributed_stein_quadform",
    "make_distributed_two_stage_sampler",
    "make_mesh",
    "make_sharded_advi_classifier_step",
    "make_sharded_ksd_step",
    "place_stein_tables",
    "replicate",
    "spawn",
    "state_shard",
]
