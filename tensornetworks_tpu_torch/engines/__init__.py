from .advi import AdversarialVariationalInference
from .amortized import AmortizedKSD, train_multi_seed
from .common import cosine_lr_schedule, global_norm, guarded_update, make_optimizer
from .distill import fit_born_machine, fit_conditioned_born_machine, marginals_product
from .ksd import KSDVariationalInference, QuantumKSDVariationalInference, run_ksd_scan
from .sampled import SampledKSDVariationalInference

# The distributed engines import torch.distributed's mesh and collectives
# only when one of them is first named, so that importing the package for a
# single-device run loads nothing of the distributed path.
_DISTRIBUTED = {"DistributedQuantumKSDVariationalInference": "distributed",
                "DistributedSteinOperator": "distributed",
                "DistributedSampledKSDVariationalInference": "distributed_sampled"}


def __getattr__(name):
    if name in _DISTRIBUTED:
        import importlib

        return getattr(importlib.import_module(f".{_DISTRIBUTED[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdversarialVariationalInference",
    "AmortizedKSD",
    "DistributedQuantumKSDVariationalInference",
    "DistributedSampledKSDVariationalInference",
    "DistributedSteinOperator",
    "KSDVariationalInference",
    "QuantumKSDVariationalInference",
    "SampledKSDVariationalInference",
    "cosine_lr_schedule",
    "fit_born_machine",
    "fit_conditioned_born_machine",
    "global_norm",
    "guarded_update",
    "make_optimizer",
    "marginals_product",
    "run_ksd_scan",
    "train_multi_seed",
]
