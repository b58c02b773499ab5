"""Reference-parity alias module: the reference ships the quantum engine as
a module of its own with the classical engine's class name. Counterpart of
``tensornetworks_tpu/engines/ksd_quantum.py``."""

from .ksd import QuantumKSDVariationalInference as KSDVariationalInference

__all__ = ["KSDVariationalInference"]
