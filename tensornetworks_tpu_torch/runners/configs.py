"""Typed experiment configurations (counterpart of
``tensornetworks_tpu/runners/configs.py``; the quantum KSD config only)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class QuantumKSDConfig:
    """The reference's shipped Sprinkler quantum-KSD values
    (``run_sprinkler_quantum_ksd.py:34-46``)."""

    latent_vars: List[str] = field(default_factory=lambda: ["C", "S", "R"])
    observed: dict = field(default_factory=lambda: {"W": 1})
    ansatz_layers: int = 4
    ansatz_type: str = "hardware_efficient"
    init_method: str = "small_random"
    base_kernel_length_scale: float = 1.0
    num_epochs: int = 1000
    lr: float = 5e-3
    use_lr_scheduler: bool = True
    gradient_clip_norm: float = 10.0
    optimizer_type: str = "adam"
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    seed: int = 0
