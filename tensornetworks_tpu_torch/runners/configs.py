"""Typed experiment configurations: the reference runners' shipped values.
Counterpart of ``tensornetworks_tpu/runners/configs.py`` (all but
``ScaleConfig``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class ClassicalKSDConfig:
    """The reference's shipped Sprinkler classical-KSD values
    (``run_sprinkler_ksd.py:32-60``)."""

    latent_vars: List[str] = field(default_factory=lambda: ["C", "S", "R"])
    observed: dict = field(default_factory=lambda: {"W": 1})
    use_logits: bool = True
    conditioning_dim: int = 1
    init_method: str = "uniform"
    hidden_dims: Optional[List[int]] = None
    use_layer_norm: bool = False
    base_kernel_length_scale: float = 1.0
    num_epochs: int = 2000
    lr: float = 3e-3
    use_lr_scheduler: bool = True
    gradient_clip_norm: float = 5.0
    optimizer_type: str = "adam"
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    entropy_weight: float = 1e-3
    patience: int = 200
    seed: int = 0


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


@dataclass
class AdversarialConfig:
    """The reference's shipped Sprinkler adversarial values
    (``run_sprinkler_adversarial.py:37-72``)."""

    latent_vars: List[str] = field(default_factory=lambda: ["C", "S", "R"])
    observed: dict = field(default_factory=lambda: {"W": 1})
    use_logits: bool = True
    conditioning_dim: int = 1
    init_method: str = "uniform"
    classifier_hidden_dims: List[int] = field(default_factory=lambda: [32, 16])
    use_batch_norm: bool = False
    num_epochs: int = 1500
    batch_size: int = 100
    lr_born: float = 3e-3
    lr_classifier: float = 3e-2
    k_classifier_steps: int = 5
    k_born_steps: int = 1
    use_lr_scheduler: bool = True
    gradient_clip_norm: float = 5.0
    baseline_decay: float = 0.95
    optimizer_type: str = "adam"
    adam_betas: Tuple[float, float] = (0.5, 0.999)
    seed: int = 0
