from .checkpoint import load_checkpoint, save_checkpoint, training_bundle
from .profiling import StepTimer, debug_nans, profile_trace, span

__all__ = [
    "StepTimer",
    "debug_nans",
    "load_checkpoint",
    "profile_trace",
    "save_checkpoint",
    "span",
    "training_bundle",
]
