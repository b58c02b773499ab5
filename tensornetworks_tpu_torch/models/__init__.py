from .born_classical import ClassicalBornMachine
from .born_quantum import QuantumBornMachine
from .classifier import BinaryClassifierMLP

__all__ = ["BinaryClassifierMLP", "ClassicalBornMachine", "QuantumBornMachine"]
