from .born_quantum import QuantumBornMachine

__all__ = ["QuantumBornMachine"]
