"""The benchmark of the PyTorch/CUDA port (``tensornetworks_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the repository's ``BENCHMARK.json`` once
and prints its result as the last line of standard output. Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the port.
"""
