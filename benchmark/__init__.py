"""The benchmark of the PyTorch / CUDA port (``pychebyshev_tpu_torch``).

``BENCHMARK.json`` at the repository's root names the cells; run one
with ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``.  Nothing here imports JAX or the JAX package.
"""
