"""The benchmark of ``blt_tpu_torch`` on one NVIDIA H100: file-to-file
tokenization through the port's CLI and Python API, judged against a plain
PyTorch reference.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; each has a file of its own
under this folder (``configs/``, ``traffic/``, ``metrics/``, ``tables/``),
found by that name. Nothing here imports ``jax`` or the JAX
package; ``reference/`` and ``common/`` import nothing of the port.
"""
