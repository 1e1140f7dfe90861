"""gpubench: the benchmark of the PyTorch/CUDA port ``wavernn_tpu_torch``.

Run from the root of a checkout:

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

The cells, configurations and metrics are named in ``BENCHMARK.json``; each
has a file of its own here (``configs/``, ``workloads/``, ``limits/``,
``metrics/``), found by that name. Nothing here imports JAX or the JAX
package.
"""
