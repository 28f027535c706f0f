"""The benchmark of ``cometbft_tpu_torch``, the PyTorch and CUDA port.

``BENCHMARK.json`` at the root of the repository names its cells,
configurations, traffic mixes and metrics; ``python3 -m portbench.run``
runs one cell once.  Nothing here imports ``jax`` or the JAX package.
"""
