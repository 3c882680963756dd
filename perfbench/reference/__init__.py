"""The plain reference of the benchmark: the models and the SAVIC round in
plain PyTorch, fp32, written from the published descriptions and the
configuration files in ``perfbench/configs``. It imports nothing of the
program (``repro_torch``), nor ``jax``, nor the JAX package, and takes
nothing the program made: it works out the weights, the token batches and
the random probes again from the seed (``weights``, ``data``, ``rng``).
"""
