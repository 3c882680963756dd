"""PyTorch/CUDA port of ``repro`` (Local Methods with Adaptivity via Scaling).

The JAX package ``repro`` is the reference; this package mirrors its module
names so each counterpart is easy to find. It imports ``torch`` and numpy and
nothing of ``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
