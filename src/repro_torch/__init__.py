"""AnchorAttention on PyTorch and CUDA: the port of :mod:`repro` to an
NVIDIA H100.

The package mirrors the layout of ``src/repro/`` module for module, so a
reader finds each counterpart at the same path.  It imports ``torch`` and
never ``jax`` or ``repro``: the JAX package stays the reference the port
is held against by ``tests/test_torch_*.py``.

Entry points place their work on ``cuda`` unless the caller passes
``device="cpu"``; asking for the card where there is none raises.
"""
