"""Backend registry and dispatch for every kernel op of the port.

One op name, two implementations:

=========  ===============================================================
``torch``  the plain PyTorch versions: eager tensor code that runs on any
           device.  ``ops.attention`` feeds them f32 inputs and casts the
           output once (DESIGN.md §4).
``cuda``   the hand-written Hopper kernels under ``kernels/csrc/``.  Each
           wrapper launches its kernel for a CUDA tensor, or raises; for a
           tensor that lies on the CPU it runs the plain version, which is
           how the CPU tests reach the same call sites.  ``ops.attention``
           then applies the ``torch`` rule too (f32 inputs, one cast of
           the output), so on the CPU both backends give the same numbers.
=========  ===============================================================

A call that names no backend runs ``cuda``.
"""

from __future__ import annotations

from typing import Callable

BACKENDS = ("torch", "cuda")

_REGISTRY: dict[tuple[str, str], Callable] = {}


def validate(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; available: {', '.join(BACKENDS)}"
        )
    return backend


def resolve_backend(backend: str | None = None) -> str:
    return "cuda" if backend is None else validate(backend)


def register(op: str, backend: str):
    """Decorator: register ``fn`` as the ``backend`` implementation of ``op``."""
    validate(backend)

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(op, backend)] = fn
        return fn

    return deco


def lookup(op: str, backend: str | None = None) -> Callable:
    """The ``backend`` implementation of ``op`` (``cuda`` if None)."""
    b = resolve_backend(backend)
    try:
        return _REGISTRY[(op, b)]
    except KeyError:
        have = sorted(bk for (o, bk) in _REGISTRY if o == op)
        raise NotImplementedError(
            f"op {op!r} has no {b!r} implementation"
            + (f" (registered: {', '.join(have)})" if have else " (op unknown)")
        ) from None
