"""Declarative attention specification (the port of ``repro.core.spec``).

A spec answers three questions:

* **algorithm**: ``"dense"`` (flash causal attention, the baseline) or
  ``"anchor"`` (the AnchorAttention pipeline, Algs. 1-3);
* **backend**: ``"torch"`` (plain PyTorch) or ``"cuda"`` (the kernels);
  ``None`` means ``"cuda"``;
* **masking**: ``"causal"`` for full-length sequences, ``"padded"`` for
  right-padded batches that carry per-sequence ``lengths``.

``lengths`` (``masking="padded"``) is a ``(B,)`` int32 tensor of valid
token counts: sequence ``b`` occupies positions ``[0, lengths[b])``.
Padding keys are masked out of every score, statistic and selection,
and padded query rows produce exact zeros.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.config import AnchorConfig

ALGORITHMS = ("dense", "anchor")
MASKINGS = ("causal", "padded")


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Hashable declarative attention configuration.

    Attributes:
      algorithm: ``"dense"`` | ``"anchor"``, the prefill attention math.
      backend: kernel backend name or ``None`` (``"cuda"``).
      anchor: :class:`AnchorConfig` (read by ``"anchor"`` only).
      masking: ``"causal"`` | ``"padded"``.
    """

    algorithm: str = "dense"
    backend: str | None = None
    anchor: AnchorConfig = AnchorConfig()
    masking: str = "causal"

    def __post_init__(self) -> None:
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; "
                f"expected one of {ALGORITHMS}"
            )
        if self.masking not in MASKINGS:
            raise ValueError(
                f"unknown masking {self.masking!r}; expected one of {MASKINGS}"
            )
        if self.backend is not None:
            from repro_torch.kernels import dispatch

            dispatch.validate(self.backend)
        if not isinstance(self.anchor, AnchorConfig):
            raise TypeError(
                f"anchor must be an AnchorConfig, got {type(self.anchor)}"
            )

    def padded(self) -> "AttentionSpec":
        """The same spec with ``masking='padded'`` (varlen calls)."""
        return dataclasses.replace(self, masking="padded")

    def with_backend(self, backend: str | None) -> "AttentionSpec":
        return dataclasses.replace(self, backend=backend)

    def with_algorithm(self, algorithm: str) -> "AttentionSpec":
        return dataclasses.replace(self, algorithm=algorithm)
