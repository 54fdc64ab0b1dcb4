"""Configuration for AnchorAttention (paper Algorithms 1-3).

The port's own copy of ``repro.core.config``: importing the reference
module would run ``repro/core/__init__.py``, which imports JAX.

All block arithmetic is 0-based. The paper's Algorithm 1 line 8
(1-based) ``j_start = max(2, floor((i-1)/step) * step * (b_q/b_kv))``
becomes ``w_start(k) = max(1, k * step * r)`` for 0-based superblock
``k = i // step`` and ``r = b_q // b_kv``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Hyper-parameters of AnchorAttention.

    Attributes:
      block_q: query block size ``b_q`` (paper uses 128).
      block_kv: key/value block size ``b_kv`` (paper uses 128).
      step: number of query blocks sharing one identification pass.
      theta: difference threshold. A key ``j`` is selected for pooled
        query row ``b`` iff ``anchor_b - score_bj <= theta``.
      capacity: maximum number of selected stripes per superblock and
        query head; ``None`` keeps every candidate (exact thresholding).
      use_anchor: ``False`` reproduces the paper's "Without Anchor"
        ablation: the anchor statistic is replaced by zero.
      share_kv_groups: one stripe selection per KV head, the union over
        its query group.

    The reference's ``backend`` field is not copied: the port's backend
    is chosen on :class:`AttentionSpec` only.
    """

    block_q: int = 128
    block_kv: int = 128
    step: int = 16
    theta: float = 12.0
    capacity: int | None = None
    use_anchor: bool = True
    share_kv_groups: bool = False

    def __post_init__(self) -> None:
        if self.block_q % self.block_kv != 0:
            raise ValueError(
                f"block_q ({self.block_q}) must be a multiple of block_kv "
                f"({self.block_kv})"
            )
        if self.step < 1:
            raise ValueError("step must be >= 1")
        if self.capacity is not None and self.capacity <= 0:
            raise ValueError(
                f"capacity must be None or a positive int, got "
                f"{self.capacity!r}"
            )
        if not math.isfinite(self.theta):
            raise ValueError(
                f"theta must be finite, got {self.theta!r} "
                "(use a large finite value like 1e9 for exact selection)"
            )

    @property
    def r(self) -> int:
        """Ratio b_q / b_kv (paper keeps both at 128 so r == 1)."""
        return self.block_q // self.block_kv

    def superblock_q(self) -> int:
        """Tokens covered by one identification superblock."""
        return self.block_q * self.step

    def prefill_pad_len(self, n: int) -> int:
        """Smallest right-padded length at which an ``n``-token prompt can
        run sparse prefill: a multiple of :meth:`superblock_q`, and at
        least two superblocks (below that the anchor region covers
        everything)."""
        need = self.superblock_q()
        return max(2 * need, -(-n // need) * need)

    def w_start_block(self, k: int) -> int:
        """First local-window KV block for superblock ``k`` (0-based).
        KV block 0 (the sink) is never part of the window."""
        return max(1, k * self.step * self.r)

    def num_q_blocks(self, n: int) -> int:
        if n % self.block_q != 0:
            raise ValueError(f"sequence length {n} not divisible by block_q")
        return n // self.block_q

    def num_kv_blocks(self, n: int) -> int:
        if n % self.block_kv != 0:
            raise ValueError(f"sequence length {n} not divisible by block_kv")
        return n // self.block_kv

    def num_superblocks(self, n: int) -> int:
        t_m = self.num_q_blocks(n)
        return (t_m + self.step - 1) // self.step


# Paper's defaults for the main experiments (§4.1 Implementation).
PAPER_CONFIG = AnchorConfig(block_q=128, block_kv=128, step=16, theta=12.0)
