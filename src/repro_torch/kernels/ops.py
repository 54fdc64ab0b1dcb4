"""Backend-dispatched entry points of the attention ops.

Port of ``src/repro/kernels/ops.py`` for the slice's path.  Each function
resolves its implementation through :mod:`repro_torch.kernels.dispatch`
(the ``backend=`` argument, else ``cuda``).

:func:`attention` is the model-facing entry point: it takes an
:class:`AttentionSpec` and an optional ``lengths`` tensor, and runs the
dense flash path or the fused AnchorAttention pipeline:

* ``anchor_phase`` emits the block-pooled ``(q_mean, m_bar)``;
* ``stripe_select`` emits compact per-(KV head, superblock) tables and
  kept counts, with no dense hit mask;
* :func:`merge_anchor_slots` prepends the guaranteed anchor slots;
* ``sparse_attention`` computes anchor and selected tiles in one
  online-softmax sweep from zero state.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import AnchorConfig
from repro_torch.core.spec import AttentionSpec
from repro_torch.kernels import dispatch, indexing
from repro_torch.kernels.indexing import StripeIndex, merge_anchor_slots

# Importing the implementation modules populates the backend registry.
from repro_torch.kernels import anchor as _anchor  # noqa: F401
from repro_torch.kernels import flash as _flash  # noqa: F401
from repro_torch.kernels import sparse as _sparse  # noqa: F401
from repro_torch.kernels import stripe_select as _stripe_select  # noqa: F401

# KV rows per stripe tile: the widest divisor of N up to 128 (the paper's
# block width) is the granularity of the tables.
_TILE = 128


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: AttentionSpec | None = None,
    *,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Canonical attention entry point.

    Args:
      q: (B, Hq, N, D); k, v: (B, Hkv, N, D) with Hq % Hkv == 0.
      spec: :class:`AttentionSpec` (default: dense causal on ``cuda``).
      lengths: (B,) int32 valid token counts, required exactly when
        ``spec.masking == "padded"``.  Padded query rows return zeros.

    The plain versions run on f32 inputs and the output is cast back
    once (DESIGN.md §4: both algorithms are then f32 end to end, so they
    cannot drift apart by a rounding of the inputs).  That is the
    ``torch`` backend, and the ``cuda`` backend on CPU tensors, whose
    wrappers run the plain versions.  The kernels keep the native dtype,
    converting to f32 inside.
    """
    spec = spec if spec is not None else AttentionSpec()
    if spec.masking == "padded" and lengths is None:
        raise ValueError("spec.masking='padded' requires a lengths array")
    if spec.masking == "causal" and lengths is not None:
        raise ValueError(
            "lengths= passed with spec.masking='causal'; use spec.padded()")
    backend = dispatch.resolve_backend(spec.backend)
    out_dtype = q.dtype
    if backend == "torch" or not q.is_cuda:
        q, k, v = (t.float() for t in (q, k, v))
    if spec.algorithm == "dense":
        out = flash_attention(q, k, v, lengths=lengths, backend=backend)
    else:
        out = anchor_attention(q, k, v, spec.anchor, lengths=lengths,
                               backend=backend)
    return out.to(out_dtype)


def flash_attention(q, k, v, lengths=None, backend: str | None = None):
    """Causal flash attention.  q: (B, Hq, N, D); k, v: (B, Hkv, N, D)."""
    fn = dispatch.lookup("flash_attention", backend)
    return fn(q, k, v, lengths=lengths)


def anchor_phase(q, k, cfg: AnchorConfig, lengths=None,
                 backend: str | None = None):
    """Alg. 1, scores only: block-pooled ``(q_mean, m_bar)``."""
    fn = dispatch.lookup("anchor_phase", backend)
    return fn(q, k, cfg, lengths=lengths)


def stripe_select(q_mean, m_bar, k, cfg: AnchorConfig, tile: int,
                  lengths=None, backend: str | None = None):
    """Alg. 2, compact: ``(selected-tile tables, kept counts)``."""
    fn = dispatch.lookup("stripe_select", backend)
    return fn(q_mean, m_bar, k, cfg, tile, lengths=lengths)


def sparse_attention(q, k, v, tables: StripeIndex, cfg: AnchorConfig,
                     lengths=None, q_offset: int | None = None,
                     backend: str | None = None):
    """Alg. 3, fused: one online-softmax sweep over ``tables``, whose
    leading slots are the anchor tiles (see ``merge_anchor_slots``)."""
    fn = dispatch.lookup("sparse_attention", backend)
    return fn(q, k, v, tables, cfg, lengths=lengths, q_offset=q_offset)


def anchor_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: AnchorConfig,
    return_stats: bool = False,
    lengths: torch.Tensor | None = None,
    backend: str | None = None,
):
    """Fused AnchorAttention: scores, compact select, one sparse sweep.

    q: (B, Hq, N, D); k, v: (B, Hkv, N, D).  ``lengths`` masks a
    right-padded batch: padding keys never enter statistics or selection,
    and padded rows return zeros.  With ``return_stats`` also returns the
    per-head kept stripe counts (B, Hq, T_s).
    """
    backend = dispatch.resolve_backend(backend)
    n = q.shape[2]
    tile = indexing.stripe_tile(n, _TILE)

    # Alg. 1: scores only, pooled in the kernel.
    q_mean, m_bar = anchor_phase(q, k, cfg, lengths=lengths, backend=backend)
    if not cfg.use_anchor:
        # Table 4 "Without Anchor" ablation: zero the anchor but keep the
        # +inf sentinel of all-padding pooled blocks.
        m_bar = torch.where(torch.isinf(m_bar), m_bar, torch.zeros_like(m_bar))

    # Alg. 2: compact tile selection.
    sel, counts = stripe_select(q_mean, m_bar, k, cfg, tile, lengths=lengths,
                                backend=backend)

    # Guaranteed anchor slots lead the tables (DESIGN.md §9).
    tables = merge_anchor_slots(sel, n, cfg)

    # Alg. 3: one fused online-softmax sweep from zero state.
    out = sparse_attention(q, k, v, tables, cfg, lengths=lengths,
                           backend=backend)
    if lengths is not None:
        rows = (torch.arange(n, device=out.device)[None, None, :, None]
                < lengths.to(out.device)[:, None, None, None])
        out = torch.where(rows, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    if return_stats:
        return out, counts
    return out
