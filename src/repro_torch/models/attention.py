"""GQA attention block: AnchorAttention (or dense) prefill and KV-cache
decode.

Port of the GQA part of ``repro.models.attention``.  Prefill attention is
configured by an :class:`AttentionSpec` and runs through
:func:`repro_torch.kernels.ops.attention`; decode is dense attention over
the cache (the paper is prefill-only).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.spec import AttentionSpec
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, decode_attention, dense_init

Params = dict[str, Any]


def gqa_init(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Params:
    dt = getattr(torch, cfg.dtype)
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, h * hd, dt, device),
        "wk": dense_init(gen, d, hkv * hd, dt, device),
        "wv": dense_init(gen, d, hkv * hd, dt, device),
        "wo": dense_init(gen, h * hd, d, dt, device),
    }


def _project(x: torch.Tensor, p: Params, cfg: ModelConfig,
             positions: torch.Tensor):
    """q, k, v with RoPE applied, each (B, H*, N, hd) and contiguous."""
    b, n, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_rope((x @ p["wq"]).reshape(b, n, h, hd), positions,
                   cfg.rope_theta)
    k = apply_rope((x @ p["wk"]).reshape(b, n, hkv, hd), positions,
                   cfg.rope_theta)
    v = (x @ p["wv"]).reshape(b, n, hkv, hd)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def gqa_apply(
    x: torch.Tensor,
    p: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    spec: AttentionSpec | None = None,
    lengths: torch.Tensor | None = None,
    return_cache: bool = False,
):
    """Prefill self-attention.  x: (B, N, d_model); positions: (B, N)."""
    b, n, _ = x.shape
    q, k, v = _project(x, p, cfg, positions)
    spec = spec if spec is not None else AttentionSpec()
    if lengths is not None and spec.masking != "padded":
        spec = spec.padded()
    out = kernel_ops.attention(q, k, v, spec, lengths=lengths)
    out = out.transpose(1, 2).reshape(b, n, cfg.num_heads * cfg.head_dim)
    out = out @ p["wo"]
    if return_cache:
        return out, {"k": k, "v": v}  # rope'd K, the layout decode reads
    return out


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device) -> Params:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def gqa_decode(
    x: torch.Tensor,
    p: Params,
    cache: Params,
    cfg: ModelConfig,
    pos: int,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); pos: the current position.

    Writes the new token's K/V at ``pos`` in place, for the ``active``
    batch rows only ((B,) bool; all rows when None), then attends over
    positions ``[0, pos]``.  Writing in place spares the copy of the whole
    cache that the functional reference makes, and the ``active`` mask
    keeps rows whose own position is past ``pos`` intact.
    """
    b = x.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project(x, p, cfg, posb)
    rows = (slice(None) if active is None
            else active.to(x.device).nonzero(as_tuple=True)[0])
    cache["k"][rows, :, pos] = k[rows, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, pos] = v[rows, :, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], pos + 1)
    out = out.transpose(1, 2).reshape(b, 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"]
