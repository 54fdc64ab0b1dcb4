"""Decoder stack: a loop over layers.

Port of the dense GQA part of ``repro.models.transformer``.  The
reference scans one group body over parameters stacked on a leading
``num_groups`` axis; the port keeps one parameter dict per layer and
loops.  Each layer is pre-norm attention then a pre-norm SwiGLU MLP, both
residual.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.spec import AttentionSpec
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)

Params = dict[str, Any]


def stack_init(gen: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> list[Params]:
    """One parameter dict per layer."""
    cfg.check_supported()
    dt = getattr(torch, cfg.dtype)
    return [{"norm_mixer": rmsnorm_init(cfg.d_model, device),
             "attn": attn_lib.gqa_init(gen, cfg, device),
             "norm_ffn": rmsnorm_init(cfg.d_model, device),
             "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device)}
            for _ in range(cfg.num_layers)]


def stack_apply(
    x: torch.Tensor,
    blocks: list[Params],
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    spec: AttentionSpec | None = None,
    lengths: torch.Tensor | None = None,
    return_cache: bool = False,
):
    """Run the decoder stack.  Returns ``hidden`` or ``(hidden, cache)``,
    the cache being one ``{"k", "v"}`` dict of (B, Hkv, N, hd) per layer."""
    caches = []
    for p in blocks:
        h = rmsnorm(x, p["norm_mixer"], cfg.norm_eps)
        h = attn_lib.gqa_apply(h, p["attn"], cfg, positions, spec=spec,
                               lengths=lengths, return_cache=return_cache)
        if return_cache:
            h, cache = h
            caches.append(cache)
        x = x + h
        x = x + mlp_apply(rmsnorm(x, p["norm_ffn"], cfg.norm_eps), p["mlp"])
    return (x, caches) if return_cache else x


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                     device: torch.device) -> list[Params]:
    """Dense per-slot cache slabs: one ``{"k", "v"}`` dict per layer, each
    leaf (batch, Hkv, max_len, hd)."""
    return [attn_lib.gqa_init_cache(cfg, batch, max_len, device)
            for _ in range(cfg.num_layers)]


def stack_decode(
    x: torch.Tensor,
    blocks: list[Params],
    cache: list[Params],
    cfg: ModelConfig,
    pos: int,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-token decode through the stack.  x: (B, 1, d).

    ``active`` ((B,) bool, optional): batch slots whose caches may be
    written this step.  Schedulers that decode one position group of a
    mixed-position batch must pass it; otherwise every slot's cache is
    written at ``pos``, corrupting slots that are past it.  The cache is
    updated in place.
    """
    for p, layer_cache in zip(blocks, cache):
        h = rmsnorm(x, p["norm_mixer"], cfg.norm_eps)
        x = x + attn_lib.gqa_decode(h, p["attn"], layer_cache, cfg, pos,
                                    active=active)
        x = x + mlp_apply(rmsnorm(x, p["norm_ffn"], cfg.norm_eps), p["mlp"])
    return x
