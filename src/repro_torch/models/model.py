"""LM wrapper: embedding, decoder stack, tied head.

Port of the serving part of ``repro.models.model``: :func:`init`,
:func:`prefill`, :func:`decode_step` and :func:`init_cache`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.spec import AttentionSpec
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_init

Params = dict[str, Any]


def init(gen: torch.Generator, cfg: ModelConfig,
         device: str | torch.device = "cuda") -> Params:
    """Random parameters drawn from ``gen`` (on the generator's device),
    placed on ``device``; the same distributions as the reference."""
    cfg.check_supported()
    dev = resolve_device(device)
    emb = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                      device=gen.device) * 0.02
    params: Params = {
        "embed": emb.to(device=dev, dtype=getattr(torch, cfg.dtype)),
        "blocks": transformer.stack_init(gen, cfg, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                           device=gen.device) * 0.02
        params["lm_head"] = head.to(device=dev, dtype=getattr(torch, cfg.dtype))
    return params


def _logits(x: torch.Tensor, params: Params) -> torch.Tensor:
    head = params.get("lm_head", params["embed"])
    return x @ head.T


def prefill(
    params: Params,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    spec: AttentionSpec | None = None,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list[Params]]:
    """Serving prefill: last-position logits (B, V) and the per-layer cache.

    The default spec runs AnchorAttention on every layer.  ``lengths``
    ((B,) int32, optional) enables right-padded batched prefill: sequence
    ``b`` occupies ``tokens[b, :lengths[b]]`` and its logits are taken at
    its own last valid position; cache positions past a sequence's length
    hold padding.
    """
    spec = spec if spec is not None else AttentionSpec(algorithm="anchor")
    if lengths is not None and spec.masking != "padded":
        spec = spec.padded()
    dev = params["embed"].device
    tokens = tokens.to(dev)
    b, n = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(n, device=dev).expand(b, n)
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int32)
    x, cache = transformer.stack_apply(
        x, params["blocks"], cfg, positions, spec=spec, lengths=lengths,
        return_cache=True)
    if lengths is None:
        x_last = x[:, -1]
    else:
        x_last = x[torch.arange(b, device=dev), lengths.long() - 1]
    x_last = rmsnorm(x_last, params["final_norm"], cfg.norm_eps)
    return _logits(x_last, params), cache


def decode_step(
    params: Params,
    cache: list[Params],
    token: torch.Tensor,
    pos: int,
    cfg: ModelConfig,
    *,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """One decode step.  token: (B,) int; pos: the position written.

    ``active`` ((B,) bool, optional) restricts cache writes to those batch
    slots (see :func:`transformer.stack_decode`).  Updates ``cache`` in
    place and returns the logits (B, V).
    """
    dev = params["embed"].device
    x = params["embed"][token.to(dev)][:, None]
    x = transformer.stack_decode(x, params["blocks"], cache, cfg, pos,
                                 active=active)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x, params)[:, 0]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda") -> list[Params]:
    """Dense per-slot decode cache."""
    return transformer.stack_cache_init(cfg, batch, max_len,
                                        resolve_device(device))
