"""Primitive layers: norms, RoPE, the gated MLP and decode attention.

Port of ``repro.models.layers`` for the slice's path.  Parameters are
plain dicts of tensors; weights live in the config dtype (bf16 by
default) and every reduction and softmax statistic is f32.
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, Any]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(in_dim, out_dim) weight, normal with std 1/sqrt(in_dim)."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device)
    return (w * (1.0 / in_dim ** 0.5)).to(device=device, dtype=dtype)


def rmsnorm_init(dim: int, device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device: torch.device) -> Params:
    return {
        "wi": dense_init(gen, d_model, d_ff, dtype, device),
        "wg": dense_init(gen, d_model, d_ff, dtype, device),
        "wo": dense_init(gen, d_ff, d_model, dtype, device),
    }


def mlp_apply(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Gated MLP, SwiGLU."""
    return (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token decode attention over the first ``cache_len`` positions of
    a cache, in f32.

    q: (B, Hq, 1, D); caches: (B, Hkv, S, D).  Positions at or past
    ``cache_len`` would carry exactly zero weight under the reference's
    mask, so they are sliced off rather than masked.
    """
    b, hq, _, d = q.shape
    hkv = k_cache.shape[1]
    g = hq // hkv
    kc = k_cache[:, :, :cache_len].float()
    vc = v_cache[:, :, :cache_len].float()
    qg = q.reshape(b, hkv, g, 1, d).float()
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc) * (1.0 / d ** 0.5)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
    return out.reshape(b, hq, 1, -1).to(q.dtype)
