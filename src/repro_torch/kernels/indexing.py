"""Index tables for index-driven sparse computation (DESIGN.md §3).

The port of ``repro.kernels.indexing`` for the slice's path.  All of it is
integer arithmetic and must be bit-equal to the reference.

:class:`StripeIndex` is the interface between the stages: per KV head and
superblock, the ids of the ``tile``-wide KV tiles that hold at least one
selected stripe, plus a per-QUERY-head validity bit for every packed KV
row.  The sparse kernel loads those tiles straight from the original
``(B, Hkv, N, D)`` tensors; selection stays stripe-granular through
``valid``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class StripeIndex(NamedTuple):
    """GQA-native stripe index tables for one sparse (Alg. 3) stage.

    Attributes:
      tile_idx: (B, Hkv, T_s, C_t) int32, ids of the KV tiles holding
        this superblock's selected stripes, packed ascending.  Unoccupied
        slots hold 0 and are masked through ``valid``.
      tile_valid: (B, Hkv, T_s, C_t) int32, slot occupancy.
      valid: (B, Hkv, G, T_s, C_t * tile) int32, per-query-head validity
        of each packed KV row.  Row ``c*tile + t`` of superblock ``s``
        refers to KV position ``tile_idx[..., s, c] * tile + t``.
    """

    tile_idx: torch.Tensor
    tile_valid: torch.Tensor
    valid: torch.Tensor

    @property
    def tile(self) -> int:
        """KV rows per indexed tile (the load granularity)."""
        return self.valid.shape[-1] // self.tile_idx.shape[-1]

    @property
    def capacity(self) -> int:
        """Packed KV rows per superblock (tile slots x tile width)."""
        return self.valid.shape[-1]


def stripe_tile(n: int, block_c: int) -> int:
    """Largest tile width <= ``block_c`` that divides ``n`` exactly."""
    return math.gcd(n, max(1, block_c))


def select_capacity(n_tiles: int, n: int, capacity: int | None,
                    g: int, share: bool) -> int:
    """Tile-slot budget of a compact stripe selection: each query head
    keeps at most ``min(capacity, n)`` stripes; a KV group's union table
    needs at most ``g`` times that (once under ``share``), clamped to the
    number of tiles that exist."""
    cap_s = n if capacity is None else min(capacity, n)
    return max(1, min(n_tiles, cap_s * (1 if share else g)))


def window_start_tokens(gs, cfg):
    """First local-window KV token of (global) superblock ``gs``: paper
    Alg. 1 line 8, 0-based, ``max(1, gs*step*r) * block_kv``.  ``gs`` is
    an int or an integer tensor of superblock ids."""
    if isinstance(gs, torch.Tensor):
        return torch.clamp(gs * (cfg.step * cfg.r), min=1) * cfg.block_kv
    return max(1, gs * cfg.step * cfg.r) * cfg.block_kv


def num_anchor_slots(tile: int, cfg) -> int:
    """Tile-slot count of the guaranteed anchor region: the init (sink)
    block takes ``ceil(block_kv / tile)`` tiles; the local window spans at
    most ``superblock_q`` tokens from an arbitrary offset, so at most
    ``ceil(superblock_q / tile) + 1`` tiles."""
    return -(-cfg.block_kv // tile) + (-(-cfg.superblock_q() // tile) + 1)


def anchor_tile_slots(nk: int, t_s: int, tile: int, cfg, sb0: int = 0,
                      device=None):
    """Guaranteed anchor-region slots for ``t_s`` superblocks (DESIGN.md §9).

    Returns ``(tile_idx, tile_valid, valid)`` of shapes ``(T_s, A)``,
    ``(T_s, A)`` and ``(T_s, A * tile)``, int32, shared by every batch
    element and head (``A = num_anchor_slots``).  Valid bits mark
    membership in the anchor region only; the causal and varlen trim
    happens per query row inside the sparse sweep.
    """
    if nk % tile:
        raise ValueError(f"tile ({tile}) must divide the KV length ({nk})")
    n_tiles = nk // tile
    a_init = min(-(-cfg.block_kv // tile), n_tiles)
    a_win = num_anchor_slots(tile, cfg) - -(-cfg.block_kv // tile)
    sb_q = cfg.superblock_q()
    i64 = dict(dtype=torch.int64, device=device)
    gs = sb0 + torch.arange(t_s, **i64)  # global superblock ids
    w_start = window_start_tokens(gs, cfg)  # (T_s,)
    w_end = torch.clamp((gs + 1) * sb_q, max=nk)
    off = torch.arange(tile, **i64)

    # Init (sink) slots: tiles overlapping [0, block_kv).
    init_idx = torch.arange(a_init, **i64).expand(t_s, a_init)
    init_valid = (init_idx[..., None] * tile + off) < cfg.block_kv

    # Window slots: tiles overlapping [w_start(s), w_end(s)).
    win_idx = w_start[:, None] // tile + torch.arange(a_win, **i64)
    win_ok = win_idx * tile < w_end[:, None]
    win_idx = torch.clamp(win_idx, 0, n_tiles - 1)
    cols = win_idx[..., None] * tile + off  # (T_s, a_win, tile)
    win_valid = ((cols >= w_start[:, None, None])
                 & (cols < w_end[:, None, None]) & win_ok[..., None])

    tile_idx = torch.cat([init_idx, win_idx], dim=1)
    tile_valid = torch.cat(
        [torch.ones_like(init_idx), win_ok.to(torch.int64)], dim=1)
    valid = torch.cat([init_valid, win_valid], dim=1)
    i32 = torch.int32
    return (tile_idx.to(i32), tile_valid.to(i32),
            valid.reshape(t_s, -1).to(i32))


def merge_anchor_slots(sel: StripeIndex, nk: int, cfg,
                       sb0: int = 0) -> StripeIndex:
    """Prepend the guaranteed anchor slots to a compact stripe selection.

    ``sel`` holds only the difference-aware selected tiles (the
    ``stripe_select`` output); the result is the full table the fused
    sparse sweep consumes: ``A`` anchor slots, identical across batch,
    heads and query-group members, followed by the selected slots.
    """
    b, hkv, t_s, _ = sel.tile_idx.shape
    g = sel.valid.shape[2]
    tile = sel.tile
    a_idx, a_tv, a_valid = anchor_tile_slots(
        nk, t_s, tile, cfg, sb0=sb0, device=sel.tile_idx.device)
    a = a_idx.shape[1]
    return StripeIndex(
        torch.cat([a_idx.expand(b, hkv, t_s, a), sel.tile_idx], dim=-1),
        torch.cat([a_tv.expand(b, hkv, t_s, a), sel.tile_valid], dim=-1),
        torch.cat([a_valid.expand(b, hkv, g, t_s, a * tile), sel.valid],
                  dim=-1),
    )


def kept_key_mask(tables: StripeIndex, nk: int) -> torch.Tensor:
    """Expand tables into the dense per-head key mask they encode.

    Returns a (B, Hkv*G, T_s, Nk) bool tensor: key ``j`` is set for query
    head ``h`` and superblock ``s`` iff some occupied slot holds a valid
    row at position ``j``.  The inverse of the compaction, used to hold
    two selections against each other key by key.
    """
    b, hkv, t_s, c_t = tables.tile_idx.shape
    g = tables.valid.shape[2]
    tile = tables.tile
    pos = (tables.tile_idx.long()[..., None] * tile
           + torch.arange(tile, device=tables.tile_idx.device))
    pos = pos.reshape(b, hkv, 1, t_s, c_t * tile).expand(b, hkv, g, t_s, -1)
    occ = tables.tile_valid.bool().repeat_interleave(tile, dim=-1)
    bits = (tables.valid != 0) & occ[:, :, None]
    out = torch.zeros(b, hkv, g, t_s, nk, dtype=torch.int32,
                      device=tables.tile_idx.device)
    out.scatter_add_(-1, pos, bits.to(torch.int32))
    return (out > 0).reshape(b, hkv * g, t_s, nk)
