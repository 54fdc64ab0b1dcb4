"""Difference-aware stripe identification (paper Alg. 2), compact-emitting:
the CUDA kernel and its plain version.

Port of ``src/repro/kernels/stripe_select.py`` (the Pallas kernel) and of
``stripe_select_xla`` (its plain twin).  Both compare pooled-query x key scores with the
pooled anchor and emit the surviving KV tiles directly as compact
per-(KV head, superblock) tables: ascending tile ids, slot occupancy,
per-query-head row validity, and per-head kept counts.  No dense
``(B, Hq, T_s, N)`` hit mask is materialized.

The kernel, ``csrc/stripe_select.cu``, replaces the Pallas kernel
``src/repro/kernels/stripe_select.py:107 stripe_select_pallas``.  On an
H100 it is bound by bytes (the tables it writes outweigh its few hundred
flops per key).  Its design: the TPU's sequential slot-counter axis
becomes a loop over candidate tiles in ascending order inside one block
per (superblock, KV head); warp ballots give each hit its per-head rank.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.config import AnchorConfig
from repro_torch.kernels import build, dispatch, indexing
from repro_torch.kernels.indexing import (
    StripeIndex,
    select_capacity,
    window_start_tokens,
)

_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use


def _pad_superblocks(q_mean, m_bar, t_s, step):
    """Pad T_m to T_s*step: pad rows pool to q_mean 0 and m_bar +inf
    (never selected)."""
    pad = t_s * step - q_mean.shape[2]
    if pad:
        q_mean = torch.nn.functional.pad(q_mean, (0, 0, 0, pad))
        m_bar = torch.nn.functional.pad(m_bar, (0, pad), value=torch.inf)
    return q_mean, m_bar


@dispatch.register("stripe_select", "torch")
def stripe_select_torch(
    q_mean: torch.Tensor,
    m_bar: torch.Tensor,
    k: torch.Tensor,
    cfg: AnchorConfig,
    tile: int,
    lengths: torch.Tensor | None = None,
) -> tuple[StripeIndex, torch.Tensor]:
    """Alg. 2, one superblock at a time over its candidate band.

    Args:
      q_mean: (B, Hq, T_m, D) block-pooled queries.
      m_bar: (B, Hq, T_m) block-pooled anchors (+inf rows never select).
      k: (B, Hkv, Nk, D) keys, ``Nk % tile == 0``.
      tile: KV rows per compacted tile.
      lengths: optional (B,) int32; keys at positions >= length are never
        selected.

    Returns:
      (tables, counts): selected-stripe :class:`StripeIndex` tables (no
      anchor slots) and per-head kept counts (B, Hq, T_s).  Selection is
      position-ascending with a per-query-head ``capacity`` budget (the
      union budget under ``share_kv_groups``), union tiles per KV head.
    """
    b, hq, t_m, d = q_mean.shape
    hkv, nk = k.shape[1], k.shape[2]
    g = hq // hkv
    t_s = (t_m + cfg.step - 1) // cfg.step
    if nk % tile:
        raise ValueError(f"tile ({tile}) must divide Nk ({nk})")
    n_tiles = nk // tile
    cap_s = nk if cfg.capacity is None else min(cfg.capacity, nk)
    c_sel = select_capacity(n_tiles, nk, cfg.capacity, g, cfg.share_kv_groups)
    scale = 1.0 / (d ** 0.5)
    dev = k.device
    i32 = torch.int32

    q_mean, m_bar = _pad_superblocks(q_mean, m_bar, t_s, cfg.step)
    qm = q_mean.float().reshape(b, hkv, g, t_s, cfg.step, d)
    mb = m_bar.float().reshape(b, hkv, g, t_s, cfg.step)
    tile_idx = torch.zeros((b, hkv, t_s, c_sel), dtype=i32, device=dev)
    tile_valid = torch.zeros_like(tile_idx)
    valid = torch.zeros((b, hkv, g, t_s, c_sel, tile), dtype=i32, device=dev)
    counts = torch.zeros((b, hkv, g, t_s), dtype=i32, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    ki = torch.arange(hkv, device=dev)[None, :, None]
    for s in range(t_s):
        w_start = window_start_tokens(s, cfg)
        j_lo, j_hi = cfg.block_kv // tile, -(-min(w_start, nk) // tile)
        if j_hi <= j_lo:
            continue
        cols = torch.arange(j_lo * tile, j_hi * tile, device=dev)
        keys = k[:, :, j_lo * tile:j_hi * tile].float()
        sc = torch.einsum("bkgpd,bkwd->bkgpw", qm[:, :, :, s], keys) * scale
        hit = ((mb[:, :, :, s, :, None] - sc) <= cfg.theta).any(dim=3)
        hit &= (cols >= cfg.block_kv) & (cols < w_start)
        if lengths is not None:
            hit &= cols < lengths.to(dev)[:, None, None, None]
        if cfg.share_kv_groups:
            hit = hit.any(dim=2, keepdim=True).expand_as(hit)
        # Position-ascending per-head budget: rank = hits before this key.
        rank = torch.cumsum(hit.to(i32), dim=-1) - 1
        kept = hit & (rank < cap_s)  # (B, Hkv, G, W)
        counts[..., s] = kept.sum(-1).to(i32)

        nt = j_hi - j_lo
        kept_t = kept.reshape(b, hkv, g, nt, tile)
        tmask = kept_t.any(dim=-1).any(dim=2)  # (B, Hkv, nt)
        trank = torch.cumsum(tmask.to(i32), dim=-1) - 1
        slot = torch.where(tmask & (trank < c_sel), trank, c_sel).long()
        tids = (j_lo + torch.arange(nt, device=dev, dtype=i32)).expand_as(slot)
        buf = torch.zeros((b, hkv, c_sel + 1), dtype=i32, device=dev)
        buf[bi, ki, slot] = tids
        tile_idx[:, :, s] = buf[..., :c_sel]
        n_occ = torch.clamp(tmask.sum(-1), max=c_sel)
        tile_valid[:, :, s] = (torch.arange(c_sel, device=dev)
                               < n_occ[..., None]).to(i32)
        vbuf = torch.zeros((b, hkv, g, c_sel + 1, tile), dtype=i32, device=dev)
        vbuf[bi[..., None], ki[..., None], torch.arange(g, device=dev)[:, None],
             slot[:, :, None, :]] = kept_t.to(i32)
        valid[:, :, :, s] = vbuf[:, :, :, :c_sel]
    tables = StripeIndex(tile_idx, tile_valid,
                         valid.reshape(b, hkv, g, t_s, c_sel * tile))
    return tables, counts.reshape(b, hq, t_s)


def near_threshold_keys(q_mean, m_bar, k, cfg: AnchorConfig,
                        rtol: float = 1e-4) -> torch.Tensor:
    """Keys whose selection could flip under f32 rounding.

    Returns a (B, Hq, T_s, Nk) bool tensor: key ``j`` is set for head
    ``h`` and superblock ``s`` if for some pooled row of the superblock
    the margin ``m_bar - score - theta`` lies within
    ``rtol * (1 + |m_bar| + |score|)`` of 0.  Two implementations of Alg. 2
    that sum the score in another order may disagree on these keys, and
    only on these.
    """
    b, hq, t_m, d = q_mean.shape
    hkv, nk = k.shape[1], k.shape[2]
    t_s = (t_m + cfg.step - 1) // cfg.step
    q_mean, m_bar = _pad_superblocks(q_mean, m_bar, t_s, cfg.step)
    qm = q_mean.float().reshape(b, hkv, hq // hkv, t_s * cfg.step, d)
    sc = torch.einsum("bkgpd,bknd->bkgpn", qm, k.float()) / (d ** 0.5)
    mb = m_bar.float().reshape(b, hkv, hq // hkv, t_s * cfg.step, 1)
    near = torch.isfinite(mb) & (
        (mb - sc - cfg.theta).abs() <= rtol * (1 + mb.abs() + sc.abs()))
    return near.reshape(b, hq, t_s, cfg.step, nk).any(dim=3)


def compare_selections(got, want, near: torch.Tensor) -> dict[str, int]:
    """Hold two Alg. 2 results ``(tables, counts)`` against each other.

    Counts table entries and kept counts that differ, keys kept by one and
    not the other, and those of them that are not near the threshold (see
    :func:`near_threshold_keys`).  Two selections agree when
    ``flipped_not_near`` is 0 and, if no key flipped, every table entry
    and count is equal.
    """
    nk = near.shape[-1]
    mism = sum(int((a != b_).sum()) for a, b_ in zip(got[0], want[0]))
    flips = (indexing.kept_key_mask(got[0], nk)
             ^ indexing.kept_key_mask(want[0], nk))
    res = {
        "table_entries_mismatched": mism,
        "counts_mismatched": int((got[1] != want[1]).sum()),
        "keys_flipped": int(flips.sum()),
        "keys_near_threshold": int(near.sum()),
        "flipped_not_near": int((flips & ~near).sum()),
    }
    res["agree"] = int(res["flipped_not_near"] == 0 and (
        res["keys_flipped"] > 0
        or res["table_entries_mismatched"] + res["counts_mismatched"] == 0))
    return res


@dispatch.register("stripe_select", "cuda")
def stripe_select_cuda(
    q_mean: torch.Tensor,
    m_bar: torch.Tensor,
    k: torch.Tensor,
    cfg: AnchorConfig,
    tile: int,
    lengths: torch.Tensor | None = None,
) -> tuple[StripeIndex, torch.Tensor]:
    """``csrc/stripe_select.cu`` for CUDA tensors; the plain version for
    tensors on the CPU."""
    if not k.is_cuda:
        return stripe_select_torch(q_mean, m_bar, k, cfg, tile, lengths=lengths)
    b, hq, t_m, d = q_mean.shape
    hkv, nk = k.shape[1], k.shape[2]
    g = hq // max(hkv, 1)
    if lengths is not None:
        lengths = lengths.to(device=k.device, dtype=torch.int32).contiguous()
    build.check_cuda_tensors("stripe_select", k, q_mean=q_mean, m_bar=m_bar,
                             k=k, lengths=lengths)
    build.require(q_mean.dtype == torch.float32 and m_bar.dtype == torch.float32,
                  "stripe_select: q_mean and m_bar must be float32")
    build.require(d in (64, 128), f"stripe_select: head dim {d} not in (64, 128)")
    build.require(hkv > 0 and hq % hkv == 0 and g <= 32,
                  f"stripe_select: Hq={hq}, Hkv={hkv} (need Hkv | Hq, G <= 32)")
    build.require(k.shape[0] == b and k.shape[3] == d and m_bar.shape == (b, hq, t_m),
                  "stripe_select: q_mean, m_bar and k shapes disagree")
    build.require(0 < tile <= 128 and nk % tile == 0,
                  f"stripe_select: tile {tile} must be <= 128 and divide Nk={nk}")
    build.require(lengths is None or lengths.shape == (b,),
                  "stripe_select: lengths must have shape (B,)")
    rows = g * cfg.step
    smem = 4 * (rows * d + rows + tile * (d + 1)) + 4 * (g * 4 + g)
    build.require(smem <= _SMEM_LIMIT,
                  f"stripe_select: G*step={rows} pooled rows need {smem} bytes "
                  "of shared memory")
    t_s = (t_m + cfg.step - 1) // cfg.step
    n_tiles = nk // tile
    cap_s = nk if cfg.capacity is None else min(cfg.capacity, nk)
    c_sel = select_capacity(n_tiles, nk, cfg.capacity, g, cfg.share_kv_groups)
    dev = k.device
    tile_idx = torch.empty((b, hkv, t_s, c_sel), dtype=torch.int32, device=dev)
    tile_valid = torch.empty_like(tile_idx)
    valid = torch.empty((b, hkv, g, t_s, c_sel * tile), dtype=torch.int32,
                        device=dev)
    counts = torch.empty((b, hq, t_s), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.stripe_select_launch(
        build.ptr(q_mean), build.ptr(m_bar), build.ptr(k), build.ptr(lengths),
        build.ptr(tile_idx), build.ptr(tile_valid), build.ptr(valid),
        build.ptr(counts), b, hq, hkv, t_m, nk, d, build.DTYPES[k.dtype],
        cfg.step, cfg.block_kv, cfg.step * cfg.r, tile, cap_s, c_sel,
        float(cfg.theta), 1.0 / (d ** 0.5), int(cfg.share_kv_groups),
        build.stream())
    build.check("stripe_select", rc)
    build.LAUNCHES["stripe_select"] += 1
    return StripeIndex(tile_idx, tile_valid, valid), counts


def _lib() -> ctypes.CDLL:
    lib = build.library("stripe_select")
    fn = lib.stripe_select_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 13 + [f, f, i, p]
        fn.restype = i
    return lib
