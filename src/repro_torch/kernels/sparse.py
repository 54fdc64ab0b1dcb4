"""Fine-grained sparse computation (paper Alg. 3), fused and index-driven:
the CUDA kernel and its plain version.

Port of ``src/repro/kernels/sparse.py`` (the Pallas kernel) and of
``sparse_attention_xla`` (its plain twin).  One online-softmax sweep from zero state runs over
the KV tiles named by a :class:`StripeIndex` whose leading slots are the
guaranteed anchor region (``merge_anchor_slots``) and whose remaining
slots are the selected stripes.  Tiles are read from the original
``(B, Hkv, Nk, D)`` tensors; nothing Hq-wide is materialized.

The kernel, ``csrc/sparse.cu``, replaces the Pallas kernel
``src/repro/kernels/sparse.py:104 sparse_attention_pallas``.  On an H100
it is bound by operations, counting the kept (row, key) pairs only.  Its
design: blocks of 64 query rows gather the keys their head keeps into a
shared-memory list and attend 64 at a time, so the work, and the time,
follow the kept fraction rather than the tiles that hold the keys.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.config import AnchorConfig
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.indexing import (
    StripeIndex,
    num_anchor_slots,
    window_start_tokens,
)

_NEG_INF = -1e30


def _online_update(state, sc, vals):
    """One online-softmax step over masked scores ``sc`` (kNegInf where
    masked) and their value rows ``vals``.  A step without an unmasked
    entry is an exact no-op (alpha = 1, zero mass)."""
    m, l, acc = state
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    p = torch.where(sc <= _NEG_INF, 0.0, p)
    alpha = torch.exp(m - m_new)
    return (m_new, l * alpha + p.sum(-1),
            acc * alpha[..., None] + torch.einsum("bkgrt,bktd->bkgrd", p, vals))


@dispatch.register("sparse_attention", "torch")
def sparse_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tables: StripeIndex,
    cfg: AnchorConfig,
    lengths: torch.Tensor | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    """Alg. 3, fused, one superblock at a time.

    The anchor region (KV block 0 and the superblock's local window) is
    computed from zero state as one contiguous product, as in the XLA
    twin; the selected slots follow in ascending order, each one tile
    gathered from ``k``/``v`` by id.  Every slot applies the validity bits
    and the causal and varlen trim from global positions (``q_offset`` is
    the position of query row 0), so padded rows come out as exact zeros.
    """
    b, hq, n, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    g = hq // hkv
    dv = v.shape[-1]
    tile = tables.tile
    t_s, c_t = tables.tile_idx.shape[2], tables.tile_idx.shape[3]
    n_anchor = min(num_anchor_slots(tile, cfg), c_t)
    sb_q = cfg.superblock_q()
    scale = 1.0 / (d ** 0.5)
    off = 0 if q_offset is None else int(q_offset)
    dev = q.device
    kf, vf = k.float(), v.float()
    lens = None if lengths is None else lengths.to(dev)[:, None, None, None, None]
    offs = torch.arange(tile, device=dev)
    out = torch.empty((b, hkv, g, n, dv), device=dev)

    def masked(sc, rows, cols, ok=None):
        ok_c = cols[..., None, :] <= rows[:, None]  # (..., R, C)
        ok = ok_c if ok is None else ok & ok_c
        if lens is not None:
            ok = ok & (cols[..., None, :] < lens) & (rows[:, None] < lens)
        return torch.where(ok, sc, _NEG_INF)

    for s in range(t_s):
        r0, r1 = s * sb_q, min((s + 1) * sb_q, n)
        qs = q[:, :, r0:r1].float().reshape(b, hkv, g, r1 - r0, d)
        rows = off + torch.arange(r0, r1, device=dev)  # global positions
        gs = off // sb_q + s
        w_start = window_start_tokens(gs, cfg)
        w_end = min((gs + 1) * sb_q, nk)
        cols = torch.cat([torch.arange(cfg.block_kv, device=dev),
                          torch.arange(w_start, w_end, device=dev)])
        keys = torch.cat([kf[:, :, :cfg.block_kv], kf[:, :, w_start:w_end]], 2)
        vals = torch.cat([vf[:, :, :cfg.block_kv], vf[:, :, w_start:w_end]], 2)
        sc = torch.einsum("bkgrd,bkcd->bkgrc", qs, keys) * scale
        zero = torch.zeros(qs.shape[:-1], device=dev)
        state = _online_update(
            (torch.full_like(zero, _NEG_INF), zero,
             torch.zeros((*qs.shape[:-1], dv), device=dev)),
            masked(sc, rows, cols), vals)
        for c in range(n_anchor, c_t):
            pos = tables.tile_idx[:, :, s, c].long()[..., None] * tile + offs
            kt = torch.gather(kf, 2, pos[..., None].expand(-1, -1, -1, d))
            vt = torch.gather(vf, 2, pos[..., None].expand(-1, -1, -1, dv))
            vld = tables.valid[:, :, :, s, c * tile:(c + 1) * tile] != 0
            sc = torch.einsum("bkgrd,bktd->bkgrt", qs, kt) * scale
            sc = masked(sc, rows, pos[:, :, None], vld[:, :, :, None, :])
            state = _online_update(state, sc, vt)
        _, l, acc = state
        out[:, :, :, r0:r1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, n, dv).to(q.dtype)


@dispatch.register("sparse_attention", "cuda")
def sparse_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tables: StripeIndex,
    cfg: AnchorConfig,
    lengths: torch.Tensor | None = None,
    q_offset: int | None = None,
) -> torch.Tensor:
    """``csrc/sparse.cu`` for CUDA tensors; the plain version for tensors
    on the CPU.  Output (B, Hq, N, Dv) in q's dtype."""
    if not q.is_cuda:
        return sparse_attention_torch(q, k, v, tables, cfg, lengths=lengths,
                                      q_offset=q_offset)
    b, hq, n, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    tile = tables.tile
    t_s, c_t = tables.tile_idx.shape[2], tables.tile_idx.shape[3]
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    off = None
    if q_offset is not None:
        off = torch.tensor([int(q_offset)], dtype=torch.int32, device=q.device)
    build.check_cuda_tensors(
        "sparse_attention", q, q=q, k=k, v=v, tile_idx=tables.tile_idx,
        tile_valid=tables.tile_valid, valid=tables.valid, lengths=lengths)
    build.require(k.dtype == q.dtype and v.dtype == q.dtype,
                  "sparse_attention: q, k, v must share one dtype")
    build.require(all(t.dtype == torch.int32 for t in tables),
                  "sparse_attention: tables must be int32")
    build.require((d, dv) in ((128, 128), (64, 64), (128, 64)),
                  f"sparse_attention: (D, Dv) = {(d, dv)} not supported")
    build.require(hkv > 0 and hq % hkv == 0,
                  f"sparse_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    build.require(k.shape == (b, hkv, nk, d) and v.shape == (b, hkv, nk, dv),
                  "sparse_attention: k / v shapes do not match q")
    build.require(nk % tile == 0, f"sparse_attention: tile {tile} must divide Nk={nk}")
    t_m = cfg.num_q_blocks(n)
    build.require(t_s == (t_m + cfg.step - 1) // cfg.step
                  and tables.tile_idx.shape[:2] == (b, hkv)
                  and tables.tile_valid.shape == tables.tile_idx.shape
                  and tables.valid.shape == (b, hkv, hq // hkv, t_s, c_t * tile),
                  "sparse_attention: table shapes do not match q")
    build.require(lengths is None or lengths.shape == (b,),
                  "sparse_attention: lengths must have shape (B,)")
    out = torch.empty((b, hq, n, dv), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.sparse_attention_launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(tables.tile_idx),
        build.ptr(tables.tile_valid), build.ptr(tables.valid),
        build.ptr(lengths), build.ptr(off), build.ptr(out), b, hq, hkv, n, nk,
        d, dv, build.DTYPES[q.dtype], t_s, c_t, tile, cfg.block_q, cfg.step,
        1.0 / (d ** 0.5), build.stream())
    build.check("sparse", rc)
    build.LAUNCHES["sparse"] += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.library("sparse")
    fn = lib.sparse_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 13 + [ctypes.c_float, p]
        fn.restype = i
    return lib
