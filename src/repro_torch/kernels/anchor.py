"""Pattern-based anchor computation, scores only (paper Alg. 1): the CUDA
kernel and its plain version.

Port of ``src/repro/kernels/anchor.py`` (the Pallas kernel) and of
``anchor_phase_xla`` (its plain twin).  Both emit exactly what Alg. 2
consumes: the block-pooled queries ``q_mean`` (B, Hq, T_m, D) and anchors
``m_bar`` (B, Hq, T_m), f32.  No V is read.

The kernel, ``csrc/anchor.cu``, replaces the Pallas kernel
``src/repro/kernels/anchor.py:96 anchor_phase_pallas``.  On an H100 it is
bound by operations (each query block scores up to (1 + step*r)*block_kv
keys).  Its design: one block per (query block, head), row maxima over
64-key sub-tiles of the sink block and the clipped window, stopping at
the diagonal and the sequence length, pooled in the same block; f32
scores, since stripe_select thresholds on them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.config import AnchorConfig
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.indexing import window_start_tokens

_NEG_INF = -1e30


@dispatch.register("anchor_phase", "torch")
def anchor_phase_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    cfg: AnchorConfig,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 1, scores only, one superblock at a time.

    A row's anchor is its maximum logit over KV block 0 and its
    superblock's local window ``[w_start, w_end)``, causally masked.  With
    ``lengths``, padding keys are masked out of the scores and padded rows
    out of the pooling; an all-padding block gets ``m_bar = +inf`` (never
    selected) and ``q_mean = 0``.
    """
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    t_m = cfg.num_q_blocks(n)
    sb_q = cfg.superblock_q()
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    kf = k.float()
    lens = None if lengths is None else lengths.to(dev)
    m_rows = torch.empty((b, hkv, g, n), device=dev)
    for s in range(cfg.num_superblocks(n)):
        r0, r1 = s * sb_q, min((s + 1) * sb_q, n)
        qs = q[:, :, r0:r1].float().reshape(b, hkv, g, r1 - r0, d)
        rows = torch.arange(r0, r1, device=dev)
        w_start = window_start_tokens(s, cfg)
        cols = torch.cat([torch.arange(cfg.block_kv, device=dev),
                          torch.arange(w_start, r1, device=dev)])
        keys = torch.cat([kf[:, :, :cfg.block_kv], kf[:, :, w_start:r1]], 2)
        sc = torch.einsum("bhgrd,bhcd->bhgrc", qs, keys) * scale
        ok = (cols[None, :] <= rows[:, None])[None, None, None]
        if lens is not None:
            lb = lens[:, None, None, None, None]
            ok = ok & (cols < lb) & (rows[:, None] < lb)
        m_rows[..., r0:r1] = torch.where(ok, sc, _NEG_INF).amax(-1)

    m_blk = m_rows.reshape(b, hq, t_m, cfg.block_q)
    q_blk = q.reshape(b, hq, t_m, cfg.block_q, d).float()
    if lens is None:
        return q_blk.mean(-2), m_blk.mean(-1)
    rv = (torch.arange(n, device=dev).reshape(t_m, cfg.block_q)
          < lens[:, None, None, None])  # (B, 1, T_m, block_q)
    cnt = rv.sum(-1)
    denom = torch.clamp(cnt, min=1)
    m_bar = torch.where(rv, m_blk, 0.0).sum(-1) / denom
    m_bar = torch.where(cnt == 0, torch.inf, m_bar)
    q_mean = torch.where(rv[..., None], q_blk, 0.0).sum(-2) / denom[..., None]
    return q_mean, m_bar


@dispatch.register("anchor_phase", "cuda")
def anchor_phase_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    cfg: AnchorConfig,
    lengths: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/anchor.cu`` for CUDA tensors; the plain version for tensors
    on the CPU."""
    if not q.is_cuda:
        return anchor_phase_torch(q, k, cfg, lengths=lengths)
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    build.check_cuda_tensors("anchor_phase", q, q=q, k=k, lengths=lengths)
    build.require(k.dtype == q.dtype, "anchor_phase: q and k must share one dtype")
    build.require(d in (64, 128), f"anchor_phase: head dim {d} not in (64, 128)")
    build.require(hkv > 0 and hq % hkv == 0,
                  f"anchor_phase: Hq={hq} is not a multiple of Hkv={hkv}")
    build.require(k.shape == (b, hkv, n, d),
                  f"anchor_phase: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    build.require(lengths is None or lengths.shape == (b,),
                  "anchor_phase: lengths must have shape (B,)")
    t_m = cfg.num_q_blocks(n)
    cfg.num_kv_blocks(n)  # raises unless block_kv divides N
    q_mean = torch.empty((b, hq, t_m, d), device=q.device, dtype=torch.float32)
    m_bar = torch.empty((b, hq, t_m), device=q.device, dtype=torch.float32)
    lib = _lib()
    rc = lib.anchor_phase_launch(
        build.ptr(q), build.ptr(k), build.ptr(lengths), build.ptr(q_mean),
        build.ptr(m_bar), b, hq, hkv, n, d, build.DTYPES[q.dtype],
        cfg.block_q, cfg.block_kv, cfg.step, 1.0 / (d ** 0.5), build.stream())
    build.check("anchor", rc)
    build.LAUNCHES["anchor"] += 1
    return q_mean, m_bar


def _lib() -> ctypes.CDLL:
    lib = build.library("anchor")
    fn = lib.anchor_phase_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    return lib
