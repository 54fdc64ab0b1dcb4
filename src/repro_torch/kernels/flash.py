"""Dense causal flash attention: the CUDA kernel and its plain version.

Port of ``src/repro/kernels/flash.py`` (the Pallas kernel) and of
``flash_attention_xla`` (its plain twin).

The kernel, ``csrc/flash.cu``, replaces the Pallas kernel
``src/repro/kernels/flash.py:83 flash_attention``.  On an H100 it is
bound by operations (hundreds of flops per byte of q/k/v).  Its design:
one block per 64-row query tile of a head, K/V read from the head's KV
head, loops that stop at the diagonal and at the sequence length, scalar
f32 FMAs from shared memory (no tensor cores yet; PERF.md has its times).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, dispatch

_NEG_INF = -1e30
_BLOCK_KV = 1024  # keys per step of the plain version's online softmax


@dispatch.register("flash_attention", "torch")
def flash_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal attention as an online softmax over KV blocks, in f32.

    q: (B, Hq, N, D); k, v: (B, Hkv, S, D/Dv).  K/V stay Hkv wide (the
    query group is a batch axis of the products).  ``lengths`` ((B,)
    int32, optional) masks a right-padded batch: padding keys contribute
    nothing and padded rows return exact zeros.
    """
    b, hq, n, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.reshape(b, hkv, g, n, d).float()
    rows = torch.arange(n, device=dev)
    m = torch.full((b, hkv, g, n), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, n), device=dev)
    acc = torch.zeros((b, hkv, g, n, dv), device=dev)
    for j0 in range(0, s, _BLOCK_KV):
        kj = k[:, :, j0:j0 + _BLOCK_KV].float()
        vj = v[:, :, j0:j0 + _BLOCK_KV].float()
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qf, kj) * scale
        cols = j0 + torch.arange(kj.shape[2], device=dev)
        ok = (cols[None, :] <= rows[:, None])[None, None, None]
        if lengths is not None:
            lb = lengths.to(dev)[:, None, None, None, None]
            ok = ok & (cols < lb) & (rows[:, None] < lb)
        sc = torch.where(ok, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        p = torch.where(ok, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, n, dv).to(q.dtype)


@dispatch.register("flash_attention", "cuda")
def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """``csrc/flash.cu`` for CUDA tensors; the plain version for tensors on
    the CPU.  Output in q's dtype."""
    if not q.is_cuda:
        return flash_attention_torch(q, k, v, lengths=lengths)
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    build.check_cuda_tensors("flash_attention", q, q=q, k=k, v=v,
                             lengths=lengths)
    build.require(k.dtype == q.dtype and v.dtype == q.dtype,
                  "flash_attention: q, k, v must share one dtype")
    build.require(d in (64, 128), f"flash_attention: head dim {d} not in (64, 128)")
    build.require(hkv > 0 and hq % hkv == 0,
                  f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    build.require(k.shape == (b, hkv, n, d) and v.shape == (b, hkv, n, d),
                  f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                  f"do not match q {tuple(q.shape)}")
    build.require(lengths is None or lengths.shape == (b,),
                  "flash_attention: lengths must have shape (B,)")
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.flash_attention_launch(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lengths),
        build.ptr(out), b, hq, hkv, n, d, build.DTYPES[q.dtype],
        1.0 / (d ** 0.5), build.stream())
    build.check("flash", rc)
    build.LAUNCHES["flash"] += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = build.library("flash")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return lib
