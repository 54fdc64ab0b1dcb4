"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and nvcc; without a card each one
skips (the decision is taken inside the ``cuda`` fixture, never at
import).  On the card: ``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances, kernel against plain version on the same inputs:

* f32: ``atol=1e-5, rtol=1e-4`` for attention outputs, ``1e-4`` for the
  anchor scores.  Both sum the same f32 products in another order; with
  D <= 128 terms of magnitude <= ~10 the difference stays below 1e-5.
  TF32 is off, so the plain products are full f32.
* bf16 outputs, element by element: ``|got - ref| <= 2**-7 * |ref| +
  1e-4``.  Both sides round an f32 value to bf16; values that differ by
  summation order may round to neighbouring bf16 numbers, one ulp apart,
  which is at most 2**-7 of the value.  The 1e-4 floor covers values near
  zero.
* stripe tables: equal element for element, except where a key's margin
  ``m_bar - s - theta`` lies within f32 rounding of 0
  (``compare_selections``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.config import AnchorConfig
from repro_torch.core.spec import AttentionSpec
from repro_torch.kernels import build, indexing, ops
from repro_torch.kernels.stripe_select import (
    compare_selections,
    near_threshold_keys,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _qkv(seed, dev, dtype, b=2, hq=4, hkv=2, n=512, d=64, dv=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, hq, n, d), (b, hkv, n, d), (b, hkv, n, dv or d)]
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            .to(dev, dtype) for s in shapes]


def _close(got, want, dtype, f32_tol=(1e-5, 1e-4)):
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=f32_tol[0], rtol=f32_tol[1])
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=2.0 ** -7)


DTYPES = [torch.float32, torch.bfloat16]
FLASH_CASES = [
    ("base", dict(), None),
    ("varlen", dict(), [130, 512]),
    ("d128", dict(d=128, hq=8, hkv=2), [300, 17]),
    ("ragged_n", dict(n=200), [200, 77]),
    ("mha", dict(hq=2, hkv=2), None),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,shape,lens", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_kernel(cuda, dtype, name, shape, lens):
    q, k, v = _qkv(1, cuda, dtype, **shape)
    lengths = None if lens is None else torch.tensor(lens, device=cuda,
                                                     dtype=torch.int32)
    got = ops.flash_attention(q, k, v, lengths=lengths, backend="cuda")
    want = ops.flash_attention(q, k, v, lengths=lengths, backend="torch")
    torch.cuda.synchronize()
    _close(got, want, dtype)
    if lengths is not None:
        for j, n_j in enumerate(lens):
            assert not got[j, :, n_j:].any(), "padded rows must be exact zeros"


ANCHOR_CASES = [
    ("base", dict(block_q=64, block_kv=64, step=2), {}, None),
    ("varlen", dict(block_q=64, block_kv=64, step=2), {}, [130, 300]),
    ("r2", dict(block_q=128, block_kv=64, step=2), {}, [512, 200]),
    ("small_block", dict(block_q=32, block_kv=32, step=4), dict(d=128), None),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,cfg_kw,shape,lens", ANCHOR_CASES,
                         ids=[c[0] for c in ANCHOR_CASES])
def test_anchor_kernel(cuda, dtype, name, cfg_kw, shape, lens):
    cfg = AnchorConfig(**cfg_kw)
    q, k, _ = _qkv(2, cuda, dtype, **shape)
    lengths = None if lens is None else torch.tensor(lens, device=cuda,
                                                     dtype=torch.int32)
    qm, mb = ops.anchor_phase(q, k, cfg, lengths=lengths, backend="cuda")
    qm0, mb0 = ops.anchor_phase(q, k, cfg, lengths=lengths, backend="torch")
    torch.cuda.synchronize()
    # Scores are f32 for either input dtype: stripe_select thresholds them.
    torch.testing.assert_close(qm, qm0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mb, mb0, atol=1e-4, rtol=1e-5)


SELECT_CASES = [
    ("base", dict(block_q=32, block_kv=32, step=2, theta=3.0), {}, None, 32),
    ("varlen", dict(block_q=32, block_kv=32, step=2, theta=3.0), {},
     [130, 512], 32),
    ("capacity", dict(block_q=32, block_kv=32, step=2, theta=8.0,
                      capacity=16), {}, None, 32),
    ("share", dict(block_q=32, block_kv=32, step=2, theta=3.0,
                   share_kv_groups=True), {}, None, 32),
    ("no_anchor", dict(block_q=32, block_kv=32, step=2, theta=-0.05,
                       use_anchor=False), {}, None, 32),
    ("tile_gt_block", dict(block_q=32, block_kv=32, step=2, theta=3.0),
     dict(d=128, hq=8), None, 128),
    ("ragged", dict(block_q=32, block_kv=32, step=4, theta=3.0),
     dict(n=320), [320, 250], 64),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,cfg_kw,shape,lens,tile", SELECT_CASES,
                         ids=[c[0] for c in SELECT_CASES])
def test_stripe_select_kernel(cuda, dtype, name, cfg_kw, shape, lens, tile):
    cfg = AnchorConfig(**cfg_kw)
    q, k, _ = _qkv(3, cuda, dtype, **shape)
    lengths = None if lens is None else torch.tensor(lens, device=cuda,
                                                     dtype=torch.int32)
    qm, mb = ops.anchor_phase(q, k, cfg, lengths=lengths, backend="torch")
    if not cfg.use_anchor:
        mb = torch.where(torch.isinf(mb), mb, torch.zeros_like(mb))
    got = ops.stripe_select(qm, mb, k, cfg, tile, lengths=lengths,
                            backend="cuda")
    want = ops.stripe_select(qm, mb, k, cfg, tile, lengths=lengths,
                             backend="torch")
    torch.cuda.synchronize()
    res = compare_selections(got, want, near_threshold_keys(qm, mb, k, cfg))
    assert res["agree"], res
    assert int(want[1].sum()) > 0, "the case must select something"


SPARSE_CASES = [
    ("base", dict(block_q=64, block_kv=64, step=2, theta=2.0), {}, None),
    ("varlen", dict(block_q=64, block_kv=64, step=2, theta=2.0), {},
     [130, 512]),
    ("all_kept", dict(block_q=64, block_kv=64, step=2, theta=1e9), {}, None),
    ("dv64", dict(block_q=64, block_kv=64, step=2, theta=2.0),
     dict(d=128, dv=64), [400, 512]),
    ("small_block", dict(block_q=32, block_kv=32, step=2, theta=2.0), {},
     [100, 224]),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name,cfg_kw,shape,lens", SPARSE_CASES,
                         ids=[c[0] for c in SPARSE_CASES])
def test_sparse_kernel(cuda, dtype, name, cfg_kw, shape, lens):
    cfg = AnchorConfig(**cfg_kw)
    q, k, v = _qkv(4, cuda, dtype, **shape)
    n = q.shape[2]
    lengths = None if lens is None else torch.tensor(lens, device=cuda,
                                                     dtype=torch.int32)
    tile = indexing.stripe_tile(n, 128)
    qm, mb = ops.anchor_phase(q, k, cfg, lengths=lengths, backend="torch")
    sel, _ = ops.stripe_select(qm, mb, k, cfg, tile, lengths=lengths,
                               backend="torch")
    tables = indexing.merge_anchor_slots(sel, n, cfg)
    got = ops.sparse_attention(q, k, v, tables, cfg, lengths=lengths,
                               backend="cuda")
    want = ops.sparse_attention(q, k, v, tables, cfg, lengths=lengths,
                                backend="torch")
    torch.cuda.synchronize()
    _close(got, want, dtype)


def test_sparse_kernel_q_offset_chunk(cuda):
    """The rows of the last superblock swept alone at their global
    ``q_offset`` over the full K/V equal the one-shot sweep (chunked
    prefill), and the plain version agrees."""
    cfg = AnchorConfig(block_q=64, block_kv=64, step=2, theta=2.0)
    q, k, v = _qkv(8, cuda, torch.float32)  # N = 512: four superblocks
    lengths = torch.tensor([512, 400], device=cuda, dtype=torch.int32)
    qm, mb = ops.anchor_phase(q, k, cfg, lengths=lengths, backend="cuda")
    sel, _ = ops.stripe_select(qm, mb, k, cfg, 128, lengths=lengths,
                               backend="cuda")
    tables = indexing.merge_anchor_slots(sel, 512, cfg)
    full = ops.sparse_attention(q, k, v, tables, cfg, lengths=lengths,
                                backend="cuda")
    sb0, off = 3, 3 * cfg.superblock_q()
    part = indexing.StripeIndex(*(t[:, :, sb0:].contiguous() if t.dim() == 4
                                  else t[:, :, :, sb0:].contiguous()
                                  for t in tables))
    args = (q[:, :, off:].contiguous(), k, v, part, cfg)
    got = ops.sparse_attention(*args, lengths=lengths, q_offset=off,
                               backend="cuda")
    want = ops.sparse_attention(*args, lengths=lengths, q_offset=off,
                                backend="torch")
    torch.cuda.synchronize()
    _close(got, full[:, :, off:], torch.float32)
    _close(got, want, torch.float32)


def test_sparse_kernel_skips_empty_slots_exactly(cuda):
    """Appending empty selected slots changes no bit of the output."""
    cfg = AnchorConfig(block_q=64, block_kv=64, step=2, theta=2.0)
    q, k, v = _qkv(5, cuda, torch.float32)
    n = q.shape[2]
    qm, mb = ops.anchor_phase(q, k, cfg, backend="cuda")
    sel, _ = ops.stripe_select(qm, mb, k, cfg, 64, backend="cuda")
    tables = indexing.merge_anchor_slots(sel, n, cfg)
    wider = indexing.StripeIndex(
        *(torch.cat([t, torch.zeros_like(t[..., :3])], -1)
          for t in tables[:2]),
        torch.cat([tables.valid,
                   torch.zeros_like(tables.valid[..., :3 * 64])], -1))
    a = ops.sparse_attention(q, k, v, tables, cfg, backend="cuda")
    b = ops.sparse_attention(q, k, v, wider, cfg, backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_attention_pipeline_and_launch_counts(cuda, dtype):
    cfg = AnchorConfig(block_q=64, block_kv=64, step=2, theta=2.0)
    q, k, v = _qkv(6, cuda, dtype)
    lengths = torch.tensor([300, 512], device=cuda, dtype=torch.int32)
    spec = AttentionSpec(algorithm="anchor", anchor=cfg).padded()
    build.reset_launches()
    got = ops.attention(q, k, v, spec.with_backend("cuda"), lengths=lengths)
    assert dict(build.LAUNCHES) == {"anchor": 1, "stripe_select": 1,
                                    "sparse": 1}
    want = ops.attention(q, k, v, spec.with_backend("torch"), lengths=lengths)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"anchor": 1, "stripe_select": 1,
                                    "sparse": 1}
    _close(got, want, dtype)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _qkv(7, cuda, torch.float32, d=32)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, v, backend="cuda")
    q, k, v = _qkv(7, cuda, torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, k, v, backend="cuda")
    q, k, v = _qkv(7, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3), k, v, backend="cuda")


def test_engine_on_the_card_matches_plain_path(cuda):
    """A small engine run on the kernels emits the plain path's tokens."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(get_reduced_config("llama31_8b"), d_model=256,
                              num_heads=4, num_kv_heads=2, head_dim=64,
                              d_ff=512, dtype="float32")
    params = model_lib.init(torch.Generator(device=cuda).manual_seed(0), cfg,
                            device=cuda)
    acfg = AnchorConfig(block_q=64, block_kv=64, step=2, theta=12.0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (200, 130, 77)]
    out = {}
    for backend in ("cuda", "torch"):
        eng = ServingEngine(params, cfg, max_batch=4, max_len=300,
                            spec=AttentionSpec(algorithm="anchor",
                                               backend=backend, anchor=acfg))
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        out[backend] = {r.uid: r.generated for r in eng.run_to_completion()}
    assert out["cuda"] == out["torch"]
