"""Invariants of the reference (DESIGN.md §3, §9) held on the port's own
terms, on the CPU:

* an empty tile slot changes nothing (bit for bit);
* padded query rows are exact zeros;
* a padded batch equals per-sequence calls;
* GQA equals the repeat-expanded multi-head form;
* a chunk of rows swept at its global ``q_offset`` equals the one-shot
  sweep.

The last three compare f32 results summed in another order, at
``atol=2e-5, rtol=1e-4``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.config import AnchorConfig
from repro_torch.core.spec import AttentionSpec
from repro_torch.kernels import indexing, ops

TOL = dict(atol=2e-5, rtol=1e-4)
ANCHOR = AnchorConfig(block_q=16, block_kv=16, step=2, theta=3.0)
N = 64  # two superblocks of ANCHOR


def _qkv(seed, b, hq, hkv, n=N, d=16):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((b, hq, n, d), generator=gen),
            torch.randn((b, hkv, n, d), generator=gen),
            torch.randn((b, hkv, n, d), generator=gen))


@pytest.mark.parametrize("where", ["end", "after_anchor"])
def test_empty_slot_changes_nothing(where):
    q, k, v = _qkv(0, 2, 4, 2)
    lengths = torch.tensor([64, 37], dtype=torch.int32)
    qm, mb = ops.anchor_phase(q, k, ANCHOR, lengths=lengths)
    sel, _ = ops.stripe_select(qm, mb, k, ANCHOR, 16, lengths=lengths)
    tables = indexing.merge_anchor_slots(sel, N, ANCHOR)
    a = indexing.num_anchor_slots(16, ANCHOR)
    at = tables.tile_idx.shape[-1] if where == "end" else a

    def insert(t, width):
        zeros = torch.zeros((*t.shape[:-1], width), dtype=t.dtype)
        return torch.cat([t[..., :at * width], zeros, t[..., at * width:]], -1)

    wider = indexing.StripeIndex(insert(tables.tile_idx, 1),
                                 insert(tables.tile_valid, 1),
                                 insert(tables.valid, 16))
    base = ops.sparse_attention(q, k, v, tables, ANCHOR, lengths=lengths)
    out = ops.sparse_attention(q, k, v, wider, ANCHOR, lengths=lengths)
    assert torch.equal(out, base)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("algorithm", ["dense", "anchor"])
def test_padded_rows_are_exact_zeros(algorithm, backend):
    lens = [64, 17, 40]
    q, k, v = _qkv(1, 3, 4, 2)
    spec = AttentionSpec(algorithm=algorithm, backend=backend, anchor=ANCHOR,
                         masking="padded")
    out = ops.attention(q, k, v, spec, lengths=torch.tensor(lens, dtype=torch.int32))
    for j, n in enumerate(lens):
        assert not out[j, :, n:].any()
        assert out[j, :, :n].abs().sum() > 0


@pytest.mark.parametrize("algorithm", ["dense", "anchor"])
def test_padded_batch_equals_per_sequence_calls(algorithm):
    lens = [64, 17, 40, 33]
    q, k, v = _qkv(2, 4, 4, 2)
    spec = AttentionSpec(algorithm=algorithm, anchor=ANCHOR, masking="padded")
    out = ops.attention(q, k, v, spec, lengths=torch.tensor(lens, dtype=torch.int32))
    for j, n in enumerate(lens):
        single = ops.attention(q[j:j + 1], k[j:j + 1], v[j:j + 1], spec,
                               lengths=torch.tensor([n], dtype=torch.int32))
        torch.testing.assert_close(out[j], single[0], **TOL)
    # A sequence that fills the padded length equals the unpadded call.
    full = ops.attention(q[:1], k[:1], v[:1],
                         AttentionSpec(algorithm=algorithm, anchor=ANCHOR))
    torch.testing.assert_close(out[0], full[0], **TOL)


@pytest.mark.parametrize("algorithm", ["dense", "anchor"])
def test_gqa_equals_repeat_expanded(algorithm):
    q, k, v = _qkv(3, 2, 4, 2)
    spec = AttentionSpec(algorithm=algorithm, anchor=ANCHOR)
    gqa = ops.attention(q, k, v, spec)
    mha = ops.attention(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1),
                        spec)
    torch.testing.assert_close(gqa, mha, **TOL)


def test_anchor_at_huge_theta_equals_dense():
    """With every candidate kept the sparse sweep covers the whole causal
    triangle: the same function as dense attention."""
    q, k, v = _qkv(4, 2, 4, 2)
    lengths = torch.tensor([64, 45], dtype=torch.int32)
    exact = AnchorConfig(block_q=16, block_kv=16, step=2, theta=1e9)
    spec = AttentionSpec(algorithm="anchor", anchor=exact, masking="padded")
    out = ops.attention(q, k, v, spec, lengths=lengths)
    dense = ops.attention(q, k, v, spec.with_algorithm("dense"), lengths=lengths)
    torch.testing.assert_close(out, dense, **TOL)
    np.testing.assert_array_equal(
        ops.anchor_attention(q, k, v, exact, return_stats=True,
                             lengths=lengths)[1].numpy() > 0,
        np.array([[[False, True]] * 4, [[False, True]] * 4]))


def test_chunk_with_q_offset_equals_one_shot():
    """Rows [off, N) swept alone, at global offset ``off`` over the full
    K/V with the tables of their superblocks, equal the one-shot sweep:
    the chunked-prefill use of ``q_offset``."""
    q, k, v = _qkv(5, 2, 4, 2, n=96)  # three superblocks of ANCHOR
    lengths = torch.tensor([96, 70], dtype=torch.int32)
    qm, mb = ops.anchor_phase(q, k, ANCHOR, lengths=lengths)
    sel, _ = ops.stripe_select(qm, mb, k, ANCHOR, 16, lengths=lengths)
    tables = indexing.merge_anchor_slots(sel, 96, ANCHOR)
    full = ops.sparse_attention(q, k, v, tables, ANCHOR, lengths=lengths)
    sb0, off = 1, ANCHOR.superblock_q()
    chunk = ops.sparse_attention(
        q[:, :, off:], k, v,
        indexing.StripeIndex(tables.tile_idx[:, :, sb0:].contiguous(),
                             tables.tile_valid[:, :, sb0:].contiguous(),
                             tables.valid[:, :, :, sb0:].contiguous()),
        ANCHOR, lengths=lengths, q_offset=off)
    torch.testing.assert_close(chunk, full[:, :, off:], **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("algorithm", ["dense", "anchor"])
def test_cpu_backends_share_one_plain_route(algorithm, dtype):
    """On CPU tensors the ``cuda`` wrappers run the plain versions, and
    ``ops.attention`` feeds them f32 as it does the ``torch`` backend: the
    two backends give the same bits."""
    q, k, v = (t.to(dtype) for t in _qkv(7, 2, 4, 2))
    lengths = torch.tensor([64, 29], dtype=torch.int32)
    outs = [ops.attention(q, k, v, AttentionSpec(algorithm=algorithm,
                                                 backend=backend,
                                                 anchor=ANCHOR).padded(),
                          lengths=lengths)
            for backend in ("torch", "cuda")]
    assert outs[0].dtype == dtype
    assert torch.equal(outs[0], outs[1])
