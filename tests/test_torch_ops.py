"""The port's attention ops against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go to ``repro.kernels.ops`` (the
``xla`` backend; ``pallas_interpret`` at N <= 256) and to
``repro_torch.kernels.ops`` (the plain versions, which the ``cuda``
backend runs for tensors on the CPU).  The case grid is the one of
``tests/test_fused_identification.py`` and ``tests/test_dispatch.py``:
GQA, MHA, varlen, capacity, share_kv_groups, the use_anchor=False
ablation, a tile wider than block_kv (every case with block_c=128: tile
128 against block_kv 32) and one narrower, a ragged last superblock,
Dv != D.

Tolerances:

* floats, ``atol=2e-5, rtol=1e-4``: both sides compute in f32 and sum in
  another order; the reference itself is not bit-stable across its own
  paths on jax 0.9 (ROADMAP §C), so no comparison is bitwise;
* integers (tables, counts): equal element for element, except keys whose
  margin ``m_bar - s - theta`` lies within f32 rounding of 0
  (``compare_selections``, which counts them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AnchorConfig as RefAnchorConfig
from repro.kernels import indexing as ref_indexing
from repro.kernels import ops as ref_ops
from repro_torch.core.config import AnchorConfig
from repro_torch.core.spec import AttentionSpec
from repro_torch.kernels import indexing, ops
from repro_torch.kernels.stripe_select import (
    compare_selections,
    near_threshold_keys,
)

TOL = dict(atol=2e-5, rtol=1e-4)
BASE = dict(block_q=32, block_kv=32, step=2, theta=3.0)

# (name, AnchorConfig overrides, input shape overrides, lengths, block_c)
CASES = [
    ("base", {}, {}, None, 128),
    ("varlen", {}, {}, [130, 256], 128),
    ("capacity", dict(capacity=16, theta=8.0), {}, None, 128),
    ("share", dict(share_kv_groups=True), {}, None, 128),
    ("no_anchor", dict(use_anchor=False, theta=-0.05), {}, None, 128),
    ("mha", {}, dict(hq=2, hkv=2), None, 128),
    ("capacity_varlen", dict(capacity=16, theta=8.0), {}, [100, 224], 128),
    ("ragged", dict(step=4), dict(n=320), [320, 250], 128),
    ("tile_lt_block", {}, {}, None, 16),
    ("dv", {}, dict(dv=16), [200, 256], 128),
]
IDS = [c[0] for c in CASES]


def _inputs(seed, b=2, hq=4, hkv=2, n=256, d=32, dv=None):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, n, d), (b, hkv, n, d), (b, hkv, n, dv or d))]


def _both(case_kw, lens):
    cfg_kw = {**BASE, **case_kw}
    j_len = None if lens is None else jnp.asarray(lens, jnp.int32)
    t_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    return RefAnchorConfig(**cfg_kw), AnchorConfig(**cfg_kw), j_len, t_len


def _t(*arrays):
    return [torch.tensor(np.asarray(a, np.float32)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("name,cfg_kw,shape,lens,block_c", CASES, ids=IDS)
def test_anchor_phase(name, cfg_kw, shape, lens, block_c):
    jcfg, tcfg, j_len, t_len = _both(cfg_kw, lens)
    q, k, _ = _inputs(1, **shape)
    jqm, jmb = ref_ops.anchor_phase(jnp.asarray(q), jnp.asarray(k), jcfg,
                                    lengths=j_len, backend="xla")
    tqm, tmb = ops.anchor_phase(*_t(q, k), tcfg, lengths=t_len, backend="cuda")
    _close(tqm, jqm)
    jmb = np.asarray(jmb)
    np.testing.assert_array_equal(np.isinf(tmb.numpy()), np.isinf(jmb))
    fin = np.isfinite(jmb)
    np.testing.assert_allclose(tmb.numpy()[fin], jmb[fin], **TOL)


@pytest.mark.parametrize("name,cfg_kw,shape,lens,block_c", CASES, ids=IDS)
def test_stripe_select(name, cfg_kw, shape, lens, block_c):
    """Both sides get the reference's pooled inputs, so this holds Alg. 2
    alone against the reference."""
    jcfg, tcfg, j_len, t_len = _both(cfg_kw, lens)
    q, k, _ = _inputs(2, **shape)
    n = q.shape[2]
    tile = ref_indexing.stripe_tile(n, min(block_c, n))
    jqm, jmb = ref_ops.anchor_phase(jnp.asarray(q), jnp.asarray(k), jcfg,
                                    lengths=j_len, backend="xla")
    if not jcfg.use_anchor:
        jmb = jnp.where(jnp.isinf(jmb), jmb, 0.0)
    jsel, jcnt = ref_ops.stripe_select(jqm, jmb, jnp.asarray(k), jcfg, tile,
                                       lengths=j_len, backend="xla")
    qm, mb, kt = _t(jqm, jmb, k)
    got = ops.stripe_select(qm, mb, kt, tcfg, tile, lengths=t_len,
                            backend="cuda")
    want = (indexing.StripeIndex(*(torch.tensor(np.asarray(a))
                                   for a in jsel)),
            torch.tensor(np.asarray(jcnt)))
    res = compare_selections(got, want, near_threshold_keys(qm, mb, kt, tcfg))
    assert res["agree"], res
    assert int(want[1].sum()) > 0, "the case must select something"


@pytest.mark.parametrize("name,cfg_kw,shape,lens,block_c", CASES, ids=IDS)
def test_sparse_attention(name, cfg_kw, shape, lens, block_c):
    """Both sides sweep the reference's merged tables."""
    jcfg, tcfg, j_len, t_len = _both(cfg_kw, lens)
    q, k, v = _inputs(3, **shape)
    n = q.shape[2]
    tile = ref_indexing.stripe_tile(n, min(block_c, n))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jqm, jmb = ref_ops.anchor_phase(jq, jk, jcfg, lengths=j_len, backend="xla")
    jsel, _ = ref_ops.stripe_select(jqm, jmb, jk, jcfg, tile, lengths=j_len,
                                    backend="xla")
    jtab = ref_indexing.merge_anchor_slots(jsel, n, jcfg)
    want = ref_ops.sparse_attention(jq, jk, jv, jtab, jcfg, lengths=j_len,
                                    backend="xla")
    tab = indexing.StripeIndex(*(torch.tensor(np.asarray(a)) for a in jtab))
    got = ops.sparse_attention(*_t(q, k, v), tab, tcfg, lengths=t_len,
                               backend="cuda")
    if lens is not None:
        # The reference's XLA sweep leaves padded rows unspecified (the
        # pipeline zeroes them); the port's sweep returns exact zeros.
        rows = np.arange(n)[None, None, :] < np.asarray(lens)[:, None, None]
        assert not got.numpy()[~np.broadcast_to(rows, got.shape[:3])].any()
        want = np.where(rows[..., None], np.asarray(want), 0.0)
    _close(got, want)


FLASH_CASES = [("base", {}, None), ("varlen", {}, [130, 256]),
               ("mha", dict(hq=2, hkv=2), None), ("odd_n", dict(n=200), [200, 77])]


@pytest.mark.parametrize("name,shape,lens", FLASH_CASES,
                         ids=[c[0] for c in FLASH_CASES])
def test_flash_attention(name, shape, lens):
    q, k, v = _inputs(4, **shape)
    j_len = None if lens is None else jnp.asarray(lens, jnp.int32)
    t_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    want = ref_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   lengths=j_len, backend="xla")
    got = ops.flash_attention(*_t(q, k, v), lengths=t_len, backend="cuda")
    _close(got, want)


ATTENTION_CASES = (
    [("anchor",) + c[:4] for c in CASES if c[4] == 128]
    + [("dense",) + c[:1] + ({},) + c[1:3] for c in FLASH_CASES])


@pytest.mark.parametrize("algorithm,name,cfg_kw,shape,lens", ATTENTION_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ATTENTION_CASES])
def test_attention(algorithm, name, cfg_kw, shape, lens):
    """The whole ``attention`` call, on both backends of the port."""
    from repro.core import AttentionSpec as RefSpec

    jcfg, tcfg, j_len, t_len = _both(cfg_kw, lens)
    q, k, v = _inputs(5, **shape)
    masking = "causal" if lens is None else "padded"
    want = ref_ops.attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        RefSpec(algorithm=algorithm, backend="xla", anchor=jcfg, masking=masking),
        lengths=j_len)
    for backend in ("torch", "cuda"):
        spec = AttentionSpec(algorithm=algorithm, backend=backend, anchor=tcfg,
                             masking=masking)
        _close(ops.attention(*_t(q, k, v), spec, lengths=t_len), want)


@pytest.mark.parametrize("name,cfg_kw,shape,lens,block_c", CASES[:4],
                         ids=IDS[:4])
def test_anchor_attention_counts(name, cfg_kw, shape, lens, block_c):
    jcfg, tcfg, j_len, t_len = _both(cfg_kw, lens)
    q, k, v = _inputs(6, **shape)
    _, jcnt = ref_ops.anchor_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                       jcfg, return_stats=True, lengths=j_len,
                                       backend="xla")
    _, cnt = ops.anchor_attention(*_t(q, k, v), tcfg, return_stats=True,
                                  lengths=t_len, backend="cuda")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


@pytest.mark.parametrize("op", ["flash", "anchor_phase", "stripe_select",
                                "sparse"])
def test_against_pallas_interpret(op):
    """The Pallas kernels themselves, interpreted, at N = 128."""
    jcfg, tcfg, j_len, t_len = _both({}, [100, 128])
    q, k, v = _inputs(7, n=128)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = _t(q, k, v)
    pi = "pallas_interpret"
    if op == "flash":
        want = ref_ops.flash_attention(jq, jk, jv, block_q=32, block_kv=32,
                                       lengths=j_len, backend=pi)
        _close(ops.flash_attention(tq, tk, tv, lengths=t_len), want)
        return
    jqm, jmb = ref_ops.anchor_phase(jq, jk, jcfg, lengths=j_len, backend=pi)
    if op == "anchor_phase":
        qm, mb = ops.anchor_phase(tq, tk, tcfg, lengths=t_len)
        _close(qm, jqm)
        fin = np.isfinite(np.asarray(jmb))
        np.testing.assert_allclose(mb.numpy()[fin], np.asarray(jmb)[fin], **TOL)
        return
    jsel, jcnt = ref_ops.stripe_select(jqm, jmb, jk, jcfg, 32, lengths=j_len,
                                       backend=pi)
    if op == "stripe_select":
        qm, mb = _t(jqm, jmb)
        got = ops.stripe_select(qm, mb, tk, tcfg, 32, lengths=t_len)
        want = (indexing.StripeIndex(*(torch.tensor(np.asarray(a))
                                       for a in jsel)),
                torch.tensor(np.asarray(jcnt)))
        res = compare_selections(got, want, near_threshold_keys(qm, mb, tk, tcfg))
        assert res["agree"], res
        return
    jtab = ref_indexing.merge_anchor_slots(jsel, 128, jcfg)
    want = ref_ops.sparse_attention(jq, jk, jv, jtab, jcfg, lengths=j_len,
                                    backend=pi)
    tab = indexing.StripeIndex(*(torch.tensor(np.asarray(a)) for a in jtab))
    _close(ops.sparse_attention(tq, tk, tv, tab, tcfg, lengths=t_len), want)
