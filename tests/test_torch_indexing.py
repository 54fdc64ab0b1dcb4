"""The port's contract types and index plumbing against the reference.

``AnchorConfig``, ``AttentionSpec``, ``ModelConfig`` and the Llama config
are copies (the port imports nothing of ``repro``), so their fields,
defaults, validation and derived sizes must match the reference's.  The
index plumbing is integer arithmetic and must be bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced_config as ref_get_reduced
from repro.core import AnchorConfig as RefAnchorConfig
from repro.core import AttentionSpec as RefSpec
from repro.kernels import indexing as ref_indexing
from repro.models.config import ModelConfig as RefModelConfig
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.config import AnchorConfig
from repro_torch.core.spec import AttentionSpec
from repro_torch.kernels import dispatch, indexing
from repro_torch.models.config import ModelConfig


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


# ------------------------------------------------------------- configs ----


@pytest.mark.parametrize("ours,ref,not_copied", [
    # The port picks its backend on AttentionSpec only.
    (AnchorConfig, RefAnchorConfig, {"backend"}),
    (ModelConfig, RefModelConfig, set()),
], ids=["AnchorConfig", "ModelConfig"])
def test_dataclass_fields_match_reference(ours, ref, not_copied):
    assert _fields(ours) == [f for f in _fields(ref) if f[0] not in not_copied]


def test_spec_fields_match_reference():
    assert [f.name for f in dataclasses.fields(AttentionSpec)] == [
        f.name for f in dataclasses.fields(RefSpec)]
    assert AttentionSpec().algorithm == RefSpec().algorithm
    assert AttentionSpec().masking == RefSpec().masking


ANCHOR_GRID = [dict(), dict(block_q=64, block_kv=32, step=4),
               dict(block_q=16, block_kv=16, step=2, theta=3.0),
               dict(block_q=256, block_kv=64, step=1)]


@pytest.mark.parametrize("kw", ANCHOR_GRID, ids=str)
def test_anchor_config_arithmetic(kw):
    ours, ref = AnchorConfig(**kw), RefAnchorConfig(**kw)
    assert (ours.r, ours.superblock_q()) == (ref.r, ref.superblock_q())
    for n in (1, 100, 2048, 4097, 8192, 131072):
        assert ours.prefill_pad_len(n) == ref.prefill_pad_len(n)
    for k in range(6):
        assert ours.w_start_block(k) == ref.w_start_block(k)
    n = ours.superblock_q() * 3
    assert ours.num_q_blocks(n) == ref.num_q_blocks(n)
    assert ours.num_kv_blocks(n) == ref.num_kv_blocks(n)
    assert ours.num_superblocks(n) == ref.num_superblocks(n)


@pytest.mark.parametrize("kw", [dict(block_q=48, block_kv=32), dict(step=0),
                                dict(capacity=0), dict(theta=float("inf"))],
                         ids=str)
def test_anchor_config_validation(kw):
    with pytest.raises(ValueError):
        RefAnchorConfig(**kw)
    with pytest.raises(ValueError):
        AnchorConfig(**kw)


def test_spec_validates_against_the_ports_backends():
    assert AttentionSpec(backend="cuda").backend == "cuda"
    assert AttentionSpec(backend="torch").padded().masking == "padded"
    for bad in (dict(backend="xla"), dict(algorithm="sparse"),
                dict(masking="ragged")):
        with pytest.raises(ValueError):
            AttentionSpec(**bad)
    with pytest.raises(TypeError):
        AttentionSpec(anchor=RefAnchorConfig())


def test_llama_configs_match_reference():
    assert (dataclasses.asdict(get_config("llama31_8b"))
            == dataclasses.asdict(ref_get_config("llama31_8b")))
    assert (dataclasses.asdict(get_reduced_config("llama31_8b"))
            == dataclasses.asdict(ref_get_reduced("llama31_8b")))
    cfg = get_config("llama31_8b")
    assert cfg.num_params() == ref_get_config("llama31_8b").num_params()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                32, 4096, 32, 8, 128, 14336, 128256)
    with pytest.raises(ValueError):
        get_config("yi_9b")


def test_unsupported_families_are_refused():
    cfg = dataclasses.replace(get_reduced_config("llama31_8b"), num_experts=4)
    with pytest.raises(NotImplementedError):
        cfg.check_supported()


# ------------------------------------------------------------ dispatch ----


def test_dispatch_registry():
    from repro_torch.kernels import ops  # noqa: F401  (fills the registry)

    for op in ("anchor_phase", "flash_attention", "sparse_attention",
               "stripe_select"):
        assert dispatch.lookup(op) is dispatch.lookup(op, "cuda")
        assert dispatch.lookup(op).__name__ == f"{op}_cuda"
        assert dispatch.lookup(op, "torch").__name__ == f"{op}_torch"
    with pytest.raises(ValueError):
        dispatch.lookup("flash_attention", "pallas_tpu")
    with pytest.raises(NotImplementedError, match="op unknown"):
        dispatch.lookup("ssd")


# ------------------------------------------------------------ indexing ----


@pytest.mark.parametrize("n,c", [(256, 128), (320, 128), (200, 128),
                                 (96, 16), (8192, 128)])
def test_stripe_tile(n, c):
    assert indexing.stripe_tile(n, c) == ref_indexing.stripe_tile(n, c)


def test_select_capacity_and_slots():
    for args in [(64, 8192, None, 4, False), (64, 8192, 100, 4, False),
                 (8, 256, 16, 2, True), (2, 256, 3, 2, False)]:
        assert (indexing.select_capacity(*args)
                == ref_indexing.select_capacity(*args))
    for kw in ANCHOR_GRID:
        for tile in (16, 32, 64, 128):
            assert (indexing.num_anchor_slots(tile, AnchorConfig(**kw))
                    == ref_indexing.num_anchor_slots(tile, RefAnchorConfig(**kw)))


def test_window_start_tokens_int_and_tensor():
    cfg, ref = AnchorConfig(step=4), RefAnchorConfig(step=4)
    gs = np.arange(7)
    want = np.asarray(ref_indexing.window_start_tokens(jnp.asarray(gs), ref))
    got = indexing.window_start_tokens(torch.from_numpy(gs), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert [indexing.window_start_tokens(int(s), cfg) for s in gs] == list(want)


MERGE_GRID = [
    # (nk, t_s, tile, cfg kwargs, sb0)
    (256, 4, 32, dict(block_q=32, block_kv=32, step=2), 0),
    (256, 4, 128, dict(block_q=32, block_kv=32, step=2), 0),
    (320, 3, 64, dict(block_q=32, block_kv=32, step=4), 0),
    (512, 2, 16, dict(block_q=64, block_kv=32, step=2), 1),
    (8192, 4, 128, dict(), 0),
]


@pytest.mark.parametrize("nk,t_s,tile,kw,sb0", MERGE_GRID,
                         ids=[str(g[:3]) for g in MERGE_GRID])
def test_anchor_slots_and_merge_bit_equal(nk, t_s, tile, kw, sb0):
    cfg, ref = AnchorConfig(**kw), RefAnchorConfig(**kw)
    want = ref_indexing.anchor_tile_slots(nk, t_s, tile, ref, sb0=sb0)
    got = indexing.anchor_tile_slots(nk, t_s, tile, cfg, sb0=sb0)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    rng = np.random.default_rng(nk + tile)
    b, hkv, g, c = 2, 2, 3, 5
    sel = ref_indexing.StripeIndex(
        jnp.asarray(rng.integers(0, nk // tile, (b, hkv, t_s, c)), jnp.int32),
        jnp.asarray(rng.integers(0, 2, (b, hkv, t_s, c)), jnp.int32),
        jnp.asarray(rng.integers(0, 2, (b, hkv, g, t_s, c * tile)), jnp.int32))
    want = ref_indexing.merge_anchor_slots(sel, nk, ref, sb0=sb0)
    got = indexing.merge_anchor_slots(
        indexing.StripeIndex(*(torch.tensor(np.asarray(a)) for a in sel)),
        nk, cfg, sb0=sb0)
    assert got.tile == want.tile and got.capacity == want.capacity
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


@pytest.mark.parametrize("capacity,share", [(None, False), (5, False),
                                            (None, True)])
def test_kept_key_mask_inverts_the_compaction(capacity, share):
    """Expanding the reference's compacted tables gives back its kept keys."""
    rng = np.random.default_rng(0)
    b, hq, hkv, t_s, n, tile = 2, 4, 2, 3, 64, 16
    hit = rng.random((b, hq, t_s, n)) < 0.15
    tables, counts = ref_indexing.compact_stripe_tiles(
        jnp.asarray(hit, jnp.int32), hkv, tile, capacity=capacity, share=share)
    mask = indexing.kept_key_mask(
        indexing.StripeIndex(*(torch.tensor(np.asarray(a)) for a in tables)), n)
    np.testing.assert_array_equal(mask.sum(-1).numpy(), np.asarray(counts))
    if capacity is None and not share:
        np.testing.assert_array_equal(mask.numpy(), hit)
