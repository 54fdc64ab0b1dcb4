"""The port's slice as a whole against the JAX reference, on the CPU.

Reduced ``llama31_8b`` in f32: the reference initialises the weights and
``params_from_jax`` carries them across, so both packages run the same
model.  Prefill logits (dense and anchor, padded and unpadded) are held at
``atol=2e-5, rtol=1e-4`` (f32 on both sides, sums in another order); the
engines must emit the same greedy tokens and the same dense-slab stats.
f32 keeps the greedy comparison meaningful: in bf16 a one-ulp difference
can flip an argmax between near-tied logits of a random model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as ref_reduced
from repro.core import AnchorConfig as RefAnchorConfig
from repro.core import AttentionSpec as RefSpec
from repro.models import model as ref_model
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import get_reduced_config
from repro_torch.core.config import AnchorConfig
from repro_torch.core.spec import AttentionSpec
from repro_torch.models import model as model_lib
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Request, ServingEngine

TOL = dict(atol=2e-5, rtol=1e-4)
# The anchor blocks of the reference's launch/serve.py: small
# prompts still span two superblocks and run sparse.
SERVE_ANCHOR = dict(block_q=16, block_kv=16, step=2)


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(ref_reduced("llama31_8b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced_config("llama31_8b"), dtype="float32")
    ref_params = ref_model.init(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def test_params_from_jax_unstacks_layers(models):
    ref_cfg, ref_params, cfg, params = models
    assert len(params["blocks"]) == cfg.num_layers == 2
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(
            params["blocks"][i]["attn"]["wq"].numpy(),
            np.asarray(ref_params["blocks"]["l0"]["attn"]["wq"][i]))
    n_ref = sum(int(np.asarray(x).size) for x in jax.tree.leaves(ref_params))
    n_port = sum(x.numel() for layer in params["blocks"]
                 for sub in layer.values() for x in sub.values())
    n_port += params["embed"].numel() + params["final_norm"]["scale"].numel()
    assert n_port == n_ref


PREFILL_CASES = [("dense", None), ("dense", [64, 40, 57]),
                 ("anchor", None), ("anchor", [64, 40, 57])]


@pytest.mark.parametrize("algorithm,lens", PREFILL_CASES,
                         ids=[f"{a}-{'padded' if l else 'full'}"
                              for a, l in PREFILL_CASES])
def test_prefill_logits_match_reference(models, algorithm, lens):
    ref_cfg, ref_params, cfg, params = models
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(3, 64)).astype(np.int32)
    kw = dict(SERVE_ANCHOR, theta=3.0)
    want, want_cache = ref_model.prefill(
        ref_params, jnp.asarray(toks), ref_cfg,
        spec=RefSpec(algorithm=algorithm, backend="xla",
                     anchor=RefAnchorConfig(**kw)),
        lengths=None if lens is None else jnp.asarray(lens, jnp.int32))
    for backend in ("torch", "cuda"):
        got, cache = model_lib.prefill(
            params, torch.from_numpy(toks), cfg,
            spec=AttentionSpec(algorithm=algorithm, backend=backend,
                               anchor=AnchorConfig(**kw)),
            lengths=None if lens is None else torch.tensor(lens, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(
            cache[1]["k"].numpy(), np.asarray(want_cache["l0"]["k"][1]),
            **TOL)


def test_decode_steps_with_active_mask_match_reference(models):
    """Ragged slots decoded by position group: the ``active`` mask keeps
    the other slots' caches intact (a write at the group's position into
    every slot would corrupt the slots past it)."""
    ref_cfg, ref_params, cfg, params = models
    rng = np.random.default_rng(2)
    lens = [20, 13]
    toks = rng.integers(0, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    spec_kw = dict(algorithm="dense")
    _, rc = ref_model.prefill(ref_params, jnp.asarray(toks), ref_cfg,
                              spec=RefSpec(backend="xla", **spec_kw),
                              lengths=jnp.asarray(lens, jnp.int32))
    _, pc = model_lib.prefill(params, torch.from_numpy(toks), cfg,
                              spec=AttentionSpec(backend="torch", **spec_kw),
                              lengths=torch.tensor(lens, dtype=torch.int32))
    max_len = 32
    ref_cache = ref_model.init_cache(ref_cfg, 2, max_len)
    ref_cache = jax.tree.map(
        lambda slab, pre: slab.at[:, :, :, :pre.shape[3]].set(pre), ref_cache, rc)
    cache = model_lib.init_cache(cfg, 2, max_len, device="cpu")
    for layer, pre in zip(cache, pc):
        for leaf in ("k", "v"):
            layer[leaf][:, :, :20] = pre[leaf]
    for step in range(3):
        for pos, slot in ((lens[1] + step, 1), (lens[0] + step, 0)):
            tok = rng.integers(0, cfg.vocab_size, size=2).astype(np.int32)
            act = np.arange(2) == slot
            want, ref_cache = ref_model.decode_step(
                ref_params, ref_cache, jnp.asarray(tok), jnp.asarray(pos),
                ref_cfg, active=jnp.asarray(act))
            got = model_lib.decode_step(params, cache, torch.from_numpy(tok),
                                        pos, cfg, active=torch.from_numpy(act))
            np.testing.assert_allclose(got[slot].numpy(),
                                       np.asarray(want[slot]), **TOL)
    np.testing.assert_allclose(cache[0]["k"].numpy(),
                               np.asarray(ref_cache["l0"]["k"][0]), **TOL)


@pytest.mark.parametrize("theta", [12.0, 1.0])
def test_engine_matches_reference_engine(models, theta):
    """A small ragged batch served as ``launch/serve.py --reduced`` serves
    it: two admission waves, one padded anchor prefill each."""
    ref_cfg, ref_params, cfg, params = models
    kw = dict(SERVE_ANCHOR, theta=theta)
    max_len = RefAnchorConfig(**kw).prefill_pad_len(40) + 8 + 8
    ref_engine = RefEngine(ref_params, ref_cfg, max_batch=4, max_len=max_len,
                           spec=RefSpec(algorithm="anchor", backend="xla",
                                        anchor=RefAnchorConfig(**kw)))
    engine = ServingEngine(params, cfg, max_batch=4, max_len=max_len,
                           spec=AttentionSpec(algorithm="anchor",
                                              anchor=AnchorConfig(**kw)))
    rng = np.random.default_rng(3)
    for uid, n in enumerate([40, 23, 31, 12, 35]):
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        ref_engine.submit(RefRequest(uid=uid, prompt=prompt, max_new_tokens=6))
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=6))
    want = {r.uid: r.generated for r in ref_engine.run_to_completion()}
    got = {r.uid: r.generated for r in engine.run_to_completion()}
    assert got == want
    ref_stats = ref_engine.snapshot()
    assert engine.snapshot() == {key: ref_stats[key] for key in engine.snapshot()}
    assert engine.snapshot()["batched_prefills"] == 1
    assert engine.snapshot()["dense_fallbacks"] == 0


def test_engine_counts_a_dense_fallback(models):
    ref_cfg, ref_params, cfg, params = models
    kw = dict(SERVE_ANCHOR, theta=3.0)
    ref_engine = RefEngine(ref_params, ref_cfg, max_batch=2, max_len=48,
                           spec=RefSpec(algorithm="anchor", backend="xla",
                                        anchor=RefAnchorConfig(**kw)))
    engine = ServingEngine(params, cfg, max_batch=2, max_len=48,
                           spec=AttentionSpec(algorithm="anchor",
                                              anchor=AnchorConfig(**kw)))
    prompt = np.arange(40, dtype=np.int32) % cfg.vocab_size
    ref_engine.submit(RefRequest(uid=0, prompt=prompt, max_new_tokens=3))
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=3))
    assert ([r.generated for r in engine.run_to_completion()]
            == [r.generated for r in ref_engine.run_to_completion()])
    assert engine.stats["dense_fallbacks"] == 1
    with pytest.raises(ValueError, match="do not fit"):
        engine.submit(Request(uid=1, prompt=np.zeros(48, np.int32),
                              max_new_tokens=1))


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "llama31_8b", "--reduced", "--device", "cpu",
                "--requests", "3", "--prompt-len", "40", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert '"dense_fallbacks": 0' in out
