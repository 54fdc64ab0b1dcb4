#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py

Builds the four CUDA kernels of ``src/repro_torch/kernels/csrc`` from the
checkout, holds each against its plain PyTorch version at the main path's
shapes, serves Llama-3.1-8B at full width (random weights from a seed)
through the port's ``ServingEngine`` on the AnchorAttention and the dense
paths, and checks the prefill logits.  Phases print one JSON line each:

1. ``environment``: card, software, kernel build time and ptxas lines.
2. ``kernels``: each kernel against its plain version, in bf16 and in f32
   (TF32 off), on random inputs at theta=12 (everything kept) and on
   structured sink/stripe inputs at a selective theta; error, time, plain
   time, the card's bound for the work, and table agreement.
3. ``main_path``: 4 requests of 8192, 7000, 5000 and 3000 tokens with 16
   new tokens each; launch counts, engine stats, times, peak memory.
4. ``logits``: kernel-path prefill logits against the plain path, and
   anchor at theta=1e9 against dense, at the stated bf16 tolerance.

Then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``.  Any failed build,
launch or check raises before that line and the exit code is not 0; so
does a machine without a CUDA card.
"""

from __future__ import annotations

import importlib.metadata
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): tensor-core bf16,
# and f32 outside the tensor cores; HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
MAIN_LENGTHS = [8192, 7000, 5000, 3000]
HQ, HKV, HEAD_DIM = 32, 8, 128
NEW_TOKENS = 16
THETA_ALL, THETA_SELECT = 12.0, 3.5
# Structured inputs: queries and 10% of the keys (the stripes) share a
# direction; the sink block leans on it too.  At theta=3.5 the stripes pass
# the threshold and the other candidate keys do not.
STRIPE_FRACTION, Q_LEAN, K_LEAN = 0.1, 0.3, 0.6
# Prefill logits (bf16 model, 32 layers): the paths differ in the order of
# f32 sums inside attention, so a layer's bf16 attention output may differ
# by one ulp (2**-8 relative) on some elements, compounded over 32 layers.
# On a CPU run of the same model code at 8 layers and width 1024 the
# anchor-vs-dense difference was 1.0% (relative L2) and 0.023 at most,
# against logits of std 0.64.
LOGIT_REL_TOL, LOGIT_ABS_TOL = 0.05, 0.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------ work counts --


def anchor_pairs(lengths, cfg) -> int:
    """(row, key) pairs of the anchor region (sink block and local window,
    causal, inside the sequence) summed over the batch, per head."""
    total = 0
    sb_q = cfg.superblock_q()
    for n in lengths:
        r = np.arange(n)
        w_start = np.maximum(1, (r // sb_q) * cfg.step * cfg.r) * cfg.block_kv
        total += int(np.minimum(r + 1, cfg.block_kv).sum()
                     + np.maximum(0, r + 1 - w_start).sum())
    return total


def sparse_pairs(lengths, counts, cfg) -> int:
    """Kept (row, key) pairs of the fused sweep over all heads: the anchor
    region plus each superblock's kept stripes for its valid rows."""
    sb_q = cfg.superblock_q()
    t_s = counts.shape[-1]
    rows = np.array([[max(0, min(n - s * sb_q, sb_q)) for s in range(t_s)]
                     for n in lengths])  # (B, T_s)
    stripe = int((counts.cpu().numpy().astype(np.int64) * rows[:, None]).sum())
    return stripe + HQ * anchor_pairs(lengths, cfg)


def causal_pairs(lengths) -> int:
    return HQ * sum(n * (n + 1) // 2 for n in lengths)


def band_keys(lengths, t_s, cfg) -> int:
    """Candidate-band keys scored by stripe_select, per KV head."""
    from repro_torch.kernels.indexing import window_start_tokens
    return sum(max(0, min(window_start_tokens(s, cfg), n) - cfg.block_kv)
               for n in lengths for s in range(t_s))


# ------------------------------------------------------------- phases ----


def phase_environment(build) -> dict:
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else None)
    build_s = build.build_all(force=True)
    rec = {"phase": "environment", "nvidia_smi": nvidia_smi(),
           "device": torch.cuda.get_device_name(0),
           "python": sys.version.split()[0], "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": nvcc, "triton": triton,
           "build_s": build_s, "ptxas": build.PTXAS}
    emit(rec)
    return rec


def make_inputs(dtype, structured: bool, seed: int = 0):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, n = len(MAIN_LENGTHS), max(MAIN_LENGTHS)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = randn(b, HQ, n, HEAD_DIM), randn(b, HKV, n, HEAD_DIM), randn(b, HKV, n, HEAD_DIM)
    if structured:
        u = randn(HEAD_DIM)
        u = u / u.norm() * math.sqrt(HEAD_DIM)
        stripe = torch.rand((b, HKV, n, 1), generator=gen, device=dev) < STRIPE_FRACTION
        stripe[:, :, :128] = True  # the sink block
        q = q + Q_LEAN * u
        k = k + K_LEAN * u * stripe
    lengths = torch.tensor(MAIN_LENGTHS, dtype=torch.int32, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), lengths


def check_close(name, got, want, dtype, case):
    """Kernel output against the plain version, element by element.

    f32: |got - want| <= 1e-5 + 1e-4 * max|want| (the same f32 products
    summed in another order).  bf16: |got - want| <= 2**-7 * |want| + 1e-4
    per element.  Both sides round an f32 value to bf16, and those f32
    values differ only by summation order (~1e-6), so they land on the same
    or on neighbouring bf16 numbers, one ulp apart, which is at most
    2**-7 of the value; the 1e-4 floor covers values near zero.  A rule
    scaled by each element holds the long rows, whose outputs average
    thousands of v rows and are small, as tightly as the large early rows.
    Returns the max abs error and the largest error-to-limit ratio."""
    g, w = got.float(), want.float()
    err_t = (g - w).abs()
    if dtype == torch.float32:
        limit = torch.full_like(w, 1e-5 + 1e-4 * float(w.abs().max()))
    else:
        limit = 2.0 ** -7 * w.abs() + 1e-4
    ratio = float((err_t / limit).max())
    err = float(err_t.max())
    if not ratio <= 1.0:
        worst = int((err_t / limit).argmax())
        fail(f"{name} ({case}, {dtype}): |got - want| = {float(err_t.flatten()[worst])} "
             f"> {float(limit.flatten()[worst])} at flat index {worst} "
             f"(want {float(w.flatten()[worst])})")
    return err, ratio


def phase_kernels(dtype, structured: bool) -> dict:
    from repro_torch.core.config import AnchorConfig
    from repro_torch.kernels import anchor, flash, indexing, sparse, stripe_select

    theta = THETA_SELECT if structured else THETA_ALL
    case = ("structured" if structured else "random") + f"_theta{theta:g}"
    cfg = AnchorConfig(theta=theta)
    q, k, v, lengths = make_inputs(dtype, structured)
    n = q.shape[2]
    tile = indexing.stripe_tile(n, 128)
    res = {}

    # flash
    out_k = flash.flash_attention_cuda(q, k, v, lengths=lengths)
    out_p = flash.flash_attention_torch(q, k, v, lengths=lengths)
    err, ratio = check_close("flash", out_k, out_p, dtype, case)
    flops = 4 * HEAD_DIM * causal_pairs(MAIN_LENGTHS)
    b_ms, b_by = bound(flops, nbytes(q, k, v, out_k, lengths), dtype)
    lib_ms = None
    if not structured:
        lib_ms = timed_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 5)
    res["flash"] = {
        "max_abs_err": err, "err_over_limit": ratio,
        "ms": timed_ms(lambda: flash.flash_attention_cuda(q, k, v, lengths=lengths), 5),
        "plain_ms": timed_ms(lambda: flash.flash_attention_torch(q, k, v, lengths=lengths), 2),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "library_ms": lib_ms}
    del out_k, out_p

    # anchor
    qm, mb = anchor.anchor_phase_cuda(q, k, cfg, lengths=lengths)
    qm0, mb0 = anchor.anchor_phase_torch(q, k, cfg, lengths=lengths)
    if not torch.equal(torch.isinf(mb), torch.isinf(mb0)):
        fail(f"anchor ({case}, {dtype}): +inf sentinels differ")
    fin = torch.isfinite(mb0)
    err = max(float((qm - qm0).abs().max()), float((mb[fin] - mb0[fin]).abs().max()))
    # Scores are f32 whatever the input dtype; sums of D=128 products in
    # another order differ by ~1e-6 of the score scale (~10).
    if not err <= 1e-4:
        fail(f"anchor ({case}, {dtype}): max abs error {err} > 1e-4")
    flops = 2 * HEAD_DIM * HQ * anchor_pairs(MAIN_LENGTHS, cfg)
    b_ms, b_by = bound(flops, nbytes(q, k, qm, mb, lengths), dtype)
    res["anchor"] = {
        "max_abs_err": err, "tol": 1e-4,
        "ms": timed_ms(lambda: anchor.anchor_phase_cuda(q, k, cfg, lengths=lengths), 10),
        "plain_ms": timed_ms(lambda: anchor.anchor_phase_torch(q, k, cfg, lengths=lengths), 2),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "library_ms": None}

    # stripe_select, both fed the kernel's anchor outputs
    got = stripe_select.stripe_select_cuda(qm, mb, k, cfg, tile, lengths=lengths)
    want = stripe_select.stripe_select_torch(qm, mb, k, cfg, tile, lengths=lengths)
    near = stripe_select.near_threshold_keys(qm, mb, k, cfg)
    cmp = stripe_select.compare_selections(got, want, near)
    if not cmp["agree"]:
        fail(f"stripe_select ({case}, {dtype}): tables disagree: {cmp}")
    t_s = got[0].tile_idx.shape[2]
    g = HQ // HKV
    flops = 2 * HEAD_DIM * g * cfg.step * HKV * band_keys(MAIN_LENGTHS, t_s, cfg)
    k_bytes = k.element_size() * HEAD_DIM * HKV * sum(
        min(n_, (t_s - 1) * cfg.superblock_q()) for n_ in MAIN_LENGTHS)
    b_ms, b_by = bound(flops, k_bytes + nbytes(qm, mb, *got[0], got[1]), dtype)
    res["stripe_select"] = {
        "max_abs_err": 0.0, **cmp,
        "ms": timed_ms(lambda: stripe_select.stripe_select_cuda(
            qm, mb, k, cfg, tile, lengths=lengths), 20),
        "plain_ms": timed_ms(lambda: stripe_select.stripe_select_torch(
            qm, mb, k, cfg, tile, lengths=lengths), 3),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "library_ms": None}

    # sparse, on the merged tables of the kernel's selection
    tables = indexing.merge_anchor_slots(got[0], n, cfg)
    out_k = sparse.sparse_attention_cuda(q, k, v, tables, cfg, lengths=lengths)
    out_p = sparse.sparse_attention_torch(q, k, v, tables, cfg, lengths=lengths)
    err, ratio = check_close("sparse", out_k, out_p, dtype, case)
    pairs = sparse_pairs(MAIN_LENGTHS, got[1], cfg)
    flops = 4 * HEAD_DIM * pairs
    b_ms, b_by = bound(flops, nbytes(q, k, v, *tables, out_k, lengths), dtype)
    res["sparse"] = {
        "max_abs_err": err, "err_over_limit": ratio,
        "ms": timed_ms(lambda: sparse.sparse_attention_cuda(
            q, k, v, tables, cfg, lengths=lengths), 5),
        "plain_ms": timed_ms(lambda: sparse.sparse_attention_torch(
            q, k, v, tables, cfg, lengths=lengths), 2),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "library_ms": None}
    rec = {"phase": "kernels", "case": case, "dtype": str(dtype),
           "lengths": MAIN_LENGTHS, "theta": theta,
           "kept_fraction": pairs / causal_pairs(MAIN_LENGTHS), "kernels": res}
    emit(rec)
    return rec


def run_engine(params, cfg, spec, prompts, build) -> dict:
    from repro_torch.serving import Request, ServingEngine

    max_len = spec.anchor.prefill_pad_len(max(MAIN_LENGTHS)) + NEW_TOKENS + 8
    engine = ServingEngine(params, cfg, max_batch=len(prompts), max_len=max_len,
                           spec=spec)
    for uid, p in enumerate(prompts):
        engine.submit(Request(uid=uid, prompt=p, max_new_tokens=NEW_TOKENS))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    done = engine.step()  # the admission wave's prefill, then one decode round
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    steps = 1
    while not engine.idle:
        done += engine.step()
        steps += 1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    tokens = {r.uid: r.generated for r in done}
    if sorted(tokens) != list(range(len(prompts))) or any(
            len(t) != NEW_TOKENS for t in tokens.values()):
        fail(f"{spec.algorithm} engine: not every request got {NEW_TOKENS} tokens")
    decoded = len(prompts) * (NEW_TOKENS - 2)  # tokens of steps 2..end
    return {"stats": engine.snapshot(), "launches": launches,
            "first_step_s": t1 - t0, "engine_steps": steps,
            "decode_tokens_per_s": decoded / (t2 - t1),
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "first_tokens": [tokens[u][0] for u in range(len(prompts))]}


def phase_main_path(build):
    from repro_torch.configs import get_config
    from repro_torch.core.config import PAPER_CONFIG
    from repro_torch.core.spec import AttentionSpec
    from repro_torch.models import model as model_lib

    cfg = get_config("llama31_8b")
    t0 = time.perf_counter()
    params = model_lib.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                            device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in MAIN_LENGTHS]
    anchor_spec = AttentionSpec(algorithm="anchor", backend="cuda",
                                anchor=PAPER_CONFIG)
    dense_spec = anchor_spec.with_algorithm("dense")
    layers = cfg.num_layers
    runs = {}
    for name, spec, want_launch in (
            ("anchor", anchor_spec, {"anchor": layers, "stripe_select": layers, "sparse": layers}),
            ("dense", dense_spec, {"flash": layers})):
        # One wave, padded to the superblock boundary (anchor) or to the
        # longest prompt (dense); one decode call per position group.
        n_pad = max(MAIN_LENGTHS)
        if name == "anchor":
            n_pad = PAPER_CONFIG.prefill_pad_len(n_pad)
        want_stats = {"prefill_requests": 4, "batched_prefills": 1, "dense_fallbacks": 0,
                      "padded_tokens": len(MAIN_LENGTHS) * n_pad - sum(MAIN_LENGTHS),
                      "decode_steps": len(set(MAIN_LENGTHS)) * (NEW_TOKENS - 1),
                      "length_truncations": 0, "active_slots": 0, "queued": 0}
        run = run_engine(params, cfg, spec, prompts, build)
        if run["launches"] != want_launch:
            fail(f"{name} path launches {run['launches']}, want {want_launch}")
        if run["stats"] != want_stats:
            fail(f"{name} path stats {run['stats']}, want {want_stats}")
        runs[name] = run
        torch.cuda.empty_cache()
    emit({"phase": "main_path", "model": cfg.name, "params": cfg.num_params(),
          "init_s": init_s, "lengths": MAIN_LENGTHS, "new_tokens": NEW_TOKENS,
          "anchor_config": vars(PAPER_CONFIG), **runs})
    return params, cfg, prompts, runs


def phase_logits(params, cfg, prompts):
    from repro_torch.core.config import PAPER_CONFIG, AnchorConfig
    from repro_torch.core.spec import AttentionSpec
    from repro_torch.models import model as model_lib

    n_pad = PAPER_CONFIG.prefill_pad_len(max(MAIN_LENGTHS))
    toks = torch.zeros((len(prompts), n_pad), dtype=torch.int64)
    for j, p in enumerate(prompts):
        toks[j, :len(p)] = torch.from_numpy(p)
    lengths = torch.tensor(MAIN_LENGTHS, dtype=torch.int32)

    def logits(algorithm, backend, theta=PAPER_CONFIG.theta):
        anchor = AnchorConfig(theta=theta)
        spec = AttentionSpec(algorithm=algorithm, backend=backend, anchor=anchor)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = model_lib.prefill(params, toks, cfg, spec=spec, lengths=lengths)
        del cache
        torch.cuda.synchronize()
        out = out.float()
        if out.shape != (len(prompts), cfg.vocab_size) or not torch.isfinite(out).all():
            fail(f"{algorithm}/{backend} logits: shape {tuple(out.shape)} or not finite")
        return out, time.perf_counter() - t0

    def diff(a, b):
        return {"max_abs": float((a - b).abs().max()),
                "rel_l2": float((a - b).norm() / b.norm()),
                "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum())}

    kern, t_kern = logits("anchor", "cuda")
    plain, t_plain = logits("anchor", "torch")
    dense, t_dense = logits("dense", "cuda")
    exact, t_exact = logits("anchor", "cuda", theta=1e9)
    control, _ = logits("anchor", "cuda", theta=-1e9)  # sink and window only
    checks = {"kernel_vs_plain": diff(kern, plain), "anchor_inf_vs_dense": diff(exact, dense),
              "window_only_vs_dense": diff(control, dense)}
    emit({"phase": "logits", "tolerance": {"rel_l2": LOGIT_REL_TOL, "max_abs": LOGIT_ABS_TOL},
          "logit_std": float(dense.std()), "prefill_s": {
              "anchor_kernels": t_kern, "anchor_plain": t_plain, "dense_kernel": t_dense,
              "anchor_theta_1e9_kernels": t_exact}, **checks})
    for name in ("kernel_vs_plain", "anchor_inf_vs_dense"):
        d = checks[name]
        if not (d["rel_l2"] <= LOGIT_REL_TOL and d["max_abs"] <= LOGIT_ABS_TOL):
            fail(f"{name}: {d} outside rel_l2 <= {LOGIT_REL_TOL}, max_abs <= {LOGIT_ABS_TOL}")


def main() -> int:
    # The smoke drives one card: pin the process to the first visible one
    # before torch initialises CUDA.
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment(build)

    kern = {}
    for dtype in (torch.bfloat16, torch.float32):
        for structured in (False, True):
            kern[(dtype, structured)] = phase_kernels(dtype, structured)
            torch.cuda.empty_cache()
    sel = kern[(torch.bfloat16, True)]["kernels"]["sparse"]["ms"]
    full = kern[(torch.bfloat16, False)]["kernels"]["sparse"]["ms"]
    if not sel < full:
        fail(f"sparse kernel: {sel} ms at the selective case is not below "
             f"{full} ms with everything kept")

    params, cfg, prompts, runs = phase_main_path(build)
    phase_logits(params, cfg, prompts)

    sources = {"flash": ("flash.cu", "src/repro/kernels/flash.py:83"),
               "anchor": ("anchor.cu", "src/repro/kernels/anchor.py:96"),
               "stripe_select": ("stripe_select.cu", "src/repro/kernels/stripe_select.py:107"),
               "sparse": ("sparse.cu", "src/repro/kernels/sparse.py:104")}
    main_case = kern[(torch.bfloat16, False)]["kernels"]
    summary = []
    for name, (src, replaces) in sources.items():
        r = main_case[name]
        path = runs["dense"] if name == "flash" else runs["anchor"]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": path["launches"].get(name, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": summary})
    print(nvidia_smi(), flush=True)
    count = torch.cuda.device_count()
    if count != 1:
        fail(f"{count} cards visible after pinning to one")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
