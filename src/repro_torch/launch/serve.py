"""Serving entry point: batched requests through the continuous-batching engine.

On the card (full width, paper AnchorAttention config, random weights):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31_8b \
        --requests 4 --prompt-len 8192 --max-new 16

On the CPU (reduced config, the small anchor blocks of the reference's serve.py):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31_8b \
        --reduced --device cpu --requests 4 --prompt-len 64 --max-new 8
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.core.config import PAPER_CONFIG, AnchorConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.spec import AttentionSpec
from repro_torch.models import model as model_lib
from repro_torch.serving import Request, ServingEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--theta", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init(gen, cfg, device=device)
    if args.reduced:
        # The blocks of the reference's serve.py: small prompts still run sparse.
        anchor_cfg = AnchorConfig(block_q=16, block_kv=16, step=2,
                                  theta=args.theta)
    else:
        anchor_cfg = AnchorConfig(block_q=PAPER_CONFIG.block_q,
                                  block_kv=PAPER_CONFIG.block_kv,
                                  step=PAPER_CONFIG.step, theta=args.theta)
    spec = AttentionSpec(algorithm="anchor", anchor=anchor_cfg)
    # The cache fits prompts padded for sparse prefill, so no wave falls
    # back to dense.
    max_len = anchor_cfg.prefill_pad_len(args.prompt_len) + args.max_new + 8
    engine = ServingEngine(params, cfg, max_batch=args.max_batch,
                           max_len=max_len, spec=spec)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new))
    done = engine.run_to_completion()
    dt = time.time() - t0
    for req in sorted(done, key=lambda r: r.uid):
        print(f"req {req.uid}: generated {len(req.generated)} tokens: "
              f"{req.generated[:8]}")
    total = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {total} tokens in {dt:.1f}s on {device}")
    print(f"engine stats: {json.dumps(engine.snapshot())}")


if __name__ == "__main__":
    main()
