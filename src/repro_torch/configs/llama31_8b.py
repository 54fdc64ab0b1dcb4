"""llama-3.1-8b-instruct, the paper's primary evaluation model (§4.1).
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama31-reduced", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
