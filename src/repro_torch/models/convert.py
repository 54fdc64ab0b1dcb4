"""Carry parameters of the JAX reference across to the port.

The one bridge between the packages, and it takes numpy, not JAX: the
caller converts the reference's tree (``repro.models.model.init``) leaf
by leaf with ``numpy.asarray``.  The reference stacks every block leaf on
a leading ``num_groups`` axis (``transformer.stack_init``), and a group of
the dense family is one layer ``"l0"``; the port keeps one dict per
layer, so the converter unstacks that axis.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig

Params = dict[str, Any]


def _to_torch(tree, fn):
    if isinstance(tree, dict):
        return {key: _to_torch(val, fn) for key, val in tree.items()}
    return fn(np.asarray(tree))


def params_from_jax(tree: Params, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Params:
    """The port's parameters from the reference's tree of numpy arrays.

    Leaves keep their dtype (bf16 weights arrive as ml_dtypes bfloat16 and
    are converted exactly through float32).
    """
    cfg.check_supported()
    dev = resolve_device(device)

    def leaf(a: np.ndarray) -> torch.Tensor:
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)  # a writable copy

    out = {key: _to_torch(val, leaf) for key, val in tree.items()
           if key != "blocks"}
    layer = tree["blocks"]["l0"]
    out["blocks"] = [_to_torch(layer, lambda a, i=i: leaf(np.asarray(a)[i]))
                     for i in range(cfg.num_layers)]
    return out
