"""Parameters of the port's models, as the JAX package's ``models/schema.py``
makes them: the init kinds of its schemas, and the copy of a JAX parameter
tree into a module whose parameter names are that tree's paths."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def init_param(shape, kind: str, generator: torch.Generator, device) -> torch.Tensor:
    """The JAX schema's init kinds (``src/repro/models/schema.py``): ``he``
    and ``lecun`` are normals scaled by the fan-in (``shape[-2]``, or
    ``shape[-1]`` for a vector), ``embed`` a normal × 0.02, ``zeros``."""
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = {"he": math.sqrt(2.0 / fan_in), "lecun": math.sqrt(1.0 / fan_in), "embed": 0.02}[kind]
    t = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return t.mul_(std)


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy ``params`` (a nested dict of numpy arrays, as a JAX model's
    ``init`` returns it) into ``model``, whose dotted parameter names are
    the paths of that tree. Raises on a shape mismatch or a leaf count
    that differs."""
    n_leaves = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            node = params
            for part in name.split("."):
                node = node[part]
            arr = np.array(node, dtype=np.float32)  # a copy: the input may be read-only
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
            n_leaves += 1
    given = _count_leaves(params)
    if given != n_leaves:
        raise ValueError(f"params has {given} arrays, the schema {n_leaves}")
    return model


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1
