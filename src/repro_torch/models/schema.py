"""Parameters of the port's models, as the JAX package's ``models/schema.py``
makes them: the init kinds of its schemas, each leaf in its own dtype, and
the copy of a JAX parameter tree into a module whose parameter names are
that tree's paths. Parameters are made for serving (no gradient);
`trainable` turns gradients on for training, and `opt_state_from_jax`
carries a JAX ``AdamWState`` over to the port's."""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.optim import AdamWState, QTensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a leaf whose float32 draw would be larger is drawn a block of leading
# indices at a time (gemma-2b's largest, 2.4 GB, is drawn whole)
WHOLE_DRAW_BYTES = 4 << 30


def default_generator(device: torch.device) -> torch.Generator | None:
    """The models' default parameter draw: seed 0 on ``device``; None on
    ``meta``, whose tensors hold no values to draw."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(0)


def init_param(shape, kind: str, generator: torch.Generator | None, device,
               dtype: str = "float32") -> torch.Tensor:
    """The JAX schema's init kinds (``src/repro/models/schema.py``): ``he``
    and ``lecun`` are normals scaled by the fan-in (``shape[-2]``, or
    ``shape[-1]`` for a vector), ``embed`` a normal × 0.02, ``zeros`` and
    ``ones``. The normal is drawn and scaled in float32, then cast to
    ``dtype``, as the JAX initialisers do. A leaf over `WHOLE_DRAW_BYTES`
    in float32 (deepseek-v3's expert weights: 30 GB a leaf at two MoE
    layers) is drawn in blocks of its leading indices, each block no larger
    than that, straight into the output: the float32 transient stays one
    block."""
    dt = DTYPES[dtype]
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if kind == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = {"he": math.sqrt(2.0 / fan_in), "lecun": math.sqrt(1.0 / fan_in), "embed": 0.02}[kind]
    if 4 * math.prod(shape) <= WHOLE_DRAW_BYTES:
        t = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return t.mul_(std).to(dt)
    # the most trailing dims whose block fits, then as many such blocks a
    # draw as fit
    lead = next(i for i in range(1, len(shape) + 1)
                if 4 * math.prod(shape[i:]) <= WHOLE_DRAW_BYTES)
    block = shape[lead:]
    out = torch.empty(shape, dtype=dt, device=device)
    rows = out.view(-1, *block)
    step = WHOLE_DRAW_BYTES // (4 * math.prod(block))
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        t = torch.randn((n, *block), generator=generator, dtype=torch.float32, device=device)
        rows[i:i + n] = t.mul_(std)
    return out


def _is_leaf(v) -> bool:
    """A schema leaf is a tuple ``(shape, init kind[, dtype])``; a group is
    a dict."""
    return isinstance(v, tuple)


def _param(leaf: tuple, generator: torch.Generator, device) -> nn.Parameter:
    shape, kind, *dtype = leaf
    return nn.Parameter(init_param(shape, kind, generator, device, *dtype), requires_grad=False)


def _group(tree: dict, generator: torch.Generator, device) -> nn.Module:
    """A group of a schema as a module: a `ParameterDict` of leaves, or a
    `ModuleDict` of groups."""
    if all(_is_leaf(v) for v in tree.values()):
        return nn.ParameterDict({k: _param(v, generator, device) for k, v in tree.items()})
    return nn.ModuleDict({k: _group(v, generator, device) for k, v in tree.items()})


def attach(module: nn.Module, schema: dict, generator: torch.Generator, device) -> None:
    """Give ``module`` the parameters of ``schema`` (a nested dict of
    leaves), drawn from ``generator`` in the schema's order: a top-level
    leaf becomes a parameter, a group a submodule of that name. Parameters
    do not require gradients (serving)."""
    for name, v in schema.items():
        if _is_leaf(v):
            module.register_parameter(name, _param(v, generator, device))
        else:
            module.add_module(name, _group(v, generator, device))


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy ``params`` (a nested dict of numpy arrays, as a JAX model's
    ``init`` returns it) into ``model``, whose dotted parameter names are
    the paths of that tree. Each array is read through float32 (exact for
    bf16) and lands in its parameter's own dtype. Raises on a shape
    mismatch or a leaf count that differs."""
    n_leaves = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = np.array(_leaf(params, name), dtype=np.float32)  # a copy: the input may be read-only
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr))
            n_leaves += 1
    given = _count_leaves(params)
    if given != n_leaves:
        raise ValueError(f"params has {given} arrays, the schema {n_leaves}")
    return model


def trainable(model: nn.Module, on: bool = True) -> nn.Module:
    """Turn gradients on (or off) for every parameter of ``model``: the
    switch between serving (the default: nothing is recorded for a
    backward) and training. Returns ``model``."""
    for p in model.parameters():
        p.requires_grad_(on)
    return model


def _leaf(tree: dict, name: str):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


def opt_state_from_jax(state, model: nn.Module):
    """The port's `repro_torch.optim.AdamWState` from a JAX one (``step``,
    ``m``, ``v``; ``m`` and ``v`` nested dicts whose paths are ``model``'s
    dotted parameter names, each leaf a numpy array or a ``QTensor`` of two),
    on the model's devices: float32 moments stay float32, int8 payloads
    int8, bit for bit."""
    def conv(x, dev):
        if isinstance(x, tuple):  # a JAX QTensor (q, scale)
            return QTensor(*(torch.from_numpy(np.array(t)).to(dev) for t in x))
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    params = dict(model.named_parameters())
    if _count_leaves(state.m) != len(params):
        raise ValueError(f"m has {_count_leaves(state.m)} leaves, the model {len(params)}")
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32, device=dev),
        m={n: conv(_leaf(state.m, n), p.device) for n, p in params.items()},
        v={n: conv(_leaf(state.v, n), p.device) for n, p in params.items()},
    )


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1
