"""Parameters of the port's models, as the JAX package's ``models/schema.py``
makes them: a model declares its parameters once as a nested dict of
`ParamDef`s (shape, logical axes, init kind, dtype), and from that schema
come the parameters themselves (`attach`: each leaf in its own dtype, drawn
in the schema's order), their meta stand-ins (`abstract_params`), their
specs and placements under the active axis rules (`param_pspecs`,
`repro_torch.launch.sharding`), and their axes (`schema_axes`). On a mesh
(`attach`'s ``mesh``, `distribute_params`) each parameter is a `DTensor`
of which a rank holds only its own chunk.

`load_jax_params` copies a JAX parameter tree into a module whose
parameter names are that tree's paths. Parameters are made for serving (no
gradient); `trainable` turns gradients on for training, and
`opt_state_from_jax` carries a JAX ``AdamWState`` over to the port's."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch.sharding import axis_rules, placements, spec_for
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


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One leaf of a schema: its shape, its logical axes (one a dim, as
    `repro_torch.launch.sharding.spec_for` reads them), its init kind and
    its dtype."""

    shape: tuple
    axes: tuple
    init: str = "lecun"
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in length")


def _flatten(schema: dict, prefix=()):
    """``(path, ParamDef)`` of every leaf, in the schema's order."""
    for k, v in schema.items():
        if isinstance(v, ParamDef):
            yield prefix + (k,), v
        else:
            yield from _flatten(v, prefix + (k,))


def _tree(schema: dict, leaf) -> dict:
    """``schema``'s nesting with ``leaf(ParamDef)`` at each leaf."""
    out: dict = {}
    for path, d in _flatten(schema):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf(d)
    return out


def abstract_params(schema: dict) -> dict:
    """Every leaf as a ``meta`` tensor of its shape and dtype (the
    reference's ``ShapeDtypeStruct``s)."""
    return _tree(schema, lambda d: torch.empty(d.shape, dtype=DTYPES[d.dtype], device="meta"))


def param_pspecs(schema: dict) -> dict:
    """Every leaf's spec under the active axis rules (`spec_for`)."""
    return _tree(schema, lambda d: spec_for(d.axes))


def schema_axes(schema: dict) -> dict:
    """Every leaf's logical axes."""
    return _tree(schema, lambda d: d.axes)


def count_params(schema: dict) -> int:
    return sum(math.prod(d.shape) for _, d in _flatten(schema))


def rank_bytes(schema: dict, rules: dict, sizes: dict) -> int:
    """The bytes of rank 0's chunks of every leaf on a mesh of ``sizes``
    (``{axis: size}``) under ``rules``: each dim over the product of the
    sizes of its spec's mesh axes, rounded up (DTensor's first chunk)."""
    with axis_rules(None, rules):
        specs = {path: spec_for(d.axes) for path, d in _flatten(schema)}
    total = 0
    for path, d in _flatten(schema):
        local = list(d.shape)
        for i, entry in enumerate(specs[path]):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            local[i] = -(-local[i] // math.prod(sizes[a] for a in names))
        total += math.prod(local) * DTYPES[d.dtype].itemsize
    return total


def _param(d: ParamDef, generator, device, mesh, rules) -> nn.Parameter:
    t = init_param(d.shape, d.init, generator, device, d.dtype)
    if mesh is not None:
        t = shard_leaf(t, d.axes, mesh, rules)
    return nn.Parameter(t, requires_grad=False)


def shard_leaf(t: torch.Tensor, axes: tuple, mesh, rules: dict) -> DTensor:
    """``t`` as a `DTensor` on ``mesh`` with the placements of ``axes`` under
    ``rules``: this rank keeps its own chunk (a copy), and nothing goes over
    the process group (``src_data_rank=None``: every rank holds ``t``)."""
    with axis_rules(mesh, rules):
        pl = placements(spec_for(axes), mesh)
    d = distribute_tensor(t, mesh, pl, src_data_rank=None)
    # the chunk may be a view of ``t``: a copy of its own lets ``t`` go
    return DTensor.from_local(d.to_local().clone(), mesh, pl, run_check=False,
                              shape=d.shape, stride=d.stride())


def _group(tree: dict, generator, device, mesh, rules) -> nn.Module:
    """A group of a schema as a module: a `ParameterDict` of leaves, or a
    `ModuleDict` of groups."""
    if all(isinstance(v, ParamDef) for v in tree.values()):
        return nn.ParameterDict({k: _param(v, generator, device, mesh, rules)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _group(v, generator, device, mesh, rules)
                          for k, v in tree.items()})


def attach(module: nn.Module, schema: dict, generator: torch.Generator, device, *,
           mesh=None, rules: dict | None = None) -> None:
    """Give ``module`` the parameters of ``schema`` (a nested dict of
    `ParamDef`s), drawn from ``generator`` in the schema's order: a
    top-level leaf becomes a parameter, a group a submodule of that name.
    Parameters do not require gradients (serving). With a ``mesh`` each
    leaf is drawn whole, kept as this rank's chunk of a `DTensor` placed by
    ``rules`` (`shard_leaf`), and the whole freed before the next draw: the
    values are the one-device model's, and a rank's transient is one
    leaf."""
    if (mesh is None) != (rules is None):
        raise ValueError("a mesh needs its rules, and rules their mesh")
    for name, v in schema.items():
        if isinstance(v, ParamDef):
            module.register_parameter(name, _param(v, generator, device, mesh, rules))
        else:
            module.add_module(name, _group(v, generator, device, mesh, rules))


def axes_by_name(schema: dict) -> dict:
    """``{dotted parameter name: logical axes}`` of ``schema``."""
    return {".".join(path): d.axes for path, d in _flatten(schema)}


def distribute_params(module: nn.Module, schema: dict, mesh, rules: dict) -> nn.Module:
    """Turn ``module``'s parameters (built from ``schema``, whole on every
    rank) into `DTensor` parameters on ``mesh`` placed by ``rules``, one
    leaf at a time: each rank keeps its own chunk (`shard_leaf`), and each
    whole leaf is freed once its chunk is taken. Returns ``module``."""
    axes = axes_by_name(schema)
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        parent = module.get_submodule(owner) if owner else module
        shard = nn.Parameter(shard_leaf(p.detach(), axes[name], mesh, rules),
                             requires_grad=p.requires_grad)
        del p
        if isinstance(parent, nn.ParameterDict):
            parent[leaf] = shard
        else:
            setattr(parent, leaf, shard)
    return module


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy ``params`` (a nested dict of numpy arrays, as a JAX model's
    ``init`` returns it) into ``model``, whose dotted parameter names are
    the paths of that tree. Each array is read through float32 (exact for
    bf16) and lands in its parameter's own dtype. Raises on a shape
    mismatch or a leaf count that differs. A `DTensor` parameter takes
    this rank's chunk of its array."""
    n_leaves = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            arr = np.array(_leaf(params, name), dtype=np.float32)  # a copy: the input may be read-only
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(p.shape)}")
            if isinstance(p, DTensor):
                whole = torch.from_numpy(arr)
                p.to_local().copy_(distribute_tensor(whole, p.device_mesh, p.placements,
                                                     src_data_rank=None).to_local())
            else:
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
