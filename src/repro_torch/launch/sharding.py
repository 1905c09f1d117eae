"""Logical-axis sharding rules onto a `DeviceMesh`: the port of
``src/repro/launch/sharding.py``.

Model code annotates activations with *logical* axis names
(``logical(x, "batch", "seq", "embed")``); a rule set maps logical names to
mesh axes per (arch family × step kind). Parameters carry logical axes in
their schema (`repro_torch.models.schema.ParamDef`) and get their
placements the same way.

A spec (`spec_for`) is the reference's ``PartitionSpec`` as a plain tuple:
one entry a tensor dim, each ``None``, a mesh axis name, or a tuple of
names, trailing ``None``s stripped. `placements` turns one into DTensor
placements on a mesh: each mesh dim named for tensor dim ``i`` is
``Shard(i)``, every other ``Replicate()``.

Outside a rules context everything is a no-op, and `logical` passes a plain
tensor through in any context: the one-process path never touches DTensor.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

__all__ = ["axis_rules", "current_mesh", "current_rules", "gnn_rules", "lm_rules",
           "logical", "mesh_matmul", "placements", "placements_for", "recsys_rules",
           "shard_input", "spec_for"]

_state = threading.local()


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict):
    """Activate a logical→mesh axis mapping (and its mesh)."""
    old_rules = getattr(_state, "rules", None)
    old_mesh = getattr(_state, "mesh", None)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old_rules, old_mesh


def spec_for(axes: tuple) -> tuple:
    """Map logical axis names to a spec under the active rules: the
    reference's ``PartitionSpec`` entries as a tuple. A mesh axis already
    used by an earlier dim is dropped; trailing ``None``s are stripped."""
    rules = current_rules()
    if rules is None:
        return ()
    out: list = []
    used: set[str] = set()
    for name in axes:
        m = rules.get(name) if name is not None else None
        if m is None:
            out.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        used.update(ms)
        if not ms:
            out.append(None)  # all mesh axes already consumed by earlier dims
        else:
            out.append(ms if len(ms) != 1 else ms[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each mesh
    dim that tensor dim ``i`` names, ``Replicate()`` on the others. A
    tensor dim over several mesh dims must name them in mesh order (DTensor
    splits a dim over its mesh dims left to right, as the reference's
    multi-axis entries do); another order, or an axis the mesh lacks,
    raises."""
    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec}: mesh axes {missing} are not in the mesh {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: dim {i} names {axes}, not in the mesh's order {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


def logical(x, *axes):
    """Constrain an activation's placements by logical axis names: ``x``
    redistributed to the active rules' placements when it is a `DTensor`
    under active rules, else ``x`` itself."""
    mesh = current_mesh()
    if mesh is None or current_rules() is None or not isinstance(x, DTensor):
        return x
    want = placements(spec_for(axes), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def mesh_matmul(x, w):
    """``x (..., K) @ w (K, M)`` on DTensors with a fixed plan, mesh dim by
    mesh dim, where DTensor's own choice may shard a replicated output
    column that a later view cannot split (gemma's 8 heads on a 16-way
    axis): a weight's contraction dim sharded where ``x``'s is not is
    gathered first (the FSDP gather), as is an output dim of the weight
    that ``x``'s rows already use; ``x``'s rows keep their placement, the
    weight's columns theirs, and a contraction split on both sides gives a
    partial sum. ``x`` partial, or sharded on K alone, is replicated
    first. Plain tensors: ``x @ w``."""
    if not isinstance(w, DTensor):
        return x @ w
    mesh = w.device_mesh
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]) if x.dim() != 2 else x
    xpl, wpl, out = [], [], []
    for xp, wp in zip(x2.placements, w.placements):
        x_rows, x_k = xp == Shard(0), xp == Shard(1)
        w_k, w_cols = wp == Shard(0), wp == Shard(1)
        if x_k and w_k:
            xpl.append(xp), wpl.append(wp), out.append(Partial())
            continue
        xp = xp if x_rows else Replicate()
        wp = wp if w_cols and not x_rows else Replicate()
        xpl.append(xp), wpl.append(wp)
        out.append(Shard(0) if x_rows else Shard(1) if wp == Shard(1) else Replicate())
    xpl, wpl = tuple(xpl), tuple(wpl)
    x2 = x2.redistribute(mesh, xpl) if tuple(x2.placements) != xpl else x2
    w = w.redistribute(mesh, wpl) if tuple(w.placements) != wpl else w
    y = local_map(torch.matmul, out_placements=out, in_placements=(xpl, wpl),
                  device_mesh=mesh)(x2, w)
    return y.view(*lead, y.shape[-1]) if x.dim() != 2 else y


def shard_input(x, *axes):
    """An input entering the active mesh with logical ``axes``: a `DTensor`
    of which this rank keeps its own chunk (every rank holds the same
    ``x``: nothing goes over the process group). ``x`` itself without
    active rules, or when it is a DTensor already."""
    mesh = current_mesh()
    if mesh is None or current_rules() is None or isinstance(x, DTensor):
        return x
    return distribute_tensor(x, mesh, placements(spec_for(axes), mesh), src_data_rank=None)


def placements_for(axes: tuple) -> tuple | None:
    """The placements of a leaf with logical ``axes`` on the active mesh
    (the reference's ``named_sharding``); None without one."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return placements(spec_for(axes), mesh)


# ---------------------------------------------------------------- rule sets
def lm_rules(kind: str) -> dict:
    """kind: train | prefill | decode.

    data-parallel/FSDP over (pod, data); tensor-parallel over model.
    Sequence (context) parallelism shards long sequences over `data` in
    prefill. Experts shard over `model` (EP).
    """
    base = {
        "batch": ("pod", "data"),
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "qkv": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "fsdp": ("pod", "data"),     # param sharding axis (ZeRO-3 style)
        "seq": None,
        "kv_seq": None,
        "lora": None,
    }
    if kind == "prefill":
        base["seq"] = ("pod", "data")   # sequence parallelism
        base["batch"] = None
    if kind == "decode":
        base["kv_seq"] = None
    return base


def gnn_rules(kind: str) -> dict:
    return {
        "graph_batch": ("pod", "data"),
        "nodes": ("pod", "data"),
        "edges": ("pod", "data"),
        "feat": None,
        "hidden": "model",
        "fsdp": None,
        "classes": None,
    }


def recsys_rules(kind: str) -> dict:
    return {
        "batch": ("pod", "data"),
        "field": None,
        "rows": ("pod", "data", "model") if kind != "train" else ("model",),
        "embed": None,
        "mlp": "model",
        "cin": "model",
        "candidates": ("pod", "data", "model"),
        "fsdp": None,
    }
