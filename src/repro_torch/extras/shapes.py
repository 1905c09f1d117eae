"""Per-cell input specs for the one-card dry run: the port of
``src/repro/extras/shapes.py``.

Every (architecture × assigned input shape) cell defines:
  * ``fn(cfg, opt_cfg)``            — the step that gets priced: the port's
    `make_train_step` step, or the model's ``prefill``, ``decode_step``,
    ``forward`` or ``retrieval_score``;
  * ``abstract_args(cfg, opt_cfg)`` — the step's arguments as ``meta``
    tensors (shapes and dtypes, never allocated): a `torch.nn.Module` of
    meta parameters in the place of the JAX params tree, the AdamW state
    (int8 moments where the optimizer config asks for them), the batch;
  * ``arg_axes(cfg, opt_cfg)``      — the logical axes of every leaf of
    those arguments, as the reference's: the schema's axes in the place of
    the model (`schema_axes`), the optimizer state's (`opt_axes`), the
    batch's; mapped to a mesh by the active rule set (``launch/rules.py``);
  * ``kind``                        — train / prefill / decode /
    decode_long / serve / retrieve;
  * ``donate``                      — the arguments the step may overwrite
    (``(0, 1)`` for train, ``(1,)`` for decode).

Sharded dims are padded to multiples of 512 (`_pad`) as in the JAX package,
so every cell's shapes equal its shapes there. A decode step's position is
a Python int (the port's ``decode_step`` takes one): the cache's last slot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import optim
from repro_torch.configs.base import GNN_SHAPES, ArchEntry, GNNConfig, LMConfig
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tf
from repro_torch.models.schema import DTYPES, axes_by_name, schema_axes
from repro_torch.train.step import make_train_step

F32, I32, BOOL = torch.float32, torch.int32, torch.bool
META = torch.device("meta")

__all__ = ["LM_SHAPES", "GNN_SHAPES", "REC_SHAPES", "CellDef", "lm_cell", "gnn_cell",
           "recsys_cell", "build_cell", "all_cells", "leaves", "opt_axes", "schema_axes"]


def _pad(n: int, mult: int = 512) -> int:
    return mult * math.ceil(n / mult)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _opt_abstract(model: torch.nn.Module, opt_cfg: optim.AdamWConfig):
    """The AdamW state of ``model``'s meta parameters."""
    return optim.init(opt_cfg, dict(model.named_parameters()))


def opt_axes(schema: dict, opt_cfg: optim.AdamWConfig) -> optim.AdamWState:
    """The logical axes of the AdamW state of ``schema``'s parameters (the
    axes half of the reference's ``opt_abstract_and_axes``), keyed as the
    port's state is, by dotted parameter name: each moment has its
    parameter's axes, or with quantized moments a ``QTensor`` whose scale
    (one a row of the last dim) keeps every axis but the last."""
    def moment(a):
        if opt_cfg.quantize_moments:
            return optim.QTensor(q=a, scale=tuple(a[:-1]) + (None,))
        return a

    flat = axes_by_name(schema)
    return optim.AdamWState(step=(), m={n: moment(a) for n, a in flat.items()},
                            v={n: moment(a) for n, a in flat.items()})


def _no_grad(fn: Callable) -> Callable:
    def run(*args):
        with torch.no_grad():
            return fn(*args)

    return run


@dataclasses.dataclass
class CellDef:
    arch_id: str
    shape_id: str
    kind: str                      # train / prefill / decode / serve / ...
    fn: Callable                   # (cfg, opt_cfg) -> step callable
    abstract_args: Callable        # (cfg, opt_cfg) -> tuple of meta args
    arg_axes: Callable             # (cfg, opt_cfg) -> the args' logical axes
    donate: tuple[int, ...] = ()


# -------------------------------------------------------------------- LM
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode_long", seq=524288, batch=1),
}


def _lm_cache_abstract(cfg: LMConfig, batch: int, s_cap: int):
    """The decode cache's meta tensors and their logical axes (two
    `DecodeCache`s)."""
    dt = DTYPES[cfg.dtype]
    L = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        data = (_sds((L, batch, s_cap, m.kv_lora_rank), dt),
                _sds((L, batch, s_cap, m.d_rope), dt))
        axes = (("layer", "batch", "kv_seq", None),) * 2
    else:
        sh = (L, batch, s_cap, cfg.n_kv_heads, cfg.d_head)
        data = (_sds(sh, dt), _sds(sh, dt))
        axes = (tf.CACHE_AXES,) * 2
    return (tf.DecodeCache(data, cfg.attn_kind, s_cap, False),
            tf.DecodeCache(axes, cfg.attn_kind, s_cap, False))


def lm_cell(entry: ArchEntry, shape_id: str) -> CellDef:
    spec = LM_SHAPES[shape_id]
    kind = spec["kind"]

    def model(cfg):
        return tf.Transformer(cfg, device=META)

    if kind == "train":
        def fn(cfg, opt_cfg):
            return make_train_step(cfg, opt_cfg)

        def abstract_args(cfg, opt_cfg):
            m = model(cfg)
            return (m, _opt_abstract(m, opt_cfg),
                    {"tokens": _sds((spec["batch"], spec["seq"]), I32)}, _sds((), I32))

        def arg_axes(cfg, opt_cfg):
            sch = tf.lm_schema(cfg)
            return (schema_axes(sch), opt_axes(sch, opt_cfg), {"tokens": ("batch", "seq")}, ())

        return CellDef(entry.arch_id, shape_id, kind, fn, abstract_args, arg_axes, donate=(0, 1))

    if kind == "prefill":
        def fn(cfg, opt_cfg):
            return _no_grad(lambda m, tokens: m.prefill(tokens))

        def abstract_args(cfg, opt_cfg):
            return (model(cfg), _sds((spec["batch"], spec["seq"]), I32))

        def arg_axes(cfg, opt_cfg):
            return (schema_axes(tf.lm_schema(cfg)), ("batch", "seq"))

        return CellDef(entry.arch_id, shape_id, kind, fn, abstract_args, arg_axes)

    # decode / decode_long
    def fn(cfg, opt_cfg):
        return _no_grad(lambda m, cache, token, pos: m.decode_step(cache, token, pos))

    def abstract_args(cfg, opt_cfg):
        return (model(cfg), _lm_cache_abstract(cfg, spec["batch"], spec["seq"])[0],
                _sds((spec["batch"], 1), I32), spec["seq"] - 1)

    def arg_axes(cfg, opt_cfg):
        return (schema_axes(tf.lm_schema(cfg)),
                _lm_cache_abstract(cfg, spec["batch"], spec["seq"])[1], ("batch", None), ())

    return CellDef(entry.arch_id, shape_id, kind, fn, abstract_args, arg_axes, donate=(1,))


# ------------------------------------------------------------------- GNN
def _gnn_batch_axes(cfg: GNNConfig, s: dict) -> gnn_lib.GraphBatch:
    task = s["task"]
    return gnn_lib.GraphBatch(
        node_feat=("nodes", "feat"),
        edge_src=("edges",),
        edge_dst=("edges",),
        node_mask=("nodes",),
        edge_mask=("edges",),
        edge_feat=("edges", None) if cfg.d_edge else None,
        node_pos=("nodes", None) if cfg.kind == "egnn" else None,
        graph_id=("nodes",) if task == "graph" else None,
        n_graphs=s.get("n_graphs", 1),
        labels=("graph_batch",) if task == "graph" else ("nodes",),
        label_mask=("nodes",) if task != "graph" else None,
    )


def _gnn_batch_abstract(cfg: GNNConfig, s: dict, *, regression: bool = False):
    N, E = _pad(s["n"]), _pad(s["e"])
    task = s["task"]
    return gnn_lib.GraphBatch(
        node_feat=_sds((N, s["d"]), F32),
        edge_src=_sds((E,), I32),
        edge_dst=_sds((E,), I32),
        node_mask=_sds((N,), BOOL),
        edge_mask=_sds((E,), BOOL),
        edge_feat=_sds((E, cfg.d_edge), F32) if cfg.d_edge else None,
        node_pos=_sds((N, 3), F32) if cfg.kind == "egnn" else None,
        graph_id=_sds((N,), I32) if task == "graph" else None,
        n_graphs=s.get("n_graphs", 1),
        labels=_sds((s.get("n_graphs", N) if task == "graph" else N,),
                    F32 if regression else I32),
        label_mask=_sds((N,), BOOL) if task != "graph" else None,
    )


def gnn_cell(entry: ArchEntry, shape_id: str) -> CellDef:
    s = GNN_SHAPES[shape_id]
    regression = entry.config.task == "regression"
    # the shape dictates input dim and pooling level; the arch dictates the
    # loss kind (float labels → MSE, incl. graph-level regression)
    task = "graph" if s["task"] == "graph" else ("regression" if regression else "node")

    def adapt(cfg: GNNConfig) -> GNNConfig:
        return dataclasses.replace(cfg, d_in=s["d"], task=task)

    def fn(cfg, opt_cfg):
        return make_train_step(adapt(cfg), opt_cfg)

    def abstract_args(cfg, opt_cfg):
        c = adapt(cfg)
        m = gnn_lib.GNN(c, device=META)
        return (m, _opt_abstract(m, opt_cfg),
                {"graph": _gnn_batch_abstract(c, s, regression=regression)}, _sds((), I32))

    def arg_axes(cfg, opt_cfg):
        c = adapt(cfg)
        sch = gnn_lib.gnn_schema(c)
        return (schema_axes(sch), opt_axes(sch, opt_cfg), {"graph": _gnn_batch_axes(c, s)}, ())

    return CellDef(entry.arch_id, shape_id, "train", fn, abstract_args, arg_axes, donate=(0, 1))


# ---------------------------------------------------------------- recsys
REC_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieve", batch=1, n_candidates=1_000_000),
}


def recsys_cell(entry: ArchEntry, shape_id: str) -> CellDef:
    s = REC_SHAPES[shape_id]
    kind = s["kind"]

    def ids_abs(cfg, b):
        return (_sds((b, cfg.n_sparse, cfg.bag_size), I32),
                _sds((b, cfg.n_sparse, cfg.bag_size), BOOL))

    def model(cfg):
        return recsys_lib.XDeepFM(cfg, device=META)

    ids_ax = (("batch", "field", None), ("batch", "field", None))

    if kind == "train":
        def fn(cfg, opt_cfg):
            return make_train_step(cfg, opt_cfg)

        def abstract_args(cfg, opt_cfg):
            m = model(cfg)
            ids, mask = ids_abs(cfg, s["batch"])
            return (m, _opt_abstract(m, opt_cfg),
                    {"ids": ids, "bag_mask": mask, "labels": _sds((s["batch"],), I32)},
                    _sds((), I32))

        def arg_axes(cfg, opt_cfg):
            sch = recsys_lib.recsys_schema(cfg)
            return (schema_axes(sch), opt_axes(sch, opt_cfg),
                    {"ids": ids_ax[0], "bag_mask": ids_ax[1], "labels": ("batch",)}, ())

        return CellDef(entry.arch_id, shape_id, kind, fn, abstract_args, arg_axes, donate=(0, 1))

    if kind == "serve":
        def fn(cfg, opt_cfg):
            return _no_grad(lambda m, ids, mask: m(ids, mask))

        def abstract_args(cfg, opt_cfg):
            return (model(cfg),) + ids_abs(cfg, s["batch"])

        def arg_axes(cfg, opt_cfg):
            return (schema_axes(recsys_lib.recsys_schema(cfg)),) + ids_ax

        return CellDef(entry.arch_id, shape_id, kind, fn, abstract_args, arg_axes)

    # retrieval
    def fn(cfg, opt_cfg):
        return _no_grad(lambda m, ids, mask, cand: m.retrieval_score(ids, mask, cand))

    def abstract_args(cfg, opt_cfg):
        return (model(cfg),) + ids_abs(cfg, 1) + (_sds((_pad(s["n_candidates"]),), I32),)

    def arg_axes(cfg, opt_cfg):
        return (schema_axes(recsys_lib.recsys_schema(cfg)), (None, "field", None),
                (None, "field", None), ("candidates",))

    return CellDef(entry.arch_id, shape_id, kind, fn, abstract_args, arg_axes)


# --------------------------------------------------------------- registry
def build_cell(entry: ArchEntry, shape_id: str) -> CellDef:
    if entry.family == "lm":
        return lm_cell(entry, shape_id)
    if entry.family == "gnn":
        return gnn_cell(entry, shape_id)
    if entry.family == "recsys":
        return recsys_cell(entry, shape_id)
    raise ValueError(entry.family)


def all_cells() -> list[CellDef]:
    from repro_torch.configs import all_archs

    cells = []
    for entry in all_archs().values():
        if entry.family in ("lm", "gnn", "recsys"):
            for sh in entry.shapes:
                cells.append(build_cell(entry, sh))
    return cells


def leaves(tree, prefix: str = "") -> dict:
    """``{dotted path: tensor}`` of every tensor in ``tree`` (a cell's
    abstract arguments, or a step's results): a module's parameters by
    their dotted names, named tuples by field, dicts by key, sequences by
    index, a `DecodeCache` by ``data``; ints and None hold no tensor. The
    paths are the JAX package's key paths of the same arguments, joined by
    dots."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: dict = {}
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            out[join(name)] = p
    elif isinstance(tree, tf.DecodeCache):
        out.update(leaves(tree.data, join("data")))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), join(f)))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, join(k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(leaves(v, join(i)))
    return out
