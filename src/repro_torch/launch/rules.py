"""Arch-aware logical→mesh axis rules: the port of
``src/repro/launch/rules.py``.

The generic rule sets in `repro_torch.launch.sharding` assume every
dimension divides the mesh axis; real configs don't always (gemma has 8
heads on a 16-way model axis, mixtral has 8 experts). `make_rules` builds
the rule set per (config × step kind × mesh), dropping or re-routing
mappings that don't divide — e.g. when experts can't shard over `model`,
the expert FFN dim takes `model` instead (so the parameters still shard
512 ways under FSDP × TP).

``mesh`` is a `DeviceMesh` or a ``{axis name: size}`` mapping (rules at the
production sizes need no world of 256 ranks).
"""
from __future__ import annotations

from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.launch.mesh import mesh_axis_size, mesh_axis_names

__all__ = ["make_rules"]


def _fits(dim: int, mesh, axes) -> bool:
    return dim % mesh_axis_size(mesh, axes) == 0


def make_rules(cfg, kind: str, mesh) -> dict:
    if isinstance(cfg, LMConfig):
        return _lm_rules(cfg, kind, mesh)
    if isinstance(cfg, GNNConfig):
        return _gnn_rules(cfg, kind, mesh)
    if isinstance(cfg, RecSysConfig):
        return _recsys_rules(cfg, kind, mesh)
    raise TypeError(type(cfg))


def _lm_rules(cfg: LMConfig, kind: str, mesh) -> dict:
    names = mesh_axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model"
    heads_ok = _fits(cfg.n_heads, mesh, tp)
    mlp_ok = _fits(cfg.d_ff, mesh, tp)
    expert_ok = cfg.moe is not None and _fits(cfg.moe.n_experts, mesh, tp)
    expert_mlp_ok = cfg.moe is not None and _fits(cfg.moe.d_ff_expert, mesh, tp)
    rules = {
        "layer": None,
        "batch": dp,
        "seq": None,
        "kv_seq": None,
        "embed": None,
        "heads": tp if heads_ok else None,
        "kv_heads": None,  # Nkv < TP for all assigned archs: replicate KV
        "mlp": tp if mlp_ok else None,
        "vocab": tp if _fits(cfg.vocab_size, mesh, tp) else None,
        "expert": tp if expert_ok else None,
        # if experts can't shard over model, shard the expert FFN dim instead
        "expert_mlp": None if expert_ok or not expert_mlp_ok else tp,
        # dispatch buffers always shard their capacity dim over DP: the
        # (E, C, D) buffer would otherwise replicate tens of GB per chip
        "expert_capacity": dp,
        "expert_group": dp,   # grouped-dispatch group axis
        "kv_block": tp,       # flash-decoding block axis
        "fsdp": dp,
        "lora": None,
    }
    if kind == "decode":
        # batch carries dp; kv cache length shards over the model axis
        # (decode attention is memory-bound: splitting S is flash-decoding)
        rules["kv_seq"] = tp
    if kind == "decode_long":
        # batch=1: everything rides on the sequence axis
        rules["batch"] = None
        rules["kv_seq"] = dp + (tp,)
    if (
        kind in ("prefill", "decode", "decode_long")
        and cfg.inference_param_sharding == "tp_replicated"
    ):
        # inference keeps weights TP-sharded and DP-replicated — no per-step
        # FSDP gathers (they dominate decode collectives); experts spread
        # over data×model when the count divides
        rules["fsdp"] = None
        if cfg.moe is not None and _fits(cfg.moe.n_experts, mesh, dp + (tp,)):
            rules["expert"] = dp + (tp,)
    return rules


def _gnn_rules(cfg: GNNConfig, kind: str, mesh) -> dict:
    names = mesh_axis_names(mesh)
    all_axes = tuple(a for a in ("pod", "data", "model") if a in names)
    return {
        "layer": None,
        "nodes": all_axes,
        "edges": all_axes,
        "feat": None,
        "hidden": None,
        "classes": None,
        "graph_batch": None,  # per-graph labels are tiny (≤ batch count)
        "fsdp": None,
    }


def _recsys_rules(cfg: RecSysConfig, kind: str, mesh) -> dict:
    names = mesh_axis_names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model"
    return {
        "batch": dp,
        "field": None,
        "rows": tp if _fits(cfg.vocab_per_field, mesh, tp) else None,
        "embed": None,
        "mlp": tp if all(m % mesh_axis_size(mesh, tp) == 0 for m in cfg.mlp_layers) else None,
        "cin": tp if all(c % mesh_axis_size(mesh, tp) == 0 for c in cfg.cin_layers) else None,
        "candidates": dp + (tp,),
        "fsdp": None,
    }
