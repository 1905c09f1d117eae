"""Config dataclasses and the architecture registry, copied from the JAX
package's ``configs/base.py`` field for field, so that a config is the JAX
package's.

Every architecture registers an `ArchEntry` from its module in
``repro_torch/configs/<id>.py``; launchers select with ``--arch <id>``
(`get`, `all_archs`). `LMConfig.n_params` and `n_active_params` give the
parameter counts that `repro_torch.analysis.roofline`'s model FLOPs read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


# --------------------------------------------------------------------- LM
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    router: str = "softmax"          # softmax (Mixtral) | sigmoid (DeepSeek-V3)
    router_bias_balancing: bool = False  # aux-loss-free bias update (DSv3)
    n_groups: int = 1                # group-limited routing (DSv3)
    top_groups: int = 1
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.0
    first_k_dense: int = 0           # leading dense layers (DSv3: 3)
    d_ff_dense: int = 0              # d_ff of those dense layers
    dispatch_groups: int = 1         # DP-local dispatch groups (1 = one global)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    act: str = "swiglu"              # swiglu | geglu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mtp_depth: int = 0               # multi-token-prediction heads (DSv3)
    emb_scale: bool = False          # gemma scales embeddings by sqrt(d)
    dtype: str = "bfloat16"
    remat: str = "none"              # none | block | full
    decode_kv_blocks: int = 1        # split-KV decode blocks (1 = one softmax)
    inference_param_sharding: str = "fsdp"  # fsdp | tp_replicated

    @property
    def attn_kind(self) -> str:
        return "mla" if self.mla is not None else "gqa"

    def _emb_attn(self) -> tuple[int, int]:
        """Embedding and one layer's attention parameters."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.d_nope + m.d_rope)
                + d * (m.kv_lora_rank + m.d_rope)
                + m.kv_lora_rank * self.n_heads * (m.d_nope + m.d_v)
                + self.n_heads * m.d_v * d
            )
        else:
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head
            attn += self.n_heads * self.d_head * d
        return emb, attn

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        emb, attn = self._emb_attn()
        if self.moe is not None:
            moe = self.moe
            dense_layers = moe.first_k_dense
            moe_layers = L - dense_layers
            ff = dense_layers * 3 * d * (moe.d_ff_dense or self.d_ff)
            ff += moe_layers * (
                (moe.n_experts + moe.n_shared) * 3 * d * moe.d_ff_expert
                + d * moe.n_experts
            )
        else:
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            ff = L * mult * d * self.d_ff
        return emb + L * attn + ff

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed-to experts)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        moe = self.moe
        emb, attn = self._emb_attn()
        dense_layers = moe.first_k_dense
        moe_layers = L - dense_layers
        ff = dense_layers * 3 * d * (moe.d_ff_dense or self.d_ff)
        ff += moe_layers * (moe.top_k + moe.n_shared) * 3 * d * moe.d_ff_expert
        return emb + L * attn + ff


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                        # gatedgcn | egnn | gin | meshgraphnet
    n_layers: int
    d_hidden: int
    d_in: int = 64                   # input feature dim (overridden per shape)
    d_edge: int = 0
    n_classes: int = 16
    aggregator: str = "sum"
    mlp_layers: int = 2              # meshgraphnet per-MLP depth
    learnable_eps: bool = True       # GIN-ε
    task: str = "node"               # node | graph | regression
    dtype: str = "float32"


# The GNN input shapes (``GNN_SHAPES`` of ``src/repro/extras/shapes.py``):
# nodes, directed edges, input feature width, task. The port's one copy:
# `repro_torch.extras.shapes` reads it.
GNN_SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d=1433, task="node"),
    "minibatch_lg": dict(n=170624, e=168960, d=602, task="node"),
    "ogb_products": dict(n=2449029, e=61859140, d=100, task="node"),
    "molecule": dict(n=3840, e=8192, d=32, task="graph", n_graphs=128),
}


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    n_sparse: int = 39
    embed_dim: int = 10
    vocab_per_field: int = 1_000_000
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    bag_size: int = 1                # multi-hot bag length (EmbeddingBag)
    dtype: str = "float32"


# --------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class ArchEntry:
    arch_id: str
    family: str                             # lm | gnn | recsys | stwig
    config: Any
    smoke: Callable[[], Any]                # reduced config for CPU smoke
    shapes: tuple[str, ...]                 # assigned input-shape ids
    skipped_shapes: tuple[tuple[str, str], ...] = ()  # (shape, reason)


_REGISTRY: dict[str, ArchEntry] = {}


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.arch_id] = entry
    return entry


def get(arch_id: str) -> ArchEntry:
    if arch_id not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populate registry)
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchEntry]:
    import repro_torch.configs  # noqa: F401

    return dict(_REGISTRY)
