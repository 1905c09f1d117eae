"""Decoder-only LM on PyTorch: the port of ``src/repro/models/transformer.py``
for serving (prefill and decode), for every LM family of the JAX package:

  qwen2-72b / qwen1.5-110b  — GQA + QKV bias, SwiGLU
  gemma-2b                  — MQA (kv=1), GeGLU, head_dim 256, scaled embed
  mixtral-8x22b             — GQA + sliding-window attention, MoE 8e top-2
  deepseek-v3-671b          — MLA, 1 shared + 256 routed top-8 (sigmoid,
                              aux-free bias), first-3-dense, MTP head

`Transformer` keeps the JAX package's parameter layout and names
(`lm_schema`): ``embed (V, D)``, ``norm_attn``/``norm_ffn (L, D)`` and
``final_norm (D,)`` in float32; ``attn.{wq (L, D, N, H), wk, wv (L, D,
Nkv, H), wo (L, N, H, D)}`` (+ ``bq``/``bk``/``bv`` with QKV bias), or the
``mla`` group in its place (`models.mla.mla_schema`); ``ffn_dense.{wi_gate,
wi_up (L', D, F'), wo (L', F', D)}`` over every layer of a dense model or
the ``first_k_dense`` prefix of a MoE one (``F' = d_ff_dense or d_ff``),
and the ``moe`` group over the rest (`models.moe.moe_schema`); ``lm_head``
when the embeddings are not tied; ``mtp`` (DeepSeek-V3's multi-token
prediction head), carried but not used by serving. Every leaf is in its
schema dtype, so `params_from_jax` carries the JAX package's weights over
one to one. A Python loop over layers takes the place of ``lax.scan``: the
dense prefix, then the MoE suffix, whose layer ``l`` reads ``moe[…][l -
first_k_dense]``.

Every prefill attention (`Transformer.forward`) goes through
``Kernels.flash_attention`` — the hand-written CUDA kernels on the card
(``csrc/flash_attention*.cu``), the plain version on the CPU: the GQA
attention with the config's window and softcap, and MLA's over its
materialised heads (q/k head dim ``d_nope + d_rope``, v head dim ``d_v``).
Decode (`Transformer.decode_step`, one query against the cache) runs
`layers.attention`, or `layers.blocked_decode_attention` when
``decode_kv_blocks > 1``, or MLA's absorbed `models.mla.mla_decode`, as the
JAX package does. The MoE FFN (`models.moe.moe_ffn`) is plain PyTorch on
both, as it is jnp outside any kernel there. The decode cache is updated in
place (the JAX package returns a new one): the returned `DecodeCache` holds
the same tensors.

Training: `loss_fn` (next-token cross entropy on float32 logits, plus the
MoE auxiliary loss, plus DeepSeek-V3's 1-depth MTP head at ``0.1 ×``) over
`Transformer.forward_train`, which runs each layer under
`torch.utils.checkpoint` when ``cfg.remat`` asks for it. The attention's
gradient comes from ``Kernels.flash_attention``'s autograd Function (the
kernel forward, the plain version's vector-Jacobian product).

On a mesh (``Transformer(cfg, mesh=, rules=)``: a `DeviceMesh` and the
rules of `repro_torch.launch.rules.make_rules`) every parameter is a
`DTensor` of which a rank holds its own chunk, and the dense GQA/MQA path
runs on DTensors under the active axis rules (`launch.sharding.axis_rules`):
activations are constrained by `logical` at the JAX package's sites,
plain tensors (positions, masks, constants) count as replicated, the
prefill attention runs the kernel on each rank's ``(batch, heads)`` block
(`extras.flash_attention.sharded`), and decode writes each new key and
value on the rank that owns its slot and combines the ranks' softmax
statistics over the sharded slots (`_mesh_decode_attention`). Without a
mesh the path, its launches and its bits are the one-device ones. MoE and
MLA on a mesh are a later slice: they raise.

Not ported: MLA with a rolling cache (the JAX package asserts a sliding
window for one, and its absorbed decode writes slot ``pos``); it raises.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication, local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core.backend import Kernels, resolve_device, resolve_kernels
from repro_torch.launch.sharding import logical, mesh_matmul
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_rope,
    attention,
    blocked_decode_attention,
    combine_decode_blocks,
    decode_block_stats,
    glu_mlp,
    rms_norm,
)
from repro_torch.models.schema import (
    DTYPES,
    ParamDef,
    attach,
    default_generator,
    load_jax_params,
)


# ------------------------------------------------------------------ schema
def lm_schema(cfg: LMConfig) -> dict:
    """The JAX package's ``lm_schema``, as a nested dict of `ParamDef`s in
    its order, each with the reference's logical axes."""
    L, D, N, Nkv, H, F, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.vocab_size)
    dt = cfg.dtype
    sch: dict = {
        "embed": ParamDef((V, D), ("vocab", "embed"), "embed", dt),
        "norm_attn": ParamDef((L, D), ("layer", None), "zeros", "float32"),
        "norm_ffn": ParamDef((L, D), ("layer", None), "zeros", "float32"),
        "final_norm": ParamDef((D,), (None,), "zeros", "float32"),
    }
    if not cfg.tie_embeddings:
        sch["lm_head"] = ParamDef((D, V), ("embed", "vocab"), "lecun", dt)
    if cfg.mla is not None:
        sch["mla"] = mla_lib.mla_schema(cfg)
    else:
        attn = {
            "wq": ParamDef((L, D, N, H), ("layer", "fsdp", "heads", None), "lecun", dt),
            "wk": ParamDef((L, D, Nkv, H), ("layer", "fsdp", "kv_heads", None), "lecun", dt),
            "wv": ParamDef((L, D, Nkv, H), ("layer", "fsdp", "kv_heads", None), "lecun", dt),
            "wo": ParamDef((L, N, H, D), ("layer", "heads", None, "fsdp"), "lecun", dt),
        }
        if cfg.qkv_bias:
            attn["bq"] = ParamDef((L, N, H), ("layer", "heads", None), "zeros", dt)
            attn["bk"] = ParamDef((L, Nkv, H), ("layer", "kv_heads", None), "zeros", dt)
            attn["bv"] = ParamDef((L, Nkv, H), ("layer", "kv_heads", None), "zeros", dt)
        sch["attn"] = attn
    k = _first_moe(cfg)
    if k:
        fd = (cfg.moe.d_ff_dense or F) if cfg.moe is not None else F
        sch["ffn_dense"] = {
            "wi_gate": ParamDef((k, D, fd), ("layer", "fsdp", "mlp"), "lecun", dt),
            "wi_up": ParamDef((k, D, fd), ("layer", "fsdp", "mlp"), "lecun", dt),
            "wo": ParamDef((k, fd, D), ("layer", "mlp", "fsdp"), "lecun", dt),
        }
    if cfg.moe is not None:
        sch["moe"] = moe_lib.moe_schema(cfg.moe, L - k, D, dt)
    if cfg.mtp_depth > 0:
        sch["mtp"] = {
            "proj": ParamDef((2 * D, D), ("fsdp", "embed"), "lecun", dt),
            "norm": ParamDef((D,), (None,), "zeros", "float32"),
        }
    return sch


def _first_moe(cfg: LMConfig) -> int:
    """The first MoE layer: the dense prefix's length (all layers when the
    model has no MoE)."""
    return cfg.moe.first_k_dense if cfg.moe is not None else cfg.n_layers


# ------------------------------------------------------------------ decode
@dataclasses.dataclass
class DecodeCache:
    """Stacked caches. ``kind`` ``"gqa"``: ``data = (k, v)``, each ``(L, B,
    S_cap, Nkv, H)``; ``"mla"``: ``data = (c_kv (L, B, S_cap, kv_lora),
    k_rope (L, B, S_cap, d_rope))``. A ``rolling`` cache (GQA only) uses
    slot ``pos % s_cap`` (sliding-window archs)."""

    data: tuple
    kind: str
    s_cap: int
    rolling: bool


def _refuse_rolling_mla(cfg: LMConfig) -> None:
    raise NotImplementedError(f"{cfg.name}: MLA with a rolling cache is not ported")


CACHE_AXES = ("layer", "batch", "kv_seq", "kv_heads", None)


def grow_cache(cache: DecodeCache, s_cap: int) -> DecodeCache:
    """A prefill's cache grown to ``s_cap`` slots (the new ones empty), as
    ``serve_lm`` grows it. On a mesh the cache's slots must not be sharded
    yet (a prefill's are not); the grown cache is then placed by the active
    rules' `CACHE_AXES` — under the ``decode`` rules its slots shard over
    ``model``, a chunk each rank already holds: this is the one move of the
    cache from the prefill's placements to the decode's."""
    data = []
    for c in cache.data:
        L, B, S = c.shape[:3]
        if isinstance(c, DTensor):
            if any(isinstance(p, Shard) and p.dim == 2 for p in c.placements):
                raise ValueError("grow_cache: the cache's slots are already sharded")
            local = c.to_local()
            z = local.new_zeros((local.shape[0], local.shape[1], s_cap, *local.shape[3:]))
            z[:, :, :S] = local
            shape = (L, B, s_cap, *c.shape[3:])
            g = DTensor.from_local(z, c.device_mesh, c.placements, run_check=False,
                                   shape=torch.Size(shape),
                                   stride=torch.empty(shape, device="meta").stride())
            data.append(logical(g, *CACHE_AXES[:c.dim()]))
        else:
            z = c.new_zeros((L, B, s_cap, *c.shape[3:]))
            z[:, :, :S] = c
            data.append(z)
    return DecodeCache(tuple(data), cache.kind, s_cap, cache.rolling)


def place_cache(cache: DecodeCache) -> DecodeCache:
    """``cache`` (on a mesh) with its DTensors placed by the active rules'
    `CACHE_AXES`, written into ``cache.data``: a no-op once they are."""
    cache.data = tuple(logical(c, *CACHE_AXES[:c.dim()]) for c in cache.data)
    return cache


def init_cache(cfg: LMConfig, batch: int, s_cap: int, *, rolling: bool = False,
               device=None) -> DecodeCache:
    """An empty cache of ``s_cap`` slots (at most ``sliding_window`` when
    ``rolling``) on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    if rolling:
        if cfg.mla is not None:
            _refuse_rolling_mla(cfg)
        if cfg.sliding_window is None:
            raise ValueError(f"{cfg.name}: a rolling cache needs a sliding window")
        s_cap = min(s_cap, cfg.sliding_window)
    lead = (cfg.n_layers, batch, s_cap)
    if cfg.mla is not None:
        kind, shapes = "mla", (lead + (cfg.mla.kv_lora_rank,), lead + (cfg.mla.d_rope,))
    else:
        kind, shapes = "gqa", (lead + (cfg.n_kv_heads, cfg.d_head),) * 2
    dt = DTYPES[cfg.dtype]
    data = tuple(torch.zeros(sh, dtype=dt, device=dev) for sh in shapes)
    return DecodeCache(data, kind, s_cap, rolling)


# ------------------------------------------------------------------- model
class Transformer(nn.Module):
    """A decoder-only LM for serving and training, with the JAX package's
    parameters (they require grad once `schema.trainable` turns them on).

    ``device=None`` means the card (it raises without one; pass
    ``device="cpu"`` for the plain versions on the CPU). With ``mesh`` (a
    `DeviceMesh`) and ``rules`` (`launch.rules.make_rules`) every parameter
    is a `DTensor` placed by its schema axes under ``rules``, drawn whole
    one leaf at a time and kept as this rank's chunk (`schema.attach`): the
    same values as the one-device model's. ``kernels``
    (``"auto"`` | ``"torch"`` | ``"cuda"`` | a `Kernels`) resolves as in
    `repro_torch.core.backend.resolve_kernels`. Parameters are drawn from
    ``generator`` (a `torch.Generator` on ``device``; default: seed 0) with
    the JAX schema's init kinds and dtypes — the same distributions, other
    numbers.
    """

    def __init__(
        self,
        cfg: LMConfig,
        *,
        generator: torch.Generator | None = None,
        device=None,
        kernels: "str | Kernels" = "auto",
        mesh=None,
        rules: dict | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = default_generator(dev)
        if mesh is not None and (cfg.moe is not None or cfg.mla is not None):
            raise NotImplementedError(f"{cfg.name}: MoE and MLA on a mesh are not ported yet "
                                      "(ROADMAP.md, Queue 1 item 5: expert parallelism)")
        self.cfg = cfg
        self.mesh = mesh
        self.kernels = resolve_kernels(kernels, dev)
        attach(self, lm_schema(cfg), generator, dev, mesh=mesh, rules=rules)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def set_kernels(self, kernels: "str | Kernels") -> None:
        self.kernels = resolve_kernels(kernels, self.device)

    def scope(self):
        """The context every step of the model runs in: on a mesh, plain
        tensors (positions, masks, constants: the same on every rank) count
        as replicated DTensors; else nothing. A caller of `layer` on a mesh
        enters it."""
        return implicit_replication() if self.mesh is not None else contextlib.nullcontext()

    # -------------------------------------------------------------- pieces
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens (B, S)`` → the residual stream ``(B, S, D)``."""
        x = nn.functional.embedding(tokens, self.embed)
        if self.cfg.emb_scale:
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        return x

    def _qkv(self, l: int, h: torch.Tensor, positions: torch.Tensor):
        """Rotated q ``(B, S, N, H)`` and k ``(B, S, Nkv, H)``, and v."""
        cfg, p = self.cfg, self.attn
        B, S, D = h.shape
        h2 = h.reshape(B * S, D)
        q = mesh_matmul(h2, p["wq"][l].reshape(D, -1)).view(B, S, cfg.n_heads, cfg.d_head)
        k = mesh_matmul(h2, p["wk"][l].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.d_head)
        v = mesh_matmul(h2, p["wv"][l].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.d_head)
        if cfg.qkv_bias:
            q = q + p["bq"][l]
            k = k + p["bk"][l]
            v = v + p["bv"][l]
        return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v

    def _attn_out(self, l: int, o: torch.Tensor) -> torch.Tensor:
        """The GQA attention output ``o (B, S, N, H)`` projected to ``(B, S,
        D)``."""
        B, S = o.shape[:2]
        wo = self.attn["wo"][l]
        return mesh_matmul(o.reshape(B * S, -1), wo.reshape(-1, wo.shape[-1])).view(B, S, -1)

    def ffn(self, l: int, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``l``'s FFN on the normed stream ``h (B, S, D)`` and its
        auxiliary loss (serving drops it): the GLU MLP of a dense layer
        (aux 0), or `models.moe.moe_ffn` over the ``B·S`` tokens of a MoE
        layer."""
        cfg = self.cfg
        k = _first_moe(cfg)
        if l < k:
            f = self.ffn_dense
            out = glu_mlp(h, f["wi_gate"][l], f["wi_up"][l], f["wo"][l], cfg.act)
            return out, torch.zeros((), dtype=torch.float32, device=h.device)
        B, S, D = h.shape
        p = {name: w[l - k] for name, w in self.moe.items()}
        out, aux = moe_lib.moe_ffn(h.reshape(B * S, D), p, cfg.moe, cfg.act)
        return out.view(B, S, D), aux

    def _attention(self, l: int, x: torch.Tensor, positions: torch.Tensor):
        """Layer ``l``'s attention (through ``Kernels.flash_attention``) on
        the stream ``x``: ``(out (B, S, D), cache entries)``."""
        cfg = self.cfg
        h = rms_norm(x, self.norm_attn[l], cfg.norm_eps)
        if cfg.mla is not None:
            return mla_lib.mla_attention(self.mla, l, h, positions, cfg,
                                         self.kernels.flash_attention)
        q, k, v = self._qkv(l, h, positions)
        q = logical(q, "batch", "seq", "heads", None)
        k = logical(k, "batch", "seq", "kv_heads", None)
        o = self.kernels.flash_attention(
            q, k, v, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
        del q
        return self._attn_out(l, o), (k, v)

    def layer(self, l: int, x: torch.Tensor, positions: torch.Tensor):
        """Layer ``l`` over a whole sequence (its attention through
        ``Kernels.flash_attention``): ``(x, *cache)``, the residual stream
        after the layer and the layer's cache entries — rotated keys and
        values (GQA), or ``c_kv`` and ``k_rope`` (MLA)."""
        a, kv = self._attention(l, x, positions)
        x = x + logical(a, "batch", "seq", "embed")
        f = self.ffn(l, rms_norm(x, self.norm_ffn[l], self.cfg.norm_eps))[0]
        return x + logical(f, "batch", "seq", "embed"), *kv

    def train_layer(self, l: int, x: torch.Tensor, positions: torch.Tensor):
        """Layer ``l`` for training: ``(x, aux)``, the stream after the layer
        and its FFN's auxiliary loss; no cache."""
        a, _ = self._attention(l, x, positions)
        x = x + logical(a, "batch", "seq", "embed")
        out, aux = self.ffn(l, rms_norm(x, self.norm_ffn[l], self.cfg.norm_eps))
        return x + logical(out, "batch", "seq", "embed"), aux

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream ``(B, S, D)`` → logits ``(B, S, V)``."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return mesh_matmul(x, w)

    # ------------------------------------------------------------- forward
    def forward(self, tokens: torch.Tensor, collect_cache: bool = False):
        """Full-sequence forward (prefill): ``tokens (B, S)`` → ``(logits
        (B, S, V), cache or None)``, the cache entries stacked ``(L, B, S,
        …)`` (`DecodeCache`'s ``data``) when ``collect_cache``. On a mesh
        ``tokens`` and the results are DTensors."""
        with self.scope():
            return self._forward(tokens, collect_cache)

    def _forward(self, tokens: torch.Tensor, collect_cache: bool):
        cfg = self.cfg
        B, S = tokens.shape
        x = logical(self.embed_tokens(tokens), "batch", "seq", "embed")
        positions = torch.arange(S, device=x.device).expand(B, S)
        kv, layers = None, []
        for l in range(cfg.n_layers):
            x, *parts = self.layer(l, x, positions)
            if collect_cache and self.mesh is not None:
                layers.append(parts)  # DTensors: stacked once at the end
            elif collect_cache:
                if kv is None:
                    kv = tuple(torch.empty((cfg.n_layers, *t.shape), dtype=t.dtype,
                                           device=t.device) for t in parts)
                for c, t in zip(kv, parts):
                    c[l] = t
            del parts
        if layers:
            kv = tuple(torch.stack(ts) for ts in zip(*layers))
            del layers
        return logical(self.head(x), "batch", "seq", "vocab"), kv

    def forward_train(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The training forward: ``tokens (B, S)`` → ``(logits (B, S, V),
        aux)``, the MoE layers' auxiliary losses summed. With grad on and
        ``cfg.remat`` ``"block"`` or ``"full"``, each layer runs under
        `torch.utils.checkpoint` (``use_reentrant=False``): only its input
        is kept, and the backward runs the layer again (its attention
        kernel too). The JAX package's ``"block"`` policy keeps the
        matmuls' outputs as well; either way the gradients are the same
        function."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat in ("block", "full") and torch.is_grad_enabled()
        for l in range(cfg.n_layers):
            if remat:
                x, a = checkpoint(self.train_layer, l, x, positions, use_reentrant=False)
            else:
                x, a = self.train_layer(l, x, positions)
            aux = aux + a
        return self.head(x), aux

    def prefill(self, tokens: torch.Tensor):
        """Full forward + caches: ``(logits, DecodeCache)`` of ``S`` slots."""
        logits, kv = self.forward(tokens, collect_cache=True)
        kind = "mla" if self.cfg.mla is not None else "gqa"
        return logits, DecodeCache(kv, kind, tokens.shape[1], False)

    def decode_step(self, cache: DecodeCache, token: torch.Tensor, pos: int):
        """One token for the whole batch: ``token (B, 1)`` at position
        ``pos`` (the tokens already in the sequence) → ``(logits (B, 1, V),
        cache)``; the cache is written in place. On a mesh the cache's
        DTensors keep their placements (`grow_cache` places them)."""
        with self.scope():
            x = logical(self.embed_tokens(token), "batch", None, "embed")
            step = self._decode_plan(cache, token.shape[0], int(pos), x.device)
            for l in range(self.cfg.n_layers):
                x = self._decode_layer(l, x, cache, step)
            return self.head(x), cache

    def decode_layer(self, l: int, x: torch.Tensor, cache: DecodeCache, pos: int) -> torch.Tensor:
        """Layer ``l`` of a decode step at position ``pos`` on the stream ``x
        (B, 1, D)``: the stream after the layer; the layer's key and value
        are written into ``cache``. A check of a layer on a shared input
        calls it."""
        with self.scope():
            return self._decode_layer(l, x, cache,
                                      self._decode_plan(cache, x.shape[0], int(pos), x.device))

    def _decode_plan(self, cache: DecodeCache, B: int, pos: int, dev) -> dict:
        """What every layer of a decode step at ``pos`` shares: the query's
        position, the slot it writes, every slot's key position."""
        cfg = self.cfg
        S_cap = cache.s_cap
        if cache.rolling:
            if cfg.mla is not None:
                _refuse_rolling_mla(cfg)
            slot = pos % S_cap
            key_slots = torch.arange(S_cap, device=dev)
            key_pos = pos - torch.remainder(pos - key_slots, S_cap)  # < 0: an empty slot
        else:
            if not 0 <= pos < S_cap:
                raise ValueError(f"position {pos} is outside the cache's {S_cap} slots")
            slot = pos
            key_pos = torch.arange(S_cap, device=dev)
        return dict(pos=pos, slot=slot, key_pos=key_pos,
                    positions=torch.full((B, 1), pos, dtype=torch.int64, device=dev),
                    pos_q=torch.full((1,), pos, dtype=torch.int64, device=dev),
                    blocked=cfg.decode_kv_blocks > 1 and S_cap % cfg.decode_kv_blocks == 0)

    def _decode_layer(self, l: int, x: torch.Tensor, cache: DecodeCache, step: dict):
        cfg = self.cfg
        c0, c1 = cache.data
        slot, key_pos, pos_q = step["slot"], step["key_pos"], step["pos_q"]
        h = rms_norm(x, self.norm_attn[l], cfg.norm_eps)
        if cfg.mla is not None:
            a = mla_lib.mla_decode(self.mla, l, h, step["pos"], c0[l], c1[l], cfg)
        else:
            q, k, v = self._qkv(l, h, step["positions"])
            if isinstance(c0, DTensor):
                o = self._mesh_decode_attention(l, q, k, v, c0, c1, slot, pos_q, key_pos)
            else:
                c0[l, :, slot] = k[:, 0]
                c1[l, :, slot] = v[:, 0]
                if step["blocked"]:
                    o = blocked_decode_attention(
                        q, c0[l], c1[l], pos_q, key_pos, cfg.decode_kv_blocks,
                        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
                else:
                    o = attention(q, c0[l], c1[l], pos_q, key_pos,
                                  window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
            a = self._attn_out(l, o)
        x = x + a
        return x + self.ffn(l, rms_norm(x, self.norm_ffn[l], cfg.norm_eps))[0]

    def _mesh_decode_attention(self, l: int, q, k, v, c0: DTensor, c1: DTensor, slot: int,
                               pos_q: torch.Tensor, key_pos: torch.Tensor) -> DTensor:
        """Layer ``l``'s decode attention on a mesh whose cache ``(L, B,
        S_cap, Nkv, H)`` may shard its batch and its slots. Each rank writes
        the new key and value only where it owns ``slot``, scores its own
        slots with every query head (q replicated off the batch: a few KB),
        and returns its slots' softmax statistics as one block of
        `layers.decode_block_stats`; `layers.combine_decode_blocks` combines
        the blocks, the reductions over the sharded slots becoming
        collectives."""
        cfg, mesh, cpl = self.cfg, c0.device_mesh, tuple(c0.placements)
        if any(isinstance(p, Shard) and p.dim not in (1, 2) or not isinstance(p, (Shard, Replicate))
               for p in cpl):
            raise ValueError(f"decode on a mesh: cache placements {cpl} (only the batch and the "
                             "slots may be sharded)")
        row = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 1 else Replicate() for p in cpl)
        blocks = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 1 else
                       Shard(1) if isinstance(p, Shard) and p.dim == 2 else Replicate()
                       for p in cpl)
        q, k, v = (t.redistribute(mesh, row) for t in (q, k, v))
        s_lo = compute_local_shape_and_global_offset(c0.shape, mesh, cpl)[1][2]

        def body(q_l, k_l, v_l, c0_l, c1_l):
            B_l, n, Nkv, H = c0_l.shape[1:]
            if s_lo <= slot < s_lo + n:
                c0_l[l, :, slot - s_lo] = k_l[:, 0]
                c1_l[l, :, slot - s_lo] = v_l[:, 0]
            # this rank's slots are one block of `blocked_decode_attention`
            return decode_block_stats(
                q_l.reshape(B_l, Nkv, -1, H), c0_l[l].reshape(B_l, 1, n, Nkv, H),
                c1_l[l].reshape(B_l, 1, n, Nkv, -1), pos_q, key_pos[s_lo:s_lo + n][None],
                window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)

        m_b, l_b, acc_b = local_map(body, out_placements=(list(blocks),) * 3,
                                    in_placements=(row, row, row, cpl, cpl),
                                    device_mesh=mesh)(q, k, v, c0, c1)
        out = combine_decode_blocks(m_b, l_b, acc_b)
        B, Nq, Hv = q.shape[0], q.shape[2], v.shape[-1]
        return out.reshape(B, 1, Nq, Hv).to(q.dtype)


def loss_fn(cfg: LMConfig, model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux, + 1-depth MTP head when on), as
    the JAX package's ``loss_fn``: a float32 scalar."""
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")
    logits, aux = model.forward_train(tokens)
    tgt = tokens[:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    del logits
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    loss = torch.mean(nll) + aux
    if cfg.mtp_depth > 0:
        # 1-depth MTP (DSv3 §2.2, lightweight variant): combine the current
        # token's embedding with the next token's, project, share the head,
        # and predict token t+2.
        emb_next = nn.functional.embedding(tokens[:, 1:], model.embed)
        h = nn.functional.embedding(tokens[:, :-1], model.embed)
        cat = torch.cat([rms_norm(h, model.mtp["norm"], cfg.norm_eps), emb_next], dim=-1)
        h2 = cat @ model.mtp["proj"]
        head = model.embed.T if cfg.tie_embeddings else model.lm_head
        mtp_logits = h2[:, :-1] @ head
        lp2 = torch.log_softmax(mtp_logits.float(), dim=-1)
        nll2 = -torch.gather(lp2, -1, tokens[:, 2:].long()[..., None])[..., 0]
        loss = loss + 0.1 * torch.mean(nll2)
    return loss


def params_from_jax(
    cfg: LMConfig, params: dict, *, device=None, kernels: "str | Kernels" = "auto",
    mesh=None, rules: dict | None = None,
) -> Transformer:
    """A `Transformer` holding the JAX package's parameters: ``params`` is
    the nested dict that ``repro.models.transformer.init`` returns, as numpy
    arrays (bf16 leaves read through float32, which is exact). With
    ``mesh`` and ``rules`` each rank keeps its own chunk of every leaf."""
    model = Transformer(cfg, device=device, kernels=kernels, mesh=mesh, rules=rules)
    return load_jax_params(model, params)
