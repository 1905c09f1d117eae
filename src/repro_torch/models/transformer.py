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

Not ported: MLA with a rolling cache (the JAX package asserts a sliding
window for one, and its absorbed decode writes slot ``pos``); it raises.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core.backend import Kernels, resolve_device, resolve_kernels
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    apply_rope,
    attention,
    blocked_decode_attention,
    glu_mlp,
    rms_norm,
)
from repro_torch.models.schema import DTYPES, attach, default_generator, load_jax_params


# ------------------------------------------------------------------ schema
def lm_schema(cfg: LMConfig) -> dict:
    """The JAX package's ``lm_schema``, as a nested dict of ``(shape, init
    kind, dtype)`` leaves in its order."""
    L, D, N, Nkv, H, F, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff, cfg.vocab_size)
    dt = cfg.dtype
    sch: dict = {
        "embed": ((V, D), "embed", dt),
        "norm_attn": ((L, D), "zeros", "float32"),
        "norm_ffn": ((L, D), "zeros", "float32"),
        "final_norm": ((D,), "zeros", "float32"),
    }
    if not cfg.tie_embeddings:
        sch["lm_head"] = ((D, V), "lecun", dt)
    if cfg.mla is not None:
        sch["mla"] = mla_lib.mla_schema(cfg)
    else:
        attn = {
            "wq": ((L, D, N, H), "lecun", dt),
            "wk": ((L, D, Nkv, H), "lecun", dt),
            "wv": ((L, D, Nkv, H), "lecun", dt),
            "wo": ((L, N, H, D), "lecun", dt),
        }
        if cfg.qkv_bias:
            attn["bq"] = ((L, N, H), "zeros", dt)
            attn["bk"] = ((L, Nkv, H), "zeros", dt)
            attn["bv"] = ((L, Nkv, H), "zeros", dt)
        sch["attn"] = attn
    k = _first_moe(cfg)
    if k:
        fd = (cfg.moe.d_ff_dense or F) if cfg.moe is not None else F
        sch["ffn_dense"] = {
            "wi_gate": ((k, D, fd), "lecun", dt),
            "wi_up": ((k, D, fd), "lecun", dt),
            "wo": ((k, fd, D), "lecun", dt),
        }
    if cfg.moe is not None:
        sch["moe"] = moe_lib.moe_schema(cfg.moe, L - k, D, dt)
    if cfg.mtp_depth > 0:
        sch["mtp"] = {
            "proj": ((2 * D, D), "lecun", dt),
            "norm": ((D,), "zeros", "float32"),
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
    ``device="cpu"`` for the plain versions on the CPU). ``kernels``
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
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = default_generator(dev)
        self.cfg = cfg
        self.kernels = resolve_kernels(kernels, dev)
        attach(self, lm_schema(cfg), generator, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def set_kernels(self, kernels: "str | Kernels") -> None:
        self.kernels = resolve_kernels(kernels, self.device)

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
        q = (h2 @ p["wq"][l].reshape(D, -1)).view(B, S, cfg.n_heads, cfg.d_head)
        k = (h2 @ p["wk"][l].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.d_head)
        v = (h2 @ p["wv"][l].reshape(D, -1)).view(B, S, cfg.n_kv_heads, cfg.d_head)
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
        return (o.reshape(B * S, -1) @ wo.reshape(-1, wo.shape[-1])).view(B, S, -1)

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
        x = x + a
        return x + self.ffn(l, rms_norm(x, self.norm_ffn[l], self.cfg.norm_eps))[0], *kv

    def train_layer(self, l: int, x: torch.Tensor, positions: torch.Tensor):
        """Layer ``l`` for training: ``(x, aux)``, the stream after the layer
        and its FFN's auxiliary loss; no cache."""
        a, _ = self._attention(l, x, positions)
        x = x + a
        out, aux = self.ffn(l, rms_norm(x, self.norm_ffn[l], self.cfg.norm_eps))
        return x + out, aux

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream ``(B, S, D)`` → logits ``(B, S, V)``."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w

    # ------------------------------------------------------------- forward
    def forward(self, tokens: torch.Tensor, collect_cache: bool = False):
        """Full-sequence forward (prefill): ``tokens (B, S)`` → ``(logits
        (B, S, V), cache or None)``, the cache entries stacked ``(L, B, S,
        …)`` (`DecodeCache`'s ``data``) when ``collect_cache``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=x.device).expand(B, S)
        kv = None
        for l in range(cfg.n_layers):
            x, *parts = self.layer(l, x, positions)
            if collect_cache:
                if kv is None:
                    kv = tuple(torch.empty((cfg.n_layers, *t.shape), dtype=t.dtype,
                                           device=t.device) for t in parts)
                for c, t in zip(kv, parts):
                    c[l] = t
            del parts
        return self.head(x), kv

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
        cache)``; the cache is written in place."""
        cfg = self.cfg
        B = token.shape[0]
        pos = int(pos)
        x = self.embed_tokens(token)
        dev = x.device
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=dev)
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
        pos_q = torch.full((1,), pos, dtype=torch.int64, device=dev)
        blocked = cfg.decode_kv_blocks > 1 and S_cap % cfg.decode_kv_blocks == 0
        c0, c1 = cache.data
        for l in range(cfg.n_layers):
            h = rms_norm(x, self.norm_attn[l], cfg.norm_eps)
            if cfg.mla is not None:
                a = mla_lib.mla_decode(self.mla, l, h, pos, c0[l], c1[l], cfg)
            else:
                q, k, v = self._qkv(l, h, positions)
                c0[l, :, slot] = k[:, 0]
                c1[l, :, slot] = v[:, 0]
                if blocked:
                    o = blocked_decode_attention(
                        q, c0[l], c1[l], pos_q, key_pos, cfg.decode_kv_blocks,
                        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
                else:
                    o = attention(q, c0[l], c1[l], pos_q, key_pos,
                                  window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
                a = self._attn_out(l, o)
            x = x + a
            x = x + self.ffn(l, rms_norm(x, self.norm_ffn[l], cfg.norm_eps))[0]
        return self.head(x), cache


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
    cfg: LMConfig, params: dict, *, device=None, kernels: "str | Kernels" = "auto"
) -> Transformer:
    """A `Transformer` holding the JAX package's parameters: ``params`` is
    the nested dict that ``repro.models.transformer.init`` returns, as numpy
    arrays (bf16 leaves read through float32, which is exact)."""
    return load_jax_params(Transformer(cfg, device=device, kernels=kernels), params)
