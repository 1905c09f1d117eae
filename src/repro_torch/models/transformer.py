"""Decoder-only LM on PyTorch, dense GQA/MQA: the port of
``src/repro/models/transformer.py`` for serving (prefill and decode).

`Transformer` keeps the JAX package's parameter layout and names
(`lm_schema`): ``embed (V, D)``, ``norm_attn``/``norm_ffn (L, D)`` and
``final_norm (D,)`` in float32, ``attn.{wq (L, D, N, H), wk, wv (L, D, Nkv,
H), wo (L, N, H, D)}`` (+ ``bq``/``bk``/``bv`` with QKV bias),
``ffn_dense.{wi_gate, wi_up (L, D, F), wo (L, F, D)}`` and ``lm_head`` when
the embeddings are not tied, every leaf in its schema dtype; so
`params_from_jax` carries the JAX package's weights over one to one. A
Python loop over layers takes the place of ``lax.scan``.

Every prefill attention (`Transformer.forward`) goes through
``Kernels.flash_attention`` — the hand-written CUDA kernel on the card
(``csrc/flash_attention.cu``), the plain version on the CPU. Decode
(`Transformer.decode_step`, one query against the cache) runs
`layers.attention`, or `layers.blocked_decode_attention` when
``decode_kv_blocks > 1``, as the JAX package does. The decode cache is
updated in place (the JAX package returns a new one): the returned
`DecodeCache` holds the same tensors.

Not ported yet: the MoE and MLA LM families (their layers and the MTP head)
and training (``loss_fn``); a config with ``moe`` or ``mla`` raises.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.core.backend import Kernels, resolve_device, resolve_kernels
from repro_torch.models.layers import (
    apply_rope,
    attention,
    blocked_decode_attention,
    glu_mlp,
    rms_norm,
)
from repro_torch.models.schema import DTYPES, attach, load_jax_params


def _dense_only(cfg: LMConfig) -> None:
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA/MQA LMs only; the MoE and MLA LM "
            "families are not ported yet")


# ------------------------------------------------------------------ schema
def lm_schema(cfg: LMConfig) -> dict:
    """The JAX package's ``lm_schema`` for a dense config, as a nested dict
    of ``(shape, init kind, dtype)`` leaves in its order."""
    _dense_only(cfg)
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
    sch["ffn_dense"] = {
        "wi_gate": ((L, D, F), "lecun", dt),
        "wi_up": ((L, D, F), "lecun", dt),
        "wo": ((L, F, D), "lecun", dt),
    }
    return sch


# ------------------------------------------------------------------ decode
@dataclasses.dataclass
class DecodeCache:
    """Stacked caches: ``data = (k, v)``, each ``(L, B, S_cap, Nkv, H)``.
    A ``rolling`` cache uses slot ``pos % s_cap`` (sliding-window archs)."""

    data: tuple
    kind: str
    s_cap: int
    rolling: bool


def init_cache(cfg: LMConfig, batch: int, s_cap: int, *, rolling: bool = False,
               device=None) -> DecodeCache:
    """An empty cache of ``s_cap`` slots (at most ``sliding_window`` when
    ``rolling``) on ``device`` (``None``: the card)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if rolling:
        if cfg.sliding_window is None:
            raise ValueError(f"{cfg.name}: a rolling cache needs a sliding window")
        s_cap = min(s_cap, cfg.sliding_window)
    shape = (cfg.n_layers, batch, s_cap, cfg.n_kv_heads, cfg.d_head)
    dt = DTYPES[cfg.dtype]
    data = (torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev))
    return DecodeCache(data, "gqa", s_cap, rolling)


# ------------------------------------------------------------------- model
class Transformer(nn.Module):
    """A dense decoder-only LM for serving, with the JAX package's
    parameters.

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
        _dense_only(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
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

    def _out_and_ffn(self, l: int, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """The residual stream after attention output ``o (B, S, N, H)`` and
        the layer's GLU MLP."""
        cfg = self.cfg
        B, S, D = x.shape
        wo = self.attn["wo"][l].reshape(-1, D)
        x = x + (o.reshape(B * S, -1) @ wo).view(B, S, D)
        h2 = rms_norm(x, self.norm_ffn[l], cfg.norm_eps)
        f = self.ffn_dense
        return x + glu_mlp(h2, f["wi_gate"][l], f["wi_up"][l], f["wo"][l], cfg.act)

    def layer(self, l: int, x: torch.Tensor, positions: torch.Tensor):
        """Layer ``l`` over a whole sequence (its attention through
        ``Kernels.flash_attention``): ``(x, k, v)``, the residual stream
        after the layer and the layer's rotated keys and values."""
        cfg = self.cfg
        q, k, v = self._qkv(l, rms_norm(x, self.norm_attn[l], cfg.norm_eps), positions)
        o = self.kernels.flash_attention(
            q, k, v, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
        del q
        return self._out_and_ffn(l, x, o), k, v

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream ``(B, S, D)`` → logits ``(B, S, V)``."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w

    # ------------------------------------------------------------- forward
    def forward(self, tokens: torch.Tensor, collect_cache: bool = False):
        """Full-sequence forward (prefill): ``tokens (B, S)`` → ``(logits
        (B, S, V), (k, v) or None)``, the caches stacked ``(L, B, S, Nkv,
        H)`` when ``collect_cache``."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self.embed_tokens(tokens)
        positions = torch.arange(S, device=x.device).expand(B, S)
        kv = None
        if collect_cache:
            shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
            kv = (torch.empty(shape, dtype=x.dtype, device=x.device),
                  torch.empty(shape, dtype=x.dtype, device=x.device))
        for l in range(cfg.n_layers):
            x, k, v = self.layer(l, x, positions)
            if kv is not None:
                kv[0][l] = k
                kv[1][l] = v
        return self.head(x), kv

    def prefill(self, tokens: torch.Tensor):
        """Full forward + caches: ``(logits, DecodeCache)`` of ``S`` slots."""
        logits, kv = self.forward(tokens, collect_cache=True)
        return logits, DecodeCache(kv, "gqa", tokens.shape[1], False)

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
        ck_all, cv_all = cache.data
        for l in range(cfg.n_layers):
            h = rms_norm(x, self.norm_attn[l], cfg.norm_eps)
            q, k, v = self._qkv(l, h, positions)
            ck_all[l, :, slot] = k[:, 0]
            cv_all[l, :, slot] = v[:, 0]
            if blocked:
                o = blocked_decode_attention(
                    q, ck_all[l], cv_all[l], pos_q, key_pos, cfg.decode_kv_blocks,
                    window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
            else:
                o = attention(q, ck_all[l], cv_all[l], pos_q, key_pos,
                              window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
            x = self._out_and_ffn(l, x, o)
        return self.head(x), cache


def params_from_jax(
    cfg: LMConfig, params: dict, *, device=None, kernels: "str | Kernels" = "auto"
) -> Transformer:
    """A `Transformer` holding the JAX package's parameters: ``params`` is
    the nested dict that ``repro.models.transformer.init`` returns, as numpy
    arrays (bf16 leaves read through float32, which is exact)."""
    return load_jax_params(Transformer(cfg, device=device, kernels=kernels), params)
