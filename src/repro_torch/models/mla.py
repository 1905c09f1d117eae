"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2405.04434 /
2412.19437) on PyTorch: the port of ``src/repro/models/mla.py``.

Queries are low-rank compressed (q_lora); keys and values share one latent
c_kv (kv_lora) plus a decoupled RoPE key (d_rope) shared by all heads. The
prefill (`mla_attention`) materialises per-head keys ``k_nope ‖ k_rope``
and values from the latent and runs ``Kernels.flash_attention`` on them
(q/k head dim ``d_nope + d_rope``, v head dim ``d_v``, one kv head a query
head). Decode (`mla_decode`) is the absorbed formulation, in plain
PyTorch: scores and values in latent space, so the cache holds ``kv_lora +
d_rope`` a token.

``p`` is the model's ``mla`` parameter group (each leaf ``(L, …)``) and
``l`` the layer: a layer's weights are ``p[name][l]``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.schema import ParamDef


def mla_schema(cfg: LMConfig) -> dict:
    """The JAX package's ``mla_schema``: `ParamDef` leaves in its order,
    with its logical axes."""
    m = cfg.mla
    L, D, N = cfg.n_layers, cfg.d_model, cfg.n_heads
    dt = cfg.dtype
    return {
        "wq_a": ParamDef((L, D, m.q_lora_rank), ("layer", "fsdp", "lora"), "lecun", dt),
        "q_norm": ParamDef((L, m.q_lora_rank), ("layer", None), "zeros", "float32"),
        "wq_b": ParamDef((L, m.q_lora_rank, N, m.d_nope + m.d_rope),
                         ("layer", "lora", "heads", None), "lecun", dt),
        "wkv_a": ParamDef((L, D, m.kv_lora_rank + m.d_rope), ("layer", "fsdp", None), "lecun", dt),
        "kv_norm": ParamDef((L, m.kv_lora_rank), ("layer", None), "zeros", "float32"),
        "wk_b": ParamDef((L, m.kv_lora_rank, N, m.d_nope), ("layer", "lora", "heads", None),
                         "lecun", dt),
        "wv_b": ParamDef((L, m.kv_lora_rank, N, m.d_v), ("layer", "lora", "heads", None),
                         "lecun", dt),
        "wo": ParamDef((L, N, m.d_v, D), ("layer", "heads", None, "fsdp"), "lecun", dt),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (B, S, r) · w (r, N, h)`` → ``(B, S, N, h)``."""
    B, S, r = x.shape
    return (x.reshape(B * S, r) @ w.reshape(r, -1)).view(B, S, *w.shape[1:])


def _project_q(p, l: int, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    m = cfg.mla
    q_lat = rms_norm(x @ p["wq_a"][l], p["q_norm"][l], cfg.norm_eps)
    q = _heads(q_lat, p["wq_b"][l])  # (B, S, N, dn + dr)
    return q[..., :m.d_nope], apply_rope(q[..., m.d_nope:], positions, cfg.rope_theta)


def _project_kv_latent(p, l: int, x: torch.Tensor, cfg: LMConfig, positions: torch.Tensor):
    m = cfg.mla
    kv = x @ p["wkv_a"][l]  # (B, S, kv_lora + dr)
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"][l], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _scale(cfg: LMConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.d_nope + cfg.mla.d_rope)


def mla_attention(p, l: int, x: torch.Tensor, positions: torch.Tensor, cfg: LMConfig,
                  flash_attention):
    """Prefill: ``x (B, S, D)`` at ``positions (B, S)`` → ``(out (B, S,
    D), (c_kv (B, S, kv_lora), k_rope (B, S, d_rope)))``. The attention is
    ``flash_attention(q_eff, k_eff, v, scale=(d_nope + d_rope) ** -0.5)``
    (causal, no window), with ``k_rope`` broadcast to all N heads."""
    m = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope = _project_q(p, l, x, cfg, positions)
    c_kv, k_rope = _project_kv_latent(p, l, x, cfg, positions)
    k_nope = _heads(c_kv, p["wk_b"][l])
    v = _heads(c_kv, p["wv_b"][l])
    N = cfg.n_heads
    q_eff = torch.cat([q_nope, q_rope], dim=-1)
    del q_nope, q_rope
    k_eff = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, N, m.d_rope)], dim=-1)
    del k_nope
    out = flash_attention(q_eff, k_eff, v, scale=_scale(cfg))
    del q_eff, k_eff, v
    wo = p["wo"][l]
    return (out.reshape(B * S, -1) @ wo.reshape(-1, wo.shape[-1])).view(B, S, -1), (c_kv, k_rope)


def mla_decode(p, l: int, x: torch.Tensor, pos: int, cache_ckv: torch.Tensor,
               cache_kr: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Absorbed decode, O(S · (kv_lora + d_rope)) a step: ``x (B, 1, D)``
    at position ``pos`` (its slot; the cache is not rolling) →
    ``(B, 1, D)``. The step's latent and RoPE key are written into
    ``cache_ckv (B, S_cap, kv_lora)`` and ``cache_kr (B, S_cap, d_rope)``
    in place; logits in float32 over the slots ``<= pos``."""
    B = x.shape[0]
    S_cap = cache_ckv.shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _project_q(p, l, x, cfg, positions)      # (B, 1, N, ·)
    c_kv_new, k_rope_new = _project_kv_latent(p, l, x, cfg, positions)
    cache_ckv[:, pos] = c_kv_new[:, 0]
    cache_kr[:, pos] = k_rope_new[:, 0]

    # absorb: q_eff[b, n, l] = q_nope · wk_b — scores in latent space
    q_eff = torch.einsum("bqnh,lnh->bqnl", q_nope, p["wk_b"][l])  # (B, 1, N, kv_lora)
    ckv = cache_ckv.float()
    logits = (torch.einsum("bqnl,bsl->bnqs", q_eff.float(), ckv)
              + torch.einsum("bqnh,bsh->bnqs", q_rope.float(), cache_kr.float())) * _scale(cfg)
    valid = torch.arange(S_cap, device=x.device) <= pos
    probs = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    o_lat = torch.einsum("bnqs,bsl->bqnl", probs, ckv)
    out = torch.einsum("bqnl,lnh->bqnh", o_lat.to(x.dtype), p["wv_b"][l])
    return torch.einsum("bqnh,nhd->bqd", out, p["wo"][l])
