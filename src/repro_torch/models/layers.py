"""Transformer layers on PyTorch: the port of ``src/repro/models/layers.py``.

Conventions, as there: activations in the config's dtype, softmax and norm
statistics in float32, KV caches ``(B, S_cap, Nkv, H)``, masks built from
positions (``pos_k < 0`` marks an empty cache slot). `attention` is plain
PyTorch — naive up to ``_NAIVE_LIMIT`` logits, an online-softmax loop over
chunks above it — and serves decode (``Sq = 1``); the LM prefill runs its
attention through ``Kernels.flash_attention`` instead
(`repro_torch.models.transformer`). The JAX package's ``maybe_scan`` and
``unrolled_model`` have no counterpart: a Python loop runs the layers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import logical, mesh_matmul

_NAIVE_LIMIT = 2048 * 2048  # Sq*Skv above this → chunked path


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * (1.0 + scale.to(dt))


# ------------------------------------------------------------------- RoPE
def rope_freqs(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, N, H); positions: (..., S). Llama convention (half split)."""
    H = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(H, theta), dtype=torch.float32, device=x.device)
    ang = positions[..., None].float() * freqs  # (..., S, H/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def _tile_mask(pos_q: torch.Tensor, pos_k: torch.Tensor, window: int | None) -> torch.Tensor:
    """(.., Sq, Skv) bool from positions; pos_k < 0 marks invalid slots."""
    ok = (pos_k[..., None, :] <= pos_q[..., :, None]) & (pos_k[..., None, :] >= 0)
    if window is not None:
        ok &= pos_k[..., None, :] > pos_q[..., :, None] - window
    return ok


def _logits_tile(qg, k, scale, softcap):
    # qg: (B, Sq, Nkv, G, H); k: (B, Skv, Nkv, H) → (B, Nkv, G, Sq, Skv) f32
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    logits = logits * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def attention(
    q: torch.Tensor,       # (B, Sq, Nq, H)
    k: torch.Tensor,       # (B, Skv, Nkv, H)
    v: torch.Tensor,       # (B, Skv, Nkv, Hv)
    pos_q: torch.Tensor,   # (Sq,) int query positions
    pos_k: torch.Tensor,   # (Skv,) int key positions (-1 = invalid slot)
    *,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
    q_chunk: int = 1024,
    kv_chunk: int = 2048,
) -> torch.Tensor:
    """Grouped-query attention, causal with an optional sliding window.
    Runs an online-softmax loop over chunks for long sequences."""
    B, Sq, Nq, H = q.shape
    Skv, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    Hv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(H)
    qg = q.reshape(B, Sq, Nkv, G, H)

    if Sq * Skv <= _NAIVE_LIMIT:
        logits = _logits_tile(qg, k, scale, softcap)
        mask = _tile_mask(pos_q, pos_k, window)  # (Sq, Skv)
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
        return out.reshape(B, Sq, Nq, Hv).to(q.dtype)

    # ---------------- chunked (flash-style) path ---------------------------
    qc = min(q_chunk, Sq)
    while Sq % qc:
        qc //= 2
    kc = min(kv_chunk, Skv)
    while Skv % kc:
        kc //= 2
    out = torch.empty((B, Sq, Nkv, G, Hv), dtype=torch.float32, device=q.device)
    for i in range(0, Sq, qc):
        qb, pq = qg[:, i:i + qc], pos_q[i:i + qc]
        m = torch.full((B, Nkv, G, qc), -torch.inf, device=q.device)
        l = torch.zeros((B, Nkv, G, qc), device=q.device)
        acc = torch.zeros((B, Nkv, G, qc, Hv), device=q.device)
        for j in range(0, Skv, kc):
            logits = _logits_tile(qb, k[:, j:j + kc], scale, softcap)  # (B,Nkv,G,qc,kc)
            mask = _tile_mask(pq, pos_k[j:j + kc], window)
            logits = torch.where(mask, logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p, v[:, j:j + kc].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, i:i + qc] = (acc / torch.clamp(l[..., None], min=1e-30)).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Nq, Hv).to(q.dtype)


def blocked_decode_attention(
    q: torch.Tensor,        # (B, 1, Nq, H)
    k_cache: torch.Tensor,  # (B, S, Nkv, H)
    v_cache: torch.Tensor,
    pos_q: torch.Tensor,    # (1,)
    pos_k: torch.Tensor,    # (S,)
    n_blocks: int,
    *,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash-decoding (split-KV) for one-token decode: per-block softmax
    stats (m, l, acc) computed block-locally (`decode_block_stats`), then
    combined across blocks (`combine_decode_blocks`)."""
    B, S, Nkv, H = k_cache.shape
    Nq = q.shape[2]
    G = Nq // Nkv
    Hv = v_cache.shape[-1]
    Sb = S // n_blocks

    kb = logical(k_cache.reshape(B, n_blocks, Sb, Nkv, H),
                 "batch", "kv_block", None, "kv_heads", None)
    vb = logical(v_cache.reshape(B, n_blocks, Sb, Nkv, Hv),
                 "batch", "kv_block", None, "kv_heads", None)
    pos_kb = pos_k.reshape(n_blocks, Sb)
    # replicate q across the model axis so every shard scores its own KV
    # blocks locally — resharding activations, never weights
    qg = logical(q.reshape(B, Nkv, G, H), "batch", None, None, None)
    m_b, l_b, acc_b = decode_block_stats(qg, kb, vb, pos_q, pos_kb, window=window,
                                         softcap=softcap, scale=scale)
    out = combine_decode_blocks(m_b, l_b, acc_b)
    return out.reshape(B, 1, Nq, Hv).to(q.dtype)


def decode_block_stats(
    qg: torch.Tensor,      # (B, Nkv, G, H)
    kb: torch.Tensor,      # (B, nb, Sb, Nkv, H)
    vb: torch.Tensor,      # (B, nb, Sb, Nkv, Hv)
    pos_q: torch.Tensor,   # (1,)
    pos_kb: torch.Tensor,  # (nb, Sb); < 0: an empty slot
    *,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each KV block's softmax statistics for a one-token decode: ``(m (B,
    nb, Nkv, G), l (B, nb, Nkv, G), acc (B, nb, Nkv, G, Hv))``, in
    float32."""
    scale = scale if scale is not None else 1.0 / np.sqrt(kb.shape[-1])
    logits = torch.einsum("bkgh,bnskh->bnkgs", qg.float(), kb.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    ok = (pos_kb <= pos_q[0]) & (pos_kb >= 0)
    if window is not None:
        ok &= pos_kb > pos_q[0] - window
    logits = torch.where(ok[None, :, None, None, :], logits, -1e30)
    logits = logical(logits, "batch", "kv_block", "kv_heads", None, None)

    m_b = logits.amax(dim=-1)                           # (B, nb, Nkv, G)
    p = torch.exp(logits - m_b[..., None])
    l_b = p.sum(dim=-1)
    acc_b = torch.einsum("bnkgs,bnskh->bnkgh", p, vb.float())
    return m_b, l_b, acc_b


def combine_decode_blocks(m_b: torch.Tensor, l_b: torch.Tensor, acc_b: torch.Tensor) -> torch.Tensor:
    """`decode_block_stats`' blocks (dim 1) combined: the attention output
    ``(B, Nkv, G, Hv)`` in float32. On `DTensor`s sharded over the blocks
    the reductions are collectives."""
    m = m_b.amax(dim=1)                                 # (B, Nkv, G)
    corr = torch.exp(m_b - m[:, None])
    l = (l_b * corr).sum(dim=1)
    acc = (acc_b * corr[..., None]).sum(dim=1)
    return acc / torch.clamp(l[..., None], min=1e-30)


def causal_mask(q_len: int, kv_len: int, *, window: int | None = None) -> torch.Tensor:
    """Additive small-scale mask (tests / reference only)."""
    qi = torch.arange(q_len)[:, None] + (kv_len - q_len)
    kj = torch.arange(kv_len)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, -1e30).float()


# ------------------------------------------------------------------- MLPs
def glu_mlp(x: torch.Tensor, wi_gate, wi_up, wo, act: str) -> torch.Tensor:
    g = mesh_matmul(x, wi_gate)
    u = mesh_matmul(x, wi_up)
    if act == "swiglu":
        h = F.silu(g).mul_(u)
    elif act == "geglu":
        h = F.gelu(g, approximate="tanh").mul_(u)
    else:
        raise ValueError(act)
    del g, u
    h = logical(h, "batch", "seq", "mlp")
    return mesh_matmul(h, wo)
