"""Mixture-of-Experts FFN on PyTorch, with static-shape sort-based dispatch:
the port of ``src/repro/models/moe.py``.

Routing variants:
  * softmax top-k, renormalised over the chosen experts  (Mixtral)
  * sigmoid scores + aux-loss-free bias balancing + group-limited top-k,
    normalised over the chosen                            (DeepSeek-V3)

Dispatch, as there: flatten the (token, k) assignments, sort them by expert
id (a stable sort: which assignments an expert past its capacity drops
depends on that order), pack each expert's tokens into a capacity-bounded
``(E, C, D)`` buffer (dropped assignments fall back to the residual path),
run the expert GEMMs batched over E (`torch.bmm`), and add each token's
kept contributions back with its combine weights. Routing, dispatch and
combine are plain PyTorch: the JAX package runs them in jnp, outside any
kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.schema import ParamDef


def moe_schema(cfg: MoEConfig, n_layers: int, d_model: int, dtype: str) -> dict:
    """The JAX package's ``moe_schema``: `ParamDef` leaves in its order,
    with its logical axes."""
    e, f, L = cfg.n_experts, cfg.d_ff_expert, n_layers
    sch = {
        "router": ParamDef((L, d_model, e), ("layer", "embed", "expert"), "lecun", "float32"),
        "wi_gate": ParamDef((L, e, d_model, f), ("layer", "expert", "fsdp", "expert_mlp"),
                            "lecun", dtype),
        "wi_up": ParamDef((L, e, d_model, f), ("layer", "expert", "fsdp", "expert_mlp"),
                          "lecun", dtype),
        "wo": ParamDef((L, e, f, d_model), ("layer", "expert", "expert_mlp", "fsdp"), "lecun",
                       dtype),
    }
    if cfg.router_bias_balancing:
        sch["router_bias"] = ParamDef((L, e), ("layer", "expert"), "zeros", "float32")
    if cfg.n_shared:
        fs = f * cfg.n_shared
        sch["shared_wi_gate"] = ParamDef((L, d_model, fs), ("layer", "fsdp", "mlp"), "lecun", dtype)
        sch["shared_wi_up"] = ParamDef((L, d_model, fs), ("layer", "fsdp", "mlp"), "lecun", dtype)
        sch["shared_wo"] = ParamDef((L, fs, d_model), ("layer", "mlp", "fsdp"), "lecun", dtype)
    return sch


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Rows an expert takes from ``tokens`` tokens: the capacity-factor
    bound, in the JAX package's host float arithmetic, with its no-drop
    floor for small batches (``C >= tokens`` when ``tokens <= 64``, so a
    decode step drops nothing)."""
    return max(1, int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)),
               min(tokens, 64))


def route(x: torch.Tensor, w_router: torch.Tensor, bias: torch.Tensor | None,
          cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x (T, D)`` → ``(expert_idx (T, K) int32, combine_weights (T, K)
    float32, aux_loss ())``. Logits in float32. ``torch.topk`` takes the
    place of ``lax.top_k`` (values in descending order). The sigmoid
    router's weights are the chosen experts' scores without the bias."""
    logits = x.float() @ w_router.float()  # (T, E)
    if cfg.router == "softmax":
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
        w = w / w.sum(dim=-1, keepdim=True)
    elif cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + bias[None, :] if bias is not None else scores
        if cfg.n_groups > 1:
            T = x.shape[0]
            g = sel.reshape(T, cfg.n_groups, -1)
            # group score = sum of the top-2 affinities in the group (DSv3)
            g2 = torch.topk(g, 2, dim=-1).values.sum(dim=-1)  # (T, G)
            gidx = torch.topk(g2, cfg.top_groups, dim=-1).indices
            gmask = torch.zeros_like(g2).scatter_(1, gidx, 1.0)
            keep = torch.repeat_interleave(gmask, sel.shape[-1] // cfg.n_groups, dim=-1) > 0
            sel = torch.where(keep, sel, -torch.inf)
        idx = torch.topk(sel, cfg.top_k, dim=-1).indices
        w = torch.gather(scores, 1, idx)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        raise ValueError(cfg.router)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.aux_loss_weight > 0:
        # Switch-style load-balance loss
        E = logits.shape[-1]
        probs = torch.softmax(logits, dim=-1)
        hot = torch.zeros_like(probs).scatter_add_(1, idx, torch.ones_like(idx, dtype=probs.dtype))
        aux = cfg.aux_loss_weight * E * torch.sum(hot.mean(dim=0) * probs.mean(dim=0))
    return idx.to(torch.int32), w.float(), aux


def _gate(g: torch.Tensor, act: str) -> torch.Tensor:
    # the JAX package's ``silu if swiglu else gelu`` (tanh approximation)
    return F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")


def assignment_slots(idx: torch.Tensor, n_experts: int, C: int) -> torch.Tensor:
    """``idx (G, Tg, K)``, each group's expert ids → ``(G, Tg·K)``: the
    dispatch buffer's row of each (token, k) assignment, in ``(t, k)``
    order. A group's assignments are sorted by expert id, stably (ties keep
    ``(t, k)`` order, as ``jnp.argsort`` does); an assignment's rank is its
    place among its expert's. Rank ``r < C`` goes to row ``e·G·C + g·C +
    r``; every other one to row ``E·G·C``, the drop row."""
    G, Tg, K = idx.shape
    E = n_experts
    flat_e = idx.reshape(G, Tg * K).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(se, torch.arange(E, device=idx.device).expand(G, E).contiguous())
    rank = torch.arange(Tg * K, device=idx.device) - torch.gather(first, 1, se)
    group = torch.arange(G, device=idx.device)[:, None]
    slot = torch.where(rank < C, se * (G * C) + group * C + rank, E * G * C)
    return torch.empty_like(slot).scatter_(1, order, slot)


def moe_ffn(x: torch.Tensor, p, cfg: MoEConfig, act: str = "swiglu"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (T, D)`` and one layer's parameters ``p`` (``moe_schema``'s
    leaves at that layer) → ``(out (T, D), aux_loss)``.

    With ``dispatch_groups = G > 1`` dividing T, the JAX package's grouped
    dispatch (``_moe_ffn_grouped``): the tokens split into G groups of
    ``T/G``, each routed, sorted and dropped at its own capacity. Else one
    group of all T (``_moe_ffn_global``). Either way one ``(E, G·C, D)``
    buffer feeds one batched GEMM an expert weight.

    The buffer: a kept assignment (rank ``r < C`` within its expert in its
    group's sorted order) lands in row ``e·G·C + g·C + r``; every dropped
    one collides in one extra row, ``E·G·C``, which the GEMMs never read
    (the JAX package's ``(E+1, C+1, D)`` buffer with drops at ``[E, C]``,
    flattened). The GEMMs' output has that extra row zeroed, so a dropped
    assignment contributes zeros.

    The combine is deterministic, with no atomics: each token has exactly
    K assignments, and its output is ``((c_0 + c_1) + c_2) + …`` in x's
    dtype, ``c_k = y[slot of (t, k)] · w[t, k]`` (the weight cast to x's
    dtype first), k in `route`'s order (descending score). The JAX
    package adds the same products to zeros by scatter-add, in the
    sorted order; in float32 the two differ by rounding only.

    It is differentiable (training): the combine weights carry the
    router's gradient, and ``aux`` (the load-balance loss, 0 without
    ``aux_loss_weight``) goes into the LM's loss. With grad on, the
    expert output is built out of place (``bmm(out=…)`` has no gradient);
    the values are the same."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = cfg.dispatch_groups if cfg.dispatch_groups > 1 and T % cfg.dispatch_groups == 0 else 1
    Tg = T // G
    C = capacity(Tg, cfg)
    bias = p.get("router_bias")
    routed = [route(x[g * Tg:(g + 1) * Tg], p["router"], bias, cfg) for g in range(G)]
    w = torch.stack([r[1] for r in routed]).view(T, K)
    aux = torch.stack([r[2] for r in routed]).mean()

    # ---- sort-based dispatch -------------------------------------------
    slots = assignment_slots(torch.stack([r[0] for r in routed]), E, C).view(T, K)
    buf = x.new_zeros((E * G * C + 1, D))
    buf[slots.view(-1)] = x.repeat_interleave(K, dim=0)
    xb = buf[:-1].view(E, G * C, D)

    # ---- expert GEMMs ----------------------------------------------------
    h = _gate(torch.bmm(xb, p["wi_gate"]), act).mul_(torch.bmm(xb, p["wi_up"]))
    del buf, xb
    if torch.is_grad_enabled() and (h.requires_grad or p["wo"].requires_grad):
        # training: ``out=`` has no gradient; the drop row is appended
        yb = torch.cat([torch.bmm(h, p["wo"]).view(E * G * C, D), x.new_zeros((1, D))])
    else:
        yb = x.new_empty((E * G * C + 1, D))
        yb[-1].zero_()
        torch.bmm(h, p["wo"], out=yb[:-1].view(E, G * C, D))
    del h

    # ---- combine: each token's K contributions, in k order -------------
    wx = w.to(x.dtype)
    out = yb[slots[:, 0]] * wx[:, :1]
    for k in range(1, K):
        out = out + yb[slots[:, k]] * wx[:, k:k + 1]

    # ---- shared experts (always-on, DSv3) --------------------------------
    if cfg.n_shared:
        hs = _gate(x @ p["shared_wi_gate"], act).mul_(x @ p["shared_wi_up"])
        out = out + hs @ p["shared_wo"]
    return out, aux


def router_bias_update(bias: torch.Tensor, idx: torch.Tensor, n_experts: int,
                       gamma: float = 1e-3) -> torch.Tensor:
    """DeepSeek-V3 aux-loss-free balancing: nudge under-loaded experts'
    selection bias up, over-loaded ones down (applied outside the
    gradient)."""
    load = torch.bincount(idx.reshape(-1).long(), minlength=n_experts).float()
    return bias + gamma * torch.sign(load.mean() - load)
