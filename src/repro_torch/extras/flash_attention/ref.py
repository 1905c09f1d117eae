"""Plain PyTorch version of causal GQA flash attention: a copy of the JAX
package's oracle (``src/repro/extras/flash_attention/ref.py``). Logits in
float32, then the tanh softcap, then the mask (key ``j`` is kept for query
``i`` iff ``j <= i`` and, with ``window``, ``j > i - window``; the rest are
filled with ``-1e30``), a softmax, and the output in q's dtype. It
materialises the ``(B, Nkv, G, S, S)`` float32 logits (float64 for float64
inputs, so that ``gradcheck`` can hold a vector-Jacobian product to it).

It is differentiable: where grad mode is on and an input requires grad,
the softcap and the mask run out of place (``tanh``'s backward needs its
output); the values are the same either way."""
from __future__ import annotations

import torch


def mha_reference(
    q: torch.Tensor,   # (B, Sq, Nq, H)
    k: torch.Tensor,   # (B, Skv, Nkv, H)
    v: torch.Tensor,   # (B, Skv, Nkv, Hv)
    *,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    B, Sq, Nq, H = q.shape
    _, Skv, Nkv, Hv = v.shape
    G = Nq // Nkv
    scale = scale if scale is not None else H**-0.5
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, Nkv, G, H).to(acc)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(acc)).mul_(scale)
    if softcap is not None:
        logits = logits.div_(softcap).tanh_()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
            logits = logits * softcap
        else:
            logits = logits.mul_(softcap)
    pos_q = torch.arange(Sq, device=q.device)[:, None]
    pos_k = torch.arange(Skv, device=q.device)[None, :]
    ok = pos_k <= pos_q
    if window is not None:
        ok = ok & (pos_k > pos_q - window)
    logits = logits.masked_fill_(~ok, -1e30)
    p = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(acc))
    return out.reshape(B, Sq, Nq, Hv).to(q.dtype)
