"""AdamW on PyTorch with optional int8-quantized moments: the port of
``src/repro/optim/adamw.py``, written by hand over a dict of tensors keyed
by parameter name (``dict(model.named_parameters())``).

The reference's semantics, which ``torch.optim.AdamW`` does not share: one
clip of every gradient by the global norm; bias correction from the
stepped counter; weight decay on every leaf, scaled by the learning rate
and added to the Adam step; the update in float32, cast back to each
leaf's dtype; the ``±10`` clamp of the per-element step only under
``quantize_moments``; quantized moments (int8 with a float32 scale a row
of the last dim, v in the sqrt domain) only for leaves with ``ndim >= 1``.
``torch.round`` rounds half to even, as ``jnp.round`` does.

`update` writes the parameters in place (under ``no_grad``) and float32
moments in place too; it returns the new state. A state is therefore used
once: step from a fresh one (`init`, or a checkpoint) to repeat a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantize_moments: bool = False


class QTensor(NamedTuple):
    q: torch.Tensor      # int8 payload
    scale: torch.Tensor  # float32 scale a row of the last dim, (..., 1)


def _quant(x: torch.Tensor, *, sqrt_domain: bool = False) -> QTensor:
    if sqrt_domain:
        # v >= 0: quantizing sqrt(v) compresses the dynamic range so small
        # second moments never collapse to zero (which would blow up m/√v)
        x = torch.sqrt(torch.clamp(x, min=0.0))
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    return QTensor(torch.round(x / scale).to(torch.int8), scale.float())


def _dequant(t: QTensor, *, sqrt_domain: bool = False) -> torch.Tensor:
    x = t.q.float() * t.scale
    return torch.square(x) if sqrt_domain else x


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32: the steps taken
    m: dict             # name → float32 tensor or QTensor
    v: dict             # name → float32 tensor or QTensor (sqrt domain)


def init(cfg: AdamWConfig, params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero moments for ``params`` (name → tensor), on their devices."""

    def zeros_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _quant(z) if cfg.quantize_moments and p.ndim >= 1 else z

    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: zeros_like(p) for n, p in params.items()},
        v={n: zeros_like(p) for n, p in params.items()},
    )


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The float32 L2 norm of every gradient together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


@torch.no_grad()
def update(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],
    state: AdamWState,
    params: Mapping[str, torch.Tensor],
    lr_scale: "torch.Tensor | float" = 1.0,
) -> tuple[AdamWState, dict]:
    """One AdamW step of ``params`` (written in place) from ``grads`` (the
    same names; any dtype). Returns ``(new_state, {"grad_norm", "lr"})``."""
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale
    new_m, new_v = {}, {}
    for name, p in params.items():
        g = grads[name].float() * clip
        m, v = state.m[name], state.v[name]
        if isinstance(m, QTensor):
            m_f = cfg.b1 * _dequant(m) + (1 - cfg.b1) * g
        else:
            m_f = m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        if isinstance(v, QTensor):
            v_f = cfg.b2 * _dequant(v, sqrt_domain=True) + (1 - cfg.b2) * g * g
        else:
            v_f = v.mul_(cfg.b2).add_(((1 - cfg.b2) * g).mul_(g))
        del g
        upd = (m_f / b1c).div_(torch.sqrt(v_f / b2c).add_(cfg.eps))
        if cfg.quantize_moments:
            # quantized moments can momentarily under-estimate v: clamp the
            # per-element step (trust-region guard, standard for 8-bit Adam)
            upd = upd.clamp_(-10.0, 10.0)
        pf = p.float()
        p.copy_(pf - lr * upd.add_(cfg.weight_decay * pf))
        del upd, pf
        new_m[name] = _quant(m_f) if isinstance(m, QTensor) else m_f
        new_v[name] = _quant(v_f, sqrt_domain=True) if isinstance(v, QTensor) else v_f
    return AdamWState(step=step, m=new_m, v=new_v), {"grad_norm": gn, "lr": lr}


def cosine_warmup(step, *, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """The learning-rate scale at ``step``: linear warm-up to 1 over
    ``warmup`` steps, then a cosine to ``floor`` at ``total``; 0 at step 0."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
