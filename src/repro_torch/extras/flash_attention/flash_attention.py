"""Wrapper of the causal GQA flash-attention CUDA kernels
(``csrc/flash_attention_tc.cu``, ``csrc/flash_attention_tf32.cu``,
``csrc/flash_attention.cu``).

`flash_attention` replaces ``flash_attention`` (body ``_attn_kernel``) of
``src/repro/extras/flash_attention/flash_attention.py``: forward attention
with a causal mask, an optional sliding window and an optional tanh softcap,
over ``Sq == Skv``. A block owns (position, query head) rows of one (batch,
kv head) and walks the kv tiles they need with an fp32 online softmax;
tiles wholly above the diagonal or outside the window are skipped.

Three routes, chosen by `route` on dtype and shape alone:

- ``"tc"`` (``flash_attention_tc``): bfloat16 with ``H`` and ``Hv``
  multiples of 8 and at most 64 query heads a kv head. Both products on
  the tensor cores (``wgmma``), every tile through TMA — whose descriptors
  need each row stride a multiple of 16 bytes, hence the multiples of 8;
  P is rounded to bf16 before P·V.
- ``"tf32"`` (``flash_attention_tf32``): float32 with ``H`` and ``Hv``
  multiples of 4 (16-byte rows) and at most 64 query heads a kv head. P·V
  on the tensor cores in split TF32 (three TF32 products a term, hi·hi +
  hi·lo + lo·hi, fp32 accuracy kept); Q·Kᵀ in fp32 FMAs in head-dim order,
  the plain version's sum, in a warpgroup of its own; every tile through
  TMA.
- ``"fma"`` (``flash_attention``): everything else — head dims TMA cannot
  describe, more than 64 query heads a kv head — on fp32 FMAs, exact up to
  summation order.

A tensor-core route copies an input off a 16-byte boundary (a view at an
odd offset) to an aligned one first. The layout is the JAX package's:
``q (B, S, Nq, H)``, ``k (B, S, Nkv, H)``, ``v (B, S, Nkv, Hv)``, no
transposes. A CPU tensor goes to the plain version
(`repro_torch.extras.flash_attention.ref`); a CUDA tensor launches the
kernel or raises: on a device mix, a dtype other than float32 or bfloat16
(or two dtypes), a non-contiguous input, ``Sq != Skv``, ``Nq % Nkv``, ``H``
or ``Hv`` above 256, a ``window`` under 1 or a ``softcap`` not above 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.extras.flash_attention import ref
from repro_torch.kernels.cuda import CudaKernel, check, on_cpu, refuse_grad

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

FLASH_ATTENTION = CudaKernel(
    "flash_attention", "flash_attention",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I],
)
FLASH_ATTENTION_TC = CudaKernel(
    "flash_attention_tc", "flash_attention_tc",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _F],
)
FLASH_ATTENTION_TF32 = CudaKernel(
    "flash_attention_tf32", "flash_attention_tf32",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _F],
)
ROUTES = {"tc": FLASH_ATTENTION_TC, "tf32": FLASH_ATTENTION_TF32, "fma": FLASH_ATTENTION}
MAX_HEAD_DIM = 256
TC_MAX_GROUP = 64  # query heads a kv head: one position's heads fit a 64-row tile
# head dims a TMA row takes: a row stride of 16-byte units
TMA_MULTIPLE = {torch.bfloat16: 8, torch.float32: 4}


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tc"`` for bfloat16 and ``"tf32"`` for float32 with ``H``, ``Hv``
    whole 16-byte rows (multiples of 8 and 4) and at most `TC_MAX_GROUP`
    query heads a kv head, else ``"fma"``."""
    H, Hv, G = q.shape[3], v.shape[3], q.shape[2] // max(k.shape[2], 1)
    n = TMA_MULTIPLE.get(q.dtype)
    if n is None or H % n or Hv % n or G > TC_MAX_GROUP:
        return "fma"
    return "tc" if q.dtype == torch.bfloat16 else "tf32"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention ``(B, S, Nq, H) × (B, S, Nkv, H) × (B, S, Nkv,
    Hv) → (B, S, Nq, Hv)`` in q's dtype; ``scale`` defaults to ``H**-0.5``."""
    refuse_grad("flash_attention", q, k, v)
    if on_cpu(q, k, v):
        return ref.mha_reference(q, k, v, scale=scale, window=window, softcap=softcap)
    return launch(q, k, v, scale=scale, window=window, softcap=softcap)


def launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """`flash_attention` on CUDA tensors, through the kernel `route` names."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for what, t in (("q", q), ("k", k), ("v", v)):
        check(t, what, q.dtype, 4)
    B, S, Nq, H = q.shape
    Bk, Skv, Nkv, Hk = k.shape
    if v.shape[:3] != k.shape[:3] or Bk != B or Hk != H:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not agree")
    Hv = v.shape[3]
    if Skv != S:
        raise ValueError(f"the kernel takes square attention: Sq {S} != Skv {Skv}")
    if Nkv == 0 or Nq % Nkv:
        raise ValueError(f"{Nq} query heads do not group over {Nkv} kv heads")
    if H > MAX_HEAD_DIM or Hv > MAX_HEAD_DIM:
        raise ValueError(f"head dims H {H}, Hv {Hv}: the kernel takes at most {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: at least 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap {softcap}: must be above 0")
    if S * (Nq // Nkv) >= 2**31:
        raise ValueError(f"{S} positions × {Nq // Nkv} heads a group: over the int32 row count")
    out = torch.empty((B, S, Nq, Hv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else H**-0.5
    r = route(q, k, v)
    if r != "fma":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        ROUTES[r](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Nq, Nkv, H, Hv,
                  float(scale), window or 0, float(softcap or 0.0))
        return out
    vec = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)) and H % 4 == 0 and Hv % 4 == 0
    FLASH_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Nq, Nkv,
                    H, Hv, float(scale), window or 0, float(softcap or 0.0),
                    int(q.dtype == torch.bfloat16), int(vec))
    return out


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with gradients for q, k and v:
    ``FlashAttention.apply(q, k, v, scale, window, softcap)``. ``attend``
    (default `flash_attention`) runs the forward: the dry run
    (`repro_torch.extras.dryrun`) gives one that prices the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None, window=None, softcap=None, attend=flash_attention):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(scale=scale, window=window, softcap=softcap)
        return attend(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        want = ctx.needs_input_grad[:3]
        if not any(want):
            return None, None, None, None, None, None, None
        inputs = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, want)]
        with torch.enable_grad():
            out = ref.mha_reference(*inputs, **ctx.kw)
            grads = torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad_out)
        it = iter(grads)
        return (*(next(it) if w else None for w in want), None, None, None, None)
