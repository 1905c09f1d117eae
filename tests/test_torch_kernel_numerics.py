"""The arithmetic of the port's two tensor-core kernels, emulated on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); these
tests check their numeric designs where the tests run, against the plain
versions they are held to there:

- ``csrc/flash_attention_tc.cu``: bf16 inputs, fp32 logits, an online
  softmax over 64-key tiles with fp32 m and l, P rounded to bf16 before P·V
  (the only rounding the JAX kernel does not do), fp32 accumulation, the
  output rounded to bf16. Held to ``mha_reference`` within ``2e-2 ·`` each
  output row's max, the kernel's bound.
- ``csrc/cin.cu``: split TF32 on ``P_h = w_hᵀ · x0`` for each ``h``. Each
  operand is split into hi (the fp32 bits with the low 13 mantissa bits
  cleared) and lo = x - hi, which the tensor core reads to 10 mantissa bits;
  a term is lo·hi + hi·lo + hi·hi, and ``out = Σ_h xk[:, h] · P_h`` in fp32.
  Held to ``cin_layer_reference`` within ``1e-4 · max|plain|`` at xDeepFM's
  layer widths; one TF32 product alone is not.

Inputs come from numpy seeds; the emulations live here, not in the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.extras.flash_attention.ref import mha_reference  # noqa: E402
from repro_torch.kernels.cin.ref import cin_layer_reference  # noqa: E402


def attention_tc_mirror(q, k, v, *, scale=None, window=None, softcap=None, tile=64):
    """The tensor-core kernel's rounding points in plain torch: ``(B, S, Nq,
    H)`` bf16 inputs, the kernel's order of tiles and its online softmax."""
    B, S, Nq, H = q.shape
    Nkv, Hv = k.shape[2], v.shape[3]
    G = Nq // Nkv
    scale = H**-0.5 if scale is None else scale
    qf = q.float().reshape(B, S, Nkv, G, H).permute(0, 2, 3, 1, 4)  # (B, Nkv, G, S, H)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]                  # (B, Nkv, 1, S, H)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, Nkv, G, S), -1e30)
    l = torch.zeros((B, Nkv, G, S))
    o = torch.zeros((B, Nkv, G, S, Hv))
    pos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        keys = torch.arange(k0, min(k0 + tile, S))[None, :]
        s = qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2) * scale   # fp32 logits
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        ok = keys <= pos
        if window is not None:
            ok &= keys > pos - window
        s = s.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)                                       # fp32 p
        o = o * corr[..., None] + p.bfloat16().float() @ vf[..., k0:k0 + tile, :]
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Nq, Hv).to(q.dtype)


@pytest.mark.parametrize("B,S,Nq,Nkv,H,q_gain,window,softcap", [
    (1, 300, 8, 1, 256, 1.0, None, None),    # gemma-2b's heads: 8 on 1, head_dim 256
    (1, 300, 8, 1, 256, 8.0, None, None),    # the same, logits 8x sharper
    (1, 300, 64, 8, 128, 1.0, 100, 30.0),    # qwen2-72b's heads, a window and a softcap
])
def test_attention_bf16_p_within_bound(B, S, Nq, Nkv, H, q_gain, window, softcap):
    rng = np.random.default_rng(S + Nq + H)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).bfloat16()
               for sh in ((B, S, Nq, H), (B, S, Nkv, H), (B, S, Nkv, H)))
    q = (q.float() * q_gain).bfloat16()
    got = attention_tc_mirror(q, k, v, window=window, softcap=softcap).float()
    want = mha_reference(q, k, v, window=window, softcap=softcap).float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    ratio = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    assert ratio <= 2e-2, ratio


def tf32_parts(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of fp32 ``x`` as the tensor core sees them: hi has the
    low 13 mantissa bits cleared, lo = x - hi read to 10 mantissa bits."""
    mask = -8192  # 0xffffe000 as an int32
    hi = (x.view(torch.int32) & mask).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def test_cin_split_tf32_keeps_fp32_accuracy():
    """xDeepFM's layers 1-2 (H 200, m 39, H' 200: 7,800 terms a sum)."""
    rng = np.random.default_rng(0)
    B, H, m, d, Hp = 16, 200, 39, 10, 200
    xk = torch.from_numpy(rng.normal(size=(B, H, d)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(size=(B, m, d)).astype(np.float32))
    w = torch.from_numpy((0.01 * rng.normal(size=(H * m, Hp))).astype(np.float32))
    want = cin_layer_reference(xk, x0, w)
    (xh, xl), (wh, wl) = tf32_parts(x0), tf32_parts(w.reshape(H, m, Hp))

    def per_h(a, b):  # P_h (B, H, H', d): tf32 x tf32 products are exact in fp32, sums fp32
        return torch.einsum("hmk,bmd->bhkd", a, b)

    def combine(p):  # out = Σ_h xk[:, h] · P_h, in fp32
        return torch.einsum("bhd,bhkd->bkd", xk, p)

    split = combine(per_h(wl, xh) + per_h(wh, xl) + per_h(wh, xh))
    one_pass = combine(per_h(wh, xh))
    scale = want.abs().max().item()
    err_split = (split - want).abs().max().item() / scale
    err_one = (one_pass - want).abs().max().item() / scale
    assert err_split <= 1e-4, err_split
    assert err_one > 1e-4 > 10 * err_split, (err_one, err_split)
