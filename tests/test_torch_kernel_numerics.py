"""The arithmetic of the port's tensor-core kernels, emulated on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); these
tests check their numeric designs where the tests run, against the plain
versions they are held to there:

- ``csrc/flash_attention_tc.cu``: bf16 inputs, fp32 logits, an online
  softmax over 64-key tiles with fp32 m and l, P rounded to bf16 before P·V
  (the only rounding the JAX kernel does not do), fp32 accumulation, the
  output rounded to bf16. Held to ``mha_reference`` within ``2e-2 ·`` each
  output row's max, the kernel's bound.
- ``csrc/flash_attention_tf32.cu``: fp32 inputs; the logits as a chain of
  fp32 FMAs in head-dim order (the plain version's sum); P·V in split TF32
  (P and V split into hi and lo as `tf32_parts` does, three TF32 products a
  term, the tensor core's fp32 sums rounded toward zero step by step) in
  fresh accumulators a tile, added with a rounded FMA; the online softmax.
  Held to ``mha_reference`` within ``2e-5 ·`` each output row's max at
  gemma-2b's and qwen2-72b's heads (one TF32 product of P·V alone is not),
  and at the fp32 model's init scale within 1e-5, where exact attention and
  split-TF32 logits are not.
- ``csrc/cin.cu``: split TF32 on ``P_h = w_hᵀ · x0`` for each ``h``. Each
  operand is split into hi (the fp32 bits with the low 13 mantissa bits
  cleared) and lo = x - hi, which the tensor core reads to 10 mantissa bits;
  a term is lo·hi + hi·lo + hi·hi, and ``out = Σ_h xk[:, h] · P_h`` in fp32.
  Held to ``cin_layer_reference`` within ``1e-4 · max|plain|`` at xDeepFM's
  layer widths; one TF32 product alone is not.

And the work split of ``csrc/stwig_expand.cu``, which has no arithmetic to
round but a plan that must give every slot exactly once: rows' ends and
edges merged and cut into tiles (Merrill & Garland's merge-path search of
``indptr``), the survivor counts of the row still open at each tile's end,
the carry a long row's owner takes from its earlier tiles, ranks from a
prefix of the tile's survivor flags. Held bit for bit to
``stwig_expand_reference`` on skewed graphs, with each output slot written
exactly once.

And the plan of ``csrc/hash_join.cu``: the build side staged into shared
memory where it fits the budget (each array at an offset congruent to its
address mod 16), persistent blocks looping over tiles of probe rows, each
tile's slots written by ``csrc/probe.cuh``'s ``store_window`` (each
thread's walk in 16-slot ``hit`` and 4-slot ``idx`` vectors with a fast
path for a vector inside one row and the build side, the scalar tail of
the last tile). Held bit for bit to ``probe_reference`` and the JAX
package's ``"jnp"`` probe, with every slot written exactly once. The same
``store_window`` over ``csrc/join_probe.cu``'s whole ``probe_window``
output, held to both packages' ``window_reference``; and
``csrc/bitset.cu``'s ``bitset_pack``, a word a thread (SIMD byte compares,
one multiply a lane, the ragged tail and unaligned masks byte by byte),
held to ``pack_reference`` of the zero-padded mask and the JAX package's
``pack_bitset``. And ``bitset_lookup`` and ``candidate_filter`` of the same
source, sixteen elements a thread (16-byte loads and stores, the filter's
lazy reads by group, the ragged tail and unaligned arrays element by
element), held to the port's plain versions and the JAX ``"jnp"`` ops,
with the filter's reads checked against what its short-circuit allows.
And ``bitset_unpack`` of the same source, a lane per half word and one
16-byte store of its 16 bools, each warp store 512 contiguous bytes, held
to ``unpack_reference`` with every byte written once.

Inputs come from numpy seeds; the emulations live here, not in the port.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.extras.flash_attention.ref import mha_reference  # noqa: E402
from repro_torch.kernels.cin.ref import cin_layer_reference  # noqa: E402
from repro_torch.kernels.hash_join.ref import probe_reference  # noqa: E402
from repro_torch.kernels.stwig_expand.ref import stwig_expand_reference  # noqa: E402
from repro_torch.kernels.stwig_expand.stwig_expand import TILE  # noqa: E402


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


def rz_float32(x: torch.Tensor) -> torch.Tensor:
    """float64 ``x`` to float32 rounded toward zero, as the tensor core's
    fp32 sums round."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def tc_sum(pairs, d=None):
    """Σ over k of ``a[..., k] · b[..., k, :]`` as a chain of TF32 wgmmas:
    for each step of 8 k and each ``(a, b)`` pair in turn, the step's eight
    products (exact in fp32: TF32 x TF32) added to the fp32 accumulator with
    one rounding toward zero; ``d`` None starts at zero."""
    K = pairs[0][0].shape[-1]
    for k0 in range(0, K, 8):
        for a, b in pairs:
            step = a[..., k0:k0 + 8].double() @ b[..., k0:k0 + 8, :].double()
            d = rz_float32(step if d is None else d.double() + step)
    return d


KEY_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]  # an 8-key step's keys in the V box's k order


def fma_logits(qf, kf):
    """``q · kᵀ`` over the last axis as a chain of fp32 FMAs, h = 0, 1, ... in
    order (the exact product added, one rounding a step): ``(..., R, H)`` x
    ``(..., K, H)`` → ``(..., R, K)``."""
    s = torch.zeros(qf.shape[:-1] + (kf.shape[-2],))
    for h in range(qf.shape[-1]):
        s = (s.double() + qf[..., h, None].double() * kf[..., None, :, h].double()).float()
    return s


def attention_tf32_mirror(q, k, v, *, scale=None, window=None, softcap=None, products=3):
    """``csrc/flash_attention_tf32.cu``'s rounding points in plain torch, fp32
    ``(B, S, Nq, H)`` inputs: the logits by `fma_logits`; the online softmax
    over 64-key tiles (x = s·scale, tanh(x/c)·c, the mask as -1e30, m started
    at -1e30, expf); each tile's P·V in split TF32 — P and V split by
    `tf32_parts`, a term lo·hi + hi·lo + hi·hi (``products=1``: hi·hi alone)
    summed by `tc_sum` over the tile's keys in the V box's order — added as
    O = fma(O, corr, P·V); O / max(l, 1e-30). A row's partial sums of l are
    summed in another order than the kernel's four threads do (fp32 rounding
    only)."""
    B, S, Nq, H = q.shape
    Nkv, Hv = k.shape[2], v.shape[3]
    G = Nq // Nkv
    scale = H**-0.5 if scale is None else scale
    qf = q.reshape(B, S, Nkv, G, H).permute(0, 2, 3, 1, 4).reshape(B, Nkv, G * S, H)
    pos = torch.arange(S).repeat(G)[:, None]  # rows (g, s)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    logits = fma_logits(qf, kf)
    m = torch.full((B, Nkv, G * S), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros((B, Nkv, G * S, Hv))
    for k0 in range(0, S, 64):
        n = min(64, S - k0)
        x = logits[..., k0:k0 + n] * scale
        if softcap is not None:
            x = torch.tanh(x / softcap) * softcap
        keys = torch.arange(k0, k0 + n)[None, :]
        ok = keys <= pos
        if window is not None:
            ok &= keys > pos - window
        x = x.masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        # the tile's keys (zero-padded to whole 8-key steps) in the V box's order
        pad = -n % 8
        order = (torch.arange(0, n + pad, 8)[:, None] + torch.tensor(KEY_ORDER)).reshape(-1)
        pp = torch.nn.functional.pad(p, (0, pad))[..., order]
        vv = torch.nn.functional.pad(vf[:, :, k0:k0 + n], (0, 0, 0, pad))[:, :, order]
        (p_hi, p_lo), (v_hi, v_lo) = tf32_parts(pp), tf32_parts(vv)
        pairs = [(p_lo, v_hi), (p_hi, v_lo), (p_hi, v_hi)] if products == 3 else [(p_hi, v_hi)]
        o = (o.double() * corr[..., None].double() + tc_sum(pairs).double()).float()
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Nkv, G, S, Hv).permute(0, 3, 1, 2, 4).reshape(B, S, Nq, Hv)


def row_ratio(got, want):
    """The largest over rows of max|got - want| / max|want| (last axis)."""
    return ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()


@pytest.mark.parametrize("B,S,Nq,Nkv,H,window,softcap", [
    (1, 300, 8, 1, 256, None, None),    # gemma-2b's heads: 8 on 1, head_dim 256
    (1, 300, 16, 2, 128, 100, 30.0),    # qwen2-72b's: 8 a kv head, head_dim 128, window, softcap
])
def test_attention_split_tf32_within_bound(B, S, Nq, Nkv, H, window, softcap):
    """N(0,1) fp32 inputs: the split-TF32 route's arithmetic within ``2e-5 ·``
    each output row's max|plain| (the fp32 routes' bound), one TF32 product
    a term of P·V alone not."""
    rng = np.random.default_rng(S + Nq + H)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((B, S, Nq, H), (B, S, Nkv, H), (B, S, Nkv, H)))
    want = mha_reference(q, k, v, window=window, softcap=softcap)
    got = attention_tf32_mirror(q, k, v, window=window, softcap=softcap)
    assert got.shape == want.shape and torch.isfinite(got).all()
    split = row_ratio(got, want)
    one = row_ratio(attention_tf32_mirror(q, k, v, window=window, softcap=softcap, products=1),
                    want)
    assert split <= 2e-5, split
    assert one > 2e-5 > 2 * split, (one, split)


def attention_float64(q, k, v):
    """Causal attention computed in float64 throughout: the control for how
    far an fp32 rounding of it lies."""
    B, S, Nq, H = q.shape
    Nkv = k.shape[2]
    qg = q.double().reshape(B, S, Nkv, Nq // Nkv, H)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.double()) * H**-0.5
    pos = torch.arange(S)
    p = torch.softmax(logits.masked_fill(pos[None, :] > pos[:, None], -1e30), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.double()).reshape(B, S, Nq, -1)


def test_attention_split_tf32_sharpened_logits():
    """Inputs at the scale of the random init the fp32 gemma-2b is checked
    with (``chip_smoke.py`` ``[lm]``): q ~ 16·N(0,1), k and v ~ 45·N(0,1),
    head_dim 256, so logits reach the hundreds and fp32 itself rounds a
    logit by ~1e-3. There the plain version lies ~4e-4 of a row's max from
    float64, past the 1e-4 the fp32 model's layers are held to, so exact
    logits cannot hold it; logits summed as the plain version sums them
    (`fma_logits`) do, and P·V in split TF32 adds next to nothing. Logits in
    split TF32 on the tensor core (`tc_sum`, 32 head dims a piece) are held
    to neither."""
    rng = np.random.default_rng(7)
    B, S, Nq, Nkv, H = 1, 256, 8, 1, 256
    q, k, v = (torch.from_numpy((sd * rng.normal(size=sh)).astype(np.float32))
               for sd, sh in ((16, (B, S, Nq, H)), (45, (B, S, Nkv, H)), (45, (B, S, Nkv, H))))
    want = mha_reference(q, k, v)
    exact = row_ratio(want.double(), attention_float64(q, k, v))
    got = row_ratio(attention_tf32_mirror(q, k, v), want)
    qf, kf = q[0].transpose(0, 1), k[0].transpose(0, 1)  # (heads, S, H)
    (q_hi, q_lo), (k_hi, k_lo) = tf32_parts(qf), tf32_parts(kf.transpose(-1, -2))
    tc = sum(tc_sum([(q_lo[..., c:c + 32], k_hi[..., c:c + 32, :]),
                     (q_hi[..., c:c + 32], k_lo[..., c:c + 32, :]),
                     (q_hi[..., c:c + 32], k_hi[..., c:c + 32, :])]) for c in range(0, H, 32))
    fma = fma_logits(qf, kf)
    assert exact > 1e-4, exact  # exact attention misses the plain version by more
    assert got <= 1e-5, got
    assert (tc != fma).float().mean() > 0.5  # the tensor core's logits round otherwise


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


def expand_tile_mirror(words_k, dst, lab, indptr, root_ok, *, child_labels, child_bound,
                       child_cap, cap, n_total, tile):
    """``csrc/stwig_expand.cu``'s two kernels in numpy, ``tile`` items a
    tile: returns ``(cand, cnt, writes, bounds)``, ``writes`` counting the
    stores to each slot of ``cand`` and ``bounds`` each tile boundary's
    (rows ended, next edge)."""
    E, k, C = dst.shape[0], len(child_labels), child_cap
    at = np.clip(indptr.astype(np.int64), 0, E)  # Graph::at
    surv = np.zeros((k, E), bool)                # Graph::survivors
    in_range = (dst >= 0) & (dst < words_k.shape[1] * 32)
    safe = np.where(in_range, dst, 0)
    for c, (label, bound) in enumerate(zip(child_labels, child_bound)):
        surv[c] = root_ok & (lab == label)
        if bound:
            surv[c] &= in_range & (((words_k[c][safe // 32] >> (safe % 32)) & 1) == 1)
    e_begin = int(at[0])
    n_edges = max(e_begin, int(at[cap + 1])) - e_begin
    total = cap + 1 + n_edges
    n_tiles = -(-(cap + 1 + E) // tile)

    def merge_path(d):
        lo, hi = max(d - n_edges, 0), min(d, cap + 1)
        while lo < hi:
            x = (lo + hi) // 2
            if at[x + 1] - e_begin <= d - x - 1:
                lo = x + 1
            else:
                hi = x
        return lo, e_begin + d - lo

    bounds = [merge_path(min(b * tile, total)) for b in range(n_tiles + 1)]
    tail = np.zeros((n_tiles, k), np.int64)  # plan_kernel: the open row's survivors
    for t in range(n_tiles):
        (_, j0), (r1, j1) = bounds[t], bounds[t + 1]
        if r1 <= cap:
            tail[t] = surv[:, max(at[r1], j0):j1].sum(1)
    cand = np.full((k, cap + 1, C), -1, np.int64)
    cnt = np.full((k, cap), -1, np.int64)
    writes = np.zeros((k, cap + 1, C), np.int64)
    for t in range(n_tiles):  # emit_kernel
        (i0, j0), (i1, j1) = bounds[t], bounds[t + 1]
        if (i0, j0) == (i1, j1):
            continue
        n_own = i1 - i0
        carry = np.zeros(k, np.int64)
        if at[i0] < j0:
            carry = tail[(i0 + at[i0] - e_begin) // tile:t].sum(0)
        ends = at[i0 + 1:i1 + 1] - j0
        ts = ends[-1] if n_own else 0
        for c in range(k):
            s = surv[c, j0:j1]
            before = np.concatenate([[0], np.cumsum(s)])
            if i1 <= cap:  # the open row's survivors of rank < C
                el = np.nonzero(s[ts:])[0] + ts
                rank = before[el] - before[ts] + (0 if n_own else carry[c])
                keep = rank < C
                cand[c, i1, rank[keep]] = dst[j0 + el[keep]]
                writes[c, i1, rank[keep]] += 1
            if not n_own:
                continue
            sl = np.append(dst[j0:j1][s], n_total)
            cum = before[ends]
            beg = np.concatenate([[0], cum[:-1]])
            rows = np.arange(i0, i1)
            n_row = cum - beg + np.where(rows == i0, carry[c], 0)
            cnt[c, rows[rows < cap]] = n_row[rows < cap]
            q = np.arange(C)[None, :] - np.where(rows == i0, carry[c], 0)[:, None]
            mine = q >= 0
            v = np.where(q < (cum - beg)[:, None],
                         sl[np.clip(beg[:, None] + q, 0, len(sl) - 1)], n_total)
            cand[c, i0:i1][mine] = v[mine]
            writes[c, i0:i1][mine] += 1
    return cand, cnt, writes, bounds


def csr_case(rng, deg, *, k=2, C=4, n_labels=3, rok=0.9, pad=13, e_begin=0, n_total=5000):
    """Rows of degrees ``deg`` (row ``cap`` = len(deg) is the ghost row with
    a ``pad``-edge tail; ``e_begin`` edges before row 0 belong to no row),
    random labels, ids, root candidacy and binding words."""
    cap = len(deg)
    E = e_begin + int(np.sum(deg)) + pad
    indptr = np.concatenate([[e_begin], e_begin + np.cumsum(deg), [E]]).astype(np.int32)
    words = rng.integers(0, 2**32, (k, -(-(n_total + 1) // 32)), dtype=np.uint32)
    args = [words, rng.integers(0, n_total, E).astype(np.int32),
            rng.integers(0, n_labels, E).astype(np.int32), indptr, rng.random(E) < rok]
    kw = dict(child_labels=tuple(int(x) for x in rng.integers(0, n_labels, k)),
              child_bound=tuple(bool(i % 2) for i in range(k)), child_cap=C, cap=cap,
              n_total=n_total)
    return args, kw


def straddle_case(rng, tile, C=4):
    """Row 0's survivors for child 0 straddle the first tile boundary at
    ranks C-1 | C, row 1's for child 1 the next at C-2 | C-1."""
    n0 = tile + 8
    deg = np.array([n0, 2 * tile, 5, 0, 7])
    args, kw = csr_case(rng, deg, k=2, C=C, rok=1.0)
    lab = args[2]
    lab[:] = 0
    kw.update(child_labels=(1, 2), child_bound=(False, False))
    lab[[*range(tile - C, tile), tile]] = 1  # edges at diagonals tile-C .. tile
    # row 1's edge e sits at diagonal e + 1 (row 0's end comes first)
    b = 2 * tile - 1
    lab[[*range(b - (C - 1), b), b]] = 2
    return args, kw


def expand_cases():
    rng = np.random.default_rng(30)
    long_deg = rng.integers(0, 20, 300)
    long_deg[5] = 50_000  # one row across ~25 tiles of the kernel's size
    empty_deg = rng.integers(0, 6, 20_000) * (rng.random(20_000) < 0.5)
    empty_deg[3_000:13_000] = 0  # a run of 10,000 empty rows
    every = csr_case(rng, rng.integers(0, 300, 60), k=2, C=4, rok=1.0)
    every[0][2][:] = 1  # every edge's label is the children's
    every[1].update(child_labels=(1, 1), child_bound=(False, False))
    return {
        "long-row": (csr_case(rng, long_deg, k=3, C=8), TILE),
        "long-row-small-tiles": (csr_case(rng, long_deg[:40], k=2, C=3), 256),
        "empty-runs": (csr_case(rng, empty_deg, k=2, C=4, pad=0), 256),
        "straddle": (straddle_case(rng, 32), 32),
        "straddle-kernel-tile": (straddle_case(rng, TILE, C=8), TILE),
        "k16-C1": (csr_case(rng, rng.integers(0, 40, 500), k=16, C=1, n_labels=4), 64),
        "every-edge-survives": (every, 32),
        "pad-tail-and-lead": (csr_case(rng, rng.integers(0, 9, 200), pad=300, e_begin=17), 32),
    }


@pytest.mark.parametrize("case", sorted(expand_cases()))
def test_stwig_expand_tile_plan(case):
    ((words, dst, lab, indptr, rok), kw), tile = expand_cases()[case]
    cand, cnt, writes, bounds = expand_tile_mirror(words, dst, lab, indptr, rok, tile=tile,
                                                   **kw)
    want_cand, want_cnt = stwig_expand_reference(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(dst), torch.from_numpy(lab),
        torch.from_numpy(indptr), torch.from_numpy(rok), **kw)
    assert (writes == 1).all(), "a slot written other than exactly once"
    np.testing.assert_array_equal(cand, want_cand.numpy())
    np.testing.assert_array_equal(cnt, want_cnt.numpy())
    # the boundaries are the merge path's: rows ended before diagonal d are
    # those whose end item r + (its end edge - e_begin) lies before d
    cap, E = kw["cap"], dst.shape[0]
    at = np.clip(indptr.astype(np.int64), 0, E)
    end_item = np.arange(cap + 1) + at[1:] - at[0]
    for b, (row, edge) in enumerate(bounds):
        d = min(b * tile, int(end_item[-1]) + 1)
        assert row == np.searchsorted(end_item, d) and row + edge - at[0] == d
    if case.startswith("long-row"):
        r = int(np.argmax(np.diff(at)))
        first = r + at[r] - at[0]
        assert (first + at[r + 1] - at[r]) // tile - first // tile >= 5  # spans tiles
        assert cnt[:, r].max() > kw["child_cap"]  # exact counts past C


# ------------------------------------------------------- hash_join_probe plan
CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
PROBE_ROWS = int(re.search(r"constexpr int kThreads = (\d+);",
                           (CSRC / "hash_join.cu").read_text())[1])  # kRows = kThreads
STAGE_BUDGET = int(re.search(r"kStageBudget = (\d+);", (CSRC / "hash_join.cu").read_text())[1])


def stage_mirror(arrays, addrs, rows):
    """``stage_offset`` + ``stage_copy`` of ``csrc/hash_join.cu``: each array
    (at a device address ``addrs[i]`` mod 16) placed in a shared image at an
    offset congruent to it mod 16, its body moved in 16-byte pieces, aligned
    on both sides; the tile scratch after. Returns views of the image."""
    image = np.zeros(STAGE_BUDGET + 256 + 9 * rows, np.uint8)
    writes = np.zeros(image.shape, np.int64)
    end, views = 0, []
    for arr, addr in zip(arrays, addrs):
        off = ((end + 15) & ~15) + addr % 16
        src = np.ascontiguousarray(arr).view(np.uint8).ravel()
        n = src.size
        head = min(n, (16 - addr % 16) % 16)
        body = (n - head) // 16
        if body:
            assert (off + head) % 16 == 0 and (addr + head) % 16 == 0
        image[off:off + n] = src  # head bytes, 16-byte body pieces, tail bytes
        writes[off:off + n] += 1
        views.append(image[off:off + n].view(arr.dtype).reshape(arr.shape))
        end = off + n
    assert (writes <= 1).all()
    off_tile = (end + 15) & ~15
    assert off_tile + 9 * rows <= STAGE_BUDGET + 3 * 30 + 15 + 9 * rows  # kMaxSmem
    return views


def lower_bound_steps(ka, keys, cap_a):
    """probe.cuh's search: bit_length(capA) guarded steps, unsigned keys."""
    lo = np.zeros(keys.shape, np.int64)
    hi = np.full(keys.shape, cap_a, np.int64)
    for _ in range(cap_a.bit_length()):
        act = lo < hi
        mid = (lo + hi) >> 1
        right = act & (ka[np.minimum(mid, cap_a - 1)] < keys)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(act & ~right, mid, hi)
    return lo


def hash_join_plan_mirror(ka, a_keys, a_valid, kb, b_keys, b_valid, *, dup_cap, rows, blocks,
                          addrs=(0, 4, 1)):
    """``csrc/hash_join.cu`` in numpy: the route, the persistent blocks'
    tiles of ``rows`` probe rows (``rows`` threads a block), each tile's
    slots written by `store_window_mirror` with ``Verified``'s test (probe
    row valid, build row valid, key columns equal). Returns ``(hit, idx,
    hit_writes, idx_writes, route)``."""
    cap_a, nk = a_keys.shape
    cap_b, dup = kb.shape[0], dup_cap
    route = "shared" if cap_a * (5 + 4 * nk) <= STAGE_BUDGET else "global"
    if route == "shared":
        ka, a_keys, a_valid = stage_mirror((ka, a_keys, a_valid), addrs, rows)
    hit = np.zeros(cap_b * dup, np.uint8)
    idx = np.zeros(cap_b * dup, np.int64)
    hit_w = np.zeros(cap_b * dup, np.int64)
    idx_w = np.zeros(cap_b * dup, np.int64)
    n_tiles = -(-cap_b // rows)
    for block in range(min(blocks, n_tiles)):
        for tile in range(block, n_tiles, blocks):
            j0 = tile * rows
            n_rows = min(rows, cap_b - j0)
            s_lo = lower_bound_steps(ka, kb[j0:j0 + n_rows], cap_a)
            base, n_slots = j0 * dup, n_rows * dup
            assert base % 16 == 0  # both outputs' vectors start 16-byte aligned
            assert tile == n_tiles - 1 or n_slots % 16 == 0  # only the last tile has tails
            # the tile's store_window, Verified as its test
            out = store_window_mirror(
                ka, kb[j0:j0 + n_rows], s_lo, dup=dup, nt=rows,
                row_ok=lambda r: b_valid[j0 + r].astype(bool),
                slot_ok=lambda r, pc: a_valid[pc].astype(bool) & (a_keys[pc] == b_keys[j0 + r]).all(-1))
            for full, part in zip((hit, idx, hit_w, idx_w), out):
                full[base:base + n_slots] = part.ravel()
    shape = (cap_b, dup)
    return (hit.reshape(shape).astype(bool), idx.reshape(shape).astype(np.int32),
            hit_w.reshape(shape), idx_w.reshape(shape), route)


def store_window_mirror(ka, key, lo, *, dup, nt, row_ok=None, slot_ok=None):
    """``csrc/probe.cuh``'s ``store_window`` in numpy: the windows of
    ``len(lo)`` rows (row ``r``: build positions ``lo[r] + w``, probe key
    ``key[r]``) as one flat range of ``rows · dup`` slots, walked by ``nt``
    threads. A step gives each thread one 16-slot ``hit`` piece and four
    4-slot ``idx`` pieces, its (row, slot) advanced by ``Walk``'s constant
    step (held to the division here), the piece's slots stepping across
    rows as ``hit_vector`` and ``idx_vector`` step, a fast path for a piece
    in one row and the build side; then the scalar tails at the end of the
    range. ``row_ok(r)`` and ``slot_ok(r, pc)`` are the kernel's test beyond
    key equality (none: ``KeyOnly``). Returns ``(hit, idx, hit_writes,
    idx_writes)``, all ``(rows, dup)``."""
    cap_a, cap_b = ka.shape[0], key.shape[0]
    n = cap_b * dup
    row_ok = row_ok or (lambda r: np.ones(r.shape, bool))
    slot_ok = slot_ok or (lambda r, pc: np.ones(r.shape, bool))
    n16, n4 = n // 16, n // 4
    hit, idx = np.zeros(n, np.uint8), np.zeros(n, np.int64)
    hit_w, idx_w = np.zeros(n, np.int64), np.zeros(n, np.int64)
    lo = lo.astype(np.int64)

    def walk(first, stride):  # one division, then constant steps
        return [first // dup, first % dup, stride // dup, stride % dup]

    def step(wk):
        wk[0], wk[1] = wk[0] + wk[2], wk[1] + wk[3]
        wrap = wk[1] >= dup
        wk[0], wk[1] = wk[0] + wrap, np.where(wrap, wk[1] - dup, wk[1])

    def piece(r, w, width):  # (k, width) rows and slots of k pieces
        rs, ws = [r], [w]
        for _ in range(width - 1):
            w = w + 1
            wrap = w == dup
            r, w = r + wrap, np.where(wrap, 0, w)
            rs.append(r)
            ws.append(w)
        return np.stack(rs, 1), np.stack(ws, 1)

    def slot_hit(r, w):
        p = lo[r] + w
        pc = np.clip(p, 0, cap_a - 1)
        return (p < cap_a) & row_ok(r) & (ka[pc] == key[r]) & slot_ok(r, pc)

    def slot_idx(r, w):
        return np.clip(lo[r] + w, 0, cap_a - 1)

    def vectors(wk, first, width, fn):
        r, w = wk[0], wk[1]
        assert (r * dup + w == first).all()  # the walk is the division's
        rs, ws = piece(r, w, width)
        pos = lo[r] + w
        fast = (w + width <= dup) & (pos >= 0) & (pos + width <= cap_a)
        out = fn(rs, ws)
        if fn is slot_hit:  # the fast path: the piece's keys against the row's at once,
            pc = np.clip(pos[:, None] + np.arange(width), 0, cap_a - 1)  # then the test
            run = row_ok(r)[:, None] & (ka[pc] == key[r][:, None]) & slot_ok(rs, pc)
            out = np.where(fast[:, None], run, out)
        else:
            out = np.where(fast[:, None], pos[:, None] + np.arange(width), out)
        return (first[:, None] + np.arange(width)).ravel(), out.ravel()

    t = np.arange(nt)
    a, b = walk(16 * t, 16 * nt), walk(4 * t, 4 * nt)
    u, q = t.copy(), t.copy()
    while (q < n4).any():
        act = u < n16
        sl, vals = vectors([a[0][act], a[1][act]], 16 * u[act], 16, slot_hit)
        hit[sl] = vals
        np.add.at(hit_w, sl, 1)
        for _ in range(4):
            act = q < n4
            sl, vals = vectors([b[0][act], b[1][act]], 4 * q[act], 4, slot_idx)
            idx[sl] = vals
            np.add.at(idx_w, sl, 1)
            q += nt
            step(b)
        u += nt
        step(a)
    for start, out, writes, fn in ((16 * n16, hit, hit_w, slot_hit), (4 * n4, idx, idx_w, slot_idx)):
        tail = np.arange(start, n)  # < 16 (hit) or < 4 (idx) slots, a division each
        out[tail] = fn(tail // dup, tail % dup)
        writes[tail] += 1
    shape = (cap_b, dup)
    return (hit.reshape(shape).astype(bool), idx.reshape(shape).astype(np.int32),
            hit_w.reshape(shape), idx_w.reshape(shape))


def probe_case(seed, cap_a, cap_b, nk, *, distinct=None, high=False):
    """A sorted build side with duplicate runs (keys ≥ 2**31 when ``high``),
    probe keys half drawn from it, ~20% invalid rows on each side, key
    columns of 3 values (so verification rejects some hash matches)."""
    rng = np.random.default_rng(seed)
    distinct = distinct or cap_a // 3 + 1
    ka = np.sort(rng.integers(0, distinct, cap_a)).astype(np.uint64) * 977
    ka = (ka + (2**31 if high else 0)).astype(np.uint32)
    ka[-1] = 0xFFFFFFFF
    kb = np.where(rng.random(cap_b) < 0.5, ka[rng.integers(0, cap_a, cap_b)],
                  rng.integers(0, 2**32, cap_b, dtype=np.uint64).astype(np.uint32))
    kb[:2] = [0, 0xFFFFFFFF]
    return (ka, rng.integers(0, 3, (cap_a, nk)).astype(np.int32), rng.random(cap_a) < 0.8,
            kb.astype(np.uint32), rng.integers(0, 3, (cap_b, nk)).astype(np.int32),
            rng.random(cap_b) < 0.8)


def probe_plan_cases():
    pow2 = (np.array([0, 5, 5, 5, 5, 5, 5, 9], np.uint32), np.full((8, 1), 5, np.int32),
            np.ones(8, bool), np.array([5, 9, 4, 5], np.uint32), np.full((4, 1), 5, np.int32),
            np.array([True, True, True, False]))
    return {  # (args, dup_cap, rows, blocks, route)
        "dup1": (probe_case(1, 300, 1100, 1), 1, PROBE_ROWS, 2, "shared"),
        "dup3-nk3": (probe_case(2, 300, 700, 3), 3, PROBE_ROWS, 2, "shared"),
        "dup16": (probe_case(3, 300, 1100, 1), 16, PROBE_ROWS, 2, "shared"),
        "dup64": (probe_case(4, 300, 600, 1), 64, PROBE_ROWS, 1, "shared"),
        "dup100-nk3-keys-over-2^31": (probe_case(5, 200, 300, 3, high=True), 100, PROBE_ROWS, 2,
                                      "shared"),
        "dup-over-capA": (probe_case(6, 5, 40, 1), 8, 16, 2, "shared"),
        "dup3-small-tiles": (probe_case(7, 100, 333, 1, distinct=20), 3, 16, 3, "shared"),
        "pow2-full-run": (pow2, 6, 16, 1, "shared"),
        "at-budget": (probe_case(8, 4096, 300, 5), 5, PROBE_ROWS, 2, "shared"),
        "over-budget": (probe_case(9, 4097, 300, 5), 5, PROBE_ROWS, 2, "global"),
    }


@pytest.mark.parametrize("case", sorted(probe_plan_cases()))
def test_hash_join_probe_tile_plan(case):
    """Every (row, slot) of ``hit`` and ``idx`` written exactly once, bit
    for bit the plain version's and the JAX package's ``"jnp"`` probe's."""
    jax = pytest.importorskip("jax")
    from repro.core.backend import get_kernels

    args, dup, rows, blocks, route = probe_plan_cases()[case]
    hit, idx, hit_w, idx_w, got_route = hash_join_plan_mirror(*args, dup_cap=dup, rows=rows,
                                                              blocks=blocks)
    assert got_route == route
    assert (hit_w == 1).all() and (idx_w == 1).all(), "a slot written other than exactly once"
    tt = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args]
    want_hit, want_idx = probe_reference(*tt, dup_cap=dup)
    np.testing.assert_array_equal(hit, want_hit.numpy())
    np.testing.assert_array_equal(idx, want_idx.numpy())
    # one jitted call compiles faster than the eager op-by-op dispatch
    jnp_probe = jax.jit(lambda *a: get_kernels("jnp").hash_join_probe(*a, dup_cap=dup))
    jh, ji = jnp_probe(*(jax.numpy.asarray(a) for a in args))
    np.testing.assert_array_equal(hit, np.asarray(jh))
    np.testing.assert_array_equal(idx, np.asarray(ji))
    if case == "pow2-full-run":
        assert hit[0].all() and idx[0, 0] == 1  # the run of six fills the window


# ----------------------------------------------------- probe_window's walk
WINDOW_THREADS = int(re.search(r"constexpr int kThreads = (\d+);",
                               (CSRC / "join_probe.cu").read_text())[1])


def window_walk_mirror(ka, kb, lo, *, dup, blocks):
    """``csrc/join_probe.cu``'s ``probe_window`` in numpy: probe.cuh's
    ``store_window`` over the whole flat output of ``capB · dup`` slots by
    ``blocks · kThreads`` threads, on key equality alone (``KeyOnly``)."""
    return store_window_mirror(ka, kb, lo, dup=dup, nt=blocks * WINDOW_THREADS)


def window_case(seed, cap_a, cap_b):
    """A sorted build side with duplicate runs, probe keys half from it, and
    their unsigned lower bounds."""
    rng = np.random.default_rng(seed)
    ka = (np.sort(rng.integers(0, cap_a // 3 + 1, cap_a)) * 977).astype(np.uint32)
    ka[-1] = 0xFFFFFFFF
    kb = np.where(rng.random(cap_b) < 0.5, ka[rng.integers(0, cap_a, cap_b)],
                  rng.integers(0, 2**32, cap_b, dtype=np.uint64).astype(np.uint32))
    return ka, kb, np.searchsorted(ka, kb, side="left").astype(np.int32)


@pytest.mark.parametrize("dup", [1, 5, 16, 17, 64, 67])
def test_probe_window_flat_walk(dup):
    """Every slot of ``hit`` and ``idx`` written exactly once, whatever the
    grid, for a ragged ``capB``; bit for bit the port's and the JAX
    package's ``window_reference``. A ``lo`` outside ``[0, capA]`` still
    gives an ``idx`` inside the build side."""
    jax = pytest.importorskip("jax")
    from repro.extras.join_probe import ref as jax_ref
    from repro_torch.extras.join_probe import ref as port_ref

    ka, kb, lo = window_case(dup, 300, 333)
    tk = [torch.from_numpy(x.view(np.int32)) for x in (ka, kb)]
    want_hit, want_idx = port_ref.window_reference(*tk, torch.from_numpy(lo), dup_cap=dup)
    # one jitted call compiles faster than the eager op-by-op dispatch
    jax_hit, jax_idx = jax.jit(lambda *a: jax_ref.window_reference(*a, dup_cap=dup))(ka, kb, lo)
    for blocks in (1, 2, -(-333 * dup // (16 * WINDOW_THREADS))):
        hit, idx, hit_w, idx_w = window_walk_mirror(ka, kb, lo, dup=dup, blocks=blocks)
        assert (hit_w == 1).all() and (idx_w == 1).all(), "a slot written other than exactly once"
        np.testing.assert_array_equal(hit, want_hit.numpy())
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(hit, np.asarray(jax_hit))
        np.testing.assert_array_equal(idx, np.asarray(jax_idx))
    wild = lo + np.random.default_rng(dup).integers(-400, 400, lo.shape).astype(np.int32)
    hit, idx, _, _ = window_walk_mirror(ka, kb, wild, dup=dup, blocks=1)
    assert ((idx >= 0) & (idx < ka.shape[0])).all()
    assert (ka[idx[hit]] == np.broadcast_to(kb[:, None], hit.shape)[hit]).all()


# ------------------------------------------------------------- bitset_pack
PACK_SRC = (CSRC / "bitset.cu").read_text()
LANE_ONES = int(re.search(r"kLaneOnes = (0x[0-9A-Fa-f]+)u;", PACK_SRC)[1], 16)
GATHER = int(re.search(r"kGather = (0x[0-9A-Fa-f]+)u;", PACK_SRC)[1], 16)


def pack_mirror(flags, addr):
    """``csrc/bitset.cu``'s ``pack_kernel`` in numpy: a word a thread over
    ``n`` flag bytes at a device address ``addr`` mod 16. A whole word of an
    aligned mask: two 16-byte loads, each 4-byte lane to 4 bits by a byte
    compare with zero, ``& kLaneOnes``, ``* kGather`` (mod 2**32) and a shift
    by 24. The last word, and every word of an unaligned mask: one byte at a
    time, the flags past ``n`` zero."""
    n = flags.shape[0]
    n_words = -(-n // 32)
    whole = n // 32 if addr % 16 == 0 else 0
    words = np.zeros(n_words, np.uint32)
    lanes = flags[:32 * whole].reshape(whole, 8, 4)
    ne = np.where(lanes != 0, np.uint8(0xFF), np.uint8(0)).view("<u4")[..., 0]  # __vcmpne4
    nib = ((ne & np.uint32(LANE_ONES)).astype(np.uint64) * GATHER % 2**32) >> 24
    assert (nib < 16).all()  # no carry reaches bit 28
    words[:whole] = (nib << (4 * np.arange(8, dtype=np.uint64))).sum(1)
    rest = np.zeros((n_words - whole) * 32, np.uint64)
    rest[:n - 32 * whole] = flags[32 * whole:] != 0
    words[whole:] = (rest.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1)
    return words


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097, 786_427])
def test_bitset_pack_word_a_thread(n):
    """Flag bytes of any value (a byte counts where it is nonzero), any
    length (the zero tail in the last word), aligned or not: bit for bit
    `pack_reference` of the zero-padded mask and the JAX package's
    ``pack_bitset``."""
    from repro.kernels.bitset import ref as jax_ref
    from repro_torch.kernels.bitset import ref as port_ref

    rng = np.random.default_rng(n)
    flags = np.where(rng.random(n) < 0.4, rng.integers(1, 256, n), 0).astype(np.uint8)
    want = port_ref.pack_padded_reference(torch.from_numpy(flags != 0)).numpy().view(np.uint32)
    np.testing.assert_array_equal(want, jax_ref.pack_bitset(flags != 0))
    for addr in (0, 1, 4, 8):
        np.testing.assert_array_equal(pack_mirror(flags, addr), want)


# ------------------------------------------- bitset_lookup, candidate_filter
GROUP = int(re.search(r"constexpr int kGroup = (\d+);", PACK_SRC)[1])
GROUP_LENGTHS = [1, 15, 16, 17, 1000, 1009]


def group_bits(flags):
    """(G, 16) bools → (G,) uint32, element i at bit i."""
    return (flags.astype(np.uint64) << np.arange(GROUP, dtype=np.uint64)).sum(1).astype(np.uint32)


def flag_bits(vectors):
    """``vector_bits`` of (G, 16) bytes, one 16-byte load each: a byte
    compare with zero and one multiply a 4-byte lane, as ``pack_mirror``."""
    lanes = np.ascontiguousarray(vectors).view("<u4")  # (G, 4)
    ne = np.where(vectors != 0, np.uint8(0xFF), np.uint8(0)).view("<u4")  # __vcmpne4
    assert ne.shape == lanes.shape
    nib = ((ne & np.uint32(LANE_ONES)).astype(np.uint64) * GATHER % 2**32) >> 24
    return (nib << (4 * np.arange(4, dtype=np.uint64))).sum(1).astype(np.uint32)


def bool_vector(bits):
    """``bool_vector``: (G,) 16-bit flags → (G, 16) bool bytes, built as four
    4-byte lanes (``nibble_bytes``), element 0 in the lowest byte."""
    nib = bits[:, None].astype(np.uint32) >> (4 * np.arange(4, dtype=np.uint32))
    lanes = ((nib & 1) | ((nib >> 1) & 1) << 8 | ((nib >> 2) & 1) << 16
             | ((nib >> 3) & 1) << 24).astype("<u4")
    return lanes.view(np.uint8).reshape(-1, GROUP)


def bit_test(words, ids):
    """``bit_test`` (``csrc/bitset.cuh``): the bits, and where the word was
    read (ids inside ``[0, 32 · n_words)``)."""
    inside = (ids >= 0) & (ids.astype(np.int64) < 32 * words.shape[0])
    w = words.view(np.uint32)[np.where(inside, ids >> 5, 0)]
    return inside & ((w >> (ids & 31).astype(np.uint32)) & 1).astype(bool), inside


def lookup_mirror(words, ids, addr):
    """``csrc/bitset.cu``'s ``lookup_kernel`` in numpy, ids at a device
    address ``addr`` mod 16 (the output, from ``torch.empty``, aligned). A
    whole group of an aligned call: four 16-byte loads, sixteen bit tests,
    one ``bool_vector`` store; the ragged last group, and every group of an
    unaligned call, element by element. Returns the output bytes and how
    many times each was written."""
    n = ids.shape[0]
    full = n // GROUP if addr % 16 == 0 else 0
    out, writes = np.zeros(n, np.uint8), np.zeros(n, np.int64)
    v = ids[:GROUP * full].reshape(full, GROUP)
    out[:GROUP * full] = bool_vector(group_bits(bit_test(words, v)[0])).reshape(-1)
    writes[:GROUP * full] += 1
    out[GROUP * full:] = bit_test(words, ids[GROUP * full:])[0]
    writes[GROUP * full:] += 1
    return out, writes


def filter_mirror(words, ids, labels, rok, label, addrs):
    """``cand_filter_kernel`` in numpy, the edge arrays ``(ids, labels,
    root_ok)`` at device addresses ``addrs`` mod 16. A whole group of an
    aligned call: one 16-byte load of its flags; none set → sixteen zero
    bytes and nothing else read; else its labels through ``load_lanes`` (four
    16-byte loads where all sixteen flags are set, else only the flagged
    ones), its ids likewise for the label matches, the bit test of the
    matches, one ``bool_vector`` store. The ragged last group and every group
    of an unaligned call: element by element, short-circuit. Returns the
    output bytes, the writes of each, and the edges whose label, id and
    bitset word were read."""
    n = ids.shape[0]
    full = n // GROUP if all(a % 16 == 0 for a in addrs) else 0
    m = GROUP * full
    out, writes = np.zeros(n, np.uint8), np.zeros(n, np.int64)
    read = {k: np.zeros(n, bool) for k in ("label", "id", "word")}
    ok = flag_bits(rok[:m].reshape(full, GROUP))
    okf = ((ok[:, None] >> np.arange(GROUP, dtype=np.uint32)) & 1).astype(bool)
    lab_read = np.where((ok == 0xFFFF)[:, None], True, okf)  # load_lanes
    v = np.where(lab_read, labels[:m].reshape(full, GROUP), 0)  # v = {}
    want = okf & (v == label)
    id_read = np.where(want.all(1)[:, None], True, want)
    v = np.where(id_read, ids[:m].reshape(full, GROUP), v)
    bit, inside = bit_test(words, v)
    hit = want & bit
    out[:m] = bool_vector(group_bits(hit)).reshape(-1)
    writes[:m] += 1
    read["label"][:m], read["id"][:m] = lab_read.reshape(-1), id_read.reshape(-1)
    read["word"][:m] = (want & inside).reshape(-1)
    r = rok[m:] != 0
    match = r & (labels[m:] == label)
    bit, inside = bit_test(words, ids[m:])
    out[m:] = match & bit
    writes[m:] += 1
    read["label"][m:], read["id"][m:], read["word"][m:] = r, match, match & inside
    return out, writes, read


def group_case(n, W=37):
    """Words, ids with -1, 32·W and 2^31 - 1 on group boundaries, labels of
    three values and ``root_ok`` in runs of 1-40 edges (all-zero, all-set
    and partial groups)."""
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2**32, W, dtype=np.uint32)
    ids = rng.integers(-50, 32 * W + 50, n).astype(np.int32)
    for i, x in zip((15, 16, 31, 32, n - 1), (-1, 32 * W, 2**31 - 1, -1, 2**31 - 1)):
        if 0 <= i < n:
            ids[i] = x
    runs = np.repeat(rng.random(n) < 0.5, rng.integers(1, 41, n))[:n]
    rok = np.where(runs, rng.integers(1, 256, n), 0).astype(np.uint8)  # any nonzero byte
    return words, ids, rng.integers(0, 3, n).astype(np.int32), rok


def group_addrs(elem_sizes):
    """Each array in turn, then all at once, 0-15 elements off alignment."""
    k = len(elem_sizes)
    for off in range(GROUP):
        for which in range(k + 1):
            yield tuple(off * s % 16 if which in (i, k) else 0 for i, s in enumerate(elem_sizes))


@pytest.mark.parametrize("n", GROUP_LENGTHS)
def test_bitset_lookup_sixteen_a_thread(n):
    """Every output byte written once, at every start of ``ids``; bit for
    bit `lookup_reference` and the JAX package's ``"jnp"`` op."""
    jax = pytest.importorskip("jax")
    from repro.core.backend import get_kernels
    from repro_torch.kernels.bitset import ref as port_ref

    words, ids, _, _ = group_case(n)
    want = port_ref.lookup_reference(torch.from_numpy(words.view(np.int32)),
                                     torch.from_numpy(ids)).numpy()
    # one jitted call compiles faster than the eager op-by-op dispatch
    jax_out = jax.jit(get_kernels("jnp").bitset_lookup)(words, ids)
    np.testing.assert_array_equal(want, np.asarray(jax_out))
    for (addr,) in group_addrs((4,)):
        out, writes = lookup_mirror(words, ids, addr)
        assert (writes == 1).all()
        np.testing.assert_array_equal(out.view(bool), want)


@pytest.mark.parametrize("n", GROUP_LENGTHS)
def test_candidate_filter_sixteen_a_thread(n):
    """Every output byte written once, at every start of each edge array;
    bit for bit `candidate_filter_reference` and the JAX package's
    ``"jnp"`` op. No edge failing ``root_ok`` reads its label, and none
    failing ``root_ok`` or the label test reads its id or bitset word; an
    aligned call reads nothing past the flags of an all-zero group."""
    jax = pytest.importorskip("jax")
    from repro.core.backend import get_kernels
    from repro_torch.kernels.bitset import ref as port_ref

    words, ids, labels, rok = group_case(n)
    label = n // GROUP % 3  # 0 at n = 1009: the flags, not v's zeros, gate a match
    want = port_ref.candidate_filter_reference(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ids),
        torch.from_numpy(labels), torch.from_numpy(rok != 0), label).numpy()
    jax_out = jax.jit(get_kernels("jnp").candidate_filter, static_argnums=4)(
        words, ids, labels, rok != 0, label)
    np.testing.assert_array_equal(want, np.asarray(jax_out))
    passed = (rok != 0) & (labels == label)
    for addrs in group_addrs((4, 4, 1)):
        out, writes, read = filter_mirror(words, ids, labels, rok, label, addrs)
        assert (writes == 1).all()
        np.testing.assert_array_equal(out.view(bool), want)
        assert not (read["label"] & (rok == 0)).any()
        assert not ((read["id"] | read["word"]) & ~passed).any()
        np.testing.assert_array_equal(read["word"] & ~bit_test(words, ids)[1], False)
        if not any(addrs):
            full = n // GROUP * GROUP
            empty = np.repeat((rok[:full].reshape(-1, GROUP) == 0).all(1), GROUP)
            assert not (read["label"][:full] & empty).any()


# ------------------------------------------------------------- bitset_unpack
UNPACK_SPANS = int(re.search(r"constexpr int kUnpackSpans = (\d+);", PACK_SRC)[1])


def unpack_mirror(words):
    """``csrc/bitset.cu``'s ``unpack_kernel`` in numpy: a lane per half word
    (one 2-byte load: bits 16h .. 16h + 15 of the little-endian words), its
    16 bools as one 16-byte ``bool_vector`` store at bytes 16h .. 16h + 15;
    warp w's lane t takes half words 32 · kUnpackSpans · w + 32i + t. Returns
    the output bytes, the writes of each, and each warp store's byte range
    (start, end) over its lanes in range."""
    halves = words.astype("<u4").view("<u2")
    n = halves.shape[0]
    out, writes = np.zeros(16 * n, np.uint8), np.zeros(16 * n, np.int64)
    spans = []
    n_warps = -(-n // (32 * UNPACK_SPANS))
    lanes = np.arange(32)
    for w in range(n_warps):
        for i in range(UNPACK_SPANS):
            h = 32 * UNPACK_SPANS * w + 32 * i + lanes
            h = h[h < n]
            if not h.size:
                continue
            vec = bool_vector(halves[h].astype(np.uint32))  # (lanes, 16)
            byte = 16 * h[:, None] + np.arange(16)
            out[byte] = vec
            writes[byte] += 1
            spans.append((int(byte.min()), int(byte.max()) + 1, h.size))
    return out, writes, spans


@pytest.mark.parametrize("W", [1, 7, 16, 17, 117_962])
def test_bitset_unpack_half_word_lanes(W):
    """Bit for bit `unpack_reference`; every byte written once; each warp
    store of 32 lanes covers 512 contiguous bytes starting on a 512-byte
    boundary (whole 32-byte sectors), a ragged last store fewer."""
    from repro_torch.kernels.bitset import ref as port_ref

    rng = np.random.default_rng(W)
    words = rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
    words[:1] = 0xFFFFFFFF
    want = port_ref.unpack_reference(torch.from_numpy(words.view(np.int32))).numpy()
    out, writes, spans = unpack_mirror(words)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out.view(bool), want)
    for start, end, lanes in spans:
        assert end - start == 16 * lanes and start % 512 == 0
        assert lanes == 32 or end == out.shape[0]
