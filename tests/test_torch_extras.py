"""The port's ``extras`` kernels' plain versions against the JAX package's
entry points on the CPU: ``segment_mp`` against
``repro.extras.segment_mp.ops.aggregate(use_pallas=False)``, the join
probe against ``repro.extras.join_probe.ops.lower_bound`` / ``window``
(``use_pallas=False``: the plain references, never interpret mode), and
flash attention's plain version against
``repro.extras.flash_attention.mha_reference`` (jnp).

The port's wrappers and entry points take CPU tensors to those plain
versions, so they are checked here too; the CUDA kernels are held to the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances: the join probe is integer and bool, equal bit for bit; the
segment sum is fp32 in another summation order, ``rtol=1e-5, atol=1e-5``
(sums of up to 600 unit normals); attention takes the JAX kernel test's
(``tests/test_kernels.py``): ``2e-5`` in fp32 and ``2e-2`` in bf16, both
absolute and relative.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.extras.flash_attention import mha_reference as jax_mha  # noqa: E402
from repro.extras.join_probe import ops as jax_probe  # noqa: E402
from repro.extras.segment_mp import ops as jax_segment  # noqa: E402
from repro_torch.core.backend import get_kernels  # noqa: E402
from repro_torch.extras.flash_attention import flash_attention  # noqa: E402
from repro_torch.extras.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.extras.flash_attention.ref import mha_reference  # noqa: E402
from repro_torch.extras.join_probe import join_probe, ops as probe_ops  # noqa: E402
from repro_torch.extras.join_probe import ref as probe_ref  # noqa: E402
from repro_torch.extras.segment_mp import ops as segment_ops  # noqa: E402
from repro_torch.extras.segment_mp import segment_mp  # noqa: E402
from repro_torch.extras.segment_mp.ref import segment_mp_reference  # noqa: E402


def t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


# ------------------------------------------------------------- segment_mp
def segment_case(name):
    """(messages, dst ascending, n_nodes) of a named case."""
    rng = np.random.default_rng(len(name))
    if name == "d1-degree-count":
        n, E, d = 50, 400, 1
        dst = rng.integers(0, n, E)
    elif name == "d70-empty-segments":
        n, E, d = 300, 500, 70
        dst = rng.choice(np.arange(0, n, 3), E)  # two nodes in three get no edge
    elif name == "hub":
        n, E, d = 40, 900, 64
        dst = np.where(rng.random(E) < 0.7, 17, rng.integers(0, n, E))  # 600+ in-edges
    elif name == "out-of-range-ids":
        n, E, d = 30, 300, 5
        dst = rng.integers(-5, n + 5, E)
        dst[:3] = [-(2**31), 2**31 - 1, n]
    elif name == "no-edges":
        n, E, d = 7, 0, 4
        dst = np.zeros(0, np.int64)
    else:
        raise KeyError(name)
    msg = rng.normal(size=(E, d)).astype(np.float32)
    return msg, np.sort(dst).astype(np.int32), n


SEGMENT_CASES = ["d1-degree-count", "d70-empty-segments", "hub", "out-of-range-ids",
                 "no-edges"]


@pytest.mark.parametrize("fn", [segment_mp_reference, segment_mp.segment_mp,
                                get_kernels("torch").segment_mp,
                                get_kernels("cuda").segment_mp,
                                lambda m, d, n: segment_ops.aggregate(m, d, n_nodes=n)],
                         ids=["ref", "wrapper", "torch-backend", "cuda-backend", "ops"])
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_mp_matches_jax(fn, case):
    msg, dst, n = segment_case(case)
    want = np.asarray(jax_segment.aggregate(msg, dst, n_nodes=n, use_pallas=False))
    got = fn(t(msg), t(dst), n)
    assert got.dtype == torch.float32 and got.shape == (n, msg.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_mp_plain_version_takes_any_order():
    msg, dst, n = segment_case("out-of-range-ids")
    perm = np.random.default_rng(0).permutation(len(dst))
    want = segment_mp_reference(t(msg), t(dst), n)
    got = segment_mp_reference(t(msg[perm]), t(dst[perm]), n)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_chunk_fills_the_card():
    """256 edges a chunk at the full-graph size, fewer for a small batch
    (so ~1M threads), never under 16."""
    assert segment_mp.chunk_for(61_859_140, 64) == 256
    assert segment_mp.chunk_for(168_960, 70) == 16
    assert segment_mp.chunk_for(10, 1) == 16
    c = segment_mp.chunk_for(5_000_000, 8)
    assert 16 <= c <= 256 and -(-5_000_000 // c) * 8 >= segment_mp.MIN_THREADS


# ------------------------------------------------------------- join_probe
def probe_case(name):
    """(ka ascending uint32, kb uint32, dup_cap) of a named case."""
    rng = np.random.default_rng(len(name))
    if name == "keys-past-2**31":
        ka = np.sort(rng.integers(0, 2**32, 64, dtype=np.uint64)).astype(np.uint32)
        ka[-4:] = 0xFFFFFFFF
        kb = np.concatenate([ka[::3], [0, 0xFFFFFFFF, 2**31, 2**31 - 1, 2**31 + 1]])
        kb = kb.astype(np.uint32)
        dup = 4
    elif name == "pow2-cap-full-run":
        # capA a power of two whose duplicate run fills the whole window
        ka = np.array([0, 5, 5, 5, 5, 5, 5, 9], np.uint32)
        kb = np.array([5, 9, 0, 4, 6, 10, 0xFFFFFFFF], np.uint32)
        dup = 6
    elif name == "dup-cap-past-capA":
        ka = np.array([3, 3, 7], np.uint32)
        kb = np.array([3, 7, 1, 8], np.uint32)
        dup = 5
    elif name == "random":
        ka = np.sort(rng.integers(0, 200, 256)).astype(np.uint32)
        kb = rng.integers(0, 210, 500).astype(np.uint32)
        dup = 8
    else:
        raise KeyError(name)
    return ka, kb, dup


PROBE_CASES = ["keys-past-2**31", "pow2-cap-full-run", "dup-cap-past-capA", "random"]


@pytest.mark.parametrize("case", PROBE_CASES)
@pytest.mark.parametrize("route", ["ops", "wrapper", "ops-plain"])
def test_join_probe_matches_jax(case, route):
    ka, kb, dup = probe_case(case)
    lo_want = np.asarray(jax_probe.lower_bound(ka, kb, use_pallas=False))
    hit_want, idx_want = map(np.asarray,
                             jax_probe.window(ka, kb, lo_want, dup_cap=dup, use_pallas=False))
    if route == "wrapper":
        lo = join_probe.probe_lower_bound(t(ka), t(kb))
        hit, idx = join_probe.probe_window(t(ka), t(kb), lo, dup_cap=dup)
    elif route == "ops":
        lo = probe_ops.lower_bound(t(ka), t(kb))
        hit, idx = probe_ops.window(t(ka), t(kb), lo, dup_cap=dup)
    else:  # the plain versions themselves
        lo = probe_ref.lower_bound_reference(t(ka), t(kb))
        hit, idx = probe_ref.window_reference(t(ka), t(kb), lo, dup_cap=dup)
    assert lo.dtype == torch.int32 and hit.dtype == torch.bool and idx.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), lo_want)
    np.testing.assert_array_equal(hit.numpy(), hit_want)
    np.testing.assert_array_equal(idx.numpy(), idx_want)
    if case == "pow2-cap-full-run":
        assert hit.numpy()[0].all()  # all six 5s found: the window is full


def test_wrappers_refuse_a_device_mix():
    ka = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        join_probe.probe_lower_bound(ka, torch.zeros(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        segment_mp.segment_mp(torch.zeros((2, 3)), torch.zeros(2, dtype=torch.int32,
                                                               device="meta"), 4)


# -------------------------------------------------------- flash_attention
# (b, s, nkv, g, h, dtype, window, softcap): every window × softcap of the
# JAX kernel test's grid, dtype alternating and G (1/2/4), H (32-128), kv
# heads and S (64-256) cycling; then gemma's head dim (256), a window of 1
# (the diagonal only) and one past S
FLASH_CASES = [
    ((1, 2)[i % 2], (64, 128, 256)[i % 3], (1, 2, 4)[i // 2], (1, 2, 4)[i % 3],
     (32, 64, 128)[(i + 1) % 3], ("float32", "bfloat16")[i % 2], window, softcap)
    for i, (window, softcap) in enumerate((w, c) for w in (None, 32, 100) for c in (None, 30.0))
] + [
    (1, 64, 1, 8, 256, "float32", None, None),
    (1, 64, 1, 8, 256, "bfloat16", 40, 30.0),
    (2, 64, 2, 2, 32, "float32", 1, None),
    (1, 128, 1, 4, 64, "bfloat16", 1, 30.0),
    (1, 64, 2, 2, 32, "float32", 500, None),
]


def _as_bf16_exact(x):
    """numpy fp32 values that bf16 holds exactly (both packages then see
    the same inputs)."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("b,s,nkv,g,h,dt,window,softcap", FLASH_CASES)
def test_mha_reference_matches_jax(b, s, nkv, g, h, dt, window, softcap):
    rng = np.random.default_rng(s * 31 + nkv * 7 + h)
    q, k, v = (_as_bf16_exact(rng.normal(size=shape)) for shape in
               ((b, s, nkv * g, h), (b, s, nkv, h), (b, s, nkv, h)))
    jfn = jax.jit(functools.partial(jax_mha, window=window, softcap=softcap))
    want = np.asarray(jfn(*(jnp.asarray(x, dt) for x in (q, k, v))).astype(jnp.float32))
    tdt = getattr(torch, dt)
    got = mha_reference(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), window=window,
                        softcap=softcap)
    assert got.dtype == tdt and got.shape == (b, s, nkv * g, h)
    tol = 2e-5 if dt == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", [mha_reference, flash_attention.flash_attention,
                                get_kernels("torch").flash_attention,
                                get_kernels("cuda").flash_attention, flash_ops.attention_fwd],
                         ids=["ref", "wrapper", "torch-backend", "cuda-backend", "ops"])
def test_flash_attention_routes_match_jax(fn):
    """Every CPU route to attention is the plain version; a given ``scale``
    is honoured."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((2, 96, 6, 40), (2, 96, 2, 40), (2, 96, 2, 24)))
    want = np.asarray(jax_mha(q, k, v, scale=0.3, window=20, softcap=30.0))
    got = fn(*map(torch.from_numpy, (q, k, v)), scale=0.3, window=20, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_flash_attention_wrapper_refuses_a_device_mix():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="several devices"):
        flash_attention.flash_attention(q, q[:, :, :1], torch.zeros((1, 4, 1, 8), device="meta"))
