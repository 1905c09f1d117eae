"""The port's plain kernel versions against the JAX package's ``"jnp"`` ops.

Inputs are made with numpy from a seed and handed to both packages; integer
and bool outputs must be bit-identical (words compared as uint32 views).
The cases are those of ``tests/test_backend.py`` plus the negative-id
``bitset_build`` case. On the CPU every CUDA wrapper runs its plain
version, so the wrappers are held here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.backend import get_kernels, n_words  # noqa: E402
from repro_torch.core.backend import get_kernels as port_kernels  # noqa: E402
from repro_torch.kernels.bitset import bitset as cuda_bitset  # noqa: E402
from repro_torch.kernels.hash_join.hash_join import hash_join_probe  # noqa: E402
from repro_torch.kernels.stwig_expand.stwig_expand import stwig_expand  # noqa: E402

JNP = get_kernels("jnp")
PORT = port_kernels("torch")
CUDA = port_kernels("cuda")  # CPU tensors: the wrappers run the plain versions


def t(x):
    """numpy → torch, uint32 words as their int32 bit patterns."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def same(port_out, jax_out):
    a = port_out.numpy()
    b = np.asarray(jax_out)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kern", [PORT, CUDA], ids=["torch", "cuda-wrapper"])
def test_bitset_pack(kern):
    rng = np.random.default_rng(0)
    mask = rng.random(128 * 32) < 0.4
    same(kern.bitset_pack(t(mask)), JNP.bitset_pack(jnp.asarray(mask)))


@pytest.mark.parametrize("kern", [PORT, CUDA], ids=["torch", "cuda-wrapper"])
def test_bitset_lookup_adversarial_ids(kern):
    rng = np.random.default_rng(1)
    W = 64
    words = rng.integers(0, 2**32, W, dtype=np.uint32)
    n_bits = W * 32
    ids = np.concatenate([
        rng.integers(0, n_bits, 256),
        [0, n_bits - 1, n_bits, n_bits + 31, -1, -32, -(2**31), 2**31 - 1],
    ]).astype(np.int32)
    got = kern.bitset_lookup(t(words), t(ids))
    same(got, JNP.bitset_lookup(jnp.asarray(words), jnp.asarray(ids)))
    oor = (ids < 0) | (ids >= n_bits)
    assert not got.numpy()[oor].any()


@pytest.mark.parametrize("kern", [PORT, CUDA], ids=["torch", "cuda-wrapper"])
@pytest.mark.parametrize("negative", [False, True], ids=["in-range", "negative-ids"])
def test_bitset_build(kern, negative):
    rng = np.random.default_rng(2)
    nwords = 32
    n_bits = nwords * 32
    lo = -2 * n_bits if negative else 0
    ids = rng.integers(lo, n_bits + (40 if negative else 0), 500).astype(np.int32)
    if negative:
        ids[:4] = [-1, -n_bits, -(2**31), 2**31 - 1]
    valid = rng.random(500) < 0.7
    valid[:4] = True
    got = kern.bitset_build(t(ids), t(valid), nwords)
    same(got, JNP.bitset_build(jnp.asarray(ids), jnp.asarray(valid), nwords))
    if negative:  # -1 wraps to the last bit; -n_bits wraps to bit 0
        from repro_torch.kernels.bitset.ref import unpack_bitset

        bits = unpack_bitset(got.numpy(), n_bits)
        assert bits[n_bits - 1] and bits[0]


@pytest.mark.parametrize("kern", [PORT, CUDA], ids=["torch", "cuda-wrapper"])
@pytest.mark.parametrize("width", [1, 3, 7])
def test_bitset_build_columns(kern, width):
    """A round's ``(n, width)`` columns in one call: each row of the result
    is the JAX package's ``bitset_build`` of that column, negative and
    out-of-range ids included."""
    rng = np.random.default_rng(20 + width)
    nwords = 16
    n_bits = nwords * 32
    ids = rng.integers(-2 * n_bits, n_bits + 40, (300, width)).astype(np.int32)
    ids[:4, 0] = [-1, -n_bits, -(2**31), 2**31 - 1]
    ids[4, :] = n_bits  # past the end in every column: dropped
    valid = rng.random(300) < 0.7
    valid[:5] = True
    got = kern.bitset_build(t(ids), t(valid), nwords)
    want = jnp.stack([JNP.bitset_build(jnp.asarray(ids[:, p]), jnp.asarray(valid), nwords)
                      for p in range(width)])
    same(got, want)
    for p in range(width):  # and the port's own 1-D call on the column
        same(kern.bitset_build(t(ids[:, p]), t(valid), nwords), want[p])


def _expand_inputs(rng, cap=41, E=160, n_total=300, child_cap=3, n_labels=4):
    src = np.sort(rng.integers(0, cap, E)).astype(np.int32)
    indptr = np.searchsorted(src, np.arange(cap + 2)).astype(np.int32)
    dst = rng.integers(0, n_total, E).astype(np.int32)
    labs = rng.integers(0, n_labels, E).astype(np.int32)
    rok = rng.random(E) < 0.8
    words = rng.integers(0, 2**32, (2, n_words(n_total + 1)), dtype=np.uint32)
    kw = dict(child_labels=(1, 2), child_bound=(True, False), child_cap=child_cap,
              cap=cap, n_total=n_total)
    return (words, dst, labs, indptr, rok), kw


def _segment_straddles_tiles():
    rng = np.random.default_rng(11)
    cap, n_total, E = 3, 400, 48
    src = np.concatenate([np.zeros(4, np.int32), np.full(E - 8, 1, np.int32),
                          np.full(4, 2, np.int32)])
    indptr = np.searchsorted(src, np.arange(cap + 2)).astype(np.int32)
    dst = rng.integers(0, n_total, E).astype(np.int32)
    labs = rng.integers(0, 2, E).astype(np.int32)
    words = rng.integers(0, 2**32, (2, n_words(n_total + 1)), dtype=np.uint32)
    kw = dict(child_labels=(1, 0), child_bound=(True, False), child_cap=6,
              cap=cap, n_total=n_total)
    return (words, dst, labs, indptr, np.ones(E, bool)), kw


def _counts_past_child_cap():
    E, cap, n_total = 64, 5, 100
    indptr = np.zeros(cap + 2, np.int32)
    indptr[1:] = E
    words = np.full((2, n_words(n_total + 1)), 0xFFFFFFFF, np.uint32)
    kw = dict(child_labels=(1, 1), child_bound=(True, False), child_cap=3,
              cap=cap, n_total=n_total)
    return (words, np.arange(E, dtype=np.int32), np.full(E, 1, np.int32), indptr,
            np.ones(E, bool)), kw


EXPAND_CASES = {
    "seed0": lambda: _expand_inputs(np.random.default_rng(0)),
    "seed1": lambda: _expand_inputs(np.random.default_rng(1)),
    "counts-past-child-cap": _counts_past_child_cap,
    "segment-straddles-tiles": _segment_straddles_tiles,
    "E128-pow2": lambda: _expand_inputs(np.random.default_rng(17), E=128),
    "E160-non-pow2": lambda: _expand_inputs(np.random.default_rng(17), E=160),
    "E127-prime": lambda: _expand_inputs(np.random.default_rng(17), E=127),
}


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_stwig_expand(case):
    args, kw = EXPAND_CASES[case]()
    # one jitted call compiles faster than the eager op-by-op dispatch
    ref = jax.jit(lambda *a: JNP.stwig_expand(*a, **kw))
    cj, nj = ref(*(jnp.asarray(a) for a in args))
    for fn in (PORT.stwig_expand, stwig_expand):
        cp, np_ = fn(*(t(a) for a in args), **kw)
        same(cp, cj)
        same(np_, nj)
    if case == "counts-past-child-cap":
        assert (np_.numpy()[:, 0] == 64).all()  # exact, not clamped


def _probe_cases():
    rng = np.random.default_rng(5)
    capA, capB, nk = 128, 96, 2
    ka = np.sort(rng.integers(0, 40, capA)).astype(np.uint32)
    rand = (ka, rng.integers(0, 9, (capA, nk)).astype(np.int32), rng.random(capA) < 0.8,
            rng.integers(0, 40, capB).astype(np.uint32),
            rng.integers(0, 9, (capB, nk)).astype(np.int32), rng.random(capB) < 0.8)
    pow2 = (np.array([0, 5, 5, 5, 5, 5, 5, 9], np.uint32), np.full((8, 1), 5, np.int32),
            np.ones(8, bool), np.array([5], np.uint32), np.array([[5]], np.int32),
            np.ones(1, bool))
    # keys above 2**31 must order as unsigned values
    big = np.sort(rng.integers(0, 2**32, 64, dtype=np.uint64)).astype(np.uint32)
    big[-3:] = 0xFFFFFFFF
    hi = (big, rng.integers(0, 3, (64, 1)).astype(np.int32), rng.random(64) < 0.9,
          np.concatenate([big[::3], [0, 0xFFFFFFFF, 2**31]]).astype(np.uint32),
          rng.integers(0, 3, (25, 1)).astype(np.int32), np.ones(25, bool))
    return {"random": (rand, 8), "pow2-run-start": (pow2, 6), "unsigned-keys": (hi, 4)}


@pytest.mark.parametrize("case", ["random", "pow2-run-start", "unsigned-keys"])
def test_hash_join_probe(case):
    args, dup = _probe_cases()[case]
    ref = jax.jit(lambda *a: JNP.hash_join_probe(*a, dup_cap=dup))
    hj, ij = ref(*(jnp.asarray(a) for a in args))
    for fn in (PORT.hash_join_probe, hash_join_probe):
        hp, ip = fn(*(t(a) for a in args), dup_cap=dup)
        same(hp, hj)
        same(ip, ij)
    if case == "pow2-run-start":
        assert hp.numpy().sum() == 6 and ip.numpy()[0, 0] == 1


UNPACK_CASES = {
    "W1": lambda rng: rng.integers(0, 2**32, 1, dtype=np.uint32),
    "W37-non-pow2": lambda rng: rng.integers(0, 2**32, 37, dtype=np.uint32),
    "W64-pow2": lambda rng: rng.integers(0, 2**32, 64, dtype=np.uint32),
    "all-false": lambda rng: np.zeros(13, np.uint32),
    "all-true": lambda rng: np.full(13, 0xFFFFFFFF, np.uint32),
}


@pytest.mark.parametrize("kern", [PORT, CUDA], ids=["torch", "cuda-wrapper"])
@pytest.mark.parametrize("case", sorted(UNPACK_CASES))
def test_bitset_unpack(kern, case):
    words = UNPACK_CASES[case](np.random.default_rng(6))
    same(kern.bitset_unpack(t(words)), JNP.bitset_unpack(jnp.asarray(words)))


def _filter_inputs(rng, W, E, fill=None):
    n_bits = W * 32
    words = (rng.integers(0, 2**32, W, dtype=np.uint32) if fill is None
             else np.full(W, fill, np.uint32))
    dst = rng.integers(-40, n_bits + 40, E).astype(np.int32)
    dst[:6] = [-1, n_bits, n_bits - 1, 0, -(2**31), 2**31 - 1]
    labs = rng.integers(0, 3, E).astype(np.int32)
    labs[:6] = 1
    rok = rng.random(E) < 0.8
    rok[:6] = True
    return words, dst, labs, rok


FILTER_CASES = {
    "W37-E997-prime": lambda rng: _filter_inputs(rng, 37, 997),
    "W64-E1024-pow2": lambda rng: _filter_inputs(rng, 64, 1024),
    "all-false-words": lambda rng: _filter_inputs(rng, 9, 211, fill=0),
    "all-true-words": lambda rng: _filter_inputs(rng, 9, 211, fill=0xFFFFFFFF),
}


@pytest.mark.parametrize("kern", [PORT, CUDA], ids=["torch", "cuda-wrapper"])
@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_candidate_filter(kern, case):
    words, dst, labs, rok = FILTER_CASES[case](np.random.default_rng(7))
    got = kern.candidate_filter(t(words), t(dst), t(labs), t(rok), 1)
    same(got, JNP.candidate_filter(jnp.asarray(words), jnp.asarray(dst), jnp.asarray(labs),
                                   jnp.asarray(rok), 1))
    oor = (dst < 0) | (dst >= words.shape[0] * 32)
    assert not got.numpy()[oor].any()  # an id outside the bitset is no member
    if case == "all-true-words":
        np.testing.assert_array_equal(got.numpy(), rok & (labs == 1) & ~oor)


def test_op_contracts_are_the_references():
    from repro.core.backend import OP_CONTRACTS as JAX_CONTRACTS
    from repro_torch.core.backend import OP_CONTRACTS

    want = {c.op: tuple("int32" if d == "uint32" else d for d in c.out_dtypes)
            for c in JAX_CONTRACTS}
    # the port's two ops more: segment_mp and flash_attention, its wiring of
    # repro.extras.segment_mp and repro.extras.flash_attention
    want["segment_mp"] = ("float32",)
    want["flash_attention"] = ("float32",)
    got = {c.op: tuple(str(d).removeprefix("torch.") for d in c.out_dtypes)
           for c in OP_CONTRACTS}
    assert got == want


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_every_op_returns_its_contract_dtypes(backend):
    from repro_torch.core.backend import CudaKernels, op_contracts

    kern = port_kernels(backend)
    for c in op_contracts(backend):
        if backend == "cuda":  # every op goes to a kernel wrapper
            assert c.op in vars(CudaKernels), c.op
        args, kw = c.make_args(torch.device("cpu"))
        out = getattr(kern, c.op)(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        assert tuple(o.dtype for o in outs) == c.out_dtypes, c.op
    with pytest.raises(ValueError, match="unknown kernel backend"):
        op_contracts("jnp")


def test_numpy_helpers_match_reference():
    from repro.kernels.bitset import ref as jref
    from repro_torch.kernels.bitset import ref as tref

    rng = np.random.default_rng(4)
    for n in (1, 31, 32, 1000):
        mask = rng.random(n) < 0.5
        words = tref.pack_bitset(mask)
        np.testing.assert_array_equal(words, jref.pack_bitset(mask))
        np.testing.assert_array_equal(tref.unpack_bitset(words, n), jref.unpack_bitset(words, n))
        ids = rng.integers(0, n, 50)
        np.testing.assert_array_equal(tref.bitset_test_np(words, ids),
                                      jref.bitset_test_np(words, ids))
        assert tref.n_words(n) == jref.n_words(n)
    # the byte-wise unpack against the JAX package's 32-lane one, on random
    # words whose bits past n are set, as int32 and as uint32 words
    for n in (0, 33, 786_432):
        words = rng.integers(0, 2**32, tref.n_words(n) + 1, dtype=np.uint32)
        want = jref.unpack_bitset(words, n)
        assert want.shape == (n,) and (n == 0 or words[-1] != 0)
        for w in (words, words.view(np.int32)):
            got = tref.unpack_bitset(w, n)
            assert got.dtype == np.bool_
            np.testing.assert_array_equal(got, want)


def test_mask_to_host_round_trips_any_length():
    rng = np.random.default_rng(3)
    for n in (0, 1, 31, 32, 33, 1000):
        mask = rng.random(n) < 0.5
        np.testing.assert_array_equal(PORT.mask_to_host(torch.from_numpy(mask)), mask)


def test_cuda_wrapper_refuses_mixed_devices():
    words = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        cuda_bitset.bitset_lookup(words, torch.zeros(3, dtype=torch.int32, device="meta"))
