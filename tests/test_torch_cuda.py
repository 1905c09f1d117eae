"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and ``nvcc``; without a card they skip. On a
GPU machine run them with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

They import no JAX: the plain versions are themselves held to the JAX
package by ``tests/test_torch_ops.py`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.backend import get_kernels  # noqa: E402
from repro_torch.kernels import cuda  # noqa: E402
from repro_torch.kernels.bitset.ref import n_words  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def on(dev, x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def same(op, args, kw=None):
    kw = kw or {}
    before = cuda.launch_counts()[op]
    got = getattr(get_kernels("cuda"), op)(*args, **kw)
    want = getattr(get_kernels("torch"), op)(*args, **kw)
    torch.cuda.synchronize()
    assert cuda.launch_counts()[op] == before + 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_build_reports_every_source(dev):
    cuda.build()  # nothing left to build after the first call
    for name in cuda.SOURCES:
        assert cuda.load(name) is not None


def boundary_ids(ids, W):
    """-1, 32·W and 2^31 - 1 on group boundaries of sixteen (the last and
    first element of a group), where they fit."""
    for i, x in zip((0, 15, 16, 31, 32, 47, ids.shape[0] - 1),
                    (2**31 - 1, -1, 32 * W, 2**31 - 1, -1, 32 * W, 2**31 - 1)):
        if i < ids.shape[0]:
            ids[i] = x
    return ids


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 1 << 20, 1_000_008])
def test_bitset_lookup(dev, n):
    """Sixteen ids a thread: whole groups, a ragged tail (1,000,008 ends 8
    past a group, as the main path's edge count does), ids out of range on
    group boundaries."""
    rng = np.random.default_rng(n)
    W = 4096
    ids = boundary_ids(rng.integers(-100, W * 32 + 100, n).astype(np.int32), W)
    same("bitset_lookup", (on(dev, rng.integers(0, 2**32, W, dtype=np.uint32)), on(dev, ids)))


@pytest.mark.parametrize("off", range(1, 16))
def test_bitset_lookup_unaligned_start(dev, off):
    """ids that start 1-15 elements past a 16-byte boundary (a slice):
    the element-by-element path in the kernel."""
    rng = np.random.default_rng(off)
    W = 64
    base = on(dev, boundary_ids(rng.integers(-100, W * 32 + 100, 1100).astype(np.int32), W))
    words = on(dev, rng.integers(0, 2**32, W, dtype=np.uint32))
    for n in (15, 17, 1000):
        same("bitset_lookup", (words, base[off:off + n]))


@pytest.mark.parametrize("width", [0, 1, 2, 7], ids=["1-D", "w1", "w2", "w7"])
@pytest.mark.parametrize("n", [5, 500, 1 << 18])
def test_bitset_build_with_negative_ids(dev, n, width):
    """1-D ids, and a round's (n, width) columns built in one launch."""
    rng = np.random.default_rng(n)
    nwords = 1024
    shape = (n, width) if width else (n,)
    ids = rng.integers(-2 * nwords * 32, nwords * 32 + 50, shape).astype(np.int32)
    ids.reshape(-1)[:2] = [-1, -(2**31)]
    same("bitset_build", (on(dev, ids), on(dev, rng.random(n) < 0.7), nwords))


@pytest.mark.parametrize("n_words_", [1, 7, 4096])
def test_bitset_pack(dev, n_words_):
    rng = np.random.default_rng(n_words_)
    same("bitset_pack", (on(dev, rng.random(32 * n_words_) < 0.4),))


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4097, 786_427])
def test_bitset_pack_ragged_through_mask_to_host(dev, n):
    """The kernel's ragged tail, reached through ``mask_to_host``: one
    launch, the host bools equal to the mask, the words bit-exact against
    the plain version of the zero-padded mask."""
    from repro_torch.kernels.bitset import bitset, ref

    mask = on(dev, np.random.default_rng(n).random(n) < 0.4)
    before = cuda.launch_counts()["bitset_pack"]
    host = get_kernels("cuda").mask_to_host(mask)
    assert cuda.launch_counts()["bitset_pack"] == before + 1
    np.testing.assert_array_equal(host, mask.cpu().numpy())
    assert torch.equal(bitset.pack_flags(mask), ref.pack_padded_reference(mask))


@pytest.mark.parametrize("off", [1, 3, 4, 8])
def test_bitset_pack_unaligned_start(dev, off):
    """A mask whose data start off 16-byte alignment (a slice): whole words
    through the op, a ragged length through ``mask_to_host``."""
    base = on(dev, np.random.default_rng(off).random(4096 + 64) < 0.4)
    assert base[off:].data_ptr() % 16 != 0
    same("bitset_pack", (base[off:off + 4096],))
    np.testing.assert_array_equal(get_kernels("cuda").mask_to_host(base[off:off + 1001]),
                                  base[off:off + 1001].cpu().numpy())


def straddle(lab, rok, indptr, r, C, label):
    """Make row ``r``'s survivors for ``label`` straddle the first tile
    boundary inside it at ranks C-1 | C: no survivor before the C edges
    that end the tile, the next edge a survivor too. Row r's edge e is item
    r + e of the merged sequence (e_begin = 0)."""
    from repro_torch.kernels.stwig_expand.stwig_expand import TILE

    first = -(-(r + int(indptr[r])) // TILE) * TILE - r  # the next tile's first edge
    assert indptr[r] <= first - C and first < indptr[r + 1]
    lab[indptr[r]:first - C] = 3  # no child's label
    lab[first - C:first + 1] = label
    rok[first - C:first + 1] = True


@pytest.mark.parametrize("k,C,max_deg", [(1, 3, 5), (3, 8, 200), (5, 4, 3000),
                                         (16, 1, 60_000), (4, 8, 60_000)])
def test_stwig_expand(dev, k, C, max_deg):
    """Random rows with a pad tail owned by the ghost row; the skewed cases
    (max_deg 60,000) add a row of 60,000 edges over ~30 tiles, a run of
    10,000 empty rows and survivors straddling a tile boundary at C-1 | C."""
    rng = np.random.default_rng(k)
    cap, n_total = 500, 20000
    deg = rng.integers(0, min(max_deg, 3000), cap)
    deg[7] = max_deg  # one long segment: counts past C
    if max_deg > 3000:
        deg = np.concatenate([deg[:100], np.zeros(10_000, deg.dtype), deg[100:]])
        cap = len(deg)
    E = int(deg.sum()) + 13  # a pad tail owned by the ghost row
    indptr = np.concatenate([[0], np.cumsum(deg), [E]]).astype(np.int32)
    labels = tuple(int(x) for x in rng.integers(0, 3, k))
    words = rng.integers(0, 2**32, (k, n_words(n_total + 1)), dtype=np.uint32)
    dst = rng.integers(0, n_total, E).astype(np.int32)
    lab = rng.integers(0, 3, E).astype(np.int32)
    rok = rng.random(E) < 0.9
    if max_deg > 3000:
        straddle(lab, rok, indptr, 7, C, labels[0])
    same("stwig_expand", (on(dev, words), on(dev, dst), on(dev, lab), on(dev, indptr),
                          on(dev, rok)),
         dict(child_labels=labels, child_bound=tuple(bool(i % 2) for i in range(k)),
              child_cap=C, cap=cap, n_total=n_total))


def probe_inputs(dev, cap_a, cap_b, nk, seed):
    """A sorted build side with duplicate runs (its last key 0xFFFFFFFF) and
    probe keys drawn from it, about 10% of rows invalid on each side."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 2**32, cap_a, dtype=np.uint64) % (cap_a // 2 + 1) * 977)
    ka = keys.astype(np.uint32)
    ka[-1] = 0xFFFFFFFF
    kb = np.concatenate([ka[rng.integers(0, cap_a, cap_b - 1)], [0xFFFFFFFF]]).astype(np.uint32)
    return (on(dev, ka), on(dev, rng.integers(0, 2, (cap_a, nk)).astype(np.int32)),
            on(dev, rng.random(cap_a) < 0.9), on(dev, kb),
            on(dev, rng.integers(0, 2, (cap_b, nk)).astype(np.int32)),
            on(dev, rng.random(cap_b) < 0.9))


# (capA, capB, nk, dup_cap, route): the build side's capA * (5 + 4 nk) bytes
# against the 102,400-byte budget, the route as the C entry point recorded
# it; capB mostly not a multiple of the kernel's 512-row tile; dup_cap not a
# multiple of 16, and above capA
@pytest.mark.parametrize("cap_a,cap_b,nk,dup,route", [
    (8, 1, 1, 6, "shared"), (1000, 3000, 2, 16, "shared"), (1 << 16, 1 << 14, 3, 64, "global"),
    (8192, 262_144, 1, 64, "shared"),   # the matcher's largest join
    (4096, 1000, 5, 5, "shared"),       # exactly at the budget
    (4097, 1000, 5, 5, "global"),       # one row above it
    (8192, 777, 1, 1, "shared"), (20_000, 3001, 1, 100, "global"), (5, 300, 3, 100, "shared"),
    # the store pieces probe_window shares (csrc/probe.cuh), on both routes
    (8192, 16_387, 1, 17, "shared"), (20_000, 16_387, 1, 67, "global"),
    (4096, 1, 5, 15, "shared"), (1 << 15, 1, 1, 15, "global"),
])
def test_hash_join_probe(dev, cap_a, cap_b, nk, dup, route):
    from repro_torch.kernels.hash_join import hash_join

    same("hash_join_probe", probe_inputs(dev, cap_a, cap_b, nk, cap_a), dict(dup_cap=dup))
    assert hash_join.last_route() == route


@pytest.mark.parametrize("W", [1, 7, 16, 17, 64, 117962])
def test_bitset_unpack(dev, W):
    """Words whose half-word lanes end inside a warp's 512-byte span (W 1,
    7, 17), fill one (16) and spill into a second warp's (64)."""
    rng = np.random.default_rng(W)
    words = rng.integers(0, 2**32, W, dtype=np.uint32)
    words[:1] = 0xFFFFFFFF
    same("bitset_unpack", (on(dev, words),))


@pytest.mark.parametrize("off", [1, 3])
def test_bitset_unpack_unaligned_start(dev, off):
    """A slice of words that starts at an odd word (4 bytes past a 16-byte
    boundary, or 12): its half words are 2-byte aligned all the same."""
    rng = np.random.default_rng(off)
    words = on(dev, rng.integers(0, 2**32, 1000, dtype=np.uint32))[off:off + 517]
    assert words.data_ptr() % 16
    same("bitset_unpack", (words,))


def filter_inputs(E, root_ok="random", W=37, seed=None):
    """numpy words, dst ids (out of range on group boundaries too), labels
    of three values, and ``root_ok``: random (80%), all false, all true, or
    on about one edge in 418 clustered by source (whole rows of ~1-40
    edges, as on the main path)."""
    rng = np.random.default_rng(E if seed is None else seed)
    dst = boundary_ids(rng.integers(-50, W * 32 + 50, E).astype(np.int32), W)
    if root_ok == "random":
        rok = rng.random(E) < 0.8
    elif root_ok == "clustered":
        rok = np.repeat(rng.random(E) < 1 / 418, rng.integers(1, 41, E))[:E]
        rok |= np.arange(E) == E // 2  # at least one flag
    else:
        rok = np.full(E, root_ok == "all")
    return (rng.integers(0, 2**32, W, dtype=np.uint32), dst,
            rng.integers(0, 3, E).astype(np.int32), rok)


@pytest.mark.parametrize("E", [1, 15, 16, 17, 997, 1 << 20, 1_000_008])
def test_candidate_filter(dev, E):
    """Sixteen edges a thread: whole groups, a ragged tail (1,000,008 ends
    8 past a group, as the main path's 32,492,392 edges do), ids out of
    range on group boundaries."""
    same("candidate_filter", tuple(on(dev, x) for x in filter_inputs(E)) + (2,))


@pytest.mark.parametrize("root_ok", ["none", "all", "clustered"])
@pytest.mark.parametrize("E", [17, 1_000_008])
def test_candidate_filter_root_ok(dev, E, root_ok):
    """``root_ok`` all false (every group skipped after its flags), all
    true (labels and ids as 16-byte vectors), and sparse in runs by source
    as on the main path; for each label, and with every label the child's."""
    words, dst, lab, rok = (on(dev, x) for x in filter_inputs(E, root_ok))
    for label in (0, 1, 2):
        same("candidate_filter", (words, dst, lab, rok, label))
    same("candidate_filter", (words, dst, torch.full_like(lab, 2), rok, 2))


@pytest.mark.parametrize("off", range(1, 16))
@pytest.mark.parametrize("which", ["dst_ids", "dst_labels", "root_ok", "all"])
def test_candidate_filter_unaligned_start(dev, which, off):
    """Each edge array in turn, then all three, starting 1-15 elements into
    a 16-byte aligned buffer (a slice): the element-by-element path, except
    where an int32 array's start lands on a boundary again (4, 8, 12)."""
    words, dst, lab, rok = (on(dev, x) for x in filter_inputs(1100, "all", seed=off))
    lab = torch.where(lab == 0, 2, lab)  # most edges pass root_ok and the label test
    for n in (15, 17, 1000):
        edges = [x[off:off + n] if which in (name, "all") else x[:n]
                 for name, x in (("dst_ids", dst), ("dst_labels", lab), ("root_ok", rok))]
        assert [x.data_ptr() % 16 for x in edges] == [
            off * x.element_size() % 16 if which in (name, "all") else 0
            for name, x in zip(("dst_ids", "dst_labels", "root_ok"), edges)]
        same("candidate_filter", (words, *edges, 2))


@pytest.mark.parametrize("B,H,m,d,Hp", [(3, 5, 4, 6, 7), (512, 39, 39, 10, 200),
                                        (64, 200, 39, 10, 200), (5, 3, 70, 1, 130),
                                        (50, 7, 13, 3, 300),      # H' over 256: two blocks of H'
                                        (700, 10, 9, 1, 64),      # d = 1
                                        (3999, 20, 39, 10, 200),  # one part of h, N ragged
                                        (61, 200, 39, 10, 200),   # h in parts, N ragged
                                        (40, 9, 104, 2, 12),      # 104 fields, h in parts
                                        (9, 4, 300, 2, 12),       # x0 in chunks 280 + 20
                                        (3000, 3, 289, 3, 20),    # chunks 280 + 9, h in 3
                                        (8448, 2, 300, 1, 16)])   # chunks, one part (132 SMs)
def test_cin_layer(dev, B, H, m, d, Hp):
    """Split TF32 on the tensor cores (fp32-level accuracy) over up to H·m
    terms in another order: held to ``max|kernel - plain| <= 1e-4 ·
    max|plain|`` with TF32 off for the plain version. The h range is split
    as `splits` chooses on this card (its parts added in a fixed order: a
    second run gives the same bits); x0 is staged 280 fields at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(B + H)
    args = (on(dev, rng.normal(size=(B, H, d)).astype(np.float32)),
            on(dev, rng.normal(size=(B, m, d)).astype(np.float32)),
            on(dev, rng.normal(size=(H * m, Hp)).astype(np.float32)))
    before = cuda.launch_counts()["cin_layer"]
    got = get_kernels("cuda").cin_layer(*args)
    want = get_kernels("torch").cin_layer(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["cin_layer"] == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(got, get_kernels("cuda").cin_layer(*args))


def test_xdeepfm_on_card_matches_the_cpu(dev):
    from repro_torch.configs import xdeepfm
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.models.recsys import XDeepFM
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = xdeepfm.smoke()
    gpu = XDeepFM(cfg, device=dev)
    cpu = XDeepFM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    assert gpu.kernels.name == "cuda" and cpu.kernels.name == "torch"
    batch = recsys_batch(cfg, 300, seed=0, step=0)
    got = make_serve_fns(cfg, gpu)["score"](batch["ids"], batch["bag_mask"]).cpu()
    want = make_serve_fns(cfg, cpu)["score"](batch["ids"], batch["bag_mask"])
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    words = torch.zeros(8, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        get_kernels("cuda").bitset_lookup(words, torch.zeros(4, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="whole number of words"):
        get_kernels("cuda").bitset_pack(torch.zeros(33, dtype=torch.bool, device=dev))
    x = torch.zeros(2, 3, 4, device=dev)
    with pytest.raises(ValueError, match="H·m"):
        get_kernels("cuda").cin_layer(x, x, torch.zeros(6, 5, device=dev))
    with pytest.raises(ValueError, match="float32"):
        get_kernels("cuda").cin_layer(x.double(), x, torch.zeros(9, 5, device=dev))


def test_session_rows_equal_on_cpu_and_card(dev):
    from repro_torch.api import GraphSession
    from repro_torch.graphstore import generators
    from repro_torch.workloads import dfs_query

    g = generators.rmat(1500, 6000, 12, seed=3)
    s_cpu, s_gpu = GraphSession.open(g, device="cpu"), GraphSession.open(g, device=dev)
    assert s_gpu.kernels.name == "cuda"
    rng = np.random.default_rng(0)
    n = 0
    while n < 4:
        q = dfs_query(g, rng, 4)
        if q is None:
            continue
        n += 1
        a, b = s_cpu.run(q, max_matches=0), s_gpu.run(q, max_matches=0)
        assert a.complete == b.complete and np.array_equal(a.rows, b.rows)
        pa = [p.rows for p in s_cpu.stream(q, page_size=50, block_rows=64)]
        pb = [p.rows for p in s_gpu.stream(q, page_size=50, block_rows=64)]
        assert len(pa) == len(pb) and all(np.array_equal(x, y) for x, y in zip(pa, pb))


def test_served_workload_on_card_equals_the_cpu(dev):
    """The continuous-batching server at its defaults (8 in flight, blocks
    of 512 rows, first 1,024 matches) on a mixed workload: per query the
    card's status, rows (in order) and counters are the CPU's, through the
    matcher's kernels, and no query fails."""
    from repro_torch.api import GraphSession
    from repro_torch.graphstore import generators
    from repro_torch.workloads import mixed_workload

    g = generators.rmat(1500, 6000, 12, seed=3)
    qs = mixed_workload(g, 10, n_labels=12, rng=np.random.default_rng(0))
    s_cpu, s_gpu = GraphSession.open(g, device="cpu"), GraphSession.open(g, device=dev)
    want_server = s_cpu.serve()
    want = want_server.serve(qs)
    cuda.reset_launch_counts()
    got_server = s_gpu.serve()
    got = got_server.serve(qs)
    counts = cuda.launch_counts()
    for op in ("stwig_expand", "bitset_build", "bitset_lookup", "bitset_pack"):
        assert counts[op] > 0, op
    assert got_server.stats.as_dict() == want_server.stats.as_dict()
    assert got_server.stats.failed == 0 and got_server.stats.global_degradations == 0
    for a, b in zip(got, want):
        assert (a.status, a.error, a.stats.degrade_reason) == (b.status, b.error,
                                                               b.stats.degrade_reason)
        assert np.array_equal(a.rows, b.rows)
    # the scheduler thread launches the same kernels and gives the same rows
    with s_gpu.serve() as server:
        tickets = [server.submit(q) for q in qs]
        threaded = [t.result(timeout=600) for t in tickets]
    assert all(np.array_equal(a.rows, b.rows) for a, b in zip(threaded, got))


def test_chaos_session_on_card_runs_the_matcher_kernels(dev, monkeypatch):
    """``chaos=`` on the card wraps the CUDA kernels (``"chaos(cuda)"``):
    the matcher's kernels launch, and masks reach the host through
    `CudaKernels.mask_to_host`, not the plain version."""
    from repro_torch.api import GraphSession
    from repro_torch.core.backend import CudaKernels
    from repro_torch.graphstore import generators
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.runtime import ChaosConfig, ChaosInjector, RetryPolicy
    from repro_torch.workloads import dfs_query, path_query

    unpacked = []
    original = CudaKernels.mask_to_host

    def counted(self, mask):
        unpacked.append(mask.device.type)
        return original(self, mask)

    monkeypatch.setattr(CudaKernels, "mask_to_host", counted)
    g = generators.rmat(1500, 6000, 12, seed=3)
    rng = np.random.default_rng(2)
    qs = []
    while len(qs) < 3:
        q = dfs_query(g, rng, 4) if len(qs) < 2 else path_query(g, rng, 4)
        if q is not None:
            qs.append(q)
    for target, cfg in ((g, ChaosConfig(seed=0, slow_shard=0, slow_delay_s=0.001)),
                        (PartitionedGraph.build(g, 4), ChaosConfig(seed=0, dead_shard=1))):
        inj = ChaosInjector(cfg)
        s = GraphSession.open(target, device=dev, chaos=inj)
        clean = GraphSession.open(target, device=dev)
        assert s.kernels.name == "chaos(cuda)"
        wants = [clean.run(q, max_matches=0) for q in qs]
        unpacked.clear()
        cuda.reset_launch_counts()
        for q, want in zip(qs, wants):
            res = s.run(q, max_matches=0, retry_policy=RetryPolicy(fetch_backoff_s=0.0))
            assert set(map(tuple, res.rows.tolist())) <= set(map(tuple, want.rows.tolist()))
            if s.backend == "local":
                assert np.array_equal(res.rows, want.rows)
            else:
                assert res.stats.shard_health[1] == "dead" and not res.complete
        counts = cuda.launch_counts()
        for op in ("stwig_expand", "bitset_build", "bitset_lookup", "bitset_pack"):
            assert counts[op] > 0, (s.backend, op)
        assert set(unpacked) == {dev.type}
        assert len(unpacked) == inj.op_calls["mask_to_host"] > 0


@pytest.mark.parametrize("graph,S,mode,use_ring", [
    (("rmat", 1500, 6000, 12, 3), 4, "hash", False),
    (("ring_of_cliques", 60, 6, 4, 2), 8, "range", True),
], ids=["rmat-4-hash", "ring-8-range-ring"])
def test_sharded_rows_equal_with_cuda_and_torch_kernels(dev, graph, S, mode, use_ring):
    """The sharded engine on the card: its shards' global ids run through
    the matcher's kernels, which must give the plain versions' bits."""
    from repro_torch.api import GraphSession
    from repro_torch.graphstore import generators
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.workloads import dfs_query, path_query

    kind, *args, seed = graph
    g = getattr(generators, kind)(*args, seed=seed)
    pg = PartitionedGraph.build(g, S, mode=mode)
    s_cuda = GraphSession.open(pg, device=dev)
    s_torch = GraphSession.open(pg, device=dev, kernels="torch")
    assert (s_cuda.backend, s_cuda.kernels.name) == ("sharded", "cuda")
    rng = np.random.default_rng(1)
    if use_ring:  # the range-partitioned ring takes the ring fetch
        q = None
        while q is None:
            q = path_query(g, rng, 4)
        plan = s_cuda.compile(q).plan
        assert s_cuda.engine.ring_radii_for(s_cuda.engine._load_masks(q, plan)[0]) is not None
    n = 0
    cuda.reset_launch_counts()
    while n < 4:
        q = dfs_query(g, rng, 4) if n < 3 else path_query(g, rng, 4)
        if q is None:
            continue
        n += 1
        a = s_torch.compile(q, max_matches=0).run(use_ring=use_ring)
        b = s_cuda.compile(q, max_matches=0).run(use_ring=use_ring)
        assert a.complete == b.complete and np.array_equal(a.rows, b.rows)
        kw = dict(page_size=50, block_rows=64, engine_kw={"use_ring": use_ring})
        pa = [p.rows for p in s_torch.stream(q, **kw)]
        pb = [p.rows for p in s_cuda.stream(q, **kw)]
        assert len(pa) == len(pb) and all(np.array_equal(x, y) for x, y in zip(pa, pb))
    counts = cuda.launch_counts()
    for op in ("stwig_expand", "bitset_build", "bitset_pack", "hash_join_probe"):
        assert counts[op] > 0, op


@pytest.mark.parametrize("E,d,n,hub", [(0, 4, 7, False), (1, 1, 3, False), (997, 1, 50, False),
                                       (5000, 70, 300, False), (200_000, 64, 4000, True),
                                       (168_960, 70, 169_984, False)])
def test_segment_mp(dev, E, d, n, hub):
    """fp32 sums in another order (and atomics in run-dependent order at
    chunk edges, as the plain ``index_add_`` has too): each element held to
    ``1e-4 ·`` the segment sum of its ``|messages|`` — the hub sums 100,000
    unit normals, and each order is ~sqrt(n)·eps of that off the exact sum;
    so a node of any degree is held to its own scale, and a node with no
    in-range edge must be exactly zero."""
    from repro_torch.extras.segment_mp import ops
    from repro_torch.extras.segment_mp.ref import segment_mp_reference

    rng = np.random.default_rng(E + d)
    dst = rng.integers(-3, n + 3, E)
    if hub:  # an R-MAT-like hub spread over many chunks
        dst[rng.random(E) < 0.5] = n // 2
    dst = np.sort(dst).astype(np.int32)
    msg = rng.normal(size=(E, d)).astype(np.float32)
    args = (on(dev, msg), on(dev, dst))
    before = cuda.launch_counts()["segment_mp"]
    got = ops.aggregate(*args, n_nodes=n)
    want = segment_mp_reference(*args, n)
    scale = segment_mp_reference(args[0].abs(), args[1], n)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["segment_mp"] == before + (1 if E else 0)
    assert got.shape == want.shape == (n, d) and got.dtype == torch.float32
    assert ((got - want).abs() <= 1e-4 * scale).all()
    untouched = torch.ones(n, dtype=torch.bool, device=dev)
    untouched[args[1][(args[1] >= 0) & (args[1] < n)].long()] = False
    assert not got[untouched].any()


# dup_cap 1, 15, 17 and 67 (not multiples of 16) and capB 1 and 16k + 3:
# probe_window walks its flat output with a scalar tail only at its end
@pytest.mark.parametrize("cap_a,cap_b,dup", [(8, 7, 6), (3, 4, 5), (8192, 262_144, 64),
                                             (1 << 16, 1000, 3), (100, 999, 100),
                                             (8192, 16_387, 1), (8192, 16_387, 15),
                                             (8192, 1003, 17), (8192, 16_387, 67),
                                             (8192, 1, 17), (300, 1, 1)])
def test_join_probe(dev, cap_a, cap_b, dup):
    from repro_torch.extras.join_probe import ops, ref

    rng = np.random.default_rng(cap_a + dup)
    ka = np.sort(rng.integers(0, 2**32, cap_a, dtype=np.uint64) % (cap_a // 2 + 1) * 977
                 + 2**31).astype(np.uint32)
    ka[-1] = 0xFFFFFFFF
    kb = np.concatenate([ka[rng.integers(0, cap_a, max(cap_b - 2, 0))],
                         np.array([0, 0xFFFFFFFF])[-cap_b:]]).astype(np.uint32)
    a, b = on(dev, ka), on(dev, kb)
    c0 = cuda.launch_counts()
    lo = ops.lower_bound(a, b)
    hit, idx = ops.window(a, b, lo, dup_cap=dup)
    lo_p = ref.lower_bound_reference(a, b)
    hit_p, idx_p = ref.window_reference(a, b, lo_p, dup_cap=dup)
    torch.cuda.synchronize()
    c1 = cuda.launch_counts()
    assert (c1["probe_lower_bound"], c1["probe_window"]) == (
        c0["probe_lower_bound"] + 1, c0["probe_window"] + 1)
    assert torch.equal(lo, lo_p) and torch.equal(hit, hit_p) and torch.equal(idx, idx_p)


# the build side's capA * (5 + 4 * 2) bytes: 53,248 and 390,000
@pytest.mark.parametrize("cap_a,route", [(4096, "shared"), (30_000, "global")],
                         ids=["shared", "global"])
def test_probe_kernels_launch_on_the_current_stream(dev, cap_a, route):
    """Inside ``torch.cuda.stream(s)`` and inside a captured CUDA graph the
    two probe kernels land on that stream (``hash_join_probe`` on each of
    its routes): a side stream's results, and a graph's replay on inputs
    changed after the capture, equal the plain versions."""
    from repro_torch.extras.join_probe import ops
    from repro_torch.extras.join_probe import ref as probe_ref
    from repro_torch.kernels.hash_join import hash_join
    from repro_torch.kernels.hash_join import ref as join_ref

    args = probe_inputs(dev, cap_a, 5000, 2, 7)
    ka, kb = args[0], args[3]

    def run():
        return ops.lower_bound(ka, kb), hash_join.hash_join_probe(*args, dup_cap=7)

    def want():
        return probe_ref.lower_bound_reference(ka, kb), join_ref.probe_reference(*args, dup_cap=7)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # the read CudaKernel passes to every launch
        assert torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()) == side.cuda_stream
        assert side.cuda_stream != torch.cuda.default_stream().cuda_stream
        lo, (hit, idx) = run()
    side.synchronize()
    assert hash_join.last_route() == route
    (lo_p, (hit_p, idx_p)) = want()
    assert torch.equal(lo, lo_p) and torch.equal(hit, hit_p) and torch.equal(idx, idx_p)

    graph = torch.cuda.CUDAGraph()
    c0 = cuda.launch_counts()
    with torch.cuda.graph(graph):
        lo, (hit, idx) = run()
    c1 = cuda.launch_counts()
    assert (c1["probe_lower_bound"], c1["hash_join_probe"]) == (
        c0["probe_lower_bound"] + 1, c0["hash_join_probe"] + 1)
    kb.copy_(torch.flip(kb, (0,)))  # new probe keys: the replay must search anew
    graph.replay()
    torch.cuda.synchronize()
    (lo_p, (hit_p, idx_p)) = want()
    assert torch.equal(lo, lo_p) and torch.equal(hit, hit_p) and torch.equal(idx, idx_p)


def test_gnn_on_card_matches_the_cpu(dev):
    """Every GNN kind at its smoke config, the same weights on card and CPU:
    outputs within ``1e-4 · max|cpu|`` with TF32 off."""
    from repro_torch.configs import egnn, gatedgcn, gin_tu, meshgraphnet
    from repro_torch.data.pipeline import gnn_full_batch
    from repro_torch.graphstore import generators
    from repro_torch.models.gnn import GNN
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    g = generators.rmat(3000, 20_000, 4, seed=1)
    for mod in (gin_tu, gatedgcn, egnn, meshgraphnet):
        cfg = mod.smoke()
        gpu = GNN(cfg, device=dev)
        cpu = GNN(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        assert gpu.kernels.name == "cuda" and cpu.kernels.name == "torch"
        batch = gnn_full_batch(cfg, g, n_classes=cfg.n_classes, seed=0)
        before = cuda.launch_counts()["segment_mp"]
        got = make_serve_fns(cfg, gpu)["infer"](batch).cpu()
        assert cuda.launch_counts()["segment_mp"] > before
        want = make_serve_fns(cfg, cpu)["infer"](batch)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max(), cfg.name


def test_extras_wrappers_reject_what_the_kernels_do_not_take(dev):
    from repro_torch.extras.join_probe import join_probe
    from repro_torch.extras.segment_mp import segment_mp

    i32 = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        segment_mp.segment_mp(torch.zeros((4, 2), dtype=torch.float64, device=dev), i32, 3)
    with pytest.raises(ValueError, match="int32"):
        segment_mp.segment_mp(torch.zeros((4, 2), device=dev), i32.long(), 3)
    with pytest.raises(ValueError, match="1 to 2"):
        join_probe.probe_lower_bound(i32[:0], i32)
    with pytest.raises(ValueError, match="does not match"):
        join_probe.probe_window(i32, i32, i32[:2], dup_cap=2)


# ---------------------------------------------------------- flash_attention
class route_counter:
    """The launch counts of both `flash_attention` routes now; `check`
    asserts that ``name``'s moved by one and the other's not at all."""

    def __init__(self, name):
        from repro_torch.extras.flash_attention import flash_attention as fa

        self.kernels = {r: fa.ROUTES[r].symbol for r in fa.ROUTES}
        self.name = name
        self.before = {r: cuda.launch_counts()[sym] for r, sym in self.kernels.items()}

    def check(self):
        for r, sym in self.kernels.items():
            want = self.before[r] + (1 if r == self.name else 0)
            assert cuda.launch_counts()[sym] == want, (r, self.name)


@pytest.mark.parametrize("B,S,Nq,Nkv,H,Hv,window,softcap", [
    (2, 200, 8, 1, 256, 256, None, None),    # gemma's heads, S not a multiple of 64
    (1, 1000, 8, 1, 256, 256, 100, 30.0),
    (1, 300, 16, 2, 128, 128, 64, 30.0),     # qwen2's head dim, G = 8
    (2, 129, 4, 2, 128, 128, 1, None),       # the diagonal only
    (1, 77, 6, 3, 40, 24, 500, None),        # window past S, Hv != H, ragged head dims
    (1, 50, 2, 1, 30, 30, 7, None),          # head dim not a multiple of 4 (scalar loads)
    (1, 1, 1, 1, 8, 8, None, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(dev, B, S, Nq, Nkv, H, Hv, window, softcap, dtype):
    """The kernel against the plain version on N(0,1) inputs, each output
    row within ``tol ·`` its max|plain| (fp32 2e-5, bf16 2e-2); TF32 off."""
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.extras.flash_attention.ref import mha_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S * 7 + H)
    q, k, v = (on(dev, rng.normal(size=sh).astype(np.float32)).to(dtype)
               for sh in ((B, S, Nq, H), (B, S, Nkv, H), (B, S, Nkv, Hv)))
    moved = route_counter(fa.route(q, k, v))
    got = get_kernels("cuda").flash_attention(q, k, v, window=window, softcap=softcap)
    want = mha_reference(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    moved.check()
    assert got.dtype == dtype and got.shape == want.shape and torch.isfinite(got).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    assert ((got.float() - want.float()).abs() <= tol * scale).all()
    # and through the entry point, with a scale of its own
    got = fa.flash_attention(q, k, v, scale=0.05, window=window, softcap=softcap)
    want = mha_reference(q, k, v, scale=0.05, window=window, softcap=softcap)
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    assert ((got.float() - want.float()).abs() <= tol * scale).all()


@pytest.mark.parametrize("B,S,Nq,Nkv,H,Hv,window,softcap,route,dtype", [
    # bf16: the tensor-core route and the FMA route
    (1, 15, 8, 1, 256, 256, None, None, "tc", torch.bfloat16),  # 16 positions a block at G = 8: -1
    (1, 16, 8, 1, 256, 256, None, None, "tc", torch.bfloat16),
    (1, 17, 8, 1, 256, 256, None, 30.0, "tc", torch.bfloat16),     # +1, softcap
    (1, 63, 8, 1, 256, 256, None, None, "tc", torch.bfloat16),     # a K/V tile is 64 keys: -1, +1
    (1, 65, 8, 1, 256, 256, 7, None, "tc", torch.bfloat16),
    (2, 127, 1, 1, 64, 64, None, None, "tc", torch.bfloat16),      # G = 1: 128 positions a block
    (1, 129, 2, 2, 64, 64, None, None, "tc", torch.bfloat16),
    (1, 130, 3, 1, 96, 96, None, None, "tc", torch.bfloat16),      # G = 3: 63 of a tile's 64 rows
    (1, 100, 16, 1, 128, 128, 33, 30.0, "tc", torch.bfloat16),     # G = 16
    (1, 300, 8, 1, 256, 64, 1, None, "tc", torch.bfloat16),        # Hv != H, the diagonal only
    (1, 200, 8, 2, 128, 256, 1000, None, "tc", torch.bfloat16),    # window past S, Hv > H
    (1, 70, 4, 1, 40, 24, 20, 50.0, "tc", torch.bfloat16),         # head dims not multiples of 16
    (1, 70, 4, 2, 8, 8, None, None, "tc", torch.bfloat16),
    (1, 130, 4, 4, 192, 128, None, None, "tc", torch.bfloat16),    # MLA: H 192 (HD 256), Hv 128
    (2, 300, 8, 8, 192, 128, None, None, "tc", torch.bfloat16),    # G = 1
    (1, 70, 4, 2, 30, 30, None, None, "fma", torch.bfloat16),  # 60-byte rows: no TMA descriptor
    (1, 70, 4, 2, 20, 36, 9, None, "fma", torch.bfloat16),
    (1, 40, 128, 1, 64, 64, None, None, "fma", torch.bfloat16),  # 128 heads a kv head: over a tile
    # float32: the split-TF32 route (a block is 64 / G positions, a K/V tile
    # 64 keys, a box 32 head dims) and the FMA route
    (1, 15, 8, 1, 256, 256, None, None, "tf32", torch.float32),   # 8 positions a block at G = 8
    (1, 16, 8, 1, 256, 256, None, None, "tf32", torch.float32),
    (1, 17, 8, 1, 256, 256, None, 30.0, "tf32", torch.float32),
    (1, 63, 8, 1, 256, 256, None, None, "tf32", torch.float32),   # a tile's keys: -1, +1
    (1, 64, 8, 1, 256, 256, 7, None, "tf32", torch.float32),
    (1, 65, 8, 1, 256, 256, 7, None, "tf32", torch.float32),
    (2, 127, 1, 1, 64, 64, None, None, "tf32", torch.float32),    # G = 1: 64 positions a block
    (1, 128, 1, 1, 64, 64, None, 50.0, "tf32", torch.float32),
    (1, 129, 2, 2, 64, 64, None, None, "tf32", torch.float32),
    (1, 130, 3, 1, 96, 96, None, None, "tf32", torch.float32),    # G = 3: 63 of a block's 64 rows
    (1, 100, 16, 1, 128, 128, 33, 30.0, "tf32", torch.float32),   # G = 16
    (1, 100, 64, 1, 32, 32, None, None, "tf32", torch.float32),   # G = 64: one position a block
    (1, 300, 8, 1, 256, 64, 1, None, "tf32", torch.float32),      # Hv != H, the diagonal only
    (1, 200, 8, 2, 128, 256, 1000, None, "tf32", torch.float32),  # window past S, Hv > H
    (1, 70, 4, 1, 36, 20, 20, 50.0, "tf32", torch.float32),  # head dims off a box: 36, 20
    (1, 70, 4, 2, 8, 8, None, None, "tf32", torch.float32),
    (1, 70, 4, 2, 4, 4, 3, None, "tf32", torch.float32),
    (2, 300, 64, 8, 128, 128, 100, 30.0, "tf32", torch.float32),  # qwen2-72b's heads
    (1, 130, 4, 4, 192, 128, None, None, "tf32", torch.float32),  # MLA: H 192, Hv 128, G = 1
    (2, 300, 8, 8, 192, 128, None, None, "tf32", torch.float32),
    (1, 70, 4, 2, 30, 30, None, None, "fma", torch.float32),  # 120-byte rows: no TMA descriptor
    (1, 70, 4, 2, 20, 30, 9, None, "fma", torch.float32),
    (1, 40, 128, 1, 64, 64, None, None, "fma", torch.float32),  # 128 heads a kv head: over a tile
])
def test_flash_attention_routes(dev, B, S, Nq, Nkv, H, Hv, window, softcap, route, dtype):
    """Edges of the three routes: the tensor-core routes at the packed-row
    tile's and the K/V tile's edges, G 1, 3, 8, 16 (and 64 in fp32), head
    dims 4-256, Hv != H (MLA's 192 and 128), window 1 and past S, softcap; the FMA route for
    shapes TMA cannot describe, in both dtypes. Each case asserts which
    route's counter moved; each output row within ``tol ·`` its max|plain|
    (bf16 2e-2, fp32 2e-5)."""
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.extras.flash_attention.ref import mha_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(S * 13 + H + Nq)
    q, k, v = (on(dev, rng.normal(size=sh).astype(np.float32)).to(dtype)
               for sh in ((B, S, Nq, H), (B, S, Nkv, H), (B, S, Nkv, Hv)))
    assert fa.route(q, k, v) == route
    moved = route_counter(route)
    got = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    want = mha_reference(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    moved.check()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    scale = want.float().abs().amax(dim=-1, keepdim=True)
    assert ((got.float() - want.float()).abs() <= tol * scale).all()


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"), (torch.float32, "tf32")])
def test_flash_attention_tc_takes_unaligned_views(dev, dtype, route):
    """Views that start off a 16-byte boundary take their tensor-core route
    (copied to aligned storage first): the same output as aligned copies."""
    from repro_torch.extras.flash_attention import flash_attention as fa

    rng = np.random.default_rng(5)
    shapes = ((1, 40, 8, 256), (1, 40, 1, 256), (1, 40, 1, 256))
    views = []
    for sh in shapes:
        flat = on(dev, rng.normal(size=int(np.prod(sh)) + 1).astype(np.float32)).to(dtype)
        views.append(flat[1:].view(sh))
    assert all(t.data_ptr() % 16 for t in views)
    moved = route_counter(route)
    got = fa.flash_attention(*views)
    torch.cuda.synchronize()
    moved.check()
    assert torch.equal(got, fa.flash_attention(*(t.clone() for t in views)))


def test_lm_on_card_matches_the_cpu(dev):
    """gemma-2b, qwen2-72b, mixtral-8x22b and deepseek-v3 smoke configs
    (fp32), the same weights on card and CPU: prefill logits and the decode
    step within ``1e-4 ·`` each row's max|cpu|, TF32 off; the prefill
    launches one kernel a layer, on the split-TF32 route (head dims 32, 16,
    16 and MLA's 24 and 16). Each config's worst ratio is printed (``-s``)
    whether it passes or not, with whether a second prefill on each side
    gave the same bits (the failure message says it too)."""
    import dataclasses

    from repro_torch.configs import deepseek_v3_671b, gemma_2b, mixtral_8x22b, qwen2_72b
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    for cfg in (gemma_2b.smoke(), dataclasses.replace(qwen2_72b.smoke(), sliding_window=40,
                                                      attn_logit_softcap=30.0),
                mixtral_8x22b.smoke(), deepseek_v3_671b.smoke()):
        gpu = Transformer(cfg, device=dev)
        cpu = Transformer(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        assert gpu.kernels.name == "cuda" and cpu.kernels.name == "torch"
        tokens = lm_batch(cfg, 2, 130, seed=0, step=0)["tokens"]
        before = {r: cuda.launch_counts()[k.symbol] for r, k in fa.ROUTES.items()}
        f_gpu, f_cpu = make_serve_fns(cfg, gpu), make_serve_fns(cfg, cpu)
        got, c_gpu = f_gpu["prefill"](tokens)
        assert {r: cuda.launch_counts()[k.symbol] - before[r] for r, k in fa.ROUTES.items()} == {
            r: cfg.n_layers if r == "tf32" else 0 for r in fa.ROUTES}
        want, c_cpu = f_cpu["prefill"](tokens)
        # each side twice: a failure then says which side moved
        cpu_again = torch.equal(want, f_cpu["prefill"](tokens)[0])
        card_again = torch.equal(got, f_gpu["prefill"](tokens)[0])
        scale = want.abs().amax(dim=-1, keepdim=True)
        prefill_ratio = ((got.cpu() - want).abs() / scale).max().item()
        tok = want[:, -1:].argmax(-1)
        # the cache has no free slot past the prompt: decode the last position again
        got_d, _ = f_gpu["decode"](c_gpu, tok, 129)
        want_d, _ = f_cpu["decode"](c_cpu, tok, 129)
        scale_d = want_d.abs().amax(dim=-1, keepdim=True)
        decode_ratio = ((got_d.cpu() - want_d).abs() / scale_d).max().item()
        again = (f"a second prefill gave the same bits: on the CPU {cpu_again}, "
                 f"on the card {card_again}")
        print(f"[lm on card vs cpu] {cfg.name}: worst |card - cpu| / max|cpu| of its row: "
              f"prefill {prefill_ratio:.3e}, decode {decode_ratio:.3e}; {again}")
        assert ((got.cpu() - want).abs() <= 1e-4 * scale).all(), (
            f"{cfg.name}: worst |card - cpu| / max|cpu| of its row {prefill_ratio}; {again}")
        assert ((got_d.cpu() - want_d).abs() <= 1e-4 * scale_d).all(), (
            f"{cfg.name}: decode {decode_ratio}")


def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    from repro_torch.extras.flash_attention import flash_attention as fa

    q = torch.zeros((1, 8, 4, 32), device=dev)
    kv = torch.zeros((1, 8, 2, 32), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="expected torch.float32"):
        fa.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="square"):
        fa.flash_attention(q, kv[:, :5].contiguous(), kv[:, :5].contiguous())
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q[:, :, :3].contiguous(), kv, kv)
    big = torch.zeros((1, 8, 1, 264), device=dev)
    with pytest.raises(ValueError, match="at most 256"):
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="softcap"):
        fa.flash_attention(q, kv, kv, softcap=-1.0)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_attention(q, kv.cpu(), kv)


# ------------------------------------------------------------------ training
def _function_case(op, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if op == "cin_layer":
        return (r(300, 39, 10), r(300, 39, 10), r(39 * 39, 200)), {}, r(300, 200, 10), [0, 1, 2]
    if op == "segment_mp":
        dst = torch.sort(torch.randint(-2, 900, (5000,), generator=g, device=dev)).values.int()
        return (r(5000, 70), dst, 880), {}, r(880, 70), [0]
    kw = dict(window=100, softcap=30.0)
    return (r(2, 300, 8, 256), r(2, 300, 1, 256), r(2, 300, 1, 256)), kw, r(2, 300, 8, 256), [0, 1, 2]


@pytest.mark.parametrize("op,dtype", [("cin_layer", torch.float32),
                                      ("segment_mp", torch.float32),
                                      ("flash_attention", torch.bfloat16),
                                      ("flash_attention", torch.float32)],
                         ids=["cin_layer", "segment_mp", "flash-tc", "flash-tf32"])
def test_function_gradients_on_card_match_the_plain_autograd(dev, op, dtype):
    """Each kernel's autograd Function (the CUDA backend's op: the kernel
    forward, one launch) against autograd of the plain version on the card:
    its gradients within ``1e-4 ·`` each gradient's max|plain| (cin_layer's
    input gradients are CIN layers on the kernel too; the attention and
    segment_mp vjps are the plain version's own, so those are exact)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args, kw, go, diff = _function_case(op, dev, dtype)
    grads = []
    for backend in ("cuda", "torch"):
        xs = [a.clone().requires_grad_(i in diff) if isinstance(a, torch.Tensor) else a
              for i, a in enumerate(args)]
        before = dict(cuda.launch_counts())
        getattr(get_kernels(backend), op)(*xs, **kw).backward(go)
        torch.cuda.synchronize()
        moved = sum(v - before[k] for k, v in cuda.launch_counts().items())
        assert moved == ({"cin_layer": 3}.get(op, 1) if backend == "cuda" else 0)
        grads.append([xs[i].grad for i in diff])
    for a, b in zip(*grads):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all()
        tol = 0.0 if op != "cin_layer" else 1e-4
        assert (a.float() - b.float()).abs().max() <= tol * b.float().abs().max()


@pytest.mark.parametrize("family", ["gemma-2b", "gatedgcn", "xdeepfm"])
def test_train_step_on_card_matches_the_cpu(dev, family):
    """One family's fp32 smoke config, the same weights on card and CPU: the
    loss and every gradient leaf within ``1e-4 ·`` the leaf's max|cpu| (TF32
    off), then one `make_train_step` step at lr > 0 (a first Adam step): the
    parameters within ``2 · lr`` of the CPU's, and all but 0.1% of a leaf's
    elements within ``1e-2 · lr``."""
    from repro_torch import optim
    from repro_torch.configs import gatedgcn, gemma_2b, xdeepfm
    from repro_torch.data.pipeline import gnn_full_batch, lm_batch, recsys_batch
    from repro_torch.graphstore import generators
    from repro_torch.models.gnn import GNN
    from repro_torch.models.recsys import XDeepFM
    from repro_torch.models.schema import trainable
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import make_train_step
    from repro_torch.train.step import batch_on, loss_for

    torch.backends.cuda.matmul.allow_tf32 = False
    if family == "gemma-2b":
        cfg, cls = gemma_2b.smoke(), Transformer
        batch = lm_batch(cfg, 2, 64, seed=0, step=0)
    elif family == "gatedgcn":
        cfg, cls = gatedgcn.smoke(), GNN
        batch = {"graph": gnn_full_batch(cfg, generators.rmat(500, 2000, 4, seed=0),
                                         n_classes=cfg.n_classes, seed=0)}
    else:
        cfg, cls = xdeepfm.smoke(), XDeepFM
        batch = recsys_batch(cfg, 256, seed=0, step=0)
    gpu = trainable(cls(cfg, device=dev))
    cpu = trainable(cls(cfg, device="cpu"))
    with torch.no_grad():
        for (_, a), (_, b) in zip(cpu.named_parameters(), gpu.named_parameters()):
            a.copy_(b.cpu())
    assert gpu.kernels.name == "cuda" and cpu.kernels.name == "torch"
    losses = []
    for m in (gpu, cpu):
        loss = loss_for(cfg, batch_on(batch, m.device))(m)
        loss.backward()
        losses.append(float(loss.detach()))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for (n, a), (_, b) in zip(gpu.named_parameters(), cpu.named_parameters()):
        ga = a.grad.cpu() if a.grad is not None else torch.zeros_like(b)
        gb = b.grad if b.grad is not None else torch.zeros_like(b)
        assert (ga - gb).abs().max() <= 1e-4 * gb.abs().max(), n
    opt = optim.AdamWConfig()
    for m in (gpu, cpu):
        m.zero_grad(set_to_none=True)
        step = make_train_step(cfg, opt, total_steps=4, warmup=1)
        step(m, optim.init(opt, dict(m.named_parameters())), batch, 1)
    for (n, a), (_, b) in zip(gpu.named_parameters(), cpu.named_parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        # a first Adam step is about lr · g / |g|: where g is ~0 its sign may
        # differ between the two sides, so those few elements may be 2 lr apart
        assert diff.max() <= 2 * opt.lr, n
        assert (diff > 1e-2 * opt.lr).float().mean() <= 1e-3, n


def test_gloo_takes_cuda_tensors_where_the_staging_rule_leaves_them(dev):
    """The staging rule of `repro_torch.core.rank_collectives` on this
    machine's torch: two gloo ranks on ``cuda:0`` reduce and gather CUDA
    tensors as they are, and a point-to-point exchange of words with bit 31
    set round-trips through pinned host memory, every bit kept."""
    import rank_fns
    from repro_torch.core.rank_collectives import GLOO_HOST_OPS
    from repro_torch.launch import spawn_ranks

    res = spawn_ranks(rank_fns.gloo_cuda_rank, 2, timeout=300)
    assert GLOO_HOST_OPS == {"p2p"}
    want_gather = np.stack([np.full((3, 2), r - 2**31, np.int32) for r in range(2)])
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["sum"], [3, -3])
        np.testing.assert_array_equal(r["max"], [2, -1])
        np.testing.assert_array_equal(r["gather"], want_gather)
        assert r["staged_p2p"]
        peer = 1 - rank
        (wd, wt, words), (md, mt, mask) = r["exchange"]
        assert (wd, wt, md, mt) == ("cuda", torch.int32, "cuda", torch.bool)
        np.testing.assert_array_equal(
            words, np.array([-(2**31), -(2**31) + peer, 2**31 - 1], np.int32))
        np.testing.assert_array_equal(mask, [peer == 0, peer == 1, True])
        # each operand out and each result back: (3 words of 4 + 3 bools) · 2
        assert r["staged"] == {"probe": 2 * (12 + 3)}


@pytest.mark.parametrize("case,mesh_type", [(c, None) for c in (
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all")] + [(c, "cuda") for c in (
        "partial_to_replicate", "partial_to_shard", "shard_to_replicate", "shard_to_shard")])
def test_gloo_takes_the_collectives_dtensor_uses(dev, case, mesh_type):
    """Two gloo ranks on ``cuda:0``, bf16 and fp32: each functional
    collective that DTensor's redistributions call, and each redistribution
    on a mesh of device type ``"cuda"``, under the staging rule of
    `rank_collectives.stage_functional_collectives`: every result right
    and on the card; only the all-gather staged through the host."""
    import mesh_fns
    from repro_torch.core.rank_collectives import GLOO_FUNCTIONAL_HOST_OPS
    from repro_torch.launch import spawn_ranks

    assert GLOO_FUNCTIONAL_HOST_OPS == {"all_gather_into_tensor"}
    res = spawn_ranks(mesh_fns.gloo_collective_rank, 2, case, mesh_type, timeout=300)
    x = [np.arange(8, dtype=np.float32) + r for r in range(2)]
    want = {"all_reduce": [x[0] + x[1]] * 2, "all_gather": [np.concatenate(x)] * 2,
            "reduce_scatter": [(x[0] + x[1])[:4], (x[0] + x[1])[4:]],
            "all_to_all": [np.concatenate([x[0][:4], x[1][:4]]),
                           np.concatenate([x[0][4:], x[1][4:]])],
            "partial_to_replicate": [(x[0] + x[1]).reshape(2, 4)] * 2,
            "partial_to_shard": [(x[0] + x[1]).reshape(2, 4)[r:r + 1] for r in range(2)],
            "shard_to_replicate": [np.concatenate([x[0].reshape(2, 4), x[1].reshape(2, 4)])] * 2,
            "shard_to_shard": [np.concatenate([x[0].reshape(2, 4), x[1].reshape(2, 4)])[
                :, 2 * r:2 * r + 2] for r in range(2)]}[case]
    gathers = case in ("all_gather", "shard_to_replicate")
    for rank, r in enumerate(res):
        for dt in ("bfloat16", "float32"):
            device, got = r[dt]
            assert device == "cuda", (case, dt)
            np.testing.assert_array_equal(got, want[rank])
        assert bool(r["staged"]) == gathers, r["staged"]


def test_gloo_all_gather_of_cuda_tensors_needs_the_staging_rule(dev):
    """Why `GLOO_FUNCTIONAL_HOST_OPS` holds the all-gather: without the
    staging rule, gloo's ``all_gather_into_tensor`` of a CUDA tensor kills
    the rank (SIGSEGV) on this machine's torch."""
    import mesh_fns
    from repro_torch.launch import spawn_ranks

    with pytest.raises(RuntimeError, match="exited with code -11"):
        spawn_ranks(mesh_fns.gloo_collective_rank, 2, "all_gather", None, "cuda", False,
                    timeout=300)


def test_mesh_lm_on_card_matches_the_one_card_forward(dev):
    """gemma-2b smoke on 2 gloo ranks sharing ``cuda:0`` (``(data=1,
    model=2)``: heads, MLP and vocab over ``model``), drawn from seed 0 leaf
    by leaf: the prefill's logits and three decode steps' equal the one-card
    model's within ``[lm]``'s smoke tolerance (1e-4 of each row's max); each
    rank's prefill launches the split-TF32 attention kernel once a layer and
    no other route; no rank builds a kernel library (the parent built
    them)."""
    import mesh_fns
    from repro_torch.configs import gemma_2b
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import spawn_ranks
    from repro_torch.models.transformer import Transformer, grow_cache
    from repro_torch.train.step import make_serve_fns

    cuda.build()
    cfg = gemma_2b.smoke()
    tokens = lm_batch(cfg, 2, 64, seed=0, step=0)["tokens"]
    decode_tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 2, 1)).astype(np.int32)
    res = spawn_ranks(mesh_fns.lm_rank, 2, "cuda:0", {"data": 1, "model": 2}, "gemma-2b", {},
                      tokens, decode_tokens, None, timeout=600)
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    fns = make_serve_fns(cfg, model)
    logits, cache = fns["prefill"](tokens)
    cache = grow_cache(cache, tokens.shape[1] + len(decode_tokens))
    want = [logits.float().cpu().numpy()]
    for i, tok in enumerate(decode_tokens):
        want.append(fns["decode"](cache, tok, tokens.shape[1] + i)[0].float().cpu().numpy())
    for r in res:
        assert r["sources_built"] == 0
        assert r["launches"] == {"flash_attention_tf32": cfg.n_layers}, r["launches"]
        for got, w in zip([r["logits"]] + r["decode"], want):
            scale = np.abs(w).max(axis=-1, keepdims=True)
            assert (np.abs(got - w) <= 1e-4 * scale).all(), np.max(np.abs(got - w) / scale)
