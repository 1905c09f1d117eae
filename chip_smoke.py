"""Drive the PyTorch/CUDA port's local query path on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure exits non-zero, and the
result lines are printed only when every phase passed):

  1. device — the card's name, and its power limit from ``nvidia-smi``;
  2. build — every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc`` for
     ``sm_90a``, all sources at once; the seconds it took and each kernel's
     registers/spills as ``ptxas`` reports them;
  3. main path — a US-Patents-shaped R-MAT graph (3,774,768 nodes,
     16,522,438 edges, 418 labels, seed 0) opened with
     ``GraphSession.open(g)`` on the card (CUDA kernels), eight or more
     seeded DFS queries of 4-6 nodes run with ``max_matches=1024,
     adaptive=False`` as in the paper's §6.1, and one stream consumed to its
     end. Every kernel's launch count is zeroed just before and read just
     after; each must be > 0. Every returned row is checked to be a
     label-preserving injective embedding of its query in the graph;
  4. the same queries and stream with ``kernels="torch"`` (the plain
     PyTorch versions) on the card must give identical rows; the inputs of
     each op's largest call there are kept for phase 5;
  5. kernels — each CUDA kernel against its plain version on the card, on
     those main-path inputs and on small adversarial cases, bit for bit
     (tolerance 0: all outputs are integers or flags); kernel and plain
     times are CUDA-event medians of 10 runs after a warm-up;
  6. a 2,000-node graph gives the same rows on the CPU and on the card.

Before the last line it prints the kernels as one JSON object, then the
``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``. It imports neither ``jax`` nor the JAX
package.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor-core rate (data sheet)
PATENTS = dict(n_nodes=3_774_768, n_edges=16_522_438, n_labels=418, seed=0)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- phase 1
def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    return name, smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    msgs = cuda.build(ptxas_verbose=True)
    log(f"[build] {len(msgs)} sources built in {time.perf_counter() - t0:.2f} s "
        f"into {cuda.BUILD_DIR.relative_to(ROOT)}")
    for src, text in msgs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {src}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def embedding_check(g, edge_keys: np.ndarray, q, rows: np.ndarray) -> None:
    """Every row maps query node i to a data node of label q.labels[i],
    injectively, and every query edge to a data edge."""
    if rows.shape[1] != q.n_nodes or (rows < 0).any():
        fail(f"rows of shape {rows.shape} / ghost ids for a {q.n_nodes}-node query")
    if not (g.labels[rows] == np.asarray(q.labels)[None, :]).all():
        fail("a row maps a query node to a node of another label")
    srt = np.sort(rows, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a row maps two query nodes to one data node")
    for u, v in q.edges:
        key = rows[:, u].astype(np.int64) * g.n_nodes + rows[:, v]
        pos = np.searchsorted(edge_keys, key)
        if not (edge_keys[np.minimum(pos, len(edge_keys) - 1)] == key).all():
            fail(f"a row maps query edge ({u},{v}) to a non-edge")


def make_queries(g, n: int = 8, seed: int = 0):
    from repro_torch.workloads import dfs_query

    rng = np.random.default_rng(seed)
    qs = []
    while len(qs) < n:
        q = dfs_query(g, rng, int(rng.integers(4, 7)))
        if q is not None and q.n_nodes >= 4:
            qs.append(q)
    return qs


def run_queries(session, queries, stream_q):
    """The queries with ``max_matches=1024, adaptive=False``, then one stream
    consumed to its end. Returns (rows per query, stream rows, report)."""
    out, report = [], []
    for i, q in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.compile(q, max_matches=1024).run(adaptive=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out.append(res.rows)
        st = {k: round(v * 1e3, 3) for k, v in res.stats.stage_times.items()}
        report.append(
            f"q{i} nodes={q.n_nodes} stwigs={len(res.stats.rounds)} rounds={res.stats.rounds} "
            f"matches={res.n_matches} complete={res.complete} ms={ms:.3f} stage_ms={st}"
        )
    t0 = time.perf_counter()
    pages = list(session.compile(stream_q, max_matches=1024).stream(page_size=256))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    srows = [p.rows for p in pages]
    report.append(f"stream pages={len(pages)} rows={sum(len(r) for r in srows)} ms={ms:.3f}")
    return out, srows, report


# ---------------------------------------------------------------- phase 4
def recording_kernels():
    """The plain PyTorch backend, keeping the inputs of each op's largest
    call (they are the main path's real inputs)."""
    from repro_torch.core.backend import Kernels

    class Recording(Kernels):
        def __init__(self):
            self.calls = {}

        def _keep(self, op, size, args, kw):
            if size > self.calls.get(op, (-1,))[0]:
                self.calls[op] = (size, args, kw)

        def bitset_pack(self, mask):
            self._keep("bitset_pack", mask.numel(), (mask,), {})
            return super().bitset_pack(mask)

        def bitset_lookup(self, words, ids):
            self._keep("bitset_lookup", ids.numel(), (words, ids), {})
            return super().bitset_lookup(words, ids)

        def bitset_build(self, ids, valid, nwords):
            self._keep("bitset_build", ids.numel(), (ids, valid, nwords), {})
            return super().bitset_build(ids, valid, nwords)

        def stwig_expand(self, *args, **kw):
            self._keep("stwig_expand", args[0].shape[0] * args[1].numel(), args, kw)
            return super().stwig_expand(*args, **kw)

        def hash_join_probe(self, *args, dup_cap):
            self._keep("hash_join_probe", args[3].numel() * dup_cap, args, {"dup_cap": dup_cap})
            return super().hash_join_probe(*args, dup_cap=dup_cap)

    return Recording()


# ---------------------------------------------------------------- phase 5
def adversarial_cases(dev):
    """Small cases of the CPU tests, on the card: (op, args, kwargs)."""
    from repro_torch.kernels.bitset.ref import n_words

    rng = np.random.default_rng(0)

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(dev)

    W = 64
    n_bits = W * 32
    ids = np.concatenate([rng.integers(0, n_bits, 256),
                          [0, n_bits - 1, n_bits, n_bits + 31, -1, -32, -(2**31), 2**31 - 1]])
    words = rng.integers(0, 2**32, W, dtype=np.uint32)
    bids = rng.integers(-2 * n_bits, n_bits + 40, 500).astype(np.int32)
    bids[:4] = [-1, -n_bits, -(2**31), 2**31 - 1]
    E, cap, n_total = 64, 5, 100
    indptr = np.zeros(cap + 2, np.int32)
    indptr[1:] = E
    ka = np.array([0, 5, 5, 5, 5, 5, 5, 9], np.uint32)
    big = np.sort(rng.integers(0, 2**32, 64, dtype=np.uint64)).astype(np.uint32)
    big[-3:] = 0xFFFFFFFF
    return [
        ("bitset_lookup", (t(words), t(ids.astype(np.int32))), {}),
        ("bitset_build", (t(bids), t(rng.random(500) < 0.7), W), {}),
        ("bitset_pack", (t(rng.random(4096) < 0.4),), {}),
        ("stwig_expand", (t(np.full((2, n_words(n_total + 1)), 0xFFFFFFFF, np.uint32)),
                          t(np.arange(E, dtype=np.int32)), t(np.full(E, 1, np.int32)),
                          t(indptr), t(np.ones(E, bool))),
         dict(child_labels=(1, 1), child_bound=(True, False), child_cap=3, cap=cap,
              n_total=n_total)),
        ("hash_join_probe", (t(ka), t(np.full((8, 1), 5, np.int32)), t(np.ones(8, bool)),
                             t(np.array([5], np.uint32)), t(np.array([[5]], np.int32)),
                             t(np.ones(1, bool))), dict(dup_cap=6)),
        ("hash_join_probe", (t(big), t(rng.integers(0, 3, (64, 1)).astype(np.int32)),
                             t(rng.random(64) < 0.9),
                             t(np.concatenate([big[::3], [0, 0xFFFFFFFF, 2**31]]).astype(np.uint32)),
                             t(rng.integers(0, 3, (25, 1)).astype(np.int32)),
                             t(np.ones(25, bool))), dict(dup_cap=4)),
    ]


def max_abs_err(a, b) -> int:
    outs_a = a if isinstance(a, tuple) else (a,)
    outs_b = b if isinstance(b, tuple) else (b,)
    err = 0
    for x, y in zip(outs_a, outs_b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"shape/dtype mismatch {tuple(x.shape)} {x.dtype} vs {tuple(y.shape)} {y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def work(op, args, kw) -> tuple[int, float]:
    """(bytes the op must move: inputs once, outputs once; integer ops)."""
    if op == "bitset_lookup":
        words, ids = args
        return nbytes(words, ids) + ids.numel(), 6.0 * ids.numel()
    if op == "bitset_build":
        ids, valid, nwords = args
        return nbytes(ids, valid) + 4 * nwords, 6.0 * ids.numel()
    if op == "bitset_pack":
        (mask,) = args
        return nbytes(mask) + mask.numel() // 8, 2.0 * mask.numel()
    if op == "stwig_expand":
        words_k, dst, lab, indptr, rok = args
        k, C, cap = words_k.shape[0], kw["child_cap"], kw["cap"]
        out = 4 * k * ((cap + 1) * C + cap)
        return nbytes(words_k, dst, lab, indptr, rok) + out, 8.0 * k * dst.numel()
    if op == "hash_join_probe":
        ka, akeys, avalid, kb, bkeys, bvalid = args
        dup = kw["dup_cap"]
        steps = max(1, ka.numel().bit_length())
        ops = kb.numel() * (4.0 * steps + dup * (4.0 + 2 * akeys.shape[1]))
        return nbytes(*args) + 5 * kb.numel() * dup, ops
    raise KeyError(op)


KERNEL_INFO = {
    "bitset_lookup": ("src/repro_torch/csrc/bitset.cu", "src/repro/kernels/bitset/bitset.py:81"),
    "bitset_build": ("src/repro_torch/csrc/bitset.cu", "src/repro/core/backend.py:263"),
    "bitset_pack": ("src/repro_torch/csrc/bitset.cu", "src/repro/kernels/bitset/bitset.py:57"),
    "stwig_expand": ("src/repro_torch/csrc/stwig_expand.cu",
                     "src/repro/kernels/stwig_expand/stwig_expand.py:173"),
    "hash_join_probe": ("src/repro_torch/csrc/hash_join.cu",
                        "src/repro/kernels/hash_join/hash_join.py:60"),
}


def phase_kernels(recorded, launches, dev) -> list[dict]:
    from repro_torch.core.backend import get_kernels

    cuda_k, plain = get_kernels("cuda"), get_kernels("torch")
    cases = {op: [] for op in KERNEL_INFO}
    for op, args, kw in adversarial_cases(dev):
        cases[op].append((args, kw))
    rows = []
    for op in KERNEL_INFO:
        if op not in recorded:
            fail(f"{op}: the main path never called it")
        _, args, kw = recorded[op]
        err = 0
        for a, k in [(args, kw)] + cases[op]:
            err = max(err, max_abs_err(getattr(cuda_k, op)(*a, **k), getattr(plain, op)(*a, **k)))
        torch.cuda.synchronize()
        if err != 0:
            fail(f"{op}: kernel differs from its plain version (max abs err {err})")
        ms = time_ms(lambda: getattr(cuda_k, op)(*args, **kw))
        plain_ms = time_ms(lambda: getattr(plain, op)(*args, **kw))
        b, ops = work(op, args, kw)
        t_bytes, t_ops = b / HBM_BYTES_PER_S * 1e3, ops / CUDA_CORE_OPS_PER_S * 1e3
        source, replaces = KERNEL_INFO[op]
        rows.append({
            "name": op, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[op], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        log(f"[kernels] {op}: bit-exact on main-path input {shapes} {kw} and "
            f"{len(cases[op])} adversarial case(s); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms ({rows[-1]['bound_by']}, {b} B), "
            f"main-path launches {launches[op]}")
    return rows


# ------------------------------------------------------------------- main
def main() -> None:
    name, smi = phase_device()
    from repro_torch.api import GraphSession
    from repro_torch.graphstore import generators
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.kernels import cuda

    phase_build()
    dev = torch.device("cuda")

    # ---- the graph (set-up: made on the host from the seed) ----------------
    t0 = time.perf_counter()
    g = generators.rmat(PATENTS["n_nodes"], PATENTS["n_edges"], PATENTS["n_labels"],
                        seed=PATENTS["seed"])
    pg = PartitionedGraph.build(g, 1)
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int64), np.diff(g.indptr))
    edge_keys = src * g.n_nodes + g.indices  # sorted: CSR rows, sorted columns
    del src
    queries = make_queries(g, 8, seed=0)
    log(f"[graph] patents-shaped R-MAT: {g.n_nodes} nodes, {g.n_edges} directed edges, "
        f"{g.n_labels} labels, max degree {g.max_degree()}, partition "
        f"{pg.memory_bytes() / 1e6:.1f} MB, built in {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: the main path, CUDA kernels ------------------------------
    session = GraphSession.open(pg)
    if session.kernels.name != "cuda":
        fail(f"GraphSession.open(g) on the card chose {session.kernels.name!r}")
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    rows_cuda, stream_cuda, report = run_queries(session, queries, queries[0])
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    for line in report:
        log(f"[main] {line}")
    log(f"[main] max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
        f"launches {counts}")
    for sym, n in counts.items():
        if n <= 0:
            fail(f"kernel {sym} was never launched on the main path")
    if not any(len(r) for r in rows_cuda):
        fail("every main-path query returned 0 rows")
    for q, rows in zip(queries, rows_cuda):
        embedding_check(g, edge_keys, q, rows)
    embedding_check(g, edge_keys, queries[0], np.concatenate(stream_cuda) if stream_cuda
                    else np.zeros((0, queries[0].n_nodes), np.int64))
    log(f"[main] every row of {len(queries)} queries + stream is a valid embedding")

    # ---- phase 4: the plain versions on the card, same rows ----------------
    recorder = recording_kernels()
    session.set_kernels(recorder)
    rows_torch, stream_torch, report = run_queries(session, queries, queries[0])
    for line in report:
        log(f"[torch] {line}")
    for i, (a, b) in enumerate(zip(rows_cuda, rows_torch)):
        if a.shape != b.shape or not (a == b).all():
            fail(f"q{i}: rows differ between kernels='cuda' and kernels='torch'")
    if len(stream_cuda) != len(stream_torch) or not all(
        (a.shape == b.shape) and (a == b).all() for a, b in zip(stream_cuda, stream_torch)
    ):
        fail("stream pages differ between kernels='cuda' and kernels='torch'")
    log("[torch] rows and stream pages identical to kernels='cuda'")

    # ---- phase 5: each kernel against its plain version --------------------
    kernel_rows = phase_kernels(recorder.calls, counts, dev)
    del session, recorder

    # ---- phase 6: a small graph, CPU vs card -------------------------------
    small = generators.rmat(2000, 8000, 24, seed=0)
    s_cpu = GraphSession.open(small, device="cpu")
    s_gpu = GraphSession.open(small)
    n_rows = 0
    for q in make_queries(small, 6, seed=1):
        a = s_cpu.run(q, max_matches=0).rows
        b = s_gpu.run(q, max_matches=0).rows
        if a.shape != b.shape or not (a == b).all():
            fail("the 2,000-node graph gives other rows on the CPU and on the card")
        n_rows += len(a)
    log(f"[small] 2,000-node graph: 6 queries, {n_rows} rows, identical on CPU and card")

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
