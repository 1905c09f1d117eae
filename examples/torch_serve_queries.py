"""End-to-end run of the PyTorch port (the paper's kind: online
subgraph-query serving), on the card.

Builds a patents-shaped graph, then serves a mixed workload of DFS + random
queries through the continuous-batching `QueryServer`
(`repro_torch.api.serve`): up to ``--max-inflight`` queries are in flight
at once, their block-join quanta interleaved on the one device, each
bounded by a first-K budget (first 1024 matches) and an optional per-query
deadline. Queries with identical plan shapes share cached steps via the
session cache — no serving loop is constructed by hand here.

    PYTHONPATH=src python examples/torch_serve_queries.py [--n-queries 40] [--device cpu]

Without a GPU the default device raises; nothing falls back to the CPU.
"""
import argparse
import time

import numpy as np

from repro_torch.api import GraphSession, summarize_outcomes
from repro_torch.core.backend import resolve_device
from repro_torch.graphstore import generators
from repro_torch.workloads import mixed_workload


def main(argv=None) -> dict:
    """Serve the workload; returns the outcomes and the server's stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-queries", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--labels", type=int, default=64)
    ap.add_argument("--max-inflight", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: raise now, before any set-up

    print(f"loading graph: {args.nodes} nodes, deg {args.degree} ...")
    t0 = time.perf_counter()
    g = generators.rmat(args.nodes, args.degree * args.nodes, args.labels, seed=0)
    session = GraphSession.open(g, backend="local", device=args.device)
    print(f"loaded in {time.perf_counter() - t0:.1f}s ({g.n_edges} edges)")

    rng = np.random.default_rng(0)
    workload = mixed_workload(g, args.n_queries, n_labels=args.labels, rng=rng)

    server = session.serve(
        max_inflight=args.max_inflight,
        max_matches=1024,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
    )
    t0 = time.perf_counter()
    outcomes = server.serve(workload)
    wall = time.perf_counter() - t0

    s = summarize_outcomes(outcomes)
    ttfp_ms = np.sort([o.ttfp_s * 1e3 for o in outcomes if o.ttfp_s is not None])
    print(f"\n{s['served']} served / {s['partial']} partial / "
          f"{s['failed']} failed in {wall:.1f}s "
          f"({len(workload) / wall:.2f} qps, {s['n_matches']} total matches)")
    if len(ttfp_ms):
        print(f"time-to-first-page p50={ttfp_ms[len(ttfp_ms) // 2]:.0f}ms "
              f"p90={ttfp_ms[int(len(ttfp_ms) * 0.9)]:.0f}ms "
              f"p99={ttfp_ms[min(len(ttfp_ms) - 1, int(len(ttfp_ms) * 0.99))]:.0f}ms")
    print(f"scheduler: {server.stats.join_quanta} block-join quanta across "
          f"{len(server.stats.buckets)} shape buckets "
          f"({server.stats.warm_admissions} warm admissions, "
          f"{server.stats.global_degradations} global degradations)")
    print(f"step cache: {session.cache.hits} hits, "
          f"{session.cache.misses} misses over the workload")
    return {"outcomes": outcomes, "summary": s, "stats": server.stats}


if __name__ == "__main__":
    main()
