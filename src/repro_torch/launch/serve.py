"""Serving launcher: subgraph-query serving (the paper's workload) through
the continuous-batching server, or LM decode serving, selected by
``--arch``. The port's copy of the JAX package's ``launch/serve.py``; it
runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stwig --n-queries 20
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --tokens 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api import GraphSession, summarize_outcomes
from repro_torch.core.backend import resolve_device
from repro_torch.graphstore import generators
from repro_torch.models.transformer import Transformer, init_cache
from repro_torch.train.step import make_serve_fns
from repro_torch.workloads import mixed_workload


def lm_archs() -> list[str]:
    """The registered LM arch ids (``--arch`` values other than ``stwig``)."""
    return sorted(a for a, e in configs.all_archs().items() if e.family == "lm")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_stwig(args) -> None:
    entry = configs.get("stwig")
    cfg = entry.smoke() if args.smoke else entry.config
    n = min(cfg.n_nodes, args.max_nodes)
    print(f"loading {n}-node graph ...")
    g = generators.rmat(n, cfg.avg_degree * n, cfg.n_labels, seed=0)
    session = GraphSession.open(g, backend="local", device=args.device)
    workload = mixed_workload(g, args.n_queries, n_labels=cfg.n_labels,
                              rng=np.random.default_rng(0))

    server = session.serve(
        max_inflight=args.max_inflight,
        max_matches=cfg.max_matches,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
    )
    t0 = time.perf_counter()
    outcomes = server.serve(workload)
    wall = time.perf_counter() - t0
    for o in outcomes:
        # a partial answer must say so (and why): first-K truncation has no
        # degrade reason, a guard trip / shard fault carries a typed one
        status = ""
        if o.status != "served":
            status = f"  [{o.status}: {o.stats.degrade_reason or o.error or 'overflow'}]"
        ttfp = "-" if o.ttfp_s is None else f"{o.ttfp_s*1e3:.0f} ms"
        print(f"  {o.n_matches} matches, first page in {ttfp}{status}")
    # a query counts as served only when it completed cleanly — guard
    # trips/overflows are partial, per-query exceptions are failed
    s = summarize_outcomes(outcomes)
    print(f"{s['served']} served / {s['partial']} partial / {s['failed']} "
          f"failed in {wall:.1f}s "
          f"({len(outcomes)/wall:.2f} qps over {server.stats.join_quanta} "
          f"block-join quanta, {server.stats.global_degradations} global "
          f"degradations; cache: {session.cache.hits} hits / "
          f"{session.cache.misses} misses; kernels {session.kernels.name!r} "
          f"on {session.device})")


def serve_lm(args) -> None:
    if args.arch not in lm_archs():
        raise SystemExit(f"unknown --arch {args.arch!r}; stwig or one of {lm_archs()}")
    cfg = configs.get(args.arch).smoke()
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    fns = make_serve_fns(cfg, Transformer(cfg, generator=gen, device=dev))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, 8),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = fns["prefill"](prompt)
    grown = init_cache(cfg, args.batch, 8 + args.tokens, device=dev)
    for z, c in zip(grown.data, cache.data):
        z[:, :, :8] = c
    tok = logits[:, -1:].argmax(-1)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        logits, grown = fns["decode"](grown, tok, 8 + i)
        tok = logits.argmax(-1)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens × batch {args.batch} in {dt:.2f}s "
          f"({args.tokens*args.batch/dt:.0f} tok/s on {dev}, smoke config)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stwig")
    ap.add_argument("--n-queries", type=int, default=10)
    ap.add_argument("--max-nodes", type=int, default=50_000)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-query deadline (0 = none); expired queries "
                    "return partial results marked [partial: deadline]")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="concurrent queries the server interleaves "
                    "block-join quanta across (continuous batching)")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.arch == "stwig":
        serve_stwig(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
