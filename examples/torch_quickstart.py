"""Quickstart of the PyTorch port: the `GraphSession` facade — open a graph,
compile a query (Algorithm 2 planning + static capacities), run it, stream
it — on the card (``--device cpu`` runs the plain PyTorch versions).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

`GraphSession.open` picks the right engine (local here; sharded for a
multi-shard partition), `session.compile` plans once, and the compiled
query can be run one-shot or streamed page by page with the paper's
pipelined first-K semantics (§6.1). Without a GPU the default device
raises; nothing falls back to the CPU.
"""
import argparse

from repro_torch.api import GraphSession
from repro_torch.core import QueryGraph
from repro_torch.core.decompose import stwig_order_selection
from repro_torch.graphstore import generators


def main(argv=None) -> dict:
    """Run the quickstart; returns the one-shot result and the streamed
    row count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # an R-MAT graph standing in for a real labeled network
    g = generators.rmat(n_nodes=2000, n_edges=8000, n_labels=24, seed=0)
    session = GraphSession.open(g, device=args.device)  # backend="auto" → local, 1 shard
    print(session)

    # the paper's running example shape: a 6-node query
    #     a - b - d - e      (labels are ints)
    #         |   |
    #         c   f
    q = QueryGraph.build(
        labels=[0, 1, 2, 3, 4, 5],
        edges=[(0, 1), (1, 2), (1, 3), (3, 4), (3, 5)],
    )

    dec = stwig_order_selection(q, session.pg.freq)
    print("STwig decomposition (Algorithm 2):")
    for t in dec.stwigs:
        print(f"  root q{t.root} (label {t.root_label}) -> children {t.children}")

    # compile once; run with the paper's pipelined serving semantics:
    # first 1024 matches (§6.1)
    compiled = session.compile(q, max_matches=1024)
    res = compiled.run(adaptive=False)
    print(f"\n{res.n_matches} matches (complete={res.complete}) "
          f"on kernels={compiled.kernels!r}")
    print("first rows (query-node order):")
    for row in res.rows[:5]:
        print("  ", row)
    print("\nper-STwig candidate rows:", res.stats.stwig_rows)
    print("join order:", res.stats.join_order)
    print(f"query time: {res.stats.time_s * 1e3:.1f} ms")

    # streaming delivery: pages arrive as join blocks finish, and stopping
    # early skips the remaining blocks' work entirely
    total = 0
    for page in compiled.stream(page_size=256, max_matches=512):
        total += page.rows.shape[0]
        print(f"  page {page.index}: {page.rows.shape[0]} rows (running total {total})")

    # cross-check a row
    for row in res.rows[: min(3, len(res.rows))]:
        for u, v in q.edges:
            assert row[v] in g.neighbors(row[u]) or row[u] in g.neighbors(row[v])
    print("edge-consistency spot check passed")
    return {"result": res, "streamed": total}


if __name__ == "__main__":
    main()
