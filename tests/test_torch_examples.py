"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``: the plain PyTorch versions), in process: the quickstart
and the sharded query at their default sizes, the served workload on a
2,000-node graph, the training loop for 2 steps. The quickstart's and the
sharded query's rows are held to the JAX package's local engine
(``kernels="jnp"``) on the same generator calls and queries. Without
``--device`` each runs on the card and raises when there is none."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.api import GraphSession as JGraphSession  # noqa: E402
from repro.core import QueryGraph as JQueryGraph  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro_torch.api import GraphSession  # noqa: E402
from repro_torch.core import QueryGraph  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The JAX engine compiles its steps at the examples' default capacities
# (65,536-row emission tables) for minutes on the CPU. The quickstart's
# explore emits 21 and 67 rows there and its join 774, the sharded query's
# join 271, so the reference runs at these smaller capacities; at the
# quickstart's, the port must also give the reference's rows in its order.
QUICKSTART_CAPS = dict(emission_budget=256, join_rows_cap=1024, join_dup_cap=64)
DISTRIBUTED_CAPS = dict(emission_budget=256, join_rows_cap=512, join_dup_cap=32)
QUICKSTART_QUERY = ([0, 1, 2, 3, 4, 5], [(0, 1), (1, 2), (1, 3), (3, 4), (3, 5)])
DISTRIBUTED_QUERY = ([0, 1, 2, 3], [(0, 1), (1, 2), (2, 3), (0, 2)])


def rows_set(rows):
    return set(map(tuple, np.asarray(rows).tolist()))


def test_quickstart_on_the_cpu():
    out = load("torch_quickstart").main(["--device", "cpu"])
    res = out["result"]
    assert res.n_matches == len(res.rows) > 0 and res.rows.shape[1] == 6
    assert 0 < out["streamed"] <= 512
    # the same graph and query (first 1,024 matches, no escalation) on the
    # JAX local engine: the example's rows, exactly
    labels, edges = QUICKSTART_QUERY
    g = jgen.rmat(n_nodes=2000, n_edges=8000, n_labels=24, seed=0)
    want = JGraphSession.open(g, backend="local", kernels="jnp").compile(
        JQueryGraph.build(labels=labels, edges=edges), max_matches=1024, **QUICKSTART_CAPS
    ).run(adaptive=False)
    assert rows_set(res.rows) == rows_set(want.rows) and res.complete == want.complete
    port = GraphSession.open(
        generators.rmat(n_nodes=2000, n_edges=8000, n_labels=24, seed=0), device="cpu"
    ).compile(QueryGraph.build(labels=labels, edges=edges), max_matches=1024, **QUICKSTART_CAPS)
    np.testing.assert_array_equal(port.run(adaptive=False).rows, np.asarray(want.rows))


def test_distributed_query_on_the_cpu():
    res = load("torch_distributed_query").main(["--device", "cpu"])["result"]
    assert res.stats.backend == "sharded" and res.stats.n_shards == 8
    assert res.complete and res.n_matches == len({tuple(r) for r in res.rows.tolist()}) > 0
    # every match, against the JAX local engine on the same graph
    labels, edges = DISTRIBUTED_QUERY
    g = jgen.ring_of_cliques(n_cliques=8, clique_size=12, n_labels=4, seed=0)
    want = JGraphSession.open(g, backend="local", kernels="jnp").run(
        JQueryGraph.build(labels=labels, edges=edges), max_matches=0, **DISTRIBUTED_CAPS)
    assert want.complete and rows_set(res.rows) == rows_set(want.rows)


def test_serve_queries_on_the_cpu():
    out = load("torch_serve_queries").main(
        ["--device", "cpu", "--n-queries", "6", "--nodes", "2000", "--degree", "4",
         "--labels", "8"])
    s = out["summary"]
    assert 0 < len(out["outcomes"]) <= 6 and s["failed"] == 0
    assert out["stats"].global_degradations == 0


def test_train_lm_on_the_cpu(tmp_path):
    out = load("torch_train_lm").main(
        ["--device", "cpu", "--steps", "2", "--ckpt", str(tmp_path / "ckpt")])
    hist = out["history"]
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    # float32 at head dim 32, 8 query heads on 4: the split-TF32 route; the
    # plain version on the CPU launches nothing
    assert out["route"] == "tf32" and out["launches"] == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("name", ["torch_quickstart", "torch_distributed_query",
                                  "torch_serve_queries", "torch_train_lm"])
def test_the_default_device_raises_without_a_card(name, tmp_path):
    argv = ["--ckpt", str(tmp_path / "ckpt")] if name == "torch_train_lm" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main(argv)
