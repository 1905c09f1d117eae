"""The port's GNN serving path against the JAX package on the CPU.

The same seeded numpy graphs and the JAX package's own parameters
(``repro.models.gnn.init``, carried over by `params_from_jax`) go through
``repro.models.gnn.forward`` and the port's ``make_serve_fns(cfg,
model)["infer"]``. Tolerance: ``1e-4 · max|jax|`` on the outputs — both
packages run fp32, but the port sums each node's messages in edge-sorted
order and gathers after a product where JAX gathers before it. The batch
pipeline and the sampler are numpy copies and must give equal arrays.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.graphstore import generators as jax_generators  # noqa: E402
from repro.graphstore import sampler as jax_sampler  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro_torch.configs import GNNConfig, egnn, gatedgcn, gin_tu, meshgraphnet  # noqa: E402
from repro_torch.configs.base import GNN_SHAPES  # noqa: E402
from repro_torch.core.backend import Kernels  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.graphstore.sampler import NeighborSampler  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train.step import make_serve_fns  # noqa: E402

SMOKE = {"gin": gin_tu.smoke(), "gatedgcn": gatedgcn.smoke(), "egnn": egnn.smoke(),
         "meshgraphnet": meshgraphnet.smoke()}


def jax_cfg(cfg):
    from repro.configs.base import GNNConfig as JaxGNNConfig

    return JaxGNNConfig(**dataclasses.asdict(cfg))


def jax_params(cfg):
    return copy.deepcopy(_jax_params(cfg))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    """The JAX package's parameters as numpy (one jitted init per config),
    with its zero-initialised leaves (biases, eps, norm gains) made random,
    so every leaf counts."""
    init = jax.jit(lambda key: jax_gnn.init(jax_cfg(cfg), key))
    params = jax.tree.map(np.array, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif not v.any():
                tree[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)

    fill(params)
    return params


def random_batch(cfg, seed, *, N=40, E=160, n_graphs=0):
    """Random edges (unsorted, repeated destinations, ~10% padded), every
    optional field the kind reads; ``n_graphs`` > 0 adds an interleaved
    ``graph_id`` and graph labels."""
    rng = np.random.default_rng(seed)
    return gnn.GraphBatch(
        node_feat=rng.normal(size=(N, cfg.d_in)).astype(np.float32),
        edge_src=rng.integers(0, N, E).astype(np.int32),
        edge_dst=rng.integers(0, N, E).astype(np.int32),
        node_mask=rng.random(N) < 0.9 if n_graphs else np.ones(N, bool),
        edge_mask=rng.random(E) < 0.9,
        edge_feat=rng.normal(size=(E, cfg.d_edge)).astype(np.float32) if cfg.d_edge else None,
        node_pos=rng.normal(size=(N, 3)).astype(np.float32) if cfg.kind == "egnn" else None,
        graph_id=rng.integers(0, n_graphs, N).astype(np.int32) if n_graphs else None,
        n_graphs=max(n_graphs, 1),
        labels=rng.integers(0, 5, n_graphs).astype(np.int32) if n_graphs else None,
    )


def jax_forward(cfg, params, g):
    jg = jax_gnn.GraphBatch(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                               for k, v in g._asdict().items()})
    return np.asarray(jax.jit(functools.partial(jax_gnn.forward, jax_cfg(cfg)))(params, jg))


def port_infer(cfg, params, g):
    model = gnn.params_from_jax(cfg, params, device="cpu")
    return make_serve_fns(cfg, model)["infer"](g).numpy()


def assert_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("kind", list(SMOKE))
def test_infer_matches_jax_forward(kind):
    cfg = SMOKE[kind]
    params = jax_params(cfg)
    g = random_batch(cfg, seed=len(kind))
    assert_close(port_infer(cfg, params, g), jax_forward(cfg, params, g))


@pytest.mark.parametrize("kind", ["gin", "gatedgcn"])
def test_graph_task_with_interleaved_graph_ids(kind):
    cfg = dataclasses.replace(SMOKE[kind], task="graph")
    params = jax_params(cfg)
    g = random_batch(cfg, seed=3, n_graphs=6)
    assert not (np.diff(g.graph_id) >= 0).all()  # not sorted: the port sorts it
    got = port_infer(cfg, params, g)
    assert got.shape == (6, cfg.n_classes)
    assert_close(got, jax_forward(cfg, params, g))


def test_gnn_padded_edges_are_inert():
    """The port's copy of ``tests/test_models.py::test_gnn_padded_edges_are_inert``:
    corrupting masked-out edges must not change anything."""
    cfg = GNNConfig(name="g", kind="gin", n_layers=2, d_hidden=16, d_in=8, n_classes=5)
    g = random_batch(cfg, seed=1)
    model = gnn.GNN(cfg, device="cpu")
    infer = make_serve_fns(cfg, model)["infer"]
    out1 = infer(g)
    bad = np.where(g.edge_mask, g.edge_src, (g.edge_src + 7) % 40).astype(np.int32)
    out2 = infer(g._replace(edge_src=bad))
    torch.testing.assert_close(out1, out2, rtol=0, atol=1e-6)


def test_every_aggregation_goes_through_segment_mp():
    """GIN: one ``segment_mp`` per layer; GatedGCN: two per layer; each on
    ascending destinations."""
    class Counting(Kernels):
        calls = 0

        def segment_mp(self, messages, dst_sorted, n_nodes):
            assert bool((dst_sorted[1:] >= dst_sorted[:-1]).all())
            Counting.calls += 1
            return super().segment_mp(messages, dst_sorted, n_nodes)

    for kind, per_layer in (("gin", 1), ("gatedgcn", 2)):
        cfg = SMOKE[kind]
        Counting.calls = 0
        gnn.GNN(cfg, device="cpu", kernels=Counting())(
            gnn.batch_to(random_batch(cfg, seed=0), "cpu"))
        assert Counting.calls == per_layer * cfg.n_layers


def test_schema_and_init_follow_jax():
    for cfg in SMOKE.values():
        want = jax.tree.map(lambda x: x.shape, jax_params(cfg))
        model = gnn.GNN(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        got = {}
        for name, p in model.named_parameters():
            node = got
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = tuple(p.shape)
        assert got == want
        assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="arrays"):
        gnn.params_from_jax(SMOKE["gin"], {**jax_params(SMOKE["gin"]), "extra": np.zeros(1)},
                            device="cpu")


@pytest.fixture(scope="module")
def graphs():
    return (generators.rmat(600, 3000, 4, seed=0), jax_generators.rmat(600, 3000, 4, seed=0))


@pytest.mark.parametrize("cfg", [SMOKE["gin"], SMOKE["egnn"], SMOKE["meshgraphnet"]],
                         ids=["gin", "egnn", "meshgraphnet"])
def test_gnn_full_batch_equals_jax(graphs, cfg):
    g, jg = graphs
    got = pipeline.gnn_full_batch(cfg, g, n_classes=5, seed=0)
    want = jax_pipeline.gnn_full_batch(jax_cfg(cfg), jg, n_classes=5, seed=0)
    for k, v in want._asdict().items():
        w = getattr(got, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(w, v, err_msg=k)
        else:
            assert w == v, k


def test_sampler_and_minibatch_equal_jax(graphs):
    g, jg = graphs
    cfg = SMOKE["gatedgcn"]
    s, js = NeighborSampler(g, (5, 3), seed=2), jax_sampler.NeighborSampler(jg, (5, 3), seed=2)
    assert s.capacities(16) == js.capacities(16) == (16 + 80 + 240, 80 + 240)
    seeds = np.arange(0, 600, 41)
    a, b = s.sample(seeds), js.sample(seeds)
    for k in ("nodes", "edge_src", "edge_dst", "edge_mask", "seed_mask"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.n_nodes == b.n_nodes
    got = pipeline.gnn_minibatch(cfg, g, s, batch_nodes=16, n_classes=5, seed=0, step=1)
    want = jax_pipeline.gnn_minibatch(jax_cfg(cfg), jg, js, batch_nodes=16, n_classes=5,
                                      seed=0, step=1)
    for k, v in want._asdict().items():
        w = getattr(got, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(w, v, err_msg=k)
        else:
            assert w == v, k


def test_minibatch_lg_capacities():
    """The chip run's GatedGCN batch: 1,024 seeds, fanouts (15, 10)."""
    s = NeighborSampler(generators.rmat(64, 256, 2, seed=0), (15, 10))
    assert s.capacities(1024) == (169_984, 168_960)
    assert GNN_SHAPES["minibatch_lg"]["e"] == 168_960


def test_serve_fn_on_minibatch_matches_jax(graphs):
    """GatedGCN served on a sampled minibatch (padded edges at node 0)."""
    g, jg = graphs
    cfg = SMOKE["gatedgcn"]
    b = pipeline.gnn_minibatch(cfg, g, NeighborSampler(g, (4, 3), seed=0), batch_nodes=8,
                               n_classes=5, seed=0, step=0)
    assert not b.edge_mask.all()
    params = jax_params(cfg)
    assert_close(port_infer(cfg, params, b), jax_forward(cfg, params, b))


def test_lm_configs_still_raise():
    """What the port does not serve still raises and names the families it
    serves; a MoE LM config, refused before, now builds and serves."""
    from repro_torch.configs import MoEConfig, gemma_2b
    from repro_torch.models.transformer import Transformer

    model = gnn.GNN(SMOKE["gin"], device="cpu")
    with pytest.raises(NotImplementedError, match="the port serves the LM, GNN and recsys "
                                                  "families$"):
        make_serve_fns(object(), model)
    moe = dataclasses.replace(gemma_2b.smoke(), moe=MoEConfig(n_experts=4, top_k=2,
                                                              d_ff_expert=32))
    lm = Transformer(moe, device="cpu")
    logits, cache = make_serve_fns(moe, lm)["prefill"](np.zeros((1, 5), np.int32))
    assert logits.shape == (1, 5, moe.vocab_size) and torch.isfinite(logits).all()
    assert cache.kind == "gqa" and "moe" in dict(lm.named_children())
    with pytest.raises(ValueError, match="built for"):
        make_serve_fns(SMOKE["egnn"], model)
