"""The port's xDeepFM scoring path against the JAX package on the CPU.

The same seeded numpy inputs and the JAX package's own parameters
(``repro.models.recsys.init``, carried over by `params_from_jax`) go
through both packages. Tolerances are fp32 ones, ``rtol=1e-5, atol=1e-6``:
the two sum the same products in other orders (the smoke logits are ~0.03
in size). The JAX side runs its ``jnp`` functions, never Pallas.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import xdeepfm as jax_xdeepfm  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.kernels.cin.ref import cin_layer_reference  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro_torch.configs import RecSysConfig, xdeepfm  # noqa: E402
from repro_torch.core.backend import get_kernels  # noqa: E402
from repro_torch.data.pipeline import recsys_batch  # noqa: E402
from repro_torch.kernels.cin.cin import cin_layer  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.train.step import make_serve_fns  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
# H != m at every CIN layer (H0 = m = 5, then 7 and 3), other widths than the smoke's
NARROW = RecSysConfig(name="narrow", n_sparse=5, embed_dim=4, vocab_per_field=50,
                      cin_layers=(7, 3), mlp_layers=(8,), bag_size=2)
CONFIGS = {"smoke": xdeepfm.smoke(), "narrow-h-ne-m": NARROW}


def jax_cfg(cfg):
    from repro.configs.base import RecSysConfig as JaxRecSysConfig

    return JaxRecSysConfig(**dataclasses.asdict(cfg))


def jax_params(cfg):
    return copy.deepcopy(_jax_params(cfg))


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    """The JAX package's parameters as numpy (one jitted init per config),
    with its zero-initialised leaves (linear, bias, dnn biases) made
    random, so every leaf counts."""
    init = jax.jit(lambda key: jax_recsys.init(jax_cfg(cfg), key))
    params = jax.tree.map(np.array, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif not v.any():
                tree[k] = (rng.normal(size=v.shape) * 0.05).astype(np.float32)

    fill(params)
    return params


@pytest.mark.parametrize("shape", [(3, 5, 4, 6, 7), (2, 3, 7, 1, 2), (4, 6, 6, 10, 65)],
                         ids=["h5-m4", "h3-m7-d1", "h-eq-m-ragged-hp"])
@pytest.mark.parametrize("fn", [get_kernels("torch").cin_layer, get_kernels("cuda").cin_layer,
                                cin_layer], ids=["torch", "cuda-backend", "cuda-wrapper"])
def test_cin_layer(fn, shape):
    B, H, m, d, Hp = shape
    rng = np.random.default_rng(sum(shape))
    xk = rng.normal(size=(B, H, d)).astype(np.float32)
    x0 = rng.normal(size=(B, m, d)).astype(np.float32)
    w = rng.normal(size=(H * m, Hp)).astype(np.float32)
    got = fn(torch.from_numpy(xk), torch.from_numpy(x0), torch.from_numpy(w))
    want = np.asarray(cin_layer_reference(xk, x0, w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("N,Hp,H,want", [(5120, 200, 200, 3),       # serve_p99: 80 tiles
                                         (2621440, 200, 200, 1),    # serve_bulk
                                         (8448, 16, 2, 1),          # 132 tiles: one wave
                                         (610, 200, 200, 8),        # 10 tiles: the most parts
                                         (70, 12, 3, 3)])           # no more parts than h
def test_cin_splits_fill_the_card(N, Hp, H, want):
    """The CUDA kernel's parts of the h range on a 132-SM card."""
    from repro_torch.kernels.cin.cin import splits

    assert splits(N, Hp, H, 132) == want


def test_cin_layer_index_is_h_major():
    # one nonzero weight row z = h*m + m' picks xk[:, h] * x0[:, m']
    B, H, m, d = 2, 3, 4, 5
    rng = np.random.default_rng(0)
    xk = torch.from_numpy(rng.normal(size=(B, H, d)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(size=(B, m, d)).astype(np.float32))
    w = torch.zeros(H * m, 1)
    w[2 * m + 1, 0] = 1.0
    torch.testing.assert_close(cin_layer(xk, x0, w)[:, 0], xk[:, 2] * x0[:, 1])


def test_recsys_batch_is_the_references():
    cfg = xdeepfm.smoke()
    a = recsys_batch(cfg, 64, seed=3, step=2)
    b = jax_pipeline.recsys_batch(jax_cfg(cfg), 64, seed=3, step=2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name, kernels):
    cfg = CONFIGS[name]
    params = jax_params(cfg)
    model = recsys.params_from_jax(cfg, params, device="cpu", kernels=kernels)
    assert model.kernels.name == kernels
    batch = recsys_batch(cfg, 16, seed=0, step=0)
    want = np.asarray(jax_recsys.forward(jax_cfg(cfg), params, batch["ids"], batch["bag_mask"]))
    got = make_serve_fns(cfg, model)["score"](batch["ids"], batch["bag_mask"])
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_retrieval_score_matches_jax(name):
    cfg = CONFIGS[name]
    params = jax_params(cfg)
    model = recsys.params_from_jax(cfg, params, device="cpu")
    batch = recsys_batch(cfg, 1, seed=4, step=0)
    cand = np.random.default_rng(5).integers(0, cfg.vocab_per_field, 33).astype(np.int32)
    want = np.asarray(jax_recsys.retrieval_score(
        jax_cfg(cfg), params, batch["ids"], batch["bag_mask"], cand))
    got = make_serve_fns(cfg, model)["retrieve"](batch["ids"], batch["bag_mask"], cand)
    assert got.shape == (33,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags_match_jax(mode):
    rng = np.random.default_rng(8)
    tables = rng.normal(size=(3, 20, 4)).astype(np.float32)
    ids = rng.integers(0, 20, (6, 3, 2)).astype(np.int32)
    mask = rng.random((6, 3, 2)) < 0.6
    np.testing.assert_allclose(
        recsys.embedding_bag(torch.from_numpy(tables), torch.from_numpy(ids),
                             torch.from_numpy(mask), mode=mode).numpy(),
        np.asarray(jax_recsys.embedding_bag(tables, ids, mask, mode=mode)), **TOL)
    flat = rng.integers(0, 20, 17).astype(np.int32)
    bags = np.sort(rng.integers(0, 5, 17)).astype(np.int32)  # bag 5 of 6 stays empty
    np.testing.assert_allclose(
        recsys.embedding_bag_ragged(torch.from_numpy(tables[0]), torch.from_numpy(flat),
                                    torch.from_numpy(bags), 6, mode=mode).numpy(),
        np.asarray(jax_recsys.embedding_bag_ragged(tables[0], flat, bags, 6, mode=mode)), **TOL)


def test_parameters_keep_the_jax_layout_and_init_kinds():
    cfg = RecSysConfig(name="wide", n_sparse=8, embed_dim=16, vocab_per_field=4000,
                       cin_layers=(32,), mlp_layers=(64,), bag_size=1)
    model = recsys.XDeepFM(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    abstract = jax.eval_shape(lambda k: jax_recsys.init(jax_cfg(cfg), k), jax.random.PRNGKey(0))
    jax_shapes = jax.tree.map(lambda a: a.shape, abstract)
    got = {}
    for name, p in model.named_parameters():
        assert not p.requires_grad
        node = got
        *groups, leaf = name.split(".")
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = tuple(p.shape)
    assert got == jax_shapes
    assert abs(model.tables.std().item() / 0.02 - 1) < 0.02
    assert abs(model.cin["w0"].std().item() / np.sqrt(2 / 64) - 1) < 0.05  # he, fan-in 8·8
    assert abs(model.user_proj.std().item() / np.sqrt(1 / 128) - 1) < 0.05  # lecun
    assert not model.linear.any() and not model.dnn["b0"].any()


def test_params_from_jax_refuses_other_shapes():
    cfg = xdeepfm.smoke()
    params = jax_params(cfg)
    params["cin"]["w1"] = params["cin"]["w1"].T
    with pytest.raises(ValueError, match="cin.w1"):
        recsys.params_from_jax(cfg, params, device="cpu")


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None opens the model on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys.XDeepFM(xdeepfm.smoke())


def test_serve_fns_refuse_other_families():
    """The refusal names the families the port serves (training is ported,
    so it no longer names that); an MLA + MoE LM config (deepseek-v3's smoke
    config) serves."""
    from repro_torch.configs import deepseek_v3_671b
    from repro_torch.models.transformer import Transformer

    model = recsys.XDeepFM(xdeepfm.smoke(), device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"the port serves the LM, GNN and recsys families$"):
        make_serve_fns(object(), model)
    with pytest.raises(ValueError, match="built for"):
        make_serve_fns(NARROW, model)
    cfg = deepseek_v3_671b.smoke()
    logits, cache = make_serve_fns(cfg, Transformer(cfg, device="cpu"))["prefill"](
        np.zeros((1, 4), np.int32))
    assert logits.shape == (1, 4, cfg.vocab_size) and cache.kind == "mla"
