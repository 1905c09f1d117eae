"""The dense LM served on a mesh of gloo ranks on the CPU, against the JAX
package's one-device ``prefill`` / ``decode_step``.

The JAX package's own parameters (``repro.models.transformer.init``, the
zero-initialised leaves made random, as ``tests/test_torch_lm.py`` does)
are carried onto the mesh by ``params_from_jax(..., mesh=, rules=)``: each
rank keeps its own chunk of every leaf. The ranks (`spawn_ranks`, the rank
function ``tests/mesh_fns.py::lm_rank``) serve the same tokens through
``make_serve_fns``: the prefill under ``make_rules(cfg, "prefill", mesh)``
(heads, MLP and vocab over ``model``, the batch and the FSDP dims over
``data``), the cache moved once to the ``decode`` placements (its slots
over ``model``), then three decode steps. Configs: gemma-2b smoke (MQA, 4
heads on 1) and qwen2-72b smoke with window 40 and softcap 30 (GQA, 4 heads
on 2, QKV bias: on the 4-rank ``model`` axis each rank's one q head reads
kv head ``r // 2``, the GQA slice), both on ``(data=2, model=2)`` and
``(model=4)``; fp32.

Tolerances are ``tests/test_torch_lm.py``'s: logits within ``1e-4 ·`` each
row's max|jax|, caches within ``1e-5 ·`` the cache's max|jax|.

Also here: `logical` is a no-op without rules and on a plain tensor, and
the one-process forward keeps its bits; the elastic restore of a
checkpoint written on 4 ranks onto 2 against the JAX package's
uninterrupted run.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mesh_fns  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.configs.base import LMConfig as JaxLMConfig  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import gemma_2b  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import axis_rules, logical, spawn_ranks  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

B, S, N_DECODE = 2, 16, 3
CASES = {
    "gemma-2b": ("gemma-2b", {}),
    "qwen2-72b-w40-sc30": ("qwen2-72b", dict(sliding_window=40, attn_logit_softcap=30.0)),
}
MESHES = {"data2-model2": {"data": 2, "model": 2}, "model4": {"model": 4}}


def jax_cfg(cfg):
    return JaxLMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@functools.lru_cache(maxsize=None)
def jax_run(case: str):
    """JAX params (numpy), tokens, decode tokens, the prefill's logits and
    cache, and the decode steps' logits and final cache."""
    cfg = mesh_fns._cfg(*CASES[case])
    jcfg = jax_cfg(cfg)
    params = jax.tree.map(np.array, jax.jit(lambda key: jax_tf.init(jcfg, key))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif not v.any():
                tree[k] = (rng.normal(size=v.shape) * 0.1).astype(v.dtype)

    fill(params)
    tokens = pipeline.lm_batch(cfg, B, S, seed=0, step=0)["tokens"]
    logits, cache = jax.jit(lambda p, t: jax_tf.prefill(jcfg, p, t))(params, tokens)
    grown = tuple(jnp.concatenate([c, jnp.zeros(c.shape[:2] + (N_DECODE,) + c.shape[3:], c.dtype)],
                                  axis=2) for c in cache.data)
    jcache = jax_tf.DecodeCache(grown, "gqa", S + N_DECODE, False)
    step = jax.jit(functools.partial(jax_tf.decode_step, jcfg))
    decode_tokens = rng.integers(0, cfg.vocab_size, (N_DECODE, B, 1)).astype(np.int32)
    steps = []
    for i, tok in enumerate(decode_tokens):
        lg, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(S + i))
        steps.append(np.asarray(lg))
    return dict(params=params, tokens=tokens, decode_tokens=decode_tokens,
                logits=np.asarray(logits), cache=[np.asarray(c) for c in cache.data],
                decode=steps, cache_after=[np.asarray(c) for c in jcache.data])


def assert_rows_close(got, want, tol=1e-4):
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= tol * scale).all(), np.max(np.abs(got - want) / scale)


def assert_cache_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


@functools.lru_cache(maxsize=None)
def mesh_runs() -> dict:
    """Every case on every mesh, served by one world of 4 gloo ranks:
    ``{(case, mesh): [each rank's result]}``."""
    keys = [(c, m) for c in CASES for m in MESHES]
    jobs = [("cpu", MESHES[m], *CASES[c], jax_run(c)["tokens"], jax_run(c)["decode_tokens"],
             jax_run(c)["params"]) for c, m in keys]
    res = spawn_ranks(mesh_fns.lm_jobs_rank, 4, jobs, timeout=600)
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lm_matches_jax(case, mesh):
    """Prefill logits and cache, three decode steps' logits and the cache
    after them, from every rank, equal the JAX package's one-device run;
    the logits come back as DTensors; the decode cache's slots shard over
    ``model``."""
    want = jax_run(case)
    res = mesh_runs()[(case, mesh)]
    for r in res:
        assert r["same_chunks"]  # `distribute_params` of the whole model: the same chunks
        assert r["logits_type"] == "DTensor"
        assert_rows_close(r["logits"], want["logits"])
        assert_cache_close(r["cache"], want["cache"])
        for got, w in zip(r["decode"], want["decode"]):
            assert_rows_close(got, w)
        assert_cache_close(r["cache_after"], want["cache_after"])
        assert "Shard(dim=2)" in r["decode_cache_placements"]
    # every rank holds a chunk: the parameter bytes a rank sum to the
    # model's over the ranks that share no chunk
    total = sum(v.size * v.dtype.itemsize for v in jax.tree.leaves(want["params"]))
    assert all(r["param_bytes"] < total for r in res)


def test_logical_is_a_no_op_off_the_mesh():
    """Without rules `logical` returns its argument; under rules a plain
    tensor passes through too; the one-process forward's logits are bitwise
    those of a forward with rules active and no mesh parameter."""
    x = torch.randn(2, 3)
    assert logical(x, "batch", "embed") is x
    with axis_rules(None, {"batch": "data"}):
        assert logical(x, "batch", "embed") is x
    cfg = gemma_2b.smoke()
    model = transformer.Transformer(cfg, device="cpu")
    tokens = torch.from_numpy(pipeline.lm_batch(cfg, 2, 8, seed=0, step=0)["tokens"])
    with torch.inference_mode():
        plain = model(tokens)[0]
        with axis_rules({"data": 2, "model": 2}, {"batch": "data", "heads": "model"}):
            ruled = model(tokens)[0]
    assert torch.equal(plain, ruled)


def _jax_elastic_reference(steps: int) -> np.ndarray:
    """The JAX package's uninterrupted run: ``steps`` AdamW steps on one
    device (``tests/test_elastic_multidevice.py``'s loss and optimizer)."""
    target = jnp.asarray(np.random.default_rng(0).normal(size=(8, 64)), jnp.float32)
    cfg = jax_optim.AdamWConfig(lr=0.05, weight_decay=0.0)

    @jax.jit
    def step(params, state):
        g = jax.grad(lambda p: jnp.mean((p["w"] - target) ** 2))(params)
        params, state, _ = jax_optim.update(cfg, g, state, params)
        return params, state

    params = {"w": jnp.zeros((8, 64), jnp.float32)}
    state = jax_optim.init(cfg, params)
    for _ in range(steps):
        params, state = step(params, state)
    return np.asarray(params["w"])


def test_elastic_restore_from_4_to_2_ranks_matches_jax(tmp_path):
    """10 steps on 4 ranks with ``w (8, 64)`` sharded by rows, a checkpoint
    (each leaf gathered, rank 0 writes), `elastic_restore` onto a mesh of 2
    ranks, 10 more steps: the result equals the JAX package's
    uninterrupted 20 steps on one device within 1e-5, with ``step == 10``."""
    target = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    first = spawn_ranks(mesh_fns.elastic_rank, 4, str(tmp_path), target, "save", timeout=300)
    assert all(r["step"] == 10 for r in first)
    second = spawn_ranks(mesh_fns.elastic_rank, 2, str(tmp_path), target, "restore", timeout=300)
    want = _jax_elastic_reference(20)
    for r in second:
        assert r["step"] == 10
        assert r["placements"] == "(Shard(dim=0),)"
        np.testing.assert_allclose(r["w"], want, rtol=0, atol=1e-5)


def test_decode_layer_chain_and_grow_cache_keep_the_one_process_bits():
    """`grow_cache` of a plain cache equals the prefill's cache with empty
    slots after it; `Transformer.decode_layer` layer by layer, then the
    head, gives `decode_step`'s logits and cache bit for bit."""
    cfg = gemma_2b.smoke()
    model = transformer.Transformer(cfg, device="cpu")
    tokens = torch.from_numpy(pipeline.lm_batch(cfg, 2, 8, seed=0, step=0)["tokens"])
    with torch.inference_mode():
        logits, cache = model.prefill(tokens)
        grown = transformer.grow_cache(cache, 11)
        assert grown.s_cap == 11 and not grown.rolling
        for g, c in zip(grown.data, cache.data):
            assert torch.equal(g[:, :, :8], c) and not g[:, :, 8:].any()
        again = transformer.grow_cache(cache, 11)
        tok = logits[:, -1:].argmax(-1)
        want, _ = model.decode_step(grown, tok, 8)
        x = model.embed_tokens(tok)
        for l in range(cfg.n_layers):
            x = model.decode_layer(l, x, again, 8)
        assert torch.equal(model.head(x), want)
        for a, b in zip(again.data, grown.data):
            assert torch.equal(a, b)
