"""The port's LM serving path against the JAX package on the CPU.

The JAX package's own parameters (``repro.models.transformer.init``, with
its zero-initialised leaves — norms, QKV biases — made random so every leaf
counts) are carried over by `params_from_jax`; the same ``lm_batch`` tokens
go through ``repro.models.transformer.prefill`` / ``decode_step`` and the
port's ``make_serve_fns(cfg, model)["prefill"]`` / ``["decode"]``. On the
CPU the port runs the plain versions (``mha_reference`` for every prefill
attention). Configs: the gemma-2b and qwen2-72b smoke configs (MQA with
G = 4; GQA with G = 2 and QKV bias), each as published, with
``sliding_window=8`` and with ``attn_logit_softcap=30.0``; all fp32.

Tolerances: logits within ``1e-4 ·`` each row's max|jax| (fp32 both, but
XLA's CPU exp/tanh/rsqrt and summation orders differ from PyTorch's); caches
within ``1e-5 ·`` max|jax| of the cache; `layers` functions at
``rtol=1e-5, atol=1e-6``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import LMConfig as JaxLMConfig  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import gemma_2b, qwen2_72b  # noqa: E402
from repro_torch.core.backend import get_kernels  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import layers, schema, transformer  # noqa: E402
from repro_torch.train.step import make_serve_fns  # noqa: E402

VARIANTS = {"plain": {}, "window8": dict(sliding_window=8),
            "softcap30": dict(attn_logit_softcap=30.0)}
CONFIGS = {f"{mod.__name__.rsplit('.', 1)[1]}-{v}": dataclasses.replace(mod.smoke(), **kw)
           for mod in (gemma_2b, qwen2_72b) for v, kw in VARIANTS.items()}
B, S, N_DECODE = 2, 16, 4


def jax_cfg(cfg):
    return JaxLMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """JAX params (numpy), tokens, prefill logits and cache of a config."""
    cfg = CONFIGS[name]
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
    return params, tokens, np.asarray(logits), tuple(np.asarray(c) for c in cache.data)


def port_model(name):
    cfg = CONFIGS[name]
    return cfg, transformer.params_from_jax(cfg, jax_run(name)[0], device="cpu")


def assert_rows_close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert (scale > 0).all()
    assert (np.abs(got - want) <= tol * scale).all(), np.max(np.abs(got - want) / scale)


def assert_cache_close(got, want):
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_lm_batch_matches_jax():
    cfg = gemma_2b.smoke()
    for step in (0, 3):
        np.testing.assert_array_equal(
            pipeline.lm_batch(cfg, 3, 40, seed=7, step=step)["tokens"],
            jax_pipeline.lm_batch(jax_cfg(cfg), 3, 40, seed=7, step=step)["tokens"])


def test_schema_and_dtypes_follow_jax():
    """Leaf names, shapes and dtypes equal the JAX schema's; bf16 weights
    with fp32 norms at the published dtype."""
    cfg = dataclasses.replace(gemma_2b.smoke(), dtype="bfloat16")
    model = transformer.Transformer(cfg, device="cpu")
    want = jax.eval_shape(lambda k: jax_tf.init(jax_cfg(cfg), k), jax.random.PRNGKey(0))
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, leaf in flat.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
    assert got["embed"].dtype == torch.bfloat16 and got["norm_attn"].dtype == torch.float32
    ones = schema.init_param((3, 2), "ones", torch.Generator(), "cpu", "bfloat16")
    assert torch.equal(ones, torch.ones((3, 2), dtype=torch.bfloat16))


def test_params_from_jax_keeps_each_dtype():
    cfg = dataclasses.replace(qwen2_72b.smoke(), dtype="bfloat16")
    params = jax.tree.map(np.array, jax.jit(lambda key: jax_tf.init(jax_cfg(cfg), key))(
        jax.random.PRNGKey(3)))
    model = transformer.params_from_jax(cfg, params, device="cpu")
    assert model.attn["wq"].dtype == torch.bfloat16 and model.final_norm.dtype == torch.float32
    # bf16 -> fp32 -> bf16 is exact
    np.testing.assert_array_equal(model.attn["wq"].float().numpy(),
                                  params["attn"]["wq"].astype(np.float32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_jax(name):
    """Prefill logits row by row and the prefill cache; ``forward`` without
    the cache gives the same logits."""
    _, tokens, want_logits, want_cache = jax_run(name)
    cfg, model = port_model(name)
    logits, cache = make_serve_fns(cfg, model)["prefill"](tokens)
    assert_rows_close(logits, want_logits)
    assert cache.s_cap == S and not cache.rolling and cache.kind == "gqa"
    assert_cache_close(cache.data, want_cache)
    with torch.inference_mode():
        again, kv = model(torch.from_numpy(tokens))
    assert kv is None
    torch.testing.assert_close(again, logits, rtol=0, atol=0)


def _grown(cfg, cache_np, rolling):
    """The prefill cache grown by ``N_DECODE`` slots (as ``serve_lm`` does),
    or folded into a rolling cache of ``sliding_window`` slots (slot = pos %
    cap)."""
    cap = cfg.sliding_window if rolling else S + N_DECODE
    out = []
    for c in cache_np:
        d = np.zeros(c.shape[:2] + (cap,) + c.shape[3:], c.dtype)
        if rolling:
            for p in range(S - cap, S):
                d[:, :, p % cap] = c[:, :, p]
        else:
            d[:, :, :S] = c
        out.append(d)
    return cap, out


@pytest.mark.parametrize("name,rolling", [(n, False) for n in CONFIGS] + [
    (n, True) for n in CONFIGS if CONFIGS[n].sliding_window])
def test_decode_matches_jax(name, rolling):
    """``N_DECODE`` greedy decode steps after the prefill: logits row by row
    and the cache after the last step (a rolling cache wraps at once)."""
    params, _, logits, cache_np = jax_run(name)
    cfg, model = port_model(name)
    cap, data = _grown(cfg, cache_np, rolling)
    jcache = jax_tf.DecodeCache(tuple(jnp.asarray(d) for d in data), "gqa", cap, rolling)
    cache = transformer.DecodeCache(tuple(torch.from_numpy(d.copy()) for d in data), "gqa",
                                    cap, rolling)
    step = jax.jit(functools.partial(jax_tf.decode_step, jax_cfg(cfg)))
    decode = make_serve_fns(cfg, model)["decode"]
    tok = logits[:, -1:].argmax(-1).astype(np.int32)
    for i in range(N_DECODE):
        want, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(S + i))
        got, cache = decode(cache, tok, S + i)
        want = np.asarray(want)
        assert got.shape == (B, 1, cfg.vocab_size)
        assert_rows_close(got, want)
        tok = want.argmax(-1).astype(np.int32)
    assert_cache_close(cache.data, [np.asarray(c) for c in jcache.data])


def test_init_cache_matches_jax():
    cfg = CONFIGS["gemma_2b-window8"]
    for rolling in (False, True):
        want = jax_tf.init_cache(jax_cfg(cfg), 3, 20, rolling=rolling)
        got = transformer.init_cache(cfg, 3, 20, rolling=rolling, device="cpu")
        assert (got.kind, got.s_cap, got.rolling) == (want.kind, want.s_cap, want.rolling)
        assert [tuple(d.shape) for d in got.data] == [d.shape for d in want.data]
    with pytest.raises(ValueError, match="sliding window"):
        transformer.init_cache(gemma_2b.smoke(), 1, 8, rolling=True, device="cpu")


def test_prefill_goes_through_the_kernels_op():
    """Every prefill attention is one ``Kernels.flash_attention`` call (one
    a layer); decode calls it never."""
    from repro_torch.core.backend import Kernels

    class Counting(Kernels):
        calls = 0

        def flash_attention(self, q, k, v, **kw):
            Counting.calls += 1
            return super().flash_attention(q, k, v, **kw)

    name = "qwen2_72b-window8"
    _, tokens, _, _ = jax_run(name)
    cfg = CONFIGS[name]
    model = transformer.Transformer(cfg, device="cpu", kernels=Counting())
    fns = make_serve_fns(cfg, model)
    _, cache = fns["prefill"](tokens)
    assert Counting.calls == cfg.n_layers
    cap, data = _grown(cfg, [d.numpy() for d in cache.data], False)
    fns["decode"](transformer.DecodeCache(tuple(map(torch.from_numpy, data)), "gqa", cap,
                                          False), tokens[:, :1], S)
    assert Counting.calls == cfg.n_layers


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None opens the model on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.Transformer(gemma_2b.smoke())
    model = transformer.Transformer(gemma_2b.smoke(), device="cpu")
    assert model.kernels.name == "torch"
    with pytest.raises(ValueError, match="built for"):
        make_serve_fns(qwen2_72b.smoke(), model)


def test_decode_refuses_a_position_past_the_cache():
    cfg = gemma_2b.smoke()
    model = transformer.Transformer(cfg, device="cpu")
    cache = transformer.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        make_serve_fns(cfg, model)["decode"](cache, np.zeros((1, 1), np.int32), 4)


# ------------------------------------------------------------------ layers
def _qkv(seed, B, Sq, Skv, Nkv, G, H):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Nkv * G, H)).astype(np.float32),
            rng.normal(size=(B, Skv, Nkv, H)).astype(np.float32),
            rng.normal(size=(B, Skv, Nkv, H)).astype(np.float32))


@pytest.mark.parametrize("branch", ["naive", "chunked"])
@pytest.mark.parametrize("window,softcap,holes", [(None, None, False), (100, 30.0, True)])
def test_attention_matches_jax(branch, window, softcap, holes):
    """Both branches of `layers.attention`: the chunked one runs above
    ``_NAIVE_LIMIT`` logits (2,560² at narrow heads), with empty slots
    (``pos_k = -1``) in the keys."""
    Sq = Skv = 2560 if branch == "chunked" else 48
    assert (Sq * Skv > layers._NAIVE_LIMIT) == (branch == "chunked")
    q, k, v = _qkv(Sq + (window or 0), 1, Sq, Skv, 1, 2, 4)
    pos_q = np.arange(Sq, dtype=np.int32)
    pos_k = np.arange(Skv, dtype=np.int32)
    if holes:
        pos_k[::7] = -1
    jax_attention = jax.jit(functools.partial(jax_layers.attention, window=window,
                                              softcap=softcap))
    want = np.asarray(jax_attention(q, k, v, pos_q, pos_k))
    got = layers.attention(*map(torch.from_numpy, (q, k, v, pos_q, pos_k)), window=window,
                           softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_blocked_decode_attention_matches_jax(window, softcap):
    q, k, v = _qkv(5, 2, 1, 64, 2, 3, 8)
    pos = 50
    pos_q = np.array([pos], np.int32)
    pos_k = np.arange(64, dtype=np.int32)
    pos_k[pos + 1:] = -1
    jax_blocked = jax.jit(functools.partial(jax_layers.blocked_decode_attention, n_blocks=4,
                                            window=window, softcap=softcap))
    want = np.asarray(jax_blocked(q, k, v, pos_q, pos_k))
    got = layers.blocked_decode_attention(*map(torch.from_numpy, (q, k, v, pos_q, pos_k)), 4,
                                          window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the split-KV combine equals one softmax over the whole cache
    one = layers.attention(*map(torch.from_numpy, (q, k, v, pos_q, pos_k)), window=window,
                           softcap=softcap)
    torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-6)


def test_small_layers_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jax_layers.apply_rope(x, pos, 10000.0)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(layers.rope_freqs(16, 1e6), jax_layers.rope_freqs(16, 1e6))
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    sc = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(layers.rms_norm(torch.from_numpy(h), torch.from_numpy(sc),
                                               1e-6).numpy(),
                               np.asarray(jax_layers.rms_norm(h, sc, 1e-6)), rtol=1e-5, atol=1e-6)
    w = [rng.normal(size=s).astype(np.float32) * 0.3 for s in ((16, 24), (16, 24), (24, 16))]
    for act in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            layers.glu_mlp(torch.from_numpy(h), *map(torch.from_numpy, w), act).numpy(),
            np.asarray(jax_layers.glu_mlp(h, *w, act)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        layers.glu_mlp(torch.from_numpy(h), *map(torch.from_numpy, w), "relu")
    for window in (None, 3):
        np.testing.assert_array_equal(layers.causal_mask(4, 7, window=window).numpy(),
                                      np.asarray(jax_layers.causal_mask(4, 7, window=window)))


def test_plain_and_cuda_backends_agree_on_the_cpu():
    """On CPU tensors the CUDA backend's op takes the plain version."""
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 40, 40, 2, 2, 16))
    a = get_kernels("torch").flash_attention(q, k, v, window=9, softcap=30.0)
    b = get_kernels("cuda").flash_attention(q, k, v, window=9, softcap=30.0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
