"""The port's MoE and MLA LM families against the JAX package on the CPU.

``repro_torch.models.moe`` (routing, the global and grouped sort-based
dispatch, capacity drops, the bias update) and ``repro_torch.models.mla``
(the prefill attention and the absorbed decode) are held to
``repro.models.moe`` / ``repro.models.mla`` on the same numpy inputs; the
LM serving path (``make_serve_fns(cfg, model)``) to ``repro.models.
transformer`` with the JAX package's own parameters carried over by
`params_from_jax` (zero-initialised leaves — norms, QKV biases, the router
bias — made random so every leaf counts). Configs: the mixtral-8x22b,
deepseek-v3 and qwen1.5-110b smoke configs and a dense-FFN MLA config (as
``tests/test_models.py``'s), all fp32, as published; no full-width model
is built here. On the CPU the port runs the plain versions
(``mha_reference`` for every prefill attention).

Tolerances, as ``tests/test_torch_lm.py``'s: logits within ``1e-4 ·`` each
row's max|jax|, caches within ``1e-5 ·`` max|jax|; routing: expert ids
exact, combine weights within 1e-6; the MoE FFN and MLA outputs within
``1e-5 ·`` max|jax|.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_base  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import deepseek_v3_671b, mixtral_8x22b, qwen1_5_110b  # noqa: E402
from repro_torch.configs.base import LMConfig, MLAConfig, MoEConfig  # noqa: E402
from repro_torch.core.backend import Kernels, get_kernels  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import mla, moe, schema, transformer  # noqa: E402
from repro_torch.train.step import make_serve_fns  # noqa: E402

MLA_DENSE = LMConfig(
    name="mla-dense", n_layers=2, d_model=48, n_heads=3, n_kv_heads=3, d_head=16, d_ff=96,
    vocab_size=64, dtype="float32",
    mla=MLAConfig(q_lora_rank=24, kv_lora_rank=12, d_nope=16, d_rope=8, d_v=16))
CONFIGS = {"mixtral": mixtral_8x22b.smoke(), "deepseek": deepseek_v3_671b.smoke(),
           "qwen1.5": qwen1_5_110b.smoke(), "mla-dense": MLA_DENSE}
B, S, N_DECODE = 2, 16, 4


def jax_cfg(cfg):
    """The JAX package's config of a port config (nested ones too)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        kw["moe"] = jax_base.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        kw["mla"] = jax_base.MLAConfig(**dataclasses.asdict(cfg.mla))
    return jax_base.LMConfig(**kw)


def filled(params, seed=1):
    """``params`` with every all-zero leaf made random (``0.1 · N(0, 1)``)."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif not v.any():
                tree[k] = (rng.normal(size=v.shape) * 0.1).astype(v.dtype)

    fill(params)
    return params


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """JAX params (numpy), tokens, prefill logits and cache of a config."""
    cfg = CONFIGS[name]
    jcfg = jax_cfg(cfg)
    params = filled(jax.tree.map(np.array, jax.jit(lambda key: jax_tf.init(jcfg, key))(
        jax.random.PRNGKey(0))))
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


def assert_scaled_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ routing
ROUTERS = {
    "softmax": MoEConfig(n_experts=8, top_k=2, d_ff_expert=16),
    "sigmoid-groups-bias": MoEConfig(n_experts=16, top_k=4, d_ff_expert=16, router="sigmoid",
                                     router_bias_balancing=True, n_groups=4, top_groups=2),
    "sigmoid": MoEConfig(n_experts=8, top_k=3, d_ff_expert=16, router="sigmoid"),
    "softmax-aux": MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, aux_loss_weight=0.01),
}


@pytest.mark.parametrize("name", list(ROUTERS))
def test_route_matches_jax(name):
    """Expert ids exact, combine weights within 1e-6, the aux loss too."""
    cfg = ROUTERS[name]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(96, 32)).astype(np.float32)
    w = (rng.normal(size=(32, cfg.n_experts)) / np.sqrt(32)).astype(np.float32)
    bias = (rng.normal(size=cfg.n_experts) * 0.1).astype(np.float32) \
        if cfg.router_bias_balancing else None
    want = jax.jit(lambda x, w, b: jax_moe.route(x, w, b, jax_base.MoEConfig(
        **dataclasses.asdict(cfg))))(x, w, bias)
    got = moe.route(t(x), t(w), None if bias is None else t(bias), cfg)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-7)


def test_route_group_limit_and_bias():
    """Group-limited routing picks experts of the top groups only, and the
    bias moves the choice but not the weights (scores without the bias)."""
    cfg = ROUTERS["sigmoid-groups-bias"]
    rng = np.random.default_rng(4)
    x = t(rng.normal(size=(64, 32)).astype(np.float32))
    w = t((rng.normal(size=(32, 16)) / np.sqrt(32)).astype(np.float32))
    bias = torch.zeros(16)
    bias[0] = 100.0  # expert 0 always chosen, its group always kept
    idx, wts, _ = moe.route(x, w, bias, cfg)
    assert (idx == 0).any(dim=-1).all()
    groups = (idx // 4).numpy()
    assert all(len(set(row)) <= cfg.top_groups for row in groups)
    scores = torch.sigmoid(x @ w).gather(1, idx.long())
    torch.testing.assert_close(wts, scores / scores.sum(-1, keepdim=True), rtol=1e-6, atol=1e-7)


def test_router_bias_update_matches_jax():
    rng = np.random.default_rng(5)
    bias = rng.normal(size=16).astype(np.float32)
    idx = rng.integers(0, 16, size=(40, 4)).astype(np.int32)
    idx[:, 0] = 3  # expert 3 over-loaded; some experts unused
    want = jax_moe.router_bias_update(jnp.asarray(bias), jnp.asarray(idx), 16)
    got = moe.router_bias_update(t(bias), t(idx), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


# ---------------------------------------------------------------- MoE FFN
def moe_case(cfg, T, D, seed):
    """JAX ``moe_schema`` params of one layer (random, bias too) and x."""
    sch = jax_moe.moe_schema(jax_base.MoEConfig(**dataclasses.asdict(cfg)), 1, D, "float32")
    params = filled(jax.tree.map(np.array, jax.jit(
        lambda key: jax_schema.init_params(sch, key))(jax.random.PRNGKey(seed))), seed)
    layer = {k: v[0] for k, v in params.items()}
    x = np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)
    return layer, x


def kept_by_reference(idx, E, C):
    """The kept (token, k) assignments of one group, by the JAX package's
    rule in numpy: a stable sort by expert id, kept while the rank within
    the expert is under C."""
    flat = np.asarray(idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(order)
    for e in np.unique(flat):
        pos = order[flat[order] == e]
        rank[pos] = np.arange(len(pos))
    return rank < C


MOE_CASES = {
    "global": dict(dispatch_groups=1),
    "grouped2": dict(dispatch_groups=2),
    "grouped4": dict(dispatch_groups=4),
    "global-drops": dict(dispatch_groups=1, capacity_factor=0.5),
    "grouped2-drops": dict(dispatch_groups=2, capacity_factor=0.5),
    "dsv3-drops": dict(n_experts=16, top_k=4, router="sigmoid", router_bias_balancing=True,
                       n_groups=4, top_groups=2, n_shared=1, capacity_factor=0.5),
}


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_matches_jax(name):
    """``moe_ffn`` against the JAX function (global, and grouped at 2 and 4)
    within ``1e-5 ·`` max|jax|; at capacity factor 0.5 assignments really
    are dropped, and the port keeps exactly the set the reference's rule
    keeps, group by group (512 tokens there: an expert's capacity is at
    least ``min(T/G, 64)``)."""
    base = dict(n_experts=8, top_k=2, d_ff_expert=24, capacity_factor=1.25)
    cfg = MoEConfig(**{**base, **MOE_CASES[name]})
    T, D = (512 if name.endswith("drops") else 128), 32
    layer, x = moe_case(cfg, T, D, seed=len(name))
    jcfg = jax_base.MoEConfig(**dataclasses.asdict(cfg))
    want, _ = jax.jit(lambda x, p: jax_moe.moe_ffn(x, p, jcfg))(x, layer)
    p = {k: t(v) for k, v in layer.items()}
    got, _ = moe.moe_ffn(t(x), p, cfg)
    assert_scaled_close(got, want, 1e-5)

    G = cfg.dispatch_groups
    Tg = T // G
    C = moe.capacity(Tg, cfg)
    idx = torch.stack([moe.route(t(x)[g * Tg:(g + 1) * Tg], p["router"], p.get("router_bias"),
                                 cfg)[0] for g in range(G)])
    kept = (moe.assignment_slots(idx, cfg.n_experts, C) < cfg.n_experts * G * C).numpy()
    want_kept = np.stack([kept_by_reference(idx[g].numpy(), cfg.n_experts, C) for g in range(G)])
    np.testing.assert_array_equal(kept, want_kept)
    if name.endswith("drops"):
        assert not kept.all()
    # every kept assignment has a row of its own; the drops share the last
    slots = moe.assignment_slots(idx, cfg.n_experts, C).numpy()
    assert len(np.unique(slots[kept])) == kept.sum()


def test_capacity_follows_the_jax_arithmetic():
    for T, K, E, cf in ((4096, 8, 256, 1.25), (8192, 2, 8, 1.25), (2, 8, 256, 1.25),
                        (128, 2, 8, 0.5), (7, 3, 5, 1.1), (100, 2, 8, 0.7)):
        cfg = MoEConfig(n_experts=E, top_k=K, d_ff_expert=1, capacity_factor=cf)
        assert moe.capacity(T, cfg) == max(1, int(np.ceil(T * K / E * cf)), min(T, 64))
    assert moe.capacity(4096, deepseek_v3_671b.CONFIG.moe) == 160
    assert moe.capacity(8192, mixtral_8x22b.CONFIG.moe) == 2560


# --------------------------------------------------------------------- MLA
def mla_layer(name, l):
    params = jax_run(name)[0]
    return {k: v[l] for k, v in params["mla"].items()}


def test_mla_attention_matches_jax():
    """The prefill attention (through the plain ``flash_attention`` op) and
    the latent cache entries, layer 1 of the deepseek smoke config."""
    cfg, model = port_model("deepseek")
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want, (ckv, kr) = jax.jit(lambda p, x: jax_mla.mla_attention(p, x, pos, jax_cfg(cfg)))(
        mla_layer("deepseek", 1), x)
    positions = torch.arange(S).expand(B, S)
    got, (g_ckv, g_kr) = mla.mla_attention(model.mla, 1, t(x), positions, cfg,
                                           get_kernels("torch").flash_attention)
    assert_scaled_close(got, want, 1e-5)
    assert_scaled_close(g_ckv, ckv, 1e-5)
    assert_scaled_close(g_kr, kr, 1e-5)


def test_mla_decode_matches_jax():
    """The absorbed decode at position 9 of a 12-slot cache: its output and
    both caches after the in-place write."""
    cfg, model = port_model("deepseek")
    m = cfg.mla
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(B, 12, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, 12, m.d_rope)).astype(np.float32)
    want = jax.jit(lambda p, x, c, k: jax_mla.mla_decode(p, x, jnp.int32(9), c, k, jax_cfg(cfg)))(
        mla_layer("deepseek", 2), x, ckv, kr)
    c, k = t(ckv.copy()), t(kr.copy())
    got = mla.mla_decode(model.mla, 2, t(x), 9, c, k, cfg)
    assert_scaled_close(got, want[0], 1e-5)
    assert_scaled_close(c, want[1], 1e-6)
    assert_scaled_close(k, want[2], 1e-6)


# ----------------------------------------------------------- the LM path
def test_schema_follows_jax_at_full_width():
    """Every leaf's name, shape, init kind and dtype equal the JAX schema's
    for the published mixtral-8x22b and deepseek-v3 (only the schema: no
    parameter is made) and the smoke configs."""
    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            elif isinstance(v, tuple):
                yield f"{prefix}{k}", v
            else:
                yield f"{prefix}{k}", (v.shape, v.init, v.dtype)

    for cfg in (mixtral_8x22b.CONFIG, deepseek_v3_671b.CONFIG, qwen1_5_110b.CONFIG,
                *CONFIGS.values()):
        got = list(flat(transformer.lm_schema(cfg)))
        want = list(flat(jax_tf.lm_schema(jax_cfg(cfg))))
        assert got == want, cfg.name
    leaves = dict(flat(transformer.lm_schema(deepseek_v3_671b.CONFIG)))
    assert "attn" not in {n.split(".")[0] for n in leaves}
    assert leaves["ffn_dense.wi_gate"][0] == (3, 7168, 18432)
    assert leaves["moe.wo"][0] == (58, 256, 2048, 7168)
    assert "ffn_dense.wi_gate" not in dict(flat(transformer.lm_schema(mixtral_8x22b.CONFIG)))


def test_large_leaves_are_drawn_in_blocks(monkeypatch):
    """A leaf under `WHOLE_DRAW_BYTES` is one float32 draw, as before; a
    larger one is drawn in blocks of leading indices into the output, with
    the same distribution."""
    gen = torch.Generator().manual_seed(3)
    whole = schema.init_param((6, 40, 50), "lecun", gen, "cpu", "bfloat16")
    want = (torch.randn((6, 40, 50), generator=torch.Generator().manual_seed(3))
            .mul_(40 ** -0.5).to(torch.bfloat16))
    assert torch.equal(whole, want)
    monkeypatch.setattr(schema, "WHOLE_DRAW_BYTES", 4 * 2 * 40 * 50)  # two leading rows a draw
    for shape in ((6, 40, 50), (5, 40, 50), (3, 7, 40, 50)):
        blocks = schema.init_param(shape, "lecun", torch.Generator().manual_seed(3), "cpu",
                                   "bfloat16")
        assert blocks.shape == shape and blocks.dtype == torch.bfloat16
        rows = blocks.float().view(-1, 2000)
        assert abs(rows.std().item() - 40 ** -0.5) < 0.01 and abs(rows.mean().item()) < 0.01
        assert not torch.equal(rows[0], rows[2])  # each block its own numbers
    # the first block's numbers are the first of the generator's stream
    assert torch.equal(blocks.view(-1, 2000)[:2], want.view(-1, 2000)[:2])
    monkeypatch.setattr(schema, "WHOLE_DRAW_BYTES", 4 * 50 * 3)  # below one trailing row
    small = schema.init_param((2, 3, 50), "he", torch.Generator().manual_seed(0), "cpu")
    assert small.shape == (2, 3, 50)
    assert not torch.equal(small[0, 0], small[0, 1])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_jax(name):
    """Prefill logits row by row and the prefill cache (``(k, v)``, or MLA's
    ``(c_kv, k_rope)``); ``forward`` without the cache gives the same
    logits."""
    _, tokens, want_logits, want_cache = jax_run(name)
    cfg, model = port_model(name)
    logits, cache = make_serve_fns(cfg, model)["prefill"](tokens)
    assert_rows_close(logits, want_logits)
    kind = "mla" if cfg.mla is not None else "gqa"
    assert cache.s_cap == S and not cache.rolling and cache.kind == kind
    for g, w in zip(cache.data, want_cache):
        assert_scaled_close(g, w, 1e-5)
    with torch.inference_mode():
        again, kv = model(torch.from_numpy(tokens))
    assert kv is None
    torch.testing.assert_close(again, logits, rtol=0, atol=0)


def _grown(cfg, cache_np, rolling):
    """The prefill cache grown by ``N_DECODE`` slots, or folded into a
    rolling cache of ``sliding_window`` slots (slot = pos % cap)."""
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


@pytest.mark.parametrize("name,rolling", [(n, False) for n in CONFIGS] + [("mixtral", True)])
def test_decode_matches_jax(name, rolling):
    """``N_DECODE`` greedy decode steps after the prefill (MoE on ``T = B``
    tokens: nothing dropped): logits row by row and the cache after the
    last step."""
    params, _, logits, cache_np = jax_run(name)
    cfg, model = port_model(name)
    kind = "mla" if cfg.mla is not None else "gqa"
    cap, data = _grown(cfg, cache_np, rolling)
    jcache = jax_tf.DecodeCache(tuple(jnp.asarray(d) for d in data), kind, cap, rolling)
    cache = transformer.DecodeCache(tuple(torch.from_numpy(d.copy()) for d in data), kind,
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
    for g, w in zip(cache.data, jcache.data):
        assert_scaled_close(g, w, 1e-5)


@pytest.mark.parametrize("name", ["mla-dense", "deepseek"])
def test_absorbed_decode_matches_own_prefill(name):
    """The port's absorbed decode, token by token from an empty cache, gives
    its own prefill's last logits (``rel < 1e-4``, as
    ``tests/test_models.py`` holds the JAX package's)."""
    cfg, model = port_model(name)
    tokens = jax_run(name)[1][:, :10]
    fns = make_serve_fns(cfg, model)
    full, _ = fns["prefill"](tokens)
    cache = transformer.init_cache(cfg, B, 10, device="cpu")
    for pos in range(10):
        lg, cache = fns["decode"](cache, tokens[:, pos:pos + 1], pos)
    ref = full[:, -1]
    rel = (lg[:, 0] - ref).abs().max().item() / (ref.abs().max().item() + 1e-9)
    assert rel < 1e-4, rel


def test_init_cache_matches_jax():
    for name in ("deepseek", "mixtral"):
        cfg = CONFIGS[name]
        want = jax_tf.init_cache(jax_cfg(cfg), 3, 20)
        got = transformer.init_cache(cfg, 3, 20, device="cpu")
        assert (got.kind, got.s_cap, got.rolling) == (want.kind, want.s_cap, want.rolling)
        assert [tuple(d.shape) for d in got.data] == [d.shape for d in want.data]
    got = transformer.init_cache(CONFIGS["mixtral"], 1, 20, rolling=True, device="cpu")
    assert got.s_cap == 8 and got.rolling
    # MLA with a rolling cache is refused (the JAX package asserts a window)
    windowed = dataclasses.replace(MLA_DENSE, sliding_window=4)
    with pytest.raises(NotImplementedError, match="MLA with a rolling cache"):
        transformer.init_cache(windowed, 1, 8, rolling=True, device="cpu")
    model = transformer.Transformer(windowed, device="cpu")
    rolled = transformer.DecodeCache(transformer.init_cache(windowed, 1, 4, device="cpu").data,
                                     "mla", 4, True)
    with pytest.raises(NotImplementedError, match="MLA with a rolling cache"):
        make_serve_fns(windowed, model)["decode"](rolled, np.zeros((1, 1), np.int32), 5)


def test_prefill_goes_through_the_kernels_op():
    """Every prefill attention is one ``Kernels.flash_attention`` call (one
    a layer, MLA's at q/k head dim ``d_nope + d_rope``, v head dim ``d_v``,
    one kv head a query head, scale ``(d_nope + d_rope) ** -0.5``); decode
    calls it never."""
    calls = []

    class Counting(Kernels):
        def flash_attention(self, q, k, v, **kw):
            calls.append((q.shape, k.shape, v.shape, kw))
            return super().flash_attention(q, k, v, **kw)

    for name in ("deepseek", "mixtral"):
        calls.clear()
        cfg = CONFIGS[name]
        tokens = jax_run(name)[1]
        model = transformer.Transformer(cfg, device="cpu", kernels=Counting())
        fns = make_serve_fns(cfg, model)
        _, cache = fns["prefill"](tokens)
        assert len(calls) == cfg.n_layers
        if cfg.mla is not None:
            m = cfg.mla
            assert calls[0] == ((B, S, cfg.n_heads, m.d_nope + m.d_rope),
                                (B, S, cfg.n_heads, m.d_nope + m.d_rope),
                                (B, S, cfg.n_heads, m.d_v),
                                dict(scale=pytest.approx((m.d_nope + m.d_rope) ** -0.5,
                                                         rel=1e-15)))
        else:
            assert calls[0][3] == dict(window=cfg.sliding_window, softcap=None)
        grown = transformer.init_cache(cfg, B, S + 1, device="cpu")
        for z, c in zip(grown.data, cache.data):
            z[:, :, :S] = c
        fns["decode"](grown, tokens[:, :1], S)
        assert len(calls) == cfg.n_layers
