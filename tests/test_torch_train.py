"""The port's training path against the JAX package on the CPU.

The JAX package's own parameters (its zero-initialised leaves made random,
so every leaf counts) are carried over by ``params_from_jax``; the same
seeded numpy batches go through ``jax.value_and_grad`` of the JAX
``loss_fn`` (``kernels="jnp"``: no Pallas kernel is on these paths) and
through the port's ``loss_fn`` and ``backward()``. The JAX gradients are
loaded into a second port model and compared leaf by leaf with the port's
``.grad``. Then AdamW (`optim.update` from an ``opt_state_from_jax``
state, with and without int8 moments), three `make_train_step` steps,
microbatching, the checkpointer, the supervisor's resume, the three
autograd Functions (``gradcheck`` in float64) and the launcher.

Tolerances (float32 on both sides; XLA's CPU fusions and summation orders
differ from PyTorch's, and the LM init amplifies rounding ~30x a layer):
  * losses within ``1e-5`` relative;
  * each gradient leaf within `GRAD_TOL` × the leaf's max|jax|;
  * AdamW: parameters and float32 moments within ``rtol=1e-6, atol=1e-9``,
    int8 payloads within ±1 element by element (the differing elements are
    named), scales within ``rtol=1e-6``;
  * train steps: each step's loss within `STEP_LOSS_TOL` relative, final
    parameters within `STEP_PARAM_TOL` × ``lr`` of JAX's (an element whose
    gradient is ~0 may take a different Adam step sign on each side);
  * the checkpointer and the supervisor's resume: bit for bit.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.autograd import gradcheck  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.configs import base as jax_base  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro.runtime import fault_tolerance as jax_ft  # noqa: E402
from repro.train import step as jax_step  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import flatten_with_paths  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    deepseek_v3_671b,
    egnn,
    gatedgcn,
    gemma_2b,
    gin_tu,
    meshgraphnet,
    mixtral_8x22b,
    qwen2_72b,
    xdeepfm,
)
from repro_torch.core.backend import get_kernels  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.extras import train as launcher  # noqa: E402
from repro_torch.extras.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.extras.segment_mp import segment_mp as smp  # noqa: E402
from repro_torch.graphstore import generators  # noqa: E402
from repro_torch.kernels.cin import cin  # noqa: E402
from repro_torch.models import gnn, recsys, schema, transformer  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    SimulatedPreemption,
    TrainSupervisor,
    elastic_restore,
    straggler_update,
)
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import batch_on, loss_for, supervised  # noqa: E402

GRAD_TOL = 2e-4
STEP_LOSS_TOL = 1e-5
STEP_PARAM_TOL = 1e-2

_MIX = mixtral_8x22b.smoke()
LM = {
    "gemma-2b": dataclasses.replace(gemma_2b.smoke(), remat="block"),
    "qwen2-72b": qwen2_72b.smoke(),
    "mixtral-8x22b-aux": dataclasses.replace(
        _MIX, moe=dataclasses.replace(_MIX.moe, aux_loss_weight=0.01)),
    "deepseek-v3": deepseek_v3_671b.smoke(),
}
GNN = {"gin": gin_tu.smoke(), "gatedgcn": gatedgcn.smoke(), "egnn": egnn.smoke(),
       "meshgraphnet": meshgraphnet.smoke(),
       "gin-graph": dataclasses.replace(gin_tu.smoke(), task="graph")}
RECSYS = xdeepfm.smoke()
B, S = 2, 16


# ------------------------------------------------------------------ helpers
def jax_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, type(RECSYS)):
        return jax_base.RecSysConfig(**kw)
    if "kind" in kw:
        return jax_base.GNNConfig(**kw)
    if cfg.moe is not None:
        kw["moe"] = jax_base.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        kw["mla"] = jax_base.MLAConfig(**dataclasses.asdict(cfg.mla))
    return jax_base.LMConfig(**kw)


def filled(params, seed=1):
    """``params`` (numpy) with every all-zero leaf made ``0.1 · N(0, 1)``."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif not np.asarray(v).any():
                tree[k] = (rng.normal(size=np.shape(v)) * 0.1).astype(np.float32)

    fill(params)
    return params


def leaf(tree, name):
    """The leaf of a dotted parameter name in a nested (or flat) dict."""
    if name in tree:
        return tree[name]
    for part in name.split("."):
        tree = tree[part]
    return tree


@functools.lru_cache(maxsize=None)
def jax_params(name):
    """A parameter tree in the JAX package's layout (nested dicts of numpy
    arrays, its schema's shapes, dtypes and init kinds), drawn by the port's
    schema from a seed — no JAX init to compile — with every zero leaf made
    random."""
    cfg = {**LM, **GNN, "xdeepfm": RECSYS}[name]
    gen = torch.Generator().manual_seed(0)
    model = (transformer.Transformer if name in LM else gnn.GNN if name in GNN
             else recsys.XDeepFM)(cfg, generator=gen, device="cpu")
    tree = {}
    for n, p in model.named_parameters():
        *path, last = n.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = p.detach().float().numpy().copy()
    return filled(tree)


def port_model(name, cfg):
    p = jax_params(name)
    if name in LM:
        return transformer.params_from_jax(cfg, p, device="cpu")
    if name in GNN:
        return gnn.params_from_jax(cfg, p, device="cpu")
    return recsys.params_from_jax(cfg, p, device="cpu")


def gnn_batch(cfg, seed=0):
    """A full-graph batch of a 64-node R-MAT with ~20% of the edges padded
    and half the labels masked; the graph task gets 3 interleaved graphs."""
    g = generators.rmat(64, 256, 4, seed=seed)
    b = pipeline.gnn_full_batch(cfg, g, n_classes=cfg.n_classes, seed=seed)
    rng = np.random.default_rng(seed + 1)
    b = b._replace(edge_mask=rng.random(len(b.edge_mask)) < 0.8,
                   label_mask=rng.random(len(b.node_feat)) < 0.5)
    if cfg.task == "graph":
        N = len(b.node_feat)
        b = b._replace(graph_id=(np.arange(N) % 3).astype(np.int32), n_graphs=3,
                       labels=rng.integers(0, cfg.n_classes, 3).astype(np.int32),
                       node_mask=rng.random(N) < 0.9, label_mask=None)
    return b


def batch_of(name, cfg, step=0):
    """The numpy batch of a case (the port's; `jax_batch` makes JAX's)."""
    if name in LM:
        return pipeline.lm_batch(cfg, B, S, seed=0, step=step)
    if name in GNN:
        return {"graph": gnn_batch(cfg)}
    return pipeline.recsys_batch(cfg, 16, seed=0, step=step)


def jax_batch(batch):
    if "graph" in batch:
        return {"graph": jax_gnn.GraphBatch(**batch["graph"]._asdict())}
    return batch


def jax_loss(name, cfg):
    jcfg = jax_cfg(cfg)
    return lambda p, batch: jax_step.loss_for(jcfg, jax_batch(batch))(p)


def assert_leaves_close(model, want: dict, *, what="grad", rel=GRAD_TOL, atol=0.0):
    """Each parameter's ``.grad`` (``what="grad"``) or value against the
    numpy tree ``want``: within ``rel`` × the leaf's max|want| + ``atol``."""
    for n, p in model.named_parameters():
        got = p.grad if what == "grad" else p.detach()
        got = torch.zeros_like(p) if got is None else got
        w = np.asarray(leaf(want, n), dtype=np.float32)
        err = float(np.abs(got.float().numpy() - w).max()) if w.size else 0.0
        bound = rel * (float(np.abs(w).max()) if w.size else 0.0) + atol
        assert err <= bound, f"{n}: max err {err:.3e} > {bound:.3e}"


# ------------------------------------------------------------- loss + grads
@pytest.mark.parametrize("name", list(LM) + list(GNN) + ["xdeepfm"])
def test_loss_and_every_gradient_leaf(name):
    """The loss and every gradient leaf of the port's ``loss_fn`` against
    ``jax.value_and_grad`` of the JAX one, from the same weights and batch."""
    cfg = {**LM, **GNN, "xdeepfm": RECSYS}[name]
    batch = batch_of(name, cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss(name, cfg)))(
        jax_params(name), jax_batch(batch))
    model = schema.trainable(port_model(name, cfg))
    loss = loss_for(cfg, batch_on(batch, model.device))(model)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss)), (loss, want_loss)
    assert_leaves_close(model, jax.tree.map(np.asarray, want_grads))


def test_remat_gives_the_same_gradients():
    """``remat="block"`` (a checkpoint a layer) changes no gradient bit."""
    cfg = LM["gemma-2b"]
    tokens = torch.as_tensor(batch_of("gemma-2b", cfg)["tokens"])
    grads = []
    for remat in ("block", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        model = schema.trainable(transformer.params_from_jax(c, jax_params("gemma-2b"),
                                                             device="cpu"))
        transformer.loss_fn(c, model, tokens).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_serving_is_unchanged_by_trainable():
    """Parameters are made for serving (no gradient); `trainable` turns it
    on and off, and the serving forward gives the same logits either way."""
    cfg = LM["gemma-2b"]
    model = transformer.params_from_jax(cfg, jax_params("gemma-2b"), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(batch_of("gemma-2b", cfg)["tokens"])
    with torch.no_grad():
        a = model(tokens)[0]
    schema.trainable(model)
    assert all(p.requires_grad for p in model.parameters())
    with torch.no_grad():
        b = model(tokens)[0]
    schema.trainable(model, False)
    assert torch.equal(a, b) and not any(p.requires_grad for p in model.parameters())


# -------------------------------------------------------------------- AdamW
def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32-moments", "int8-moments"])
def test_adamw_update_from_a_jax_state(quantize):
    """`optim.update` against ``repro.optim.update`` from the same
    mid-training state (one JAX step in), gradients and lr scale."""
    cfg = optim.AdamWConfig(quantize_moments=quantize)
    jcfg = jax_optim.AdamWConfig(quantize_moments=quantize)
    p0 = jax_params("xdeepfm")
    update = jax.jit(functools.partial(jax_optim.update, jcfg))
    p1, s1, _ = update(_grads_like(p0, 1), jax.jit(functools.partial(jax_optim.init, jcfg))(p0),
                       p0, jnp.float32(1.0))
    g2 = _grads_like(p0, 2)
    want_p, want_s, want_m = update(g2, s1, p1, jnp.float32(0.7))
    want_p, want_s = jax.tree.map(np.asarray, (want_p, want_s))

    model = recsys.params_from_jax(RECSYS, jax.tree.map(np.asarray, p1), device="cpu")
    state = schema.opt_state_from_jax(jax.tree.map(np.asarray, s1), model)
    params = dict(model.named_parameters())
    grads = {n: torch.from_numpy(np.array(leaf(g2, n))) for n in params}
    state, metrics = optim.update(cfg, grads, state, params, torch.tensor(0.7))
    assert int(state.step) == int(want_s.step) == 2
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics["lr"]), float(want_m["lr"]), rtol=1e-7)
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), leaf(want_p, n), rtol=1e-6, atol=1e-9,
                                   err_msg=n)
        for got, want in ((state.m[n], leaf(want_s.m, n)), (state.v[n], leaf(want_s.v, n))):
            if isinstance(got, optim.QTensor):
                assert got.q.dtype == torch.int8 and p.ndim >= 1
                diff = got.q.numpy().astype(np.int32) - np.asarray(want.q, np.int32)
                bad = np.argwhere(diff != 0)
                assert np.abs(diff).max() <= 1, f"{n}: payloads differ by >1 at {bad[:8]}"
                np.testing.assert_allclose(got.scale.numpy(), want.scale, rtol=1e-6,
                                           err_msg=n)
            else:
                assert not quantize or p.ndim == 0
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9, err_msg=n)


def test_global_norm_cosine_warmup_and_straggler_update():
    g = _grads_like(jax_params("xdeepfm"), 3)
    got = optim.global_norm({n: torch.from_numpy(np.array(x)) for n, x in
                             [("a", g["tables"]), ("b", g["cin"]["w0"]), ("c", g["bias"])]})
    want = jax_optim.adamw.global_norm([g["tables"], g["cin"]["w0"], g["bias"]])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for warmup, total in ((200, 10_000), (1, 4), (0, 3)):
        for s in (0, 1, 2, 3, 5, 50, 199, 200, 201, 5000, 9999, 10_000, 12_000):
            np.testing.assert_allclose(
                float(optim.cosine_warmup(s, warmup=warmup, total=total)),
                float(jax_optim.cosine_warmup(jnp.int32(s), warmup=warmup, total=total)),
                rtol=1e-6, atol=1e-7, err_msg=f"{warmup}, {total}, {s}")
    assert float(optim.cosine_warmup(0, warmup=1, total=4)) == 0.0
    ours, theirs = None, None
    for dt in (1.0, 1.1, 0.9, 5.0, 1.0, 3.5, 1.0, 0.2, 3.0):
        ours, flag = straggler_update(ours, dt, 3.0)
        theirs, jflag = jax_ft.straggler_update(theirs, dt, 3.0)
        assert (ours, flag) == (theirs, jflag)


# --------------------------------------------------------------- train steps
def jax_train(name, cfg, opt, n_steps, microbatches=1, batch_fn=None):
    jcfg = jax_cfg(cfg)
    jopt = jax_optim.AdamWConfig(**dataclasses.asdict(opt))
    step = jax.jit(jax_step.make_train_step(jcfg, jopt, total_steps=10, warmup=1,
                                            microbatches=microbatches))
    params = jax_params(name)
    state = jax_optim.init(jopt, params)
    losses = []
    for s in range(n_steps):
        params, state, m = step(params, state, jax_batch(batch_fn(s)), jnp.int32(s))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, params)


def port_train(name, cfg, opt, n_steps, microbatches=1, batch_fn=None):
    model = port_model(name, cfg)
    state = optim.init(opt, dict(model.named_parameters()))
    step = make_train_step(cfg, opt, total_steps=10, warmup=1, microbatches=microbatches)
    losses = []
    for s in range(n_steps):
        state, m = step(model, state, batch_fn(s), s)
        losses.append(float(m["loss"]))
    return losses, model, state


@pytest.mark.parametrize("name", ["gemma-2b", "gatedgcn", "xdeepfm"])
def test_three_train_steps_against_jax(name):
    """Three `make_train_step` steps (warm-up 1: step 0 has lr 0) against
    the JAX step, one config a family: the loss trajectory and the final
    parameters. (Int8 moments: `test_adamw_update_from_a_jax_state`.)"""
    cfg = {**LM, **GNN, "xdeepfm": RECSYS}[name]
    opt = optim.AdamWConfig()
    batch_fn = functools.partial(batch_of, name, cfg) if name not in GNN else (
        lambda s: batch_of(name, cfg))
    want_losses, want_params = jax_train(name, cfg, opt, 3, batch_fn=batch_fn)
    losses, model, state = port_train(name, cfg, opt, 3, batch_fn=batch_fn)
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_LOSS_TOL)
    assert int(state.step) == 3
    assert_leaves_close(model, want_params, what="value", rel=0.0, atol=STEP_PARAM_TOL * opt.lr)
    moved = [n for n, p in model.named_parameters()
             if not np.array_equal(p.detach().numpy(), leaf(jax_params(name), n))]
    assert len(moved) == len(list(model.parameters()))  # weight decay moves every leaf


def test_microbatches_against_one_batch_and_jax():
    """``microbatches=2`` on 4 sequences: the port against itself with one
    batch (the same mean of gradients, other summation order) and against
    the JAX package's microbatched step."""
    name, cfg = "gemma-2b", LM["gemma-2b"]
    opt = optim.AdamWConfig()
    fn = lambda s: pipeline.lm_batch(cfg, 4, S, seed=0, step=s)  # noqa: E731
    l2, m2, _ = port_train(name, cfg, opt, 2, microbatches=2, batch_fn=fn)
    l1, m1, _ = port_train(name, cfg, opt, 2, microbatches=1, batch_fn=fn)
    jl, jp = jax_train(name, cfg, opt, 2, microbatches=2, batch_fn=fn)
    np.testing.assert_allclose(l2, l1, rtol=STEP_LOSS_TOL)
    np.testing.assert_allclose(l2, jl, rtol=STEP_LOSS_TOL)
    assert_leaves_close(m2, jp, what="value", rel=0.0, atol=STEP_PARAM_TOL * opt.lr)
    assert_leaves_close(m2, {n: p.detach().numpy() for n, p in m1.named_parameters()},
                        what="value", rel=0.0, atol=STEP_PARAM_TOL * opt.lr)


def test_microbatches_refuse_a_graph_batch():
    cfg = GNN["gin"]
    step = make_train_step(cfg, optim.AdamWConfig(), microbatches=2)
    model = gnn.GNN(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="GraphBatch"):
        step(model, optim.init(optim.AdamWConfig(), dict(model.named_parameters())),
             {"graph": gnn_batch(cfg)}, 0)


# --------------------------------------------------------------- checkpoints
def _tree():
    g = torch.Generator().manual_seed(0)
    opt_cfg = optim.AdamWConfig(quantize_moments=True)
    params = {"w": torch.randn(4, 6, generator=g).to(torch.bfloat16),
              "b": torch.randn(6, generator=g), "s": torch.randn((), generator=g)}
    state = optim.init(opt_cfg, params)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}
    state, _ = optim.update(opt_cfg, grads, state, params)
    return (params, state, [torch.arange(5, dtype=torch.int32)])


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(7, tree)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert {m["name"]: m["dtype"] for m in manifest["leaves"]}["0/w"] == "bfloat16"
    like = _tree()
    with torch.no_grad():
        for t in like[0].values():
            t.zero_()
    got = ck.restore(7, like)
    assert isinstance(got[1], optim.AdamWState) and isinstance(got[1].m["w"], optim.QTensor)
    a = flatten_with_paths(tree)
    b = flatten_with_paths(got)
    assert [n for n, _ in a] == [n for n, _ in b] and len(a) == 15
    for (n, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), n


def test_checkpoint_keeps_the_newest_and_saves_async(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=True)
    tree = {"x": torch.zeros(3)}
    for s in range(1, 5):
        tree["x"] += 1  # written in place after save returns: save copied it first
        ck.save(s, tree)
    assert ck.latest_step() == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
    assert ck.restore(3, tree)["x"].tolist() == [3.0] * 3
    got, step = elastic_restore(ck, tree, "cpu")
    assert step == 4 and got["x"].tolist() == [4.0] * 3


def _supervised(tmp_path, fail_at=None):
    cfg = LM["gemma-2b"]
    model = transformer.Transformer(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(3))
    opt = optim.AdamWConfig(quantize_moments=True)
    step_fn, params = supervised(model, make_train_step(cfg, opt, total_steps=6, warmup=1))
    sup = TrainSupervisor(Checkpointer(tmp_path, keep=2), ckpt_every=2,
                          fail_at=dict(fail_at or {}))
    return sup.run(state=(params, optim.init(opt, params)), step_fn=step_fn,
                   batch_fn=lambda s: pipeline.lm_batch(cfg, B, S, seed=0, step=s), n_steps=6)


def test_supervisor_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    """A `SimulatedPreemption` at step 3 of 6, then a restart from the
    latest checkpoint (step 2): the same state, bit for bit, as a run that
    was never stopped."""
    want, hist = _supervised(tmp_path / "a")
    with pytest.raises(SimulatedPreemption):
        _supervised(tmp_path / "b", {3: SimulatedPreemption})
    got, hist2 = _supervised(tmp_path / "b")
    assert [h["step"] for h in hist2] == [2, 3, 4, 5]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[2:]]
    for (n, x), (_, y) in zip(flatten_with_paths(want), flatten_with_paths(got)):
        assert torch.equal(x, y), n


def test_supervisor_joins_the_inflight_save_before_a_preemption_leaves(tmp_path, monkeypatch):
    """The step-2 save is still being written when the preemption at step 3
    is raised (``np.save`` slowed down); `run` joins it first, so a fresh
    `Checkpointer` over the same directory finds step 2."""
    import time

    from repro_torch.checkpoint import checkpointer as ckpt_mod

    real_save = ckpt_mod.np.save

    def slow_save(*a, **k):
        time.sleep(0.01)
        return real_save(*a, **k)

    monkeypatch.setattr(ckpt_mod.np, "save", slow_save)
    sup = TrainSupervisor(Checkpointer(tmp_path, keep=2), ckpt_every=2,
                          fail_at={3: SimulatedPreemption})
    with pytest.raises(SimulatedPreemption):
        sup.run(state={"w": torch.zeros(40)}, n_steps=6,
                step_fn=lambda st, b, s: ({"w": st["w"] + b}, {"loss": torch.tensor(0.0)}),
                batch_fn=lambda s: float(s))
    assert sup.checkpointer._thread is None
    assert Checkpointer(tmp_path, keep=2).latest_step() == 2


# ------------------------------------------------------- autograd Functions
D64 = torch.float64


def _rand(*shape, seed=0):
    return torch.randn(*shape, dtype=D64, generator=torch.Generator().manual_seed(seed),
                       requires_grad=True)


@pytest.mark.parametrize("H,m,Hp", [(3, 3, 4), (5, 2, 3)], ids=["first-layer", "wider"])
def test_cin_layer_function_gradcheck(H, m, Hp):
    xk, x0, w = _rand(4, H, 5, seed=1), _rand(4, m, 5, seed=2), _rand(H * m, Hp, seed=3)
    assert gradcheck(cin.CinLayer.apply, (xk, x0, w))
    # xk and x0 the same tensor, as the first CIN layer takes them
    assert gradcheck(lambda a, c: cin.CinLayer.apply(a, a, c),
                     (_rand(3, 2, 4, seed=4), _rand(4, 3, seed=5)))


def test_cin_grad_w_in_chunks(monkeypatch):
    """``grad_w`` summed over chunks of the batch equals one sum."""
    xk, x0, g = (torch.randn(9, 3, 4, dtype=D64), torch.randn(9, 2, 4, dtype=D64),
                 torch.randn(9, 5, 4, dtype=D64))
    whole = cin.grad_w(xk, x0, g)
    monkeypatch.setattr(cin, "GRAD_W_CHUNK_BYTES", 2 * 3 * 2 * 4 * 8)
    torch.testing.assert_close(cin.grad_w(xk, x0, g), whole, rtol=1e-12, atol=1e-12)


def test_segment_mp_function_gradcheck():
    msg = _rand(9, 3)
    dst = torch.tensor([-1, 0, 0, 1, 2, 2, 2, 5, 7], dtype=torch.int32)  # -1, 7: dropped
    assert gradcheck(lambda m: smp.SegmentMP.apply(m, dst, 6), (msg,))


@pytest.mark.parametrize("window,softcap,scale", [(None, None, None), (3, None, None),
                                                  (None, 5.0, None), (2, 4.0, 0.3)])
def test_flash_attention_function_gradcheck(window, softcap, scale):
    q, k, v = _rand(2, 6, 4, 8, seed=1), _rand(2, 6, 2, 8, seed=2), _rand(2, 6, 2, 5, seed=3)
    assert gradcheck(lambda a, b, c: fa.FlashAttention.apply(a, b, c, scale, window, softcap),
                     (q, k, v))


@pytest.mark.parametrize("op", ["cin_layer", "segment_mp", "flash_attention"])
def test_cuda_backend_ops_carry_the_plain_gradients(op):
    """The CUDA backend's op (its Function; on CPU tensors the forward is
    the plain version) gives, in float32, the gradients of autograd through
    the plain backend."""
    g = torch.Generator().manual_seed(0)
    if op == "cin_layer":
        args = [torch.randn(8, 4, 6, generator=g), torch.randn(8, 3, 6, generator=g),
                torch.randn(12, 5, generator=g)]
        kw, diff = {}, [0, 1, 2]
    elif op == "segment_mp":
        args = [torch.randn(20, 4, generator=g), torch.sort(
            torch.randint(0, 7, (20,), generator=g).int()).values, 7]
        kw, diff = {}, [0]
    else:
        args = [torch.randn(1, 10, 4, 8, generator=g), torch.randn(1, 10, 1, 8, generator=g),
                torch.randn(1, 10, 1, 8, generator=g)]
        kw, diff = dict(window=4, softcap=20.0), [0, 1, 2]
    grads = []
    for backend in ("cuda", "torch"):
        xs = [a.clone().requires_grad_(i in diff) if isinstance(a, torch.Tensor) else a
              for i, a in enumerate(args)]
        out = getattr(get_kernels(backend), op)(*xs, **kw)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        grads.append([xs[i].grad for i in diff])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["cin_layer", "segment_mp", "flash_attention"])
def test_raw_launchers_refuse_inputs_that_require_grad(op):
    """A raw launcher has no backward: under grad mode it refuses an input
    that requires grad (on any device), and runs under ``no_grad``."""
    x = torch.randn(2, 3, 4, requires_grad=True)
    call = {"cin_layer": lambda: cin.cin_layer(x, x, torch.randn(9, 2)),
            "segment_mp": lambda: smp.segment_mp(x[0], torch.zeros(3, dtype=torch.int32), 2),
            "flash_attention": lambda: fa.flash_attention(x[None], x[None], x[None])}[op]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()


# ------------------------------------------------------------------ launcher
def test_launcher_trains_three_smoke_steps_on_the_cpu(tmp_path, capsys):
    history = launcher.main(["--arch", "gemma-2b", "--steps", "3", "--batch", "2",
                             "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                             "--ckpt-every", "2"])
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[0]["lr"] == 0.0
    assert (tmp_path / "step_00000003" / "manifest.json").exists()
    assert "final loss" in capsys.readouterr().out
    resumed = launcher.main(["--arch", "gemma-2b", "--steps", "3", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--resume"])
    assert resumed == []  # the checkpoint is at the last step already
