"""Rank functions for `repro_torch.launch.mesh.spawn_ranks` in the tests of
model sharding (``tests/test_torch_mesh_lm.py``, ``tests/test_torch_cuda.py``).

Each runs in a spawned gloo rank and returns plain numpy results; it
imports neither ``jax`` nor a test module, so a rank starts with torch and
the port alone.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


COLLECTIVE_CASES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
REDISTRIBUTE_CASES = ("partial_to_replicate", "partial_to_shard", "shard_to_replicate",
                      "shard_to_shard")


def gloo_collective_rank(rank: int, case: str, mesh_type: str | None = None,
                         device: str = "cuda", staged: bool = True) -> dict:
    """On two gloo ranks sharing ``cuda:0`` (``device="cpu"``: on the
    host): one functional collective that DTensor's redistributions call
    (``case`` in `COLLECTIVE_CASES`), or, with ``mesh_type``, one DTensor
    redistribution (``case`` in `REDISTRIBUTE_CASES`) on a mesh of that
    device type holding the rank's tensors, for bf16 and fp32; with
    ``staged`` under the port's staging rule
    (`rank_collectives.stage_functional_collectives`). Returns ``{dtype:
    (device of the result, the result on the host)}`` and the bytes
    staged."""
    from repro_torch.core import rank_collectives as rc

    if staged:
        rc.stage_functional_collectives()
    rc.reset_staged_bytes()
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dev = torch.device(f"{device}:0" if device == "cuda" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.group.WORLD
    out: dict = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.arange(8, device=dev).to(dt) + rank
        if mesh_type is None:
            y = {"all_reduce": lambda: funcol.all_reduce(x, "sum", group),
                 "all_gather": lambda: funcol.all_gather_tensor(x, 0, group),
                 "reduce_scatter": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
                 "all_to_all": lambda: funcol.all_to_all_single(x, None, None, group),
                 }[case]()
        else:
            mesh = init_device_mesh(mesh_type, (2,), mesh_dim_names=("model",))
            src, dst = {"partial_to_replicate": ([Partial()], [Replicate()]),
                        "partial_to_shard": ([Partial()], [Shard(0)]),
                        "shard_to_replicate": ([Shard(0)], [Replicate()]),
                        "shard_to_shard": ([Shard(0)], [Shard(1)])}[case]
            y = DTensor.from_local(x.view(2, 4), mesh, src).redistribute(mesh, dst).to_local()
        y = y.wait() if hasattr(y, "wait") else y
        out[str(dt).removeprefix("torch.")] = (y.device.type, y.float().cpu().numpy())
    out["staged"] = dict(rc.staged_bytes)
    return out


def _cfg(name: str, overrides: dict):
    import dataclasses

    from repro_torch.configs import gemma_2b, qwen2_72b

    mod = {"gemma-2b": gemma_2b, "qwen2-72b": qwen2_72b}[name]
    return dataclasses.replace(mod.smoke(), **overrides)


def lm_rank(rank: int, device: str, mesh_shape: dict, name: str, overrides: dict,
            tokens: np.ndarray, decode_tokens: np.ndarray, params: dict | None = None) -> dict:
    """The smoke config ``name`` (with ``overrides``) served on a mesh
    ``mesh_shape`` of gloo ranks through ``make_serve_fns``: from the JAX
    ``params`` (numpy), or drawn from seed 0 on the rank's device when None.
    The prefill of ``tokens``, the cache grown by ``len(decode_tokens)``
    slots under the decode rules, then one decode step a token of
    ``decode_tokens (T, B, 1)``. Returns the gathered logits and caches on
    the host, the prefill's attention launches by route (on the card), the
    kernel sources this rank built, and this rank's parameter bytes."""
    from repro_torch.kernels import cuda
    from repro_torch.launch import axis_rules, make_mesh, make_rules
    from repro_torch.models import transformer as tf
    from repro_torch.models.schema import distribute_params
    from repro_torch.train.step import make_serve_fns

    cfg = _cfg(name, overrides)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(mesh_shape, dev.type)
    rules = make_rules(cfg, "prefill", mesh)
    if params is None:
        model = tf.Transformer(cfg, device=dev, mesh=mesh, rules=rules,
                               generator=torch.Generator(device=dev).manual_seed(0))
    else:
        model = tf.params_from_jax(cfg, params, device=dev, mesh=mesh, rules=rules)
    # a model built whole, then distributed: the same chunks
    whole = tf.Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    if params is not None:
        whole = tf.params_from_jax(cfg, params, device=dev)
    distribute_params(whole, tf.lm_schema(cfg), mesh, rules)
    mesh_params = dict(model.named_parameters())
    same_chunks = all(torch.equal(p.to_local(), mesh_params[n].to_local()) and
                      p.placements == mesh_params[n].placements
                      for n, p in whole.named_parameters())
    del whole
    fns = make_serve_fns(cfg, model)
    cuda.reset_launch_counts()
    logits, cache = fns["prefill"](tokens)
    launches = {k: v for k, v in cuda.launch_counts().items() if v}

    def host(t):
        return t.full_tensor().float().cpu().numpy()

    out = {"logits": host(logits), "cache": [host(c) for c in cache.data],
           "same_chunks": same_chunks,
           "launches": launches, "logits_type": type(logits).__name__,
           "param_bytes": sum(p.to_local().numel() * p.element_size()
                              for p in model.parameters()),
           "placements": {n: str(tuple(p.placements)) for n, p in model.named_parameters()}}
    S = tokens.shape[1]
    with axis_rules(mesh, make_rules(cfg, "decode", mesh)):
        cache = tf.grow_cache(cache, S + len(decode_tokens))
    out["decode_cache_placements"] = str(tuple(cache.data[0].placements))
    steps = []
    for i, tok in enumerate(decode_tokens):
        lg, cache = fns["decode"](cache, tok, S + i)
        steps.append(host(lg))
    out["decode"] = steps
    out["cache_after"] = [host(c) for c in cache.data]
    out["sources_built"] = cuda.sources_built
    return out



def lm_jobs_rank(rank: int, jobs: list) -> list:
    """`lm_rank` for each argument tuple of ``jobs``, in one process."""
    return [lm_rank(rank, *job) for job in jobs]


def elastic_rank(rank: int, directory: str, target: np.ndarray, phase: str) -> dict:
    """``tests/test_elastic_multidevice.py``'s scenario on gloo ranks: ``w
    (8, 64)`` sharded by rows over the world (``(d,)``), AdamW ``lr=0.05``
    without weight decay on ``mean((w - target)²)``. ``"save"``: 10 steps
    from zeros, then a checkpoint of ``(params, state)``. ``"restore"``:
    `elastic_restore` onto this world's mesh, then 10 more steps. Returns
    the step restored or saved, ``w`` gathered, and its placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.runtime import elastic_restore

    mesh = init_device_mesh("cpu", (dist.get_world_size(),), mesh_dim_names=("d",))
    rows, rep = (Shard(0),), (Replicate(),)
    cfg = optim.AdamWConfig(lr=0.05, weight_decay=0.0)
    tgt = distribute_tensor(torch.from_numpy(target), mesh, rows, src_data_rank=None)

    def step(params, state):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((w - tgt) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        state, _ = optim.update(cfg, {"w": g}, state, params)
        return params, state

    def fresh():
        def z():
            return distribute_tensor(torch.zeros(8, 64), mesh, rows, src_data_rank=None)
        return ({"w": z()}, optim.AdamWState(step=torch.zeros((), dtype=torch.int32),
                                            m={"w": z()}, v={"w": z()}))

    ck = Checkpointer(directory, async_save=False)
    with implicit_replication():
        params, state = fresh()
        if phase == "save":
            for _ in range(10):
                params, state = step(params, state)
            ck.save(10, (params, state))
            n = 10
        else:
            shardings = ({"w": (mesh, rows)}, optim.AdamWState(
                step=(mesh, rep), m={"w": (mesh, rows)}, v={"w": (mesh, rows)}))
            (params, state), n = elastic_restore(ck, (params, state), shardings=shardings)
            state = state._replace(step=state.step.full_tensor())
            for _ in range(10):
                params, state = step(params, state)
        return {"step": n, "w": params["w"].full_tensor().numpy(),
                "placements": str(tuple(params["w"].placements))}
