"""One-card dry run: the port of ``src/repro/extras/dryrun.py``, priced on
``meta`` tensors.

For every (architecture × input shape) cell the cell's step
(`repro_torch.extras.shapes`) runs on meta tensors under the staticcheck
op recorder (`analysis.staticcheck.oplog`), and the cost model
(`analysis.staticcheck.costmodel`) prices the log: FLOPs, bytes read and
written, and peak live bytes. Nothing is allocated or computed, so a
configuration that no card could hold is priced in seconds. The record of
a cell says whether its peak fits one card's memory (``fits``; 80 GB
unless ``device_bytes`` says otherwise) and gives its H100 roofline
(`analysis.roofline`, one chip).

The reference lowers each cell with XLA on 256- and 512-chip meshes and
reads ``cost_analysis`` and ``memory_analysis``; here the mesh is one
H100, and the op log takes XLA's place:

  * the hand-written kernels' ops (``Kernels.flash_attention``,
    ``segment_mp``, ``cin_layer``) are priced as the card runs them
    (`FusedKernels`): one pseudo-op that reads its inputs and writes its
    outputs, with its plain version's FLOPs; their temporaries (the plain
    attention's S × S logits) are not live. A backward is the one of the
    autograd Function the card's backend calls;
  * ``measure_cost`` prices full depth from small-depth variants, as the
    reference does, but fitted as a quadratic in depth, since a train
    step's gradients of stacked leaves cost ``∝ L²`` here (see there).
    FLOPs and bytes are exact sums, so the fit equals a direct log;
  * the peak is a max over the step's ops, which need not be linear in
    depth (a candidate that leads at small depth may lose at full depth),
    so ``run_cell`` also records the full-depth step once and takes its
    peak for ``memory.peak_bytes`` and ``fits``; the extrapolated peak is
    kept beside it.

On one card there is no collective: the collective term is 0.

``--mesh single-pod`` / ``multi-pod`` prices a cell per chip on the
reference's 16×16 (256 chips) or 2×16×16 (512) mesh: the process joins a
world of 256 or 512 ranks as rank 0 (torch's ``fake`` backend over a
``FakeStore``: collectives move nothing), `make_production_mesh` builds the
mesh, and the cell's step runs on meta `DTensor`s under ``make_rules(cfg,
kind, mesh)`` — parameters placed by their schema axes (`param_pspecs`),
inputs by the cell's ``arg_axes``. The recorder sees each op at the rank's
local shapes (`oplog` lets DTensor's dispatch run and records its local
ops and functional collectives), so every figure is one chip's: parameter
bytes, peak, FLOPs, HBM bytes, and collective bytes and calls by kind
(`costmodel.log_collectives`, the reference's ``coll_by_kind`` and
``coll_count``). A mesh cell is priced from the depth probes alone (the
fit gives its peak too: a serving step's peak is linear in depth); no
full-depth step is recorded. The cells on a pod mesh are the dense LMs'
serving cells (`MESH_CELLS`); every other raises `NotImplementedError`
naming its ``ROADMAP.md`` item (`mesh_refusal`); ``--all`` prints it and
saves its record, with ``status`` "not ported" and the ``reason``.
A fake default group holds for the whole process: run a pod mesh in a
process of its own.

Usage (it needs no card):
  PYTHONPATH=src python -m repro_torch.extras.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.extras.dryrun --all [--variant opt]
  PYTHONPATH=src python -m repro_torch.extras.dryrun --mesh single-pod --all
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import optim
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.staticcheck import costmodel, oplog
from repro_torch.configs import all_archs, get
from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.core.backend import Kernels
from repro_torch.extras import shapes as shapes_lib
from repro_torch.extras.flash_attention.flash_attention import FlashAttention
from repro_torch.extras.flash_attention.sharded import attention_on_shards
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.rules import make_rules
from repro_torch.launch.sharding import axis_rules, shard_input
from repro_torch.models import transformer as tf
from repro_torch.extras.segment_mp.segment_mp import SegmentMP
from repro_torch.kernels.cin.cin import CinLayer

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
H100_BYTES = 80e9  # one H100 SXM's HBM3 (data sheet: 80 GB)
MESH = "1xH100"
# the meshes a cell is priced on: the record's mesh name and chip count
MESHES = {"one-card": (MESH, 1), "single-pod": ("16x16", 256), "multi-pod": ("2x16x16", 512)}
# the cells priced on a pod mesh: the dense LMs' serving
MESH_CELLS = frozenset((a, s) for a in ("gemma-2b", "qwen2-72b", "qwen1.5-110b")
                       for s in ("prefill_32k", "decode_32k"))
_POD_MESHES: dict = {}


def _opt_cfg_for(cfg) -> optim.AdamWConfig:
    # int8 moments for the models whose optimizer state would not fit HBM
    quant = isinstance(cfg, LMConfig) and cfg.n_params() > 1e11
    return optim.AdamWConfig(quantize_moments=quant)


def _model_flops(cell, cfg) -> float:
    if isinstance(cfg, LMConfig):
        s = shapes_lib.LM_SHAPES[cell.shape_id]
        return rl.model_flops_lm(cfg, s["batch"], s["seq"], cell.kind)
    if isinstance(cfg, GNNConfig):
        s = shapes_lib.GNN_SHAPES[cell.shape_id]
        return rl.model_flops_gnn(cfg, s["n"], s["e"])
    if isinstance(cfg, RecSysConfig):
        s = shapes_lib.REC_SHAPES[cell.shape_id]
        return rl.model_flops_recsys(cfg, s.get("batch", 1), cell.kind)
    return 0.0


def _shrink(cfg, n_layers: int, first_k_dense: int | None = None):
    if isinstance(cfg, LMConfig):
        moe = cfg.moe
        if moe is not None and first_k_dense is not None:
            moe = dataclasses.replace(moe, first_k_dense=first_k_dense)
        return dataclasses.replace(cfg, n_layers=n_layers, moe=moe)
    return dataclasses.replace(cfg, n_layers=n_layers)


def _fresh(out):
    """A kernel writes a fresh output: a plain version's view is copied."""
    if isinstance(out, torch.Tensor) and out._base is not None:
        return out.clone()
    return out


def _priced(op: str, fn):
    """``fn`` (a plain version) as the card's kernel to the active recorder:
    one ``kernels.<op>`` pseudo-op that reads the call's inputs and writes
    its outputs, carrying the FLOPs of ``fn``'s own ops, which are not
    logged."""
    def call(*args, **kwargs):
        rec = oplog.active()
        if rec is None:
            return fn(*args, **kwargs)
        rec.paused += 1
        try:
            out, inner = oplog.record(lambda *a, **k: _fresh(fn(*a, **k)), *args, **kwargs)
        finally:
            rec.paused -= 1
        rec.note(f"kernels.{op}", (args, kwargs), out, flops=costmodel.log_flops(inner))
        return out

    return call


class FusedKernels(Kernels):
    """The plain `Kernels` backend as the recorder should see the card's:
    every op is one priced pseudo-op (`_priced`), and the three model ops
    go through the autograd Functions the card's backend calls
    (`CinLayer`, `SegmentMP`, `FlashAttention`) with that pseudo-op as
    their kernel, so a backward is priced as the card runs it (the CIN
    kernel's two gradient layers, the chunked ``grad_w``; attention's
    recomputed plain forward)."""

    name = "torch"

    _FUNCTIONS = ("cin_layer", "segment_mp", "flash_attention")

    def __init__(self):
        plain = Kernels()
        for op in dir(plain):
            if not op.startswith("_") and callable(getattr(plain, op)):
                priced = _priced(op, getattr(plain, op))
                setattr(self, f"_{op}" if op in self._FUNCTIONS else op, priced)

    def cin_layer(self, xk, x0, w):
        return CinLayer.apply(xk, x0, w, self._cin_layer)

    def segment_mp(self, messages, dst_sorted, n_nodes):
        return SegmentMP.apply(messages, dst_sorted, n_nodes, self._segment_mp)

    def flash_attention(self, q, k, v, *, scale=None, window=None, softcap=None):
        if isinstance(q, DTensor):
            return attention_on_shards(self.flash_attention, q, k, v, scale=scale,
                                       window=window, softcap=softcap)
        return FlashAttention.apply(q, k, v, scale, window, softcap, self._flash_attention)


def mesh_refusal(entry, shape_id: str) -> str | None:
    """Why a cell is not priced on a pod mesh yet (its ``ROADMAP.md``
    item), or None for one of `MESH_CELLS`."""
    if (entry.arch_id, shape_id) in MESH_CELLS:
        return None
    where = "ROADMAP.md, Queue 1 item 5"
    if entry.family in ("gnn", "recsys"):
        return f"xDeepFM and the GNNs on a mesh are a later slice ({where}, slice 2)"
    cfg = entry.config
    if cfg.moe is not None or cfg.mla is not None:
        return f"MoE and MLA on a mesh (expert parallelism) are a later slice ({where}, slice 1)"
    return f"training on a mesh (FSDP) is a later slice ({where}, slice 3)"


def pod_mesh(mesh: str):
    """The reference's ``mesh`` (``"single-pod"``: ``(data=16, model=16)``,
    ``"multi-pod"``: ``(pod=2, data=16, model=16)``) with this process as
    rank 0 of a world of fake ranks (torch's ``fake`` backend: no rank
    runs, no collective moves data)."""
    if mesh not in _POD_MESHES:
        n = MESHES[mesh][1]
        if not dist.is_initialized():
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        if dist.get_world_size() != n:
            raise RuntimeError(f"the {mesh} mesh needs a world of {n}; this process is in one "
                               f"of {dist.get_world_size()}: run each mesh in its own process")
        _POD_MESHES[mesh] = make_production_mesh(multi_pod=mesh == "multi-pod",
                                                 device_type="cpu")
    return _POD_MESHES[mesh]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def mesh_args(cell, cfg, opt_cfg, mesh, rules: dict) -> tuple:
    """The cell's abstract arguments on ``mesh``: a model whose parameters
    are meta `DTensor`s placed by ``rules``, and every input placed by the
    cell's ``arg_axes``."""
    args = cell.abstract_args(cfg, opt_cfg)
    axes = cell.arg_axes(cfg, opt_cfg)
    model = tf.Transformer(cfg, device=torch.device("meta"), mesh=mesh, rules=rules)

    def place(t, a):
        if isinstance(t, tf.DecodeCache):
            return tf.DecodeCache(tuple(place(c, ca) for c, ca in zip(t.data, a.data)),
                                  t.kind, t.s_cap, t.rolling)
        return shard_input(t, *a) if isinstance(t, torch.Tensor) else t

    with axis_rules(mesh, rules):
        return (model,) + tuple(place(t, a) for t, a in zip(args[1:], axes[1:]))


def cost_of(entry, shape_id: str, cfg, opt_cfg, mesh=None) -> dict:
    """One recorded run of the cell's step at ``cfg`` on meta tensors:
    ``flops``, ``bytes``, ``peak`` (live bytes) and ``argument_bytes``; on
    a ``mesh``, one rank's, with ``param_bytes`` and its collectives
    (``coll`` bytes, ``coll:<kind>`` bytes and ``count:<kind>`` calls)."""
    cell = shapes_lib.build_cell(dataclasses.replace(entry, config=cfg), shape_id)
    scope = contextlib.nullcontext()
    if mesh is None:
        args = cell.abstract_args(cfg, opt_cfg)
    else:
        rules = make_rules(cfg, cell.kind, mesh)
        args = mesh_args(cell, cfg, opt_cfg, mesh, rules)
        scope = axis_rules(mesh, rules)
    args[0].kernels = FusedKernels()
    fn = cell.fn(cfg, opt_cfg)
    rec = oplog.OpRecorder()
    rec.log.args = tuple(rec.rec(_local(t)) for t in shapes_lib.leaves(args).values())
    with scope, rec:
        out = fn(*args)
    rec.log.results = tuple(rec.rec(_local(t)) for t in shapes_lib.leaves(out).values())
    log = rec.log
    arg_storages = {t.storage: t.nbytes for t in log.args}
    cost = {
        "flops": costmodel.log_flops(log),
        "bytes": costmodel.log_bytes(log),
        "peak": costmodel.peak_bytes(log),
        "argument_bytes": float(sum(arg_storages.values())),
    }
    if mesh is not None:
        nbytes, count = costmodel.log_collectives(log)
        cost["param_bytes"] = float(sum(_local(p).numel() * p.element_size()
                                        for p in args[0].parameters()))
        cost["coll"] = float(sum(nbytes.values()))
        for kind in costmodel.FUNCTIONAL_KIND.values():
            cost[f"coll:{kind}"] = nbytes.get(kind, 0.0)
            cost[f"count:{kind}"] = float(count.get(kind, 0))
    return cost


def _fit(probes: list, full: tuple, monomials) -> dict:
    """Each metric of the ``probes`` (``(depths, cost)`` pairs) fitted
    exactly as a sum of ``monomials(depths)``, evaluated at ``full``."""
    A = np.array([monomials(d) for d, _ in probes], dtype=np.float64)
    x = np.array(monomials(full), dtype=np.float64)
    keys = probes[0][1].keys()
    y = np.array([[c[k] for k in keys] for _, c in probes], dtype=np.float64)
    coef = np.linalg.solve(A, y)
    return dict(zip(keys, (x @ coef).tolist()))


def _quad1(d):
    (L,) = d
    return (1.0, L, L * L)


def _quad2(d):
    k, m = d
    return (1.0, k, m, k * k, m * m, k * m)


def depth_probes(entry, shape_id: str, cfg, opt_cfg, mesh=None):
    """``(probes, monomials, depths)`` of `measure_cost`: the small-depth
    variants' ``(depths, cost)``, the fit's terms, and ``cfg``'s own depths
    (None: a recsys model, priced directly)."""
    def probe(cfg_small):
        return cost_of(entry, shape_id, cfg_small, opt_cfg, mesh)

    if isinstance(cfg, LMConfig):
        k = cfg.moe.first_k_dense if cfg.moe is not None else cfg.n_layers
        Lm = cfg.n_layers - k
        if cfg.moe is not None and k > 0 and Lm > 0:
            pts = [(1, 1), (2, 1), (1, 2), (3, 1), (1, 3), (2, 2)]
            return ([(p, probe(_shrink(cfg, p[0] + p[1], p[0]))) for p in pts],
                    _quad2, (k, Lm))
        fk = 0 if cfg.moe is not None else None
        return ([((L,), probe(_shrink(cfg, L, fk))) for L in (2, 3, 4)],
                _quad1, (cfg.n_layers,))
    if isinstance(cfg, GNNConfig):
        return ([((L,), probe(_shrink(cfg, L))) for L in (2, 3, 4)], _quad1, (cfg.n_layers,))
    return [((), probe(cfg))], None, None


def measure_cost(entry, shape_id: str, cfg, opt_cfg, mesh=None) -> dict:
    """The cell's cost at full depth from small-depth variants, as the
    reference prices it, with one more term. The reference extrapolates
    ``base + Σ_s L_s · c_s``, linear in each stack's depth ``L_s``. A
    train step here is not linear: each layer's read of a stacked leaf
    (``w[l]``) has a backward that writes a gradient the size of the
    whole stack, so the gradients cost ``∝ L²``. The cost is therefore
    fitted exactly as a quadratic in the depths: three probes (depth 2-4:
    an EGNN's one-layer step is not on its curve, as its last layer's
    coordinate update reaches no loss) for one stack, six for a MoE
    model's dense prefix ``k`` and MoE suffix ``m`` (``1, k, m, k², m²,
    k·m``: the attention leaves stack both). Inference steps fit with a
    zero quadratic term. A recsys model has no layer stack: it is priced
    directly."""
    probes, monomials, depths = depth_probes(entry, shape_id, cfg, opt_cfg, mesh)
    if monomials is None:
        return probes[0][1]
    return _fit(probes, depths, monomials)


def apply_variant(cfg, kind: str):
    """The reference's optimized variant at one card (``dp = tp = 1``):
    MoE dispatch in ``dp`` = 1 group, split-KV decode in ``tp`` (decode) or
    ``dp · tp`` (long decode) = 1 block, and no remat for a model under
    1e10 parameters. The reference gates the split-KV blocks on whether
    its chips can hold replicated weights; one card holds every weight it
    holds at all, so here they are set without that gate."""
    if not isinstance(cfg, LMConfig):
        return cfg
    dp = tp = 1
    if cfg.moe is not None and kind in ("train", "prefill"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=dp))
    if kind in ("decode", "decode_long"):
        cfg = dataclasses.replace(
            cfg, inference_param_sharding="tp_replicated",
            decode_kv_blocks=tp if kind == "decode" else dp * tp)
    if kind == "train" and cfg.n_params() < 1e10:
        # small models don't need remat: trade recompute for bytes
        cfg = dataclasses.replace(cfg, remat="none")
    return cfg


def _save(out: dict, variant: str | None, out_dir: pathlib.Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    path = out_dir / f"{out['arch']}__{out['shape']}__{out['mesh']}{suffix}.json"
    path.write_text(json.dumps(out, indent=2, default=str))


def run_cell(
    arch_id: str,
    shape_id: str,
    *,
    save: bool = True,
    variant: str | None = None,
    device_bytes: float = H100_BYTES,
    out_dir: "pathlib.Path | str" = ARTIFACTS,
    mesh: str = "one-card",
) -> dict:
    """Price one cell (see the module docstring) on ``mesh`` (`MESHES`);
    ``status`` is ``ok``, ``skipped`` (one of the arch's
    ``skipped_shapes``) or ``error`` (the exception and its traceback are
    in the record). A cell not priced on a pod mesh yet raises
    `NotImplementedError` (`mesh_refusal`). With ``save`` the record is
    written as JSON into ``out_dir``."""
    out_dir = pathlib.Path(out_dir)
    entry = get(arch_id)
    skipped = dict(entry.skipped_shapes)
    if shape_id in skipped:
        out = {"arch": arch_id, "shape": shape_id, "mesh": MESHES[mesh][0],
               "status": "skipped", "reason": skipped[shape_id]}
        if save:
            _save(out, variant, out_dir)
        return out
    if mesh != "one-card":
        reason = mesh_refusal(entry, shape_id)
        if reason is not None:
            raise NotImplementedError(f"{arch_id} x {shape_id} on the {mesh} mesh: {reason}")
        return _run_mesh_cell(entry, shape_id, mesh, save=save, variant=variant,
                              device_bytes=device_bytes, out_dir=out_dir)
    cell = shapes_lib.build_cell(entry, shape_id)
    cfg = entry.config
    opt_cfg = _opt_cfg_for(cfg)
    if variant == "opt":
        cfg = apply_variant(cfg, cell.kind)
        entry = dataclasses.replace(entry, config=cfg)
    out: dict = {
        "arch": arch_id, "shape": shape_id, "mesh": MESH,
        "kind": cell.kind, "status": "ok", "variant": variant or "baseline",
    }
    t0 = time.perf_counter()
    try:
        # 1. the full config runs on meta: its peak (and the proof it runs)
        full = cost_of(entry, shape_id, cfg, opt_cfg)
        t_full = time.perf_counter() - t0
        # 2. full-depth cost from small depths, as the reference prices it
        cost = measure_cost(entry, shape_id, cfg, opt_cfg)
        t_measure = time.perf_counter() - t0 - t_full
        roof = rl.Roofline(
            flops=cost["flops"], hbm_bytes=cost["bytes"], collective_bytes=0.0,
            n_chips=1, model_flops=_model_flops(cell, cfg),
            peak_flops=rl.peak_for(cfg.dtype),
        )
        out.update({
            "record_s": t_full,
            "measure_s": t_measure,
            "memory": {"argument_bytes": full["argument_bytes"], "peak_bytes": full["peak"]},
            "extrapolated": {"flops": cost["flops"], "bytes": cost["bytes"],
                             "peak_bytes": cost["peak"]},
            "direct": {"flops": full["flops"], "bytes": full["bytes"]},
            "device_bytes": float(device_bytes),
            "fits": full["peak"] <= device_bytes,
            "roofline": roof.to_dict(),
        })
        print(
            f"[OK] {arch_id} × {shape_id} × {MESH}: peak {full['peak'] / 1e9:.3f} GB "
            f"({'fits' if out['fits'] else 'does not fit'}), "
            f"t_comp {roof.t_compute * 1e3:.2f}ms t_mem {roof.t_memory * 1e3:.2f}ms "
            f"→ {roof.bottleneck} (record {t_full:.1f}s, probes {t_measure:.1f}s)"
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        out["status"] = "error"
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch_id} × {shape_id} × {MESH}: {out['error']}")
    if save:
        _save(out, variant, out_dir)
    return out


def _run_mesh_cell(entry, shape_id: str, mesh: str, *, save: bool, variant, device_bytes,
                   out_dir) -> dict:
    """A `MESH_CELLS` cell priced a chip on a pod mesh, from the depth
    probes (see the module docstring)."""
    name, n_chips = MESHES[mesh]
    cell = shapes_lib.build_cell(entry, shape_id)
    cfg = entry.config
    opt_cfg = _opt_cfg_for(cfg)
    if variant == "opt":
        cfg = apply_variant(cfg, cell.kind)
        entry = dataclasses.replace(entry, config=cfg)
    out: dict = {"arch": entry.arch_id, "shape": shape_id, "mesh": name, "kind": cell.kind,
                 "status": "ok", "variant": variant or "baseline", "n_chips": n_chips}
    t0 = time.perf_counter()
    try:
        pm = pod_mesh(mesh)
        cost = measure_cost(entry, shape_id, cfg, opt_cfg, pm)
        roof = rl.Roofline(
            flops=cost["flops"], hbm_bytes=cost["bytes"], collective_bytes=cost["coll"],
            n_chips=n_chips, model_flops=_model_flops(cell, cfg),
            peak_flops=rl.peak_for(cfg.dtype))
        out.update({
            "measure_s": time.perf_counter() - t0,
            "rules": make_rules(cfg, cell.kind, pm),
            "memory": {"param_bytes": cost["param_bytes"],
                       "argument_bytes": cost["argument_bytes"], "peak_bytes": cost["peak"]},
            "flops": cost["flops"], "bytes": cost["bytes"],
            "collectives": {
                "bytes": cost["coll"],
                "bytes_by_kind": {k: cost[f"coll:{k}"] for k in costmodel.FUNCTIONAL_KIND.values()},
                "count_by_kind": {k: int(round(cost[f"count:{k}"]))
                                  for k in costmodel.FUNCTIONAL_KIND.values()}},
            "device_bytes": float(device_bytes),
            "fits": cost["peak"] <= device_bytes,
            "roofline": roof.to_dict(),
        })
        print(
            f"[OK] {entry.arch_id} × {shape_id} × {name}: a chip holds "
            f"{cost['param_bytes'] / 1e9:.3f} GB of parameters, peak {cost['peak'] / 1e9:.3f} "
            f"GB ({'fits' if out['fits'] else 'does not fit'}), collectives "
            f"{cost['coll'] / 1e9:.3f} GB → {roof.bottleneck} "
            f"(priced in {out['measure_s']:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        out["status"] = "error"
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {entry.arch_id} × {shape_id} × {name}: {out['error']}", flush=True)
    if save:
        _save(out, variant, out_dir)
    return out


def all_cell_ids() -> list[tuple[str, str]]:
    """Every (arch, shape) of the LM, GNN and recsys families: assigned
    shapes, then skipped ones."""
    return [(e.arch_id, sh) for e in all_archs().values()
            if e.family in ("lm", "gnn", "recsys")
            for sh in e.shapes + tuple(s for s, _ in e.skipped_shapes)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", type=str, default=None, choices=[None, "opt"])
    ap.add_argument("--device-bytes", type=float, default=H100_BYTES,
                    help="the card's memory that `fits` holds the peak to")
    ap.add_argument("--out", default=str(ARTIFACTS), help="directory of the JSON records")
    ap.add_argument("--mesh", default="one-card", choices=list(MESHES),
                    help="one H100, or the reference's 16x16 / 2x16x16 mesh (fake ranks)")
    args = ap.parse_args(argv)

    if args.all:
        ids = all_cell_ids()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        ids = [(args.arch, args.shape)]
    results = []
    for a, s in ids:
        try:
            r = run_cell(a, s, variant=args.variant, device_bytes=args.device_bytes,
                         out_dir=args.out, mesh=args.mesh)
        except NotImplementedError as e:
            if not args.all:
                raise
            print(f"[NOT PORTED] {e}", flush=True)
            r = {"arch": a, "shape": s, "mesh": MESHES[args.mesh][0], "status": "not ported",
                 "reason": str(e)}
            _save(r, args.variant, pathlib.Path(args.out))
        results.append(r)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_not = sum(r["status"] == "not ported" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skipped, {n_not} not ported on this mesh, "
          f"{n_err} failed ===")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
