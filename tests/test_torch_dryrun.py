"""The port's one-card dry run (`repro_torch.extras.shapes`,
`repro_torch.extras.dryrun`) against the JAX package's, on the CPU.

  * every arch × shape cell's abstract arguments, leaf by leaf (the JAX key
    paths joined by dots), have the shapes and dtypes of
    ``repro.extras.shapes``'s — meta tensors and ShapeDtypeStructs only,
    nothing is allocated;
  * a train step's priced FLOPs at one smoke config a family are within
    10% of ``repro.analysis.staticcheck.costmodel.jaxpr_flops`` of the
    same JAX step under ``unrolled_model()``, at shapes cut for the CPU;
    every gap above 2% is pinned with its cause;
  * ``measure_cost``'s fit equals a direct log at depths it did not probe
    (FLOPs and bytes to 1e-9 relative); the peak within 1% where the step
    is an inference step or a GNN's, and where it is not (an LM's train
    step), ``run_cell`` records the peak of the full-depth log;
  * ``run_cell``'s record keys, ``skipped`` and ``error`` cells, and
    ``main``'s exit code;
  * ``_opt_cfg_for``, ``_shrink`` and ``apply_variant`` against the JAX
    package's, read from its source (importing ``repro.extras.dryrun``
    sets ``XLA_FLAGS`` to 512 host devices, which this process must not).
"""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.analysis.staticcheck import costmodel as jcost  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.extras import shapes as jshapes  # noqa: E402
from repro.models.layers import unrolled_model  # noqa: E402
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.extras import dryrun, shapes  # noqa: E402

CELLS = dryrun.all_cell_ids()
ASSIGNED = [(a, s) for a, s in CELLS if s not in dict(get(a).skipped_shapes)]
# the JAX package's opt config, as the port's `_opt_cfg_for` would give it
# (`repro.extras.dryrun` is not imported here: see the module docstring)


def _jax_opt_cfg(cfg):
    from repro import optim as joptim
    from repro.configs.base import LMConfig as JLMConfig

    return joptim.AdamWConfig(
        quantize_moments=isinstance(cfg, JLMConfig) and cfg.n_params() > 1e11)


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def jax_leaves(args: tuple) -> dict:
    """``{dotted path: (shape, dtype)}`` of the array leaves (ints, such as
    a GraphBatch's ``n_graphs``, are not arrays); a `DecodeCache` argument
    by its ``data``, as the port's `shapes.leaves` names it."""
    from repro.models.transformer import DecodeCache

    tree = tuple({"data": a.data} if isinstance(a, DecodeCache) else a for a in args)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            out[".".join(_key(k) for k in path)] = (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
    return out


@pytest.mark.parametrize("arch,shape", ASSIGNED, ids=[f"{a}-{s}" for a, s in ASSIGNED])
def test_abstract_args_equal_reference(arch, shape):
    entry, jentry = get(arch), jget(arch)
    cfg = entry.config
    opt = dryrun._opt_cfg_for(cfg)
    assert opt.quantize_moments == _jax_opt_cfg(jentry.config).quantize_moments
    cell = shapes.build_cell(entry, shape)
    jcell = jshapes.build_cell(jentry, shape)
    assert cell.kind == jcell.kind
    want = jax_leaves(jcell.abstract_args(jentry.config, _jax_opt_cfg(jentry.config)))
    got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for k, t in shapes.leaves(cell.abstract_args(cfg, opt)).items()}
    if cell.kind in ("decode", "decode_long"):
        # the port's decode position is a Python int (the cache's last slot)
        assert want.pop("3") == ((), "int32")
    assert got == want
    assert all(d.device.type == "meta" for d in
               cell.abstract_args(cfg, opt)[0].parameters())


# ---------------------------------------------------------- CPU-sized cells
SMALL_LM = dict(seq=64, batch=2)
SMALL_GNN = dict(n=600, e=1500)
SMALL_REC = dict(batch=64, n_candidates=2000)


@pytest.fixture
def small_shapes(monkeypatch):
    """Both packages' shape tables cut to CPU size (the same cut on both)."""
    for mod in (shapes, jshapes):
        for k, v in list(mod.LM_SHAPES.items()):
            monkeypatch.setitem(mod.LM_SHAPES, k, dict(v, **SMALL_LM))
        for k, v in list(mod.GNN_SHAPES.items()):
            small = dict(v, **SMALL_GNN)
            if "n_graphs" in v:
                small["n_graphs"] = 20
            monkeypatch.setitem(mod.GNN_SHAPES, k, small)
        for k, v in list(mod.REC_SHAPES.items()):
            small = dict(v, batch=min(v["batch"], SMALL_REC["batch"]))
            if "n_candidates" in v:
                small["n_candidates"] = SMALL_REC["n_candidates"]
            monkeypatch.setitem(mod.REC_SHAPES, k, small)


def smoke_entry(arch, **replace):
    e = get(arch)
    return dataclasses.replace(e, config=dataclasses.replace(e.smoke(), **replace))


# each (arch, shape) family representative: the port's priced FLOPs over
# the JAX cost model's, pinned to 4 digits where the gap is above 2%.
#  * gemma-2b train: the card's attention backward (`FlashAttention`) runs
#    the plain attention forward again before its vector-Jacobian product;
#  * GatedGCN: the port takes the A, B and V products of the node states on
#    the N = 1,024 nodes and gathers the products to the edges, where the
#    JAX model gathers first and multiplies on the E = 1,536 edges (forward
#    and backward);
#  * xDeepFM serve: the CIN's outer product z = xk ⊗ x0 is a dot_general
#    with no contracted dim in the JAX model (2 operations an element to
#    its cost model) and a product in the port's plain version (1);
# every other op agrees within 2%
FLOP_CASES = {
    ("gemma-2b", "train_4k"): 1.0587,
    ("gemma-2b", "prefill_32k"): None,
    ("gatedgcn", "minibatch_lg"): 0.9035,
    ("xdeepfm", "serve_p99"): 0.9630,
}


def flops_ratio(arch, shape):
    """The port's priced FLOPs of the cell's step at the smoke config over
    the JAX cost model's."""
    entry = smoke_entry(arch)
    cfg = entry.config
    got = dryrun.cost_of(entry, shape, cfg, dryrun._opt_cfg_for(cfg))["flops"]
    jentry = jget(arch)
    jcfg = jentry.smoke()
    jcell = jshapes.build_cell(dataclasses.replace(jentry, config=jcfg), shape)
    with unrolled_model():
        jaxpr = jax.make_jaxpr(jcell.fn(jcfg, _jax_opt_cfg(jcfg)))(
            *jcell.abstract_args(jcfg, _jax_opt_cfg(jcfg)))
        want = jcost.jaxpr_flops(jaxpr)
    print(f"[dryrun flops] {arch} {shape}: port {got:.6g}, jax {want:.6g}, "
          f"ratio {got / want:.4f}")
    return got / want


@pytest.mark.parametrize("arch,shape", list(FLOP_CASES), ids=[f"{a}-{s}" for a, s in FLOP_CASES])
def test_priced_flops_within_ten_percent_of_jax(arch, shape, small_shapes):
    ratio = flops_ratio(arch, shape)
    pinned = FLOP_CASES[(arch, shape)]
    assert abs(ratio - 1) <= 0.10
    if abs(ratio - 1) > 0.02:
        assert pinned is not None and round(ratio, 4) == pinned, ratio


def test_cin_backward_is_priced_as_the_card_runs_it(small_shapes):
    """xDeepFM's train step prices 24% above the JAX model's: the card's CIN
    backward (`CinLayer`) takes xk's and x0's gradients as two more CIN
    layers (2·B·H′·m·d·H and 2·B·H′·H·d·m operations) and w's from z formed
    again, where the JAX backward forms z's gradient once and reduces it.
    That is the card's work, so the dry run keeps it; pinned here."""
    assert round(flops_ratio("xdeepfm", "train_batch"), 4) == 1.2415


# depth cases: (arch, shape, depths the fit did not probe)
DEPTH_CASES = [
    ("gemma-2b", "train_4k"), ("gemma-2b", "prefill_32k"), ("gemma-2b", "decode_32k"),
    ("deepseek-v3-671b", "train_4k"), ("deepseek-v3-671b", "prefill_32k"),
    ("gatedgcn", "minibatch_lg"), ("egnn", "molecule"),
]


@pytest.mark.parametrize("arch,shape", DEPTH_CASES, ids=[f"{a}-{s}" for a, s in DEPTH_CASES])
def test_fit_equals_a_direct_log(arch, shape, small_shapes):
    """Depths 6 and 8 (the probes are at 2-4, or six (dense, MoE) splits of
    2-4 layers); at deepseek-v3's, 3 dense layers lead either depth."""
    entry = smoke_entry(arch)
    cfg = entry.config
    opt = dryrun._opt_cfg_for(cfg)
    # the probes' depths do not depend on the full depth: one set serves both
    probes, monomials, _ = dryrun.depth_probes(entry, shape, cfg, opt)
    for depth in (6, 8):
        c = dryrun._shrink(cfg, depth)
        e = dataclasses.replace(entry, config=c)
        direct = dryrun.cost_of(e, shape, c, opt)
        k = c.moe.first_k_dense if len(probes[0][0]) == 2 else 0
        fit = dryrun._fit(probes, (k, depth - k) if k else (depth,), monomials)
        for k in ("flops", "bytes", "argument_bytes"):
            assert fit[k] == pytest.approx(direct[k], rel=1e-9), (depth, k)
        gap = fit["peak"] / direct["peak"] - 1
        print(f"[dryrun depth] {arch} {shape} depth {depth}: peak fit/direct - 1 = {gap:.4f}")
        if shape == "train_4k":  # the step's peak is not a quadratic in depth
            assert abs(gap) > 0.01
        else:
            assert abs(gap) <= 0.01


def test_run_cell_records_the_full_depth_peak(small_shapes, monkeypatch, tmp_path):
    entry = smoke_entry("gemma-2b", n_layers=6)
    monkeypatch.setattr(dryrun, "get", lambda arch: entry)
    out = dryrun.run_cell("gemma-2b", "train_4k", out_dir=tmp_path)
    assert out["status"] == "ok", out.get("error")
    cfg = entry.config
    direct = dryrun.cost_of(entry, "train_4k", cfg, dryrun._opt_cfg_for(cfg))
    assert out["memory"] == {"argument_bytes": direct["argument_bytes"],
                             "peak_bytes": direct["peak"]}
    assert out["extrapolated"]["peak_bytes"] != direct["peak"]
    assert out["extrapolated"]["flops"] == pytest.approx(direct["flops"], rel=1e-9)
    assert {k: out[k] for k in ("arch", "shape", "mesh", "kind", "variant")} == dict(
        arch="gemma-2b", shape="train_4k", mesh="1xH100", kind="train", variant="baseline")
    assert out["fits"] is True and out["device_bytes"] == dryrun.H100_BYTES
    roof = rl.Roofline(flops=1.0, hbm_bytes=1.0, collective_bytes=0.0, n_chips=1)
    assert set(out["roofline"]) == set(roof.to_dict())
    assert out["roofline"]["n_chips"] == 1 and out["roofline"]["collective_bytes_per_chip"] == 0
    assert out["roofline"]["model_flops"] == rl.model_flops_lm(
        cfg, SMALL_LM["batch"], SMALL_LM["seq"], "train")
    saved = json.loads((tmp_path / "gemma-2b__train_4k__1xH100.json").read_text())
    assert saved["memory"] == out["memory"]
    monkeypatch.setattr(dryrun, "get", lambda arch: smoke_entry("xdeepfm"))
    small = dryrun.run_cell("xdeepfm", "serve_p99", device_bytes=1e3, save=False)
    assert small["status"] == "ok" and small["fits"] is False


def test_skipped_and_error_cells_and_the_exit_code(small_shapes, monkeypatch, tmp_path):
    out = dryrun.run_cell("gemma-2b", "long_500k", out_dir=tmp_path)
    assert out["status"] == "skipped"
    assert out["reason"] == dict(get("gemma-2b").skipped_shapes)["long_500k"]
    monkeypatch.setattr(dryrun, "cost_of", lambda *a: 1 / 0)
    bad = dryrun.run_cell("gemma-2b", "train_4k", save=False)
    assert bad["status"] == "error" and bad["error"].startswith("ZeroDivisionError")
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k", "--out", str(tmp_path)])
    assert exc.value.code == 1


def test_every_skipped_cell_is_an_entry_skipped_shape():
    for arch, shape in CELLS:
        e = get(arch)
        assert shape in e.shapes or shape in dict(e.skipped_shapes)
    assert len(CELLS) == len(ASSIGNED) + 3


def reference_functions() -> dict:
    """The JAX package's ``_opt_cfg_for``, ``_shrink`` and ``apply_variant``,
    read from ``src/repro/extras/dryrun.py`` and compiled alone: importing
    that module would set ``XLA_FLAGS`` first."""
    from repro import optim as joptim
    from repro.configs.base import LMConfig as JLMConfig

    path = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / "extras" / "dryrun.py"
    tree = ast.parse(path.read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_opt_cfg_for", "_shrink", "apply_variant")]
    assert len(defs) == 3
    ns = {"dataclasses": dataclasses, "optim": joptim, "LMConfig": JLMConfig}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"), ns)
    return ns


class OneCard:
    """A mesh of one card for the reference's ``apply_variant``: no axis,
    so ``dp = tp = 1``."""

    shape: dict = {}


def test_opt_cfg_shrink_and_variant_equal_reference():
    ref = reference_functions()
    from repro_torch.configs.base import LMConfig

    for arch in {a for a, _ in dryrun.all_cell_ids()}:
        entry, jcfg = get(arch), jget(arch).config
        cfg = entry.config
        assert (dryrun._opt_cfg_for(cfg).quantize_moments
                == ref["_opt_cfg_for"](jcfg).quantize_moments), arch
        if entry.family != "recsys":  # neither package shrinks a recsys model
            # the configs' reprs name their package's classes the same way
            assert repr(dryrun._shrink(cfg, 3, 1)) == repr(ref["_shrink"](jcfg, 3, 1)), arch
        for kind in ("train", "prefill", "decode", "decode_long", "serve"):
            got, want = dryrun.apply_variant(cfg, kind), ref["apply_variant"](jcfg, kind, OneCard())
            if isinstance(got, LMConfig):
                # the reference also relabels the weights' sharding where its
                # chips could hold them replicated; the port reads no label
                assert ([got.decode_kv_blocks, got.remat,
                         got.moe.dispatch_groups if got.moe else None]
                        == [want.decode_kv_blocks, want.remat,
                            want.moe.dispatch_groups if want.moe else None]), (arch, kind)
            else:
                assert repr(got) == repr(want), (arch, kind)


POD_SCRIPT = r"""
import json
from repro_torch.extras import dryrun
rec = dryrun.run_cell("gemma-2b", "prefill_32k", save=False, mesh="single-pod")
try:
    dryrun.run_cell("mixtral-8x22b", "prefill_32k", save=False, mesh="single-pod")
    refused = None
except NotImplementedError as e:
    refused = str(e)
print(json.dumps({"record": rec, "refused": refused}, default=str))
"""


@pytest.mark.slow
def test_pod_mesh_cell_in_its_own_process():
    """gemma-2b ``prefill_32k`` priced a chip on the single-pod mesh (a
    world of 256 fake ranks, so a process of its own): its per-rank
    parameter bytes equal those derived from the JAX package's
    ``param_pspecs`` under the JAX rules at ``(data=16, model=16)``; the
    path's collectives are all-reduces and the FSDP all-gathers; a cell of
    a later slice raises `NotImplementedError` naming its ROADMAP item."""
    import os
    import subprocess
    import sys

    from repro.launch import rules as jrules
    from repro.launch import sharding as jsharding
    from repro.models import schema as jschema
    from repro.models import transformer as jtf

    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", POD_SCRIPT], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rec = out["record"]
    assert (rec["status"], rec["mesh"], rec["n_chips"]) == ("ok", "16x16", 256), rec
    jcfg = jget("gemma-2b").config
    sizes = {"data": 16, "model": 16}
    with jsharding.axis_rules(None, jrules.make_rules(jcfg, "prefill", type(
            "M", (), {"shape": sizes})())):
        specs = jax.tree.leaves(jschema.param_pspecs(jtf.lm_schema(jcfg)),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = jax.tree.leaves(jschema.abstract_params(jtf.lm_schema(jcfg)))
    want = 0
    for spec, leaf in zip(specs, leaves):
        local = [d // int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else e or ())]))
                 for d, e in zip(leaf.shape, tuple(spec) + (None,) * len(leaf.shape))]
        want += int(np.prod(local)) * leaf.dtype.itemsize
    assert rec["memory"]["param_bytes"] == want
    assert rec["fits"] and rec["memory"]["peak_bytes"] < 80e9
    counts = rec["collectives"]["count_by_kind"]
    assert counts["all-reduce"] > 0 and counts["all-gather"] > 0, counts
    assert rec["roofline"]["n_chips"] == 256 and rec["flops"] > 0
    assert "slice 1" in out["refused"] and "ROADMAP.md" in out["refused"]
