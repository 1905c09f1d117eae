"""Model sharding's rules and schemas against the JAX package, exactly.

`repro_torch.launch.rules.make_rules` against ``repro.launch.rules`` for
every registered LM, GNN and recsys arch × ``train`` / ``prefill`` /
``decode`` / ``decode_long`` × the meshes ``(16, 16)``, ``(2, 16, 16)``,
``(2, 2)`` and ``(model=4)`` (as ``{axis: size}`` mappings, the reference's
``mesh.shape``: no world of 256 ranks); `spec_for` against the reference's
``PartitionSpec`` entries, its de-duplication cases included; the schemas'
`param_pspecs`, `schema_axes` and `abstract_params` leaf for leaf under
every rule set; the optimizer state's axes (int8 moments' scale axes too);
every dry-run cell's ``arg_axes``, ``kind`` and ``donate``; and
`placements` on a mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro import optim as jax_optim  # noqa: E402
from repro.extras import shapes as jax_shapes  # noqa: E402
from repro.launch import rules as jax_rules  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.models import gnn as jax_gnn  # noqa: E402
from repro.models import recsys as jax_recsys  # noqa: E402
from repro.models import schema as jax_schema  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.extras import shapes  # noqa: E402
from repro_torch.launch import axis_rules, make_rules, spec_for  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import gnn, recsys, schema, transformer  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "model4": {"model": 4}}
KINDS = ("train", "prefill", "decode", "decode_long")
ARCHS = [a for a, e in configs.all_archs().items() if e.family in ("lm", "gnn", "recsys")]


class _FakeMesh:
    """The reference's mesh as ``make_rules`` reads it: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _schemas(arch):
    """The port's and the JAX package's schema of an arch's config."""
    entry, jentry = configs.get(arch), jax_configs.get(arch)
    build = {"lm": (transformer.lm_schema, jax_tf.lm_schema),
             "gnn": (gnn.gnn_schema, jax_gnn.gnn_schema),
             "recsys": (recsys.recsys_schema, jax_recsys.recsys_schema)}[entry.family]
    return build[0](entry.config), build[1](jentry.config)


def _flat(tree, prefix=""):
    """``{dotted path: leaf}`` of nested dicts, named tuples, dataclasses
    with ``data`` (the decode caches) and tuples of trees; a tuple of axis
    names (or an empty one) is a leaf."""
    def join(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, join(k)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), join(f)))
        return out
    if hasattr(tree, "data") and hasattr(tree, "s_cap"):
        return _flat(tree.data, join("data"))
    if isinstance(tree, tuple) and not all(isinstance(a, (str, type(None))) for a in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, join(i)))
        return out
    return {prefix: tree}


def _dicts(tree, prefix=""):
    """``{dotted path: leaf}`` of nested dicts (a spec is a leaf)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_dicts(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_make_rules_equal_the_reference(kind, mesh):
    """Every registered arch's rule set, key for key."""
    for arch in ARCHS:
        got = make_rules(configs.get(arch).config, kind, MESHES[mesh])
        want = jax_rules.make_rules(jax_configs.get(arch).config, kind, _FakeMesh(MESHES[mesh]))
        assert got == want, (arch, kind, mesh)


@pytest.mark.parametrize("axes,want", [
    (("a", "b"), P(("pod", "data"))),
    (("b", "a"), P("data", "pod")),
    (("c", None), P()),
    (("b", "c", "a", None), P("data", None, "pod")),
    ((None, "a", "a"), P(None, ("pod", "data"))),
])
def test_spec_for_deduplicates_as_the_reference(axes, want):
    """A mesh axis already used by an earlier dim is dropped; trailing
    ``None``s are stripped (``tests/test_sharding_rules.py``'s cases)."""
    rules = {"a": ("pod", "data"), "b": "data", "c": None}
    with axis_rules(None, rules):
        got = spec_for(axes)
    with jax_sharding.axis_rules(None, rules):
        assert tuple(jax_sharding.spec_for(axes)) == tuple(want)
    assert got == tuple(want)
    assert spec_for(axes) == ()  # no active rules


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_schema_specs_axes_and_abstract_params_equal_the_reference(kind, mesh):
    """Every leaf's spec (`param_pspecs`), axes (`schema_axes`) and meta
    shape and dtype (`abstract_params`), for every arch, under its rules."""
    for arch in ARCHS:
        sch, jsch = _schemas(arch)
        rules = make_rules(configs.get(arch).config, kind, MESHES[mesh])
        with axis_rules(None, rules):
            got = _dicts(schema.param_pspecs(sch))
        with jax_sharding.axis_rules(None, rules):
            want = _dicts(jax_schema.param_pspecs(jsch))
        assert got == {k: tuple(v) for k, v in want.items()}, (arch, kind, mesh)
        assert _flat(schema.schema_axes(sch)) == _flat(jax_shapes.schema_axes(jsch)), arch
        abstract = _flat(schema.abstract_params(sch))
        jabstract = _flat(jax_schema.abstract_params(jsch))
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in
                abstract.items()} == {k: (tuple(t.shape), str(t.dtype)) for k, t in
                                      jabstract.items()}, arch
        assert all(t.device.type == "meta" for t in abstract.values())


@pytest.mark.parametrize("quantize", [False, True])
def test_optimizer_state_axes_equal_the_reference(quantize):
    """The AdamW state's axes of every arch's schema, int8 moments' scale
    axes included (the port keys moments by dotted name, the reference
    nests them: the same paths)."""
    for arch in ARCHS:
        sch, jsch = _schemas(arch)
        got = shapes.opt_axes(sch, optim.AdamWConfig(quantize_moments=quantize))
        want = jax_shapes.opt_abstract_and_axes(jsch, jax_optim.AdamWConfig(
            quantize_moments=quantize))[1]
        assert _flat(got) == _flat(want), arch


def test_every_cell_has_the_reference_axes_kind_and_donate():
    """Every dry-run cell: the same (arch, shape) list, kind, donated
    arguments and logical axes of every argument leaf."""
    cells = {(c.arch_id, c.shape_id): c for c in shapes.all_cells()}
    jcells = {(c.arch_id, c.shape_id): c for c in jax_shapes.all_cells()}
    assert list(cells) == list(jcells)
    for key, c in cells.items():
        j = jcells[key]
        assert (c.kind, c.donate) == (j.kind, j.donate), key
        cfg, jcfg = configs.get(key[0]).config, jax_configs.get(key[0]).config
        q = schema.count_params(_schemas(key[0])[0]) > 1e11
        got = c.arg_axes(cfg, optim.AdamWConfig(quantize_moments=q))
        want = j.arg_axes(jcfg, jax_optim.AdamWConfig(quantize_moments=q))
        assert _flat(got) == _flat(want), key
    donate = {c.kind: c.donate for c in cells.values()}
    assert donate == {"train": (0, 1), "prefill": (), "decode": (1,), "decode_long": (1,),
                      "serve": (), "retrieve": ()}


def test_placements_on_a_mesh():
    """`placements`: a tensor dim's mesh axes become ``Shard`` of that dim,
    the others ``Replicate``; a dim over two mesh axes names them in mesh
    order, any other order raises, as does an axis the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = type("M", (), {"mesh_dim_names": ("pod", "data", "model")})()
    assert sharding.placements((None, "model", "data"), mesh) == (Replicate(), Shard(2), Shard(1))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        sharding.placements(("expert",), mesh)


def test_param_bytes_a_rank_follow_the_reference_specs():
    """Rank 0's parameter bytes on a mesh, from the JAX ``param_pspecs``
    (a dim's chunk: its size over the product of its mesh axes, rounded
    up, as DTensor's first chunk is), equal `schema.rank_bytes` of the
    port's schema under the port's rules."""
    cfg = dataclasses.replace(configs.get("qwen2-72b").config, n_layers=2)
    jcfg = jax_configs.get("qwen2-72b").config.__class__(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    sizes = MESHES["2x16x16"]
    rules = make_rules(cfg, "prefill", sizes)
    with jax_sharding.axis_rules(None, rules):
        specs = _dicts(jax_schema.param_pspecs(jax_tf.lm_schema(jcfg)))
    abstract = _dicts(jax_schema.abstract_params(jax_tf.lm_schema(jcfg)))
    want = 0
    for name, spec in specs.items():
        shape, item = abstract[name].shape, np.dtype(abstract[name].dtype).itemsize
        local = list(shape)
        for i, entry in enumerate(spec):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            local[i] = -(-shape[i] // int(np.prod([sizes[a] for a in names])))
        want += int(np.prod(local)) * item
    got = schema.rank_bytes(transformer.lm_schema(cfg), rules, sizes)
    assert got == want
    assert jax.tree.leaves(specs)  # the reference shards some leaf
