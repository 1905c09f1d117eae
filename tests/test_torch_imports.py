"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and no ``examples/torch_*.py`` imports ``jax`` or
anything of the JAX package ``repro``
(its numpy-only modules included — they are copied, not imported). Checked
on the source with `ast`, so nothing is imported to check it."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                roots.add(arg.value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_port_has_its_modules():
    names = {str(f.relative_to(ROOT)) for f in FILES}
    for mod in ("api/session.py", "core/engine.py", "core/match.py", "core/join.py",
                "kernels/cuda.py", "runtime/resilience.py", "kernels/cin/cin.py",
                "kernels/cin/ref.py", "configs/base.py", "configs/xdeepfm.py",
                "models/recsys.py", "data/pipeline.py", "train/step.py",
                "configs/gin_tu.py", "configs/gatedgcn.py", "configs/egnn.py",
                "configs/meshgraphnet.py", "models/gnn.py", "models/schema.py",
                "graphstore/sampler.py",
                "extras/segment_mp/ref.py", "extras/segment_mp/segment_mp.py",
                "extras/segment_mp/ops.py", "extras/join_probe/ref.py",
                "extras/join_probe/join_probe.py", "extras/join_probe/ops.py",
                "configs/gemma_2b.py", "configs/qwen2_72b.py", "models/layers.py",
                "models/transformer.py", "extras/flash_attention/ref.py",
                "extras/flash_attention/flash_attention.py",
                "extras/flash_attention/ops.py", "core/dist.py", "core/collectives.py",
                "graphstore/cluster_graph.py", "configs/stwig.py", "workloads.py",
                "runtime/chaos.py", "runtime/server.py", "api/serve.py",
                "launch/serve.py", "optim/adamw.py", "optim/__init__.py",
                "checkpoint/checkpointer.py", "checkpoint/__init__.py",
                "runtime/fault_tolerance.py", "extras/train.py", "train/__init__.py",
                "models/moe.py", "models/mla.py", "analysis/__init__.py",
                "analysis/roofline.py",
                "analysis/staticcheck/__init__.py", "analysis/staticcheck/__main__.py",
                "analysis/staticcheck/findings.py", "analysis/staticcheck/oplog.py",
                "analysis/staticcheck/archlint.py", "analysis/staticcheck/cachekeys.py",
                "analysis/staticcheck/contracts.py", "analysis/staticcheck/engines.py",
                "analysis/staticcheck/costmodel.py",
                "analysis/staticcheck/collective_safety.py", "extras/shapes.py",
                "extras/dryrun.py"):
        assert f"src/repro_torch/{mod}" in names
    assert [f.name for f in EXAMPLES] == [
        "torch_distributed_query.py", "torch_quickstart.py", "torch_serve_queries.py",
        "torch_train_lm.py"]
    for src in ("bitset.cu", "bitset.cuh", "stwig_expand.cu", "hash_join.cu", "cin.cu",
                "segment_mp.cu", "join_probe.cu", "probe.cuh", "flash_attention.cu",
                "flash_attention_tc.cu", "flash_attention_tf32.cu", "hopper.cuh"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / src).exists()
    assert (ROOT / "src" / "repro_torch" / "analysis" / "budgets.json").exists()
    assert (ROOT / "chip_smoke.py").exists()
