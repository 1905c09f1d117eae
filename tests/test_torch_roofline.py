"""The port's roofline (`repro_torch.analysis.roofline`) and the parameter
counts it reads: the H100 terms, collective statistics from recorded
calls, the matcher's per-entry-point rooflines, and the registry's
``n_params``/``n_active_params`` and every ``model_flops_*`` equal to the
JAX package's for every registered arch and shape, exactly."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.analysis import roofline as jroofline  # noqa: E402
from repro.extras.shapes import GNN_SHAPES, LM_SHAPES, REC_SHAPES  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW,
    PEAK_FLOPS,
    CollectiveStats,
    Roofline,
    engine_rooflines,
    model_flops_gnn,
    model_flops_lm,
    model_flops_recsys,
)
from repro_torch.analysis.staticcheck.collective_safety import CollectiveCall  # noqa: E402

ARCHS = sorted(configs.all_archs())


def test_h100_constants():
    assert PEAK_FLOPS == roofline.BF16_FLOPS == 989e12
    assert (roofline.TF32_FLOPS, roofline.FP32_FLOPS) == (495e12, 67e12)
    assert (HBM_BW, roofline.NVLINK_BW) == (3.35e12, 450e9)
    assert roofline.peak_for("torch.float32") == 67e12
    assert roofline.peak_for("bfloat16") == 989e12


def test_roofline_terms_and_bottleneck():
    r = Roofline(
        flops=PEAK_FLOPS,              # exactly 1 s of compute
        hbm_bytes=HBM_BW / 2,          # 0.5 s
        collective_bytes=roofline.NVLINK_BW * 2,  # 2 s over NVLink
        n_chips=4,
        model_flops=PEAK_FLOPS * 4,    # ideal = 1 s/chip
    )
    assert np.isclose(r.t_compute, 1.0)
    assert np.isclose(r.t_memory, 0.5)
    assert np.isclose(r.t_collective, 2.0)
    assert r.bottleneck == "collective"
    assert np.isclose(r.useful_flops_ratio, 1.0)
    assert np.isclose(r.roofline_fraction, 0.5)  # ideal 1s / bound 2s
    # one card: the stacked shards exchange through HBM
    one = dataclasses.replace(r, n_chips=1)
    assert np.isclose(one.t_collective, roofline.NVLINK_BW * 2 / HBM_BW)
    assert one.to_dict()["bottleneck"] == one.bottleneck


def test_collective_stats_from_calls_kinds_and_bytes():
    def call(name, nbytes):
        return CollectiveCall(name, {}, {}, 8, nbytes)

    st = CollectiveStats.from_calls([
        call("or_allreduce", 4096), call("pmax", 4), call("gather_load_set", 1024),
        call("gather_load_set_ring", 256), call("fetch_load_set", 1024),
    ])
    assert st.count_by_kind == {"all-reduce": 2, "all-gather": 1, "collective-permute": 1}
    ring = 7 / 8
    assert np.isclose(st.bytes_by_kind["all-reduce"], (4096 + 4) * 2 * ring)
    assert np.isclose(st.bytes_by_kind["all-gather"], 1024 * ring)
    assert np.isclose(st.bytes_by_kind["collective-permute"], 256)
    assert np.isclose(st.total_bytes, sum(st.bytes_by_kind.values()))


def test_engine_rooflines_attribute_matcher_entry_points():
    rooflines = engine_rooflines(backends=("local",), kernels=("torch",), device="cpu")
    assert set(rooflines) == {"engine:local:torch:match", "engine:local:torch:join"}
    for r in rooflines.values():
        assert r.flops > 0 and r.hbm_bytes > 0
        assert r.bottleneck in ("compute", "memory")  # one engine moves nothing
        assert 0.0 < r.roofline_fraction <= 1.0
        assert r.to_dict()["bottleneck"] == r.bottleneck


def _cells(entry):
    if entry.family == "lm":
        return [dict(shape=s, **LM_SHAPES[s]) for s in entry.shapes]
    if entry.family == "gnn":
        return [dict(shape=s, **GNN_SHAPES[s]) for s in entry.shapes]
    if entry.family == "recsys":
        return [dict(shape=s, **REC_SHAPES[s]) for s in entry.shapes]
    return []


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_model_flops_equal_the_reference(arch):
    ours, ref = configs.get(arch), jconfigs.get(arch)
    cfgs = [(ours.config, ref.config), (ours.smoke(), ref.smoke())]
    for a, b in cfgs:
        if ours.family == "lm":
            assert a.attn_kind == b.attn_kind
            assert a.n_params() == b.n_params()
            assert a.n_active_params() == b.n_active_params()
    for c in _cells(ours):
        for a, b in cfgs:
            if ours.family == "lm":
                for kind in (c["kind"], "train", "prefill", "decode"):
                    assert model_flops_lm(a, c["batch"], c["seq"], kind) == \
                        jroofline.model_flops_lm(b, c["batch"], c["seq"], kind)
            elif ours.family == "gnn":
                assert model_flops_gnn(a, c["n"], c["e"]) == \
                    jroofline.model_flops_gnn(b, c["n"], c["e"])
            else:
                for kind in (c["kind"], "train"):
                    assert model_flops_recsys(a, c["batch"], kind) == \
                        jroofline.model_flops_recsys(b, c["batch"], kind)


def test_model_flops_published_configs():
    # 6·N_active·D sanity for DeepSeek-V3: 37B active × 6 × tokens
    cfg = configs.get("deepseek-v3-671b").config
    f = model_flops_lm(cfg, batch=256, seq=4096, kind="train")
    assert np.isclose(f, 6 * cfg.n_active_params() * 256 * 4096)
    assert 35e9 < cfg.n_active_params() < 40e9
    assert np.isclose(model_flops_lm(cfg, batch=128, seq=32768, kind="decode"),
                      2 * cfg.n_active_params() * 128)
