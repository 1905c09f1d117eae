"""Three-term roofline model on the H100, and the models' useful FLOPs.

    compute    = FLOPs       / (chips × peak FLOP/s of the dtype)
    memory     = HBM bytes   / (chips × HBM rate)
    collective = coll bytes  / (chips × link rate)

The terms are the JAX package's (``src/repro/analysis/roofline.py``); the
constants are the H100 SXM data sheet's, not the TPU's: dense tensor-core
rates of 989e12 (bf16) and 495e12 (TF32) operations a second, 67e12 fp32
on the CUDA cores, HBM3 at 3.35e12 bytes a second and NVLink at 450e9
bytes a second each way. `PEAK_FLOPS` is the bf16 rate, as the JAX
package's is its bf16 rate; `peak_for` gives the rate of a dtype.

HLO text has no meaning for PyTorch, so there is no ``parse_collectives``:
`CollectiveStats` is built from the collective calls the staticcheck probe
recorded (`from_calls`), with the cost model's ring conventions.

`engine_rooflines` points the same model at the matcher: per entry point,
the cost model's FLOPs, peak live bytes and collective bytes over the
engine probe's recorded steps and collectives. On one card the stacked
shards' collectives move through HBM, not NVLink, so they are charged at
HBM's rate there (``n_chips=1``).

`model_flops_lm`, `model_flops_gnn` and `model_flops_recsys` are the JAX
package's formulas: the useful work of a step, for a share of peak.
"""
from __future__ import annotations

import dataclasses

BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor-core rate (data sheet)
FP32_FLOPS = 67e12      # H100 SXM non-tensor-core fp32 rate (data sheet)
HBM_BW = 3.35e12        # H100 SXM HBM3 rate, bytes a second (data sheet)
NVLINK_BW = 450e9       # H100 SXM NVLink, bytes a second each way (data sheet)
PEAK_FLOPS = BF16_FLOPS

_PEAKS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "tf32": TF32_FLOPS,
          "float32": FP32_FLOPS}


def peak_for(dtype: str) -> float:
    """The H100's peak rate for work in ``dtype`` (``"bfloat16"``,
    ``"float16"``, ``"tf32"``, ``"float32"``)."""
    return _PEAKS[str(dtype).removeprefix("torch.")]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    @staticmethod
    def from_calls(calls) -> "CollectiveStats":
        """From recorded `collective_safety.CollectiveCall`s: bytes a shard
        by kind (the cost model's conventions) and calls by kind."""
        from repro_torch.analysis.staticcheck import costmodel

        counts: dict[str, int] = {}
        for c in calls:
            kind = costmodel.COLLECTIVE_KIND.get(c.name)
            if kind is not None:
                counts[kind] = counts.get(kind, 0) + 1
        return CollectiveStats(costmodel.collective_bytes(calls), counts)


@dataclasses.dataclass
class Roofline:
    flops: float             # per-device FLOPs
    hbm_bytes: float         # per-device bytes accessed
    collective_bytes: float  # per-device collective bytes moved
    n_chips: int
    model_flops: float = 0.0  # 6·N·D (or 6·N_active·D) whole-step model flops
    peak_flops: float = PEAK_FLOPS

    @property
    def link_bw(self) -> float:
        """One card's stacked shards exchange through HBM; more cards
        through NVLink."""
        return HBM_BW if self.n_chips == 1 else NVLINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total FLOPs (remat/redundancy waste detector)."""
        total = self.flops * self.n_chips
        return (self.model_flops / total) if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step's time the dominant term says is 'useful
        peak': model_flops/chips/PEAK divided by the bounding term."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        ideal = (self.model_flops / self.n_chips) / self.peak_flops
        return (ideal / bound) if bound > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# ------------------------------------------------- matcher engine rooflines
def engine_rooflines(
    backends=None,
    kernels=("torch",),
    *,
    device=None,
    scale: int = 1,
    n_chips: int = 1,
    traces=None,
) -> "dict[str, Roofline]":
    """Per-entry-point rooflines for the matcher engines, from the cost
    model over the engine probe's entry traces (``traces``, or a fresh
    probe of ``backends`` × ``kernels`` on ``device``; ``None``: the card,
    and it raises without one). Per target, the
    per-metric max over its entry points (the budgets pass's aggregation)
    feeds one `Roofline`:

      * ``flops``            — the cost model's counted operations, at the
        fp32 rate (the matcher's work is integer and fp32, no tensor core);
      * ``hbm_bytes``        — peak live bytes, a floor on HBM traffic;
      * ``collective_bytes`` — ring-convention collective bytes a shard;
      * ``model_flops``      — equal to ``flops``: the matcher has no
        closed-form useful-work model, so ``roofline_fraction`` reads as
        the share of the bounding term compute accounts for.

    Returns ``{target: Roofline}`` with targets like
    ``engine:local:torch:match``.
    """
    from repro_torch.analysis.staticcheck import costmodel
    from repro_torch.analysis.staticcheck import engines as _engines

    if traces is None:
        _, traces = _engines.check_engines_traces(
            tuple(backends or _engines.ENGINE_BACKENDS), tuple(kernels),
            device=device, scale=scale,
        )
    worst = costmodel.aggregate(
        [costmodel.estimate(t.log, t.target, t.collectives) for t in traces]
    )
    return {
        target: Roofline(
            flops=m["flops"],
            hbm_bytes=m["peak_bytes"],
            collective_bytes=m["collective_bytes"],
            n_chips=n_chips,
            model_flops=m["flops"],
            peak_flops=FP32_FLOPS,
        )
        for target, m in sorted(worst.items())
    }


def model_flops_lm(cfg, batch: int, seq: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    n = cfg.n_active_params()
    tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def model_flops_gnn(cfg, n_nodes: int, n_edges: int) -> float:
    """Per-layer: edges × d_hidden message work + nodes × MLP work, ×3 (train)."""
    d = cfg.d_hidden
    per_layer = 2.0 * n_edges * d * d + 2.0 * n_nodes * d * d * 2
    return 3.0 * cfg.n_layers * per_layer


def model_flops_recsys(cfg, batch: int, kind: str) -> float:
    m, d = cfg.n_sparse, cfg.embed_dim
    cin = 0.0
    h_prev = m
    for h in cfg.cin_layers:
        cin += 2.0 * h_prev * m * d * h
        h_prev = h
    dims = [m * d] + list(cfg.mlp_layers) + [1]
    dnn = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
    mult = 3.0 if kind == "train" else 1.0
    return mult * batch * (cin + dnn)
