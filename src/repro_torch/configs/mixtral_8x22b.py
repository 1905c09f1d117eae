"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]. The JAX package's ``configs/mixtral_8x22b.py``:
140,630,071,296 parameters, 281.3 GB in bf16, so one card serves it cut in
depth only (``chip_smoke.py`` runs 4 of its 56 layers at full width:
10,418,903,040 parameters, 20.8 GB)."""
from repro_torch.configs.base import ArchEntry, LMConfig, MoEConfig, register

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384, capacity_factor=1.25),
    remat="block",
)


def smoke() -> LMConfig:
    return LMConfig(
        name="mixtral-8x22b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=8,
        dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=2.0),
    )


ENTRY = register(
    ArchEntry(
        arch_id="mixtral-8x22b",
        family="lm",
        config=CONFIG,
        smoke=smoke,
        # long_500k runs: SWA bounds the attention window (sub-quadratic)
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    )
)
