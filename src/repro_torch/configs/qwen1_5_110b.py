"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-110B; hf]. The JAX package's
``configs/qwen1_5_110b.py``: 111,209,914,368 parameters, 222.4 GB in bf16,
so it does not fit on one card: the port runs its smoke config."""
from repro_torch.configs.base import ArchEntry, LMConfig, register

CONFIG = LMConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    remat="block",
)


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=192,
        vocab_size=256,
        qkv_bias=True,
        dtype="float32",
    )


ENTRY = register(
    ArchEntry(
        arch_id="qwen1.5-110b",
        family="lm",
        config=CONFIG,
        smoke=smoke,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes=(
            ("long_500k", "pure full-attention arch (no sub-quadratic mechanism); skipped per brief"),
        ),
    )
)
