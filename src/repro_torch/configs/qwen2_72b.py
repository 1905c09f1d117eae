"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf]. The JAX package's
``configs/qwen2_72b.py``. At 145 GB in bf16 it does not fit on one card: the
port runs its smoke config on the CPU and its attention heads (64 on 8,
head_dim 128) in the kernel checks, never its full width."""
from repro_torch.configs.base import ArchEntry, LMConfig, register

CONFIG = LMConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    remat="block",
)


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen2-72b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        dtype="float32",
    )


ENTRY = register(
    ArchEntry(
        arch_id="qwen2-72b",
        family="lm",
        config=CONFIG,
        smoke=smoke,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes=(
            ("long_500k", "pure full-attention arch (no sub-quadratic mechanism); skipped per brief"),
        ),
    )
)
