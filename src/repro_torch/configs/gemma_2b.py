"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, tied embeddings, scaled embed [arXiv:2403.08295; hf].
The JAX package's ``configs/gemma_2b.py``: 2,506,172,416 parameters, bf16."""
from repro_torch.configs.base import ArchEntry, LMConfig, register

CONFIG = LMConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab_size=256000,
    act="geglu",
    tie_embeddings=True,
    emb_scale=True,
    remat="block",
)


def smoke() -> LMConfig:
    return LMConfig(
        name="gemma-2b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=32,
        d_ff=128,
        vocab_size=256,
        act="geglu",
        tie_embeddings=True,
        emb_scale=True,
        dtype="float32",
    )


ENTRY = register(
    ArchEntry(
        arch_id="gemma-2b",
        family="lm",
        config=CONFIG,
        smoke=smoke,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes=(
            ("long_500k", "pure full-attention arch (no sub-quadratic mechanism); skipped per brief"),
        ),
    )
)
