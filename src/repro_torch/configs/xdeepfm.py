"""xdeepfm [recsys]: 39 sparse fields, embed_dim=10, CIN 200-200-200,
MLP 400-400 [arXiv:1803.05170] — the JAX package's ``configs/xdeepfm.py``.
Its shapes are `repro_torch.extras.shapes.REC_SHAPES`."""
from repro_torch.configs.base import ArchEntry, RecSysConfig, register

CONFIG = RecSysConfig(
    name="xdeepfm",
    n_sparse=39,
    embed_dim=10,
    vocab_per_field=1_000_000,
    cin_layers=(200, 200, 200),
    mlp_layers=(400, 400),
    bag_size=4,
)

def smoke() -> RecSysConfig:
    return RecSysConfig(
        name="xdeepfm-smoke",
        n_sparse=6,
        embed_dim=8,
        vocab_per_field=100,
        cin_layers=(10, 10),
        mlp_layers=(16, 16),
        bag_size=3,
    )


ENTRY = register(
    ArchEntry(
        arch_id="xdeepfm",
        family="recsys",
        config=CONFIG,
        smoke=smoke,
        shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"),
    )
)
