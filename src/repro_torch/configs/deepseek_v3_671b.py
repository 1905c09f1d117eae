"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff_expert=2048
vocab=129280 — MLA (q_lora 1536, kv_lora 512, rope 64), 1 shared + 256
routed top-8 sigmoid router w/ aux-free bias + group-limited routing
(8 groups, top-4), first 3 layers dense (d_ff 18432), MTP
[arXiv:2412.19437; hf]. The JAX package's ``configs/deepseek_v3_671b.py``:
671,129,186,816 parameters, 1,342.5 GB in bf16, so one card serves it cut
in depth only (``chip_smoke.py`` runs its 3 dense layers and 2 MoE layers,
all 256 experts, at full width: 26,721,155,584 parameters, 53.4 GB)."""
from repro_torch.configs.base import ArchEntry, LMConfig, MLAConfig, MoEConfig, register

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=18432,
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        router="sigmoid",
        router_bias_balancing=True,
        n_groups=8,
        top_groups=4,
        first_k_dense=3,
        d_ff_dense=18432,
        capacity_factor=1.25,
    ),
    mtp_depth=1,
    remat="block",
)


def smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, d_nope=16, d_rope=8, d_v=16),
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=32,
            n_shared=1,
            router="sigmoid",
            router_bias_balancing=True,
            n_groups=2,
            top_groups=1,
            first_k_dense=1,
            d_ff_dense=128,
            capacity_factor=2.0,
        ),
        mtp_depth=1,
    )


ENTRY = register(
    ArchEntry(
        arch_id="deepseek-v3-671b",
        family="lm",
        config=CONFIG,
        smoke=smoke,
        # long_500k runs: MLA latent KV cache (576/token) makes 500k-context
        # decode practical; per-step attention is O(L·d_c)
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    )
)
