"""Model configurations of the port and the architecture registry, as
``src/repro/configs/``: the dataclasses the ported model paths read, one
module per configuration, and importing this package registers them all."""
from repro_torch.configs import base
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    deepseek_v3_671b,
    egnn,
    gatedgcn,
    gemma_2b,
    gin_tu,
    meshgraphnet,
    mixtral_8x22b,
    qwen1_5_110b,
    qwen2_72b,
    stwig,
    xdeepfm,
)
from repro_torch.configs.base import (
    ArchEntry,
    GNNConfig,
    LMConfig,
    MLAConfig,
    MoEConfig,
    RecSysConfig,
    all_archs,
    get,
)

__all__ = ["base", "ArchEntry", "GNNConfig", "LMConfig", "MLAConfig", "MoEConfig",
           "RecSysConfig", "all_archs", "get"]
