"""Model configurations of the port: the dataclasses the ported model paths
read, and one module per configuration (as ``src/repro/configs/``)."""
from repro_torch.configs.base import GNNConfig, LMConfig, MLAConfig, MoEConfig, RecSysConfig

__all__ = ["GNNConfig", "LMConfig", "MLAConfig", "MoEConfig", "RecSysConfig"]
