from symmetry_tpu_torch.provider.config import ConfigManager, TpuConfig

__all__ = ["ConfigManager", "TpuConfig"]
