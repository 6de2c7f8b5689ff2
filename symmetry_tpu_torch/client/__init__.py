from symmetry_tpu_torch.client.client import SymmetryClient

__all__ = ["SymmetryClient"]
