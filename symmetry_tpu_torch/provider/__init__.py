from symmetry_tpu_torch.provider.config import ConfigManager, TpuConfig

__all__ = ["ConfigManager", "TpuConfig", "SymmetryProvider"]


def __getattr__(name: str):
    # Lazy (PEP 562): SymmetryProvider pulls the identity/crypto stack,
    # which the engine-host and backend paths (engine/host.py, tpu_native)
    # never need — importing the package must not require `cryptography`.
    if name == "SymmetryProvider":
        from symmetry_tpu_torch.provider.provider import SymmetryProvider

        return SymmetryProvider
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
