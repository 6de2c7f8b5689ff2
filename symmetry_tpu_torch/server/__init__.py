from symmetry_tpu_torch.server.registry import Registry

__all__ = ["Registry", "SymmetryServer"]


def __getattr__(name: str):
    # Lazy (PEP 562): the broker pulls the identity/crypto stack; the
    # registry (sqlite data model) must stay importable without it.
    if name == "SymmetryServer":
        from symmetry_tpu_torch.server.broker import SymmetryServer

        return SymmetryServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
