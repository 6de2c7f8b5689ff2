from symmetry_tpu_torch.network.peer import Peer

__all__ = ["Peer"]
