from symmetry_tpu_torch.transport.base import Connection, Listener, Transport
from symmetry_tpu_torch.transport.memory import MemoryTransport, memory_pair
from symmetry_tpu_torch.transport.tcp import TcpTransport


def transport_for(address: str) -> Transport:
    """Pick a transport by address scheme: tcp:// (default) or udp:// (native
    C++ udpstream, transport/udp.py). mem:// is rejected: MemoryTransport
    registries are instance-local, so a fresh instance could never reach an
    existing listener — tests must inject their hub explicitly."""
    if address.startswith("udp://"):
        from symmetry_tpu_torch.transport.udp import UdpTransport

        return UdpTransport()
    if address.startswith("mem://"):
        raise ValueError(
            "mem:// requires passing the shared MemoryTransport instance")
    return TcpTransport()


__all__ = [
    "Connection",
    "Listener",
    "Transport",
    "MemoryTransport",
    "memory_pair",
    "TcpTransport",
    "transport_for",
]
