"""Host-side heap machinery the KV pool runs on: page allocation,
permissions, seals, leases and quotas. NumPy and plain Python."""

from .errors import AllocationError, ChannelError, InvalidPointer, Overloaded, SealViolation
from .heap import PERM_SEALED, SharedHeap
from .orchestrator import Orchestrator
from .seal import SealManager

__all__ = [
    "AllocationError", "ChannelError", "InvalidPointer", "Overloaded",
    "SealViolation", "PERM_SEALED", "SharedHeap", "Orchestrator",
    "SealManager",
]
