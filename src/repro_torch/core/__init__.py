"""Host-side RPCool machinery the serving plane runs on: heaps, seals,
sandboxes, leases and quotas, and the RPC plane over them (descriptor
rings, typed marshalling, services, the cluster router and the fallback
transport). NumPy and plain Python: the rings, scopes and descriptor
tables are host memory standing in for the CXL region.

Layers (bottom-up), each the reference package's module of the same name
trimmed to what the serving engine calls:
  addr        packed 64-bit global addresses
  heap        SharedHeap: paged memory + permissions + epochs
  scope       contiguous page ranges bounding one RPC's arguments
  seal        Fig. 8 seal()/release() protocol + batched release
  sandbox     MPK-analogue pointer confinement, 14 cached sandboxes
  containers  heap-resident pointer-rich objects
  serial      the by-value wire format of the fallback route
  orchestrator heap ids, leases, quotas, pods, channel registry
  channel     channels/connections/descriptor rings, ServerLoop
  marshal     typed zero-copy invoke, streaming reply chains
  service     @service/@method declarations and client stubs
  fallback    two-node software-coherent link (RDMA analogue)
  router      ClusterRouter: endpoint names → CXL ring or fallback
"""

from . import addr, containers, serial
from .channel import (
    BusyWaitPolicy,
    Channel,
    Connection,
    DescriptorRing,
    RPC,
    RpcError,
    ServerCtx,
    ServerLoop,
)
from .errors import (
    AllocationError,
    ChannelError,
    DeadlineExceeded,
    InvalidPointer,
    Overloaded,
    OwnershipMiss,
    QuotaExceeded,
    SandboxViolation,
    SealedPageError,
    SealViolation,
    WaitTimeout,
)
from .fallback import DSMLink, FallbackConnection, LinkPool
from .heap import PERM_SEALED, SharedHeap
from .marshal import ArgView, RpcStream, ServerStream
from .orchestrator import Orchestrator, ReproConfig
from .router import ClusterRouter, RoutedConnection
from .sandbox import Sandbox, SandboxManager
from .scope import Scope, ScopePool, create_scope
from .seal import SealManager
from .service import (
    AdmissionInterceptor,
    DeadlineEnforcer,
    Interceptor,
    ServiceDef,
    ServiceStub,
    StubMethod,
    method,
    service,
    service_def,
    stable_fn_id,
)

__all__ = [
    "addr", "containers", "serial",
    "BusyWaitPolicy", "Channel", "Connection", "DescriptorRing", "RPC",
    "RpcError", "ServerCtx", "ServerLoop",
    "AllocationError", "ChannelError", "DeadlineExceeded", "InvalidPointer",
    "Overloaded", "OwnershipMiss", "QuotaExceeded", "SandboxViolation",
    "SealedPageError", "SealViolation", "WaitTimeout",
    "DSMLink", "FallbackConnection", "LinkPool",
    "PERM_SEALED", "SharedHeap",
    "ArgView", "RpcStream", "ServerStream",
    "Orchestrator", "ReproConfig",
    "ClusterRouter", "RoutedConnection",
    "Sandbox", "SandboxManager",
    "Scope", "ScopePool", "create_scope",
    "SealManager",
    "AdmissionInterceptor", "DeadlineEnforcer", "Interceptor", "ServiceDef", "ServiceStub",
    "StubMethod", "method", "service", "service_def", "stable_fn_id",
]
