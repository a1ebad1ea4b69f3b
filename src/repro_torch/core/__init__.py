"""Host-side RPCool machinery the serving plane runs on: heaps, seals,
sandboxes, leases and quotas, and the RPC plane over them (descriptor
rings, typed marshalling, futures and streams, services, the fallback
transport, and the cluster plane: router, replicas and failover,
lifecycle, snapshot and migration, chaos). NumPy and plain Python: the rings,
scopes and descriptor tables are host memory standing in for the CXL
region.

Layers (bottom-up), each the reference package's module of the same name:
  addr        packed 64-bit global addresses
  heap        SharedHeap: paged memory + permissions + epochs
  scope       contiguous page ranges bounding one RPC's arguments
  seal        Fig. 8 seal()/release() protocol + batched and window release
  sandbox     MPK-analogue pointer confinement, 14 cached sandboxes
  containers  heap-resident pointer-rich objects, deep_copy
  serial      the by-value wire format, and the SerialChannel baseline
  orchestrator heap ids, leases, byte/request/page quotas, pods,
              channel registry, failure GC
  channel     channels/connections/descriptor rings, serve loops
              (serve_once/serve_many/listen), ServerLoop
  marshal     typed zero-copy invoke, GraphRef/build_graph, futures and
              gather, streaming reply chains, the serializing baseline
  service     @service/@method declarations, client stubs (sync, future,
              stream), the interceptors
  fallback    two-node software-coherent link (RDMA analogue): staged
              flights, link streams, one-sided put/get, LinkPool stripes
  router      ClusterRouter: endpoint names → CXL ring or fallback,
              lease heartbeats, replica failover, balanced and wildcard
              stubs, live migration (migrate)
  lifecycle   Endpoint handle: serve/quiesce/drain/close states
  snapshot    snapshot/restore: service checkpoints → warm replicas
  chaos       seeded fault plans and their injector
Every heap takes ``sanitize=`` and feeds the ShmCheck tracer of
``repro_torch.analysis`` when one is attached (off by default).
"""

from . import addr, containers, marshal, serial
from ..configs.global_config import ReproConfig, global_config
from .channel import (
    E_DEADLINE,
    E_OVERLOAD,
    F_BYVAL,
    F_DEADLINE,
    F_SANDBOXED,
    F_SEALED,
    F_STREAM,
    F_TYPED,
    RING_DTYPE,
    RPC,
    BusyWaitPolicy,
    Channel,
    Connection,
    DescriptorRing,
    RpcError,
    ServerCtx,
    ServerLoop,
)
from .errors import (
    AllocationError,
    ChannelError,
    DeadlineExceeded,
    InvalidPointer,
    LeaseExpired,
    Overloaded,
    OwnershipMiss,
    QuotaExceeded,
    RPCoolError,
    SandboxViolation,
    SealedPageError,
    SealViolation,
    WaitTimeout,
)
from .fallback import DSMLink, DSMNode, FallbackConnection, LinkPool
from .heap import PERM_SEALED, SharedHeap
from .marshal import (
    ArgView,
    FallbackRpcFuture,
    FallbackRpcStream,
    GraphRef,
    RpcFuture,
    RpcStream,
    ServerStream,
    build_graph,
    gather,
)
from .orchestrator import Lease, Orchestrator
from .router import (
    BalancedConnection,
    ClusterRouter,
    EndpointRecord,
    MigrationReport,
    RoutedConnection,
    RoutedRpcFuture,
    RoutedRpcStream,
    WildcardConnection,
)
from .lifecycle import (
    CLOSED,
    DRAINED,
    QUIESCED,
    SERVING,
    Endpoint,
    QuiesceGate,
)
from .snapshot import RestoredEndpoint, Snapshot, restore, snapshot, sync_state
from .chaos import KINDS, ChaosInjector, Fault, FaultPlan
from .sandbox import MAX_CACHED, Sandbox, SandboxManager
from .scope import Scope, ScopePool, create_scope
from .seal import S_COMPLETE, S_RELEASED, S_SEALED, SealManager
from .serial import SerialChannel
from .service import (
    AdmissionInterceptor,
    DeadlineEnforcer,
    Interceptor,
    MethodSpec,
    RetryInterceptor,
    ServiceDef,
    ServiceStub,
    StatsInterceptor,
    StubMethod,
    method,
    service,
    service_def,
    stable_fn_id,
)

__all__ = [
    "addr", "containers", "marshal", "serial",
    "ReproConfig", "global_config",
    "E_DEADLINE", "E_OVERLOAD", "F_BYVAL", "F_DEADLINE", "F_SANDBOXED",
    "F_SEALED", "F_STREAM", "F_TYPED", "RING_DTYPE", "RPC",
    "BusyWaitPolicy", "Channel", "Connection", "DescriptorRing",
    "RpcError", "ServerCtx", "ServerLoop",
    "AllocationError", "ChannelError", "DeadlineExceeded", "InvalidPointer",
    "LeaseExpired", "Overloaded", "OwnershipMiss", "QuotaExceeded", "RPCoolError",
    "SandboxViolation", "SealedPageError", "SealViolation", "WaitTimeout",
    "DSMLink", "DSMNode", "FallbackConnection", "LinkPool",
    "PERM_SEALED", "SharedHeap",
    "ArgView", "FallbackRpcFuture", "FallbackRpcStream", "GraphRef",
    "RpcFuture", "RpcStream", "ServerStream", "build_graph", "gather",
    "Lease", "Orchestrator",
    "BalancedConnection", "ClusterRouter", "EndpointRecord",
    "MigrationReport", "RoutedConnection", "RoutedRpcFuture",
    "RoutedRpcStream", "WildcardConnection",
    "CLOSED", "DRAINED", "Endpoint", "QUIESCED", "QuiesceGate", "SERVING",
    "RestoredEndpoint", "Snapshot", "restore", "snapshot", "sync_state",
    "ChaosInjector", "Fault", "FaultPlan", "KINDS",
    "MAX_CACHED", "Sandbox", "SandboxManager",
    "Scope", "ScopePool", "create_scope",
    "S_COMPLETE", "S_RELEASED", "S_SEALED", "SealManager",
    "SerialChannel",
    "AdmissionInterceptor", "DeadlineEnforcer", "Interceptor", "MethodSpec",
    "RetryInterceptor", "ServiceDef", "ServiceStub", "StatsInterceptor",
    "StubMethod", "method", "service", "service_def", "stable_fn_id",
]
