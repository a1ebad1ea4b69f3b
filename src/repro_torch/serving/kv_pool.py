"""PagedKVPool — the KV cache as an RPCool shared-memory heap.

The pool is the device-resident instantiation of the paper's shared heap:
  * a page = one KV block (page_tokens × kv_heads × head_dim × 2 (K,V) ×
    num_layers);
  * page accounting, ownership, permissions, leases and quotas run
    through this package's SharedHeap/Orchestrator, so page ids, seal
    indices and quota sheds are the reference's;
  * block tables are page indices — the pointer-rich RPC argument of the
    serving data plane;
  * seals: prefill write-protects a request's pages before the handoff;
    the paged-attention kernel verifies the seal on every dereference;
  * sandbox bitmap: pages owned by the connection — a wild block-table
    entry pointing at another request's pages is masked and flagged.

``k``/``v`` are ``(L, P, T, Hkv, D)`` bf16 tensors on the pool's device;
the permission word, sandbox bitmap and descriptor reach the kernel as
int32 tensors on the same device.

``PoolPages`` is a page set passed *by reference* as an RPC argument: the
stub resolves it against the route the call takes — the raw page ids in
pod, one bulk page migration across pods (``transfer_pages_cross_pod``,
charged to the fallback link).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import AllocationError, ChannelError, Overloaded
from ..core.orchestrator import Orchestrator
from ..core.seal import SealManager
from ..device import DeviceLike, resolve_device
from ..kernels.scope_copy.ops import gather_pages, scatter_pages
from ..models.config import ModelConfig

# back-off hint carried by pool-pressure sheds (§5.4 retry-after)
POOL_RETRY_AFTER_S = 0.02


@dataclass
class PoolConfig:
    num_pages: int = 256
    page_tokens: int = 16
    max_pages_per_seq: int = 32


class PagedKVPool:
    def __init__(self, orch: Orchestrator, cfg: ModelConfig,
                 pool_cfg: PoolConfig, owner_pid: int,
                 pod: Optional[str] = None, device: DeviceLike = None):
        self.cfg = cfg
        self.pc = pool_cfg
        self.device = resolve_device(device)
        L = cfg.num_layers
        T, P = pool_cfg.page_tokens, pool_cfg.num_pages
        Hkv, D = cfg.num_kv_heads, cfg.head_dim

        # page byte size for quota accounting (K+V, all layers)
        self.page_bytes = 2 * L * T * Hkv * D * 2
        self.heap = orch.create_heap(P, page_size=self.page_bytes,
                                     name="kv_pool")
        orch.map_heap(owner_pid, self.heap)
        self.heap.attach_device_perm(self.device)
        # the seal descriptor ring takes heap pages 0..r-1; those pages
        # exist in the device pool too but are never handed to requests
        self.seals = SealManager(self.heap, capacity=4 * P)
        self.k = torch.zeros((L, P, T, Hkv, D), dtype=torch.bfloat16,
                             device=self.device)
        self.v = torch.zeros_like(self.k)
        self.owner_pid = owner_pid
        self.orch = orch
        self.pod = pod
        if pod is not None:
            # publish as the pod's KV pool: cross-pod byref arguments
            # resolve their destination pages against this registry
            orch.register_pool(pod, self)
        # bytes bulk-migrated into/out of this pool by cross-pod byref
        # handoffs (zero on the CXL route)
        self.byref_bytes_in = 0
        self.byref_bytes_out = 0

    # -- allocation (pointer minting) -----------------------------------
    def pages_owned(self, conn_id: int) -> int:
        """Pool pages ``conn_id`` currently owns (quota accounting)."""
        return int(((self.heap.owner == conn_id)
                    & (self.heap.state == 1)).sum())

    def _check_page_quota(self, conn_id: int, n_pages: int) -> None:
        quota = self.orch.page_quota(conn_id)
        if quota is None:
            return
        owned = self.pages_owned(conn_id)
        if owned + n_pages > quota:
            raise Overloaded(
                f"conn {conn_id}: admit needs {n_pages} pages but "
                f"{owned}/{quota} of its page quota are in use (§5.4)",
                retry_after_s=POOL_RETRY_AFTER_S)

    def alloc_seq(self, n_tokens: int, conn_id: int) -> List[int]:
        n_pages = max(1, -(-n_tokens // self.pc.page_tokens))
        if n_pages > self.pc.max_pages_per_seq:
            raise ValueError("sequence exceeds max_pages_per_seq")
        self._check_page_quota(conn_id, n_pages)
        # one-page extents (block tables chase pointers anyway); a
        # mid-sequence failure hands the partial list back
        pages: List[int] = []
        try:
            for _ in range(n_pages):
                pages.append(self.heap.alloc_pages(1, owner=conn_id))
        except AllocationError:
            for p in pages:
                self.heap.free_extent(p, 1)
            raise
        return pages

    def extend_seq(self, pages: List[int], n_tokens: int,
                   conn_id: int) -> List[int]:
        """Grow ``pages`` in place to cover ``n_tokens``; a failed growth
        leaves the list exactly as it was."""
        need = max(1, -(-n_tokens // self.pc.page_tokens))
        if need > self.pc.max_pages_per_seq:
            raise ValueError("sequence exceeds max_pages_per_seq")
        if need > len(pages):
            self._check_page_quota(conn_id, need - len(pages))
        grown = 0
        try:
            while len(pages) < need:
                pages.append(self.heap.alloc_pages(1, owner=conn_id))
                grown += 1
        except AllocationError:
            for _ in range(grown):
                self.heap.free_extent(pages.pop(), 1)
            raise
        return pages

    def free_seq(self, pages: List[int]) -> None:
        for p in pages:
            self.heap.free_extent(p, 1)

    # -- seal protocol around the handoff -------------------------------
    def seal_seq(self, pages: List[int], holder: int) -> List[int]:
        return [self.seals.seal((p, 1), holder=holder) for p in pages]

    def complete_and_release(self, seal_idxs: List[int], holder: int,
                             batched: bool = True) -> None:
        for idx in seal_idxs:
            self.seals.mark_complete(idx)
            if batched:
                self.seals.release_batched(idx, holder=holder)
            else:
                self.seals.release(idx, holder=holder)

    # -- device-side permission state for the kernel -----------------------
    def perm_bits(self) -> torch.Tensor:
        """(P,) int32 perm words (bit0 = SEALED) on the pool's device;
        re-uploaded only after a permission epoch bump."""
        return self.heap.device_perm()

    def sandbox_bitmap(self, conn_id: int) -> torch.Tensor:
        """Pages this connection may dereference (the MPK key check)."""
        allowed = (self.heap.owner == conn_id) & (self.heap.state == 1)
        return torch.from_numpy(allowed.astype(np.int32)).to(self.device)

    def sandbox_desc(self, enforce: bool = True) -> torch.Tensor:
        return torch.tensor([0, self.pc.num_pages, 1 if enforce else 0],
                            dtype=torch.int32, device=self.device)

    # -- data plane ----------------------------------------------------------
    def write_prefill(self, cache_k, cache_v, pages: List[int],
                      n_tokens: int) -> None:
        """Scatter a prefill's contiguous (L, S, Hkv, D) KV into pages."""
        T = self.pc.page_tokens
        nP = len(pages)
        L = cache_k.shape[0]
        pad = nP * T - n_tokens
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for pool, c in ((self.k, cache_k), (self.v, cache_v)):
            blocks = F.pad(c, (0, 0, 0, 0, 0, pad)).to(pool.dtype)
            pool.index_copy_(1, idx, blocks.reshape(L, nP, T, *c.shape[2:]))

    def write_token(self, k_new, v_new, block_tab, pos) -> None:
        """Insert one decoded token's KV. k_new/v_new: (L, B, Hkv, D);
        block_tab: (B, MAXP) i32; pos: (B,) i32 (the slot being written)."""
        T = self.pc.page_tokens
        tab = torch.as_tensor(block_tab, device=self.device).long()
        pos = torch.as_tensor(pos, device=self.device).long()
        page = tab.gather(1, (pos // T)[:, None])[:, 0]        # (B,)
        slot = pos % T
        # advanced-index write: (L, B, Hkv, D) lands at [:, page_b, slot_b]
        for pool, new in ((self.k, k_new), (self.v, v_new)):
            pool[:, page, slot] = torch.as_tensor(new).to(self.device,
                                                          pool.dtype)

    def stats(self) -> Dict[str, int]:
        return self.heap.stats()


def transfer_pages_cross_pod(src_pool: PagedKVPool, dst_pool: PagedKVPool,
                             src_pages: List[int], dst_pages: List[int],
                             link=None) -> int:
    """The fallback data plane (§4.7): when prefill and decode live in
    different pods, the block-table handoff degrades to gather(src pages)
    → wire → scatter(dst pages) for K and V. The destination pool is
    updated in place. Returns the bytes moved — the number the zero-copy
    path avoids entirely.

    The reference gathers and scatters layer by layer; here each pool is
    a flat (L·P, W) view and one gather and one scatter move every layer's
    rows of a tensor, four launches a transfer. Each id is clamped to the
    flat view, as the per-layer launches clamped theirs. With ``link``
    (the fallback transport's ``DSMLink``) the bulk is charged to the
    link as one one-sided put with a completion word."""
    L, P = src_pool.k.shape[0], src_pool.k.shape[1]

    def flat_ids(pages, device):
        # page ids offset per layer into the flattened (L·P, W) pool
        ids = torch.tensor(pages, dtype=torch.int32, device=device)
        layer = P * torch.arange(L, dtype=torch.int32, device=device)
        return (ids[None, :] + layer[:, None]).reshape(-1)

    sp = flat_ids(src_pages, src_pool.device)
    dp = flat_ids(dst_pages, dst_pool.device)
    moved = 0
    for name in ("k", "v"):
        src_t, dst_t = getattr(src_pool, name), getattr(dst_pool, name)
        if not (src_t.is_contiguous() and dst_t.is_contiguous()):
            raise ValueError("pool tensors must be contiguous to flatten "
                             "into (L·P, W) views")
        # views, not copies: the scatter lands in the destination pool
        src = src_t.view(L * P, -1)
        dst = dst_t.view(L * P, -1)
        wire = gather_pages(src, sp)
        scatter_pages(dst, dp, wire.to(dst.device))
        moved += wire.numel() * wire.element_size()
    src_pool.byref_bytes_out += moved
    dst_pool.byref_bytes_in += moved
    if link is not None:
        link.put_bytes(moved, to=1)
    return moved


class PoolPages:
    """A KV-pool page set passed *by reference* as an RPC argument (the
    argument form behind ``@method(byref=True)``). The stub resolves it
    per dispatch against the route the connection took:

    * same pod (CXL ring): the raw page ids travel as the pointer set;
      zero KV bytes move;
    * cross pod (fallback link): destination pages are minted in the
      target pod's registered pool and the KV migrates in ONE bulk
      gather → wire → scatter transfer, then the *destination* ids
      travel.

    Either way the handler receives plain page ids in its own pod's
    pool. ``last_moved_bytes`` records what the most recent resolution
    copied (0 on the pointer route). The kernels dispatch on the pools'
    device, so there is no backend argument."""

    __slots__ = ("pool", "pages", "last_moved_bytes")

    def __init__(self, pool: PagedKVPool, pages: List[int]):
        self.pool = pool
        self.pages = list(pages)
        self.last_moved_bytes = 0

    def _server_pid(self, conn) -> int:
        # a RoutedConnection wraps the live target; bare connections carry
        # server_pid directly
        target = getattr(conn, "target", None) or conn
        pid = getattr(target, "server_pid", None)
        if pid is None:
            raise ChannelError(
                "byref argument needs a connection with a server pid "
                "(Connection / FallbackConnection / RoutedConnection)")
        return pid

    def __byref_resolve__(self, conn) -> List[int]:
        if getattr(conn, "transport", None) in (None, "cxl"):
            # shared coherence domain: pointer passing, nothing copied
            self.last_moved_bytes = 0
            return list(self.pages)
        orch = self.pool.orch
        pod = orch.pod_of(self._server_pid(conn))
        if pod is None:
            raise ChannelError(
                "cross-pod byref dispatch but the serving pid has no pod "
                "assignment — cannot locate the destination pool")
        dst_pool: PagedKVPool = orch.pool_of_pod(pod)
        # mint the destination block table (owned by the decode pod's
        # pool owner so its sandbox bitmap admits the kernel reads), then
        # one bulk transfer for the whole page set
        dst_pages = dst_pool.alloc_seq(
            len(self.pages) * dst_pool.pc.page_tokens, dst_pool.owner_pid)
        target = getattr(conn, "target", None) or conn
        try:
            self.last_moved_bytes = transfer_pages_cross_pod(
                self.pool, dst_pool, self.pages, dst_pages,
                link=getattr(target, "link", None))
        except BaseException:
            dst_pool.free_seq(dst_pages)
            raise
        return dst_pages
