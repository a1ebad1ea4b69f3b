"""Serving engine: continuous batching with an RPCool-disaggregated
prefill → decode handoff.

Roles (paper ↔ engine):
  prefill worker = RPC *client*: allocates pool pages (its lease), runs
      prefill, writes KV into the pages, **seals** them, and calls
      ``decode.attach`` through a service stub over the shared-memory
      descriptor ring — the argument is the pointer set (rid, prompt
      length, page ids) marshalled once into a sealed scope; no KV is
      copied.
  decode worker = RPC *server* (``DecodeService``): verifies the seal,
      adopts the request into the active set, and thereafter
      dereferences the block table in the paged-attention kernel under
      the connection's sandbox bitmap and the seal bits. It is served
      inline on the caller's thread, or by a ``ServerLoop`` thread
      (``serve_threaded=True``).
  orchestrator = leases + page quota on the pool; the pod registry that
      makes the router pick the CXL ring in pod and the fallback link
      across pods (``decode.attach_remote`` with a ``PoolPages`` byref
      argument migrates the KV once through the page-copy kernels).

Two admission planes share the pool and the kernels:

  * the batched plane (``submit``/``step``): requests queue, ``_admit``
    prefills + hands off over ``stub.attach``, ``_decode_batch`` steps
    them;
  * the streaming plane (``decode.generate_stream``): every live stream
    is a ``_StreamSlot`` inside the ``StreamScheduler``; *one* batched
    ``paged_decode_step`` per scheduler tick produces the next token for
    every live stream, and each token goes out on that stream's reply
    chain. Streams admit, retire and cancel mid-batch; admission sheds
    typed ``Overloaded`` (retry-after on the wire) when pages, quota, or
    slots run out (§5.4).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..configs.global_config import global_config
from ..core.channel import RPC, BusyWaitPolicy, ServerLoop
from ..core.errors import AllocationError, ChannelError, Overloaded
from ..core.orchestrator import Orchestrator
from ..core.router import ClusterRouter
from ..core.service import method, service
from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig
from ..models.model import Model
from .kv_pool import POOL_RETRY_AFTER_S, PagedKVPool, PoolConfig
from .paged_model import check_paged_compatible, paged_decode_step, prefill_kv

# the raw fn ids the service methods are pinned to (the reference's wire
# ids, so either package's raw-API clients call the same slots)
FN_ATTACH = 100
FN_ATTACH_REMOTE = 101


@service(name="decode")
class DecodeService:
    """The decode worker's RPC surface: sealed + sandboxed methods that
    adopt a prefilled request by pointer set (§4.5 handoff), driven
    through a stub by *name*."""

    def __init__(self, engine: "ServeEngine"):
        self._engine = engine

    @method(fn_id=FN_ATTACH, sealed=True, sandboxed=True, deadline=30.0)
    def attach(self, ctx, rid, prompt_len, pages):
        """Verify + adopt. Runs sandboxed over the argument scope — every
        block-table dereference is bounds-checked (§4.3). Pending
        handoffs are keyed by ``rid``; a stale or forged handoff raises a
        typed ``ChannelError``, a full active set sheds ``Overloaded``."""
        engine = self._engine
        pages = list(pages.to_python())   # the block table — no KV copied
        rid = int(rid)
        with engine._decode_lock:
            req = engine._pending_attach.pop(rid, None)
            if req is None:
                raise ChannelError(
                    f"attach: no pending handoff for rid {rid}")
            if req.pages != pages or len(req.prompt) != int(prompt_len):
                raise ChannelError(
                    f"attach: rid {rid} handoff mismatch "
                    f"(pages/prompt_len disagree with the prefill record)")
            if len(engine.active) >= engine.max_active:
                # typed shed: the reply's ret word carries retry-after µs
                engine._pending_attach[rid] = req
                engine.shed_admits += 1
                raise Overloaded("decode worker active set is full",
                                 retry_after_s=POOL_RETRY_AFTER_S)
            engine.active.append(req)
        return 0

    @method(fn_id=FN_ATTACH_REMOTE, byref=True, sealed=True,
            sandboxed=True, deadline=30.0)
    def attach_remote(self, ctx, rid, prompt, first_token, max_new, pages):
        """Cross-pod prefill → decode handoff: ``pages`` is a *byref*
        ``PoolPages`` argument the stub resolved before marshalling — in
        pod the raw pointer set, across pods the destination page ids
        after one bulk migration. The request is adopted fully specified
        (prompt, first token, budget), so the remote prefill worker never
        round-trips again."""
        engine = self._engine
        req = Request(int(rid), list(prompt.to_python()), int(max_new),
                      pages=list(pages.to_python()))
        req.out = [int(first_token)]
        req.pos = len(req.prompt)
        with engine._decode_lock:
            # seal for the flight of the generation on the decode side —
            # migrated pages were minted here and never sealed yet
            req.seal_idxs = engine.pool.seal_seq(
                req.pages, holder=engine.client_pid)
            engine.active.append(req)
        return 0

    @method(streaming=True, deadline=120.0)
    def generate_stream(self, ctx, prompt, max_new):
        """Token-streaming decode: each token goes onto the reply chain
        the moment its paged decode step completes. Concurrent calls are
        continuously batched: one ``paged_decode_step`` per scheduler
        tick advances every live stream."""
        return self._engine.generate_tokens(list(prompt.to_python()),
                                            int(max_new))


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    pages: List[int] = field(default_factory=list)
    seal_idxs: List[int] = field(default_factory=list)
    out: List[int] = field(default_factory=list)
    pos: int = 0          # next position to generate
    done: bool = False


class _StreamSlot:
    """One live ``generate_tokens`` stream inside the batched scheduler."""

    __slots__ = ("rid", "max_new", "pages", "seal_idxs", "pos", "cur",
                 "produced", "buf", "released", "admit_step",
                 "first_pop_step")

    def __init__(self, rid: int, max_new: int, pages: List[int],
                 admit_step: int):
        self.rid = rid
        self.max_new = max_new
        self.pages = pages
        self.seal_idxs: List[int] = []
        self.pos = 0          # next position to generate
        self.cur = 0          # last token produced (next step's input)
        self.produced = 0     # tokens generated so far (incl. prefill's)
        self.buf: Deque[int] = deque()   # produced, not yet streamed
        self.released = False
        self.admit_step = admit_step
        self.first_pop_step = -1


class StreamScheduler:
    """Continuous batching for concurrent streaming decodes.

    Admission (prefill + seal + slot creation), batched stepping, and
    release all run under the engine's reentrant ``_decode_lock``. Each
    client generator pulls from its slot's buffer; whoever finds the
    buffer empty runs ONE batched ``paged_decode_step`` over all live
    slots, so every stream advances regardless of which client pumps.
    """

    def __init__(self, engine: "ServeEngine"):
        self.engine = engine
        self.slots: List[_StreamSlot] = []

    # -- admission (sheds typed on pressure) -----------------------------
    def admit(self, prompt: List[int], max_new: int) -> _StreamSlot:
        eng = self.engine
        with eng._decode_lock:
            if len(self.slots) >= eng.max_active:
                eng.shed_admits += 1
                raise Overloaded(
                    f"stream slots full ({eng.max_active} live)",
                    retry_after_s=POOL_RETRY_AFTER_S)
            total = len(prompt) + max_new
            try:
                pages = eng.pool.alloc_seq(total, eng.conn_id)
            except AllocationError as e:
                eng.shed_admits += 1
                raise Overloaded(str(e), retry_after_s=POOL_RETRY_AFTER_S)
            except Overloaded:
                eng.shed_admits += 1
                raise
            slot = _StreamSlot(eng._mint_rid(), max_new, pages,
                               eng.stream_steps)
            try:
                first = eng._prefill_into(prompt, pages)
                # seal for the flight of the generation: the kernel
                # verifies the seal on every dereference (Fig. 8 step 4)
                slot.seal_idxs = eng.pool.seal_seq(
                    pages, holder=eng.client_pid)
            except BaseException:
                eng.pool.free_seq(pages)
                raise
            slot.cur = first
            slot.pos = len(prompt)
            slot.produced = 1
            slot.buf.append(slot.cur)   # TTFT = 0 decode steps
            self.slots.append(slot)
            if len(self.slots) > eng.peak_stream_batch:
                eng.peak_stream_batch = len(self.slots)
            return slot

    # -- the continuous batch tick --------------------------------------
    def step_batch(self) -> int:
        """One batched decode step over every live, unfinished slot.
        Caller must hold the engine lock. Returns the batch size."""
        eng = self.engine
        live = [s for s in self.slots
                if not s.released and s.produced < s.max_new]
        if not live:
            return 0
        B = len(live)
        MAXP = eng.pool.pc.max_pages_per_seq
        # pad the batch to ONE fixed bucket (max_active), as the
        # reference does: padding rows repeat slot 0, so their pool
        # writes land on slot 0's (page, slot) with slot 0's exact values
        # — duplicate but identical — and their logits/oob are sliced off
        Bp = max(B, eng.max_active)
        bt = np.zeros((Bp, MAXP), np.int32)
        pos = np.zeros((Bp,), np.int32)
        toks = np.zeros((Bp,), np.int32)
        for i, s in enumerate(live):
            bt[i, : len(s.pages)] = s.pages
            pos[i] = s.pos
            toks[i] = s.cur
        if Bp > B:
            bt[B:] = bt[0]
            pos[B:] = pos[0]
            toks[B:] = toks[0]

        logits, oob = eng._paged_step(toks, pos, bt)
        eng.decode_steps += 1
        eng.stream_steps += 1
        eng.oob_events += int(oob[:B].sum())
        if B > eng.peak_stream_batch:
            eng.peak_stream_batch = B

        nxt = logits[:B].argmax(-1).cpu().numpy()
        for i, s in enumerate(live):
            s.cur = int(nxt[i])
            s.pos += 1
            s.produced += 1
            s.buf.append(s.cur)
        return B

    # -- per-stream pull -------------------------------------------------
    def next_token(self, slot: _StreamSlot) -> Optional[int]:
        eng = self.engine
        while True:
            with eng._decode_lock:
                if slot.buf:
                    tok = slot.buf.popleft()
                    if slot.first_pop_step < 0:
                        slot.first_pop_step = eng.stream_steps
                        eng.ttft_steps.append(
                            slot.first_pop_step - slot.admit_step)
                    return tok
                if slot.produced >= slot.max_new or slot.released:
                    return None   # retired mid-batch; batch keeps going
                self.step_batch()

    # -- retire / cancel (idempotent) ------------------------------------
    def release(self, slot: _StreamSlot) -> None:
        """Drop a stream from the batch and return its resources, exactly
        once: seals complete + release, pages back to the pool."""
        eng = self.engine
        with eng._decode_lock:
            if slot.released:
                return
            slot.released = True
            if slot in self.slots:
                self.slots.remove(slot)
            if slot.seal_idxs:
                eng.pool.complete_and_release(
                    slot.seal_idxs, eng.client_pid, batched=True)
                eng.pool.seals.flush()
                slot.seal_idxs = []
            eng.pool.free_seq(slot.pages)
            slot.pages = []


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: Model, pool_cfg: PoolConfig,
                 max_active: int = 8, sleep_us: Optional[float] = None,
                 quota_pages: Optional[int] = None, pod: str = "pod0",
                 serve_threaded: bool = False, device: DeviceLike = None):
        check_paged_compatible(cfg)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model

        self.orch = Orchestrator()
        self.client_pid, self.server_pid = 11, 12
        self.conn_id = self.client_pid  # pool pages owned by the client
        if quota_pages is None:
            # default from the central config (None there = unlimited)
            quota_pages = global_config.quota_pages
        if quota_pages is not None:
            # §5.4 page quota: an admit past it sheds typed Overloaded
            self.orch.set_page_quota(self.conn_id, int(quota_pages))
        self.pool = PagedKVPool(self.orch, cfg, pool_cfg, self.client_pid,
                                pod=pod, device=self.device)

        # the handoff endpoint, published through the cluster router:
        # prefill (client) and decode (server) share a pod, so the stub
        # resolves to the zero-copy CXL ring. The channel's heap holds
        # the ring, the argument scopes and the reply graphs — never KV.
        self.router = ClusterRouter(self.orch)
        self.endpoint_name = f"/{pod}/decode"
        self.channel = RPC(self.orch, pid=self.server_pid).open(
            self.endpoint_name, heap_pages=256)
        self.service = DecodeService(self)
        self.channel.serve(self.service)
        # every generate_stream generator pulls from the one shared
        # StreamScheduler: one chunk per stream per pump, so a sweep
        # advances all live streams together — one batched decode step
        # per pass
        self.channel.stream_pump_burst = 1
        self.router.register(self.endpoint_name, self.channel, pod=pod)
        self.stub = self.router.stub(self.endpoint_name, DecodeService,
                                     pid=self.client_pid, pod=pod)
        self.conn = self.stub.connection
        if self.conn.transport != "cxl":
            raise ChannelError(
                "prefill/decode pair must share a pod (got transport "
                f"{self.conn.transport!r}); zero-copy KV handoff needs "
                "the CXL ring")
        # optionally serve the ring from a dedicated ServerLoop thread
        # (the cluster deployment shape) instead of inline on the caller
        self.serve_loop: Optional[ServerLoop] = None
        if serve_threaded:
            self.serve_loop = ServerLoop([self.channel],
                                         BusyWaitPolicy(fixed_sleep_us=5.0))
            self.serve_loop.run_in_thread()

        # §5.8 back-off between idle ticks of ``step``: adaptive, or a
        # fixed ``sleep_us`` (the Fig. 13 sweep)
        self.policy = BusyWaitPolicy(fixed_sleep_us=sleep_us)
        self.queue: List[Request] = []
        self.active: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self.max_active = max_active
        self._next_rid = 1
        # handoffs in flight, keyed by rid (concurrent prefill clients)
        self._pending_attach: Dict[int, Request] = {}
        # one reentrant lock serializes pool/batch state across the
        # batched plane, the stream scheduler and the threaded handlers;
        # it is never held across an RPC
        self._decode_lock = threading.RLock()
        self.scheduler = StreamScheduler(self)
        # metrics
        self.handoff_bytes = 0
        self.decode_steps = 0
        self.oob_events = 0
        self.stream_steps = 0        # batched steps the scheduler ran
        self.peak_stream_batch = 0   # max concurrent streams in one step
        self.ttft_steps: List[int] = []   # per-stream decode-steps to t0
        self.shed_admits = 0         # typed Overloaded sheds (§5.4)

    def _mint_rid(self) -> int:
        with self._decode_lock:
            rid = self._next_rid
            self._next_rid += 1
            return rid

    # -- the two device calls --------------------------------------------------
    def _prefill_into(self, prompt: List[int], pages: List[int]) -> int:
        """Prefill ``prompt``, write its KV into ``pages``; returns the
        first generated token (greedy)."""
        toks = torch.tensor([prompt], dtype=torch.int32, device=self.device)
        logits, k, v = prefill_kv(self.model, toks)
        self.pool.write_prefill(k[:, 0], v[:, 0], pages, len(prompt))
        return int(logits[0].argmax())

    def _paged_step(self, toks: np.ndarray, pos: np.ndarray,
                    bt: np.ndarray):
        """One ``paged_decode_step`` over host-built batch arrays; the
        pool is updated in place. Returns (logits, oob as numpy)."""
        dev = self.device
        pos_t = torch.from_numpy(pos).to(dev)
        logits, _, _, oob = paged_decode_step(
            self.cfg, self.model, torch.from_numpy(toks).to(dev), pos_t,
            torch.from_numpy(bt).to(dev), pos_t + 1, self.pool.k,
            self.pool.v, self.pool.perm_bits(), self.pool.sandbox_desc(),
            self.pool.sandbox_bitmap(self.conn_id))
        return logits, oob.cpu().numpy()

    # -- client-facing API ---------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        rid = self._mint_rid()
        self.queue.append(Request(rid, list(prompt), max_new))
        return rid

    def result(self, rid: int) -> Optional[List[int]]:
        r = self.finished.get(rid)
        return r.out if r else None

    # -- the RPCool handoff ----------------------------------------------------
    def _handoff(self, req: Request) -> None:
        """Prefill side: seal the KV pages, stub-invoke the block table.

        ``stub.attach`` is ``decode.attach`` on the wire: the argument
        tuple (rid, prompt length, page ids) is marshalled once into a
        pooled scope as a ``containers`` graph and travels as a single
        GlobalAddr; the method's options (sealed, sandboxed, 30 s
        deadline) come from the service declaration."""
        # 1. seal the KV pages themselves (pool heap) for the flight;
        # under the lock, as the serving thread seals and flushes the same
        # SealManager, but not across the RPC
        with self._decode_lock:
            req.seal_idxs = self.pool.seal_seq(req.pages,
                                               holder=self.client_pid)
        # 2. the RPC (argument scope sealed too, sandboxed server); with a
        # serving thread the call crosses threads, else it runs inline
        b0 = self.conn.marshal_bytes
        self.stub.attach(req.rid, len(req.prompt), req.pages,
                         timeout=30.0, inline=self.serve_loop is None)
        # the marshalled pointers, never KV bytes
        self.handoff_bytes += self.conn.marshal_bytes - b0

    # -- engine loop --------------------------------------------------------
    def _admit(self) -> int:
        admitted = 0
        while self.queue and len(self.active) < self.max_active:
            req = self.queue.pop(0)
            total = len(req.prompt) + req.max_new
            try:
                req.pages = self.pool.alloc_seq(total, self.conn_id)
            except (AllocationError, Overloaded):
                self.queue.insert(0, req)
                break
            try:
                req.out.append(self._prefill_into(req.prompt, req.pages))
                req.pos = len(req.prompt)
                self._pending_attach[req.rid] = req
                self._handoff(req)
            except Exception:
                # a failed admit must not leak: drop the pending record,
                # release any flight seals, hand the pages back, and reset
                # the request so a retry starts clean
                self._pending_attach.pop(req.rid, None)
                with self._decode_lock:
                    if req.seal_idxs:
                        self.pool.complete_and_release(
                            req.seal_idxs, self.client_pid, batched=True)
                        self.pool.seals.flush()
                        req.seal_idxs = []
                    self.pool.free_seq(req.pages)
                req.pages = []
                req.out = []
                req.pos = 0
                self.queue.insert(0, req)
                break
            admitted += 1
        return admitted

    def _decode_batch(self) -> None:
        with self._decode_lock:
            if not self.active:
                return
            B = len(self.active)
            MAXP = self.pool.pc.max_pages_per_seq
            bt = np.zeros((B, MAXP), np.int32)
            pos = np.zeros((B,), np.int32)
            toks = np.zeros((B,), np.int32)
            for i, r in enumerate(self.active):
                bt[i, : len(r.pages)] = r.pages
                pos[i] = r.pos
                toks[i] = r.out[-1]

            logits, oob = self._paged_step(toks, pos, bt)
            self.decode_steps += 1
            self.oob_events += int(oob.sum())

            nxt = logits.argmax(-1).cpu().numpy()
            still = []
            for i, r in enumerate(self.active):
                r.out.append(int(nxt[i]))
                r.pos += 1
                if len(r.out) >= r.max_new:
                    self._retire(r)
                else:
                    still.append(r)
            self.active = still

    def _retire(self, req: Request) -> None:
        req.done = True
        # release seals (the receiver completed the whole generation)
        self.pool.complete_and_release(req.seal_idxs, self.client_pid,
                                       batched=True)
        self.pool.seals.flush()
        self.pool.free_seq(req.pages)
        self.finished[req.rid] = req

    def step(self) -> bool:
        """One engine tick. Returns True if any work happened; an idle
        tick sleeps what the busy-wait policy prescribes (nothing while
        the engine has been mostly idle, 5-150 µs under load)."""
        self.orch.renew(self.client_pid)   # lease heartbeat
        worked = self._admit() > 0
        if self.active:
            self._decode_batch()
            worked = True
        self.policy.record(worked)
        if not worked:
            self.policy.sleep()
        return worked

    def generate_tokens(self, prompt: List[int], max_new: int = 16):
        """Streaming decode behind ``decode.generate_stream``: prefill
        once, then yield each token as its decode step completes. Concurrent calls share ONE batched
        ``paged_decode_step`` per scheduler tick (continuous batching).
        Admission runs here, eagerly, so it sheds typed ``Overloaded``
        at the call; the generator's ``finally`` releases seals + pages
        exactly once on exhaustion, cancel (``close()``), or disconnect."""
        if max_new <= 0:
            return iter(())
        slot = self.scheduler.admit(list(prompt), int(max_new))
        return self._drain_slot(slot)

    def _drain_slot(self, slot):
        try:
            while True:
                tok = self.scheduler.next_token(slot)
                if tok is None:
                    return
                yield tok
        finally:
            self.scheduler.release(slot)

    def run_until_drained(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while self.queue or self.active:
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain")
            self.step()

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the serving thread (if any) and join it; idempotent.
        Raises if the thread is still alive after ``timeout``."""
        loop, self.serve_loop = self.serve_loop, None
        if loop is not None:
            thread = loop._thread
            loop.stop(timeout=timeout)
            if thread is not None and thread.is_alive():
                raise ChannelError("serving thread did not stop")
