"""RPCool error taxonomy (the subset the serving slice and its RPC plane
raise; the reference's class names and meanings).

* ``SealedPageError``  — sender writes an in-flight (sealed) page (§4.5).
* ``SealViolation``    — receiver proceeds on an unsealed region or the
                         sender releases an incomplete RPC (Fig. 8 step 8).
* ``SandboxViolation`` — dereference outside the sandbox; the SIGSEGV that
                         librpcool converts into an RPC error (§5.2).
* ``InvalidPointer``   — wild/invalid GlobalAddr (bad heap, freed page).
* ``QuotaExceeded``    — mapping a heap past the administrator quota (§5.4).
* ``LeaseExpired``     — operating on a heap whose lease lapsed (§4.6).
* ``ChannelError``     — connection/channel protocol misuse.
* ``DeadlineExceeded`` — an RPC's propagated deadline lapsed.
* ``WaitTimeout``      — a client wait lapsed before the reply landed.
* ``Overloaded``       — admission control shed the request (§5.4); carries
                         the suggested ``retry_after_s`` back-off.
* ``OwnershipMiss``    — fallback-transport access to a page this node does
                         not currently own (§5.6 page-fault analogue).
* ``AllocationError``  — the heap has no free extent large enough.

On the wire a failed RPC is a status word (``channel.E_*``); the client
maps ``E_DEADLINE`` back to ``DeadlineExceeded`` and ``E_OVERLOAD`` to
``Overloaded`` with the retry-after the reply's ret word carries.
"""


class RPCoolError(Exception):
    """Base class for all RPCool errors."""


class SealedPageError(RPCoolError):
    pass


class SealViolation(RPCoolError):
    pass


class SandboxViolation(RPCoolError):
    pass


class InvalidPointer(RPCoolError):
    pass


class QuotaExceeded(RPCoolError):
    pass


class LeaseExpired(RPCoolError):
    pass


class ChannelError(RPCoolError):
    pass


class DeadlineExceeded(ChannelError):
    """An RPC's propagated deadline lapsed: the server found it expired
    (E_DEADLINE reply, the handler never runs) or a handler raised past
    the budget. Not retryable: the budget is gone."""


class WaitTimeout(ChannelError):
    """A client-side wait lapsed before the reply landed: the RPC may
    still complete server-side. Retryable, unlike ``DeadlineExceeded``."""


class Overloaded(ChannelError):
    """Admission control turned the request away (§5.4). Carries the
    suggested ``retry_after_s`` back-off; retry layers honor it as a
    floor on their next pause."""

    def __init__(self, msg: str = "overloaded",
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class OwnershipMiss(RPCoolError):
    def __init__(self, page: int, msg: str = ""):
        super().__init__(msg or f"page {page} not owned by this node")
        self.page = page


class AllocationError(RPCoolError):
    pass
