"""RPCool error taxonomy (the subset the serving slice raises).

* ``SealViolation``   — receiver proceeds on an unsealed region or the
                        sender releases an incomplete RPC (Fig. 8 step 8).
* ``InvalidPointer``  — wild/invalid page reference (freed page, double free).
* ``ChannelError``    — handoff protocol misuse (unknown or mismatched rid).
* ``Overloaded``      — admission control shed the request (§5.4); carries
                        the suggested ``retry_after_s`` back-off.
* ``AllocationError`` — the heap has no free extent large enough.
"""


class RPCoolError(Exception):
    """Base class for all RPCool errors."""


class SealViolation(RPCoolError):
    pass


class InvalidPointer(RPCoolError):
    pass


class ChannelError(RPCoolError):
    pass


class Overloaded(ChannelError):
    """Admission control turned the request away (§5.4). Carries the
    suggested ``retry_after_s`` back-off; retry layers honor it as a
    floor on their next pause."""

    def __init__(self, msg: str = "overloaded",
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class AllocationError(RPCoolError):
    pass
