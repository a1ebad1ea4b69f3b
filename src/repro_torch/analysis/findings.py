"""Structured sanitizer findings.

Every ShmCheck diagnostic is a `Finding`: a stable rule id, a
human-readable message, the heap space / page it anchors to, and the
stack of the *triggering* access (frames inside the analysis package are
elided — the top frame is the caller that performed the bad access).
Findings are deduplicated by (rule, space, site) so a hot loop that
trips the same bug a million times reports it once.
"""

from __future__ import annotations

import traceback
from dataclasses import dataclass, field
from typing import Tuple

# Rule table (mirrored in README "Correctness tooling").
RULES = {
    "SHM101": "unsynchronized racy access to a shared heap extent "
              "(no happens-before edge between the two accesses)",
    "SHM102": "TOCTOU (§4.5): receiver dereference races a sender write "
              "on an unsealed sender-writable extent",
    "SHM103": "use-after-free: access through a destroyed, recycled or "
              "pool-held scope",
    "SHM104": "leak-at-close: live scope pages still allocated when "
              "their connection closed",
    "SHM105": "double seal release",
    "SHM106": "seal leak: pages still write-protected (or release still "
              "queued, never flushed) at connection close",
    "SHM107": "wild-pointer dereference by an unsandboxed handler",
    "SHM108": "stale sandbox: cached key re-entered after its pages were "
              "freed or recycled",
}

# this package's own frames (the reference package elides its own)
_ANALYSIS_DIR = "/repro_torch/analysis/"


def capture_stack(limit: int = 12) -> Tuple[str, ...]:
    """Formatted frames of the triggering access, innermost last,
    with analysis-internal frames elided."""
    out = []
    for fr in traceback.extract_stack():
        fname = fr.filename.replace("\\", "/")
        if _ANALYSIS_DIR in fname:
            continue
        out.append(f"{fr.filename}:{fr.lineno} in {fr.name}")
    return tuple(out[-limit:])


@dataclass(frozen=True)
class Finding:
    rule: str
    message: str
    space: int = -1
    page: int = -1
    stack: Tuple[str, ...] = field(default=())

    @property
    def site(self) -> str:
        """The innermost non-analysis frame — the dedup anchor."""
        return self.stack[-1] if self.stack else "<unknown>"

    def dedup_key(self) -> Tuple[str, int, str]:
        return (self.rule, self.space, self.site)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "title": RULES.get(self.rule, ""),
            "message": self.message,
            "space": self.space,
            "page": self.page,
            "stack": list(self.stack),
        }

    def __str__(self) -> str:
        loc = f" space={self.space}" if self.space >= 0 else ""
        if self.page >= 0:
            loc += f" page={self.page}"
        head = f"{self.rule}{loc}: {self.message}"
        if not self.stack:
            return head
        frames = "\n".join(f"    at {f}" for f in reversed(self.stack))
        return f"{head}\n{frames}"
