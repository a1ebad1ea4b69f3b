"""Dispatching wrapper for sandboxed paged decode attention.

The device of ``q`` decides: a CPU tensor takes the plain PyTorch
version, and so does a ``meta`` tensor (shapes only: the dry-run's
costing, ``launch/dryrun.py``); a CUDA tensor launches the CUDA kernel
or raises. There is no
fallback and no option that runs the plain version on the card.
``paged_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

from .kernel import paged_attention_cuda
from .ref import paged_attention_ref


def paged_attention(q, k_pool, v_pool, block_tab, seq_lens, perm_bits,
                    sandbox, bitmap):
    """RPCool-sandboxed paged decode attention.

    q: (B, Hq, D); k/v_pool: (P, T, Hkv, D); block_tab: (B, MAXP) int32;
    seq_lens: (B,) int32; perm_bits/bitmap: (P,) int32; sandbox: (3,)
    int32 [lo, hi, enforce]. Returns (out (B, Hq, D), oob (B,) int32),
    where oob counts sandbox-violating page dereferences (≠0 ⇒ the RPC
    must be failed with E_SANDBOX, per §4.4).
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tab, seq_lens,
                                   perm_bits, sandbox, bitmap)
    if q.device.type == "meta":    # no data to run a kernel on: the plain version's shapes
        return paged_attention_ref(q, k_pool, v_pool, block_tab, seq_lens,
                                   perm_bits, sandbox, bitmap)
    result = paged_attention_cuda(q, k_pool, v_pool, block_tab, seq_lens,
                                  perm_bits, sandbox, bitmap)
    paged_attention.launches += 1
    return result


paged_attention.launches = 0
