"""End-to-end serving CLI: continuous batching over the RPCool pool.

The counterpart of ``src/repro/launch/serve.py``, with the same flags,
demo configuration and printed lines. It serves a small GQA LM (yi-9b's
family at ``--d-model`` / ``--layers``) with batched requests through the
full RPCool path: pool pages leased from the orchestrator, the prefill →
decode handoff as a sealed zero-copy RPC over the shared-memory ring,
sandboxed paged-attention decode, and the §5.8 busy-wait back-off
(adaptive, or fixed by ``--sleep-us``).

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --max-new 12
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``main(argv)`` parses ``argv`` (``None``: the command line) and returns
the drained engine, so a caller can run it in-process and read its
counters.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..serving import PoolConfig, ServeEngine


def main(argv: Optional[List[str]] = None) -> ServeEngine:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-active", type=int, default=8)
    ap.add_argument("--pool-pages", type=int, default=256)
    ap.add_argument("--sleep-us", type=float, default=None,
                    help="fixed busy-wait sleep (default: §5.8 adaptive)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("yi-9b"), name="serve-demo", num_layers=args.layers,
        d_model=args.d_model, num_heads=max(4, args.d_model // 64),
        num_kv_heads=max(2, args.d_model // 128), head_dim=64,
        d_ff=4 * args.d_model, vocab_size=8192)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    print(f"serving {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    eng = ServeEngine(
        cfg, model,
        PoolConfig(num_pages=args.pool_pages, page_tokens=16,
                   max_pages_per_seq=16),
        max_active=args.max_active, sleep_us=args.sleep_us, device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = []
    for _ in range(args.requests):
        prompt = list(rng.integers(1, cfg.vocab_size,
                                   size=int(rng.integers(4, 24))))
        rids.append(eng.submit(prompt, max_new=args.max_new))
    eng.run_until_drained()
    dt = time.time() - t0

    total_tokens = sum(len(eng.result(r)) for r in rids)
    print(f"{len(rids)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s)")
    print(f"decode steps: {eng.decode_steps}  "
          f"handoff bytes (pointers only): {eng.handoff_bytes}  "
          f"sandbox violations: {eng.oob_events}")
    print(f"pool: {eng.pool.stats()}")
    for r in rids[:4]:
        print(f"  req {r}: {eng.result(r)}")
    return eng


if __name__ == "__main__":
    main()
