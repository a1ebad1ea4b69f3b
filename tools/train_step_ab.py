#!/usr/bin/env python3
"""olmo-1b's training step on one card, timed from several source trees
of the PyTorch port in one call, in the order given, so that two
versions are compared on the same card under the same power limit:

    python tools/train_step_ab.py --out chiprun_out/ab build/parent . . build/parent

Each tree runs in a process of its own with that tree's ``src`` first on
``sys.path``, and trains as ``chip_smoke.py``'s phase 33 does: olmo-1b
at full width and depth, random weights from seed 0, bf16 with fp32
AdamW state, ``make_train_step`` (remat on) for 20 steps on one 8 x 512
batch of the synthetic packed corpus. The step time is the median of
steps 3-20 on the host clock (each step synced by reading its loss).
Then two more steps under ``torch.profiler`` through this tree's
``chip_smoke.profile_steps``: wall, device busy time, idle share,
launches, and the device time of the kernels whose names hold
``flash_prefill`` and ``flash_prefill_bwd``. Each run writes
``<out>_<i>_<label>.json`` and prints one line; the script exits
non-zero if a run failed. Needs a CUDA card and ``nvcc``: each tree
builds its own kernels under its ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS, B, S = 20, 8, 512


def one(tree: Path, out: Path) -> None:
    """Train and profile olmo-1b with the port under ``tree/src``."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_prefill import kernel as k3
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    if Path(repro_torch.__file__).resolve().parents[1] != (tree / "src").resolve():
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {tree}/src")
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py sets it
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    cfg = get_config("olmo_1b")
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    model.trainable()
    batch = chip_smoke.train_batch(cfg, B, S)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS))
    state = init_opt_state(model.params())
    bwd = getattr(k3, "flash_prefill_bwd_cuda", None)   # None in a tree without it
    k3.flash_prefill_cuda.launches = 0
    if bwd is not None:
        bwd.launches = 0
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # syncs
        step_ms.append(1e3 * (time.perf_counter() - t0))
    calls = {"flash_prefill": k3.flash_prefill_cuda.launches,
             "flash_prefill_bwd": None if bwd is None else bwd.launches}
    prof = chip_smoke.profile_steps(lambda: step(state, batch), model.device, steps=2,
                                    watch=("flash_prefill", "flash_prefill_bwd"))
    info = {"card": card, "tree": str(tree), "B": B, "S": S, "steps": STEPS,
            "losses": losses, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[2:])),
            "wrapper_calls": calls, "profile": prof}
    out.write_text(json.dumps(info, indent=1))
    print(f"{tree}: olmo-1b step {info['step_ms_median']:.1f} ms (median of steps "
          f"3-{STEPS}), loss {losses[0]:.4f} -> {losses[-1]:.4f}, wrapper calls {calls}; "
          f"{chip_smoke.profile_line(prof)}; flash_prefill "
          f"{prof['watch_ms_per_step']['flash_prefill']:.2f} ms, flash_prefill_bwd "
          f"{prof['watch_ms_per_step']['flash_prefill_bwd']:.2f} ms a step; {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path, help="source trees, run in this order")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "train_step_ab")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)   # a child's tree
    ap.add_argument("--json", type=Path, help=argparse.SUPPRESS)  # ... and its output
    args = ap.parse_args()
    if args.one is not None:
        one(args.one.resolve(), args.json)
        return 0
    if not args.trees:
        ap.error("give at least one source tree")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    rcs = []
    for i, tree in enumerate(args.trees, 1):
        label = tree.resolve().name or "root"
        out = args.out.parent / f"{args.out.name}_{i}_{label}.json"
        rc = subprocess.run([sys.executable, __file__, "--one", str(tree.resolve()),
                             "--json", str(out)], env=env).returncode
        print(f"run {i} {tree} rc {rc}", flush=True)
        rcs.append(rc)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
