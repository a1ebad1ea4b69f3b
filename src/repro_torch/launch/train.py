"""End-to-end training CLI.

The counterpart of ``src/repro/launch/train.py``, with the same flags,
model and printed lines. It trains a small OLMo-family model
(``small_lm_config``: olmo-1b's family at ``--d-model`` / ``--layers``)
on the synthetic packed corpus: AdamW with fp32 moments, remat,
gradient accumulation, a prefetching data loader with straggler skip,
and checkpoint/restart (async saves every ``--ckpt-every`` steps; with
``--resume`` the latest checkpoint's parameters, optimizer state and
data position are restored, and the run continues the same token stream
to the same parameters, bitwise). A checkpoint's data state is the
position after the batches the saved parameters have seen.

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path:

    PYTHONPATH=src python -m repro_torch.launch.train --steps 200 --d-model 768 --layers 12
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 \\
        --d-model 128 --layers 2 --seq 64

``main(argv)`` parses ``argv`` (``None``: the command line) and returns
``{"model", "opt_state", "start", "losses", "stragglers_skipped"}``, so a
caller can run it in-process and compare runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model
from ..training import (AdamWConfig, Checkpointer, DataConfig, PrefetchLoader,
                        SyntheticPackedDataset, init_opt_state, make_train_step)


def small_lm_config(d_model: int, layers: int, vocab: int = 32000):
    base = get_config("olmo-1b")
    return dataclasses.replace(
        base, name=f"olmo-{d_model}x{layers}", num_layers=layers,
        d_model=d_model, num_heads=max(4, d_model // 128),
        num_kv_heads=max(4, d_model // 128), head_dim=128,
        d_ff=4 * d_model, vocab_size=vocab)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = small_lm_config(args.d_model, args.layers)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), device)
    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=0)
    dataset = SyntheticPackedDataset(dc)
    ck = Checkpointer(args.ckpt_dir, keep_last=2)

    start = 0
    if args.resume and ck.latest_step() is not None:
        start, restored, extras = ck.restore(device=device)
        model.load_state(restored["params"])
        opt_state = restored["opt"]
        dataset.restore(extras["data"])
        print(f"resumed from step {start}")
    else:
        opt_state = init_opt_state(model.params())

    # the stream starts at the batch of step ``start`` (one a step), set
    # before the loader's thread starts reading the position: the
    # reference sets it after, so its thread may already have built
    # batches at another position (ROADMAP Queue 3 entry 15)
    dataset.step = start
    loader = PrefetchLoader(dataset, depth=2, deadline_s=30.0)

    def data_state(consumed: int):
        """The position after ``consumed`` batches (the dataset's own
        ``step`` runs ahead by what the loader has prefetched)."""
        return {"seed": dc.seed, "step": consumed}

    tok_per_step = args.batch * args.seq
    losses = []
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            batch = loader.next()
            opt_state, metrics = step_fn(opt_state, batch)
            losses.append(metrics["loss"])
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                dt = time.time() - t_start
                tps = tok_per_step * (step - start + 1) / max(dt, 1e-9)
                print(f"step {step:5d}  loss {loss:7.4f}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"gnorm {float(metrics['grad_norm']):7.3f}  "
                      f"{tps:,.0f} tok/s", flush=True)
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ck.save_async(step + 1, {"params": model.params(), "opt": opt_state},
                              extras={"data": data_state(step + 1)})
        ck.wait()
        ck.save(args.steps, {"params": model.params(), "opt": opt_state},
                extras={"data": data_state(args.steps)})
        print(f"done; stragglers skipped: {loader.stragglers_skipped}")
    finally:
        loader.close()
    return {"model": model, "opt_state": opt_state, "start": start,
            "losses": [float(v) for v in losses],
            "stragglers_skipped": loader.stragglers_skipped}


if __name__ == "__main__":
    main()
