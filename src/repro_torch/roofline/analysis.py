"""Three-term roofline from the dry-run's records (NVIDIA H100 SXM5 80 GB).

The counterpart of ``src/repro/roofline/analysis.py``, with the H100's
rates in place of the TPU's:

  compute    = FLOPs_per_device / peak FLOP/s        (989 TFLOP/s dense bf16)
  memory     = bytes_per_device / HBM rate           (3.35 TB/s HBM3)
  collective = collective_bytes_per_device / link    (see below)

Rates: NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB column (dense
bf16 tensor-core peak without sparsity; HBM3 bandwidth; fourth-generation
NVLink 900 GB/s a GPU in both directions, 450 GB/s each way) and the
ConnectX-7 InfiniBand NDR adapter of an HGX H100 node, one 400 Gb/s
port a GPU (50 GB/s each way).

**The link of the collective term.** The reference prices a pod's
collectives at one TPU interconnect rate and the pod axis at a slower
one. An H100 pod has no single counterpart: NVLink joins the 8 GPUs of a
node, InfiniBand the nodes. A (16, 16) pod of 256 cards spans 32 nodes
of 8, so each of its axes crosses nodes (the model axis of 16 spans two
nodes, the data axis 16): a ring over either axis is paced by its
InfiniBand hops, and the pod axis of the (2, 16, 16) multipod mesh crosses
between pods on the same adapters. Both production meshes therefore use
the InfiniBand rate a GPU; a record of at most 8 devices (one node) uses
NVLink's. The dry-run's collective bytes are not split by axis, so this
prices every byte at the slower link the mesh's collectives must cross.

The dry-run (``launch/dryrun.py``) records per-device FLOPs of the local
operators, the bytes they read and write unfused, and the bytes of each
collective's local input.

MODEL_FLOPS (6·N·D dense / 6·N_active·D MoE for train; 2·N_active·tokens
for inference) anchors the "useful ratio": how much of the traced compute
is the model itself against remat and dispatch overhead.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

PEAK_FLOPS = 989e12      # dense bf16 / GPU (H100 SXM5 data sheet)
HBM_BW = 3.35e12         # bytes/s / GPU, HBM3 (H100 SXM5 data sheet)
NVLINK_BW = 450e9        # bytes/s / GPU each way, NVLink 4 (900 GB/s both ways)
IB_BW = 50e9             # bytes/s / GPU each way, InfiniBand NDR 400 Gb/s
GPUS_PER_NODE = 8        # an HGX H100 node: the NVLink domain


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    step_s: float
    mfu: float
    raw: Dict[str, Any]

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.compute_s:.2e} | "
                f"{self.memory_s:.2e} | {self.collective_s:.2e} | "
                f"**{self.bottleneck}** | {self.useful_ratio:.2f} | "
                f"{self.mfu*100:.1f}% |")


def model_flops(rec: Dict[str, Any]) -> float:
    """Per-DEVICE useful model FLOPs for the cell."""
    from ..models.config import SHAPES

    n_active = rec["active_params"]
    devices = rec["devices"]
    mode = rec["mode"]
    # tokens processed per step
    shape = SHAPES[rec["shape"]]
    if mode == "train":
        toks = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * toks
    elif mode == "prefill":
        toks = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * toks
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / devices


def link_bw(rec: Dict[str, Any]) -> float:
    """The link rate of a record's collective term (module docstring)."""
    return NVLINK_BW if rec["devices"] <= GPUS_PER_NODE else IB_BW


def analyze(rec: Dict[str, Any]) -> Optional[Roofline]:
    if rec.get("skipped") or "error" in rec:
        return None
    flops = rec.get("flops") or 0.0
    byts = rec.get("bytes_accessed") or 0.0
    coll = rec.get("collectives", {})
    coll_bytes = sum(v for k, v in coll.items() if k != "count")

    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = coll_bytes / link_bw(rec)

    mf = model_flops(rec)
    useful = mf / flops if flops else 0.0
    step = max(compute_s, memory_s, collective_s)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mfu = (mf / step) / PEAK_FLOPS if step > 0 else 0.0
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mf, hlo_flops=flops,
        useful_ratio=useful, step_s=step, mfu=mfu, raw=rec)


def load_all(artifact_dir: str, mesh: str = "pod",
             prefer_cost: bool = True) -> List[Roofline]:
    """Merge: FLOPs/bytes/collectives from the ``--costing`` pass where
    one exists, memory fields from the plain pass."""
    out = []
    for path in sorted(glob.glob(
            os.path.join(artifact_dir, mesh, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if prefer_cost:
            cpath = os.path.join(artifact_dir, f"{mesh}_cost",
                                 os.path.basename(path))
            if os.path.exists(cpath):
                with open(cpath) as f:
                    crec = json.load(f)
                if "error" not in crec and not crec.get("skipped"):
                    for k in ("flops", "bytes_accessed", "collectives",
                              "transcendentals"):
                        if k in crec:
                            rec[k] = crec[k]
        r = analyze(rec)
        if r:
            out.append(r)
    return out


def table(rows: List[Roofline]) -> str:
    hdr = ("| arch | shape | compute (s) | memory (s) | collective (s) | "
           "bottleneck | useful | MFU bound |\n"
           "|---|---|---|---|---|---|---|---|")
    return "\n".join([hdr] + [r.row() for r in rows])


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"))
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    rows = load_all(args.dir, args.mesh)
    print(table(rows))


if __name__ == "__main__":
    main()
