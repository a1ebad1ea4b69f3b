"""Where one launch of the bf16 paged-attention kernel spends its time, on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.paged_attention.timeline

Builds ``csrc/paged_attention.cu`` with text substitutions that make
thread 0 of every block write ``%globaltimer`` at the kernel's phase
boundaries into a device array, at the cluster size the kernel picks and
fixed at 1 and 8 blocks a sequence. Each is launched at phase 7's shape
(``chip_smoke.py``) after an L2 flush, four times; for the last launch it
prints each stamp's min / median / max over blocks in µs after the first
block started, and writes ``chiprun_out/k1_timeline.json``. The stamps
are thread 0's, so "pages checked" and "first tile landed" are warp 0's;
writing them costs a few instructions a block.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import variants
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda

ROOT = build.BUILD_ROOT.parents[1]   # the checkout: chip_smoke.py lives there
MAX_BLOCKS = 1 << 16
STAMPS = ("start", "pages checked", "first tile landed", "tiles done", "warps merged",
          "block merged", "cluster barrier passed", "out written")

_DEFS = ("#include <stdint.h>\n", """#include <stdint.h>
__device__ unsigned long long g_stamps[65536][8];
#define STAMP(k)                                                                    \\
  do {                                                                              \\
    if (threadIdx.x == 0) {                                                         \\
      unsigned long long t_;                                                        \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                        \\
      g_stamps[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x][k] = t_; \\
    }                                                                               \\
  } while (0)
""")
# (text in paged_attention.cu, the same text with a stamp)
_STAMPED = [
    _DEFS,
    ("  const uint32_t ring_s = smem_addr(ring);\n",
     "  const uint32_t ring_s = smem_addr(ring);\n  STAMP(0);\n"),
    ("    n_oob += __popc(__ballot_sync(0xffffffffu, in_use) & ~todo);\n",
     "    n_oob += __popc(__ballot_sync(0xffffffffu, in_use) & ~todo);\n"
     "    if (base == 0) STAMP(1);\n"),
    ("      __syncwarp();         // ... and every lane's\n",
     "      __syncwarp();         // ... and every lane's\n"
     "      if (base == 0 && st == 0) STAMP(2);\n"),
    ("  cp_async_wait<0>();\n\n", "  cp_async_wait<0>();\n  STAMP(3);\n\n"),
    ("  if (lane == 0) warp_oob[warp] = n_oob;\n  __syncthreads();\n",
     "  if (lane == 0) warp_oob[warp] = n_oob;\n  __syncthreads();\n  STAMP(4);\n"),
    ("  cluster.sync();   // release the blocks' states to the cluster\n",
     "  STAMP(5);\n  cluster.sync();   // release the blocks' states to the cluster\n"
     "  STAMP(6);\n"),
    ("  // peers' shared memory stays alive until it has been read",
     "  STAMP(7);\n  // peers' shared memory stays alive until it has been read"),
    ('extern "C" const char* repro_cuda_error_string(int code) {',
     'extern "C" int k1_stamps(void* dst, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n\n'
     'extern "C" const char* repro_cuda_error_string(int code) {'),
]
VARIANTS = {
    "landed": _STAMPED,
    "cluster_1": _STAMPED + variants.VARIANTS["cluster_1"],
    "cluster_8": _STAMPED + variants.VARIANTS["cluster_8"],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("timeline: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config

    card = cs.card_line()
    print(card, flush=True)
    built = build.build_variants("paged_attention.cu", VARIANTS, "k1_timeline",
                                 "paged_attention_launch")
    gen = torch.Generator("cuda").manual_seed(1)
    main_lens = [len(p) + cs.MAX_NEW for p in
                 cs.make_prompts(np.random.default_rng(0), 8, get_config("yi_9b").vocab_size)]
    args = cs.k1_inputs(gen, lens=main_lens)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    result = {"card": card, "lengths": main_lens, "us_after_first_start": {}}
    for name, (lib, log_) in built.items():
        if lib is None:
            print(f"{name}: BUILD FAILED {log_[-3000:]}", flush=True)
            return 1
        lib.k1_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.k1_stamps.restype = ctypes.c_int
        for _ in range(4):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            paged_attention_cuda(*args, lib=lib)
        torch.cuda.synchronize()
        stamps = np.zeros((MAX_BLOCKS, len(STAMPS)), np.uint64)
        if lib.k1_stamps(stamps.ctypes.data, stamps.nbytes):
            raise RuntimeError("k1_stamps: cudaMemcpyFromSymbol failed")
        ran = stamps[stamps[:, 0] > 0].astype(np.int64)
        us = (ran - ran[:, 0].min()) / 1e3
        rows = {s: [float(us[:, k].min()), float(np.median(us[:, k])), float(us[:, k].max())]
                for k, s in enumerate(STAMPS)}
        result["us_after_first_start"][name] = {"blocks": len(ran), **rows}
        print(f"{name} ({len(ran)} blocks; µs after the first block started, min / median "
              "/ max over blocks):", flush=True)
        for s, (lo, med, hi) in rows.items():
            print(f"   {s:24s} {lo:8.3f} {med:8.3f} {hi:8.3f}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k1_timeline.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
