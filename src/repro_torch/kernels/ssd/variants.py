"""Time and check variants of the bf16 SSD intra-chunk kernel on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd.variants

Each variant is ``csrc/ssd.cu`` with a few text substitutions that change
one choice of the tensor-core bf16 kernel; ``landed`` is the file as it
is: 4 or 16 heads a block instead of 8 (C·Bᵀ is built once a block, so
fewer heads build it more often), one bf16 term of M in M·x or of
Bᵀ·diag(w) in the states instead of two, 4 warps a block instead of 8,
a states warp building one 16-row tile of N at a time instead of two,
and ``cuda_cores``, the CUDA-core kernel that serves fp32, run on bf16
(the kernel before the redesign). The ``diag_`` variants leave work out to show where the
time goes, so they give wrong outputs and are only timed: no stores of y
and states, no y warps, no states warps, and no head loop (the block's
loads, scan and C·Bᵀ alone). Every variant is built by its own ``nvcc`` (all started
together) into ``build/k4_variants/`` at the root of the checkout and
launched through ``ssd_intra_chunk_cuda``. Each is held against
``ssd_intra_chunk_ref`` at ``chip_smoke.py``'s phase 8 tolerance, at the
slice shape with chunk decays past 88 and at phase 8's ragged bf16 cases,
and timed (CUDA events, L2 flushed, median) at phase 11's shape, all
variants in turn, twice. Prints one line per variant, per case and per
round and writes ``chiprun_out/k4_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.kernel import bf16_blocks_per_sm, ssd_intra_chunk_cuda

ROOT = build.BUILD_ROOT.parents[1]   # the checkout: chip_smoke.py lives there

# name → [(text in ssd.cu, its replacement), ...]
VARIANTS = {
    "landed": [],
    "heads_4": [("constexpr int kHeads = 8;", "constexpr int kHeads = 4;")],
    "heads_16": [("constexpr int kHeads = 8;", "constexpr int kHeads = 16;")],
    "one_term_m": [("constexpr int kMTerms = 2;", "constexpr int kMTerms = 1;")],
    "one_term_w": [("constexpr int kWTerms = 2;", "constexpr int kWTerms = 1;")],
    "warps_4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "state_tiles_1": [("constexpr int kStateTiles = 2;", "constexpr int kStateTiles = 1;")],
    "cuda_cores": [("if (dtype == 1) return tc::launch(",
                    "if (dtype == 1) return cc::launch<__nv_bfloat16>(")],
}
_STORE2 = ("__device__ __forceinline__ void store2(float* __restrict__ out, int p, int P, "
           "float v0,\n                                       float v1) {\n")
_NO_Y = ("for (int pair = warp; pair < kStrips / 2; pair += kYWarps)",
         "for (int pair = kStrips; pair < kStrips / 2; pair += kYWarps)")
_NO_STATES = ("for (int mt0 = (warp - kYWarps) * kT; mt0 < nn;", "for (int mt0 = nn; mt0 < nn;")
DIAGNOSTICS = {
    "diag_no_stores": [(_STORE2, _STORE2 + "  if (P >= 0) return;\n")],
    "diag_no_y": [_NO_Y],
    "diag_no_states": [_NO_STATES],
    "diag_no_y_no_states": [_NO_Y, _NO_STATES],
    "diag_no_heads": [("for (int hh = 0; hh < nh; ++hh) {", "for (int hh = 0; hh < 0; ++hh) {")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version stays fp32
    card = cs.card_line()
    print(card, flush=True)
    built = build.build_variants("ssd.cu", {**VARIANTS, **DIAGNOSTICS}, "k4_variants",
                                 "ssd_intra_chunk_launch")
    libs = {n: lib for n, (lib, _) in built.items() if lib is not None}
    checked = {n: lib for n, lib in libs.items() if n in VARIANTS}
    result = {"card": card, "ptxas": {}, "blocks_per_sm": {}, "cases": {}, "times": {}}
    for name, (lib, log_) in built.items():
        if lib is None:
            print(f"{name}: BUILD FAILED {log_[-3000:]}", flush=True)
            continue
        fn = lib.ssd_intra_chunk_bf16_blocks_per_sm
        fn.argtypes, fn.restype = build.SIGNATURES[fn.__name__], ctypes.c_int
        result["ptxas"][name] = cs.ptxas_report([log_])
        result["blocks_per_sm"][name] = bf16_blocks_per_sm(lib)
        print(f"{name}: ptxas {result['ptxas'][name]}, tensor-core kernel blocks an SM "
              f"{result['blocks_per_sm'][name]}", flush=True)

    gen = torch.Generator("cuda").manual_seed(1)
    sh = cs.SSD_SHAPE
    B, S, H, P, N, Q = (sh[k] for k in "BSHPNQ")
    cases = {"slice": (cs.ssd_inputs(gen, B, S, H, P, N, torch.bfloat16), Q)}
    for S_, chunk, H_, P_, N_ in cs.K4_BF16_CASES:
        cases[f"S{S_} Q{min(chunk, S_)} H{H_} P{P_} N{N_}"] = (
            cs.ssd_inputs(gen, 2, S_, H_, P_, N_, torch.bfloat16), chunk)
    for key, (args, chunk) in cases.items():
        want = ssd_intra_chunk_ref(*args, chunk)
        row = {}
        for name, lib in checked.items():
            got = ssd_intra_chunk_cuda(*args, chunk, lib=lib)
            ok = all(bool(torch.isfinite(g).all()) and cs.scaled_close(g, w)
                     for g, w in zip(got, want))
            row[name] = {"max_abs_err": max((g - w).abs().max().item()
                                            for g, w in zip(got, want)), "ok": ok}
        result["cases"][key] = row
        print(f"case {key} (max |ref| {max(w.abs().max().item() for w in want):.3e}): "
              + "; ".join(f"{n} {r['max_abs_err']:.2e} {'ok' if r['ok'] else 'MISS'}"
                          for n, r in row.items()), flush=True)

    timer = cs.Timer()
    args = cases["slice"][0]
    runs = {n: [] for n in libs}
    for rnd in range(2):
        for name, lib in libs.items():
            runs[name].append(timer.ms(lambda: ssd_intra_chunk_cuda(*args, Q, lib=lib)))
        print(f"time round {rnd + 1} (ms, B={B} S={S} H={H} P={P} N={N} Q={Q} bf16): "
              + "; ".join(f"{n} {ts[-1]:.5f}" for n, ts in runs.items()), flush=True)
    result["times"] = runs

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k4_variants.json").write_text(json.dumps(result, indent=1))
    missed = [k for k, row in result["cases"].items() if not row.get("landed", {}).get("ok")]
    if missed:
        print(f"the landed kernel misses at {missed}", flush=True)
    return 1 if missed or len(libs) < len(VARIANTS) + len(DIAGNOSTICS) else 0


if __name__ == "__main__":
    sys.exit(main())
