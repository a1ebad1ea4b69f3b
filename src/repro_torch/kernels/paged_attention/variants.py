"""Time and check variants of the bf16 paged-attention kernel on the card.

    PYTHONPATH=src python -m repro_torch.kernels.paged_attention.variants

Each variant is ``csrc/paged_attention.cu`` with a few text substitutions
that change one choice of the kernel; ``landed`` is the file as it is:
the cluster size fixed at 1, 2, 4 or 8 blocks a sequence (the landed
kernel picks it from the SM count), one bf16 term of P in P·V instead of
two, and 2 or 8 warps a block instead of 4. Every variant is built by its
own ``nvcc`` (all started together) into ``build/k1_variants/`` at the
root of the checkout and launched through ``paged_attention_cuda``. Each
is held against the plain version at ``chip_smoke.py``'s phase 2 bf16
cases plus rows of 1-17 tokens, at phase 2's bf16 tolerance, and timed
(CUDA events, L2 flushed, median) at phase 7's shape, all variants in
turn, twice. Prints one line per case and per round and writes
``chiprun_out/k1_variants.json``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda

ROOT = build.BUILD_ROOT.parents[1]   # the checkout: chip_smoke.py lives there

_CLUSTER = "  while (c < kMaxCluster && pairs * c * 2 <= sms) c *= 2;\n  return c;\n"
# name → [(text in paged_attention.cu, its replacement), ...]
VARIANTS = {
    "landed": [],
    **{f"cluster_{c}": [(_CLUSTER, f"  return {c};\n")] for c in (1, 2, 4, 8)},
    # P·V over one bf16 term, l summed from the same rounded weights
    "one_term": [("constexpr int kPTerms = 2;", "constexpr int kPTerms = 1;")],
    "warps_2": [("constexpr int kWarps = 4;\nconstexpr int kThreads = kWarps * 32;\n"
                 "constexpr int kTile",
                 "constexpr int kWarps = 2;\nconstexpr int kThreads = kWarps * 32;\n"
                 "constexpr int kTile")],
    "warps_8": [("constexpr int kWarps = 4;\nconstexpr int kThreads = kWarps * 32;\n"
                 "constexpr int kTile",
                 "constexpr int kWarps = 8;\nconstexpr int kThreads = kWarps * 32;\n"
                 "constexpr int kTile")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    card = cs.card_line()
    print(card, flush=True)
    built = build.build_variants("paged_attention.cu", VARIANTS, "k1_variants",
                                 "paged_attention_launch")
    libs = {n: lib for n, (lib, _) in built.items() if lib is not None}
    result = {"card": card, "ptxas": {}, "cases": {}, "times": {}}
    for name, (lib, log_) in built.items():
        rep = cs.ptxas_report([log_]) if lib else log_[-3000:]
        if lib:
            result["ptxas"][name] = rep
        print(f"{name}: {'ptxas ' + str(rep) if lib else 'BUILD FAILED ' + rep}", flush=True)

    gen = torch.Generator("cuda").manual_seed(1)
    tol = cs.TOL_K1_BF16
    main_lens = [len(p) + cs.MAX_NEW for p in
                 cs.make_prompts(np.random.default_rng(0), 8, get_config("yi_9b").vocab_size)]
    cases = {"slice": (cs.k1_inputs(gen, lens=main_lens), None),
             "short_rows": (cs.k1_inputs(gen, lens=[1, 2, 3, 4, 5, 7, 9, 17]), None),
             "sweep_D128_T16": (cs.k1_inputs(gen, B=4, Hq=16, Hkv=4, P=64, MAXP=6), None),
             "sweep_D64_T8": (cs.k1_inputs(gen, B=2, Hq=16, Hkv=2, D=64, P=64, T=8, MAXP=6),
                              None)}
    for name in cs.K1_SANDBOX_CASES:
        cases[name] = cs.k1_sandbox_case(gen, name, torch.bfloat16)
    for name in cs.K1_SPLIT_CASES:
        cases[name] = cs.k1_split_case(gen, name)
    for key, (args, expect) in cases.items():
        want, want_oob = paged_attention_ref(*args)
        want = want.float()
        row = {}
        for name, lib in libs.items():
            got, oob = paged_attention_cuda(*args, lib=lib)
            got = got.float()
            ok = (torch.equal(oob, want_oob) and (expect is None or oob.tolist() == expect)
                  and bool(torch.isfinite(got).all()) and torch.allclose(got, want, **tol))
            row[name] = {"max_abs_err": (got - want).abs().max().item(), "ok": ok}
        result["cases"][key] = row
        print(f"case {key}: " + "; ".join(
            f"{n} {r['max_abs_err']:.2e} {'ok' if r['ok'] else 'MISS'}" for n, r in row.items()),
            flush=True)

    timer = cs.Timer()
    args = cs.k1_inputs(gen, lens=main_lens)
    runs = {n: [] for n in libs}
    for rnd in range(2):
        for name, lib in libs.items():
            runs[name].append(timer.ms(lambda: paged_attention_cuda(*args, lib=lib)))
        print(f"time round {rnd + 1} (ms, B=8 Hq=32 Hkv=4 D=128 T=16 MAXP=64, lengths "
              f"{main_lens}): " + "; ".join(f"{n} {ts[-1]:.5f}" for n, ts in runs.items()),
              flush=True)
    result["times"] = runs

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k1_variants.json").write_text(json.dumps(result, indent=1))
    missed = [k for k, row in result["cases"].items() if not row.get("landed", {}).get("ok")]
    if missed:
        print(f"the landed kernel misses at {missed}", flush=True)
    return 1 if missed or len(libs) < len(VARIANTS) else 0


if __name__ == "__main__":
    sys.exit(main())
