"""Time and check variants of the bf16 flash-prefill kernel on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_prefill.variants

Each variant is ``csrc/flash_prefill.cu`` with a few text substitutions
that remove or change one mechanism of the kernel; ``landed`` is the file
as it is. Every variant is built by its own ``nvcc`` (all started
together) into ``build/k3_variants/`` at the root of the checkout and
called through its C entry point. Each is held against the plain version
at ``chip_smoke.py``'s phase 12 cases and the card tests' edge windows, at
phase 12's bf16 tolerance, and timed (CUDA events, L2 flushed, median) at
phase 15's shapes, all variants in turn, twice. Prints one line per case
and per shape and writes ``chiprun_out/k3_variants.json``.
"""

from __future__ import annotations

import json
import sys

import torch

from repro_torch.kernels import build

ROOT = build.BUILD_ROOT.parents[1]   # the checkout: chip_smoke.py lives there

# name → [(text in flash_prefill.cu, its replacement), ...]
_NO_LO = ("        wgmma_rs<D>(o, lo[kk], dv);\n", "")
VARIANTS = {
    "landed": [],
    # P·V over one bf16 term, l summed from the same rounded weights
    "one_term": [
        _NO_LO,
        ("            s[j][e] = none ? 0.f : exp2f(s[j][e] - m[i]);",
         "            s[j][e] = none ? 0.f : __bfloat162float(__float2bfloat16_rn("
         "exp2f(s[j][e] - m[i])));"),
    ],
    # P·V over one bf16 term, l summed from the fp32 weights
    "one_term_fp32_l": [_NO_LO],
    # D 256: a block always takes 128 positions of one query head
    "one_head_a_block": [
        ("const int pack_log2 = Shape<D>::kWG == 2 && (Hq / Hkv) % 2 == 0 ? 1 : 0;",
         "const int pack_log2 = 0;"),
    ],
    # the running max follows every tile's max and O is rescaled every tile
    "eager_rescale": [
        ("constexpr float kLazy = 8.f;", "constexpr float kLazy = 0.f;"),
        ("if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))", "if (true)"),
    ],
}
# (S, window, softcap) at B 2, 4/2 heads, D 64/128/256: tests/test_torch_cuda.py's edge windows
EDGES = [(1, 0, 0.0), (1, 5, 0.0), (65, 1, 0.0), (130, 64, 0.0), (200, 65, 0.0),
         (300, 17, 0.0), (1, 0, 30.0), (37, 0, 30.0), (37, 16, 30.0)]


def build_variants(names):
    """name → (loaded library or None, ptxas report or the build error)."""
    from chip_smoke import ptxas_report

    built = build.build_variants("flash_prefill.cu", {n: VARIANTS[n] for n in names},
                                 "k3_variants", "flash_prefill_launch")
    return {n: (lib, ptxas_report([log_]) if lib else log_[-3000:])
            for n, (lib, log_) in built.items()}


def launch(lib, q, k, v, window=0, softcap=0.0):
    out = torch.empty_like(q)
    B, S, Hq, D = q.shape
    code = lib.flash_prefill_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    None, B, S, Hq, k.shape[2], D, window, 1, softcap,
                                    torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"flash_prefill_launch: CUDA error {code}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    card = cs.card_line()
    print(card, flush=True)
    built = build_variants(VARIANTS)
    libs = {n: lib for n, (lib, _) in built.items() if lib is not None}
    for name, (lib, rep) in built.items():
        print(f"{name}: {'ptxas ' + str(rep) if lib else 'BUILD FAILED ' + rep}", flush=True)
    result = {"card": card, "ptxas": {n: r for n, (lib, r) in built.items() if lib},
              "cases": {}, "times": {}}

    gen = torch.Generator("cuda").manual_seed(1)
    tol = cs.TOL_K3[torch.bfloat16]
    cases = list(cs.K3_CASES) + [(2, S, 4, 2, D, w, c) for D in (64, 128, 256)
                                 for S, w, c in EDGES]
    for B, S, Hq, Hkv, D, window, softcap in cases:
        q, k, v = cs.k3_inputs(gen, B, S, Hq, Hkv, D, torch.bfloat16)
        want = flash_prefill_ref(q, k, v, window=window, softcap=softcap).float()
        row = {}
        for name, lib in libs.items():
            got = launch(lib, q, k, v, window, softcap).float()
            row[name] = {"max_abs_err": (got - want).abs().max().item(),
                         "ok": bool(torch.isfinite(got).all() and torch.allclose(got, want, **tol))}
        key = f"B{B} S{S} {Hq}/{Hkv} D{D} w{window} cap{softcap:g}"
        result["cases"][key] = row
        print(f"case {key}: " + "; ".join(
            f"{n} {r['max_abs_err']:.2e} {'ok' if r['ok'] else 'MISS'}" for n, r in row.items()),
            flush=True)

    timer = cs.Timer()
    for shape, (B, S, Hq, Hkv, D, window) in cs.K3_TIMED.items():
        q, k, v = cs.k3_inputs(gen, B, S, Hq, Hkv, D, torch.bfloat16)
        flops = 4 * D * Hq * B * cs.k3_pairs(S, window)
        runs = {n: [] for n in libs}
        for _ in range(2):
            for name, lib in libs.items():
                runs[name].append(timer.ms(lambda: launch(lib, q, k, v, window)))
        result["times"][shape] = runs
        print(f"time {shape} (ms, TFLOP/s): " + "; ".join(
            f"{n} " + " ".join(f"{t:.4f} ({flops / t / 1e9:.1f})" for t in ts)
            for n, ts in runs.items()), flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "k3_variants.json").write_text(json.dumps(result, indent=1))
    missed = [k for k, row in result["cases"].items() if not row.get("landed", {}).get("ok")]
    if missed:
        print(f"the landed kernel misses at {missed}", flush=True)
    return 1 if missed or len(libs) < len(VARIANTS) else 0


if __name__ == "__main__":
    sys.exit(main())
