#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and exits non-zero
before the result line is printed:

1. environment: the card's name and power limit; build the CUDA kernels
   from ``src/repro_torch/csrc`` (timed as set-up);
2. every kernel against its plain PyTorch version on the card, at the
   slice's shapes, plus the sandbox cases and clamped page ids;
3. the main path: yi-9b at full width and depth (48 layers) with random
   weights from a seed, served by ``ServeEngine``:
   8 concurrent ``generate_tokens`` streams, then 3 requests through
   ``submit``/``run_until_drained``; the kernel launch counts are read
   around this run alone;
4. end-to-end check of the paged kernel: the same prompts through the
   dense-cache ``Model.prefill`` + ``Model.decode_step`` chain;
5. where a decode step's time goes, from ``torch.profiler``;
6. cross-pod handoff between two full-width pools (gather/scatter);
7. times with CUDA events (median over samples, L2 flushed before each);
8. a ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Needs a CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
jax or of the reference package. Also writes its measurements to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)   # the reference's tolerance: near-tie rule
TOL_F32 = dict(atol=5e-5, rtol=1e-4)
# paged_attention alone in bf16: kernel and plain version both accumulate in
# fp32, so they differ by about the output's bf16 rounding
TOL_K1_BF16 = dict(atol=2e-3, rtol=1e-2)
MAX_NEW = 16                            # new tokens per stream and request
SAMPLES = 25


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
class Timer:
    """Median of per-call CUDA-event times. Before each call the L2 cache
    is flushed (the main path finds each layer's pool slice cold) and the
    card is kept busy for ~0.1 ms, so the call is fully enqueued before
    its start event fires and the host's launch overhead stays outside
    the measured interval."""

    def __init__(self):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, samples: int = SAMPLES, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(samples):
            self.flush_buf.zero_()
            torch.cuda._sleep(200_000)   # spin ~0.1 ms of GPU clocks
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def k1_inputs(gen, B=8, Hq=32, Hkv=4, D=128, P=512, T=16, MAXP=64,
              dtype=torch.bfloat16, lens=None):
    dev = "cuda"
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, T, Hkv, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, T, Hkv, D), generator=gen, device=dev).to(dtype)
    bt = torch.randperm(P, generator=gen, device=dev)[: B * MAXP]
    bt = bt.reshape(B, MAXP).to(torch.int32).contiguous()
    if lens is None:
        lens = torch.randint(1, MAXP * T + 1, (B,), generator=gen, device=dev)
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    ones = torch.ones((P,), dtype=torch.int32, device=dev)
    sandbox = torch.tensor([0, P, 1], dtype=torch.int32, device=dev)
    return [q, kp, vp, bt, lens, ones.clone(), sandbox, ones.clone()]


def check_k1(args, tol, expect_oob=None):
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    out, oob = paged_attention_cuda(*args)
    torch.cuda.synchronize()
    ref_out, ref_oob = paged_attention_ref(*args)
    if not torch.equal(oob, ref_oob):
        fail(f"paged_attention oob {oob.tolist()} != plain {ref_oob.tolist()}")
    if expect_oob is not None and oob.tolist() != expect_oob:
        fail(f"paged_attention oob {oob.tolist()} != expected {expect_oob}")
    if not torch.isfinite(out.float()).all():
        fail("paged_attention produced a non-finite value")
    if not torch.allclose(out.float(), ref_out.float(), **tol):
        fail("paged_attention disagrees with its plain version: max |err| "
             f"{(out.float() - ref_out.float()).abs().max().item()}")
    return (out.float() - ref_out.float()).abs().max().item()


def phase_kernels(gen, main_lens):
    """K1 at the slice's shapes and the four sandbox cases; K2 bitwise."""
    from repro_torch.kernels.scope_copy.kernel import gather_pages_cuda, scatter_pages_cuda
    from repro_torch.kernels.scope_copy.ref import gather_pages_ref, scatter_pages_ref

    # the slice shape at the main path's lengths: up to 30 in-use pages, so
    # each of the kernel's 8 warps carries its softmax across several pages
    k1_err = check_k1(k1_inputs(gen, lens=main_lens), TOL_K1_BF16)
    k1_err = max(k1_err, check_k1(k1_inputs(gen, lens=main_lens, dtype=torch.float32),
                                  TOL_F32))
    for B, Hq, Hkv, D, T, dtype in ((2, 4, 1, 64, 8, torch.float32),
                                    (3, 8, 1, 128, 16, torch.float32),
                                    (4, 16, 4, 128, 16, torch.bfloat16),
                                    (2, 16, 2, 64, 8, torch.bfloat16)):
        tol = TOL_F32 if dtype == torch.float32 else TOL_K1_BF16
        err = check_k1(k1_inputs(gen, B=B, Hq=Hq, Hkv=Hkv, D=D, P=64, T=T,
                                 MAXP=6, dtype=dtype), tol)
        k1_err = max(k1_err, err)
    cases = {}
    for name, expect in (("wild_pointer", [1, 0]), ("unsealed_page", [0, 1]),
                         ("sandbox_off", [0, 0]), ("foreign_bitmap", [1, 0]),
                         ("empty_row", [0, 2])):
        args = k1_inputs(gen, B=2, Hq=4, Hkv=2, D=64, P=32, T=16, MAXP=4,
                         dtype=torch.float32)
        bt, perm, bitmap = args[3], args[5], args[7]
        if name == "wild_pointer":
            bt[0, 0] = 999
        elif name == "unsealed_page":
            perm[bt[1, 0]] = 0
        elif name == "sandbox_off":
            perm.zero_()
            args[6] = torch.tensor([0, 32, 0], dtype=torch.int32, device="cuda")
        elif name == "foreign_bitmap":
            bitmap[bt[0, 0]] = 0
        else:   # no valid token: a zero-length row and a fully rejected row
            args[4] = torch.tensor([0, 20], dtype=torch.int32, device="cuda")
            bitmap[bt[1, :2].long()] = 0
        cases[name] = check_k1(args, TOL_F32, expect_oob=expect)

    for dtype in (torch.bfloat16, torch.float32, torch.int32):
        for W in (8192, 7):            # 16-byte vector path and byte path
            pool = (torch.randn((1024, W), generator=gen, device="cuda") * 1000).to(dtype)
            pages = torch.tensor([3, 1023, -5, 4000, 17, 512], dtype=torch.int32,
                                 device="cuda")
            got = gather_pages_cuda(pool, pages)
            buf = (torch.randn((6, W), generator=gen, device="cuda") * 1000).to(dtype)
            dst_pages = torch.tensor([7, 2000, -1, 100, 55, 900], dtype=torch.int32,
                                     device="cuda")
            scattered = scatter_pages_cuda(pool.clone(), dst_pages, buf)
            torch.cuda.synchronize()
            if not torch.equal(got, gather_pages_ref(pool, pages)):
                fail(f"gather_pages differs from its plain version ({dtype}, W={W})")
            if not torch.equal(scattered, scatter_pages_ref(pool.clone(), dst_pages, buf)):
                fail(f"scatter_pages differs from its plain version ({dtype}, W={W})")
    log(f"phase 2 kernels vs plain: paged_attention at the slice shape (bf16 and "
        f"f32, B=8 Hq=32 Hkv=4 D=128 T=16 MAXP=64) and a D/GQA/dtype sweep, max|err| "
        f"{k1_err:.3e}; sandbox cases "
        f"{ {k: f'{v:.1e}' for k, v in cases.items()} }; gather/scatter bitwise "
        "for bf16/f32/i32 with clamped ids")
    # K2 either matches bitwise or the phase has failed
    return {"paged_attention": max(k1_err, *cases.values()),
            "gather_pages": 0.0, "scatter_pages": 0.0}


# ---------------------------------------------------------------------------
# phases 3-6: the main path
# ---------------------------------------------------------------------------
def make_prompts(rng, n, vocab):
    return [rng.integers(1, vocab, size=int(rng.integers(128, 513))).tolist()
            for _ in range(n)]


def phase_serve(cfg, model, prompts, extra, max_new):
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving import PoolConfig, ServeEngine

    dev = model.device
    eng = ServeEngine(cfg, model, PoolConfig(num_pages=512, page_tokens=16,
                                             max_pages_per_seq=64), max_active=8,
                      device=dev)
    free0 = eng.pool.heap.free_pages()
    paged_attention.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    gens = [eng.generate_tokens(p, max_new) for p in prompts]
    sync(dev)
    t_admit = time.perf_counter() - t0
    streams = [[] for _ in prompts]
    t1 = time.perf_counter()
    live = list(range(len(prompts)))
    while live:                     # round-robin pulls: one batched step each
        for i in list(live):
            tok = next(gens[i], None)
            if tok is None:
                live.remove(i)
            else:
                streams[i].append(tok)
    sync(dev)
    t_decode = time.perf_counter() - t1
    stream_steps = eng.stream_steps
    rids = [eng.submit(p, max_new) for p in extra]
    eng.run_until_drained(timeout=600)
    launches = paged_attention.launches
    results = [eng.result(r) for r in rids]

    L = cfg.num_layers
    if launches != L * eng.decode_steps:
        fail(f"paged_attention launched {launches} times, expected "
             f"{L} x {eng.decode_steps} decode steps")
    if eng.oob_events:
        fail(f"{eng.oob_events} sandbox violations on the main path")
    if eng.pool.heap.free_pages() != free0 or eng.pool.stats()["sealed_pages"]:
        fail(f"pages or seals leaked: {eng.pool.stats()}")
    if any(len(s) != max_new for s in streams + results):
        fail("a stream or request came back short")
    step_ms = 1e3 * t_decode / stream_steps
    info = {
        "decode_steps": eng.decode_steps, "stream_steps": stream_steps,
        "launches": launches, "peak_batch": eng.peak_stream_batch,
        "admit_8_prefills_s": t_admit, "decode_step_ms_b8": step_ms,
        "decode_tokens_per_s_b8": len(prompts) * stream_steps / t_decode,
    }
    log(f"phase 3 main path: {len(prompts)} streams + {len(extra)} requests, "
        f"{eng.decode_steps} decode steps, paged_attention launches {launches} "
        f"= {L} x {eng.decode_steps}, oob 0, all pages and seals returned; "
        f"decode step {step_ms:.2f} ms at B=8")
    return eng, streams + results, info


def phase_profile(eng, prompts, max_new, steps=4):
    """Where a decode step's time goes: a few batched steps at B=8 under
    torch.profiler; device time by kernel against the host clock. Only
    device events are summed: an operator's own entry also carries the
    time of the kernels it launched, which would count them twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gens = [eng.generate_tokens(p, max_new) for p in prompts]
    for g in gens:
        next(g)                       # the prefill token; no step yet
    def run_steps():
        sync(eng.device)
        t0 = time.perf_counter()
        with eng._decode_lock:
            for _ in range(steps):
                eng.scheduler.step_batch()
        sync(eng.device)
        return 1e3 * (time.perf_counter() - t0) / steps

    wall_ms = run_steps()             # the same steps, no profiler attached
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run_steps()
    for g in gens:
        g.close()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    info = {"steps": steps, "wall_ms_per_step": wall_ms,
            "profiled_wall_ms_per_step": prof_wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "launches_per_step": sum(c for _, _, c in kernels),
            "top_kernels_ms_per_step": [(k[:80], t) for k, t, _ in top]}
    if busy_ms:
        log(f"phase 5 where a decode step goes (B=8, {steps} steps, then the "
            f"same under the profiler): {wall_ms:.2f} ms wall ({prof_wall_ms:.2f} "
            f"profiled), {busy_ms:.2f} ms device busy, idle share "
            f"{info['device_idle_share']:.3f}, {info['launches_per_step']:.0f} "
            f"launches; top kernels "
            f"{[(k[:40], round(t, 3)) for k, t in info['top_kernels_ms_per_step']]}")
    else:
        log("phase 5 where a decode step goes: the profiler reported no device "
            "time; device busy share not measured")
    return info


def phase_dense(model, prompts, outputs, max_new):
    """The dense-cache chain on the same prompts; agreement up to the
    first mismatch, which must sit at a near-tie of the dense chain."""
    near_ties, agreed = [], 0
    dev = model.device
    for n, (prompt, got) in enumerate(zip(prompts, outputs)):
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        logits, cache = model.prefill(toks, cache_len=len(prompt) + max_new)
        seq, gaps = [], []
        for k in range(max_new):
            top2 = torch.topk(logits[0], 2).values.tolist()
            gaps.append((top2[0] - top2[1], top2[0]))
            seq.append(int(logits[0].argmax()))
            if k + 1 < max_new:
                logits, cache = model.decode_step(
                    torch.tensor([seq[-1]], dtype=torch.int32, device=dev),
                    torch.tensor([len(prompt) + k], dtype=torch.int32, device=dev),
                    cache)
        first = next((k for k in range(max_new) if seq[k] != got[k]), None)
        if first is None:
            agreed += 1
            continue
        gap, top = gaps[first]
        if gap > TOL_BF16["atol"] + TOL_BF16["rtol"] * abs(top):
            fail(f"stream {n} diverges from the dense chain at step {first} "
                 f"with top-2 gap {gap:.4f} (no near-tie): {got} vs {seq}")
        near_ties.append({"stream": n, "step": first, "gap": gap})
    log(f"phase 4 dense-cache chain: {agreed}/{len(prompts)} streams identical; "
        f"near-tie divergences {near_ties}")
    return {"identical_streams": agreed, "near_ties": near_ties}


def phase_transfer(cfg, gen):
    from repro_torch.core.orchestrator import Orchestrator
    from repro_torch.kernels.scope_copy import gather_pages, scatter_pages
    from repro_torch.serving import PagedKVPool, PoolConfig, transfer_pages_cross_pod

    pc = PoolConfig(num_pages=512, page_tokens=16, max_pages_per_seq=64)
    orch = Orchestrator()
    dev = gen.device
    src = PagedKVPool(orch, cfg, pc, owner_pid=1, device=dev)
    dst = PagedKVPool(orch, cfg, pc, owner_pid=2, device=dev)
    for t in (src.k, src.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    sp = src.alloc_seq(528, 1)
    dp = dst.alloc_seq(528, 2)
    gather_pages.launches = scatter_pages.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    moved = transfer_pages_cross_pod(src, dst, sp, dp)
    sync(dev)
    dt = time.perf_counter() - t0
    launches = {"gather_pages": gather_pages.launches,
                "scatter_pages": scatter_pages.launches}
    L, n = cfg.num_layers, len(sp)
    want = 2 * L * n * pc.page_tokens * cfg.num_kv_heads * cfg.head_dim * 2
    if moved != want:
        fail(f"transfer moved {moved} bytes, expected {want}")
    if launches != {"gather_pages": 2 * L, "scatter_pages": 2 * L}:
        fail(f"transfer launches {launches}, expected {2 * L} each")
    idx_s, idx_d = torch.tensor(sp, device=dev), torch.tensor(dp, device=dev)
    for a, b in ((src.k, dst.k), (src.v, dst.v)):
        if not torch.equal(a[:, idx_s].view(torch.int16), b[:, idx_d].view(torch.int16)):
            fail("copied pages are not bitwise equal to the source")
        rest = torch.ones(pc.num_pages, dtype=torch.bool, device=dev)
        rest[idx_d] = False
        if b[:, rest].abs().sum().item() != 0:
            fail("the transfer wrote outside the destination pages")
    log(f"phase 6 cross-pod handoff: {n} pages x {L} layers x K,V = {moved} bytes, "
        f"bitwise equal; {2 * L} gathers + {2 * L} scatters in {1e3 * dt:.2f} ms")
    return src, sp, {"bytes": moved, "ms": 1e3 * dt, "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------
def phase_times(gen, main_lens, src_pool, src_pages, card):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.kernels.scope_copy.kernel import gather_pages_cuda, scatter_pages_cuda
    from repro_torch.kernels.scope_copy.ref import gather_pages_ref, scatter_pages_ref

    timer = Timer()
    out = {}

    # K1 at the main path's shapes: B=8, MAXP=64, ragged lengths as served
    args = k1_inputs(gen, lens=main_lens)
    q, kp, vp, bt, lens = args[:5]
    B, Hq, D = q.shape
    P, T, Hkv, _ = kp.shape
    pages_used = [math.ceil(int(n) / T) for n in lens.tolist()]
    tok_total = int(lens.sum())
    kv_bytes = 2 * tok_total * Hkv * D * kp.element_size()   # valid tokens only
    io_bytes = 2 * q.numel() * q.element_size() + B * 4 * 2 \
        + sum(pages_used) * 4 * 3      # block-table, perm, bitmap entries read
    flops = 4 * Hq * D * tok_total
    b_ms, b_by = bound_ms(kv_bytes + io_bytes, flops)
    # the library yardstick: SDPA over the same KV gathered contiguous
    S = max(pages_used) * T
    k_c = kp[bt[:, : S // T].long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    v_c = vp[bt[:, : S // T].long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q4, k_c, v_c, attn_mask=mask,
                                                  enable_gqa=True)
    lib_err = (sdpa()[:, :, 0].float() - paged_attention_ref(*args)[0].float()).abs().max()
    out["paged_attention"] = {
        "ms": timer.ms(lambda: paged_attention_cuda(*args)),
        "plain_ms": timer.ms(lambda: paged_attention_ref(*args)),
        "library_ms": timer.ms(sdpa),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": kv_bytes + io_bytes,
        "library_max_abs_err_vs_plain": lib_err.item(),
    }

    # K2 at the transfer's shapes: one layer's rows of the flattened pool
    flat = src_pool.k.view(-1, src_pool.k[0, 0].numel())
    pages = torch.tensor(src_pages, dtype=torch.int32, device="cuda")
    pages_l = pages.long()
    n, W = len(src_pages), flat.shape[1]
    nbytes = 2 * n * W * flat.element_size() + n * 4
    b_ms, b_by = bound_ms(nbytes, 0)
    wire = gather_pages_cuda(flat, pages)
    dst = torch.zeros_like(flat[:1024])
    out["gather_pages"] = {
        "ms": timer.ms(lambda: gather_pages_cuda(flat, pages)),
        "plain_ms": timer.ms(lambda: gather_pages_ref(flat, pages)),
        "library_ms": timer.ms(lambda: torch.index_select(flat, 0, pages_l)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
    }
    out["scatter_pages"] = {
        "ms": timer.ms(lambda: scatter_pages_cuda(dst, pages, wire)),
        "plain_ms": timer.ms(lambda: scatter_pages_ref(dst, pages, wire)),
        "library_ms": timer.ms(lambda: dst.index_copy_(0, pages_l, wire)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
    }
    for name in ("gather_pages", "scatter_pages"):
        out[name]["GB_per_s"] = nbytes / out[name]["ms"] / 1e6
    log("phase 7 times on %s (ms, median of %d, L2 flushed): %s" % (card, SAMPLES, json.dumps(
        {k: {m: round(v, 5) for m, v in d.items() if isinstance(v, float)}
         for k, d in out.items()})))
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    t0 = time.perf_counter()
    build.library()
    t_build = time.perf_counter() - t0
    ptxas = [ln.strip() for out in build.build_log for ln in out.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"phase 1 environment: {kind}, torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), kernels built in {t_build:.1f} s; ptxas: {ptxas}")

    cfg = get_config("yi_9b")
    rng = np.random.default_rng(0)
    prompts = make_prompts(rng, 8, cfg.vocab_size)
    extra = make_prompts(rng, 3, cfg.vocab_size)
    main_lens = [len(p) + MAX_NEW for p in prompts]
    gen = torch.Generator("cuda").manual_seed(1)

    errs = phase_kernels(gen, main_lens)

    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {cfg.name} {cfg.num_layers} layers, {n_params / 1e9:.2f} B "
        f"params, initialised in {time.perf_counter() - t0:.1f} s")
    eng, outputs, serve = phase_serve(cfg, model, prompts, extra, MAX_NEW)
    dense = phase_dense(model, prompts + extra, outputs, MAX_NEW)
    prof = phase_profile(eng, prompts, MAX_NEW)
    del eng, model
    torch.cuda.empty_cache()
    src_pool, src_pages, transfer = phase_transfer(cfg, gen)
    times = phase_times(gen, main_lens, src_pool, src_pages, card)

    sources = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:189",
                            serve["launches"]),
        "gather_pages": ("src/repro_torch/csrc/scope_copy.cu",
                         "src/repro/kernels/scope_copy/kernel.py:47",
                         transfer["launches"]["gather_pages"]),
        "scatter_pages": ("src/repro_torch/csrc/scope_copy.cu",
                          "src/repro/kernels/scope_copy/kernel.py:75",
                          transfer["launches"]["scatter_pages"]),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches, "max_abs_err": errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": times[name]["library_ms"],
    } for name, (src, tpu, launches) in sources.items()]

    result = {"card": card, "build_s": t_build, "serve": serve, "dense": dense,
              "profile": prof, "transfer": transfer, "times": times,
              "kernels": kernels}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
