#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, one printed line each; any failure raises and exits non-zero
before the result line is printed:

1. environment: the card's name and power limit; build the CUDA kernels
   from ``src/repro_torch/csrc`` (timed as set-up) and read ptxas's
   register and spill report, which must cover the two bf16
   paged-attention, the three bf16 flash-prefill, its six bf16 backward
   (dq and dk/dv at each head_dim) and the bf16 SSD instantiations and
   show no spill in them;
2. the paged-attention and page-copy kernels against their plain PyTorch
   versions on the card, at the yi-9b slice's shapes, plus the sandbox
   cases in f32 and bf16, bf16 cases that reach the cluster split
   (rejected pages on ranks other than 0, empty ranks, seq_len past
   MAXP·T, 1 and 8 query rows a KV head) and clamped page ids;
3. yi-9b at full width and depth (48 layers) with random weights from a
   seed, served by ``ServeEngine``: 8 concurrent ``generate_tokens``
   streams, then 3 requests through ``submit``/``run_until_drained``; the
   kernel launch counts are read around this run alone;
4. end-to-end check of the paged kernel: the same prompts through the
   dense-cache ``Model.prefill`` + ``Model.decode_step`` chain;
5. where a yi-9b decode step's time goes, from ``torch.profiler``;
6. cross-pod handoff between two full-width pools: one gather and one
   scatter a tensor over every layer's rows;
7. times with CUDA events (median over samples, L2 flushed before each),
   the paged-attention kernel's SDPA yardstick under each backend alone
   (the fastest is ``library_ms``);
8. the SSD intra-chunk kernel against its plain version at mamba2-1.3b's
   batched prefill shape in bf16 (tensor cores) and f32 (CUDA cores),
   with chunk decays above 88 (where an unmasked exp overflows), a bf16
   sweep of ragged tile edges, and a sweep of the chunked scan through
   the kernel against the recurrence;
9. mamba2-1.3b at full width and depth (48 layers), random weights from
   a seed: 8 requests prefilled alone through ``Model.prefill`` (the SSD
   kernel's launch count is read around these prefills), their caches
   joined on the batch axis, 16 greedy ``Model.decode_step``s at B=8;
10. end-to-end check of the SSD kernel: an fp32 copy of the model,
    teacher-forced decode steps against prefills of the same prefixes;
11. mamba2 times: the SSD kernel, a batched 8 x 512 prefill, and a B=8
    decode step under ``torch.profiler``;
12. the flash-prefill kernel against its plain version at yi-9b's prefill
    shape and gemma3-12b's (head_dim 256, window 0, 65 and 1024) and at
    head_dim 64, bf16 (tensor cores) and f32 (CUDA cores), with a softcap
    at one shape;
13. gemma3-12b at full width and depth (48 layers: 40 local with a
    1024-token window, 8 global), random weights from a seed: 4 requests
    of 1,100-3,100 tokens prefilled alone through ``Model.prefill`` (the
    flash-prefill kernel's launch count is read around these prefills),
    caches joined on the batch axis, 16 greedy ``Model.decode_step``s;
14. end-to-end check of the flash-prefill kernel: an fp32 copy of
    gemma3's first 12 layers, teacher-forced decode steps through the
    ring caches against kernel prefills of the same prefixes;
15. gemma3 times: the flash-prefill kernel at yi-9b's and gemma3's
    global and local layer shapes beside its plain version and SDPA
    (each backend alone, the fastest kept), and a B=1, 4,096-token
    prefill under ``torch.profiler``;
16. the RPC plane at yi-9b full width (run after phase 5, on phase 3's
    model and prompts): a ``ServeEngine(serve_threaded=True)`` whose
    decode service is served by a ``ServerLoop`` thread; 8 client
    threads, each with its own stub, stream phase 3's prompts through
    ``decode.generate_stream`` over the ring (tokens equal phase 3's or
    differ first at a near-tie; K1 and K3 launch L x steps and L x
    prefills); 3 ``submit``s whose handoffs cross the ring under 200
    bytes each; the median handoff (seal + ``stub.attach``) inline and
    threaded; a cross-pod ``attach_remote`` whose ``PoolPages`` argument
    migrates the KV in 2 gathers + 2 scatters charged to the fallback
    link, decoding the same tokens as the same-pod handoff; no page or
    seal left and the serving thread stopped;
17. the paged-attention and flash-prefill kernels against their plain
    versions at olmo-1b's layout (16/16 heads: at B=8 the 128 pairs fill
    the card, so K1's cluster is one block, asserted) and qwen2-vl-7b's
    (28/4: 7 query rows a KV head), bf16 and f32, K1 at the served
    lengths with phase 2's sandbox cases, K3 at S=471 with and without a
    softcap;
18. olmo-1b at full width and depth (16 layers, non-parametric LayerNorm),
    random weights from a seed, served as yi-9b in phases 3, 4 and 6: 8
    streams and 3 submits through ``ServeEngine`` (K1 L x steps, K3 L x
    prefills), the dense-cache chain, a cross-pod handoff between two
    olmo pools (2 + 2 K2 launches, bitwise);
19. qwen2-vl-7b at full width and depth (28 layers, M-RoPE, q/k/v
    biases), the same traffic and checks; then ``Model.prefill`` with
    Qwen2-VL's position triples for an image (text, a 16 x 24 patch grid
    at one temporal position, text resuming after it): the positions path
    runs and K3 does not, the logits are finite, and explicit 0..S-1
    triples on the positions path give the K3 path's logits;
20. times: K1 at both models' decode shapes and K3 at their prefill
    shapes beside their bounds, plain versions and SDPA (each backend
    alone), and a B=8 decode step of each under ``torch.profiler``
    (printed with phases 18 and 19);
21. the flash-prefill kernel against its plain version at the MoE
    models' prefill shapes (B=1, the longest prompt: granite-moe's 16/8
    heads at head_dim 64, qwen3-moe's 32/4 at 128), bf16 and f32, and
    timed beside its bound, its plain version and SDPA;
22. granite-moe-1b-a400m at full width and depth (24 layers, 32 experts,
    top-8), random weights from a seed, through ``Model.prefill`` and
    ``Model.decode_step`` under ``dropless_moe()`` (the paged engine
    refuses MoE, as the reference's ``PagedLM`` does): 8 requests
    prefilled alone (K3 L x prefills), caches joined, 16 greedy steps at
    B=8; a decode step's device-to-host syncs, decode steps and an
    8 x 512 prefill under ``torch.profiler``; the capacity path: an
    8 x 512 prefill at factor 1.25 with each layer's dropped slots, and
    at factor E/k (nothing drops) each layer's output against the
    dropless path's on the same input; then fp32 teacher forcing over
    the served weights in fp32;
23. qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts,
    top-8; 61 GB in bf16) the same, its fp32 teacher forcing over its
    first 24 layers (all 48 would take ~122 GB);
24. the flash-prefill and SSD kernels against their plain versions at
    jamba-v0.1-52b's shapes (K3: B=1, the longest prompt, 32/8 heads at
    head_dim 128; K4: B 8, S 512, 128 heads, P 64, state 16, chunk 128,
    chunk decays above 88), bf16 and f32, and timed beside their bounds,
    their plain versions and (K3) SDPA;
25. jamba-v0.1-52b at full width and 16 of its 32 layers (two 8-layer
    super-blocks: 2 attention layers without positions, 14 SSM layers, 8
    MoE FFNs of 16 experts top-2; 25.73 B parameters, 51.5 GB in bf16),
    random weights from a seed, under ``dropless_moe()``, as phases 22
    and 23: 8 requests prefilled alone (K3 2 and K4 14 launches each),
    caches joined, 16 greedy steps at B=8 under the router near-tie rule,
    a step's syncs and profile, an 8 x 512 prefill under the profiler;
26. its capacity path: an 8 x 512 prefill at factor 1.25 with each MoE
    layer's dropped slots, and at factor E/k each layer's output bitwise
    the dropless one;
27. one 16,384-token prompt at B=1: time to first token, the prefill's
    device busy and K3's and K4's device time under the profiler, the
    chunked scan outside K4 (inter-chunk recurrence, off-diagonal term)
    from CUDA events, and 16 decode steps;
28. fp32 teacher forcing over one super-block (8 layers, 52.0 GB in
    fp32, the bf16 model freed first), each step against a kernel
    prefill of its prefix within 1e-3 and with the same argmax; peak
    device memory after each of phases 25-28;
29. the flash-prefill kernel against its plain version at whisper-base's
    decoder self-attention shapes (B=1, 8/8 heads at head_dim 64, S 1, 4,
    63 and 224), bf16 and f32, and timed at S 224 beside its bound, its
    plain version and SDPA (each backend alone);
30. whisper-base at full width and depth (6 encoder + 6 decoder layers,
    d_model 512), random weights from a seed, through ``Model.prefill``
    and ``Model.decode_step`` (the paged engine refuses cross-attention):
    8 requests of 4-224 decoder tokens, each prefilled alone with its
    1,500 frames (K3 6 launches a prefill, the encoder's and the
    cross-attention's 12 layers on the memory path), self and cross caches
    joined, 16 greedy steps at B=8 (phase 9's rule on the first), the
    cross caches bitwise unchanged by decode; the encoder over 8 x 1,500
    frames, a B=1 prefill and a B=8 decode step under the profiler; fp32
    teacher forcing over all 12 layers within 1e-3, same argmax;
31. the serving CLI (``repro_torch.launch.serve.main``) in-process at the
    reference's defaults and with ``--sleep-us 5``: on the card, 0 sandbox
    violations, K1 and K3 launches counted around each call;
32. the kernels' gradients: ``FlashPrefillFn`` (K3's forward and its
    backward kernel, ``csrc/flash_prefill_bwd.cu``) against
    ``flash_prefill_vjp`` on the plain forward at olmo-1b's training shape
    and gemma3's (D 256, window 1,024, a softcap), fp32 (also against
    autograd of the plain version) and bf16: finite, one backward launch a
    gradient, a second gradient bitwise the first; the backward kernel
    alone against ``flash_prefill_vjp`` given the kernel forward's own O
    and lse at K3's kernel tolerance (bf16 atol 2e-3, rtol 1e-2); the
    backward kernel timed beside its bound, the plain vjp, K3's forward and SDPA's
    backward alone and forward + backward (each backend alone, causal
    only); ``SsdIntraChunkFn`` at mamba2's shape with chunk decays above
    88, finite in fp32 and bf16, and the chunked scan's grads through K4
    against autograd through the token recurrence;
33. olmo-1b at full width and depth, bf16 with fp32 AdamW state:
    ``make_train_step`` with remat, 20 steps on one 8 x 512 batch of the
    synthetic packed corpus (the loss falls by at least 0.5); every first
    gradient finite and non-zero; K3 twice a layer a step (forward and
    recompute) and its backward kernel once; step ms, tokens/s, peak
    memory, a profiled step; an fp32 copy at 2 layers: gradients through
    K3 and its backward against the plain version's (no kernel launched
    under the plain patch) within 1e-3 of each gradient's max;
34. mamba2-1.3b the same way, with K4;
35. the training CLI (``repro_torch.launch.train.main``) in-process: 40
    steps with a checkpoint every 20 (K3 twice a layer a step, its
    backward once), then ``--resume`` from step 20
    equals the uninterrupted run bitwise (else the largest difference and
    the ops without a deterministic implementation are printed);
36. sharded training on a world-size-1 NCCL group and a (1, 1, 1)
    pod/data/model mesh: olmo-1b (5 steps) and mamba2-1.3b (3 steps) as
    phases 33-34 build them, their parameters DTensors under
    ``launch/sharding.rules_for``, ZeRO-1 moments: losses bitwise equal to
    phases 33-34's, K3/K4 twice a layer a step on their local shards (K3's
    backward once), peak
    memory within 2%; the step ms beside the unsharded step's, a profiled
    step, and one sharded and one unsharded step under cProfile (DTensor's
    own host time, its dispatches and redistributes); olmo-1b's sharded
    parameters saved and restored onto the unsharded model bitwise;

37. gradient compression: olmo-1b's full gradient tree from one 8 x 512
    step with remat (K3 twice a layer, its backward once), two rounds of ``compressed_psum``
    with error feedback over the pod axis of a (1, 1, 1) mesh on a
    world-size-1 NCCL group, int8 on the wire (``n_shards=1``) and int32
    (asserted on the tensors handed to ``all_reduce``): every leaf within
    half a step plus one ulp of g + e, the new error (g + e) - codes *
    scale bitwise, the codes the CPU's outside half-integer ties; a round's
    ms beside its byte bound, ``estimate_bytes``, peak memory;
38. ``pipeline_apply`` with olmo-1b's whole stack as the one stage of a
    (1,) pod mesh over the embedded 8 x 512 batch in 4 microbatches: K3
    16 x 4 launches, the output bitwise the stack on each microbatch in
    turn, ``bubble_fraction(1, 4)`` 0, its ms beside the stack's on the
    whole batch (the ring between stages runs only in the CPU tests);
39. the dry-run tools under this machine's torch, as subprocesses:
    ``repro_torch.launch.dryrun`` at yi-9b train_4k on the (2, 16, 16)
    multipod mesh, mamba2-1.3b prefill_32k and qwen3-moe-30b-a3b
    decode_32k on the (16, 16) pod (fake process groups of 512 and 256
    ranks, DTensors over ``meta``): FLOPs, collective bytes by kind,
    memory fields, trace time and roofline terms; and
    ``repro_torch.launch.grad_sync --arch jamba-v0.1-52b``: int8_ef's
    all-reduce bytes half dense_bf16's and a quarter of dense_f32's plus
    the fp32 maxima;
40. the RPC plane's asynchronous surface at yi-9b's full width, printed
    right after phase 16 on its model and prompts: (a) 8 client threads
    in pod ``pod9`` stream phase 3's prompts from a threaded
    ``ServeEngine`` in ``pod0`` over the fallback link (staged chunk
    flights the clients pull): tokens equal phase 16's in-pod streams
    outside near-ties, K3 48 x 8 and K1 48 x the decode steps, no
    sandbox violation, every page and seal back; (b) three prompts
    prefilled (K3) into a pool of pod ``ppod`` hand off as
    ``attach_remote.future`` calls settled by one ``gather``: K2 4
    launches a transfer, K1 decodes them, the tokens equal the same
    prompts' in-pod ``generate_tokens`` outside near-ties; (c) the link's
    ``stats()`` for both, decode step ms and time to first token against
    phase 16's in-pod streams, the host ms of the flushes;
41. the cluster plane at yi-9b's full width, printed right after phase
    40 on its model and phase 3's prompts: a ``ServeEngine`` without a
    serving thread of its own and a standby ``DecodeService`` (pid 13)
    registered under its endpoint name, both channels served by one
    lifecycle ``Endpoint``, clients polling at 200 µs, every lease
    heartbeat through ``router.pump()``; (a) 8 ``balance="power2"``
    stubs: each stream pins one replica, both replicas take streams,
    tokens equal phase 16's outside near-ties; (b) 8 routed stubs on the
    primary (pid 12) while a ``ChaosInjector`` lapses its lease half-way
    through the tokens: one failover, each stream raises the mid-stream
    ``ChannelError`` once and restarts on pid 13, final tokens equal
    phase 16's outside near-ties, every page and seal back, then 3
    submits hand off over pid 13's ring; (c) ``quiesce()`` sheds a new
    stream with a typed ``Overloaded``, ``resume()`` serves it,
    ``drain()`` and ``close()``; K3 48 x the prefills run (restarts and
    submits included) and K1 48 x the decode steps; step ms at B=8
    before and after the lapse, host ms from the lapse to each restarted
    stream's first token, host µs of ``pump()`` and of the lapse's tick;
42. yi-9b's served streams under the ShmCheck sanitizer, printed right
    after phase 41 on its model and phase 3's prompts: a threaded
    ``ServeEngine`` built inside a ``repro_torch.analysis.session()``
    serves phase 16's 8 polling client streams; no finding, oob 0, every
    page, seal and slot back, tokens equal phase 16's outside near-ties,
    K3 48 x 8 and K1 48 x the decode steps; the tracer's event count by
    kind and the host ms spent in its hooks a decode step, and the B=8
    step in the order sanitized, unsanitized (an engine built outside any
    session), unsanitized, sanitized;

then a ``{"kernels": [...]}`` line (each kernel's launches summed over
every path, and by path), the card line, and last
``{"ok": true, "device": {...}}``.

Needs a CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
jax or of the reference package. Also writes its measurements to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
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
# ssd_intra_chunk alone: kernel and plain version get the same inputs and both
# accumulate in fp32, so they differ by summation order, scaled to the output
TOL_K4 = 1e-4
TOL_SCAN = dict(atol=2e-3, rtol=2e-3)   # chunked vs recurrence (tests/test_kernels.py:165)
TOL_TF = 1e-3          # fp32 decode vs prefill (tests/test_arch_smoke.py:113)
TOL_TF_MAX = 1e-2      # ... where 48 layers need more: printed, never beyond this
# mamba2-1.3b's SSD at the batched prefill of 8 x 512 tokens
SSD_SHAPE = dict(B=8, S=512, H=64, P=64, N=128, Q=128)
# (S, chunk, H, P, N) for the bf16 SSD kernel alone at B=2: the chunked
# sweep's ragged shapes at one and three chunks, a chunk of 100 (not a
# multiple of 16) and odd P and N (element loads, 4-byte stores)
K4_BF16_CASES = [(m * Q, Q, H, P, N) for Q, H, P, N in ((16, 8, 16, 16), (16, 64, 16, 128),
                                                        (128, 8, 64, 16), (128, 12, 24, 17))
                 for m in (1, 3)] + [(100, 128, 12, 24, 17), (100, 128, 64, 64, 128),
                                     (120, 40, 3, 17, 9)]
# flash_prefill alone, as paged_attention: both sides accumulate in fp32
TOL_K3 = {torch.float32: TOL_F32, torch.bfloat16: TOL_K1_BF16}
# (B, S, Hq, Hkv, D, window, softcap): yi-9b's prefill of its longest served
# sequence, gemma3's global and local layers at a ragged S, the kernel's
# smallest head_dim, and a window one key wider than a tile at gemma3's heads
K3_CASES = [(1, 471, 32, 4, 128, 0, 0.0), (1, 471, 32, 4, 128, 0, 30.0),
            (2, 2000, 16, 8, 256, 0, 0.0), (2, 2000, 16, 8, 256, 1024, 0.0),
            (2, 1000, 8, 2, 64, 0, 0.0), (2, 2000, 16, 8, 256, 65, 0.0)]
# timed at B=1, bf16: yi-9b's prefill, gemma3's global and local layers at 4,096
# (Hq, Hkv) at head_dim 128 of the paged configurations added after yi-9b
NEW_LAYOUTS = {"olmo-1b": (16, 16), "qwen2-vl-7b": (28, 4)}
# the MoE configurations (config id: layers of its fp32 teacher forcing;
# qwen3-moe's 48 would take ~122 GB in fp32, its first 24 take ~63 GB)
MOE_ARCHS = {"granite-moe-1b-a400m": 24, "qwen3-moe-30b-a3b": 24}
K3_TIMED = {"yi9b_S471": (1, 471, 32, 4, 128, 0), "gemma3_global_S4096": (1, 4096, 16, 8, 256, 0),
            "gemma3_local_S4096": (1, 4096, 16, 8, 256, 1024)}
# jamba-v0.1-52b: 16 of its 32 layers (its 51.19 B parameters are 102.4 GB in
# bf16; 16 layers hold 25.73 B, 51.5 GB), fp32 teacher forcing over one
# super-block of 8 (13.00 B, 52.0 GB in fp32), one prompt of 16,384 tokens
JAMBA_LAYERS, JAMBA_TF_LAYERS, JAMBA_LONG = 16, 8, 16384
# jamba's SSD at the batched prefill of 8 x 512 tokens: 128 heads, state 16
JAMBA_SSD_SHAPE = dict(B=8, S=512, H=128, P=64, N=16, Q=128)
# whisper-base: decoder prompts of 4-224 tokens (its decoder context is 448
# tokens, up to half of it the previous text); K3 checked at these lengths,
# the first a fraction of one 64-query tile, and timed at the longest
WHISPER_PROMPTS = (4, 224)
WHISPER_K3_S = (1, 4, 63, 224)


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
    card is kept busy for ~1 ms, so the call is fully enqueued before its
    start event fires and the host's launch overhead stays outside the
    measured interval. Phases 7 and 15 record that overhead (``host_us``):
    an SDPA call's is near 0.1 ms, the spin this one replaced."""

    def __init__(self):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, samples: int = SAMPLES, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(samples):
            self.flush_buf.zero_()
            torch.cuda._sleep(2_000_000)   # spin ~1 ms of GPU clocks
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    @staticmethod
    def host_us(fn, calls: int = 100) -> float:
        """Mean host time to enqueue one call of ``fn``, in µs."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e6 * (t1 - t0) / calls


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_by_backend(timer, call, plain):
    """``call`` (one scaled_dot_product_attention) under each backend alone.
    Returns the fastest backend's name, its ms and its max |Δ| against
    ``plain`` (the output as ``call`` returns it), and every backend's ms
    or why it refused the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    every, errs = {}, {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            every[name] = "not in this torch"
            continue

        def under(backend=backend):
            with sdpa_kernel(backend):
                return call()
        try:
            got = under()
            torch.cuda.synchronize()
        except RuntimeError as e:
            every[name] = "refused: " + (str(e).strip().splitlines() or ["?"])[0][:160]
            continue
        errs[name] = (got.float() - plain).abs().max().item()
        every[name] = timer.ms(under)
    timed = {k: v for k, v in every.items() if isinstance(v, float)}
    if not timed:
        fail(f"no SDPA backend took the yardstick's inputs: {every}")
    best = min(timed, key=timed.get)
    return best, timed[best], errs[best], every


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


K1_SANDBOX_LAYOUT = dict(B=2, Hq=4, Hkv=2, D=64, P=32, T=16, MAXP=4)


def k1_sandbox_case(gen, name, dtype, layout=K1_SANDBOX_LAYOUT):
    """The four sandbox cases of the reference's tests, plus rows with no
    valid token, on rows 0 and 1 of ``layout``; returns (args, expected
    oob)."""
    args = k1_inputs(gen, dtype=dtype, **layout)
    bt, perm, bitmap = args[3], args[5], args[7]
    B, P = bt.shape[0], perm.shape[0]
    rest = [0] * (B - 2)
    if name == "wild_pointer":
        bt[0, 0] = 999
        return args, [1, 0] + rest
    if name == "unsealed_page":
        perm[bt[1, 0]] = 0
        return args, [0, 1] + rest
    if name == "sandbox_off":
        perm.zero_()
        args[6] = torch.tensor([0, P, 0], dtype=torch.int32, device="cuda")
        return args, [0, 0] + rest
    if name == "foreign_bitmap":
        bitmap[bt[0, 0]] = 0
        return args, [1, 0] + rest
    # no valid token: a zero-length row and a fully rejected row
    args[4][:2] = torch.tensor([0, 20], dtype=torch.int32, device="cuda")
    bitmap[bt[1, :2].long()] = 0
    return args, [0, 2] + rest


K1_SANDBOX_CASES = ("wild_pointer", "unsealed_page", "sandbox_off", "foreign_bitmap",
                    "empty_row")


def k1_split_case(gen, name):
    """bf16 cases that reach the cluster split (up to 8 blocks a sequence,
    4 warps each; page i goes to rank i mod C); returns (args, expected
    oob or None)."""
    if name == "rejected_off_rank0":   # pages 1, 6 and 13 and an unsealed one
        args = k1_inputs(gen, B=2, P=128, MAXP=32, lens=[470, 300])
        bt, perm, bitmap = args[3], args[5], args[7]
        bitmap[bt[0, [1, 6, 13]].long()] = 0
        perm[bt[1, 3]] = 0
        return args, [3, 1]
    if name == "empty_ranks":          # one page beside thirty
        return k1_inputs(gen, B=2, P=128, MAXP=32, lens=[10, 471]), [0, 0]
    if name == "past_maxp":            # pages past MAXP are neither read nor counted
        return k1_inputs(gen, B=2, P=64, MAXP=8, lens=[8 * 16 + 37, 5]), [0, 0]
    qpk, D = (int(x) for x in re.fullmatch(r"qpk(\d+)_D(\d+)", name).groups())
    Hkv = 4 if qpk == 1 else 2
    return k1_inputs(gen, B=3, Hq=qpk * Hkv, Hkv=Hkv, D=D, P=128, MAXP=32), None


K1_SPLIT_CASES = ("rejected_off_rank0", "empty_ranks", "past_maxp", "qpk1_D64",
                  "qpk1_D128", "qpk8_D64", "qpk8_D128")
K1_TOL = {torch.float32: TOL_F32, torch.bfloat16: TOL_K1_BF16}


def phase_kernels(gen, main_lens):
    """K1 at the slice's shapes, the sandbox cases and the split cases; K2
    bitwise."""
    from repro_torch.kernels.scope_copy.kernel import gather_pages_cuda, scatter_pages_cuda
    from repro_torch.kernels.scope_copy.ref import gather_pages_ref, scatter_pages_ref

    # the slice shape at the main path's lengths: up to 30 in-use pages, so
    # the bf16 kernel splits each sequence over a cluster
    k1_err = check_k1(k1_inputs(gen, lens=main_lens), TOL_K1_BF16)
    k1_err = max(k1_err, check_k1(k1_inputs(gen, lens=main_lens, dtype=torch.float32),
                                  TOL_F32))
    for B, Hq, Hkv, D, T, dtype in ((2, 4, 1, 64, 8, torch.float32),
                                    (3, 8, 1, 128, 16, torch.float32),
                                    (4, 16, 4, 128, 16, torch.bfloat16),
                                    (2, 16, 2, 64, 8, torch.bfloat16)):
        err = check_k1(k1_inputs(gen, B=B, Hq=Hq, Hkv=Hkv, D=D, P=64, T=T,
                                 MAXP=6, dtype=dtype), K1_TOL[dtype])
        k1_err = max(k1_err, err)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name in K1_SANDBOX_CASES:
            args, expect = k1_sandbox_case(gen, name, dtype)
            cases[f"{name}_{str(dtype)[6:]}"] = check_k1(args, K1_TOL[dtype], expect_oob=expect)
    for name in K1_SPLIT_CASES:
        args, expect = k1_split_case(gen, name)
        cases[name] = check_k1(args, TOL_K1_BF16, expect_oob=expect)

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
        f"{k1_err:.3e}; sandbox and split cases "
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


def phase_serve(cfg, model, prompts, extra, max_new, label="phase 3 main path"):
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving import PoolConfig, ServeEngine

    dev = model.device
    eng = ServeEngine(cfg, model, PoolConfig(num_pages=512, page_tokens=16,
                                             max_pages_per_seq=64), max_active=8,
                      device=dev)
    free0 = eng.pool.heap.free_pages()
    paged_attention.launches = flash_prefill_cuda.launches = 0
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
    k3_launches = flash_prefill_cuda.launches
    results = [eng.result(r) for r in rids]

    L = cfg.num_layers
    if launches != L * eng.decode_steps:
        fail(f"paged_attention launched {launches} times, expected "
             f"{L} x {eng.decode_steps} decode steps")
    n_prefills = len(prompts) + len(extra)
    if k3_launches != L * n_prefills:
        fail(f"flash_prefill launched {k3_launches} times, expected "
             f"{L} x {n_prefills} prefills")
    if eng.oob_events:
        fail(f"{eng.oob_events} sandbox violations on the main path")
    if eng.pool.heap.free_pages() != free0 or eng.pool.stats()["sealed_pages"]:
        fail(f"pages or seals leaked: {eng.pool.stats()}")
    if any(len(s) != max_new for s in streams + results):
        fail("a stream or request came back short")
    step_ms = 1e3 * t_decode / stream_steps
    info = {
        "decode_steps": eng.decode_steps, "stream_steps": stream_steps,
        "launches": launches, "flash_prefill_launches": k3_launches,
        "peak_batch": eng.peak_stream_batch,
        "admit_8_prefills_s": t_admit, "decode_step_ms_b8": step_ms,
        "decode_tokens_per_s_b8": len(prompts) * stream_steps / t_decode,
    }
    log(f"{label}: {len(prompts)} streams + {len(extra)} requests, "
        f"{eng.decode_steps} decode steps, paged_attention launches {launches} "
        f"= {L} x {eng.decode_steps}, flash_prefill launches {k3_launches} = {L} x "
        f"{n_prefills} prefills, oob 0, all pages and seals returned; "
        f"decode step {step_ms:.2f} ms at B=8")
    return eng, streams + results, info


def profile_steps(step, dev, steps=4, watch=()):
    """``steps`` calls of ``step`` timed on the host clock, then the same
    under torch.profiler: device time by kernel against the host clock,
    and, for each name in ``watch``, the device time of the kernels whose
    name holds it and no longer watched name (``flash_prefill_bwd`` takes
    the backward's kernels from ``flash_prefill``).
    Only device events are summed: an operator's own entry also carries
    the time of the kernels it launched, which would count them twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run_steps():
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(dev)
        return 1e3 * (time.perf_counter() - t0) / steps

    wall_ms = run_steps()             # the same steps, no profiler attached
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = run_steps()
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]

    def watched(name):
        return max((w for w in watch if w in name), key=len, default=None)
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "profiled_wall_ms_per_step": prof_wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "launches_per_step": sum(c for _, _, c in kernels),
            "watch_ms_per_step": {w: sum(t for k, t, _ in kernels if watched(k) == w)
                                  for w in watch},
            "top_kernels_ms_per_step": [(k[:80], t) for k, t, _ in top]}


def profile_line(info) -> str:
    if not info["device_busy_ms_per_step"]:
        return "the profiler reported no device time; device busy share not measured"
    return (f"{info['wall_ms_per_step']:.2f} ms wall ({info['profiled_wall_ms_per_step']:.2f} "
            f"profiled), {info['device_busy_ms_per_step']:.2f} ms device busy, idle share "
            f"{info['device_idle_share']:.3f}, {info['launches_per_step']:.0f} launches; "
            f"top kernels "
            f"{[(k[:40], round(t, 3)) for k, t in info['top_kernels_ms_per_step']]}")


def phase_profile(eng, prompts, max_new, label="phase 5 where a decode step goes"):
    """Where a decode step's time goes: batched steps at B=8."""
    gens = [eng.generate_tokens(p, max_new) for p in prompts]
    for g in gens:
        next(g)                       # the prefill token; no step yet

    def step():
        with eng._decode_lock:
            eng.scheduler.step_batch()

    info = profile_steps(step, eng.device, watch=("paged_attention",))
    for g in gens:
        g.close()
    log(f"{label} (B=8, {info['steps']} steps, then the "
        f"same under the profiler): {profile_line(info)}; paged_attention "
        f"{info['watch_ms_per_step']['paged_attention']} ms per step")
    return info


def phase_dense(model, prompts, outputs, max_new, label="phase 4 dense-cache chain"):
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
    log(f"{label}: {agreed}/{len(prompts)} streams identical; "
        f"near-tie divergences {near_ties}")
    return {"identical_streams": agreed, "near_ties": near_ties}


def phase_transfer(cfg, gen, label="phase 6 cross-pod handoff"):
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
    if launches != {"gather_pages": 2, "scatter_pages": 2}:
        fail(f"transfer launches {launches}, expected 2 each (K and V, all layers at once)")
    idx_s, idx_d = torch.tensor(sp, device=dev), torch.tensor(dp, device=dev)
    for a, b in ((src.k, dst.k), (src.v, dst.v)):
        if not torch.equal(a[:, idx_s].view(torch.int16), b[:, idx_d].view(torch.int16)):
            fail("copied pages are not bitwise equal to the source")
        rest = torch.ones(pc.num_pages, dtype=torch.bool, device=dev)
        rest[idx_d] = False
        if b[:, rest].abs().sum().item() != 0:
            fail("the transfer wrote outside the destination pages")
    log(f"{label}: {n} pages x {L} layers x K,V = {moved} bytes, "
        f"bitwise equal, nothing written outside the destination pages; 2 gathers + 2 "
        f"scatters of {L * n} rows each in {1e3 * dt:.2f} ms")
    return src, sp, {"bytes": moved, "ms": 1e3 * dt, "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------
def k1_times(timer, args):
    """K1 on ``args`` (bf16): its time, its plain version's, the fastest
    SDPA backend's over the same KV gathered contiguous, host µs a call,
    and its bound (the valid K and V read once, q read, out written)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

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
    plain = paged_attention_ref(*args)[0].float()[:, :, None, :]
    backend, lib_ms, lib_err, every = sdpa_by_backend(timer, sdpa, plain)
    return {
        "ms": timer.ms(lambda: paged_attention_cuda(*args)),
        "plain_ms": timer.ms(lambda: paged_attention_ref(*args)),
        "library_ms": lib_ms, "library_backend": f"SDPA {backend}",
        "library_ms_by_backend": every,
        "host_us": timer.host_us(lambda: paged_attention_cuda(*args)),
        "library_host_us": timer.host_us(sdpa),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": kv_bytes + io_bytes,
        "library_max_abs_err_vs_plain": lib_err,
    }


def phase_times(gen, main_lens, src_pool, src_pages, card):
    from repro_torch.kernels.scope_copy.kernel import gather_pages_cuda, scatter_pages_cuda
    from repro_torch.kernels.scope_copy.ref import gather_pages_ref, scatter_pages_ref

    timer = Timer()
    out = {}

    # K1 at the main path's shapes: B=8, MAXP=64, ragged lengths as served
    out["paged_attention"] = k1_times(timer, k1_inputs(gen, lens=main_lens))

    # K2 at the transfer's shape: one launch over every layer's rows of the
    # flattened (L·P, W) pool, the ids as transfer_pages_cross_pod builds them
    L, P_ = src_pool.k.shape[:2]
    flat = src_pool.k.view(L * P_, -1)
    layer = P_ * torch.arange(L, dtype=torch.int32, device="cuda")
    pages = (torch.tensor(src_pages, dtype=torch.int32, device="cuda")[None, :]
             + layer[:, None]).reshape(-1)
    pages_l = pages.long()
    n, W = pages.numel(), flat.shape[1]
    nbytes = 2 * n * W * flat.element_size() + n * 4
    b_ms, b_by = bound_ms(nbytes, 0)
    wire = gather_pages_cuda(flat, pages)
    dst = torch.zeros_like(flat)
    out["gather_pages"] = {
        "ms": timer.ms(lambda: gather_pages_cuda(flat, pages)),
        "plain_ms": timer.ms(lambda: gather_pages_ref(flat, pages)),
        "library_ms": timer.ms(lambda: torch.index_select(flat, 0, pages_l)),
        "library_backend": "torch.index_select",
        "host_us": timer.host_us(lambda: gather_pages_cuda(flat, pages)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
    }
    out["scatter_pages"] = {
        "ms": timer.ms(lambda: scatter_pages_cuda(dst, pages, wire)),
        "plain_ms": timer.ms(lambda: scatter_pages_ref(dst, pages, wire)),
        "library_ms": timer.ms(lambda: dst.index_copy_(0, pages_l, wire)),
        "library_backend": "Tensor.index_copy_",
        "host_us": timer.host_us(lambda: scatter_pages_cuda(dst, pages, wire)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
    }
    for name in ("gather_pages", "scatter_pages"):
        out[name]["GB_per_s"] = nbytes / out[name]["ms"] / 1e6
    log("phase 7 times on %s (ms, median of %d, L2 flushed; host_us: µs to enqueue a "
        "call; gather/scatter over %d rows of %d bytes): %s; paged_attention's yardstick by "
        "SDPA backend: %s" % (
            card, SAMPLES, n, W * flat.element_size(), json.dumps(
                {k: {m: (round(v, 5) if isinstance(v, float) else v) for m, v in d.items()
                     if isinstance(v, (float, str))} for k, d in out.items()}),
            json.dumps(out["paged_attention"]["library_ms_by_backend"])))
    return out


# ---------------------------------------------------------------------------
# phases 8-11: mamba2-1.3b prefill (SSD kernel) and decode
# ---------------------------------------------------------------------------
def ssd_inputs(gen, B, S, H, P, N, dtype, decay="strong"):
    """``strong``: mamba2's init, A = -linspace(1, 16, H) and dt =
    softplus(N(0,1) + dt_bias) with dt_bias drawn as the model draws it,
    so 128-token chunk decays pass 88; ``weak``: small steps, so each
    chunk carries most of its state into the next."""
    dev = "cuda"
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    Bm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    Cm = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
    if decay == "strong":
        u = torch.rand((H,), generator=gen, device=dev)
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        dt_bias = torch.log(torch.expm1(dt0))
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device=dev) + dt_bias)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        dt = 0.005 + 0.045 * torch.rand((B, S, H), generator=gen, device=dev)
        A = -torch.linspace(0.1, 1.0, H, device=dev)
    return [x, dt, A, Bm, Cm]


def scaled_close(got, want, rel=TOL_K4):
    """|got - want| <= rel·max|want| + rel·|want|: fp32 summation order,
    scaled to the output."""
    return torch.allclose(got, want, rtol=rel, atol=rel * max(want.abs().max().item(), 1.0))


def check_k4(args, Q):
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref
    got = ssd_intra_chunk_cuda(*args, Q)
    torch.cuda.synchronize()
    err, scale = 0.0, 0.0
    for name, g, w in zip(("y_diag", "states", "decay"), got,
                          ssd_intra_chunk_ref(*args, Q)):
        if not torch.isfinite(g).all():
            fail(f"ssd_intra_chunk produced a non-finite {name}")
        if not scaled_close(g, w):
            fail(f"ssd_intra_chunk {name} disagrees with its plain version: max |err| "
                 f"{(g - w).abs().max().item():.3e}, max |ref| {w.abs().max().item():.3e}")
        err = max(err, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
    return err, scale


def phase_ssd_kernel(gen, card):
    """K4 against its plain version at mamba2-1.3b's batched prefill shape,
    in bf16 and f32, then a sweep of the chunked scan through the kernel
    against the recurrence and the plain chunked formulation."""
    from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_ref, ssd_sequential_ref
    from repro_torch.kernels.ssd.kernel import bf16_blocks_per_sm

    sh = SSD_SHAPE
    B, S, H, P, N, Q = (sh[k] for k in "BSHPNQ")
    args = ssd_inputs(gen, B, S, H, P, N, torch.bfloat16)
    chunk_decay = -(args[1] * args[2]).reshape(B, S // Q, Q, H).sum(2)
    hot_heads = int((chunk_decay > 88).flatten(0, 1).any(0).sum())
    if hot_heads == 0:
        fail("no head's chunk decay passes 88: the overflow case is not exercised")
    err, scale = {}, {}
    err["bf16"], scale["bf16"] = check_k4(args, Q)
    err["f32"], scale["f32"] = check_k4(ssd_inputs(gen, B, S, H, P, N, torch.float32), Q)
    ragged = {}
    for S_, chunk, H_, P_, N_ in K4_BF16_CASES:
        e, sc = check_k4(ssd_inputs(gen, 2, S_, H_, P_, N_, torch.bfloat16), chunk)
        ragged[f"S{S_} Q{min(chunk, S_)} H{H_} P{P_} N{N_}"] = e
        err["bf16"], scale["bf16"] = max(err["bf16"], e), max(scale["bf16"], sc)
    blocks = bf16_blocks_per_sm()
    if blocks < 2:
        fail(f"the bf16 SSD kernel fits {blocks} block(s) an SM, not 2")

    sweep_err = 0.0
    cases = [(S_, Q_, H_, P_, N_) for S_ in (16, 100, 300)
             for Q_, H_, P_, N_ in ((16, 8, 16, 16), (128, 64, 64, 128),
                                    (16, 64, 16, 128), (128, 8, 64, 16),
                                    (128, 12, 24, 17))]   # ragged head block and tiles
    for S_, Q_, H_, P_, N_ in cases:
        x, dt, A, Bm, Cm = ssd_inputs(gen, 2, S_, H_, P_, N_, torch.float32, "weak")
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
        y, s = ssd_chunked(x, dt, A, Bm, Cm, chunk=Q_)
        ys, ss = ssd_sequential_ref(x, dt, A, Bm, Cm)
        yc, sc = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=Q_)
        for got, want, plain in ((y, ys, yc), (s, ss, sc)):
            if not (torch.allclose(got, want, **TOL_SCAN) and scaled_close(got, plain)):
                fail(f"ssd_chunked on the card (S={S_} Q={Q_} H={H_} P={P_} N={N_}) "
                     f"disagrees: max |err| vs recurrence {(got - want).abs().max().item():.3e}"
                     f", vs plain chunked {(got - plain).abs().max().item():.3e}")
            sweep_err = max(sweep_err, (got - want).abs().max().item())
    x, dt, A, Bm, Cm = ssd_inputs(gen, 2, 300, 8, 64, 128, torch.float32, "weak")
    Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    _, s1 = ssd_chunked(x[:, :200], dt[:, :200], A, Bm[:, :200], Cm[:, :200], chunk=128)
    y2, s2 = ssd_chunked(x[:, 200:], dt[:, 200:], A, Bm[:, 200:], Cm[:, 200:],
                         chunk=128, init_state=s1)
    ys, ss = ssd_sequential_ref(x, dt, A, Bm, Cm)
    if not (torch.allclose(y2, ys[:, 200:], **TOL_SCAN) and torch.allclose(s2, ss, **TOL_SCAN)):
        fail("ssd_chunked on the card does not continue from a carried state")
    log(f"phase 8 ssd_intra_chunk vs plain on {card}: B={B} S={S} H={H} P={P} N={N} Q={Q}, "
        f"{hot_heads}/{H} heads with a chunk decay above 88 (max "
        f"{chunk_decay.max().item():.1f}); bf16 on the tensor cores ({blocks} blocks an SM) "
        f"there and at {len(ragged)} ragged shapes max |err| {err['bf16']:.3e} (max |ref| "
        f"{scale['bf16']:.3e}; by shape { {k: f'{v:.1e}' for k, v in ragged.items()} }), "
        f"f32 {err['f32']:.3e} (max |ref| {scale['f32']:.3e}); "
        f"atol {TOL_K4:g}·max|ref|, rtol {TOL_K4:g}; "
        f"{len(cases)}-case chunked sweep + continuation vs recurrence max |err| "
        f"{sweep_err:.3e} (atol/rtol {TOL_SCAN['atol']:g})")
    return {"max_abs_err": max(err.values()), "err": err, "max_abs_ref": scale,
            "bf16_ragged_max_abs_err": ragged, "bf16_blocks_per_sm": blocks,
            "hot_heads": hot_heads,
            "max_chunk_decay": chunk_decay.max().item(), "sweep_max_abs_err": sweep_err,
            "args": args}


def tree_cat(trees, dim):
    first = trees[0]
    return {k: tree_cat([t[k] for t in trees], dim) if isinstance(v, dict)
            else torch.cat([t[k] for t in trees], dim=dim) for k, v in first.items()}


def tree_clone(tree):
    """A copy of a cache tree: a decode step advances an SSM layer's state
    in place, so each run of the same step needs its own."""
    return {k: tree_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def first_step_ties(batched, alone, streams=None):
    """Rows where the batched step picks another token than the stream
    alone must be near-ties of the stream alone (top-2 gap within the
    bf16 tolerance): B=8 and B=1 run different GEMM kernels, whose bf16
    roundings part over 48 layers. A row joined from the wrong cache
    differs everywhere, not at a near-tie. ``streams`` names the rows
    (default 0, 1, ...)."""
    ties = []
    streams = range(len(batched)) if streams is None else streams
    for i, b, a in zip(streams, batched.argmax(-1).tolist(), alone.argmax(-1).tolist()):
        if b != a:
            top2 = torch.topk(alone[i], 2).values.tolist()
            gap = top2[0] - top2[1]
            if gap > TOL_BF16["atol"] + TOL_BF16["rtol"] * abs(top2[0]):
                fail(f"stream {i}: the batched first step picks token {b}, the stream alone "
                     f"{a}, with top-2 gap {gap:.4f} (no near-tie)")
            ties.append({"stream": i, "gap": gap})
    return ties


def phase_mamba_serve(cfg, model, prompts, max_new, card):
    """Each request prefilled alone (B=1) through the SSD kernel, the
    caches joined on the batch axis, then greedy decode at B=8."""
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    dev = model.device
    ssd_intra_chunk_cuda.launches = 0
    caches, first, prefill_ms = [], [], []
    for prompt in prompts:
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(toks)
        sync(dev)
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        if not torch.isfinite(logits).all():
            fail("mamba2 prefill produced non-finite logits")
        first.append(int(logits[0].argmax()))
        caches.append(cache)
    launches = ssd_intra_chunk_cuda.launches
    if launches != cfg.num_layers * len(prompts):
        fail(f"ssd_intra_chunk launched {launches} times, expected "
             f"{cfg.num_layers} x {len(prompts)} prefill calls")

    cache = tree_cat(caches, dim=1)       # leaves are (L, B, ...): batch is axis 1
    tok = torch.tensor(first, dtype=torch.int32, device=dev)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    alone = torch.cat([model.decode_step(tok[i:i + 1], pos[i:i + 1], caches[i])[0]
                       for i in range(len(prompts))])
    streams = [tok]
    sync(dev)
    t0 = time.perf_counter()
    for k in range(max_new):
        logits, cache = model.decode_step(streams[-1], pos + k, cache)
        if k == 0:
            batch_err = (logits - alone).abs().max().item()
            batch_ties = first_step_ties(logits, alone)
        streams.append(logits.argmax(-1).to(torch.int32))
    sync(dev)
    t_decode = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        fail("mamba2 decode produced non-finite logits")
    tokens = torch.stack(streams, dim=1).tolist()
    if [t[0] for t in tokens] != first:
        fail("a stream does not start from the argmax of its own prefill")
    step_ms = 1e3 * t_decode / max_new
    info = {"prompt_lens": [len(p) for p in prompts], "prefill_ms": prefill_ms,
            "launches": launches, "batched_vs_alone_max_abs_err": batch_err,
            "batched_vs_alone_near_ties": batch_ties,
            "decode_step_ms_b8": step_ms,
            "decode_tokens_per_s_b8": len(prompts) * max_new / t_decode}
    log(f"phase 9 mamba2 main path on {card}: {len(prompts)} prefills alone (lengths "
        f"{info['prompt_lens']}), ssd_intra_chunk launches {launches} = "
        f"{cfg.num_layers} x {len(prompts)}, prefill ms {[round(t, 1) for t in prefill_ms]}; "
        f"caches joined, {max_new} greedy steps at B={len(prompts)}: logits finite, first "
        f"step vs each stream alone: tokens equal but at near-ties {batch_ties}, max "
        f"|Δlogit| {batch_err:.3e}; decode step {step_ms:.2f} ms, "
        f"{info['decode_tokens_per_s_b8']:.1f} tokens/s")
    return cache, tok, pos, info


def phase_teacher_forced(model, cfg, rng, card, K=200, steps=8):
    """An fp32 copy of the model: each decode step's logits against a
    prefill of the prefix plus that token. The decode recurrence uses no
    kernel, so this holds the SSD kernel against an independent
    computation at full depth."""
    m32 = copy.deepcopy(model).float()
    dev = model.device
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, K + steps)).astype(
        np.int32)).to(dev)
    logits, cache = m32.prefill(toks[:, :K])
    errs = []
    for t in range(K, K + steps):
        ref, _ = m32.prefill(toks[:, : t + 1])
        logits, cache = m32.decode_step(toks[:, t], torch.full((2,), t, dtype=torch.int32,
                                                               device=dev), cache)
        errs.append((logits - ref).abs().max().item())
        if not torch.equal(logits.argmax(-1), ref.argmax(-1)):
            fail(f"fp32 decode step {t} picks another token than the prefill of its prefix")
    err = max(errs)
    if err > TOL_TF_MAX:
        fail(f"fp32 decode vs prefill max |err| {err:.3e} > {TOL_TF_MAX:g}")
    note = ("" if err <= TOL_TF else
            f"; above the reference's {TOL_TF:g} (tests/test_arch_smoke.py:113) at 48 layers")
    del m32
    torch.cuda.empty_cache()
    log(f"phase 10 fp32 teacher forcing on {card}: B=2, prefill {K} tokens (2 chunks, "
        f"padded), {steps} decode steps each against a prefill of its prefix: max |err| "
        f"{err:.3e} (atol {TOL_TF:g}), argmax equal{note}")
    return {"max_abs_err": err, "per_step": errs}


def k4_times(timer, ssd_args, Q):
    """K4 at one shape: its time, its plain version's, and its bound (the
    inputs read once; y_diag, the states and the decays written once in
    fp32; the products' operations at the tensor-core peak). No one
    PyTorch call computes it."""
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

    B, S, H, P = ssd_args[0].shape
    N = ssd_args[3].shape[-1]
    nc = S // Q
    nbytes = sum(t.numel() * t.element_size() for t in ssd_args) \
        + 4 * (B * S * H * P + B * nc * H * N * P + B * nc * H)
    flops = B * nc * (2 * Q * Q * N + H * (2 * Q * Q * P + 2 * Q * N * P))
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"ms": timer.ms(lambda: ssd_intra_chunk_cuda(*ssd_args, Q)),
            "plain_ms": timer.ms(lambda: ssd_intra_chunk_ref(*ssd_args, Q)),
            "library_ms": None, "library_backend": None, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops}


def phase_mamba_times(model, ssd_args, cache, tok, pos, card):
    timer = Timer()
    k4 = k4_times(timer, ssd_args, SSD_SHAPE["Q"])
    b_ms, b_by, nbytes, flops = (k4[k] for k in ("bound_ms", "bound_by", "bytes", "flops"))

    toks = torch.randint(1, model.cfg.vocab_size, (8, 512), dtype=torch.int32,
                         device=model.device)
    prefill_ms = timer.ms(lambda: model.prefill(toks))
    prefill_prof = profile_steps(lambda: model.prefill(toks), model.device, steps=2)
    state = {"tok": tok, "k": 0}

    def step():
        logits, _ = model.decode_step(state["tok"], pos + state["k"], cache)
        state["tok"] = logits.argmax(-1).to(torch.int32)
        state["k"] += 1

    prof = profile_steps(step, model.device)
    info = {"ssd_intra_chunk": k4, "prefill_8x512_ms": prefill_ms,
            "prefill_8x512_tokens_per_s": 8 * 512 / prefill_ms * 1e3,
            "prefill_8x512_profile": prefill_prof, "decode_profile_b8": prof}
    log(f"phase 11 mamba2 times on {card} (ms, median of {SAMPLES}, L2 flushed): "
        f"ssd_intra_chunk {k4['ms']:.4f}, plain {k4['plain_ms']:.4f}, bound "
        f"{b_ms:.4f} ({b_by}; {nbytes} bytes, {flops} flops), library none; prefill "
        f"8x512 {prefill_ms:.2f} ms ({info['prefill_8x512_tokens_per_s']:.0f} tokens/s, "
        f"{model.cfg.num_layers} K4 launches inside; 2 more, then 2 under the profiler: "
        f"{profile_line(prefill_prof)}); decode step at B=8 ({prof['steps']} steps, then the "
        f"same under the profiler): {profile_line(prof)}")
    return info


# ---------------------------------------------------------------------------
# phases 12-15: gemma3-12b prefill (flash-prefill kernel) and decode
# ---------------------------------------------------------------------------
def k3_inputs(gen, B, S, Hq, Hkv, D, dtype):
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def check_k3(gen, case, dtype):
    """K3 against its plain version at one (B, S, Hq, Hkv, D, window,
    softcap) case; returns (the case's name, max |err|)."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    B, S, Hq, Hkv, D, window, softcap = case
    q, k, v = k3_inputs(gen, B, S, Hq, Hkv, D, dtype)
    got = flash_prefill_cuda(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    want = flash_prefill_ref(q, k, v, window=window, softcap=softcap)
    name = f"B{B} S{S} {Hq}/{Hkv} D{D} w{window} cap{softcap:g} {str(dtype)[6:]}"
    if not torch.isfinite(got.float()).all():
        fail(f"flash_prefill produced a non-finite value ({name})")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL_K3[dtype]):
        fail(f"flash_prefill disagrees with its plain version ({name}): "
             f"max |err| {err:.3e}")
    return name, err


def phase_flash_kernel(gen, card):
    """K3 against its plain version at the main paths' shapes."""
    errs = dict(check_k3(gen, case, dtype) for case in K3_CASES
                for dtype in (torch.bfloat16, torch.float32))
    log(f"phase 12 flash_prefill vs plain on {card} (bf16 at atol "
        f"{TOL_K1_BF16['atol']:g}/rtol {TOL_K1_BF16['rtol']:g}, f32 at "
        f"{TOL_F32['atol']:g}/{TOL_F32['rtol']:g}): max |err| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }")
    return {"max_abs_err": max(errs.values()), "per_case": errs}


def ragged_prompts(rng, n, vocab, lo=1100, hi=3100, multiple=64):
    """``n`` prompts of lo..hi tokens, none a multiple of ``multiple``."""
    lens = []
    while len(lens) < n:
        s = int(rng.integers(lo, hi + 1))
        if s % multiple:
            lens.append(s)
    return [rng.integers(1, vocab, size=s).tolist() for s in lens]


def phase_gemma_serve(cfg, model, prompts, max_new, card):
    """Each request prefilled alone (B=1) through the flash-prefill
    kernel, the caches joined on the batch axis, then greedy decode."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda

    dev = model.device
    cache_len = max(len(p) for p in prompts) + max_new
    window = cfg.sliding_window
    flash_prefill_cuda.launches = 0
    caches, first, prefill_ms = [], [], []
    for prompt in prompts:
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(toks, cache_len=cache_len)
        sync(dev)
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        if not torch.isfinite(logits).all():
            fail("gemma3 prefill produced non-finite logits")
        first.append(int(logits[0].argmax()))
        caches.append(cache)
    launches = flash_prefill_cuda.launches
    if launches != cfg.num_layers * len(prompts):
        fail(f"flash_prefill launched {launches} times, expected "
             f"{cfg.num_layers} x {len(prompts)} prefill calls")
    for prompt, cache in zip(prompts, caches):
        S = len(prompt)
        for i, spec in enumerate(cfg.block_pattern()):
            cpos = cache[f"pos{i}"]["self"]["pos"]          # (L, 1, size)
            want = (torch.arange(S - window, S, device=dev) if spec.sliding_window
                    else torch.arange(S, device=dev))
            held = cpos.sort(-1).values[..., -len(want):]
            if spec.sliding_window and cpos.shape[-1] != window:
                fail(f"layer position {i}: ring of {cpos.shape[-1]} slots, not {window}")
            if not torch.equal(held, want.to(cpos.dtype).expand_as(held)):
                fail(f"layer position {i} of a {S}-token prefill does not hold "
                     f"positions {int(want[0])}..{S - 1}")

    cache = tree_cat(caches, dim=1)       # leaves are (L, B, ...): batch is axis 1
    tok = torch.tensor(first, dtype=torch.int32, device=dev)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    alone = torch.cat([model.decode_step(tok[i:i + 1], pos[i:i + 1], caches[i])[0]
                       for i in range(len(prompts))])
    del caches
    streams = [tok]
    sync(dev)
    t0 = time.perf_counter()
    for k in range(max_new):
        logits, cache = model.decode_step(streams[-1], pos + k, cache)
        if not torch.isfinite(logits).all():
            fail(f"gemma3 decode step {k} produced non-finite logits")
        if k == 0:
            batch_err = (logits - alone).abs().max().item()
            batch_ties = first_step_ties(logits, alone)
        streams.append(logits.argmax(-1).to(torch.int32))
    sync(dev)
    t_decode = time.perf_counter() - t0
    step_ms = 1e3 * t_decode / max_new
    B = len(prompts)
    info = {"prompt_lens": [len(p) for p in prompts], "cache_len": cache_len,
            "prefill_ms": prefill_ms, "launches": launches,
            "batched_vs_alone_max_abs_err": batch_err,
            "batched_vs_alone_near_ties": batch_ties,
            f"decode_step_ms_b{B}": step_ms,
            f"decode_tokens_per_s_b{B}": B * max_new / t_decode}
    log(f"phase 13 gemma3 main path on {card}: {B} prefills alone (lengths "
        f"{info['prompt_lens']}, cache_len {cache_len}; every local ring of {window} "
        f"slots wrapped and holds the last {window} positions), flash_prefill launches "
        f"{launches} = {cfg.num_layers} x {B}, prefill ms "
        f"{[round(t, 1) for t in prefill_ms]}; caches joined, {max_new} greedy steps at "
        f"B={B}: logits finite, first step vs each stream alone: tokens equal but at "
        f"near-ties {batch_ties}, max |Δlogit| {batch_err:.3e}; decode step {step_ms:.2f} "
        f"ms, {info[f'decode_tokens_per_s_b{B}']:.1f} tokens/s")
    return info


def phase_gemma_teacher_forced(model, cfg, rng, card, blocks=2, K=1200, steps=8):
    """An fp32 copy of gemma3's first ``blocks`` super-blocks (local and
    global layers): each decode step (``_attend`` over the ring and dense
    caches) against a prefill of the prefix plus that token through the
    flash-prefill kernel in fp32, past the 1024-token window."""
    from dataclasses import replace

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.models import build_model

    dev = model.device
    cfg_s = replace(cfg, num_layers=blocks * len(cfg.block_pattern()))
    m32 = build_model(cfg_s).init(torch.Generator(dev).manual_seed(1), device=dev)
    with torch.no_grad():
        for name, p in m32.named_parameters():
            src = model.get_parameter(name)
            p.copy_(src[:blocks] if name.startswith("stack.") else src)
    m32 = m32.float()
    gb = sum(p.numel() * p.element_size() for p in m32.parameters()) / 1e9
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, K + steps)).astype(
        np.int32)).to(dev)
    n0 = flash_prefill_cuda.launches
    logits, cache = m32.prefill(toks[:, :K], cache_len=K + steps)
    errs = []
    for t in range(K, K + steps):
        ref, _ = m32.prefill(toks[:, : t + 1])
        logits, cache = m32.decode_step(toks[:, t], torch.full((2,), t, dtype=torch.int32,
                                                               device=dev), cache)
        errs.append((logits - ref).abs().max().item())
        if not torch.equal(logits.argmax(-1), ref.argmax(-1)):
            fail(f"fp32 decode step {t} picks another token than the prefill of its prefix")
    if flash_prefill_cuda.launches - n0 != cfg_s.num_layers * (steps + 1):
        fail("the fp32 prefills did not all run the flash-prefill kernel")
    err = max(errs)
    if err > TOL_TF_MAX:
        fail(f"fp32 decode vs prefill max |err| {err:.3e} > {TOL_TF_MAX:g}")
    note = ("" if err <= TOL_TF else
            f"; above the reference's {TOL_TF:g} (tests/test_arch_smoke.py:113)")
    del m32, cache
    torch.cuda.empty_cache()
    log(f"phase 14 fp32 teacher forcing on {card}: first {cfg_s.num_layers} layers "
        f"({gb:.1f} GB in fp32), B=2, prefill {K} tokens (past the {cfg.sliding_window} "
        f"window), {steps} decode steps each against a kernel prefill of its prefix: max "
        f"|err| {err:.3e} (atol {TOL_TF:g}), argmax equal{note}")
    return {"layers": cfg_s.num_layers, "max_abs_err": err, "per_step": errs}


def k3_pairs(S, window):
    """(query, key) pairs the causal window admits at positions 0..S-1."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def k3_times(timer, gen, B, S, Hq, Hkv, D, window):
    """K3 at one bf16 shape: its time, its plain version's, the fastest
    SDPA backend's (causal, or a band mask for a window), host µs a call,
    and its bound (q, k, v read and out written once; 4·D·Hq operations a
    visible pair at the tensor-core peak)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref

    q, k, v = k3_inputs(gen, B, S, Hq, Hkv, D, torch.bfloat16)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())     # q, k, v read, out written
    flops = 4 * D * Hq * B * k3_pairs(S, window)
    b_ms, b_by = bound_ms(nbytes, flops)
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if window:
        i = torch.arange(S, device="cuda")
        band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band,
                                                      enable_gqa=True)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                      enable_gqa=True)
    plain = flash_prefill_ref(q, k, v, window=window).float().transpose(1, 2)
    backend, lib_ms, lib_err, every = sdpa_by_backend(timer, sdpa, plain)
    del plain
    info = {
        "ms": timer.ms(lambda: flash_prefill_cuda(q, k, v, window=window)),
        "plain_ms": timer.ms(lambda: flash_prefill_ref(q, k, v, window=window)),
        "library_ms": lib_ms, "library_backend": f"SDPA {backend}",
        "library_ms_by_backend": every,
        "host_us": timer.host_us(lambda: flash_prefill_cuda(q, k, v, window=window)),
        "library_host_us": timer.host_us(sdpa),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        "pairs": B * k3_pairs(S, window), "library_max_abs_err_vs_plain": lib_err,
    }
    info["TFLOP_per_s"] = flops / info["ms"] / 1e9
    return info


def phase_gemma_times(model, gen, card):
    timer = Timer()
    out = {}
    for name, shape in K3_TIMED.items():
        out[name] = k3_times(timer, gen, *shape)
    torch.cuda.empty_cache()

    toks = torch.randint(1, model.cfg.vocab_size, (1, 4096), dtype=torch.int32,
                         device=model.device)
    prefill_ms = timer.ms(lambda: model.prefill(toks), samples=5, warmup=1)
    prof = profile_steps(lambda: model.prefill(toks), model.device, steps=2,
                         watch=("flash_prefill",))
    info = {"flash_prefill": out, "prefill_1x4096_ms": prefill_ms,
            "prefill_1x4096_tokens_per_s": 4096 / prefill_ms * 1e3,
            "prefill_1x4096_profile": prof}
    share = (prof["watch_ms_per_step"]["flash_prefill"] / prof["device_busy_ms_per_step"]
             if prof["device_busy_ms_per_step"] else None)
    info["flash_prefill_share_of_busy"] = share
    log(f"phase 15 gemma3 times on {card} (ms, median of {SAMPLES}, L2 flushed): "
        + "; ".join(f"flash_prefill {n} {d['ms']:.4f} ({d['TFLOP_per_s']:.1f} TFLOP/s), plain "
                    f"{d['plain_ms']:.4f}, {d['library_backend']} {d['library_ms']:.4f} (max "
                    f"|Δ| vs plain {d['library_max_abs_err_vs_plain']:.1e}; by backend "
                    f"{json.dumps(d['library_ms_by_backend'])}), bound {d['bound_ms']:.4f} "
                    f"({d['bound_by']}), host µs a call {d['host_us']:.1f} (SDPA "
                    f"{d['library_host_us']:.1f})" for n, d in out.items())
        + f"; prefill 1x4096 {prefill_ms:.2f} ms (median of 5, "
        f"{info['prefill_1x4096_tokens_per_s']:.0f} tokens/s; 2 more, then 2 under the "
        f"profiler: {profile_line(prof)}; flash_prefill "
        f"{prof['watch_ms_per_step']['flash_prefill']:.2f} ms "
        f"per prefill, share of busy {share if share is None else round(share, 3)})")
    return info


# ---------------------------------------------------------------------------
# phase 16: the RPC plane (the decode service over the ring, byref handoff)
# ---------------------------------------------------------------------------
def near_tie(model, prompt, prefix) -> bool:
    """Phase 4's rule at one step: after ``prompt + prefix`` the top-2 gap
    of the dense chain's logits is within the bf16 tolerance of the top."""
    toks = torch.tensor([prompt + prefix], dtype=torch.int32, device=model.device)
    top2 = torch.topk(model.prefill(toks)[0][0], 2).values.tolist()
    return top2[0] - top2[1] <= TOL_BF16["atol"] + TOL_BF16["rtol"] * abs(top2[0])


def divergences(model, prompts, want, got, what):
    """Where ``got`` differs from ``want``: the first mismatch of each row
    must sit at a near-tie of the dense chain."""
    differ = []
    for n, (prompt, a, b) in enumerate(zip(prompts, want, got)):
        if a == b:
            continue
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None or not near_tie(model, prompt, a[:k]):
            fail(f"{what} {n} differs at step {k} without a near-tie: {b} vs {a}")
        differ.append({"row": n, "step": k})
    return differ


def stream_clients(eng, prompts, max_new, pid0, client_sleep_us=None, pod=None,
                   transport="cxl"):
    """One thread a prompt, each with its own stub (pid ``pid0 + i``, in
    ``pod`` when given), streaming from the engine's decode service over
    ``transport``. ``client_sleep_us`` pins the clients' chunk polling to
    naps of that length (the default policy spins, yielding the GIL).
    Returns the token lists and each stream's seconds to its first token,
    from the barrier that releases all clients together."""
    from repro_torch.core.channel import BusyWaitPolicy
    from repro_torch.serving import DecodeService

    outs, first_s, errors = [None] * len(prompts), [None] * len(prompts), []
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            stub = eng.router.stub(eng.endpoint_name, DecodeService, pid=pid0 + i, pod=pod)
            if stub.connection.transport != transport:
                raise RuntimeError(f"stub rode {stub.connection.transport!r}, "
                                   f"not {transport!r}")
            if client_sleep_us is not None:
                stub.connection.target.wait_policy = BusyWaitPolicy(
                    fixed_sleep_us=client_sleep_us)
            barrier.wait(timeout=60)
            t0 = time.perf_counter()
            toks = []
            for tok in stub.generate_stream.stream(prompts[i], max_new, timeout=600.0):
                if not toks:
                    first_s[i] = time.perf_counter() - t0
                toks.append(tok)
            outs[i] = toks
        except Exception as e:   # reported below
            errors.append((i, repr(e)))
            barrier.abort()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            fail("a client stream thread did not finish")
    if errors:
        fail(f"client streams failed: {errors}")
    return outs, first_s


def handoff_bytes_for(pages: int) -> int:
    """The marshalled (rid, prompt_len, page ids) tuple: a 3-value vec
    (8 + 3 x 16 B) and a vec of ``pages`` values (8 + 16 B each)."""
    return 64 + 16 * pages


def time_handoffs(eng, n, prompt_tokens=512, max_new=MAX_NEW):
    """``n`` same-pod handoffs (seal + ``stub.attach`` over the ring) of a
    synthetic request, each timed around ``_handoff``; the request is
    retired between calls. Returns (median µs, bytes a handoff)."""
    from repro_torch.serving import Request

    samples, sizes = [], set()
    for _ in range(n):
        req = Request(eng._mint_rid(), list(range(1, prompt_tokens + 1)), max_new)
        req.pages = eng.pool.alloc_seq(prompt_tokens + max_new, eng.conn_id)
        eng._pending_attach[req.rid] = req
        b0 = eng.handoff_bytes
        t0 = time.perf_counter()
        eng._handoff(req)
        samples.append(time.perf_counter() - t0)
        sizes.add(eng.handoff_bytes - b0)
        with eng._decode_lock:
            eng.active.remove(req)
        eng.pool.complete_and_release(req.seal_idxs, eng.client_pid, batched=False)
        eng.pool.free_seq(req.pages)
    if sizes != {handoff_bytes_for(len(req.pages))}:
        fail(f"handoff sizes {sizes}, expected {handoff_bytes_for(len(req.pages))}")
    return 1e6 * float(np.median(samples)), sizes.pop()


def phase_rpc(cfg, model, prompts, submits, phase3_streams, phase3_step_ms, max_new, card):
    """The decode service over the shared-memory ring at full width: 8
    threaded client streams, 3 submits whose handoffs cross the ring, a
    cross-pod ``attach_remote`` through the fallback link, and the times."""
    import repro_torch.serving.kv_pool as kv_pool
    from repro_torch.core.fallback import COMPLETION_WORD_BYTES
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.scope_copy import gather_pages, scatter_pages
    from repro_torch.serving import DecodeService, PagedKVPool, PoolConfig, PoolPages, \
        ServeEngine, prefill_kv

    dev, L = model.device, cfg.num_layers
    counters = (paged_attention, flash_prefill_cuda, gather_pages, scatter_pages)

    def zero():
        for c in counters:
            c.launches = 0

    def read(steps0):
        got = {"paged_attention": paged_attention.launches,
               "flash_prefill": flash_prefill_cuda.launches,
               "gather_pages": gather_pages.launches,
               "scatter_pages": scatter_pages.launches,
               "decode_steps": eng.decode_steps - steps0}
        if got["paged_attention"] != L * got["decode_steps"]:
            fail(f"paged_attention launched {got['paged_attention']} times, expected "
                 f"{L} x {got['decode_steps']} decode steps")
        return got

    pc = PoolConfig(num_pages=512, page_tokens=16, max_pages_per_seq=64)
    eng = ServeEngine(cfg, model, pc, max_active=8, serve_threaded=True, device=dev)
    thread = eng.serve_loop._thread
    free0 = eng.pool.heap.free_pages()
    info, launches = {}, {}
    try:
        # 1. eight client threads stream phase 3's prompts over the ring;
        # the server thread prefills (K3) and steps the batch (K1). Twice:
        # clients on the default policy (spinning on the GIL), then clients
        # polling with 200 µs naps (benchmarks/serve.py's client policy)
        step_log = []
        step_batch = eng.scheduler.step_batch

        def logged_step():
            t0 = time.perf_counter()
            b = step_batch()
            step_log.append((t0, time.perf_counter(), b))
            return b

        eng.scheduler.step_batch = logged_step
        info["streams"] = {}
        for run, (pid0, client_sleep_us) in (("spinning_clients", (30, None)),
                                             ("polling_200us_clients", (40, 200.0))):
            step_log.clear()
            zero()
            steps0 = eng.decode_steps
            sync(dev)
            t0 = time.perf_counter()
            outs, first_s = stream_clients(eng, prompts, max_new, pid0, client_sleep_us)
            sync(dev)
            t_streams = time.perf_counter() - t0
            launches[run] = got = read(steps0)
            if got["flash_prefill"] != L * len(prompts):
                fail(f"streams: flash_prefill launched {got['flash_prefill']} times, "
                     f"expected {L} x {len(prompts)} prefills")
            if eng.oob_events:
                fail(f"{eng.oob_events} sandbox violations over the ring")
            differ = divergences(model, prompts, phase3_streams, outs,
                                 "stream over the ring, against phase 3's,")
            full = [(t0, t1) for t0, t1, b in step_log if b == len(prompts)]
            if not full:
                fail(f"no decode step ran all {len(prompts)} streams together")
            info["streams"][run] = {
                "wall_s": t_streams, "decode_steps": got["decode_steps"],
                "steps_at_b8": len(full), "near_tie_divergences": differ,
                # wall per batched step over the B=8 stretch: the ring's chunk
                # traffic and the client threads' pulls included, as phase 3's
                # in-process quotient includes its pulls
                "decode_step_ms_b8": 1e3 * (full[-1][1] - full[0][0]) / len(full),
                "step_batch_ms_median_b8": 1e3 * float(np.median([b - a for a, b in full])),
                "ttft_ms": [1e3 * t for t in first_s], "tokens": outs,
            }
        del eng.scheduler.step_batch

        # 2. three submits: prefill on this thread, ``stub.attach`` crosses
        # to the serving thread, batched decode here
        per_req = []
        handoff = eng._handoff

        def measured(req):
            b0 = eng.handoff_bytes
            handoff(req)
            per_req.append((len(req.prompt), len(req.pages), eng.handoff_bytes - b0))

        eng._handoff = measured
        zero()
        steps0 = eng.decode_steps
        rids = [eng.submit(p, max_new) for p in submits]
        eng.run_until_drained(timeout=600)
        launches["submits"] = got = read(steps0)
        del eng._handoff
        if got["flash_prefill"] != L * len(submits):
            fail(f"submits: flash_prefill launched {got['flash_prefill']} times, "
                 f"expected {L} x {len(submits)}")
        if any(len(eng.result(r)) != max_new for r in rids):
            fail("a submitted request came back short")
        if any(b != handoff_bytes_for(n) or b >= 200 for _, n, b in per_req):
            fail(f"handoffs (prompt tokens, pages, bytes): {per_req}")
        kv_per_token = 2 * L * cfg.num_kv_heads * cfg.head_dim * 2
        info["submits"] = [{"prompt_tokens": t, "pages": n, "handoff_bytes": b,
                            "kv_bytes": t * kv_per_token, "ratio": t * kv_per_token / b}
                           for t, n, b in per_req]

        # 3. handoff times: threaded, then inline once the thread stops
        us_threaded, hb = time_handoffs(eng, 50)
        eng.shutdown()
        if thread.is_alive():
            fail("the serving thread is still alive after shutdown()")
        us_inline, _ = time_handoffs(eng, 50)
        info["handoff_us"] = {"threaded": us_threaded, "inline": us_inline,
                              "bytes_33_pages": hb}

        # 4. attach_remote of one prompt in pod (pointer) and from pod
        # ``ppod`` (fallback link, one bulk page migration); the cross-pod
        # round runs twice: timed on the host clock, then under
        # torch.profiler for the K2 kernels' device time
        from torch.profiler import ProfilerActivity, profile

        prompt = prompts[0]
        src = PagedKVPool(eng.orch, cfg, pc, 21, pod="ppod", device=dev)
        far = eng.router.stub(eng.endpoint_name, DecodeService, pid=21, pod="ppod")
        if far.connection.transport != "fallback":
            fail(f"cross-pod stub rode {far.connection.transport!r}, not the fallback link")
        link = far.connection.target.link
        put_deltas = []
        put_bytes = link.put_bytes

        def put(nbytes, to):
            b0 = link.bytes_moved
            put_bytes(nbytes, to)
            put_deltas.append(link.bytes_moved - b0)

        link.put_bytes = put
        rounds = (("same_pod", eng.pool, eng.stub, eng.conn_id),
                  ("cross_pod", src, far, 21), ("cross_pod_profiled", src, far, 21))
        tokens, moved, t_handoff, k2_launches = {}, {}, {}, {}
        zero()
        steps0 = eng.decode_steps
        link0 = link.bytes_moved
        try:
            for rid, (where, pool, stub, owner) in enumerate(rounds, start=9000):
                pages = pool.alloc_seq(len(prompt) + max_new, owner)
                toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
                logits, k, v = prefill_kv(model, toks)
                pool.write_prefill(k[:, 0], v[:, 0], pages, len(prompt))
                first = int(logits[0].argmax())
                pp = PoolPages(pool, pages)
                g0, s0 = gather_pages.launches, scatter_pages.launches
                sync(dev)
                if where == "cross_pod_profiled":
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        stub.attach_remote(rid, prompt, first, max_new, pp,
                                           timeout=120.0, inline=True)
                        sync(dev)
                else:
                    t0 = time.perf_counter()
                    stub.attach_remote(rid, prompt, first, max_new, pp, timeout=120.0,
                                       inline=True)
                    sync(dev)
                    t_handoff[where] = time.perf_counter() - t0
                k2_launches[where] = (gather_pages.launches - g0,
                                      scatter_pages.launches - s0)
                moved[where] = (pp.last_moved_bytes, len(pages))
                eng.run_until_drained(timeout=600)
                tokens[where] = eng.result(rid)
                if pool is src:
                    src.free_seq(pages)
        finally:
            del link.put_bytes
        launches["attach_remote"] = got = read(steps0)
        if k2_launches != {"same_pod": (0, 0), "cross_pod": (2, 2),
                           "cross_pod_profiled": (2, 2)}:
            fail(f"gather/scatter launches by round {k2_launches}, expected 2 + 2 "
                 f"a cross-pod transfer and none in pod")
        if got["flash_prefill"] != len(rounds) * L:
            fail(f"attach_remote: flash_prefill launched {got['flash_prefill']} times")
        n_moved, n_pages = moved["cross_pod"]
        want = n_pages * src.page_bytes
        if moved["same_pod"][0] != 0 or moved["cross_pod_profiled"][0] != want or not (
                n_moved == want and src.byref_bytes_out == eng.pool.byref_bytes_in
                == 2 * want):
            fail(f"byref bytes: moved {moved}, want {want} a transfer, out "
                 f"{src.byref_bytes_out}, in {eng.pool.byref_bytes_in}")
        if put_deltas != [want + COMPLETION_WORD_BYTES] * 2 or link.n_puts != 2:
            fail(f"the link's puts moved {put_deltas} bytes, expected one of "
                 f"{want} + {COMPLETION_WORD_BYTES} a transfer")
        if not tokens["cross_pod"] == tokens["cross_pod_profiled"] == tokens["same_pod"]:
            fail(f"migrated KV decodes differently: {tokens}")
        k2 = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
              if "pages_kernel" in e.key and e.self_device_time_total > 0]
        k2_ms = sum(t for _, t in k2) if k2 else None
        info["cross_pod"] = {
            "pages": n_pages, "moved_bytes": n_moved,
            "link_bytes_two_rounds": link.bytes_moved - link0,
            "handoff_ms": 1e3 * t_handoff["cross_pod"], "k2_ms": k2_ms,
            "k2_kernels": k2,
            "host_ms": (1e3 * t_handoff["cross_pod"] - k2_ms) if k2_ms else None,
            "same_pod_handoff_ms": 1e3 * t_handoff["same_pod"],
        }
        if eng.pool.heap.free_pages() != free0 or eng.pool.stats()["sealed_pages"]:
            fail(f"pages or seals leaked over the ring: {eng.pool.stats()}")
    finally:
        eng.shutdown()
    if thread.is_alive():
        fail("the serving thread is still alive after shutdown()")
    info["launches"] = launches
    h, c = info["handoff_us"], info["cross_pod"]
    for run, st in info["streams"].items():
        got = launches[run]
        log(f"phase 16 RPC plane on {card} ({run}): 8 client threads streamed "
            f"{len(prompts)} x {max_new} tokens over the ring in {st['decode_steps']} decode "
            f"steps ({st['steps_at_b8']} at B=8), paged_attention {got['paged_attention']} = "
            f"{L} x {st['decode_steps']}, flash_prefill {got['flash_prefill']} = {L} x "
            f"{len(prompts)}, oob 0; {len(st['near_tie_divergences'])} streams differ from "
            f"phase 3, each at a near-tie; threaded decode step {st['decode_step_ms_b8']:.2f} "
            f"ms at B=8 (step_batch alone {st['step_batch_ms_median_b8']:.2f} ms) vs phase "
            f"3's {phase3_step_ms:.2f} ms in process")
    log(f"phase 16 handoffs on {card}: 3 submits of "
        f"{[d['prompt_tokens'] for d in info['submits']]} tokens carried "
        f"{[d['handoff_bytes'] for d in info['submits']]} bytes for "
        f"{[d['kv_bytes'] for d in info['submits']]} bytes of KV (ratios "
        f"{[round(d['ratio']) for d in info['submits']]}); a 33-page handoff "
        f"({h['bytes_33_pages']} B) takes {h['inline']:.1f} µs inline and "
        f"{h['threaded']:.1f} µs threaded (median of 50); all pages and seals back, "
        f"serving thread stopped")
    k2_text = "K2 not in the profile" if c["k2_ms"] is None else (
        f"K2 {c['k2_ms']:.4f} ms of device time + host {c['host_ms']:.2f} ms")
    log(f"phase 16 cross-pod attach_remote on {card}: {c['pages']} pages, "
        f"{c['moved_bytes']} bytes in 2 gathers + 2 scatters a transfer, one put of "
        f"{c['moved_bytes']} + {COMPLETION_WORD_BYTES} bytes a transfer on the link; "
        f"handoff {c['handoff_ms']:.2f} ms = {k2_text} (same pod "
        f"{c['same_pod_handoff_ms']:.2f} ms); tokens equal the same-pod generation exactly")
    return info


# ---------------------------------------------------------------------------
# phase 40: the RPC plane's asynchronous surface across pods (fallback link)
# ---------------------------------------------------------------------------
def link_totals(router) -> dict:
    """Every pod pair's LinkPool counters, summed."""
    out = {}
    for pool in router._link_pools.values():
        for k, v in pool.stats().items():
            out[k] = out.get(k, 0) + v
    return out


def phase_cross_pod(cfg, model, prompts, rpc, max_new, card, n=40):
    """(a) eight client threads in pod ``pod9`` stream from a threaded
    engine in ``pod0`` over the fallback link; (b) three ``attach_remote``
    futures from pod ``ppod`` settled by one ``gather``; (c) the link's
    counters, step and first-token times, the flushes' host time."""
    from repro_torch.core.fallback import LinkPool
    from repro_torch.core.marshal import gather
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.scope_copy import gather_pages, scatter_pages
    from repro_torch.serving import DecodeService, PagedKVPool, PoolConfig, PoolPages, \
        ServeEngine, prefill_kv

    dev, L = model.device, cfg.num_layers
    counters = (paged_attention, flash_prefill_cuda, gather_pages, scatter_pages)
    in_pod = rpc["streams"]["spinning_clients"]

    def zero():
        for c in counters:
            c.launches = 0

    def read(steps0):
        got = {"paged_attention": paged_attention.launches,
               "flash_prefill": flash_prefill_cuda.launches,
               "gather_pages": gather_pages.launches,
               "scatter_pages": scatter_pages.launches,
               "decode_steps": eng.decode_steps - steps0}
        if got["paged_attention"] != L * got["decode_steps"]:
            fail(f"phase {n}: paged_attention launched {got['paged_attention']} times, "
                 f"expected {L} x {got['decode_steps']} decode steps")
        return got

    def leaks(what):
        if eng.pool.heap.free_pages() != free0 or eng.pool.stats()["sealed_pages"]:
            fail(f"phase {n} {what}: pages or seals leaked: {eng.pool.stats()}")
        held = [(k, int(l.replica[0].perm.sum()))
                for k, pool in eng.router._link_pools.items() for l in pool.links
                if l.replica[0].perm.any()]
        if held:
            fail(f"phase {n} {what}: link pages still sealed: {held}")

    # the flushes' host time: every LinkPool stripe flush, on the host clock
    flush_s = []
    flush_stripe = LinkPool.flush_stripe

    def timed_flush(self, idx):
        t0 = time.perf_counter()
        try:
            return flush_stripe(self, idx)
        finally:
            flush_s.append(time.perf_counter() - t0)

    pc = PoolConfig(num_pages=512, page_tokens=16, max_pages_per_seq=64)
    eng = ServeEngine(cfg, model, pc, max_active=8, serve_threaded=True, pod="pod0",
                      device=dev)
    thread = eng.serve_loop._thread
    free0 = eng.pool.heap.free_pages()
    info, launches = {}, {}
    LinkPool.flush_stripe = timed_flush
    try:
        # (a) cross-pod streams: each client's pulls run the prefill (K3)
        # and the batched steps (K1) of the one shared StreamScheduler
        step_log = []
        step_batch = eng.scheduler.step_batch

        def logged_step():
            t0 = time.perf_counter()
            b = step_batch()
            step_log.append((t0, time.perf_counter(), b))
            return b

        eng.scheduler.step_batch = logged_step
        zero()
        steps0 = eng.decode_steps
        sync(dev)
        t0 = time.perf_counter()
        outs, first_s = stream_clients(eng, prompts, max_new, 60, pod="pod9",
                                       transport="fallback")
        sync(dev)
        wall = time.perf_counter() - t0
        del eng.scheduler.step_batch
        launches["streams"] = got = read(steps0)
        if got["flash_prefill"] != L * len(prompts):
            fail(f"phase {n} (a): flash_prefill launched {got['flash_prefill']} times, "
                 f"expected {L} x {len(prompts)}")
        if eng.oob_events:
            fail(f"phase {n} (a): {eng.oob_events} sandbox violations")
        if any(len(o) != max_new for o in outs):
            fail(f"phase {n} (a): a stream came back short: {[len(o) for o in outs]}")
        differ = divergences(model, prompts, in_pod["tokens"], outs, "cross-pod stream")
        full = [(a, b) for a, b, bs in step_log if bs == len(prompts)]
        if not full:
            fail(f"phase {n} (a): no decode step ran all {len(prompts)} streams together")
        leaks("(a)")
        info["streams"] = {
            "wall_s": wall, "decode_steps": got["decode_steps"], "steps_at_b8": len(full),
            "near_tie_divergences": differ,
            "decode_step_ms_b8": 1e3 * (full[-1][1] - full[0][0]) / len(full),
            "step_batch_ms_median_b8": 1e3 * float(np.median([b - a for a, b in full])),
            "ttft_ms": [1e3 * t for t in first_s],
            "in_pod_ttft_ms": in_pod["ttft_ms"],
            "in_pod_decode_step_ms_b8": in_pod["decode_step_ms_b8"],
            "link": link_totals(eng.router), "tokens": outs,
        }

        # (b) three prefills in pod ``ppod``, posted as attach_remote futures
        # on one stub and settled by one gather: one staged flight, the KV
        # moved by K2 when each future resolves its PoolPages argument
        picks = prompts[:3]
        zero()
        steps0 = eng.decode_steps
        gens = [eng.generate_tokens(p, max_new) for p in picks]
        want = [[] for _ in picks]
        for _ in range(max_new):                  # in lockstep: one batch
            for w, g in zip(want, gens):
                w.append(next(g))
        for g in gens:
            if next(g, None) is not None:
                fail(f"phase {n} (b): an in-pod stream ran past {max_new} tokens")
        info["in_pod_launches"] = read(steps0)    # not across pods: a path of its own
        src = PagedKVPool(eng.orch, cfg, pc, 21, pod="ppod", device=dev)
        far = eng.router.stub(eng.endpoint_name, DecodeService, pid=21, pod="ppod")
        if far.connection.transport != "fallback":
            fail(f"phase {n} (b): the stub rode {far.connection.transport!r}")
        target = far.connection.target
        link0 = target.stats()
        zero()
        steps0 = eng.decode_steps
        futs, src_pages, k2 = [], [], []
        flush_s.clear()
        t0 = time.perf_counter()
        for i, prompt in enumerate(picks):
            pages = src.alloc_seq(len(prompt) + max_new, 21)
            toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
            logits, k, v = prefill_kv(model, toks)
            src.write_prefill(k[:, 0], v[:, 0], pages, len(prompt))
            first = int(logits[0].argmax())
            g0 = gather_pages.launches + scatter_pages.launches
            futs.append(far.attach_remote.future(9400 + i, prompt, first, max_new,
                                                 PoolPages(src, pages), timeout=600.0))
            k2.append(gather_pages.launches + scatter_pages.launches - g0)
            src_pages.append(pages)
        staged = len(target._flight)
        results = gather(futs, timeout=600.0)
        sync(dev)
        t_handoffs = time.perf_counter() - t0
        eng.run_until_drained(timeout=600)
        got_b = [eng.result(9400 + i) for i in range(len(picks))]
        launches["attach_remote_futures"] = got = read(steps0)
        if results != [0] * len(picks) or staged != len(picks):
            fail(f"phase {n} (b): gather gave {results}, {staged} staged in the flight")
        if k2 != [4] * len(picks):
            fail(f"phase {n} (b): K2 launches by transfer {k2}, expected 4 each")
        if got["flash_prefill"] != L * len(picks):
            fail(f"phase {n} (b): flash_prefill launched {got['flash_prefill']} times")
        if not got["decode_steps"] or any(len(o) != max_new for o in got_b):
            fail(f"phase {n} (b): the handed-off requests decoded {got_b}")
        differ_b = divergences(model, picks, want, got_b, "cross-pod handoff")
        for pages in src_pages:
            src.free_seq(pages)
        if eng.oob_events:
            fail(f"phase {n} (b): {eng.oob_events} sandbox violations")
        leaks("(b)")
        st = target.stats()
        info["futures"] = {
            "handoffs_ms": 1e3 * t_handoffs, "flushes": len(flush_s),
            "flush_host_ms": [1e3 * t for t in flush_s], "k2_launches": k2,
            "link": {k: st[k] - link0[k] for k in st}, "near_tie_divergences": differ_b,
            "decode_steps": got["decode_steps"],
            "moved_bytes": src.byref_bytes_out,
        }
        if info["futures"]["link"]["window_seal_flushes"] != 1 or len(flush_s) != 1:
            fail(f"phase {n} (b): {len(flush_s)} flushes, link {info['futures']['link']}")
    finally:
        LinkPool.flush_stripe = flush_stripe
        eng.shutdown()
    if thread.is_alive():
        fail(f"phase {n}: the serving thread is still alive after shutdown()")
    info["launches"] = launches
    a, b = info["streams"], info["futures"]
    log(f"phase {n} cross-pod streams on {card}: 8 client threads in pod9 streamed "
        f"{len(prompts)} x {max_new} tokens over the fallback link in {a['decode_steps']} "
        f"decode steps ({a['steps_at_b8']} at B=8), paged_attention "
        f"{launches['streams']['paged_attention']} = {L} x {a['decode_steps']}, "
        f"flash_prefill {launches['streams']['flash_prefill']} = {L} x {len(prompts)}, oob 0, "
        f"{len(a['near_tie_divergences'])} streams differ from phase 16's, each at a "
        f"near-tie; decode step {a['decode_step_ms_b8']:.2f} ms at B=8 (step_batch "
        f"{a['step_batch_ms_median_b8']:.2f} ms) vs in pod {a['in_pod_decode_step_ms_b8']:.2f}"
        f" ms; time to first token median {np.median(a['ttft_ms']):.1f} ms (max "
        f"{max(a['ttft_ms']):.1f}) vs in pod {np.median(a['in_pod_ttft_ms']):.1f} ms (max "
        f"{max(a['in_pod_ttft_ms']):.1f}); link {a['link']}")
    log(f"phase {n} cross-pod attach_remote futures on {card}: 3 futures in one flight, "
        f"gather -> [0, 0, 0], K2 {b['k2_launches']} launches by transfer "
        f"({b['moved_bytes']} bytes), K1 decoded them in {b['decode_steps']} steps, "
        f"{len(b['near_tie_divergences'])} differ from in-pod generate_tokens, each at a "
        f"near-tie; handoffs {b['handoffs_ms']:.2f} ms, {b['flushes']} flush of "
        f"{b['flush_host_ms'][0]:.3f} ms on the host; link {b['link']}")
    return info


# ---------------------------------------------------------------------------
# phase 41: the cluster plane (a decode endpoint with a standby replica)
# ---------------------------------------------------------------------------
def await_reaped(channel, conn, timeout=60.0):
    """Wait until the serving thread has reaped ``conn``'s cancelled
    streams (it sees the cancel word at its next pump), so a client's
    re-wire never closes a generator that thread is running."""
    deadline = time.monotonic() + timeout
    while any(st.conn is conn for st in list(channel._streams)):
        if time.monotonic() > deadline:
            raise RuntimeError("the serving thread never reaped a cancelled stream")
        time.sleep(0.001)


def phase_failover(cfg, model, prompts, submits, rpc, max_new, card, n=41):
    """yi-9b's decode endpoint with a standby replica: (a) balanced client
    streams over both replicas; (b) a chaos lease lapse fails the endpoint
    over mid-stream, the streams restart on the standby, then submits hand
    off over its ring; (c) the lifecycle handle quiesces, resumes, drains
    and closes."""
    from repro_torch.core import (RPC, ChannelError, ChaosInjector, Endpoint, Fault,
                                  FaultPlan, Overloaded)
    from repro_torch.core.channel import BusyWaitPolicy
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving import DecodeService, PoolConfig, ServeEngine

    dev, L = model.device, cfg.num_layers
    ref = rpc["streams"]["polling_200us_clients"]
    total = len(prompts) * max_new

    def zero():
        paged_attention.launches = 0
        flash_prefill_cuda.launches = 0

    def read(steps0, prefills, what):
        got = {"paged_attention": paged_attention.launches,
               "flash_prefill": flash_prefill_cuda.launches,
               "decode_steps": eng.decode_steps - steps0, "prefills": prefills}
        if got["paged_attention"] != L * got["decode_steps"]:
            fail(f"phase {n} {what}: paged_attention launched {got['paged_attention']} "
                 f"times, expected {L} x {got['decode_steps']} decode steps")
        if got["flash_prefill"] != L * prefills:
            fail(f"phase {n} {what}: flash_prefill launched {got['flash_prefill']} times, "
                 f"expected {L} x {prefills} prefills")
        if eng.oob_events:
            fail(f"phase {n} {what}: {eng.oob_events} sandbox violations")
        return got

    def leaks(what):
        if eng.pool.heap.free_pages() != free0 or eng.pool.stats()["sealed_pages"] \
                or eng.scheduler.slots:
            fail(f"phase {n} {what}: pages, seals or slots leaked: {eng.pool.stats()}")

    pc = PoolConfig(num_pages=512, page_tokens=16, max_pages_per_seq=64)
    eng = ServeEngine(cfg, model, pc, max_active=8, pod="pod0", device=dev)
    free0 = eng.pool.heap.free_pages()
    name = eng.endpoint_name
    standby = RPC(eng.orch, pid=13).open("/pod0/decode-standby", heap_pages=256)
    standby.stream_pump_burst = 1
    standby.serve(DecodeService(eng))
    rec = eng.router.register(name, standby)
    ep = Endpoint.serve([eng.channel, standby], policy=BusyWaitPolicy(fixed_sleep_us=5.0))
    # the control plane: connects, stream starts and restarts, heartbeats
    # and the fault take turns, so no lease-table walk races a mapping
    cp_lock = threading.Lock()
    pump_us, step_log = [], []
    step_batch = eng.scheduler.step_batch

    def logged_step():
        t0 = time.perf_counter()
        b = step_batch()
        step_log.append((t0, time.perf_counter(), b))
        return b

    def poll():
        return BusyWaitPolicy(fixed_sleep_us=200.0)

    def run(client, what):
        """One thread a prompt; this thread heartbeats every 50 ms."""
        errors = []
        barrier = threading.Barrier(len(prompts))

        def body(i):
            try:
                client(i, barrier)
            except Exception as e:   # reported below
                errors.append((i, repr(e)))
                barrier.abort()

        threads = [threading.Thread(target=body, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 600
        while any(t.is_alive() for t in threads) and time.monotonic() < deadline:
            with cp_lock:
                t0 = time.perf_counter()
                eng.router.pump()
                pump_us.append(1e6 * (time.perf_counter() - t0))
            time.sleep(0.05)
        if any(t.is_alive() for t in threads):
            fail(f"phase {n} {what}: a client thread did not finish")
        if errors:
            fail(f"phase {n} {what}: clients failed: {errors}")

    def b8_ms(steps):
        full = [(a, b) for a, b, bs in steps if bs == len(prompts)]
        return (1e3 * (full[-1][1] - full[0][0]) / len(full), len(full)) if full else \
            (None, 0)

    info, launches = {}, {}
    eng.scheduler.step_batch = logged_step
    try:
        # (a) balanced stubs: each stream pins the replica power2 picks
        pins, outs = [None] * len(prompts), [None] * len(prompts)

        def balanced(i, barrier):
            with cp_lock:
                stub = eng.router.stub(name, DecodeService, pid=70 + i, pod="pod0",
                                       balance="power2", balance_seed=i)
                conn = stub.connection
                conn.prime()
                for sub in conn._subs.values():
                    sub.target.wait_policy = poll()
            barrier.wait(timeout=60)
            with cp_lock:
                s = stub.generate_stream.stream(prompts[i], max_new, timeout=600.0)
            pins[i] = rec.chain[conn._stream_pin].server_pid
            outs[i] = list(s)

        zero()
        steps0 = eng.decode_steps
        step_log.clear()
        t0 = time.perf_counter()
        run(balanced, "(a)")
        wall_a = time.perf_counter() - t0
        launches["balanced"] = read(steps0, len(prompts), "(a)")
        if set(pins) != {12, 13}:
            fail(f"phase {n} (a): the streams pinned {pins}; both replicas must take some")
        differ_a = divergences(model, prompts, ref["tokens"], outs, f"phase {n} (a) stream")
        leaks("(a)")
        step_a, full_a = b8_ms(step_log)
        info["balanced"] = {"pins": pins, "wall_s": wall_a, "decode_step_ms_b8": step_a,
                            "steps_at_b8": full_a, "near_tie_divergences": differ_a,
                            "tokens": outs}

        # (b) routed stubs on the primary; the lease lapses half-way
        gen0, fo0 = rec.generation, eng.router.n_failovers
        inj = ChaosInjector(FaultPlan([Fault("lease_lapse", at=0.5, target=12)]),
                            orch=eng.orch, router=eng.router)
        state = {"delivered": 0, "t_lapse": None, "lapse_us": None}
        restarts, first_after = [0] * len(prompts), [None] * len(prompts)
        outs, served_by = [None] * len(prompts), [None] * len(prompts)

        def failing_over(i, barrier):
            with cp_lock:
                stub = eng.router.stub(name, DecodeService, pid=80 + i, pod="pod0")
                stub.connection.target.wait_policy = poll()
            if stub.connection.target.channel is not eng.channel:
                raise RuntimeError("a routed stub did not start on the primary")
            barrier.wait(timeout=60)
            while True:
                old = stub.connection.target
                with cp_lock:
                    s = stub.generate_stream.stream(prompts[i], max_new, timeout=600.0)
                    stub.connection.target.wait_policy = poll()
                toks = []
                try:
                    for tok in s:
                        if restarts[i] and not toks:
                            first_after[i] = time.perf_counter()
                        toks.append(tok)
                        with cp_lock:
                            state["delivered"] += 1
                            t0 = time.perf_counter()
                            if inj.poke(state["delivered"] / total):
                                state["lapse_us"] = 1e6 * (time.perf_counter() - t0)
                                state["t_lapse"] = t0
                    break
                except ChannelError as e:
                    if restarts[i] or "failed over mid-stream" not in str(e):
                        raise
                    restarts[i] += 1
                    await_reaped(old.channel, old)
            outs[i] = toks
            served_by[i] = stub.connection.target.channel.server_pid

        zero()
        steps0 = eng.decode_steps
        step_log.clear()
        t0 = time.perf_counter()
        run(failing_over, "(b)")
        wall_b = time.perf_counter() - t0
        streams = read(steps0, 2 * len(prompts), "(b) streams")
        if inj.n_fired != 1 or state["t_lapse"] is None:
            fail(f"phase {n} (b): the lease lapse fired {inj.n_fired} times")
        if rec.generation != gen0 + 1 or eng.router.n_failovers != fo0 + 1:
            fail(f"phase {n} (b): generation {gen0} -> {rec.generation}, failovers "
                 f"{fo0} -> {eng.router.n_failovers}; expected one failover")
        if restarts != [1] * len(prompts) or set(served_by) != {13}:
            fail(f"phase {n} (b): restarts {restarts}, served by {served_by}")
        differ_b = divergences(model, prompts, ref["tokens"], outs,
                               f"phase {n} (b) restarted stream")
        leaks("(b) streams")
        t_lapse = state["t_lapse"]
        step_before, n_before = b8_ms([s for s in step_log if s[1] <= t_lapse])
        step_after, n_after = b8_ms([s for s in step_log if s[0] >= t_lapse])
        # three submits: prefill here, ``stub.attach`` re-wires to pid 13 and
        # crosses to the Endpoint's serving thread, batched decode here
        zero()
        steps0 = eng.decode_steps
        eng.serve_loop = ep.loop
        try:
            rids = [eng.submit(p, max_new) for p in submits]
            eng.run_until_drained(timeout=600)
        finally:
            eng.serve_loop = None
        launches["submits"] = read(steps0, len(submits), "(b) submits")
        with cp_lock:
            eng.router.pump()
        if eng.conn.target.channel is not standby or eng.conn.failovers != 1 or \
                any(len(eng.result(r)) != max_new for r in rids):
            fail(f"phase {n} (b): the submits rode pid "
                 f"{eng.conn.target.channel.server_pid} after {eng.conn.failovers} failovers")
        leaks("(b) submits")
        launches["failover_streams"] = streams
        info["failover"] = {
            "wall_s": wall_b, "restarts": restarts, "served_by": served_by,
            "generation": [gen0, rec.generation], "lapse_at_token": inj.fired[0].at * total,
            "decode_step_ms_b8_before": step_before, "steps_at_b8_before": n_before,
            "decode_step_ms_b8_after": step_after, "steps_at_b8_after": n_after,
            "lapse_to_first_token_ms": [1e3 * (t - t_lapse) for t in first_after],
            "lapse_us": state["lapse_us"], "near_tie_divergences": differ_b,
            "tokens": outs, "submit_tokens": [eng.result(r) for r in rids],
            "router": eng.router.stats(),
        }

        # (c) the lifecycle: quiesce sheds typed, resume serves, drain, close
        zero()
        steps0 = eng.decode_steps
        with cp_lock:
            stub = eng.router.stub(name, DecodeService, pid=90, pod="pod0")
            stub.connection.target.wait_policy = poll()
        ep.quiesce()
        try:
            list(stub.generate_stream.stream(prompts[0], max_new, timeout=600.0))
            fail(f"phase {n} (c): a quiesced endpoint admitted a stream")
        except Overloaded as e:
            shed = e.retry_after_s
        if not shed or shed <= 0:
            fail(f"phase {n} (c): the shed carried retry-after {shed}")
        ep.resume()
        toks = list(stub.generate_stream.stream(prompts[0], max_new, timeout=600.0))
        differ_c = divergences(model, prompts[:1], ref["tokens"][:1], [toks],
                               f"phase {n} (c) resumed stream")
        drained = ep.drain(timeout_s=30.0)
        ep.close()
        launches["lifecycle"] = read(steps0, 1, "(c)")
        if not drained or ep.state != "closed" or ep.n_shed < 1:
            fail(f"phase {n} (c): drained {drained}, state {ep.state}, shed {ep.n_shed}")
        leaks("(c)")
        info["lifecycle"] = {"retry_after_s": shed, "n_shed": ep.n_shed,
                             "near_tie_divergences": differ_c, "state": ep.state}
    finally:
        del eng.scheduler.step_batch
        ep.close()
    info["launches"] = launches
    info["pump_us"] = {"median": float(np.median(pump_us)), "max": max(pump_us),
                       "n": len(pump_us)}
    a, b = info["balanced"], info["failover"]
    k1 = sum(part["paged_attention"] for part in launches.values())
    k3 = sum(part["flash_prefill"] for part in launches.values())
    prefills = sum(part["prefills"] for part in launches.values())
    steps = sum(part["decode_steps"] for part in launches.values())
    log(f"phase {n} standby replica on {card}: (a) 8 power2 streams pinned pids {a['pins']}, "
        f"B=8 step {a['decode_step_ms_b8']:.2f} ms, {len(a['near_tie_divergences'])} differ "
        f"from phase 16 at near-ties; (b) the lease lapse at token "
        f"{b['lapse_at_token']:.0f} of {total} failed {name} over to pid 13 (generation "
        f"{b['generation'][0]} -> {b['generation'][1]}), {sum(b['restarts'])} streams "
        f"restarted there, {len(b['near_tie_divergences'])} differ from phase 16 at "
        f"near-ties, pages and seals back, 3 submits handed off over pid 13's ring; B=8 "
        f"step {b['decode_step_ms_b8_before']:.2f} ms before the lapse, "
        f"{b['decode_step_ms_b8_after']:.2f} ms after (phase 16's polling clients "
        f"{ref['decode_step_ms_b8']:.2f}); lapse to restarted first token median "
        f"{np.median(b['lapse_to_first_token_ms']):.1f} ms (max "
        f"{max(b['lapse_to_first_token_ms']):.1f}); lapse tick {b['lapse_us']:.0f} µs, "
        f"pump() median {info['pump_us']['median']:.0f} µs (max "
        f"{info['pump_us']['max']:.0f}); (c) quiesced shed Overloaded(retry_after "
        f"{info['lifecycle']['retry_after_s']} s), resumed, drained, closed; "
        f"flash_prefill {k3} = {L} x {prefills} prefills, paged_attention {k1} = {L} x "
        f"{steps} steps")
    return info


# ---------------------------------------------------------------------------
# phase 42: yi-9b's served streams under the ShmCheck sanitizer
# ---------------------------------------------------------------------------
def phase_shmcheck(cfg, model, prompts, rpc, max_new, card, n=42):
    """Phase 16's threaded streams (8 clients with 200 µs polling naps, the
    wait policy set on each stub's connection) from an engine built inside
    a ``repro_torch.analysis.session()``: every heap the engine makes
    attaches to the tracer, and the session must end with no finding,
    oob 0, every page, seal and slot back and phase 16's tokens outside
    near-ties. Four engines in turn, each shut down and dropped before the
    next: sanitized, unsanitized (built outside any session, no tracer),
    unsanitized, sanitized, so that each setting is read in both orders.
    Each sanitized run also times the host seconds spent inside the
    tracer's hooks. The hooks are host code: K1 and K3 run as without
    them."""
    from collections import Counter

    from repro_torch.analysis import session
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.serving import PoolConfig, ServeEngine

    dev, L = model.device, cfg.num_layers
    ref = rpc["streams"]["polling_200us_clients"]
    pc = PoolConfig(num_pages=512, page_tokens=16, max_pages_per_seq=64)

    def streams(eng, what):
        free0 = eng.pool.heap.free_pages()
        step_log = []
        step_batch = eng.scheduler.step_batch

        def logged_step():
            t0 = time.perf_counter()
            b = step_batch()
            step_log.append((t0, time.perf_counter(), b))
            return b

        eng.scheduler.step_batch = logged_step
        paged_attention.launches = 0
        flash_prefill_cuda.launches = 0
        steps0 = eng.decode_steps
        try:
            sync(dev)
            outs, first_s = stream_clients(eng, prompts, max_new, 50, client_sleep_us=200.0)
            sync(dev)
        finally:
            del eng.scheduler.step_batch
            eng.shutdown()
        got = {"paged_attention": paged_attention.launches,
               "flash_prefill": flash_prefill_cuda.launches,
               "decode_steps": eng.decode_steps - steps0, "prefills": len(prompts)}
        if got["paged_attention"] != L * got["decode_steps"]:
            fail(f"phase {n} {what}: paged_attention launched {got['paged_attention']} "
                 f"times, expected {L} x {got['decode_steps']} decode steps")
        if got["flash_prefill"] != L * len(prompts):
            fail(f"phase {n} {what}: flash_prefill launched {got['flash_prefill']} times, "
                 f"expected {L} x {len(prompts)} prefills")
        if eng.oob_events:
            fail(f"phase {n} {what}: {eng.oob_events} sandbox violations")
        if eng.pool.heap.free_pages() != free0 or eng.pool.stats()["sealed_pages"] \
                or eng.scheduler.slots:
            fail(f"phase {n} {what}: pages, seals or slots leaked: {eng.pool.stats()}")
        full = [(t0, t1) for t0, t1, b in step_log if b == len(prompts)]
        if not full:
            fail(f"phase {n} {what}: no decode step ran all {len(prompts)} streams together")
        return {"launches": got, "tokens": outs, "ttft_ms": [1e3 * t for t in first_s],
                "steps_at_b8": len(full),
                "decode_step_ms_b8": 1e3 * (full[-1][1] - full[0][0]) / len(full),
                "near_tie_divergences": divergences(
                    model, prompts, ref["tokens"], outs,
                    f"phase {n} {what} stream, against phase 16's,")}

    def hook_timer(tr):
        """Wrap each hook the core calls on this tracer with a host timer:
        the seconds spent inside the tracer, summed over every thread (an
        inner hook that a hook calls is not counted twice)."""
        cells, mine = [], threading.local()    # one [seconds, calls, depth] a thread

        def timed(fn):
            def hook(*a, **kw):
                c = getattr(mine, "c", None)
                if c is None:
                    c = mine.c = [0.0, 0, 0]
                    cells.append(c)
                if c[2]:
                    return fn(*a, **kw)
                c[2] = 1
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    c[0] += time.perf_counter() - t
                    c[1] += 1
                    c[2] = 0
            return hook

        for name in dir(tr):
            if name.startswith(("on_", "sync_", "checked_deref")) or name in (
                    "alias_space", "reset_pages"):
                setattr(tr, name, timed(getattr(tr, name)))
        return lambda: (sum(c[0] for c in cells), sum(c[1] for c in cells))

    def run(sanitized, k):
        what = f"{'sanitized' if sanitized else 'unsanitized'} run {k}"
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if not sanitized:
            eng = ServeEngine(cfg, model, pc, max_active=8, serve_threaded=True, device=dev)
            if eng.pool.heap._tracer is not None or eng.conn.heap._tracer is not None:
                fail(f"phase {n}: an engine built outside any session carries a tracer")
            res = streams(eng, what)
            res["wall_s"] = time.perf_counter() - t0
            return res
        with session(max_events=1 << 22) as tr:
            acc = hook_timer(tr)
            eng = ServeEngine(cfg, model, pc, max_active=8, serve_threaded=True, device=dev)
            if eng.pool.heap._tracer is not tr or eng.conn.heap._tracer is not tr:
                fail(f"phase {n}: the engine's heaps are not attached to the session")
            res = streams(eng, what)
        res["wall_s"] = time.perf_counter() - t0
        if tr.findings:
            fail(f"phase {n} {what}: ShmCheck reported {len(tr.findings)} finding(s):\n"
                 + "\n".join(str(f) for f in tr.findings))
        if len(tr.events) != tr.n_events:
            fail(f"phase {n} {what}: the event ring dropped "
                 f"{tr.n_events - len(tr.events)} events")
        kinds = dict(sorted(Counter(rec[0] for rec in tr.events).items()))
        for kind in ("alloc", "seal", "seal-release", "rel", "acq", "w", "r"):
            if not kinds.get(kind):
                fail(f"phase {n} {what}: no {kind!r} event: the hooks did not run ({kinds})")
        steps = res["launches"]["decode_steps"]
        hook_s, hook_calls = acc()
        res.update(n_events=tr.n_events, event_kinds=kinds, summary=tr.summary(),
                   hook_calls=hook_calls, hook_s=hook_s,
                   hook_ms_per_step=1e3 * hook_s / max(steps, 1))
        return res

    # on, off, off, on: each order is read once, so an effect of the order
    # shows as a difference between the two runs of one setting. Each engine
    # is shut down (its serving thread joined) and dropped before the next.
    runs = [run(s, k) for k, s in enumerate((True, False, False, True))]
    on = [r for r in runs if "hook_s" in r]
    off = [r for r in runs if "hook_s" not in r]
    launches = {key: sum(r["launches"][key] for r in on) for key in on[0]["launches"]}
    info = {"order": ["sanitized", "unsanitized", "unsanitized", "sanitized"],
            "runs": runs, "launches": {"sanitized": launches}}
    step = [f"{r['decode_step_ms_b8']:.2f}" for r in runs]
    log(f"phase {n} ShmCheck over yi-9b's served streams on {card}: 8 client threads "
        f"streamed {len(prompts)} x {max_new} tokens from engines built inside a "
        f"session (runs 0 and 3) and outside any (runs 1 and 2); {on[0]['summary']}; "
        f"events by kind {on[0]['event_kinds']}; oob 0, pages, seals and slots back "
        f"in every run; streams that differ from phase 16 at near-ties "
        f"{[len(r['near_tie_divergences']) for r in runs]}; flash_prefill "
        f"{launches['flash_prefill']} = {L} x {launches['prefills']} prefills, "
        f"paged_attention {launches['paged_attention']} = {L} x "
        f"{launches['decode_steps']} steps over the sanitized runs; B=8 step ms "
        f"on/off/off/on {step} (phase 16's polling clients "
        f"{ref['decode_step_ms_b8']:.2f}); host ms inside the tracer's hooks per "
        f"decode step, all threads summed, {[round(r['hook_ms_per_step'], 3) for r in on]} "
        f"({[r['hook_calls'] for r in on]} hook calls); wall s "
        f"{[round(r['wall_s'], 1) for r in runs]}")
    return info


def _kernel_name(mangled: str) -> str:
    """'..25flash_prefill_bf16_kernelILi256EE..' → 'flash_prefill_bf16_kernel<256>':
    the first length-prefixed identifier that ends in ``_kernel``."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        ident, i = mangled[j:j + int(m.group())], j + int(m.group())
        if ident.endswith("_kernel"):
            t = re.match(r"ILi(\d+)E", mangled[i:])
            return ident + (f"<{t.group(1)}>" if t else "")
    return mangled


def ptxas_report(logs) -> dict:
    """nvcc's -Xptxas -v output → {kernel<D>: (registers, spill bytes)}."""
    out, name, spill = {}, None, 0
    for ln in (ln for log_ in logs for ln in log_.splitlines()):
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name = _kernel_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", ln):
            out[name] = (int(m.group(1)), spill)
    return out


# ---------------------------------------------------------------------------
# phases 17-20: olmo-1b and qwen2-vl-7b, every family the paged engine serves
# ---------------------------------------------------------------------------
def phase_new_layouts(gen, main_lens, card):
    """K1 and K3 against their plain versions at olmo-1b's (16/16: a
    cluster of one block a pair at B=8) and qwen2-vl-7b's (28/4: 7 query
    rows a KV head) layouts, bf16 and f32, with the sandbox cases."""
    from repro_torch.kernels.paged_attention.kernel import cluster_size

    clusters = {name: cluster_size(8, Hkv) for name, (_, Hkv) in NEW_LAYOUTS.items()}
    if clusters["olmo-1b"] != 1:
        fail(f"K1 at olmo-1b's 8 x 16 pairs launches clusters of {clusters['olmo-1b']}, "
             "expected 1")
    errs = {}
    for name, (Hq, Hkv) in NEW_LAYOUTS.items():
        layout = dict(B=8, Hq=Hq, Hkv=Hkv, D=128, P=512, T=16, MAXP=64, lens=main_lens)
        for dtype in (torch.bfloat16, torch.float32):
            dt = str(dtype)[6:]
            errs[f"K1 {name} {dt}"] = check_k1(k1_inputs(gen, dtype=dtype, **layout),
                                               K1_TOL[dtype])
            for case in K1_SANDBOX_CASES:
                args, expect = k1_sandbox_case(gen, case, dtype, layout)
                errs[f"K1 {name} {case} {dt}"] = check_k1(args, K1_TOL[dtype],
                                                          expect_oob=expect)
            for softcap in (0.0, 30.0):
                k3_name, err = check_k3(gen, (2, 471, Hq, Hkv, 128, 0, softcap), dtype)
                errs[f"K3 {k3_name}"] = err
    log(f"phase 17 new layouts vs plain on {card}: K1 cluster size at B=8 "
        f"{clusters} (paged_attention bf16 at atol {TOL_K1_BF16['atol']:g}/rtol "
        f"{TOL_K1_BF16['rtol']:g}, f32 at {TOL_F32['atol']:g}/{TOL_F32['rtol']:g}, the "
        f"served lengths and the sandbox cases on rows 0-1); flash_prefill at S=471, "
        f"softcap 0 and 30: max |err| { {k: f'{v:.1e}' for k, v in errs.items()} }")
    return {"cluster_size_b8": clusters, "max_abs_err": max(errs.values()), "per_case": errs}


def phase_family(cfg, gen, rng, card, n):
    """One more paged configuration at full width and depth, served as
    yi-9b is in phases 3-6: 8 streams and 3 submits through ``ServeEngine``
    (K3 a prefill, K1 a step), the dense-cache chain, a B=8 step under the
    profiler (phase 20), and one cross-pod handoff between two pools."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {cfg.name} {cfg.num_layers} layers, {n_params / 1e9:.2f} B params "
        f"(analytic {cfg.param_count() / 1e9:.2f} B), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = make_prompts(rng, 8, cfg.vocab_size)
    extra = make_prompts(rng, 3, cfg.vocab_size)
    eng, outputs, serve = phase_serve(cfg, model, prompts, extra, MAX_NEW,
                                      label=f"phase {n} {cfg.name} main path on {card}")
    dense = phase_dense(model, prompts + extra, outputs, MAX_NEW,
                        label=f"phase {n} {cfg.name} dense-cache chain")
    prof = phase_profile(eng, prompts, MAX_NEW,
                         label=f"phase 20 where a {cfg.name} decode step goes")
    del eng
    torch.cuda.empty_cache()
    src_pool, _, transfer = phase_transfer(cfg, gen,
                                           label=f"phase {n} {cfg.name} cross-pod handoff")
    del src_pool
    torch.cuda.empty_cache()
    info = {"serve": serve, "dense": dense, "profile": prof, "transfer": transfer,
            "decode_lens": [len(p) + MAX_NEW for p in prompts],
            "longest_prompt": max(len(p) for p in prompts + extra)}
    return model, info


def phase_mrope(model, cfg, rng, card):
    """``Model.prefill`` with caller-given M-RoPE triples for an image:
    the positions path runs (``_attend``, masked by the temporal stream)
    and K3 does not; the logits are finite; explicit 0..S-1 triples on the
    positions path give the K3 path's logits within the bf16 tolerance."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.models.attention import attention_full
    from repro_torch.models.layers import image_positions

    L, dev = cfg.num_layers, model.device
    pos = image_positions(20, (16, 24), 60)
    S = pos.shape[1]
    pos = pos[:, None].to(dev)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, S)).astype(np.int32)).to(dev)
    arange3 = torch.arange(S, dtype=torch.int32, device=dev)[None, None].expand(3, 1, S)

    def run(**kw):
        attention_full.paths = dict.fromkeys(attention_full.paths, 0)
        flash_prefill_cuda.launches = 0
        logits, _ = model.prefill(toks, **kw)
        sync(dev)
        return logits, dict(attention_full.paths, k3_launches=flash_prefill_cuda.launches)

    l_img, paths_img = run(positions=pos)
    if paths_img != {"flash_prefill": 0, "positions": L, "memory": 0, "k3_launches": 0}:
        fail(f"the image prefill's paths {paths_img}: expected {L} layers on the positions "
             "path and no flash_prefill launch")
    if not torch.isfinite(l_img).all():
        fail("the image prefill's logits are not finite")
    l_pos, paths_pos = run(positions=arange3)
    l_k3, paths_k3 = run()
    if paths_pos["positions"] != L or paths_k3 != {"flash_prefill": L, "positions": 0,
                                                   "memory": 0, "k3_launches": L}:
        fail(f"paths: arange triples {paths_pos}, no positions {paths_k3}")
    err = (l_pos - l_k3).abs().max().item()
    if not torch.allclose(l_pos, l_k3, **TOL_BF16):
        fail(f"arange triples on the positions path disagree with the K3 path: "
             f"max |err| {err:.3e}")
    timer = Timer()
    ms = {"positions_path": timer.ms(lambda: model.prefill(toks, positions=pos), samples=5,
                                     warmup=1),
          "k3_path": timer.ms(lambda: model.prefill(toks), samples=5, warmup=1)}
    info = {"S": S, "grid": [16, 24], "paths_image": paths_img,
            "max_abs_err_positions_vs_k3": err,
            "top1_equal": int(l_pos.argmax()) == int(l_k3.argmax()), "prefill_ms": ms,
            "image_top1": int(l_img.argmax())}
    log(f"phase 19 M-RoPE image prefill on {card}: {S} tokens (20 text, a 16 x 24 patch "
        f"grid at one temporal position, 60 text resuming at "
        f"{int(pos[0, 0, 20 + 16 * 24])}); positions path {L} layers, flash_prefill 0 "
        f"launches, logits finite; arange triples on the positions path vs the K3 path max "
        f"|err| {err:.3e} (atol {TOL_BF16['atol']:g}/rtol {TOL_BF16['rtol']:g}), top-1 "
        f"equal {info['top1_equal']}; prefill ms (CUDA events, median of 5): positions path "
        f"{ms['positions_path']:.2f}, K3 path {ms['k3_path']:.2f}")
    return info


def phase_family_times(gen, fams, card):
    """K1 at each model's decode shape (B=8, its served lengths) and K3 at
    its prefill shape (B=1, its longest prompt), bf16, each with its bound
    and the fastest SDPA backend timed alone."""
    timer = Timer()
    out = {}
    for name, (Hq, Hkv) in NEW_LAYOUTS.items():
        info = fams[name]
        out[name] = {
            "paged_attention": k1_times(timer, k1_inputs(gen, Hq=Hq, Hkv=Hkv,
                                                         lens=info["decode_lens"])),
            "flash_prefill": k3_times(timer, gen, 1, info["longest_prompt"], Hq, Hkv, 128, 0),
        }
        torch.cuda.empty_cache()
    log(f"phase 20 times on {card} (ms, median of {SAMPLES}, L2 flushed): "
        + "; ".join(f"{m} {k} {d['ms']:.5f}, plain {d['plain_ms']:.5f}, "
                    f"{d['library_backend']} {d['library_ms']:.5f} (by backend "
                    f"{json.dumps(d['library_ms_by_backend'])}), bound {d['bound_ms']:.5f} "
                    f"({d['bound_by']}), host µs a call {d['host_us']:.1f}"
                    for m, kd in out.items() for k, d in kd.items()))
    return out


# ---------------------------------------------------------------------------
# phases 21-23: the MoE families (granite-moe-1b-a400m, qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------
def phase_moe_kernels(gen, shapes, card):
    """K3 against its plain version at each MoE model's prefill shape (B=1,
    its longest prompt), bf16 and f32 at phase 12's tolerances, then timed
    beside its bound, its plain version and SDPA (each backend alone)."""
    errs = dict(check_k3(gen, (1, S, Hq, Hkv, D, 0, 0.0), dtype)
                for S, Hq, Hkv, D in shapes.values()
                for dtype in (torch.bfloat16, torch.float32))
    timer = Timer()
    times = {name: k3_times(timer, gen, 1, S, Hq, Hkv, D, 0)
             for name, (S, Hq, Hkv, D) in shapes.items()}
    torch.cuda.empty_cache()
    log(f"phase 21 flash_prefill at the MoE models' prefill shapes on {card} (bf16 at atol "
        f"{TOL_K1_BF16['atol']:g}/rtol {TOL_K1_BF16['rtol']:g}, f32 at "
        f"{TOL_F32['atol']:g}/{TOL_F32['rtol']:g}): max |err| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; times (ms, median of {SAMPLES}, L2 "
        "flushed): "
        + "; ".join(f"{n} {d['ms']:.5f} ({d['TFLOP_per_s']:.1f} TFLOP/s), plain "
                    f"{d['plain_ms']:.5f}, {d['library_backend']} {d['library_ms']:.5f} (by "
                    f"backend {json.dumps(d['library_ms_by_backend'])}), bound "
                    f"{d['bound_ms']:.5f} ({d['bound_by']}), host µs a call "
                    f"{d['host_us']:.1f}" for n, d in times.items()))
    return {"max_abs_err": max(errs.values()), "per_case": errs, "times": times}


def count_syncs(fn) -> dict:
    """Device-to-host synchronisations in one call of ``fn``, as CUDA's
    sync debug mode reports them, by the source line that made them."""
    import warnings
    from collections import Counter

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                        if "synchroniz" in str(w.message)))


def layer_counts(cfg):
    """Attention, SSM and MoE layers of the whole stack."""
    pattern = cfg.block_pattern()
    return tuple(cfg.num_blocks * sum(map(f, pattern)) for f in (
        lambda s: s.kind == "attn", lambda s: s.kind == "ssm", lambda s: s.moe))


def peak_gb() -> float:
    """Peak device memory allocated since the last call, in GB."""
    gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return gb


def routed(fn, pinned=None):
    """Call ``fn`` with every MoE layer's router logits (fp32, rows =
    tokens) and experts recorded; with ``pinned`` (experts a layer, rows =
    tokens) each layer routes to those experts instead, weighted by its
    own renormalised probabilities. Returns (fn's result, [(logits,
    experts) a layer])."""
    import repro_torch.models.transformer as tr
    from repro_torch.models import moe

    serve_moe, route, trace = tr.moe_apply, moe.route, []

    def probe(x, p, cfg_, group_size=4096):
        h = x.reshape(-1, x.shape[-1])
        probs, weights, idx = route(h, p["router"], cfg_.top_k)
        if pinned is not None:
            idx = pinned[len(trace)]
            weights = probs.gather(-1, idx)
            weights = weights / weights.sum(-1, keepdim=True)
        trace.append((h.float() @ p["router"], idx))
        moe.route = lambda *_: (probs, weights, idx)
        try:
            return serve_moe(x, p, cfg_, group_size)
        finally:
            moe.route = route

    tr.moe_apply = probe
    try:
        return fn(), trace
    finally:
        tr.moe_apply = serve_moe


def router_flips(trace_b, traces_a, k):
    """Per stream, the first layer whose experts differ between the batched
    step and the stream alone: the alone router's logit gap between its
    k-th and (k+1)-th experts, and how far the router logits moved between
    the two runs. An expert kept alone and dropped batched outranks one
    dropped alone by at least the gap, and ranks below it batched, so a
    flip of the same rows' top-k needs the gap within twice the shift;
    the caller fails otherwise."""
    flips = []
    for i, trace_a in enumerate(traces_a):
        layer = next((j for j, ((_, eb), (_, ea)) in enumerate(zip(trace_b, trace_a))
                      if not torch.equal(eb[i].sort().values, ea[0].sort().values)), None)
        if layer is None:
            flips.append(None)
            continue
        rb, ra = trace_b[layer][0][i], trace_a[layer][0][0]
        top = ra.sort(descending=True).values
        flips.append({"layer": layer, "router_gap_at_k": (top[k - 1] - top[k]).item(),
                      "router_shift": (rb - ra).abs().max().item()})
    return flips


def phase_moe_serve(cfg, model, prompts, max_new, card, n):
    """Under ``dropless_moe()`` (the serving mode): each request prefilled
    alone (B=1) through the flash-prefill kernel, the caches joined on the
    batch axis, greedy decode at B=8; then a decode step's device-to-host
    syncs, decode steps and a batched 8 x 512 prefill under the profiler.

    B=8 and B=1 round the hidden states apart, and where a router's gap
    at its k-th expert is below that, a token goes to another expert, which
    moves the logits by more than a near-tie. So the first batched step is
    held to three rules: where a stream's experts differ from its own
    alone, the first such layer's router gap at the k-th expert is within
    twice the router logits' shift (a flip, not a routing fault); every
    stream alone routed to the batched step's experts agrees with it by
    phase 9's rule (tokens equal outside near-ties); and so does every
    stream whose experts never differ, on its own routing. Each prefill
    launches K3 once an attention layer and K4 once an SSM layer."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.models.moe import dropless_moe

    dev, B = model.device, len(prompts)
    n_attn, n_ssm, _ = layer_counts(cfg)
    # room for the profiled steps after the main path's
    cache_len = max(len(p) for p in prompts) + max_new + 8
    with dropless_moe():
        flash_prefill_cuda.launches = ssd_intra_chunk_cuda.launches = 0
        caches, first, prefill_ms = [], [], []
        for prompt in prompts:
            toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            logits, cache = model.prefill(toks, cache_len=cache_len)
            sync(dev)
            prefill_ms.append(1e3 * (time.perf_counter() - t0))
            if not torch.isfinite(logits).all():
                fail(f"{cfg.name} prefill produced non-finite logits")
            first.append(int(logits[0].argmax()))
            caches.append(cache)
        cache = tree_cat(caches, dim=1)       # leaves are (L, B, ...): batch is axis 1
        tok = torch.tensor(first, dtype=torch.int32, device=dev)
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
        (logits, cache), trace_b = routed(lambda: model.decode_step(tok, pos, cache))
        if not torch.isfinite(logits).all():
            fail(f"{cfg.name} decode step 0 produced non-finite logits")
        alone, traces_a = zip(*(routed(lambda i=i: model.decode_step(
            tok[i:i + 1], pos[i:i + 1], tree_clone(caches[i]))[0]) for i in range(B)))
        alone = torch.cat(alone)
        flips = router_flips(trace_b, traces_a, cfg.top_k)
        if wide := [(i, f) for i, f in enumerate(flips)
                    if f and f["router_gap_at_k"] > 2 * f["router_shift"]]:
            fail(f"{cfg.name}: experts differ between B={B} and B=1 where the router's gap "
                 f"exceeds twice the shift of its logits (a routing fault, not a flip): "
                 f"(stream, layer, gap, shift) "
                 f"{[(i, f['layer'], f['router_gap_at_k'], f['router_shift']) for i, f in wide]}")
        pinned = torch.cat([routed(lambda i=i: model.decode_step(
            tok[i:i + 1], pos[i:i + 1], tree_clone(caches[i]))[0],
            pinned=[e[i:i + 1] for _, e in trace_b])[0] for i in range(B)])
        del caches, trace_b, traces_a
        batch_err = (logits - pinned).abs().max().item()
        batch_ties = first_step_ties(logits, pinned)
        same = [i for i, f in enumerate(flips) if f is None]
        same_ties = first_step_ties(logits[same], alone[same], streams=same)
        free = {"top1_equal": int((logits.argmax(-1) == alone.argmax(-1)).sum()),
                "max_abs_err": (logits - alone).abs().max().item()}
        streams = [tok, logits.argmax(-1).to(torch.int32)]
        sync(dev)
        t0 = time.perf_counter()
        for k in range(1, max_new):
            logits, cache = model.decode_step(streams[-1], pos + k, cache)
            if not torch.isfinite(logits).all():
                fail(f"{cfg.name} decode step {k} produced non-finite logits")
            streams.append(logits.argmax(-1).to(torch.int32))
        sync(dev)
        t_decode = time.perf_counter() - t0
        launches, ssd_launches = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
        if (launches, ssd_launches) != (n_attn * B, n_ssm * B):
            fail(f"flash_prefill and ssd_intra_chunk launched {launches} and {ssd_launches} "
                 f"times, expected {n_attn} and {n_ssm} x {B} prefill calls")
        tokens = torch.stack(streams, dim=1).tolist()
        if [t[0] for t in tokens] != first:
            fail("a stream does not start from the argmax of its own prefill")

        state = {"tok": streams[-1], "k": max_new}

        def step():
            logits, _ = model.decode_step(state["tok"], pos + state["k"], cache)
            state["tok"] = logits.argmax(-1).to(torch.int32)
            state["k"] += 1

        syncs = count_syncs(step)
        n_syncs = sum(syncs.values())
        prof = profile_steps(step, dev, steps=3)
        toks = torch.randint(1, cfg.vocab_size, (8, 512), dtype=torch.int32, device=dev)
        prefill_prof = profile_steps(lambda: model.prefill(toks), dev, steps=2,
                                     watch=("flash_prefill", "ssd_intra_chunk"))
    del cache
    torch.cuda.empty_cache()
    step_ms = 1e3 * t_decode / (max_new - 1)
    flip_text = [f and (f["layer"], round(f["router_gap_at_k"], 5), round(f["router_shift"], 5))
                 for f in flips]
    info = {"prompt_lens": [len(p) for p in prompts], "cache_len": cache_len,
            "prefill_ms": prefill_ms, "launches": launches, "ssd_launches": ssd_launches,
            "batched_vs_alone_max_abs_err": batch_err,
            "batched_vs_alone_near_ties": batch_ties,
            "routed_alone": dict(free, router_flips=flips, unflipped_streams=same,
                                 unflipped_near_ties=same_ties),
            f"decode_step_ms_b{B}": step_ms, f"decode_tokens_per_s_b{B}": 1e3 * B / step_ms,
            "decode_syncs_per_step": n_syncs, "decode_syncs_by_line": syncs,
            "decode_profile": prof,
            "prefill_8x512_profile": prefill_prof}
    log(f"phase {n} {cfg.name} main path (dropless) on {card}: {B} prefills alone (lengths "
        f"{info['prompt_lens']}), flash_prefill launches {launches} = {n_attn} x {B}"
        + (f", ssd_intra_chunk launches {ssd_launches} = {n_ssm} x {B}" if n_ssm else "")
        + f", prefill ms {[round(t, 1) for t in prefill_ms]}; caches joined, {max_new} greedy "
        f"steps at B={B}: logits finite, first step vs each stream alone with the batched "
        f"step's experts: tokens equal but at near-ties {batch_ties}, max |Δlogit| "
        f"{batch_err:.3e}; each stream alone on its own routing: experts differ from the "
        f"batched step's first at (layer, router gap at the k-th expert, router logit shift "
        f"B={B} vs B=1) {flip_text}, each gap within twice its shift; streams {same} never "
        f"differ and their tokens equal the batched step's but at near-ties {same_ties}; "
        f"top-1 equal in {free['top1_equal']}/{B} rows, max |Δlogit| {free['max_abs_err']:.3e}; "
        f"decode step {step_ms:.2f} ms (the {max_new - 1} steps after the first), "
        f"{info[f'decode_tokens_per_s_b{B}']:.1f} tokens/s")
    log(f"phase {n} where a {cfg.name} decode step goes on {card} (B={B}, dropless; "
        f"{n_syncs} device-to-host syncs a step, by line {syncs}; {prof['steps']} steps, then "
        "the same under the "
        f"profiler): {profile_line(prof)}; prefill 8x512 (2 steps, then 2 under the profiler): "
        f"{profile_line(prefill_prof)}; flash_prefill "
        f"{prefill_prof['watch_ms_per_step']['flash_prefill']:.2f} ms a prefill"
        + (f", ssd_intra_chunk {prefill_prof['watch_ms_per_step']['ssd_intra_chunk']:.2f} ms"
           if n_ssm else ""))
    return info


def phase_moe_capacity(cfg, model, rng, card, n, B=8, S=512):
    """A B x S prefill with capacity routing at the configured factor (one
    group of B·S tokens): the slots each MoE layer drops. On the same input
    each layer's capacity path at factor E/k (capacity = the group, nothing
    drops) must equal the dropless path's output: the same rows through
    the same expert products (a batched product over the (E, C) buffer
    against one an expert, each output row its own dot products), the
    gate rounded alike and each token's outputs added in expert order by
    both. Each token's difference relative to its norm is printed beside
    it as a diagnostic."""
    from dataclasses import replace

    import repro_torch.models.transformer as tr
    from repro_torch.models import moe

    E, k = cfg.num_experts, cfg.top_k
    G = B * S
    C = max(1, int(k * G / E * cfg.capacity_factor))
    full = replace(cfg, capacity_factor=E / k)
    layers = []
    serve_moe = tr.moe_apply

    def probe(x, p, cfg_, group_size=4096):
        if x.shape[0] * x.shape[1] != G or group_size < G:
            fail(f"the capacity probe expects one group of {G} tokens")
        y, aux = serve_moe(x, p, cfg_, group_size)
        _, _, idx = moe.route(x.reshape(1, G, -1), p["router"], k)
        flat = idx.reshape(1, G * k)
        keep = moe.capacity_slots(flat, E, C)[2]
        keep_full = moe.capacity_slots(flat, E, G)[2]
        y_full, _ = serve_moe(x, p, full, group_size)
        with moe.dropless_moe():
            y_dl, _ = serve_moe(x, p, cfg_, group_size)
        d, ref = (y_full.float() - y_dl.float()).reshape(G, -1), y_dl.float().reshape(G, -1)
        apart = (d.norm(dim=-1) / ref.norm(dim=-1)).max().item()
        layers.append({"dropped": int((~keep).sum()), "dropped_at_E_over_k":
                       int((~keep_full).sum()), "max_abs_err": d.abs().max().item(),
                       "max_abs_ref": ref.abs().max().item(), "tokens_apart": apart,
                       "elements_equal": (d == 0).float().mean().item()})
        return y, aux

    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, S)).astype(
        np.int32)).to(model.device)
    tr.moe_apply = probe
    try:
        logits, _ = model.prefill(toks)
    finally:
        tr.moe_apply = serve_moe
    if len(layers) != layer_counts(cfg)[2]:
        fail(f"the capacity probe saw {len(layers)} MoE layers, expected {layer_counts(cfg)[2]}")
    if not torch.isfinite(logits).all():
        fail(f"{cfg.name} capacity prefill produced non-finite logits")
    if any(l["dropped_at_E_over_k"] for l in layers):
        fail(f"slots drop at factor E/k: {[l['dropped_at_E_over_k'] for l in layers]}")
    if bad := [i for i, l in enumerate(layers) if l["max_abs_err"] != 0]:
        fail(f"{cfg.name} layers {bad}: the capacity path at factor E/k differs from the "
             f"dropless path by up to {max(layers[i]['max_abs_err'] for i in bad):.3e}, a "
             f"token's output by {max(layers[i]['tokens_apart'] for i in bad):.3e} of its norm")
    share = [l["dropped"] / (G * k) for l in layers]
    err = max(l["max_abs_err"] for l in layers)
    apart = max(l["tokens_apart"] for l in layers)
    equal = min(l["elements_equal"] for l in layers)
    log(f"phase {n} {cfg.name} capacity path on {card}: a {B} x {S} prefill at factor "
        f"{cfg.capacity_factor:g} (capacity {C} of a {G}-token group) drops "
        f"{100 * sum(share) / len(share):.2f}% of its slots (by layer "
        f"{min(share):.3f}-{max(share):.3f}); at factor E/k = {E / k:g} nothing drops and "
        f"each of the {len(layers)} MoE layers' outputs equals the dropless path's on the "
        f"same input: max |err| {err:.3e} (must be 0; max |output| "
        f"{max(l['max_abs_ref'] for l in layers):.3e}), {100 * equal:.2f}% of the elements "
        f"equal, each token within {apart:.3e} of its norm")
    return {"capacity": C, "group": G, "dropped_share": sum(share) / len(share),
            "dropped_share_by_layer": share, "max_abs_err_full_vs_dropless": err,
            "max_token_apart_full_vs_dropless": apart, "layers": layers}


def phase_moe_teacher_forced(cfg, layers, rng, card, n, K=200, steps=8):
    """An fp32 model of the first ``layers`` layers (drawn from the served
    model's seed: where the super-block is one layer its weights are the
    served ones in fp32) under ``dropless_moe()``: each decode step
    against a prefill of the prefix plus that token through the
    flash-prefill kernel (and the SSD kernel) in fp32."""
    from dataclasses import replace

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.models import build_model
    from repro_torch.models.moe import dropless_moe

    cfg_s = replace(cfg, num_layers=layers)
    n_attn, n_ssm, _ = layer_counts(cfg_s)
    m32 = build_model(cfg_s).init(torch.Generator("cuda").manual_seed(0)).float()
    dev = m32.device
    gb = sum(p.numel() * p.element_size() for p in m32.parameters()) / 1e9
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, K + steps)).astype(
        np.int32)).to(dev)
    n0, s0 = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
    errs = []
    with dropless_moe():
        logits, cache = m32.prefill(toks[:, :K], cache_len=K + steps)
        for t in range(K, K + steps):
            ref, _ = m32.prefill(toks[:, : t + 1])
            logits, cache = m32.decode_step(toks[:, t], torch.full((2,), t, dtype=torch.int32,
                                                                   device=dev), cache)
            errs.append((logits - ref).abs().max().item())
            if not torch.equal(logits.argmax(-1), ref.argmax(-1)):
                fail(f"fp32 decode step {t} picks another token than the prefill of its prefix")
    if (flash_prefill_cuda.launches - n0, ssd_intra_chunk_cuda.launches - s0) != (
            n_attn * (steps + 1), n_ssm * (steps + 1)):
        fail("the fp32 prefills did not all run the flash-prefill and SSD kernels")
    err = max(errs)
    if err > TOL_TF:
        fail(f"fp32 decode vs prefill max |err| {err:.3e} > {TOL_TF:g}")
    del m32, cache
    torch.cuda.empty_cache()
    log(f"phase {n} {cfg.name} fp32 teacher forcing on {card} (dropless): first {layers} of "
        f"{cfg.num_layers} layers ({gb:.1f} GB in fp32, "
        f"{'the served weights' if len(cfg.block_pattern()) == 1 else 'seed 0'}), B=2, prefill {K} "
        f"tokens, {steps} decode steps each against a kernel prefill of its prefix: max |err| "
        f"{err:.3e} (atol {TOL_TF:g}), argmax equal")
    return {"layers": layers, "gb_fp32": gb, "max_abs_err": err, "per_step": errs}


def phase_moe(cfg, prompts, rng, card, n, tf_layers):
    """One MoE configuration at full width and depth, random weights from
    seed 0: the main path, the capacity path, then (its bf16 weights freed)
    fp32 teacher forcing over its first ``tf_layers`` layers."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {cfg.name} {cfg.num_layers} layers, {cfg.num_experts} experts (top "
        f"{cfg.top_k}), {n_params / 1e9:.2f} B params ({2 * n_params / 1e9:.1f} GB in bf16; "
        f"analytic {cfg.param_count() / 1e9:.2f} B), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    serve = phase_moe_serve(cfg, model, prompts, MAX_NEW, card, n)
    capacity = phase_moe_capacity(cfg, model, rng, card, n)
    del model
    torch.cuda.empty_cache()
    tf = phase_moe_teacher_forced(cfg, tf_layers, rng, card, n)
    return {"params": n_params, "serve": serve, "capacity": capacity, "teacher_forced": tf,
            "longest_prompt": max(len(p) for p in prompts)}


# ---------------------------------------------------------------------------
# phases 24-28: the hybrid (jamba-v0.1-52b at half depth)
# ---------------------------------------------------------------------------
def phase_jamba_kernels(gen, cfg, S, card):
    """K3 at jamba's attention shape (B=1, its longest prompt, 32/8 heads
    at head_dim 128) and K4 at its batched prefill shape (B 8, S 512, 128
    heads, state 16), each against its plain version in bf16 and f32 at
    phase 12's and phase 8's tolerances, with the SSD init's chunk decays
    above 88; then each timed beside its bound, its plain version and (K3)
    SDPA."""
    sh = JAMBA_SSD_SHAPE
    B, S4, H, P, N, Q = (sh[k] for k in "BSHPNQ")
    case = (1, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 0, 0.0)
    errs = dict(check_k3(gen, case, dtype) for dtype in (torch.bfloat16, torch.float32))
    args = ssd_inputs(gen, B, S4, H, P, N, torch.bfloat16)
    chunk_decay = -(args[1] * args[2]).reshape(B, S4 // Q, Q, H).sum(2)
    hot_heads = int((chunk_decay > 88).flatten(0, 1).any(0).sum())
    if hot_heads == 0:
        fail("no head's chunk decay passes 88 at jamba's SSD shape")
    for dtype, a in (("bf16", args), ("f32", ssd_inputs(gen, B, S4, H, P, N, torch.float32))):
        errs[f"ssd B{B} S{S4} H{H} P{P} N{N} Q{Q} {dtype}"] = check_k4(a, Q)[0]
    timer = Timer()
    k3 = k3_times(timer, gen, *case[:-1])
    k4 = k4_times(timer, args, Q)
    torch.cuda.empty_cache()
    log(f"phase 24 jamba kernels vs plain on {card}: flash_prefill at B1 S{S} "
        f"{cfg.num_heads}/{cfg.num_kv_heads} D{cfg.head_dim} (bf16 at atol "
        f"{TOL_K1_BF16['atol']:g}/rtol {TOL_K1_BF16['rtol']:g}, f32 at "
        f"{TOL_F32['atol']:g}/{TOL_F32['rtol']:g}) and ssd_intra_chunk ({hot_heads}/{H} heads "
        f"with a chunk decay above 88, max {chunk_decay.max().item():.1f}; atol "
        f"{TOL_K4:g}·max|ref|, rtol {TOL_K4:g}): max |err| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; times (ms, median of {SAMPLES}, L2 "
        f"flushed): flash_prefill {k3['ms']:.5f} ({k3['TFLOP_per_s']:.1f} TFLOP/s), plain "
        f"{k3['plain_ms']:.5f}, {k3['library_backend']} {k3['library_ms']:.5f} (by backend "
        f"{json.dumps(k3['library_ms_by_backend'])}), bound {k3['bound_ms']:.5f} "
        f"({k3['bound_by']}), host µs a call {k3['host_us']:.1f}; ssd_intra_chunk "
        f"{k4['ms']:.5f}, plain {k4['plain_ms']:.5f}, bound {k4['bound_ms']:.5f} "
        f"({k4['bound_by']}; {k4['bytes']} bytes, {k4['flops']} flops), library none")
    return {"max_abs_err": errs, "hot_heads": hot_heads,
            "max_chunk_decay": chunk_decay.max().item(),
            "times": {"flash_prefill": k3, "ssd_intra_chunk": k4}}


def ssd_spans(fn):
    """Call ``fn`` with CUDA events around every ``ssd_chunked`` call of the
    SSM layers and every K4 launch inside them. Returns (fn's result, ms
    between the events summed for ``ssd_chunked``, for K4)."""
    import repro_torch.kernels.ssd.ops as ops
    import repro_torch.models.ssm as ssm

    spans = {"scan": [], "k4": []}
    scan, k4 = ssm.ssd_chunked, ops.ssd_intra_chunk_cuda

    def timed(key, f):
        def call(*a, **kw):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = f(*a, **kw)
            stop.record()
            spans[key].append((start, stop))
            return out
        return call

    ssm.ssd_chunked, ops.ssd_intra_chunk_cuda = timed("scan", scan), timed("k4", k4)
    try:
        out = fn()
    finally:
        ssm.ssd_chunked, ops.ssd_intra_chunk_cuda = scan, k4
    torch.cuda.synchronize()
    return out, *(sum(a.elapsed_time(b) for a, b in spans[k]) for k in ("scan", "k4"))


def phase_jamba_long(cfg, model, rng, card, n, S=JAMBA_LONG, max_new=MAX_NEW):
    """One prompt of ``S`` tokens at B=1 under ``dropless_moe()``: its
    time to first token (host clock, ending in a sync), the same prefill
    under the profiler (device busy, K3's and K4's device time) and with
    CUDA events around each SSM layer's ``ssd_chunked`` and each K4 launch
    (the chunked scan outside K4: the inter-chunk recurrence and the
    off-diagonal term); then ``max_new`` greedy decode steps."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.models.moe import dropless_moe

    dev = model.device
    n_attn, n_ssm, _ = layer_counts(cfg)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, S)).astype(
        np.int32)).to(dev)
    cache_len = S + max_new
    with dropless_moe():
        f0, s0 = flash_prefill_cuda.launches, ssd_intra_chunk_cuda.launches
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(toks, cache_len=cache_len)
        sync(dev)
        ttft_ms = 1e3 * (time.perf_counter() - t0)
        if (flash_prefill_cuda.launches - f0, ssd_intra_chunk_cuda.launches - s0) != (
                n_attn, n_ssm):
            fail(f"the {S}-token prefill did not launch K3 {n_attn} and K4 {n_ssm} times")
        if not torch.isfinite(logits).all():
            fail(f"{cfg.name}: the {S}-token prefill produced non-finite logits")
        tok = logits.argmax(-1).to(torch.int32)
        sync(dev)
        t0 = time.perf_counter()
        for k in range(max_new):
            logits, cache = model.decode_step(tok, torch.tensor([S + k], dtype=torch.int32,
                                                                device=dev), cache)
            if not torch.isfinite(logits).all():
                fail(f"{cfg.name}: decode step {k} after {S} tokens produced non-finite logits")
            tok = logits.argmax(-1).to(torch.int32)
        sync(dev)
        step_ms = 1e3 * (time.perf_counter() - t0) / max_new
        del cache
        prof = profile_steps(lambda: model.prefill(toks, cache_len=cache_len), dev, steps=1,
                             watch=("flash_prefill", "ssd_intra_chunk"))
        sync(dev)
        t0 = time.perf_counter()
        _, scan_ms, k4_ms = ssd_spans(lambda: model.prefill(toks, cache_len=cache_len))
        spans_wall = 1e3 * (time.perf_counter() - t0)
    torch.cuda.empty_cache()
    busy = prof["device_busy_ms_per_step"]
    k3_dev, k4_dev = (prof["watch_ms_per_step"][w] for w in ("flash_prefill", "ssd_intra_chunk"))
    info = {"prompt_tokens": S, "ttft_ms": ttft_ms, "decode_step_ms_b1": step_ms,
            "profile": prof, "flash_prefill_share_of_busy": k3_dev / busy if busy else None,
            "ssd_intra_chunk_share_of_busy": k4_dev / busy if busy else None,
            "ssd_chunked_span_ms": scan_ms, "ssd_intra_chunk_span_ms": k4_ms,
            "scan_outside_k4_span_ms": scan_ms - k4_ms, "spans_run_wall_ms": spans_wall,
            "scan_outside_k4_share_of_wall": (scan_ms - k4_ms) / spans_wall}
    log(f"phase {n} {cfg.name} long prompt on {card} (dropless): a {S}-token prefill at B=1, "
        f"TTFT {ttft_ms:.1f} ms (K3 {n_attn}, K4 {n_ssm} launches), logits finite; "
        f"{max_new} greedy steps {step_ms:.2f} ms a step; the prefill again under the "
        f"profiler: {profile_line(prof)}; flash_prefill {k3_dev:.2f} ms (share of busy "
        f"{info['flash_prefill_share_of_busy'] or 0:.3f}), ssd_intra_chunk {k4_dev:.2f} ms "
        f"({info['ssd_intra_chunk_share_of_busy'] or 0:.3f}); once more with CUDA events: "
        f"ssd_chunked {scan_ms:.2f} ms in {n_ssm} layers, K4 inside {k4_ms:.2f} ms, the "
        f"inter-chunk scan and off-diagonal term (ssd_chunked outside K4) {scan_ms - k4_ms:.2f}"
        f" ms, {100 * info['scan_outside_k4_share_of_wall']:.1f}% of that prefill's "
        f"{spans_wall:.1f} ms wall")
    return info


def phase_jamba(cfg, prompts, rng, card):
    """jamba-v0.1-52b at published width and ``cfg.num_layers`` layers,
    random weights from seed 0: the main path, the capacity path and the
    long prompt on bf16 weights, then (those freed) fp32 teacher forcing
    over one super-block. Peak device memory after each."""
    from repro_torch.models import build_model

    peak_gb()
    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    peaks = {"init": peak_gb()}
    n_attn, n_ssm, n_moe = layer_counts(cfg)
    log(f"model: {cfg.name} {cfg.num_layers} of 32 layers ({n_attn} attention, {n_ssm} SSM, "
        f"{n_moe} MoE of {cfg.num_experts} experts top {cfg.top_k}), {n_params / 1e9:.2f} B "
        f"params ({2 * n_params / 1e9:.1f} GB in bf16; the reference's analytic count "
        f"{cfg.param_count() / 1e9:.2f} B leaves out the SSM layers' dense FFNs), initialised "
        f"in {time.perf_counter() - t0:.1f} s, peak {peaks['init']:.1f} GB")
    serve = phase_moe_serve(cfg, model, prompts, MAX_NEW, card, 25)
    peaks["serve"] = peak_gb()
    capacity = phase_moe_capacity(cfg, model, rng, card, 26)
    peaks["capacity"] = peak_gb()
    long = phase_jamba_long(cfg, model, rng, card, 27)
    peaks["long_prompt"] = peak_gb()
    del model
    torch.cuda.empty_cache()
    tf = phase_moe_teacher_forced(cfg, JAMBA_TF_LAYERS, rng, card, 28)
    peaks["teacher_forced"] = peak_gb()
    log(f"{cfg.name} peak device memory (GB) by phase on {card}: "
        + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()))
    return {"params": n_params, "serve": serve, "capacity": capacity, "long_prompt": long,
            "teacher_forced": tf, "peak_gb": peaks,
            "longest_prompt": max(len(p) for p in prompts)}


# ---------------------------------------------------------------------------
# phases 29-31: the encoder-decoder (whisper-base) and the serving CLI
# ---------------------------------------------------------------------------
def phase_whisper_kernels(gen, cfg, card):
    """K3 at whisper's decoder self-attention shapes (B=1, 8/8 heads at
    head_dim 64, prompts of 1 to 224 tokens), bf16 and f32 at phase 12's
    tolerances, then timed at the longest beside its bound, its plain
    version and SDPA (each backend alone)."""
    H, D = cfg.num_heads, cfg.head_dim
    errs = dict(check_k3(gen, (1, S, H, cfg.num_kv_heads, D, 0, 0.0), dtype)
                for S in WHISPER_K3_S for dtype in (torch.bfloat16, torch.float32))
    k3 = k3_times(Timer(), gen, 1, max(WHISPER_K3_S), H, cfg.num_kv_heads, D, 0)
    torch.cuda.empty_cache()
    log(f"phase 29 flash_prefill at whisper-base's decoder shapes on {card}: B1 S"
        f"{'/'.join(map(str, WHISPER_K3_S))} {H}/{cfg.num_kv_heads} D{D} (bf16 at atol "
        f"{TOL_K1_BF16['atol']:g}/rtol {TOL_K1_BF16['rtol']:g}, f32 at "
        f"{TOL_F32['atol']:g}/{TOL_F32['rtol']:g}): max |err| "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; times at S{max(WHISPER_K3_S)} (ms, "
        f"median of {SAMPLES}, L2 flushed): flash_prefill {k3['ms']:.5f} "
        f"({k3['TFLOP_per_s']:.1f} TFLOP/s), plain {k3['plain_ms']:.5f}, "
        f"{k3['library_backend']} {k3['library_ms']:.5f} (by backend "
        f"{json.dumps(k3['library_ms_by_backend'])}), bound {k3['bound_ms']:.5f} "
        f"({k3['bound_by']}; {k3['bytes']} bytes, {k3['flops']} flops), host µs a call "
        f"{k3['host_us']:.1f}")
    return {"max_abs_err": errs, "times": {"flash_prefill": k3}}


def whisper_frames(cfg, B, dtype, seed):
    """(B, encoder_seq, d_model) stub-frontend frames from a numpy seed."""
    a = np.random.default_rng(seed).standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                                    dtype=np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def phase_whisper_serve(cfg, model, prompts, frames, max_new, card):
    """Each request prefilled alone (B=1) with its own frames (the encoder
    over 1,500 frames, K3 in each decoder layer's self-attention, the
    cross K/V of the encoder's output cached), the self and cross caches
    joined on the batch axis, greedy decode at B=8: the first batched step
    picks each stream's B=1 token outside near-ties (phase 9's rule), and
    the cross caches come out of the 16 steps bitwise as they went in. Then
    the encoder at 8 x 1,500 frames, a B=1 prefill of the longest prompt
    and a B=8 decode step under the profiler, and a step's syncs."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.models.attention import attention_full
    from repro_torch.models.transformer import encode

    dev, B, L = model.device, len(prompts), cfg.num_layers
    cache_len = max(len(p) for p in prompts) + max_new + 8   # room for the profiled steps
    flash_prefill_cuda.launches = 0
    attention_full.paths = dict.fromkeys(attention_full.paths, 0)
    caches, first, prefill_ms = [], [], []
    for i, prompt in enumerate(prompts):
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(toks, cache_len=cache_len, frames=frames[i:i + 1])
        sync(dev)
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        if not torch.isfinite(logits).all():
            fail(f"{cfg.name} prefill produced non-finite logits")
        first.append(int(logits[0].argmax()))
        caches.append(cache)
    launches, paths = flash_prefill_cuda.launches, dict(attention_full.paths)
    if launches != L * B:
        fail(f"flash_prefill launched {launches} times, expected {L} x {B} prefills")
    if paths != {"flash_prefill": L * B, "positions": 0,
                 "memory": (L + cfg.encoder_layers) * B}:
        fail(f"attention paths {paths}: expected {L} flash_prefill and {L} cross + "
             f"{cfg.encoder_layers} encoder memory layers a prefill")
    cache = tree_cat(caches, dim=1)        # leaves are (L, B, ...): batch is axis 1
    cross0 = tree_clone(cache["pos0"]["cross"])
    tok = torch.tensor(first, dtype=torch.int32, device=dev)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    logits, cache = model.decode_step(tok, pos, cache)
    if not torch.isfinite(logits).all():
        fail(f"{cfg.name} decode step 0 produced non-finite logits")
    alone = torch.cat([model.decode_step(tok[i:i + 1], pos[i:i + 1], tree_clone(caches[i]))[0]
                       for i in range(B)])
    del caches
    batch_err = (logits - alone).abs().max().item()
    batch_ties = first_step_ties(logits, alone)
    streams = [tok, logits.argmax(-1).to(torch.int32)]
    sync(dev)
    t0 = time.perf_counter()
    for k in range(1, max_new):
        logits, cache = model.decode_step(streams[-1], pos + k, cache)
        if not torch.isfinite(logits).all():
            fail(f"{cfg.name} decode step {k} produced non-finite logits")
        streams.append(logits.argmax(-1).to(torch.int32))
    sync(dev)
    t_decode = time.perf_counter() - t0
    if flash_prefill_cuda.launches != launches:
        fail("decode launched flash_prefill")
    tokens = torch.stack(streams, dim=1).tolist()
    if [t[0] for t in tokens] != first:
        fail("a stream does not start from the argmax of its own prefill")
    if changed := [k for k, v in cross0.items() if not torch.equal(cache["pos0"]["cross"][k], v)]:
        fail(f"decode rewrote the sealed cross caches: {changed}")

    state = {"tok": streams[-1], "k": max_new}

    def step():
        logits, _ = model.decode_step(state["tok"], pos + state["k"], cache)
        state["tok"] = logits.argmax(-1).to(torch.int32)
        state["k"] += 1

    syncs = count_syncs(step)
    n_syncs = sum(syncs.values())
    prof = profile_steps(step, dev, steps=3)
    enc_prof = profile_steps(lambda: encode(model["encoder"], cfg, frames), dev, steps=2)
    longest = max(prompts, key=len)
    toks = torch.tensor([longest], dtype=torch.int32, device=dev)
    prefill_prof = profile_steps(lambda: model.prefill(toks, frames=frames[:1]), dev, steps=2,
                                 watch=("flash_prefill",))
    del cache
    torch.cuda.empty_cache()
    step_ms = 1e3 * t_decode / (max_new - 1)
    info = {"prompt_lens": [len(p) for p in prompts], "cache_len": cache_len,
            "prefill_ms": prefill_ms, "launches": launches, "attention_paths": paths,
            "batched_vs_alone_max_abs_err": batch_err,
            "batched_vs_alone_near_ties": batch_ties, "cross_cache_unchanged": True,
            f"decode_step_ms_b{B}": step_ms, f"decode_tokens_per_s_b{B}": 1e3 * B / step_ms,
            "decode_syncs_per_step": n_syncs, "decode_syncs_by_line": syncs,
            "decode_profile": prof, "encoder_profile": enc_prof,
            "prefill_b1_profile": prefill_prof}
    log(f"phase 30 {cfg.name} main path on {card}: {B} prefills alone with "
        f"{cfg.encoder_seq} frames each (decoder prompt lengths {info['prompt_lens']}), "
        f"flash_prefill launches {launches} = {L} x {B}, memory path {paths['memory']} = "
        f"({cfg.encoder_layers} encoder + {L} cross) x {B}, prefill ms "
        f"{[round(t, 1) for t in prefill_ms]}; self and cross caches joined, {max_new} greedy "
        f"steps at B={B}: logits finite, first step vs each stream alone: tokens equal but at "
        f"near-ties {batch_ties}, max |Δlogit| {batch_err:.3e}; cross caches bitwise "
        f"unchanged; decode step {step_ms:.2f} ms (the {max_new - 1} steps after the "
        f"first), {info[f'decode_tokens_per_s_b{B}']:.1f} tokens/s")
    log(f"phase 30 where whisper-base's time goes on {card}: encoder over {B} x "
        f"{cfg.encoder_seq} frames (2 passes, then 2 under the profiler): "
        f"{profile_line(enc_prof)}; B=1 prefill of {len(longest)} tokens with its frames: "
        f"{profile_line(prefill_prof)}; flash_prefill "
        f"{prefill_prof['watch_ms_per_step']['flash_prefill']:.4f} ms a prefill; B={B} decode "
        f"step ({n_syncs} device-to-host syncs, by line {syncs}): {profile_line(prof)}")
    return info


def phase_whisper_teacher_forced(model, cfg, card, K=100, steps=8):
    """The served model in fp32, all of its layers (encoder and decoder):
    B=2 with frames from a numpy seed, each decode step against a kernel
    prefill of its prefix plus that token, within 1e-3 and with the same
    argmax. The model is converted in place: it is the phase's last use."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda

    m32 = model.float()
    dev = m32.device
    frames = whisper_frames(cfg, 2, torch.float32, seed=31)
    toks = torch.from_numpy(np.random.default_rng(32).integers(
        1, cfg.vocab_size, size=(2, K + steps)).astype(np.int32)).to(dev)
    n0 = flash_prefill_cuda.launches
    errs = []
    logits, cache = m32.prefill(toks[:, :K], cache_len=K + steps, frames=frames)
    for t in range(K, K + steps):
        ref, _ = m32.prefill(toks[:, : t + 1], frames=frames)
        logits, cache = m32.decode_step(toks[:, t], torch.full((2,), t, dtype=torch.int32,
                                                               device=dev), cache)
        errs.append((logits - ref).abs().max().item())
        if not torch.equal(logits.argmax(-1), ref.argmax(-1)):
            fail(f"fp32 decode step {t} picks another token than the prefill of its prefix")
    if flash_prefill_cuda.launches - n0 != cfg.num_layers * (steps + 1):
        fail("the fp32 prefills did not all run the flash-prefill kernel")
    err = max(errs)
    if err > TOL_TF:
        fail(f"fp32 decode vs prefill max |err| {err:.3e} > {TOL_TF:g}")
    log(f"phase 30 {cfg.name} fp32 teacher forcing on {card}: all {cfg.encoder_layers} + "
        f"{cfg.num_layers} layers in fp32, B=2 with {cfg.encoder_seq} frames, prefill {K} "
        f"tokens, {steps} decode steps each against a kernel prefill of its prefix: max |err| "
        f"{err:.3e} (atol {TOL_TF:g}), argmax equal")
    return {"max_abs_err": err, "per_step": errs}


def phase_whisper(cfg, rng, card):
    """whisper-base at published width and depth, random weights from seed
    0, frames from a numpy seed: the main path, then fp32 teacher forcing."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {cfg.name} {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
        f"{n_params / 1e6:.2f} M params (analytic {cfg.param_count() / 1e6:.2f} M), "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    lo, hi = WHISPER_PROMPTS
    lens = [lo, hi] + rng.integers(lo + 1, hi, size=6).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in lens]
    frames = whisper_frames(cfg, len(prompts), torch.bfloat16, seed=30)
    serve = phase_whisper_serve(cfg, model, prompts, frames, MAX_NEW, card)
    tf = phase_whisper_teacher_forced(model, cfg, card)
    del model
    torch.cuda.empty_cache()
    return {"params": n_params, "serve": serve, "teacher_forced": tf}


def phase_serve_cli(card):
    """``repro_torch.launch.serve.main`` in-process at the reference's
    defaults (16 requests, 12 new tokens, d_model 256, 4 layers, 8 active),
    then with ``--sleep-us 5``: on the card, 0 sandbox violations, every
    page and seal returned, K3 once a layer per prefill and K1 once a layer
    per decode step, counted around each call."""
    import contextlib
    import io

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.launch import serve

    runs = {}
    for argv in ([], ["--sleep-us", "5"]):
        out = io.StringIO()
        paged_attention.launches = flash_prefill_cuda.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            eng = serve.main(argv)
        sync(eng.device)
        wall = time.perf_counter() - t0
        k1, k3 = paged_attention.launches, flash_prefill_cuda.launches
        L, n_req = eng.cfg.num_layers, len(eng.finished)
        name = " ".join(argv) or "defaults"
        if eng.device.type != "cuda":
            fail(f"the CLI ({name}) served on {eng.device}")
        if eng.oob_events:
            fail(f"the CLI ({name}): {eng.oob_events} sandbox violations")
        if eng.pool.stats()["sealed_pages"]:
            fail(f"the CLI ({name}) left sealed pages: {eng.pool.stats()}")
        if (k1, k3) != (L * eng.decode_steps, L * n_req) or n_req != 16:
            fail(f"the CLI ({name}): paged_attention {k1} and flash_prefill {k3} launches, "
                 f"expected {L} x {eng.decode_steps} steps and {L} x 16 prefills")
        if eng.policy.fixed != (5.0 if argv else None):
            fail(f"the CLI ({name}) left the engine's policy at {eng.policy.fixed}")
        runs[name] = {"paged_attention": k1, "flash_prefill": k3,
                      "decode_steps": eng.decode_steps, "oob_events": eng.oob_events,
                      "policy_fixed_us": eng.policy.fixed, "wall_s": wall,
                      "printed": out.getvalue().splitlines()}
        eng.shutdown()
        del eng
    log(f"phase 31 the serving CLI on {card} (python -m repro_torch.launch.serve, in-process): "
        + "; ".join(f"{name}: {r['decode_steps']} decode steps, paged_attention launches "
                    f"{r['paged_attention']}, flash_prefill launches {r['flash_prefill']}, "
                    f"sandbox violations {r['oob_events']}, policy sleep "
                    f"{r['policy_fixed_us']} µs, {r['wall_s']:.2f} s; printed "
                    f"{[line for line in r['printed'] if not line.startswith('  req')]}"
                    for name, r in runs.items()))
    return runs


# ---------------------------------------------------------------------------
# phases 32-35: training (the kernels' gradients, olmo-1b, mamba2-1.3b, the CLI)
# ---------------------------------------------------------------------------
def max_rel(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    return (got.float() - want.float()).abs().max().item() / max(
        want.float().abs().max().item(), 1e-30)


def sdpa_grad_times(timer, qs, ks, vs, do_s, gqa):
    """SDPA (causal) under each backend alone: its backward by itself (one
    ``autograd.grad`` over a retained graph: the backward kernel the
    forward chose) and its forward + backward. Returns the backend whose
    backward is fastest, that ms, its forward + backward ms, and every
    backend's pair or why it refused the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    every = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            every[name] = "not in this torch"
            continue

        def fwd(backend=backend):
            with sdpa_kernel(backend):
                return sdpa(qs, ks, vs, is_causal=True, enable_gqa=gqa)
        try:
            o = fwd()
            torch.autograd.grad(o, (qs, ks, vs), do_s, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError as e:
            every[name] = "refused: " + (str(e).strip().splitlines() or ["?"])[0][:160]
            continue
        every[name] = {
            "bwd_ms": timer.ms(lambda: torch.autograd.grad(o, (qs, ks, vs), do_s,
                                                           retain_graph=True), samples=5),
            "fwd_bwd_ms": timer.ms(lambda: torch.autograd.grad(fwd(), (qs, ks, vs), do_s),
                                   samples=5)}
        del o
    timed = {k: v for k, v in every.items() if isinstance(v, dict)}
    if not timed:
        fail(f"no SDPA backend took the backward yardstick's inputs: {every}")
    best = min(timed, key=lambda k: timed[k]["bwd_ms"])
    return best, timed[best]["bwd_ms"], timed[best]["fwd_bwd_ms"], every


def k3_grad_case(gen, timer, case, dtype):
    """``FlashPrefillFn`` (K3's forward and the backward kernel) against
    ``flash_prefill_vjp`` applied to the plain forward, at one (B, S, Hq,
    Hkv, D, window, softcap) case: finite, one backward launch, and a
    second gradient bitwise the first; fp32 also against autograd through
    the plain version; then the backward kernel alone against
    ``flash_prefill_vjp`` given the kernel forward's own O and lse, at
    K3's kernel tolerance (``TOL_K3``). Returns the case's errors and
    times: the backward
    kernel alone beside its bound (bf16) and the plain vjp, K3's forward,
    and SDPA's backward and forward + backward where SDPA computes the
    function (no window, no softcap)."""
    from repro_torch.kernels.flash_prefill import (FlashPrefillFn, flash_prefill_ref,
                                                   flash_prefill_vjp)
    from repro_torch.kernels.flash_prefill.kernel import (flash_prefill_bwd_cuda,
                                                          flash_prefill_cuda)

    B, S, Hq, Hkv, D, window, softcap = case
    q, k, v = (t.requires_grad_() for t in k3_inputs(gen, B, S, Hq, Hkv, D, dtype))
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    fn = lambda: FlashPrefillFn.apply(q, k, v, window, softcap, flash_prefill_cuda)  # noqa: E731
    n0 = flash_prefill_bwd_cuda.launches
    got = torch.autograd.grad(fn(), (q, k, v), dout)
    again = torch.autograd.grad(fn(), (q, k, v), dout)
    torch.cuda.synchronize()
    name = f"B{B} S{S} {Hq}/{Hkv} D{D} w{window} cap{softcap:g} {str(dtype)[6:]}"
    if flash_prefill_bwd_cuda.launches != n0 + 2:
        fail(f"two gradients through FlashPrefillFn launched the backward kernel "
             f"{flash_prefill_bwd_cuda.launches - n0} times, not twice ({name})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_prefill's backward kernel is not bitwise repeatable ({name})")
    with torch.no_grad():
        plain = flash_prefill_ref(q, k, v, window=window, softcap=softcap)
        want = flash_prefill_vjp(q, k, v, plain, dout, window=window, softcap=softcap)
    out = {"max_abs_err": 0.0, "bitwise_repeatable": True}
    for part, g, w in zip("qkv", got, want):
        if g.dtype != dtype or not torch.isfinite(g.float()).all():
            fail(f"flash_prefill's d{part} is not finite {dtype} ({name})")
        if not torch.allclose(g.float(), w.float(), **(TOL_F32 if dtype == torch.float32
                                                       else TOL_BF16)):
            fail(f"flash_prefill's d{part} through the kernel disagrees with the plain "
                 f"gradient ({name}): max |err| {(g.float() - w.float()).abs().max().item():.3e}")
        out["max_abs_err"] = max(out["max_abs_err"], (g.float() - w.float()).abs().max().item())
    del got, again
    qd, kd, vd = (t.detach() for t in (q, k, v))
    with torch.no_grad():
        o, lse = flash_prefill_cuda(qd, kd, vd, window=window, softcap=softcap, return_lse=True)
    # the kernel alone against the plain gradient given the kernel forward's
    # own O and lse (its formulation), at K3's kernel tolerance: both sides
    # accumulate in fp32, so bf16 grads differ by about their rounding
    with torch.no_grad():
        alone = flash_prefill_bwd_cuda(qd, kd, vd, o, dout, lse, window=window, softcap=softcap)
        same = flash_prefill_vjp(qd, kd, vd, o, dout, window=window, softcap=softcap, lse=lse)
    tol = out["kernel_tol"] = TOL_K3[dtype]
    out["kernel_vs_vjp_same_lse_max_abs_err"] = out["kernel_vs_vjp_same_lse_tol_used"] = 0.0
    for part, g, w in zip("qkv", alone, same):
        diff = (g.float() - w.float()).abs()
        err = diff.max().item()
        # the largest share of its allowance, atol + rtol·|want|, an element uses
        used = (diff / (tol["atol"] + tol["rtol"] * w.float().abs())).max().item()
        if not used <= 1:   # NaN too
            fail(f"flash_prefill_bwd_cuda's d{part} disagrees with flash_prefill_vjp given "
                 f"the same O and lse ({name}): max |err| {err:.3e}, {used:.2f} of the "
                 f"allowance (atol {tol['atol']:g}, rtol {tol['rtol']:g})")
        out["kernel_vs_vjp_same_lse_max_abs_err"] = max(
            out["kernel_vs_vjp_same_lse_max_abs_err"], err)
        out["kernel_vs_vjp_same_lse_tol_used"] = max(out["kernel_vs_vjp_same_lse_tol_used"], used)
    del alone, same, diff
    out["bwd_ms"] = timer.ms(lambda: flash_prefill_bwd_cuda(qd, kd, vd, o, dout, lse,
                                                           window=window, softcap=softcap))
    if dtype == torch.float32:   # the explicit gradient against autograd's
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(flash_prefill_ref(*leaves, window=window, softcap=softcap),
                                   leaves, dout)
        out["vjp_vs_autograd_max_rel"] = max(max_rel(w, a) for w, a in zip(want, auto))
        if out["vjp_vs_autograd_max_rel"] > TOL_K4:
            fail(f"flash_prefill_vjp disagrees with autograd of the plain version ({name}): "
                 f"{out['vjp_vs_autograd_max_rel']:.3e} of the max")
    else:
        # 10·D operations a visible pair and query head; q, k, v, O, dO and lse
        # read, dq, dk and dv written once
        nbytes = 2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * B * Hq * S
        flops = 10 * D * Hq * B * k3_pairs(S, window)
        b_ms, b_by = bound_ms(nbytes, flops)
        out.update({
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "bwd_TFLOP_per_s": flops / out["bwd_ms"] / 1e9,
            "fwd_ms": timer.ms(lambda: flash_prefill_cuda(qd, kd, vd, window=window,
                                                          softcap=softcap)),
            "vjp_ms": timer.ms(lambda: flash_prefill_vjp(qd, kd, vd, plain, dout, window=window,
                                                         softcap=softcap), samples=5),
            "sdpa_bwd_ms": None, "sdpa_fwd_bwd_ms": None, "sdpa_backend": None})
        if not window and not softcap:
            qs, ks, vs = (t.transpose(1, 2).requires_grad_() for t in (qd, kd, vd))
            best, bwd, fwd_bwd, every = sdpa_grad_times(timer, qs, ks, vs,
                                                        dout.transpose(1, 2), Hq != Hkv)
            out.update({"sdpa_bwd_ms": bwd, "sdpa_fwd_bwd_ms": fwd_bwd,
                        "sdpa_backend": f"SDPA {best}", "sdpa_by_backend": every})
    return name, out


def phase_kernel_grads(gen, card):
    """Phase 32: the kernels' ``autograd.Function``s on the card. K3 (its
    forward and backward kernels) at olmo-1b's training shape (B 8, S 512,
    16/16, D 128) and gemma3's (D 256, window 1,024, softcap 50), fp32 and
    bf16, against the plain gradient (``grad.py``) applied to the plain
    forward, finite and bitwise repeatable; the backward kernel alone
    against the plain gradient given the kernel forward's O and lse at
    ``TOL_K3``; the backward kernel timed beside its bound, the plain
    gradient and SDPA. K4 at mamba2's
    shape with chunk decays above 88: the Function's grads against
    ``ssd_intra_chunk_vjp`` on the same inputs, all finite, and the
    chunked scan's grads through the kernel against autograd through the
    token recurrence (B 1, fp32)."""
    from repro_torch.kernels.ssd import (SsdIntraChunkFn, ssd_chunked, ssd_intra_chunk_vjp,
                                         ssd_sequential_ref)
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    timer = Timer()
    k3 = dict(k3_grad_case(gen, timer, case, dtype)
              for case in ((8, 512, 16, 16, 128, 0, 0.0), (2, 2048, 16, 8, 256, 1024, 50.0))
              for dtype in (torch.float32, torch.bfloat16))
    torch.cuda.empty_cache()

    sh = SSD_SHAPE
    k4 = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.requires_grad_() for t in
                ssd_inputs(gen, sh["B"], sh["S"], sh["H"], sh["P"], sh["N"], dtype)]
        outs = SsdIntraChunkFn.apply(*args, sh["Q"], ssd_intra_chunk_cuda)
        douts = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]
        got = torch.autograd.grad(outs, args, douts)
        want = ssd_intra_chunk_vjp(*[a.detach() for a in args], sh["Q"], *douts)
        name = f"{str(dtype)[6:]}"
        for part, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
            if g.dtype != w.dtype or not torch.isfinite(g.float()).all():
                fail(f"ssd_intra_chunk's d{part} is not finite above a decay of 88 ({name})")
            if not scaled_close(g.float(), w.float()):
                fail(f"ssd_intra_chunk's d{part} through the Function differs from "
                     f"ssd_intra_chunk_vjp ({name}): {max_rel(g, w):.3e} of the max")
        decay = (-(args[1].detach() * args[2].detach())).reshape(
            sh["B"], -1, sh["Q"], sh["H"]).sum(2).max().item()
        k4[name] = {"max_chunk_decay": decay,
                    "vjp_ms": timer.ms(lambda: ssd_intra_chunk_vjp(
                        *[a.detach() for a in args], sh["Q"], *douts), samples=5)}
        if decay <= 88:
            fail(f"phase 32's K4 inputs reach a chunk decay of {decay:.1f}, not above 88")
    # the chunked scan through the kernel against the recurrence, B 1, fp32
    x, dt, A, Bm, Cm = ssd_inputs(gen, 1, sh["S"], sh["H"], sh["P"], sh["N"], torch.float32)
    Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    w = torch.randn(x.shape, generator=gen, device="cuda")

    def scan_grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, s = fn(*leaves)
        return torch.autograd.grad((y.float() * w).sum() + s.sum(), leaves)
    n0 = ssd_intra_chunk_cuda.launches
    chunked = scan_grads(lambda *a: ssd_chunked(*a, chunk=sh["Q"]))
    if ssd_intra_chunk_cuda.launches != n0 + 1:
        fail("ssd_chunked's forward did not launch K4 once")
    recur = scan_grads(ssd_sequential_ref)
    scan_rel = max(max_rel(g, r) for g, r in zip(chunked, recur))
    if not all(torch.isfinite(g).all() for g in chunked) or scan_rel > TOL_SCAN["atol"]:
        fail(f"the chunked scan's grads through K4 disagree with the recurrence's: "
             f"{scan_rel:.3e} of the max")
    max_decay = max(d["max_chunk_decay"] for d in k4.values())
    k4["scan_vs_recurrence_max_rel"] = scan_rel
    torch.cuda.empty_cache()
    log(f"phase 32 kernel gradients on {card}: flash_prefill through FlashPrefillFn (K3's "
        f"forward and backward kernels) vs flash_prefill_vjp on the plain forward (f32 at "
        f"atol {TOL_F32['atol']:g}, bf16 at atol {TOL_BF16['atol']:g}), finite, one backward "
        f"launch a gradient, two gradients bitwise equal: "
        + "; ".join(f"{n} max |err| {d['max_abs_err']:.2e}, the kernel alone vs the vjp given "
                    f"its O and lse {d['kernel_vs_vjp_same_lse_max_abs_err']:.2e}, "
                    f"{d['kernel_vs_vjp_same_lse_tol_used']:.2f} of its allowance (atol "
                    f"{d['kernel_tol']['atol']:g} + rtol {d['kernel_tol']['rtol']:g} of |want|), "
                    f"backward kernel {d['bwd_ms']:.4f} ms"
                    + (f", vjp vs autograd {d['vjp_vs_autograd_max_rel']:.1e} of the max"
                       if "vjp_vs_autograd_max_rel" in d else
                       f" (bound {d['bound_ms']:.4f} ms by {d['bound_by']}, "
                       f"{d['bwd_TFLOP_per_s']:.1f} TFLOP/s), K3 fwd {d['fwd_ms']:.4f} ms, "
                       f"plain vjp {d['vjp_ms']:.3f} ms"
                       + (f", {d['sdpa_backend']} bwd {d['sdpa_bwd_ms']:.4f} ms, fwd+bwd "
                          f"{d['sdpa_fwd_bwd_ms']:.4f} ms against K3 fwd+bwd "
                          f"{d['fwd_ms'] + d['bwd_ms']:.4f} ms"
                          if d["sdpa_fwd_bwd_ms"] is not None else ""))
                    for n, d in k3.items())
        + f"; ssd_intra_chunk at B{sh['B']} S{sh['S']} H{sh['H']} P{sh['P']} N{sh['N']} "
        f"Q{sh['Q']} (chunk decays up to {max_decay:.1f}): "
        f"Function grads match ssd_intra_chunk_vjp's (rel {TOL_K4:g}) and are finite in f32 "
        f"and bf16, plain vjp "
        f"{k4['float32']['vjp_ms']:.3f} / {k4['bfloat16']['vjp_ms']:.3f} ms; chunked scan "
        f"through K4 vs the recurrence at B1 (f32): {scan_rel:.1e} of the max")
    # the kernels line's backward entry: olmo-1b's training shape in bf16
    olmo = k3["B8 S512 16/16 D128 w0 cap0 bfloat16"]
    bwd = {"ms": olmo["bwd_ms"], "plain_ms": olmo["vjp_ms"], "bound_ms": olmo["bound_ms"],
           "bound_by": olmo["bound_by"], "library_ms": olmo["sdpa_bwd_ms"],
           "library_backend": f"{olmo['sdpa_backend']} backward alone (autograd.grad over "
                              f"its retained graph)"}
    return {"flash_prefill": k3, "ssd_intra_chunk": k4, "flash_prefill_bwd": bwd,
            "max_abs_err": max(d["max_abs_err"] for d in k3.values())}


def train_batch(cfg, B, S, seed=0):
    """One batch of the synthetic packed corpus, on the card."""
    from repro_torch.training import DataConfig, SyntheticPackedDataset

    b = SyntheticPackedDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                          global_batch=B, seed=seed)).batch_at(0)
    return {k: torch.from_numpy(v).cuda() for k, v in b.items()}


def plain_vs_kernel_grads(cfg, batch, plain, layers=2):
    """An fp32 copy at full width and ``layers`` layers: the gradients of
    one loss with the kernels against those with ``plain`` (a patch that
    routes the kernel's calls through its plain version under plain
    autograd, forward and backward: no kernel of the port launches under
    it, asserted). Returns the worst gradient's max |Δ| over its max |g|."""
    from dataclasses import replace

    from repro_torch.kernels.flash_prefill.kernel import (flash_prefill_bwd_cuda,
                                                          flash_prefill_cuda)
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda
    from repro_torch.models import build_model

    counters = (flash_prefill_cuda, flash_prefill_bwd_cuda, ssd_intra_chunk_cuda)

    model = build_model(replace(cfg, num_layers=layers)).init(
        torch.Generator("cuda").manual_seed(0))
    for p in model.parameters():
        p.data = p.data.float()
    model.trainable()
    leaves = list(model.parameters())
    grads = []
    for ctx in (contextlib.nullcontext(), plain):
        n0 = [c.launches for c in counters]
        with ctx:   # the backward too: remat recomputes the forward there
            loss, _ = model.loss_fn(batch)
            grads.append(torch.autograd.grad(loss, leaves))
        if ctx is plain and [c.launches for c in counters] != n0:
            fail(f"{cfg.name}: the plain path launched a kernel: "
                 f"{[c.launches - n for c, n in zip(counters, n0)]}")
    worst = max(max_rel(g, p) for g, p in zip(*grads))
    del model, grads
    torch.cuda.empty_cache()
    return worst


def phase_train_model(cfg, kernel, plain, card, n, steps=20, B=8, S=512):
    """Phases 33 and 34: ``cfg`` at full width and depth, bf16 with fp32
    AdamW state, trained by ``make_train_step`` (remat on) for ``steps``
    steps on one B x S batch of the synthetic packed corpus: the loss falls
    by at least 0.5 (tests/test_training.py's bar); the first gradient of
    every parameter is finite and not all zero; ``kernel`` launches twice a
    layer a step (the forward and the recompute); then step time, tokens/s,
    peak memory and a profiled step; then ``plain_vs_kernel_grads``."""
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda as bwd
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    t0 = time.perf_counter()
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    L = layer_counts(cfg)[0 if kernel.__name__ == "flash_prefill_cuda" else 1]
    L_bwd = layer_counts(cfg)[0]   # K3's backward: once an attention layer a step
    batch = train_batch(cfg, B, S)

    model.trainable()
    names, leaves = zip(*model.named_parameters())
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = bwd.launches = 0
    loss, _ = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    first_launches, first_bwd = kernel.launches, bwd.launches
    bad = [nm for nm, g in zip(names, grads)
           if not torch.isfinite(g).all() or not torch.count_nonzero(g)]
    if bad:
        fail(f"{cfg.name}: first gradients not finite or all zero: {bad}")
    if first_launches != 2 * L:
        fail(f"{cfg.name}: {kernel.__name__} launched {first_launches} times for one loss "
             f"and its gradient, expected 2 x {L} (forward and recompute)")
    if first_bwd != L_bwd:
        fail(f"{cfg.name}: flash_prefill_bwd ran {first_bwd} times for one gradient, "
             f"expected {L_bwd}")
    grad_peak_gb = peak_gb()
    del grads, loss

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    step = make_train_step(model, opt_cfg)
    state = init_opt_state(model.params())
    kernel.launches = bwd.launches = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # syncs
        step_ms.append(1e3 * (time.perf_counter() - t1))
    launches, bwd_launches = kernel.launches, bwd.launches
    train_peak_gb = peak_gb()
    if launches != 2 * L * steps:
        fail(f"{cfg.name}: {kernel.__name__} launched {launches} times in {steps} steps, "
             f"expected 2 x {L} a step")
    if bwd_launches != L_bwd * steps:
        fail(f"{cfg.name}: flash_prefill_bwd ran {bwd_launches} times in {steps} steps, "
             f"expected {L_bwd} a step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] - 0.5:
        fail(f"{cfg.name}: the loss did not fall by 0.5 in {steps} steps: {losses}")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail(f"{cfg.name}: a parameter is not finite after training")
    med = float(np.median(step_ms[2:]))
    prof = profile_steps(lambda: step(state, batch), model.device, steps=2,
                         watch=(kernel.__name__.replace("_cuda", ""), "flash_prefill_bwd"))
    del model, state, step
    torch.cuda.empty_cache()
    worst = plain_vs_kernel_grads(cfg, batch, plain)
    if worst > TOL_TF:
        fail(f"{cfg.name}: fp32 gradients through {kernel.__name__} differ from the plain "
             f"path's by {worst:.3e} of a gradient's max (limit {TOL_TF:g})")
    info = {"params": n_params, "init_s": init_s, "B": B, "S": S, "steps": steps,
            "losses": losses, "step_ms": step_ms, "step_ms_median": med,
            "tokens_per_s": B * S / med * 1e3, "launches": launches,
            "launches_per_step": launches / steps, "bwd_launches": bwd_launches,
            "bwd_launches_per_step": bwd_launches / steps, "first_grad_peak_gb": grad_peak_gb,
            "train_peak_gb": train_peak_gb, "profile": prof,
            "fp32_kernel_vs_plain_grads_max_rel": worst}
    log(f"phase {n} {cfg.name} training on {card}: {n_params / 1e9:.3f} B params (bf16, fp32 "
        f"AdamW state), {steps} steps on one {B} x {S} batch, remat on: loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} (min {min(losses):.4f}); first gradients finite and non-zero "
        f"for all {len(names)} parameters; {kernel.__name__} {first_launches} launches for "
        f"one loss and gradient and {launches / steps:.0f} a step ({L} layers x 2), "
        f"flash_prefill_bwd {first_bwd} and {bwd_launches} in {steps} steps ({L_bwd} a "
        f"step); step "
        f"{med:.1f} ms (median of steps 3-{steps}, host clock, synced), "
        f"{info['tokens_per_s']:.0f} tokens/s; peak {train_peak_gb:.2f} GB training "
        f"({grad_peak_gb:.2f} GB for the first gradient); a step under the profiler: "
        f"{profile_line(prof)}, {kernel.__name__.replace('_cuda', '')} "
        f"{prof['watch_ms_per_step'][kernel.__name__.replace('_cuda', '')]:.2f} ms, "
        f"flash_prefill_bwd {prof['watch_ms_per_step']['flash_prefill_bwd']:.2f} ms; fp32 at 2 "
        f"layers: gradients with the kernel vs the plain version {worst:.2e} of the max")
    return info


def phase_train_cli(card, steps=40, every=20):
    """Phase 35: ``repro_torch.launch.train.main`` in-process at the
    reference's defaults (olmo-768x12, B 8 x S 512) for ``steps`` steps
    with a checkpoint every ``every``; then, as after a crash once step
    ``every``'s checkpoint was written, ``--resume``: its parameters and
    optimizer state must equal the uninterrupted run's bitwise. K3 launches
    twice a layer a step. The checkpoints go under build/ and are removed."""
    import io
    import shutil
    import warnings

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda, flash_prefill_cuda
    from repro_torch.launch import train
    from repro_torch.training.optimizer import tree_leaves

    ckpt = ROOT / "build" / "train_cli_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--steps", str(steps), "--ckpt-every", str(every), "--ckpt-dir", str(ckpt)]
    runs = {}
    try:
        for name, extra in (("whole", []), ("resumed", ["--resume"])):
            out = io.StringIO()
            flash_prefill_cuda.launches = flash_prefill_bwd_cuda.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                res = train.main(argv + extra)
            sync(res["model"].device)
            runs[name] = dict(res, wall_s=time.perf_counter() - t0,
                              launches=flash_prefill_cuda.launches,
                              bwd_launches=flash_prefill_bwd_cuda.launches,
                              printed=out.getvalue().splitlines())
            if name == "whole":
                shutil.rmtree(ckpt / f"step_{steps:09d}")
        whole, resumed = runs["whole"], runs["resumed"]
        L = whole["model"].cfg.num_layers
        if resumed["model"].device.type != "cuda":
            fail(f"the training CLI ran on {resumed['model'].device}")
        for name, r in runs.items():
            want = 2 * L * (steps - r["start"])
            if r["launches"] != want or r["bwd_launches"] != want // 2:
                fail(f"the training CLI ({name}): flash_prefill {r['launches']} and "
                     f"flash_prefill_bwd {r['bwd_launches']} launches, expected {want} and "
                     f"{want // 2}")
        if resumed["start"] != every or f"resumed from step {every}" not in resumed["printed"]:
            fail(f"the training CLI did not resume from step {every}: {resumed['printed'][:3]}")
        diffs = {nm: (a.float() - b.float()).abs().max().item()
                 for (nm, a), (_, b) in zip(whole["model"].named_parameters(),
                                            resumed["model"].named_parameters())}
        bitwise = all(torch.equal(a, b) for a, b in zip(whole["model"].parameters(),
                                                        resumed["model"].parameters()))
        opt_equal = all(torch.equal(a, b) for key in ("m", "v")
                        for a, b in zip(tree_leaves(whole["opt_state"][key]),
                                        tree_leaves(resumed["opt_state"][key])))
        nondeterministic = []
        if not (bitwise and opt_equal):
            # name the ops without a deterministic implementation on a step
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    train.main(["--steps", "1", "--ckpt-every", "0", "--ckpt-dir",
                                str(ckpt / "probe")])
                finally:
                    torch.use_deterministic_algorithms(False)
            nondeterministic = sorted({str(w.message).splitlines()[0][:160] for w in caught
                                       if "deterministic" in str(w.message)})
            log(f"phase 35: the resumed run differs from the uninterrupted one: largest "
                f"parameter difference {max(diffs.values()):.3e} "
                f"({max(diffs, key=diffs.get)}); ops without a deterministic implementation: "
                f"{nondeterministic}")
            fail("the training CLI's resumed run does not equal the uninterrupted run")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    info = {name: {"start": r["start"], "launches": r["launches"],
                   "bwd_launches": r["bwd_launches"], "wall_s": r["wall_s"],
                   "losses": r["losses"], "printed": r["printed"]} for name, r in runs.items()}
    info["bitwise"] = True
    info["flash_prefill"] = whole["launches"] + resumed["launches"]
    info["flash_prefill_bwd"] = whole["bwd_launches"] + resumed["bwd_launches"]
    log(f"phase 35 the training CLI on {card} (python -m repro_torch.launch.train, in-process, "
        f"{whole['model'].cfg.name}, {steps} steps, a checkpoint every {every}): "
        f"uninterrupted {whole['wall_s']:.1f} s, flash_prefill {whole['launches']} and "
        f"flash_prefill_bwd {whole['bwd_launches']} launches, loss {whole['losses'][0]:.4f} -> "
        f"{whole['losses'][-1]:.4f}; resumed from step {every} after removing step {steps}'s "
        f"checkpoint: {resumed['wall_s']:.1f} s, {resumed['launches']} and "
        f"{resumed['bwd_launches']} launches, parameters and optimizer state bitwise equal to the "
        f"uninterrupted run's; printed {[line for line in whole['printed'] if 'step' not in line]}")
    del runs, whole, resumed
    torch.cuda.empty_cache()
    return info


def operator_calls(step) -> dict:
    """The aten operators one call of ``step`` issues, forward and
    backward (the backward kept on this thread, where a dispatch mode
    sees it), counted at the top level: all of them, and those with a
    DTensor argument (each one a DTensor dispatch: sharding propagation,
    then the operator on the local tensors)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = dtensor_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            Count.dtensor_ops += any(issubclass(t, DTensor) for t in types)
            return func(*args, **(kwargs or {}))

    with torch.autograd.set_multithreading_enabled(False), Count():
        step()
    torch.cuda.synchronize()
    return {"ops": Count.ops, "dtensor_ops": Count.dtensor_ops}


def host_profile(step) -> dict:
    """One call of ``step`` (synchronised) under cProfile: its host seconds,
    the seconds of DTensor's own Python (``torch/distributed/tensor``, each
    function's time less its callees'), the local redistributes with their
    seconds (callees included), and the five costliest functions of
    DTensor and of the whole call. DTensor's C++ dispatch path is not
    Python: ``operator_calls`` counts what it dispatches."""
    import cProfile
    import pstats

    pr = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr.enable()
    step()
    torch.cuda.synchronize()
    pr.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(pr).stats   # (file, line, name) -> (cc, ncalls, tottime, cumtime, callers)
    dt = {k: v for k, v in stats.items() if "torch/distributed/tensor" in k[0]}
    redis = [v for k, v in dt.items() if k[2] == "redistribute_local_tensor"]

    def top(d):
        return [(f"{Path(k[0]).name}:{k[2]}", round(v[2], 4), v[1])
                for k, v in sorted(d.items(), key=lambda kv: -kv[1][2])[:5]]

    return {"host_s": wall, "profiled_total_s": sum(v[2] for v in stats.values()),
            "dtensor_self_s": sum(v[2] for v in dt.values()),
            "redistributes": sum(v[1] for v in redis),
            "redistribute_s": sum(v[3] for v in redis),
            "dtensor_top": top(dt), "top": top(stats)}


def redistribute_probe(mesh) -> dict:
    """Host µs of one redistribute of the kind mamba2's rules issue (B and
    C of the SSD, (8, 512, 1, 128) bf16, gathered over their state dim:
    ``Shard(3)`` → ``Replicate()`` on the model axis), with the device
    idle and then behind ~``backlog_ms`` of queued fp32 products: a host
    time that follows the backlog is a wait for the device."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(torch.randn(8, 512, 1, 128, device="cuda", dtype=torch.bfloat16),
                          mesh, [Shard(0), Shard(0), Shard(3)])
    want = [Shard(0), Shard(0), Replicate()]
    a = torch.randn(4096, 4096, device="cuda")
    x.redistribute(mesh, want)
    out = {}
    for name, queued in (("idle", 0), ("busy", 8)):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(queued):
            a @ a
        end.record()
        t0 = time.perf_counter()
        x.redistribute(mesh, want)
        out[f"{name}_host_us"] = 1e6 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if queued:
            out["backlog_ms"] = start.elapsed_time(end)
    return out


@contextlib.contextmanager
def nccl_world1(name: str):
    """A world-size-1 NCCL default group (a FileStore under build/, no
    network), destroyed on exit."""
    import shutil

    import torch.distributed as dist

    store = ROOT / "build" / f"{name}_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def phase_sharded_train(cfg, kernel, unsharded, card, steps, B=8, S=512, elastic=False):
    """Phase 36 for one model: ``cfg`` at full width and depth as phases
    33-34 build it (same seed, batch and AdamW config), its parameters
    DTensors on a (1, 1, 1) pod/data/model mesh under
    ``rules_for(cfg, ShapeConfig("t", S, B, "train"), mesh)``, with ZeRO-1
    moments, trained ``steps`` steps by the sharded ``make_train_step``:
    the losses equal the unsharded run's first ``steps`` bitwise, ``kernel``
    launches twice a layer a step on its local shards, and peak memory is
    within 2% of the unsharded run's. Then where the host time goes: a
    profiled sharded step, and one sharded and one unsharded step under
    cProfile. With ``elastic``, the sharded parameters saved and restored
    onto the unsharded model, bitwise."""
    import shutil

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda as bwd
    from repro_torch.launch.sharding import (distribute_model, rules_for, sharding_tree,
                                             zero_sharding_tree)
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import shard
    from repro_torch.training import (AdamWConfig, Checkpointer, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import tree_leaves

    mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    rules = rules_for(cfg, ShapeConfig("t", S, B, "train"), mesh)
    axes = model.axes()
    distribute_model(model, sharding_tree(axes, rules, mesh))
    zero = zero_sharding_tree(model.param_shapes(), axes, rules, mesh)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=unsharded["steps"])
    state = init_opt_state(model.params(), zero)
    step = make_train_step(model, opt_cfg, rules=rules, mesh=mesh)
    batch = train_batch(cfg, B, S)
    L = layer_counts(cfg)[0 if kernel.__name__ == "flash_prefill_cuda" else 1]
    L_bwd = layer_counts(cfg)[0]

    torch.cuda.synchronize()
    peak_gb()
    kernel.launches = bwd.launches = 0
    shard.redistributes = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # syncs
        step_ms.append(1e3 * (time.perf_counter() - t1))
    launches, bwd_launches, redistributes = kernel.launches, bwd.launches, shard.redistributes
    peak = peak_gb()
    want = unsharded["losses"][:steps]
    if losses != want:
        fail(f"{cfg.name} sharded on (1, 1, 1): losses {losses} differ from the unsharded "
             f"run's {want}")
    if launches != 2 * L * steps or bwd_launches != L_bwd * steps:
        fail(f"{cfg.name} sharded: {kernel.__name__} launched {launches} times and "
             f"flash_prefill_bwd {bwd_launches} in {steps} steps, expected 2 x {L} and "
             f"{L_bwd} a step")
    if abs(peak - unsharded["train_peak_gb"]) > 0.02 * unsharded["train_peak_gb"]:
        fail(f"{cfg.name} sharded: peak {peak:.2f} GB against {unsharded['train_peak_gb']:.2f} "
             f"GB unsharded, beyond 2%")
    placements = sorted({str(tuple(x.placements)) for x in tree_leaves(state["m"])})
    med = float(np.median(step_ms[2:]))
    prof = profile_steps(lambda: step(state, batch), model.device, steps=2,
                         watch=(kernel.__name__.replace("_cuda", ""), "flash_prefill_bwd"))
    host_sharded = host_profile(lambda: step(state, batch))
    host_sharded.update(operator_calls(lambda: step(state, batch)))

    plain = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    plain_step = make_train_step(plain, opt_cfg)
    plain_state = init_opt_state(plain.params())
    plain_step(plain_state, batch)            # warm, as the sharded step is
    host_plain = host_profile(lambda: plain_step(plain_state, batch))
    host_plain.update(operator_calls(lambda: plain_step(plain_state, batch)))
    del plain_state, plain_step

    round_trip = None
    if elastic:
        ckpt = ROOT / "build" / "phase36_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            t0 = time.perf_counter()
            Checkpointer(str(ckpt)).save(1, model.params())
            _, tree, _ = Checkpointer(str(ckpt)).restore(1, device="cuda")
            plain.load_state(tree)
            equal = all(torch.equal(a.full_tensor(), b) for a, b in
                        zip(tree_leaves(model.params()), tree_leaves(plain.params())))
            if not equal:
                fail(f"{cfg.name}: the sharded parameters restored onto the unsharded model "
                     f"differ")
            round_trip = {"bitwise": True, "seconds": time.perf_counter() - t0,
                          "leaves": len(list(tree_leaves(tree)))}
            del tree
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    del model, plain, state, step
    torch.cuda.empty_cache()
    ratio = med / unsharded["step_ms_median"]
    info = {"steps": steps, "losses": losses, "bitwise": True, "step_ms": step_ms,
            "step_ms_median": med, "unsharded_step_ms_median": unsharded["step_ms_median"],
            "ratio": ratio, "launches": launches, "launches_per_step": launches / steps,
            "bwd_launches": bwd_launches, "bwd_launches_per_step": bwd_launches / steps,
            "unsharded_launches_per_step": unsharded["launches_per_step"],
            "redistributes_per_step": redistributes / steps, "peak_gb": peak,
            "unsharded_peak_gb": unsharded["train_peak_gb"], "moment_placements": placements,
            "rules": rules, "profile": prof, "unsharded_profile": unsharded["profile"],
            "host_sharded": host_sharded, "host_unsharded": host_plain,
            "elastic": round_trip}
    return info


def phase_sharded(cfgs, kernels, train, card):
    """Phase 36: olmo-1b (5 steps, and the elastic round trip) and
    mamba2-1.3b (3 steps) under the sharding rules on a world-size-1 NCCL
    group (a FileStore under build/, no network), against phases 33-34."""
    from torch.distributed.device_mesh import init_device_mesh

    with nccl_world1("phase36"):
        out = {name: phase_sharded_train(cfgs[name], kernels[name], train[name], card,
                                         steps=steps, elastic=name == "olmo-1b")
               for name, steps in (("olmo-1b", 5), ("mamba2-1.3b", 3))}
        probe = redistribute_probe(init_device_mesh(
            "cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model")))

    def part(name, r):
        h, hp = r["host_sharded"], r["host_unsharded"]
        extra = r["step_ms_median"] - r["unsharded_step_ms_median"]
        per_op = 1e3 * extra / h["dtensor_ops"] if h["dtensor_ops"] else float("nan")
        return (f"{name} {r['steps']} steps, losses {[round(x, 4) for x in r['losses']]} bitwise "
                f"the unsharded run's, {r['launches_per_step']:.0f} "
                f"{'flash_prefill' if name == 'olmo-1b' else 'ssd_intra_chunk'} and "
                f"{r['bwd_launches_per_step']:.0f} flash_prefill_bwd launches a "
                f"step (unsharded {r['unsharded_launches_per_step']:.0f}), "
                f"{r['redistributes_per_step']:.0f} redistributes by the rules a step; step "
                f"{r['step_ms_median']:.1f} ms sharded vs {r['unsharded_step_ms_median']:.1f} ms "
                f"unsharded ({r['ratio']:.2f}x, +{extra:.1f} ms); peak {r['peak_gb']:.2f} GB vs "
                f"{r['unsharded_peak_gb']:.2f} GB; a profiled sharded step: "
                f"{profile_line(r['profile'])}; unsharded (phase "
                f"{33 if name == 'olmo-1b' else 34}): device busy "
                f"{r['unsharded_profile']['device_busy_ms_per_step']:.2f} ms, "
                f"{r['unsharded_profile']['launches_per_step']:.0f} launches; one step under "
                f"cProfile: {h['host_s'] * 1e3:.0f} ms sharded ({h['dtensor_self_s'] * 1e3:.0f} ms "
                f"in DTensor's own Python, {h['redistributes']} local redistributes taking "
                f"{h['redistribute_s'] * 1e3:.0f} ms; costliest {h['top'][:4]}) vs "
                f"{hp['host_s'] * 1e3:.0f} ms unsharded (costliest {hp['top'][:2]}); a step "
                f"issues {h['dtensor_ops']} DTensor operators of {h['ops']} (unsharded "
                f"{hp['ops']} operators): the extra {extra:.1f} ms is {per_op:.1f} us a DTensor "
                f"operator"
                + (f"; sharded parameters saved and restored onto the unsharded model bitwise "
                   f"({r['elastic']['leaves']} leaves, {r['elastic']['seconds']:.1f} s)"
                   if r["elastic"] else ""))

    log(f"phase 36 sharded training on {card}, world size 1 (NCCL), (1, 1, 1) pod/data/model "
        f"mesh, ZeRO-1 moments {out['olmo-1b']['moment_placements'][:2]}: "
        + "; ".join(part(name, r) for name, r in out.items())
        + f"; one redistribute of mamba2's kind (Shard(3) -> Replicate over the size-1 model "
        f"axis): {probe['idle_host_us']:.0f} us on the host with the device idle, "
        f"{probe['busy_host_us']:.0f} us behind {probe['backlog_ms']:.1f} ms of queued work")
    out["redistribute_probe"] = probe
    return out


# ---------------------------------------------------------------------------
# phases 37-39: gradient compression, GPipe, the dry-run and grad-sync tools
# ---------------------------------------------------------------------------
def wire_spy():
    """A patch of ``dist.all_reduce`` that keeps every tensor handed to it
    (after the call: its reduced value) in ``spy.seen``."""
    from unittest import mock

    import torch.distributed as dist

    real, seen = dist.all_reduce, []

    def spy(tensor, *args, **kwargs):
        out = real(tensor, *args, **kwargs)
        seen.append(tensor)
        return out

    patch = mock.patch.object(dist, "all_reduce", spy)
    patch.seen = seen
    return patch


def half_ties(t: torch.Tensor) -> torch.Tensor:
    """Where an fp32 quotient lies within 2e-5 of k + 1/2 (ulp(127) is
    7.6e-6): one device's division may round it the other way."""
    return (torch.abs(torch.abs(t - torch.floor(t)) - 0.5) < 2e-5)


def phase_grad_comp(cfg, card, n=37, B=8, S=512):
    """Phase 37: olmo-1b's full gradient tree from one B x S step with remat
    (K3 twice a layer), then two rounds of ``compressed_psum`` with error
    feedback over the pod axis of a (1, 1, 1) mesh on a world-size-1 NCCL
    group, with ``n_shards=1`` (int8 on the wire) and without (int32): the
    wire dtypes; for every leaf |g^ - (g + e0)| within half a step plus one
    ulp of g^'s dtype, the new error equal to (g + e0) - codes * scale as
    computed, the codes equal the CPU's outside half-integer ties (and
    equal between the two wires); a round's time beside its byte bound."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_bwd_cuda, flash_prefill_cuda
    from repro_torch.models import build_model
    from repro_torch.training.grad_comp import (compressed_psum, estimate_bytes,
                                                init_error_state)

    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    model.trainable()
    names, leaves = zip(*model.named_parameters())
    batch = train_batch(cfg, B, S)
    flash_prefill_cuda.launches = flash_prefill_bwd_cuda.launches = 0
    loss, _ = model.loss_fn(batch)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    torch.cuda.synchronize()
    launches, bwd_launches = flash_prefill_cuda.launches, flash_prefill_bwd_cuda.launches
    L = layer_counts(cfg)[0]
    if launches != 2 * L or bwd_launches != L:
        fail(f"phase {n}: the gradient step launched flash_prefill {launches} and "
             f"flash_prefill_bwd {bwd_launches} times, expected 2 x {L} and {L}")
    del model, loss, leaves
    torch.cuda.empty_cache()
    N = sum(g.numel() for g in grads.values())
    g_bytes = sum(g.numel() * g.element_size() for g in grads.values())
    eps = torch.finfo(next(iter(grads.values())).dtype).eps
    peak_gb()
    out = {"launches": launches, "bwd_launches": bwd_launches, "elements": N,
           "leaves": len(grads),
           "estimate_bytes": estimate_bytes(grads), "rounds": {}}
    with nccl_world1("phase37"):
        import torch.distributed as dist

        group = init_device_mesh("cuda", (1, 1, 1),
                                 mesh_dim_names=("pod", "data", "model")).get_group("pod")
        ranks = dist.get_world_size(group)
        codes = {}
        for wire, n_shards in (("int8", 1), ("int32", None)):
            e0 = init_error_state(grads)
            rounds = []
            for r in range(2):
                spy = wire_spy()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with spy:
                    ghat, e1 = compressed_psum(grads, e0, group, n_shards=n_shards)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
                dtypes = [str(x.dtype) for x in spy.seen]
                if dtypes != ["torch.float32"] + [f"torch.{wire}"] * len(grads):
                    fail(f"phase {n}: {wire} round {r}: all_reduce was handed "
                         f"{sorted(set(dtypes))}")
                qmax = 127.0
                scales = spy.seen[0] / qmax + 1e-12
                worst, ties, off = 0.0, 0, 0
                for i, k in enumerate(grads):
                    gf = grads[k].float() + e0[k]
                    q, scale = spy.seen[1 + i], scales[i]
                    gh = ghat[k].float()
                    excess = (torch.abs(gh - gf) - (scale / 2 + eps * torch.abs(gh))).max()
                    worst = max(worst, float(torch.abs(gh - gf).max() / scale))
                    if excess > 1e-6 * float(scale):
                        fail(f"phase {n}: {wire} round {r} {k}: |g^ - (g + e)| exceeds half a "
                             f"step plus one ulp by {float(excess):.3e}")
                    if not torch.equal(e1[k], gf - q.float() * scale):
                        fail(f"phase {n}: {wire} round {r} {k}: the new error is not "
                             f"(g + e) - codes * scale")
                    if not torch.equal(ghat[k], (q.float() * scale / ranks).to(grads[k].dtype)):
                        fail(f"phase {n}: {wire} round {r} {k}: g^ is not codes * scale")
                    if wire == "int8":
                        codes[(r, k)] = q
                        cpu_gf = grads[k].cpu().float() + e0[k].cpu()
                        cpu_scale = scales[i].cpu()
                        t_cpu = cpu_gf / cpu_scale
                        want = torch.clamp(torch.round(t_cpu), -127, 127).to(torch.int8)
                        tie = half_ties(t_cpu)
                        ties += int(tie.sum())
                        off += int(((q.cpu() != want) & ~tie).sum())
                    elif not torch.equal(q.to(torch.int8), codes[(r, k)]):
                        fail(f"phase {n}: round {r} {k}: the int32 wire's codes differ from "
                             f"the int8 wire's")
                if off:
                    fail(f"phase {n}: {wire} round {r}: {off} codes differ from the CPU's "
                         f"outside half-integer ties")
                rounds.append({"wall_ms": wall_ms, "max_err_over_step": worst, "ties": ties,
                               "wire": sorted(set(dtypes))})
                del spy, ghat
                e0 = e1
            out["rounds"][wire] = rounds
        del codes

        def one_round():
            compressed_psum(grads, e0, group, n_shards=1)

        torch.cuda.synchronize()
        ms = Timer().ms(one_round, samples=5, warmup=1)
    # inputs g (bf16) and e (fp32) read once, g^ and the new e written once
    e_bytes = 4 * N
    bound = bound_ms(2 * (g_bytes + e_bytes), 0)[0]
    out.update(ms=ms, bound_ms=bound, peak_gb=peak_gb())
    del grads, e0
    torch.cuda.empty_cache()
    r8, r32 = out["rounds"]["int8"], out["rounds"]["int32"]
    log(f"phase {n} compressed_psum on {card}: {cfg.name}'s gradient tree from one {B} x {S} "
        f"step with remat ({launches} flash_prefill and {bwd_launches} flash_prefill_bwd launches, {out['leaves']} leaves, {N / 1e9:.3f} B elements), 2 rounds with error feedback over the pod axis of a "
        f"(1, 1, 1) mesh (world size 1, NCCL): all_reduce handed float32 maxima then "
        f"{r8[0]['wire'][-1]} codes with n_shards=1 and {r32[0]['wire'][-1]} without; every "
        f"leaf's |g^ - (g + e)| within half a step plus one bf16 ulp (worst "
        f"{max(x['max_err_over_step'] for x in r8 + r32):.3f} of a step), the new error "
        f"(g + e) - codes * scale bitwise, codes equal the CPU's outside "
        f"{[x['ties'] for x in r8]} half-integer ties and equal on both wires; a round "
        f"{ms:.2f} ms (CUDA events, median of 5; wall {r8[1]['wall_ms']:.1f} ms) against its "
        f"byte bound {bound:.2f} ms at 3.35 TB/s ({2 * (g_bytes + e_bytes) / 1e9:.2f} GB); "
        f"estimate_bytes {out['estimate_bytes']}; peak {out['peak_gb']:.2f} GB")
    return out


def phase_pipeline(cfg, card, n=38, B=8, S=512, n_micro=4):
    """Phase 38: ``pipeline_apply`` on a (1,) pod mesh (world size 1, NCCL)
    with olmo-1b's whole stack in bf16 as the one stage, over the embedded
    B x S batch in ``n_micro`` microbatches: K3 L x n_micro launches, the
    output bitwise the stack applied to each microbatch in turn,
    ``bubble_fraction(1, n_micro)`` 0; its ms beside the stack's on the
    whole batch. One card holds one stage: the ring between stages runs
    only in the CPU tests (4 gloo ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed_tokens
    from repro_torch.models.transformer import apply_stack_full
    from repro_torch.training.optimizer import tree_map
    from repro_torch.training.pipeline import bubble_fraction, pipeline_apply

    model = build_model(cfg).init(torch.Generator("cuda").manual_seed(0))
    tokens = train_batch(cfg, B, S)["tokens"]
    x = embed_tokens(tokens, model["embed"], cfg.embed_scale, cfg.d_model)
    stack = model.params()["stack"]
    stage_params = tree_map(lambda a: a[None], stack)     # one stage: a leading dim of 1

    def stage(h, params):
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)[None].expand(
            h.shape[0], -1)
        return apply_stack_full(h, params, cfg, pos)[0]

    L = layer_counts(cfg)[0]
    with torch.no_grad(), nccl_world1("phase38"):
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        flash_prefill_cuda.launches = 0
        y = pipeline_apply(stage, x, stage_params, mesh=mesh, axis="pod", n_micro=n_micro)
        torch.cuda.synchronize()
        launches = flash_prefill_cuda.launches
        mb = B // n_micro
        want = torch.cat([stage(x[i:i + mb], stack) for i in range(0, B, mb)])
        if launches != L * n_micro:
            fail(f"phase {n}: the pipeline launched flash_prefill {launches} times, expected "
                 f"{L} x {n_micro}")
        if not torch.equal(y, want):
            fail(f"phase {n}: the pipeline's output differs from the stack on each microbatch "
                 f"(max |d| {(y.float() - want.float()).abs().max().item():.3e})")
        if bubble_fraction(1, n_micro) != 0:
            fail(f"phase {n}: bubble_fraction(1, {n_micro}) = {bubble_fraction(1, n_micro)}")

        def wall(fn, reps=5):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            return float(np.median(times))

        pipe_ms = wall(lambda: pipeline_apply(stage, x, stage_params, mesh=mesh, axis="pod",
                                              n_micro=n_micro))
        whole_ms = wall(lambda: stage(x, stack))
        micro_ms = wall(lambda: stage(x[:mb], stack))
    del model, x, y, want
    torch.cuda.empty_cache()
    log(f"phase {n} pipeline_apply on {card}: {cfg.name}'s whole stack ({L} layers, bf16) as "
        f"the one stage of a (1,) pod mesh (world size 1, NCCL), the embedded {B} x {S} batch "
        f"in {n_micro} microbatches: {launches} flash_prefill launches ({L} x {n_micro}), output "
        f"bitwise the stack on each microbatch in turn, bubble_fraction(1, {n_micro}) = 0; "
        f"{pipe_ms:.1f} ms against {whole_ms:.1f} ms for the stack on the whole batch and "
        f"{micro_ms:.1f} ms on one microbatch (host clock, synced, median of 5); one card holds one stage, so no handoff runs here: the "
        f"ring between stages runs in tests/test_torch_pipeline.py on 4 gloo ranks")
    return {"launches": launches, "ms": pipe_ms, "stack_whole_batch_ms": whole_ms,
            "stack_microbatch_ms": micro_ms, "n_micro": n_micro, "bitwise": True}


DRYRUN_CELLS = (("yi-9b", "train_4k", "multipod"), ("mamba2-1.3b", "prefill_32k", "pod"),
                ("qwen3-moe-30b-a3b", "decode_32k", "pod"))
GRAD_SYNC_ARCH = "jamba-v0.1-52b"


def phase_dryrun(card, n=39, tag="chip_smoke", timeout=600):
    """Phase 39: the dry-run (``python -m repro_torch.launch.dryrun``) of a
    train, a prefill and a decode cell at full width on the production
    meshes (256 or 512 ranks of a ``fake`` group, DTensors over ``meta``)
    and ``python -m repro_torch.launch.grad_sync``, each a subprocess of
    its own, all at once, under this machine's torch: every one exits 0;
    each cell's FLOPs, collective bytes by kind, memory fields, trace time
    and roofline terms; int8_ef's all-reduce bytes half dense_bf16's and a
    quarter of dense_f32's, plus the fp32 maxima (4 bytes a leaf)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import analyze
    from repro_torch.training.optimizer import tree_leaves

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    work = ROOT / "build" / "phase39"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cmds = {f"{a} {s} {m}": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                             "--shape", s, "--mesh", m, "--tag", tag, "--force"]
            for a, s, m in DRYRUN_CELLS}
    cmds["grad_sync"] = [sys.executable, "-m", "repro_torch.launch.grad_sync", "--arch",
                         GRAD_SYNC_ARCH, "--out", str(work / "grad_sync.json")]
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    outs = {}
    try:
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    bad = {name: outs.get(name, "")[-2000:] for name, p in procs.items() if p.returncode}
    if bad:
        fail(f"phase {n}: {list(bad)} exited non-zero: {bad}")
    cells = {}
    for a, s, m in DRYRUN_CELLS:
        with open(dryrun.cell_path(a, s, m, tag)) as f:
            rec = json.load(f)
        if "error" in rec or not rec.get("flops"):
            fail(f"phase {n}: {a} {s} {m}: {rec.get('error', 'no FLOPs')}")
        roof = analyze(rec)
        cells[f"{a} {s} {m}"] = dict(rec, roofline={
            "compute_s": roof.compute_s, "memory_s": roof.memory_s,
            "collective_s": roof.collective_s, "bottleneck": roof.bottleneck,
            "useful_ratio": roof.useful_ratio, "mfu": roof.mfu})
    for mesh_kind in {m for _, _, m in DRYRUN_CELLS}:
        shutil.rmtree(Path(dryrun.ARTIFACT_DIR) / f"{mesh_kind}_{tag}", ignore_errors=True)
    with open(work / "grad_sync.json") as f:
        sync_res = json.load(f)["results"]
    shutil.rmtree(work, ignore_errors=True)
    f32, bf16, int8 = (sync_res[k]["all-reduce"] for k in ("dense_f32", "dense_bf16", "int8_ef"))
    n_leaves = len(list(tree_leaves(build_model(get_config(GRAD_SYNC_ARCH)).param_shapes())))
    if not (f32 == 2 * bf16 and 2 * int8 - bf16 == 2 * 4 * n_leaves
            and sync_res["int8_ef"]["count"] == n_leaves + 1):
        fail(f"phase {n}: grad_sync all-reduce bytes f32 {f32}, bf16 {bf16}, int8 {int8} are "
             f"not 4 : 2 : 1 plus {n_leaves} fp32 maxima")

    def cell_line(name, r):
        c = {k: v for k, v in r["collectives"].items() if v}
        mem = {k.replace("_size_in_bytes", ""): r[k] for k in
               ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                "alias_size_in_bytes")}
        ro = r["roofline"]
        return (f"{name} ({r['devices']} ranks): {r['flops']:.4g} FLOPs, "
                f"{r['bytes_accessed']:.4g} bytes accessed, collectives {c}, memory {mem}, "
                f"trace {r['trace_s']} s; roofline compute {ro['compute_s']:.3g} s, memory "
                f"{ro['memory_s']:.3g} s, collective {ro['collective_s']:.3g} s "
                f"({ro['bottleneck']})")

    log(f"phase {n} dry-run and grad-sync under torch {torch.__version__} ({card}; meshes over "
        f"a fake process group, DTensors over meta, the kernels' plain versions), 4 "
        f"subprocesses in {wall_s:.1f} s: " + "; ".join(cell_line(k, r) for k, r in cells.items())
        + f"; grad_sync --arch {GRAD_SYNC_ARCH} on (2, 16, 16): all-reduce bytes/device "
        f"dense_f32 {f32 / 1e9:.3f} GB, dense_bf16 {bf16 / 1e9:.3f} GB, int8_ef "
        f"{int8 / 1e9:.3f} GB (= bf16/2 + 4 x {n_leaves} bytes of maxima)")
    return {"cells": cells, "grad_sync": sync_res, "n_leaves": n_leaves, "wall_s": wall_s,
            "torch": torch.__version__}


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from dataclasses import replace

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
    ptxas = ptxas_report(build.build_log)
    log(f"phase 1 environment: {kind}, torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), kernels built in {t_build:.1f} s; ptxas (registers, "
        f"spill bytes): {ptxas}")
    bf16_kernels = ([f"paged_attention_bf16_kernel<{D}>" for D in (64, 128)]
                    + [f"flash_prefill_{k}bf16_kernel<{D}>" for D in (64, 128, 256)
                       for k in ("", "bwd_dq_", "bwd_dkdv_")]
                    + ["ssd_intra_chunk_bf16_kernel"])
    if missing := [name for name in bf16_kernels if name not in ptxas]:
        fail(f"no ptxas report for {missing}: the build left none to check for spills")
    if spilled := [name for name in bf16_kernels if ptxas[name][1]]:
        fail(f"a tensor-core kernel spills registers: {spilled}")

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
    del eng
    torch.cuda.empty_cache()
    # phase 16 runs here, on phase 3's model and prompts; its submits are
    # short enough (at most 8 pages) for a handoff under 200 bytes
    submits = [np.random.default_rng(16).integers(1, cfg.vocab_size, size=n).tolist()
               for n in (16, 64, 112)]
    rpc = phase_rpc(cfg, model, prompts, submits, outputs[: len(prompts)],
                    serve["decode_step_ms_b8"], MAX_NEW, card)
    cross_pod = phase_cross_pod(cfg, model, prompts, rpc, MAX_NEW, card)
    failover = phase_failover(cfg, model, prompts, submits, rpc, MAX_NEW, card)
    shm = phase_shmcheck(cfg, model, prompts, rpc, MAX_NEW, card)
    del model
    torch.cuda.empty_cache()
    src_pool, src_pages, transfer = phase_transfer(cfg, gen)
    times = phase_times(gen, main_lens, src_pool, src_pages, card)
    del src_pool
    torch.cuda.empty_cache()

    mcfg = get_config("mamba2_1p3b")
    ssd = phase_ssd_kernel(gen, card)
    errs["ssd_intra_chunk"] = ssd.pop("max_abs_err")
    t0 = time.perf_counter()
    mamba = build_model(mcfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in mamba.parameters())
    log(f"model: {mcfg.name} {mcfg.num_layers} layers, {n_params / 1e9:.2f} B params "
        f"(analytic {mcfg.param_count() / 1e9:.2f} B), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    m_prompts = make_prompts(rng, 8, mcfg.vocab_size)
    cache, tok, pos, m_serve = phase_mamba_serve(mcfg, mamba, m_prompts, MAX_NEW, card)
    m_tf = phase_teacher_forced(mamba, mcfg, rng, card)
    m_times = phase_mamba_times(mamba, ssd.pop("args"), cache, tok, pos, card)
    times["ssd_intra_chunk"] = m_times["ssd_intra_chunk"]
    del mamba, cache
    torch.cuda.empty_cache()

    gcfg = get_config("gemma3_12b")
    flash = phase_flash_kernel(gen, card)
    errs["flash_prefill"] = flash.pop("max_abs_err")
    t0 = time.perf_counter()
    gemma = build_model(gcfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in gemma.parameters())
    log(f"model: {gcfg.name} {gcfg.num_layers} layers, {n_params / 1e9:.2f} B params "
        f"(analytic {gcfg.param_count() / 1e9:.2f} B), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    g_serve = phase_gemma_serve(gcfg, gemma, ragged_prompts(rng, 4, gcfg.vocab_size),
                                MAX_NEW, card)
    g_tf = phase_gemma_teacher_forced(gemma, gcfg, rng, card)
    g_times = phase_gemma_times(gemma, gen, card)
    times["flash_prefill"] = g_times["flash_prefill"]["gemma3_global_S4096"]
    del gemma
    torch.cuda.empty_cache()

    new = phase_new_layouts(gen, main_lens, card)
    for name, prefix in (("paged_attention", "K1"), ("flash_prefill", "K3")):
        errs[name] = max(errs[name], *(v for k, v in new["per_case"].items()
                                       if k.startswith(prefix)))
    fams = {}
    olmo, fams["olmo-1b"] = phase_family(get_config("olmo_1b"), gen, rng, card, 18)
    del olmo
    torch.cuda.empty_cache()
    qcfg = get_config("qwen2_vl_7b")
    qwen, fams["qwen2-vl-7b"] = phase_family(qcfg, gen, rng, card, 19)
    fams["qwen2-vl-7b"]["mrope"] = phase_mrope(qwen, qcfg, rng, card)
    del qwen
    torch.cuda.empty_cache()
    fam_times = phase_family_times(gen, fams, card)

    # the MoE families: K3 at their prefill shapes, then each model
    moe_cfgs = {name: get_config(name) for name in MOE_ARCHS}
    moe_prompts = {name: make_prompts(rng, 8, c.vocab_size) for name, c in moe_cfgs.items()}
    moe_k3 = phase_moe_kernels(gen, {name: (max(len(p) for p in moe_prompts[name]),
                                            c.num_heads, c.num_kv_heads, c.head_dim)
                                     for name, c in moe_cfgs.items()}, card)
    errs["flash_prefill"] = max(errs["flash_prefill"], moe_k3["max_abs_err"])
    moes = {name: phase_moe(c, moe_prompts[name], rng, card, n, MOE_ARCHS[name])
            for n, (name, c) in enumerate(moe_cfgs.items(), start=22)}

    # the hybrid: K3 and K4 at jamba's shapes, then the model at half depth
    jcfg = replace(get_config("jamba_v01_52b"), num_layers=JAMBA_LAYERS)
    j_prompts = make_prompts(rng, 8, jcfg.vocab_size)
    j_kernels = phase_jamba_kernels(gen, jcfg, max(len(p) for p in j_prompts), card)
    for name, prefix in (("flash_prefill", "B"), ("ssd_intra_chunk", "ssd")):
        errs[name] = max(errs[name], *(v for k, v in j_kernels["max_abs_err"].items()
                                       if k.startswith(prefix)))
    jamba = phase_jamba(jcfg, j_prompts, rng, card)

    # the encoder-decoder: K3 at whisper's decoder shapes, the model, the CLI
    wcfg = get_config("whisper_base")
    w_kernels = phase_whisper_kernels(gen, wcfg, card)
    errs["flash_prefill"] = max(errs["flash_prefill"], *w_kernels["max_abs_err"].values())
    whisper = phase_whisper(wcfg, rng, card)
    cli = phase_serve_cli(card)

    # training: the kernels' gradients, olmo-1b and mamba2-1.3b, the CLI
    from unittest import mock

    import repro_torch.kernels.ssd.ops as ssd_ops
    import repro_torch.models.attention as attention
    from repro_torch.kernels.flash_prefill import flash_prefill_ref
    from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda
    from repro_torch.kernels.ssd import ssd_intra_chunk_ref
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda

    grads = phase_kernel_grads(gen, card)
    # the kernel against its plain version on the same inputs (O and lse included)
    errs["flash_prefill_bwd"] = max(d["kernel_vs_vjp_same_lse_max_abs_err"]
                                    for d in grads["flash_prefill"].values())
    times["flash_prefill_bwd"] = grads["flash_prefill_bwd"]
    train = {
        "olmo-1b": phase_train_model(get_config("olmo_1b"), flash_prefill_cuda,
                                     mock.patch.object(attention, "flash_prefill",
                                                       flash_prefill_ref),
                                     card, 33),
        "mamba2-1.3b": phase_train_model(get_config("mamba2_1p3b"), ssd_intra_chunk_cuda,
                                         mock.patch.object(ssd_ops, "ssd_intra_chunk",
                                                           ssd_intra_chunk_ref),
                                         card, 34),
    }
    train_cli = phase_train_cli(card)
    sharded = phase_sharded({"olmo-1b": get_config("olmo_1b"),
                             "mamba2-1.3b": get_config("mamba2_1p3b")},
                            {"olmo-1b": flash_prefill_cuda, "mamba2-1.3b": ssd_intra_chunk_cuda},
                            train, card)
    grad_comp = phase_grad_comp(get_config("olmo_1b"), card)
    pipeline = phase_pipeline(get_config("olmo_1b"), card)
    dry = phase_dryrun(card)

    sources = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:189"),
        "gather_pages": ("src/repro_torch/csrc/scope_copy.cu",
                         "src/repro/kernels/scope_copy/kernel.py:47"),
        "scatter_pages": ("src/repro_torch/csrc/scope_copy.cu",
                          "src/repro/kernels/scope_copy/kernel.py:75"),
        "ssd_intra_chunk": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd/kernel.py:77"),
        "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                          "src/repro/kernels/flash_prefill/kernel.py:84"),
        # no TPU kernel: the reference differentiates _attend with jax.grad
        "flash_prefill_bwd": ("src/repro_torch/csrc/flash_prefill_bwd.cu",
                              "none: jax.grad of src/repro/models/attention.py:109 (_attend)"),
    }
    # launches on each path, each read around that path alone (the RPC
    # plane's summed over its parts); a kernel's launches are their sum
    by_path = {
        "yi-9b": {"paged_attention": serve["launches"],
                  "flash_prefill": serve["flash_prefill_launches"], **transfer["launches"]},
        "yi-9b over the RPC plane": {
            name: sum(part.get(name, 0) for part in rpc["launches"].values())
            for name in sources},
        "yi-9b across pods (phase 40)": {
            name: sum(part.get(name, 0) for part in cross_pod["launches"].values())
            for name in sources},
        "yi-9b in pod, phase 40's reference": {
            name: cross_pod["in_pod_launches"].get(name, 0) for name in sources},
        "yi-9b with a standby replica (phase 41)": {
            name: sum(part.get(name, 0) for part in failover["launches"].values())
            for name in sources},
        "yi-9b under ShmCheck (phase 42)": {
            name: shm["launches"]["sanitized"].get(name, 0) for name in sources},
        "mamba2-1.3b": {"ssd_intra_chunk": m_serve["launches"]},
        "gemma3-12b": {"flash_prefill": g_serve["launches"]},
        **{name: {"paged_attention": f["serve"]["launches"],
                  "flash_prefill": f["serve"]["flash_prefill_launches"],
                  **f["transfer"]["launches"]} for name, f in fams.items()},
        **{name: {"flash_prefill": m["serve"]["launches"]} for name, m in moes.items()},
        jcfg.name: {"flash_prefill": jamba["serve"]["launches"],
                    "ssd_intra_chunk": jamba["serve"]["ssd_launches"]},
        wcfg.name: {"flash_prefill": whisper["serve"]["launches"]},
        "serve_cli": {name: sum(r[name] for r in cli.values())
                      for name in ("paged_attention", "flash_prefill")},
        "olmo-1b training": {"flash_prefill": train["olmo-1b"]["launches"],
                             "flash_prefill_bwd": train["olmo-1b"]["bwd_launches"]},
        "mamba2-1.3b training": {"ssd_intra_chunk": train["mamba2-1.3b"]["launches"]},
        "train_cli": {"flash_prefill": train_cli["flash_prefill"],
                      "flash_prefill_bwd": train_cli["flash_prefill_bwd"]},
        "olmo-1b sharded training": {"flash_prefill": sharded["olmo-1b"]["launches"],
                                     "flash_prefill_bwd": sharded["olmo-1b"]["bwd_launches"]},
        "mamba2-1.3b sharded training": {"ssd_intra_chunk": sharded["mamba2-1.3b"]["launches"]},
        "grad_comp_step": {"flash_prefill": grad_comp["launches"],
                           "flash_prefill_bwd": grad_comp["bwd_launches"]},
        "pipeline": {"flash_prefill": pipeline["launches"]},
    }
    # "launches" counts wrapper calls; the backward's call launches two
    # __global__ kernels (dq with Δ, then dk/dv), every other wrapper's one
    per_call = {"flash_prefill_bwd": 2}
    kernels = [{
        "name": name, "route": "cuda", "source": src, "replaces": tpu,
        "launches": sum(path.get(name, 0) for path in by_path.values()),
        "device_launches_per_call": per_call.get(name, 1),
        "launches_by_path": {p: path[name] for p, path in by_path.items() if path.get(name)},
        "max_abs_err": errs[name],
        "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
        "library_ms": times[name]["library_ms"],
        "library_backend": times[name]["library_backend"],
    } for name, (src, tpu) in sources.items()]
    if idle := [k["name"] for k in kernels if not k["launches"]]:
        fail(f"kernels of the main paths never launched: {idle}")

    result = {"card": card, "build_s": t_build, "ptxas": ptxas, "serve": serve, "dense": dense,
              "profile": prof, "transfer": transfer, "times": times,
              "ssd_kernel": ssd, "mamba_serve": m_serve, "mamba_teacher_forced": m_tf,
              "mamba_times": m_times, "flash_kernel": flash, "gemma_serve": g_serve,
              "gemma_teacher_forced": g_tf, "gemma_times": g_times, "rpc": rpc,
              "cross_pod": cross_pod, "failover": failover, "shmcheck": shm,
              "new_layouts": new, "families": fams, "family_times": fam_times,
              "moe_kernels": moe_k3, "moe": moes, "jamba_kernels": j_kernels, "jamba": jamba,
              "whisper_kernels": w_kernels, "whisper": whisper, "serve_cli": cli,
              "kernel_grads": grads, "train": train, "train_cli": train_cli,
              "sharded": sharded, "grad_comp": grad_comp, "pipeline": pipeline,
              "dryrun": dry, "kernels": kernels}
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
