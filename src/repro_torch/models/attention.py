"""GQA self-attention with RoPE, M-RoPE or no positions (jamba, whisper),
optional q/k/v biases, qk-norm, sliding windows and a logit softcap, over
dense or ring KV caches (bf16, fp32 or int8), and whisper's attention
over encoder memory.

Three entry modes:
  * full-sequence prefill. Without caller-given positions the positions
    are 0..S-1 and the ``flash_prefill`` kernel (its plain version on a
    CPU tensor) computes causal attention by token index, with the
    layer's window. With caller-given positions (Qwen2-VL's M-RoPE
    triples for an image) the reference masks by the values of the
    temporal stream, which a kernel masking by index cannot do: that
    prefill goes through ``_attend``, as the reference computes it.
    ``attention_full.paths`` counts the layers each path ran;
  * decode — one query token per sequence against the cache, through
    ``_attend``; ``pos`` is (B,) or a 0-d tensor when every sequence is at
    the same position;
  * memory — whisper's encoder self-attention and decoder cross-attention:
    K and V projected from the encoder's states (``memory``), no
    positions, no causal mask, through ``_attend`` as in the reference (the
    ``flash_prefill`` kernel, like the TPU kernel it replaces, is causal
    only). The prefill returns the cross cache ``{"k", "v"}``; decode
    attends over it (``memory_cache``) and never writes it.

KV caches of sliding-window layers are rings of ``min(window, cache_len)``
slots (slot = position % size), as in the reference: gemma3's local layers
keep 1024 tokens whatever the context. An int8 cache stores K and V at the
reference's fixed symmetric scale ``KV_INT8_SCALE``.

``_attend`` rounds as the reference does at every step: fp32 scores,
the softcap, ``NEG_INF`` masking, fp32 softmax, and the weights cast to
``v``'s dtype before the PV product. These are plain products outside any
kernel, chunked over queries as the reference's are.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.flash_prefill.ops import flash_prefill
from ..sharding import is_dtensor, local_call, shard, shard_offset
from .config import LayerSpec, ModelConfig
from .layers import apply_mrope, apply_rope, dense_init, rmsnorm

Params = Dict[str, Any]

NEG_INF = -1e30
Q_CHUNK = 1024         # queries a score block of ``_attend`` holds, as the reference's
KV_INT8_SCALE = 0.05   # the reference's fixed symmetric scale for int8 KV caches


# logical sharding axes of each parameter leaf (repro_torch.sharding)
ATTENTION_AXES = {
    "wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"), "bv": ("kv_heads", "head_dim"),
    "q_norm": ("head_dim",), "k_norm": ("head_dim",),
}


def init_attention(gen, cfg: ModelConfig, device=None) -> Params:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, H, Dh), device=device),
        "wk": dense_init(gen, (d, Hkv, Dh), device=device),
        "wv": dense_init(gen, (d, Hkv, Dh), device=device),
        "wo": dense_init(gen, (H, Dh, d), device=device),
    }
    if cfg.attn_bias:     # zeros, as the reference initialises them
        p["bq"] = torch.zeros((H, Dh), dtype=torch.bfloat16, device=device)
        p["bk"] = torch.zeros((Hkv, Dh), dtype=torch.bfloat16, device=device)
        p["bv"] = torch.zeros((Hkv, Dh), dtype=torch.bfloat16, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((Dh,), dtype=torch.bfloat16, device=device)
        p["k_norm"] = torch.ones((Dh,), dtype=torch.bfloat16, device=device)
    return p


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
def _project_q(x, p, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(x, p, cfg: ModelConfig):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _project_out(out, p):
    """Heads back to d_model in the promoted dtype of the attention output
    and ``wo``, as the reference's einsum promotes: fp32 weights over a
    bf16 or int8 cache give fp32."""
    dt = torch.promote_types(out.dtype, p["wo"].dtype)
    return torch.einsum("bshk,hkd->bsd", out.to(dt), p["wo"].to(dt))


def _rope_qk(q, k, positions, cfg: ModelConfig, spec: LayerSpec):
    """positions: (B, S) for ``rope``; (3, B, S) for ``mrope``; q and k
    pass unchanged for ``none`` (jamba's attention has no positions)."""
    if cfg.rope_kind == "none":
        return q, k
    if cfg.rope_kind == "mrope":
        return (apply_mrope(q, positions, spec.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, spec.rope_theta, cfg.mrope_sections))
    if cfg.rope_kind != "rope":
        raise NotImplementedError(f"rope kind {cfg.rope_kind!r} is not ported")
    return (apply_rope(q, positions, spec.rope_theta),
            apply_rope(k, positions, spec.rope_theta))


def _scalar_pos(positions):
    """(B, S) positions from either rank: M-RoPE's temporal stream."""
    return positions[0] if positions.dim() == 3 else positions


# ---------------------------------------------------------------------------
# core attention math (GQA, chunked over queries)
# ---------------------------------------------------------------------------
def _attend(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0,
            softcap: float = 0.0, kv_valid: Optional[torch.Tensor] = None,
            stats: bool = False):
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D); *_pos: (B,S*), or ``None`` when
    not ``causal``. A key is visible when ``q_pos >= kv_pos`` (causal),
    ``q_pos - kv_pos < window`` (when ``window``) and ``kv_valid``. Scores
    are tanh-capped at ``softcap`` (0: none) before the mask.

    Scores materialize as (B, Hkv, qpk, Cq, Skv) fp32 for chunks of
    ``Q_CHUNK`` queries; decode has Sq = 1.

    With ``stats`` the softmax is left open over these keys: returns the
    fp32 (B,Sq,H,D) sum of exp(s − m)·v, the row maxima m and the sums of
    exp(s − m) (B,Sq,H), for a caller that combines key ranges
    (``_attend_local`` over a sequence-sharded cache).
    """
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    kf = k.float()

    def attend_chunk(qc, qp):
        # when heads cannot carry the TP axis (28 ∤ 16: qwen2-vl, 8 < 16:
        # whisper) the "attn_q" rule shards score rows over it instead
        qc = shard(qc, ("batch", "attn_q", None, None, None))
        s = torch.einsum("bqgpd,bkgd->bgpqk", qc.float(), kf) * (1.0 / math.sqrt(Dh))
        s = shard(s, ("batch", None, None, "attn_q", None))
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = torch.ones((B, 1, 1, qc.shape[1], Skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            m = qp[:, :, None] >= kv_pos[:, None, :]          # (B, Cq, Skv)
            if window:
                m = m & (qp[:, :, None] - kv_pos[:, None, :] < window)
            mask = mask & m[:, None, None]
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        if stats:
            m = s.amax(dim=-1, keepdim=True)
            e = torch.exp(s - m)
            o = torch.einsum("bgpqk,bkgd->bqgpd", e, v.float())
            return o, m[..., 0].permute(0, 3, 1, 2), e.sum(-1).permute(0, 3, 1, 2)
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bgpqk,bkgd->bqgpd", w.to(v.dtype), v)

    if Sq <= Q_CHUNK:
        parts = [attend_chunk(qg, q_pos)]
    else:
        parts = [attend_chunk(qg[:, c0:c0 + Q_CHUNK],
                              q_pos if q_pos is None else q_pos[:, c0:c0 + Q_CHUNK])
                 for c0 in range(0, Sq, Q_CHUNK)]
    if stats:
        o, m, l = (torch.cat(x, dim=1) if len(parts) > 1 else x[0] for x in zip(*parts))
        return o.reshape(B, Sq, H, Dh), m.reshape(B, Sq, H), l.reshape(B, Sq, H)
    out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return out.reshape(B, Sq, H, Dh)


def _as_dtensor(x, mesh):
    """A DTensor as it is; a plain tensor (the same full value on every
    rank: positions the model makes) as a replicated DTensor."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _kv_heads_of_local_q(q, k):
    """For DTensor q and K laid out by ``_Q_AXES`` and ``_KV_AXES``: where
    q's heads are sharded and K's are not (GQA whose ``kv_heads`` do not
    divide the model axis), a rank's query heads [o, o + h) read the K/V
    heads ``g // (H / Hkv)`` of their global index g, not the first of its
    local view. Returns the index of those K/V heads in the local view
    (a slice when all h share one, else one per query head), or ``None``
    when the local views already match."""
    from torch.distributed.tensor import Shard

    q_heads, kv_heads = ({i for i, pl in enumerate(t.placements)
                          if isinstance(pl, Shard) and pl.dim == 2} for t in (q, k))
    if kv_heads and kv_heads != q_heads:
        raise NotImplementedError(f"K/V heads sharded over mesh dims {sorted(kv_heads)}, "
                                  f"query heads over {sorted(q_heads)}")
    if not q_heads or kv_heads:
        return None
    off, h = shard_offset(q, 2)
    qpk = q.shape[2] // k.shape[2]
    first, last = off // qpk, (off + h - 1) // qpk
    return (slice(first, first + 1) if first == last else
            torch.div(torch.arange(off, off + h), qpk, rounding_mode="floor"))


def _cut_heads(kv_of, kl, vl):
    if kv_of is None:
        return kl, vl
    idx = kv_of if isinstance(kv_of, slice) else kv_of.to(kl.device)
    return kl[:, :, idx], vl[:, :, idx]


def _attend_local(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0,
                  softcap: float = 0.0, kv_valid=None, kv_seq: Optional[str] = None):
    """``_attend`` on each rank's local shards under a mesh (``_attend``
    itself on plain tensors): one DTensor dispatch a layer instead of one
    an operator, whose sharding propagation over 5-d scores on a 3-d mesh
    is slow enough to stall a trace. q is laid out by batch, ``attn_q``
    rows and ``heads``; K and V by batch, ``kv_seq`` (the logical axis of
    their sequence dim, ``"kv_seq"`` for a decode cache, else whole) and
    ``kv_heads``; positions and ``kv_valid`` as the rows they mask.

    Where ``kv_seq`` shards K and V over mesh dims, every query row needs
    every range of keys: q goes whole over its heads, each rank attends
    over its own keys with the softmax left open (``stats``), and the
    ranges are combined across those dims, flash-decoding style: all-reduces
    of the row maxima (max), then of the rescaled sums and weighted values
    (sum). No gradient flows through that combine (decode only)."""
    if not is_dtensor(q):
        return _attend(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                       softcap=softcap, kv_valid=kv_valid)
    from torch.distributed.tensor import Shard

    mesh = q.device_mesh
    kv_ax = ("batch", kv_seq, "kv_heads", None)
    k, v = shard(k, kv_ax), shard(v, kv_ax)
    seq_dims = [i for i, pl in enumerate(k.placements) if isinstance(pl, Shard) and pl.dim == 1]
    q_ax = ("batch", "attn_q", None if seq_dims else "heads", None)
    q = shard(q, q_ax)
    kv_of = _kv_heads_of_local_q(q, k)
    args = [(q, q_ax), (k, kv_ax), (v, kv_ax)]
    rest = [(name, t, ax) for name, t, ax in (("q_pos", q_pos, ("batch", "attn_q")),
                                              ("kv_pos", kv_pos, ("batch", kv_seq)),
                                              ("kv_valid", kv_valid, ("batch", kv_seq)))
            if t is not None]
    args += [(_as_dtensor(t, mesh), ax) for _, t, ax in rest]

    def run(ql, kl, vl, *extra):
        kl, vl = _cut_heads(kv_of, kl, vl)
        kw = dict(zip([name for name, _, _ in rest], extra))
        kw.setdefault("q_pos", None)
        kw.setdefault("kv_pos", None)
        if not seq_dims:
            return _attend(ql, kl, vl, causal=causal, window=window, softcap=softcap, **kw)
        import torch.distributed._functional_collectives as funcol

        o, m, l = _attend(ql, kl, vl, causal=causal, window=window, softcap=softcap,
                          stats=True, **kw)
        big = m
        for i in seq_dims:
            big = funcol.all_reduce(big, "max", mesh.get_group(i))
        w = torch.exp(m - big)
        o, l = o * w[..., None], l * w
        for i in seq_dims:
            o = funcol.all_reduce(o, "sum", mesh.get_group(i))
            l = funcol.all_reduce(l, "sum", mesh.get_group(i))
        return (o / l[..., None]).to(vl.dtype)

    return local_call(run, args, out_axes=[q_ax])


# ---------------------------------------------------------------------------
# public modes
# ---------------------------------------------------------------------------
def attention_full(x, p, cfg: ModelConfig, spec: LayerSpec, positions,
                   want_cache: bool = False, cache_len: int = 0,
                   caller_positions: bool = False, memory=None):
    """Prefill over the full sequence. ``positions`` ((B, S), or (3, B,
    S) for M-RoPE) feed RoPE and the cache slots. Without
    ``caller_positions`` they are 0..S-1 and the ``flash_prefill`` kernel
    masks by token index; with it, ``_attend`` masks by the values of
    ``_scalar_pos(positions)``, as the reference does. The choice is the
    caller's, made on the host. With ``want_cache`` also returns the KV
    cache sized ``cache_len`` (>= S for decode continuation; a ring of the
    last tokens for a windowed layer).

    With ``memory`` (B, S_mem, d) K and V come from it, ``positions`` is
    unused and every query sees every memory row; the cache is the
    unpositioned ``{"k", "v"}`` of the memory."""
    q = _project_q(x, p, cfg)
    if memory is not None:
        k, v = _project_kv(memory, p, cfg)
        out = _attend_local(q, k, v, None, None, causal=False, softcap=cfg.attn_logit_softcap)
        attention_full.paths["memory"] += 1
        return _project_out(out, p), ({"k": k, "v": v} if want_cache else None)
    k, v = _project_kv(x, p, cfg)
    q, k = _rope_qk(q, k, positions, cfg, spec)
    q = shard(q, _Q_AXES)
    k = shard(k, _KV_AXES)
    pos = _scalar_pos(positions)
    if caller_positions:
        out = _attend_local(q, k, v, pos, pos, causal=True, window=spec.sliding_window,
                            softcap=cfg.attn_logit_softcap)
        attention_full.paths["positions"] += 1
    else:
        out = _flash_prefill_local(q, k, v, window=spec.sliding_window,
                                   softcap=cfg.attn_logit_softcap)
        attention_full.paths["flash_prefill"] += 1
    cache = (_build_cache(k, v, pos, spec.sliding_window, cache_len)
             if want_cache else None)
    out = shard(out, _Q_AXES)
    return _project_out(out, p), cache


attention_full.paths = {"flash_prefill": 0, "positions": 0, "memory": 0}

_Q_AXES = ("batch", "seq", "heads", None)
_KV_AXES = ("batch", "seq", "kv_heads", None)
_CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)


def _flash_prefill_local(q, k, v, window: int, softcap: float):
    """``flash_prefill`` on each rank's local shards under a mesh (on the
    tensors as they are without one): q by batch and ``heads``, K and V
    by batch and ``kv_heads``, whole along the sequence (positions
    0..S-1 on every rank).

    Where a rule shards q's heads but not K's (GQA whose ``kv_heads``
    do not divide the model axis), a rank's query heads [o, o + h) read
    the K/V heads ``g // (H / Hkv)`` of their global index g, not the
    first of its local view: the kernel gets K and V cut to those (one
    head when all h share it, else one per query head), and their
    gradients are partial sums over the ranks that cut them (``local_call``)."""
    kv_of = None
    if is_dtensor(q):
        q, k = shard(q, _Q_AXES), shard(k, _KV_AXES)
        kv_of = _kv_heads_of_local_q(q, k)

    def run(ql, kl, vl):
        kl, vl = _cut_heads(kv_of, kl, vl)
        return flash_prefill(ql, kl, vl, window=window, softcap=softcap)

    return local_call(run, [(q, _Q_AXES), (k, _KV_AXES), (v, _KV_AXES)], out_axes=[_Q_AXES])


def _cache_size(window: int, cache_len: int) -> int:
    return min(window, cache_len) if window else cache_len


def _build_cache(k, v, pos, window: int, cache_len: int):
    """Prefill→decode cache. A windowed layer keeps a ring of the last
    ``min(window, cache_len)`` tokens at slot ``pos % size``; a global
    layer keeps every token at slot ``pos`` up to ``cache_len``. Unwritten
    slots carry position -1. Under a mesh each rank builds its rows and
    heads from its local K and V, whole along the sequence, and the cache
    is then laid out by ``_CACHE_AXES`` (a slice where ``kv_seq`` shards)."""
    if is_dtensor(k):
        def run(kl, vl, pl):
            return tuple(_build_cache(kl, vl, pl, window, cache_len).values())

        whole = ("batch", None, "kv_heads", None)
        ck, cv, cpos = local_call(
            run, [(k, _KV_AXES), (v, _KV_AXES), (_as_dtensor(pos, k.device_mesh), ("batch", "seq"))],
            out_axes=[whole, whole, whole[:2]])
        return {"k": shard(ck, _CACHE_AXES), "v": shard(cv, _CACHE_AXES),
                "pos": shard(cpos, _CACHE_AXES[:2])}
    B, S = k.shape[0], k.shape[1]
    size = _cache_size(window, cache_len)
    ck = torch.zeros((B, size) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    cv = torch.zeros_like(ck)
    cpos = torch.full((B, size), -1, dtype=torch.int32, device=k.device)
    if window and S > size:
        k, v, pos = k[:, -size:], v[:, -size:], pos[:, -size:]
    slots = (pos % size if window else pos).long()
    bidx = torch.arange(B, device=k.device)[:, None]
    ck[bidx, slots] = k
    cv[bidx, slots] = v
    cpos[bidx, slots] = pos.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


def _write_slots(c, slot, new):
    """``c[b, slot[b]] = new[b]`` for every row b, in place: c (B, size,
    ...), slot (B,), new (B, ...) in c's dtype. On a DTensor cache each rank
    writes into its local shard: its rows, its heads, and of a sequence
    that ``kv_seq`` shards only the slots in its range (the others keep
    their values); new and slot are laid out to match first."""
    if not is_dtensor(c):
        c[torch.arange(c.shape[0], device=c.device), slot] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = c.device_mesh
    rows = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in c.placements]
    cols = [Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim >= 2 else r
            for pl, r in zip(c.placements, rows)]
    new_l = _as_dtensor(new, mesh).redistribute(mesh, cols).to_local()
    slot_l = _as_dtensor(slot, mesh).redistribute(mesh, rows).to_local()
    off, n = shard_offset(c, 1)
    cl = c.to_local()
    local = slot_l - off
    inside = ((local >= 0) & (local < n)).reshape((-1,) + (1,) * (new_l.dim() - 1))
    local = local.clamp(0, n - 1)
    b = torch.arange(cl.shape[0], device=cl.device)
    cl[b, local] = torch.where(inside, new_l, cl[b, local])


def _kv_load(c):
    """An int8 cache's values in bf16 at the fixed scale; others as they are."""
    if c.dtype == torch.int8:
        return c.to(torch.bfloat16) * torch.tensor(KV_INT8_SCALE, dtype=torch.bfloat16,
                                                   device=c.device)
    return c


def _kv_store(x, dtype):
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.float() / KV_INT8_SCALE),
                           -127, 127).to(torch.int8)
    return x.to(dtype)


def attention_decode(x, p, cfg: ModelConfig, spec: LayerSpec, cache: Params,
                     pos, memory_cache: Optional[Params] = None):
    """One-token decode. x: (B, 1, D); pos: (B,) current positions, or a
    0-d tensor when every sequence is at the same position (the same slot
    of every row is written; the reference's ``dynamic_update_slice``
    branch, which only XLA needs apart).

    Writes this token's K/V into ``cache`` in place (slot ``pos % size``
    in a windowed layer's ring; the returned cache is the same tensors;
    an int8 cache stores them quantized) and attends over the valid
    slots, within the window. M-RoPE turns q and k by three equal streams
    from ``pos``; ``rope_kind="none"`` turns nothing. ``pos`` must lie
    inside a global layer's cache; ``apply_stack_decode`` checks that
    before any layer writes.

    With ``memory_cache`` (the cross cache of the prefill) the query
    attends over its K and V, unmasked; ``cache`` and ``pos`` are unused
    and ``cache`` is returned as it came.
    """
    if memory_cache is not None:
        q = _project_q(x, p, cfg)
        out = _attend_local(q, memory_cache["k"], memory_cache["v"], None, None,
                            causal=False, softcap=cfg.attn_logit_softcap)
        return _project_out(out, p), cache
    B = x.shape[0]
    pos_vec = pos.expand(B) if pos.dim() == 0 else pos
    q = _project_q(x, p, cfg)
    k_new, v_new = _project_kv(x, p, cfg)
    pos2 = pos_vec[:, None]
    rope_pos = pos2[None].expand(3, B, 1) if cfg.rope_kind == "mrope" else pos2
    q, k_new = _rope_qk(q, k_new, rope_pos, cfg, spec)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = (pos_vec % ck.shape[1] if spec.sliding_window else pos_vec).long()
    _write_slots(ck, slot, _kv_store(k_new[:, 0], ck.dtype))
    _write_slots(cv, slot, _kv_store(v_new[:, 0], cv.dtype))
    _write_slots(cpos, slot, pos_vec.to(cpos.dtype))

    ck_s = shard(_kv_load(ck), _CACHE_AXES)
    cv_s = shard(_kv_load(cv), _CACHE_AXES)
    out = _attend_local(q, ck_s, cv_s, pos2, cpos, causal=True,
                        window=spec.sliding_window, softcap=cfg.attn_logit_softcap,
                        kv_valid=cpos >= 0, kv_seq="kv_seq")
    out = shard(out, _Q_AXES)
    return _project_out(out, p), cache


def empty_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                cache_len: int, dtype=torch.bfloat16, device=None) -> Params:
    """Zeros of ``dtype`` (bf16, fp32 or int8) with every slot at position -1."""
    size = _cache_size(spec.sliding_window, cache_len)
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32,
                          device=device),
    }
