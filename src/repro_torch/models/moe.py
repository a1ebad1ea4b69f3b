"""Mixture-of-Experts FFN: top-k routing with sort-based grouped dispatch.

Two modes, as in the reference:

* capacity routing (the default): tokens are cut into groups of
  ``group_size``, each group's (token, slot) pairs are argsorted by expert
  id, packed into an (E, C, D) buffer (capacity C per expert; a slot
  ranked past C is dropped, GShard-style), pushed through batched expert
  products and combined back with the routing weights;
* dropless (inside ``dropless_moe()``): exact top-k. The expert-sorted
  rows go through one SwiGLU product per expert that has rows, as the
  reference's ``ragged_dot`` computes it. Serving uses this mode.

Routing rounds as the reference does: fp32 router logits and softmax,
the top-k weights renormalised, ties broken towards the lower expert id
(``jax.lax.top_k``'s order), the slot order a stable sort (which slots
keep their place under capacity), the weights cast to the activation
dtype before the product, and each token's k outputs added in expert
order in that dtype (the order of the reference's scatter-add).
Under sharding rules (``repro_torch.sharding``) the capacity path's
token groups take the data-parallel placement when their count divides
it (``_group_axis``), and the (E, C, ·) expert buffers the ``expert``
axis, as the reference lays them out.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding import current_mesh, current_rules, local_call, mesh_axis_sizes, shard
from .config import ModelConfig
from .layers import dense_init

Params = Dict[str, Any]

_dropless = contextvars.ContextVar("repro_torch_moe_dropless", default=False)


@contextlib.contextmanager
def dropless_moe(enabled: bool = True):
    """Exact top-k MoE (no capacity, no dropped slots) inside the block."""
    tok = _dropless.set(enabled)
    try:
        yield
    finally:
        _dropless.reset(tok)


# logical sharding axes of each parameter leaf (repro_torch.sharding)
MOE_AXES = {"router": ("embed", None), "w_gate": ("expert", "embed", "mlp"),
            "w_up": ("expert", "embed", "mlp"), "w_down": ("expert", "mlp", "embed")}


def init_moe(gen, cfg: ModelConfig, device=None) -> Params:
    """Router fp32 (d, E); expert weights (E, d, F), (E, d, F), (E, F, d)
    in bf16; the reference's key names and fan-in rule."""
    d, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": dense_init(gen, (d, E), dtype=torch.float32, device=device),
        "w_gate": dense_init(gen, (E, d, Fd), device=device),
        "w_up": dense_init(gen, (E, d, Fd), device=device),
        "w_down": dense_init(gen, (E, Fd, d), device=device),
    }


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router probabilities (..., E) in fp32 and the top ``k`` of them,
    renormalised: (probs, weights (..., k), expert ids (..., k)). Equal
    probabilities go to the lower expert id first, as ``jax.lax.top_k``
    orders them (a zero pad row's uniform probabilities pick 0..k-1)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = vals[..., :k]
    return probs, weights / weights.sum(-1, keepdim=True), idx[..., :k]


def swiglu_gate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) · b rounded where the reference rounds it: ``jax.nn.silu``
    is a · (1 / (1 + exp(−a))), each operation rounded to the activation
    dtype (``F.silu`` rounds once, which in bf16 moves the expert outputs
    by a few ulps). Out of place, so that autograd can differentiate it."""
    return torch.reciprocal(torch.exp(-a) + 1) * a * b


def capacity_slots(flat_e: torch.Tensor, num_experts: int, capacity: int):
    """Slot placement of (ng, G·k) expert ids under ``capacity``: the stable
    expert order of the slots, each sorted slot's flat buffer row
    (expert·C + rank, or E·C when dropped), its keep mask, and the
    per-expert counts (ng, E)."""
    ng, n = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((ng, num_experts), dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(1) - counts                        # exclusive
    rank = torch.arange(n, device=flat_e.device)[None] - torch.gather(starts, 1, sorted_e)
    keep = rank < capacity
    dest = torch.where(keep, sorted_e * capacity + rank, num_experts * capacity)
    return order, dest, keep, counts


def _combine(contrib: torch.Tensor, token_of_slot: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k weighted slot outputs summed: ``contrib`` (..., T·k, D)
    holds them in the expert-sorted slot order, ``token_of_slot`` their
    tokens. A token's outputs are added in that order (by expert id) in
    the activation dtype, as the reference's scatter-add adds them;
    deterministic on the card, where an atomic scatter-add is not."""
    at = torch.argsort(token_of_slot, dim=-1, stable=True)   # a token's k slots, in order
    D = contrib.shape[-1]
    rows = torch.gather(contrib, -2, at[..., None].expand(*at.shape, D))
    rows = rows.reshape(*at.shape[:-1], at.shape[-1] // k, k, D)
    y = rows[..., 0, :]
    for j in range(1, k):
        y = y + rows[..., j, :]
    return y


def _to_slots(xg: torch.Tensor, router: torch.Tensor, k: int, E: int, C: int):
    """Routing and the expert buffer of (ng, G, D) token groups, each
    group on its own: (buf (ng, E, C, D), the stable expert order of the
    (token, slot) pairs (ng, G·k), each sorted pair's buffer row (E·C
    when dropped), its routing weight (fp32), and each group's
    Σ_e f_e · P_e (ng,) for the aux loss)."""
    ng, G, D = xg.shape
    probs, weights, idx = route(xg, router, k)                # (ng, G, E), (ng, G, k)
    order, dest, keep, counts = capacity_slots(idx.reshape(ng, G * k), E, C)
    rows = lambda i: i[..., None].expand(-1, -1, D)

    xs = torch.gather(xg, 1, rows(order // k))
    buf = torch.zeros((ng, E * C + 1, D), dtype=xg.dtype, device=xg.device)
    buf.scatter_(1, rows(dest), torch.where(keep[..., None], xs, 0))
    w_slot = torch.gather(weights.reshape(ng, G * k), 1, order)
    # load-balancing aux loss (Switch-style): E · Σ_e f_e · P_e, its Σ here
    f = counts.float() / (G * k)
    return (buf[:, :-1].reshape(ng, E, C, D), order, dest, w_slot,
            torch.sum(f * probs.mean(1), dim=-1))


def _from_slots(out: torch.Tensor, order: torch.Tensor, dest: torch.Tensor,
                w_slot: torch.Tensor, k: int) -> torch.Tensor:
    """The experts' (ng, E, C, D) outputs back to each group's tokens,
    weighted and summed (``_to_slots``' order, rows and weights)."""
    ng, E, C, D = out.shape
    flat_out = torch.cat([out.reshape(ng, E * C, D),
                          torch.zeros((ng, 1, D), dtype=out.dtype, device=out.device)], 1)
    y_slot = torch.gather(flat_out, 1, dest[..., None].expand(-1, -1, D))
    return _combine(y_slot * w_slot.to(y_slot.dtype)[..., None], order // k, k)


def _dispatch_groups(xg: torch.Tensor, p, cfg: ModelConfig, capacity: int):
    """GShard-style dispatch over (ng, G, D) token groups. Returns
    (y (ng, G, D), aux). Under sharding rules the routing and the
    combine run on each rank's local groups (``local_call``), and the
    expert products on DTensors between them."""
    ng, G, D = xg.shape
    E, k, C = cfg.num_experts, cfg.top_k, capacity
    gax = _group_axis(ng)  # None when ng doesn't divide the DP extent
    g_ax, x_ax = (gax, None), (gax, None, "embed")

    xg = shard(xg, x_ax)
    buf, order, dest, w_slot, aux_g = local_call(
        lambda x, r: _to_slots(x, r, k, E, C), [(xg, x_ax), (p["router"], ("embed", None))],
        out_axes=[(gax, None, None, "embed"), g_ax, g_ax, g_ax, (gax,)])

    # tokens→experts: group-sharded → expert-sharded
    buf = shard(buf, (None, "expert", None, "embed"))
    h = swiglu_gate(torch.einsum("gecd,edf->gecf", buf, p["w_gate"]),
                    torch.einsum("gecd,edf->gecf", buf, p["w_up"]))
    h = shard(h, (None, "expert", None, "mlp"))
    out = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    # experts→tokens: back to group-sharded
    out = shard(out, (gax, None, None, "embed"))

    y = local_call(lambda o, oi, d, w: _from_slots(o, oi, d, w, k),
                   [(out, (gax, None, None, "embed")), (order, g_ax), (dest, g_ax),
                    (w_slot, g_ax)], out_axes=[x_ax])
    aux = E * torch.mean(shard(aux_g, (None,)))
    return y, aux


def _group_axis(ng: int):
    """The token-group dim carries the DP sharding iff it divides it."""
    rules, mesh = current_rules(), current_mesh()
    if not rules or mesh is None:
        return None
    r = rules.get("batch")
    axes = (r,) if isinstance(r, str) else tuple(r or ())
    sizes = mesh_axis_sizes(mesh)
    dp = 1
    for a in axes:
        dp *= sizes.get(a, 1)
    return "batch" if dp > 1 and ng % dp == 0 else None


def _dispatch_dropless(x: torch.Tensor, p, cfg: ModelConfig):
    """Exact top-k over (T, D) rows: the expert-sorted rows of each expert
    that has rows through its three products, the gate in between over
    all rows at once. Reads the per-expert counts on the host (one
    device-to-host copy a call). Returns (y (T, D), aux)."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.top_k

    probs, weights, idx = route(x, p["router"], k)
    order, _, _, counts = capacity_slots(idx.reshape(1, T * k), E, T * k)
    order, counts = order[0], counts[0]
    token_of_slot = order // k

    spans, start = [], 0
    for e, n in enumerate(counts.tolist()):
        if n:
            spans.append((e, slice(start, start + n)))
            start += n
    xs = x[token_of_slot]                                     # (T·k, D), expert-sorted

    def per_expert(rows_in, w):   # each expert's product over its span, in order
        return torch.cat([rows_in[rows] @ w[e] for e, rows in spans])

    h = swiglu_gate(per_expert(xs, p["w_gate"]), per_expert(xs, p["w_up"]))
    out = per_expert(h, p["w_down"])

    w_slot = weights.reshape(-1)[order].to(out.dtype)
    y = _combine(out * w_slot[:, None], token_of_slot, k)

    f = counts.float() / (T * k)
    aux = E * torch.sum(f * probs.mean(0))
    return y, aux


def moe_apply(x: torch.Tensor, p, cfg: ModelConfig,
              group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (y (B, S, D), aux loss, 0-d fp32)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    if _dropless.get():
        y, aux = _dispatch_dropless(xt, p, cfg)
        return y.reshape(B, S, D), aux.float()
    G = min(group_size, T)
    ng = (T + G - 1) // G
    pad = ng * G - T
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    capacity = max(1, int(cfg.top_k * G / cfg.num_experts * cfg.capacity_factor))
    y, aux = _dispatch_groups(xt.reshape(ng, G, D), p, cfg, capacity)
    return y.reshape(ng * G, D)[:T].reshape(B, S, D), aux.float()
