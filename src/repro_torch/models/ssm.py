"""Mamba-2 / SSD (state-space duality) layers — arXiv:2405.21060.

The counterpart of ``src/repro/models/ssm.py``. Full-sequence mode runs
the chunked SSD scan of ``kernels/ssd/ops.ssd_chunked``: on a CUDA tensor
its intra-chunk part is always the hand-written kernel, on a CPU tensor
its plain version. The reference's ``use_kernel`` flag does not come
across: no knob selects the plain version on the card. Decode mode is the
O(1) recurrent update, plain torch.

Layer structure (Mamba-2 block):
  [z|x|B|C|dt] projections → causal depthwise conv on x/B/C → silu
  → SSD(x·dt, exp(dt·A), B, C) + D⊙x → gated RMSNorm(y ⊙ silu(z)) → out_proj

Rounding follows the reference: prefill casts the SSD output to the
input dtype before adding D⊙x, decode adds D⊙x in fp32 and casts after.
``F.softplus`` switches to the identity above 20, where JAX's softplus
does not; the two differ there by under 1e-8.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd_chunked
from ..sharding import local_call, shard
from .config import ModelConfig
from .layers import dense_init, rmsnorm

Params = Dict[str, Any]

NGROUPS = 1  # B/C shared across heads (Mamba-2 default ngroups=1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
# logical sharding axes of each parameter leaf (repro_torch.sharding); the
# projections are separate so that each stream shards on its own axis
SSM_AXES = {
    "in_z": ("embed", "ssm_inner"), "in_x": ("embed", "ssm_inner"),
    "in_B": ("embed", "ssm_state"), "in_C": ("embed", "ssm_state"),
    "in_dt": ("embed", "ssm_heads"),
    "conv_x": (None, "ssm_inner"), "conv_B": (None, "ssm_state"), "conv_C": (None, "ssm_state"),
    "conv_bx": ("ssm_inner",), "conv_bB": ("ssm_state",), "conv_bC": ("ssm_state",),
    "A_log": ("ssm_heads",), "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
    "norm_scale": ("ssm_inner",), "out_proj": ("ssm_inner", "embed"),
}


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """The reference's key paths, shapes and dtypes; values from ``gen``."""
    d = cfg.d_model
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    GN = NGROUPS * N
    K = cfg.ssm_conv
    bf16 = dict(dtype=torch.bfloat16, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    # dt_bias = softplus⁻¹(dt) with dt log-uniform in [1e-3, 1e-1]
    u = torch.rand((H,), generator=gen, dtype=torch.float32, device=gen.device)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_z": dense_init(gen, (d, di), device=device),
        "in_x": dense_init(gen, (d, di), device=device),
        "in_B": dense_init(gen, (d, GN), device=device),
        "in_C": dense_init(gen, (d, GN), device=device),
        "in_dt": dense_init(gen, (d, H), device=device),
        "conv_x": dense_init(gen, (K, di), device=device),
        "conv_B": dense_init(gen, (K, GN), device=device),
        "conv_C": dense_init(gen, (K, GN), device=device),
        "conv_bx": torch.zeros((di,), **bf16),
        "conv_bB": torch.zeros((GN,), **bf16),
        "conv_bC": torch.zeros((GN,), **bf16),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(dt0)).to(device),
        "norm_scale": torch.ones((di,), **bf16),
        "out_proj": dense_init(gen, (di, d), device=device),
    }


# ---------------------------------------------------------------------------
# SSD one step (the full sequence is ``ssd_chunked``, from kernels/ssd/ops)
# ---------------------------------------------------------------------------
def ssd_decode(x, dt, A, Bm, Cm, state):
    """O(1) recurrent update. x: (B,H,P); dt: (B,H); Bm/Cm: (B,G,N);
    state: (B,H,N,P). Returns (y, new_state), fp32."""
    f32 = torch.float32
    x, dt = x.to(f32), dt.to(f32)
    Bm, Cm, state = Bm.to(f32), Cm.to(f32), state.to(f32)
    dA = torch.exp(dt * A[None, :])                                    # (B,H)
    inc = torch.einsum("bgn,bh,bhp->bhnp", Bm, dt, x)
    new_state = state * dA[:, :, None, None] + inc
    y = torch.einsum("bgn,bhnp->bhp", Cm, new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# full Mamba-2 block
# ---------------------------------------------------------------------------
def _conv_full(xc, w, b):
    """Causal depthwise conv along seq. xc: (B,S,C); w: (K,C). A sum of K
    products in order, as the reference (not ``F.conv1d``, which
    accumulates differently and runs fp32 in TF32 under cuDNN)."""
    K, S = w.shape[0], xc.shape[1]
    pad = F.pad(xc, (0, 0, K - 1, 0))
    # sum_k w[k] * x[s - (K-1) + k]
    out = sum(pad[:, k: k + S] * w[k] for k in range(K))
    return out + b


# the SSD scan runs on each rank's local heads (``local_call``): x, dt and A
# by ``ssm_heads``, while B and C, shared by every head, stay whole
_HEADS_AXES = ("batch", "seq", "ssm_heads", None)
_SHARED_AXES = ("batch", "seq", None, None)


def _conv_silu(xc, w, b, axis: str):
    """silu of the causal depthwise conv of the (B, S, C) stream ``xc``,
    whose channels lie on the logical ``axis``; on each rank's local
    channels and batch under a mesh (each channel is its own conv)."""
    return local_call(lambda t, wt, bt: F.silu(_conv_full(t, wt, bt)),
                      [(xc, ("batch", "seq", axis)), (w, (None, axis)), (b, (axis,))],
                      out_axes=[("batch", "seq", axis)])


def ssm_forward(x, p: Params, cfg: ModelConfig, want_state: bool = False):
    """Full-sequence Mamba-2 block. x: (B, S, D). Returns (out, state)."""
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    z = x @ p["in_z"]
    xr = x @ p["in_x"]
    Br = x @ p["in_B"]
    Cr = x @ p["in_C"]
    dt_raw = x @ p["in_dt"]

    xin = _conv_silu(xr, p["conv_x"], p["conv_bx"], "ssm_inner")
    Bm = _conv_silu(Br, p["conv_B"], p["conv_bB"], "ssm_state")
    Cm = _conv_silu(Cr, p["conv_C"], p["conv_bC"], "ssm_state")

    xin = shard(xin.reshape(B, S, H, P), ("batch", "seq", "ssm_heads", None))
    Bm = Bm.reshape(B, S, NGROUPS, N)
    Cm = Cm.reshape(B, S, NGROUPS, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, s_final = local_call(
        lambda *t: ssd_chunked(*t, cfg.ssm_chunk),
        [(xin, _HEADS_AXES), (dt, _HEADS_AXES[:3]), (A, ("ssm_heads",)),
         (Bm, _SHARED_AXES), (Cm, _SHARED_AXES)],
        out_axes=[_HEADS_AXES, ("batch", "ssm_heads", None, None)])
    y = y + xin * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"], cfg.norm_eps)
    out = y @ p["out_proj"]

    state = None
    if want_state:
        Kc = cfg.ssm_conv

        def tail(stream):   # last (K-1) raw conv inputs
            if S >= Kc - 1:
                return stream[:, -(Kc - 1):]
            return F.pad(stream, (0, 0, Kc - 1 - S, 0))

        state = {"conv_x": tail(xr), "conv_B": tail(Br), "conv_C": tail(Cr),
                 "ssd": s_final.float()}
    return out, state


def ssm_decode_step(x, p: Params, cfg: ModelConfig, state: Params):
    """One-token decode. x: (B, 1, D); state: conv tails + ssd state.
    Returns (out (B, 1, D), new state)."""
    B = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    xt = x[:, 0]
    z = xt @ p["in_z"]
    xr = xt @ p["in_x"]
    Br = xt @ p["in_B"]
    Cr = xt @ p["in_C"]
    dt_raw = xt @ p["in_dt"]

    def conv_step(tail, new, w, b):
        window = torch.cat([tail, new[:, None]], dim=1)          # (B,K,C), promoted
        wt = torch.promote_types(window.dtype, w.dtype)
        out = F.silu(torch.einsum("bkc,kc->bc", window.to(wt), w.to(wt)) + b)
        return out, window[:, 1:]

    xin, ncx = conv_step(state["conv_x"], xr, p["conv_x"], p["conv_bx"])
    Bm, ncB = conv_step(state["conv_B"], Br, p["conv_B"], p["conv_bB"])
    Cm, ncC = conv_step(state["conv_C"], Cr, p["conv_C"], p["conv_bC"])

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, new_ssd = ssd_decode(
        xin.reshape(B, H, P), dt, A,
        Bm.reshape(B, NGROUPS, N), Cm.reshape(B, NGROUPS, N), state["ssd"])
    y = y + xin.reshape(B, H, P).float() * p["D"][None, :, None]
    y = y.reshape(B, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv_x": ncx, "conv_B": ncB, "conv_C": ncC, "ssd": new_ssd}


def empty_ssm_state(cfg: ModelConfig, batch: int, device=None) -> Params:
    GN = NGROUPS * cfg.ssm_state
    K = cfg.ssm_conv
    bf16 = dict(dtype=torch.bfloat16, device=device)
    return {
        "conv_x": torch.zeros((batch, K - 1, cfg.d_inner), **bf16),
        "conv_B": torch.zeros((batch, K - 1, GN), **bf16),
        "conv_C": torch.zeros((batch, K - 1, GN), **bf16),
        "ssd": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32, device=device),
    }
