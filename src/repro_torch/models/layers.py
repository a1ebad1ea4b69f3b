"""Shared building blocks: init, RMSNorm (plain and gemma's ``1 + w``),
LayerNorm (OLMo's without parameters, whisper's with a scale and a bias),
rotary embeddings (RoPE and Qwen2-VL's M-RoPE), the SwiGLU and tanh-GELU
MLPs, embedding and unembedding.

Plain functions over explicit parameter trees (nested dicts, or the
``ModuleDict``/``ParameterDict`` nesting of ``Model`` — both index the
same way). Dtype discipline follows the reference: norm and RoPE compute
in fp32 and cast back to the input dtype, so both packages round at the
same places.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..sharding import is_dtensor, local_call, shard, shard_offset

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal × 1/√fan_in, drawn in fp32 and cast (the reference's rule;
    the values differ because the generators differ). On the ``meta``
    device nothing is drawn: the shape alone (``Model.param_shapes``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return w.to(device=device, dtype=dtype)


NORM_KINDS = ("rmsnorm", "rmsnorm_gemma", "layernorm_np", "layernorm")
MLP_KINDS = ("swiglu", "gelu")

# logical sharding axes of each parameter leaf, by its key (repro_torch.sharding),
# the reference's ``init_*`` axes trees
NORM_AXES = {"scale": ("embed",), "bias": ("embed",)}
MLP_AXES = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed"),
            "wi": ("embed", "mlp"), "bi": ("mlp",), "bo": ("embed",)}
EMBED_AXES = {"tok": ("vocab", "embed"), "unembed": ("embed", "vocab")}


def init_norm(d: int, kind: str, device=None) -> Params:
    """RMSNorm scales: ones, or zeros for gemma's ``(1 + w)`` form; OLMo's
    LayerNorm has no parameters (an empty subtree, as in the reference);
    whisper's has a scale of ones and a bias of zeros."""
    if kind not in NORM_KINDS:
        raise NotImplementedError(f"norm kind {kind!r} is not ported")
    if kind == "layernorm_np":
        return {}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.bfloat16, device=device),
                "bias": torch.zeros((d,), dtype=torch.bfloat16, device=device)}
    fill = torch.zeros if kind == "rmsnorm_gemma" else torch.ones
    return {"scale": fill((d,), dtype=torch.bfloat16, device=device)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w, eps: float = 1e-6,
            gemma: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis, scaled by ``w`` (``1 + w`` for gemma)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if w is not None:
        x = x * ((1.0 + w.float()) if gemma else w.float())
    return x.to(dt)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: fp32 statistics, no scale, no bias."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def layernorm(x: torch.Tensor, w, b, eps: float = 1e-5) -> torch.Tensor:
    """whisper's LayerNorm: fp32 statistics (two passes, as the reference),
    then ``w``, then ``b``, then the cast back to the input dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(x: torch.Tensor, params, kind: str, eps: float):
    """``params`` may be ``None`` or empty for ``layernorm_np``."""
    if kind not in NORM_KINDS:
        raise NotImplementedError(f"norm kind {kind!r} is not ported")
    if kind == "layernorm_np":
        return layernorm_np(x, eps)
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"], eps)
    return rmsnorm(x, params["scale"], eps, gemma=kind == "rmsnorm_gemma")


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)   # (D/2,)
    ang = positions.float()[..., None] * inv                 # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE. x: (B, S, H, D); positions3: (3, B, S)
    int, the temporal, height and width streams. The D/2 frequency slots
    split into ``sections`` (16/24/24 at D 128), each slot turned by its
    section's stream; three equal streams give 1-D RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must cover the "
                         f"{half} frequency slots")
    inv = rope_freqs(x.shape[-1], theta, device=x.device)    # (D/2,)
    stream = torch.repeat_interleave(
        torch.arange(len(sections)), torch.tensor(sections)).to(x.device)
    ang = positions3[stream].float().permute(1, 2, 0) * inv  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin)


def image_positions(n_text0: int, grid, n_text1: int) -> torch.Tensor:
    """Qwen2-VL's M-RoPE triples for text, one image and text again, (3, S)
    int32 with S = n_text0 + gh * gw + n_text1: the image's patches share
    one temporal position and count rows and columns on the height and
    width streams from where the text stopped; the text after it resumes on
    all three streams one past the grid's largest position."""
    gh, gw = grid
    rows, cols = torch.meshgrid(torch.arange(gh), torch.arange(gw), indexing="ij")
    img = torch.stack([torch.full((gh * gw,), n_text0), n_text0 + rows.reshape(-1),
                       n_text0 + cols.reshape(-1)])
    t1 = int(img.max()) + 1 + torch.arange(n_text1)
    return torch.cat([torch.arange(n_text0).expand(3, -1), img, t1.expand(3, -1)],
                     dim=1).to(torch.int32)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_apply(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    """SwiGLU, or whisper's tanh-approximate GELU with the ``bi`` and
    ``bo`` biases."""
    if kind not in MLP_KINDS:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported")
    if kind == "swiglu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
        h = shard(h, ("batch", "seq", "mlp"))
        return h @ p["wo"]
    h = F.gelu(x @ p["wi"] + p["bi"], approximate="tanh")
    h = shard(h, ("batch", "seq", "mlp"))
    return h @ p["wo"] + p["bo"]


def init_mlp(gen, d: int, d_ff: int, kind: str, device=None) -> Params:
    """SwiGLU's three matrices, or GELU's two with zero biases."""
    if kind not in MLP_KINDS:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported")
    if kind == "gelu":
        return {
            "wi": dense_init(gen, (d, d_ff), device=device),
            "bi": torch.zeros((d_ff,), dtype=torch.bfloat16, device=device),
            "wo": dense_init(gen, (d_ff, d), device=device),
            "bo": torch.zeros((d,), dtype=torch.bfloat16, device=device),
        }
    return {
        "wi_gate": dense_init(gen, (d, d_ff), device=device),
        "wi_up": dense_init(gen, (d, d_ff), device=device),
        "wo": dense_init(gen, (d_ff, d), in_axis=0, device=device),
    }


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def init_embed(gen, vocab: int, d: int, tie: bool, device=None) -> Params:
    p = {"tok": dense_init(gen, (vocab, d), in_axis=1, device=device)}
    if not tie:
        p["unembed"] = dense_init(gen, (d, vocab), device=device)
    return p


def embed_tokens(tokens: torch.Tensor, p, scale: bool, d: int):
    """The table's rows of ``tokens``. On a DTensor table each rank looks
    up the tokens of its own vocab rows, zeros for the others, and the
    rows are a partial sum over the ranks that shard the vocab (a
    vocab-parallel lookup; no operator of DTensor's indexes the table)."""
    tok = p["tok"]
    if is_dtensor(tok):
        lo, n = shard_offset(shard(tok, EMBED_AXES["tok"]), 0)

        def lookup(t, w):
            idx = t.long() - lo
            if n == tok.shape[0]:
                return w[idx]
            ok = (idx >= 0) & (idx < n)
            return torch.where(ok[..., None], w[idx.clamp(0, n - 1)], 0)

        x = local_call(lookup, [(tokens, ("batch", "seq")), (tok, EMBED_AXES["tok"])],
                       out_axes=[("batch", "seq", None)], partial_over=("vocab",))
    else:
        x = tok[tokens.long()]
    if scale:
        x = x * torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
    return x


def unembed(x: torch.Tensor, p) -> torch.Tensor:
    w = p["unembed"] if "unembed" in p else p["tok"].T
    return shard(x @ w, ("batch", "seq", "vocab"))
