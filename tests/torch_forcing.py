"""Layer-wise teacher forcing, for holding a deep bf16 model against
another run of it.

Two correct bf16 runs of a deep model part past the bf16 tolerance: each
layer's rounding is carried into the next, and XLA's fusions and the port's
per-operation rounding differ. ``forced`` holds each layer instead. A
leading side runs the model; a following side runs each layer on the
leader's input to that layer and keeps its own caches. Every layer's
output, every leaf of its cache and the logits of the leader's last hidden
state are recorded at the prefill and after every decode step, and
``check_forced`` holds them at a tolerance.

At an MoE layer the two sides may route a token apart on a router near-tie
(the rule of ``chip_smoke.py``'s MoE phases): ``routed_apart`` names
the tokens whose kept experts differ and, for each token whose experts
differ, the leader's logit gap at the k-th expert beside the two sides'
logit shift. Imports nothing of jax: ``tests/test_torch_cuda.py`` runs it
with the port on the CPU leading the port on the card, and
``tests/test_torch_hybrid.py`` with the reference leading the port.
"""

import numpy as np
import torch

from repro_torch.convert import array_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr


def expert_draws(cfg, seed=11):
    """Expert weights for every MoE position of the stack, fp32 numpy of
    the stacked shapes, drawn at std 1/√fan-in (d_model for ``w_gate`` and
    ``w_up``, ``moe_d_ff`` for ``w_down``). The reference's init draws them
    at std 1/√E, at which each MoE FFN amplifies its input's rounding
    (``tests/test_torch_hybrid.py``)."""
    rng = np.random.default_rng(seed)
    pattern = cfg.block_pattern()
    nb, E, D, F = cfg.num_layers // len(pattern), cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    draws = {}
    for i, spec in enumerate(pattern):
        if spec.moe:
            draws[f"pos{i}"] = {
                name: (rng.standard_normal((nb, E) + shape) / np.sqrt(shape[0])
                       ).astype(np.float32)
                for name, shape in (("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D)))}
    return draws


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class TorchSide:
    """The port's model on its device, as a side of ``forced``."""

    def __init__(self, model):
        self.model, self.cfg, self.dev = model, model.cfg, model.device
        pattern = self.cfg.block_pattern()
        blocks = range(self.cfg.num_layers // len(pattern))
        self.specs = [s for _ in blocks for s in pattern]
        self.params = [ttr.tree_index(model["stack"][f"pos{i}"], b)
                       for b in blocks for i in range(len(pattern))]

    def routing(self, dropless):
        return tmoe.dropless_moe(dropless)

    def take(self, x):
        """An activation of the leading side, on this side's device."""
        if not isinstance(x, torch.Tensor):
            x = array_from_numpy(np.asarray(x), "cpu")
        return x.to(self.dev)

    def _int(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def embed(self, toks):
        cfg = self.cfg
        return tl.embed_tokens(self._int(toks), self.model["embed"], cfg.embed_scale,
                               cfg.d_model)

    def full(self, L, x, pos, cache_len):
        y, _, cache = ttr.apply_layer_full(x, self.params[L], self.cfg, self.specs[L],
                                           self._int(pos), want_cache=True,
                                           cache_len=cache_len)
        return y, cache

    def decode(self, L, x, cache, pos):
        y = ttr.apply_layer_decode(x, self.params[L], self.cfg, self.specs[L], cache,
                                   self._int(pos))
        return y, cache

    def router(self, L, x, state=None):
        """Router logits (T, E) and top-k ids (T, k) of an SSM layer's MoE
        FFN, from the layer's input and, in decode, its SSM state."""
        cfg, p = self.cfg, self.params[L]
        h = tl.apply_norm(x, p["norm_in"], cfg.norm_kind, cfg.norm_eps)
        a = (tssm.ssm_forward(h, p["ssm"], cfg) if state is None
             else tssm.ssm_decode_step(h, p["ssm"], cfg, state))[0]
        h = tl.apply_norm(x + a, p["norm_mlp"], cfg.norm_kind, cfg.norm_eps)
        h = h.reshape(-1, h.shape[-1])
        idx = tmoe.route(h, p["moe"]["router"], cfg.top_k)[2]
        return (h.float() @ p["moe"]["router"]).cpu().numpy(), idx.cpu().numpy()

    def head(self, x):
        cfg = self.cfg
        x = tl.apply_norm(x, self.model["norm_f"], cfg.norm_kind, cfg.norm_eps)
        return tl.unembed(x, self.model["embed"])[:, 0].float()

    @staticmethod
    def record(a):
        """A copy: the decode caches are updated in place."""
        return (a.detach().to("cpu", torch.float32, copy=True).numpy(),
                str(a.dtype).replace("torch.", ""))


def routed_apart(logits_a, idx_a, logits_b, idx_b, cfg, dropless):
    """Where two routers part at one MoE layer, from each side's router
    logits (T, E) and top-k ids (T, k): the tokens whose kept experts
    differ (under capacity, slots placed as ``capacity_slots`` places them
    over the one group of T tokens), and (token, side a's logit gap at the
    k-th expert, the largest logit shift) for each token whose experts
    differ."""
    T, k, E = idx_a.shape[0], cfg.top_k, cfg.num_experts
    C = max(1, int(k * T / E * cfg.capacity_factor))

    def kept(idx):
        if dropless:
            return [set(r) for r in idx.tolist()]
        flat = torch.as_tensor(np.array(idx), dtype=torch.int64).reshape(1, T * k)
        order, _, keep, _ = tmoe.capacity_slots(flat, E, C)
        out = [set() for _ in range(T)]
        for slot, ok in zip(order[0].tolist(), keep[0].tolist()):
            if ok:
                out[slot // k].add(int(flat[0, slot]))
        return out

    apart = {t for t, (a, b) in enumerate(zip(kept(idx_a), kept(idx_b))) if a != b}
    top = -np.sort(-logits_a, axis=-1)
    flips = [(t, float(top[t, k - 1] - top[t, k]), float(np.abs(logits_a[t] - logits_b[t]).max()))
             for t in range(T) if set(idx_a[t].tolist()) != set(idx_b[t].tolist())]
    return apart, flips


def forced(lead, follow, toks, t0, dropless):
    """Prefill ``toks[:, :t0]``, then decode the rest, the following side's
    layers on the leading side's inputs. Returns ``rows``: (what, leader's
    record, follower's record, tokens routed apart) for every layer's
    output, every leaf of its cache and the logits, at the prefill and
    after every step; and ``ties``: (what, token, gap, shift) for every
    token whose experts differ between the sides at an MoE layer."""
    B, n = toks.shape
    cfg = follow.cfg
    rows, ties = [], []

    def held(what, y_l, y_f, c_l, c_f, apart=frozenset()):
        rows.append((what, lead.record(y_l), follow.record(y_f), apart))
        want = dict(leaves(c_l))
        for name, leaf in leaves(c_f):
            rows.append((f"{what} {name}", lead.record(want[name]), follow.record(leaf),
                         frozenset()))

    def moe_apart(what, L, x, state_l=None, state_f=None):
        apart, flips = routed_apart(*lead.router(L, x, state_l),
                                    *follow.router(L, follow.take(x), state_f), cfg, dropless)
        ties.extend((what, *f) for f in flips)
        return apart

    with lead.routing(dropless), follow.routing(dropless):
        pos = np.broadcast_to(np.arange(t0, dtype=np.int32)[None], (B, t0))
        x = lead.embed(toks[:, :t0])
        caches_l, caches_f = [], []
        for L, spec in enumerate(follow.specs):
            what = f"prefill layer {L}"
            apart = moe_apart(what, L, x) if spec.moe else frozenset()
            y_l, c_l = lead.full(L, x, pos, n)
            y_f, c_f = follow.full(L, follow.take(x), pos, n)
            held(what, y_l, y_f, c_l, c_f, apart)
            caches_l.append(c_l)
            caches_f.append(c_f)
            x = y_l
        rows.append(("prefill logits", lead.record(lead.head(x[:, -1:])),
                     follow.record(follow.head(follow.take(x[:, -1:]))), frozenset()))
        for t in range(t0, n):
            p = np.full((B,), t, np.int32)
            x = lead.embed(toks[:, t : t + 1])
            for L, spec in enumerate(follow.specs):
                what = f"decode at {t} layer {L}"
                apart = (moe_apart(what, L, x, caches_l[L]["ssm"], caches_f[L]["ssm"])
                         if spec.moe else frozenset())
                y_l, caches_l[L] = lead.decode(L, x, caches_l[L], p)
                y_f, caches_f[L] = follow.decode(L, follow.take(x), caches_f[L], p)
                held(what, y_l, y_f, caches_l[L], caches_f[L], apart)
                x = y_l
            rows.append((f"decode at {t} logits", lead.record(lead.head(x)),
                         follow.record(follow.head(follow.take(x))), frozenset()))
    return rows, ties


def check_forced(rows, ties, tol):
    """Every record at ``tol`` with the leader's dtype (slot positions
    exactly). A token routed apart at an MoE layer may lie outside it;
    every other token is held. A token's experts may differ only where the
    leader's gap at the k-th expert is within twice the logit shift."""
    for what, token, gap, shift in ties:
        assert gap <= 2 * shift, (what, token, gap, shift)
    for what, (want, want_dtype), (got, got_dtype), apart in rows:
        assert got_dtype == want_dtype, (what, got_dtype, want_dtype)
        if what.endswith(".pos"):
            np.testing.assert_array_equal(got, want, err_msg=what)
            continue
        if apart:
            outside = np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)
            rows_out = set(np.flatnonzero(outside.reshape(-1, want.shape[-1]).any(-1)).tolist())
            assert rows_out <= apart, (what, rows_out, apart)
            keep = np.ones(want.size // want.shape[-1], bool)
            keep[sorted(apart)] = False
            got, want = (a.reshape(-1, a.shape[-1])[keep] for a in (got, want))
        np.testing.assert_allclose(got, want, **tol, err_msg=what)
