"""The port's gradient compression against the reference's
(``src/repro/training/grad_comp.py``): ``_quantize`` over the grid of
``tests/test_training.py:210``, error feedback and ``estimate_bytes``
(``:216-232``, and every smoke configuration's tree), and
``compressed_psum`` on 8 gloo ranks over numpy seed 0 gradients of shape
(8, 64, 64), with and without ``n_shards``: the bounds of
``tests/test_distribution.py:127-157``, the dtypes on the wire, and the
reference's own ``compressed_psum`` on the same inputs in a subprocess
with 8 host devices (``jax.set_mesh`` over ``Auto`` axes, ROADMAP Queue 3
entry 16), two rounds with error feedback.

Codes are compared outside half-integer ties: where (g + e)/scale lies
within ``TIE`` of k + ½, one package's fp32 quotient may round the other
way. The tests count those elements."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_dist import ROOT, run_ranks  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training.grad_comp import _quantize as jax_quantize  # noqa: E402
from repro.training.grad_comp import estimate_bytes as jax_estimate_bytes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.grad_comp import _quantize, estimate_bytes  # noqa: E402

RANKS = 8
TIE = 2e-5                      # |frac(t)| within this of ½ (ulp(127) = 7.6e-6): a tie
ATOL = 1e-6                     # against the reference, outside ties
# the union over 8 ranks and 2 rounds covers ~2·TIE·16 of the elements; allow 4×
MAX_TIE_SHARE = 4 * 2 * TIE * RANKS * 2
RANKS_TIMEOUT_S = 180
REFERENCE_TIMEOUT_S = 300


def _ties(t: np.ndarray) -> np.ndarray:
    return np.abs(np.abs(t - np.floor(t)) - 0.5) < TIE


@pytest.mark.parametrize("n", [8, 97, 512])
@pytest.mark.parametrize("scale", [1e-3, 3.7e-2, 1.0, 29.0, 1e3])
def test_quantize_matches_the_reference(scale, n):
    """Codes, scale and error state equal the reference's outside ties,
    and the reconstruction keeps the reference's bound (half a step)."""
    g = np.random.default_rng(0).normal(size=n).astype(np.float32) * scale
    q, s, err = _quantize(torch.from_numpy(g), torch.zeros(n))
    jq, js, jerr = jax_quantize(jnp.asarray(g), jnp.zeros(n))
    assert q.dtype == torch.int8
    assert float(s) == float(js)
    ties = _ties(g.astype(np.float64) / float(s))
    assert ties.sum() <= 1, ties.sum()
    np.testing.assert_array_equal(q.numpy()[~ties], np.asarray(jq)[~ties])
    np.testing.assert_allclose(err.numpy()[~ties], np.asarray(jerr)[~ties], atol=ATOL, rtol=0)
    recon = q.numpy().astype(np.float32) * float(s)
    assert np.max(np.abs(recon - g)) <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates():
    """With error feedback, repeated compression of a constant gradient
    keeps its mass: the mean of 50 dequantized updates is g."""
    g = torch.tensor([1e-4, 3e-2, -2e-1, 0.5])
    err = torch.zeros(4)
    total = torch.zeros(4)
    for _ in range(50):
        q, s, err = _quantize(g, err)
        total = total + q.float() * s
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=1e-3)


def test_bytes_estimate():
    est = estimate_bytes({"w": torch.zeros((128, 128), dtype=torch.bfloat16)})
    assert est == {"dense_bf16": 2 * 128 * 128, "int8_ef": 128 * 128, "reduction": 2.0}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bytes_estimate_of_every_smoke_tree_equals_the_reference(arch):
    got = estimate_bytes(build_model(get_smoke_config(arch)).param_shapes())
    want = jax_estimate_bytes(jax_build(jax_smoke(arch)).param_shapes())
    assert got == want


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import shard_map
from repro.training.grad_comp import compressed_psum

g = np.load(sys.argv[1])
n = g.shape[0]
mesh = jax.make_mesh((n,), ("pod",), axis_types=(AxisType.Auto,))
out = {}
for name, n_shards in (("int32", None), ("int8", n)):
    def body(g_local, e_local):
        ghat, e = compressed_psum({"w": g_local[0]}, {"w": e_local[0]}, "pod",
                                  n_shards=n_shards)
        return ghat["w"], e["w"][None]
    f = shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                  out_specs=(P(), P("pod")))
    e = jnp.zeros(g.shape, jnp.float32)
    with jax.set_mesh(mesh):
        for r in range(2):
            ghat, e = f(jnp.asarray(g), e)
            out[f"{name}_ghat_{r}"] = np.asarray(ghat)
            out[f"{name}_err_{r}"] = np.asarray(e)
np.savez(sys.argv[2], **out)
print("DEVICES", len(jax.devices()))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 8 gloo ranks' results and the reference's, on numpy seed 0
    gradients (8, 64, 64), one row a rank."""
    wd = tmp_path_factory.mktemp("grad_comp")
    g = np.random.default_rng(0).standard_normal((RANKS, 64, 64)).astype(np.float32)
    np.save(wd / "g.npy", g)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(wd / "g.npy"),
                            str(wd / "reference.npz")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        torch.save({"g": g, "n": RANKS}, wd / "inputs.pt")
        result = run_ranks("grad_comp", RANKS, wd, timeout=RANKS_TIMEOUT_S)
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    assert "DEVICES 8" in out
    return g, result, dict(np.load(wd / "reference.npz"))


def _tie_mask(g, rounds, qmax):
    """Elements where any rank's (g + e)/scale is a half-integer tie, in
    any round (its error state from the round before)."""
    mask = np.zeros(g.shape[1:], bool)
    e = np.zeros_like(g)
    for r in rounds:
        gf = g + e
        scale = np.float32(np.abs(gf).max() / np.float32(qmax) + np.float32(1e-12))
        mask |= _ties((gf / scale).astype(np.float64)).any(axis=0)
        e = r["err"]
    return mask


@pytest.mark.parametrize("wire", ["int32", "int8"])
def test_compressed_psum_is_close_to_the_dense_mean(runs, wire):
    """tests/test_distribution.py:127-157's bounds: |ĝ − mean| and |e|
    within max|g|/100 with int32 sums (qmax 127). With int8 sums over 8
    ranks qmax is 127 // 8 = 15, whose half step (max|g|/30) that bound
    cannot hold: there both are held to half a step, max|g|/(2·qmax)."""
    g, result, _ = runs
    qmax = 127 if wire == "int32" else 127 // RANKS
    first = result[wire][0]
    tol = float(np.abs(g).max()) / 100 if wire == "int32" \
        else float(np.abs(g).max()) / (2 * qmax) * (1 + 1e-6)
    mean = g.mean(axis=0)
    for ghat in first["ghat"]:                       # every rank holds the same ĝ
        np.testing.assert_array_equal(ghat, first["ghat"][0])
    assert np.abs(first["ghat"][0] - mean).max() <= tol
    assert np.abs(first["err"]).max() <= tol


@pytest.mark.parametrize("wire", ["int32", "int8"])
def test_compressed_psum_matches_the_reference(runs, wire):
    """Two rounds with error feedback: ĝ and every rank's error state
    equal the reference's within 1e-6 outside ties."""
    g, result, reference = runs
    qmax = 127 if wire == "int32" else 127 // RANKS
    mask = _tie_mask(g, result[wire], qmax)
    assert mask.sum() <= MAX_TIE_SHARE * mask.size, mask.sum()
    for r, got in enumerate(result[wire]):
        np.testing.assert_allclose(got["ghat"][0][~mask], reference[f"{wire}_ghat_{r}"][~mask],
                                   atol=ATOL, rtol=0, err_msg=f"round {r}")
        np.testing.assert_allclose(got["err"][:, ~mask], reference[f"{wire}_err_{r}"][:, ~mask],
                                   atol=ATOL, rtol=0, err_msg=f"round {r}")


def test_the_wire_dtype_is_int8_with_n_shards_and_int32_without(runs):
    """One all-reduce (MAX) of the fp32 maxima, then the codes: int8 with
    ``n_shards``, int32 without, every round."""
    _, result, _ = runs
    for wire in ("int32", "int8"):
        for r in result[wire]:
            assert r["wire"] == ["torch.float32", f"torch.{wire}"]
