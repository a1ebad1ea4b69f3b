"""The port's GPipe pipeline against the reference's
(``src/repro/training/pipeline.py``): on 4 gloo ranks, a (4,) ``pod``
mesh, D 16, B 8, ``n_micro`` 4 and ``tanh(x @ w)`` as the stage, the
output equals the sequential stack at atol and rtol 1e-5 on every rank
(``tests/test_distribution.py:161-184``), with the stage weights whole or
sharded over ``pod``, and equals the reference's ``pipeline_apply`` on the
same numpy inputs with 4 host devices at the same tolerance. One stage is
the identity ring; ``bubble_fraction`` is the reference's; a batch that
``n_micro`` does not divide raises."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402
from torch_dist import ROOT, run_ranks  # noqa: E402

from repro.training.pipeline import bubble_fraction as jax_bubble_fraction  # noqa: E402
from repro_torch.training.pipeline import bubble_fraction, pipeline_apply  # noqa: E402

STAGES, D, B, N_MICRO = 4, 16, 8, 4
TOL = dict(atol=1e-5, rtol=1e-5)     # tests/test_distribution.py:182
RANKS_TIMEOUT_S = 180
REFERENCE_TIMEOUT_S = 300

REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.training.pipeline import pipeline_apply

inp = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("pod",))
y = pipeline_apply(lambda x, w: jnp.tanh(x @ w), jnp.asarray(inp["x"]), jnp.asarray(inp["ws"]),
                   mesh=mesh, axis="pod", n_micro=int(inp["n_micro"]))
np.save(sys.argv[2], np.asarray(y))
print("DEVICES", len(jax.devices()))
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"ws": (rng.standard_normal((STAGES, D, D)) / np.sqrt(D)).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32), "n_micro": N_MICRO}


def _sequential(x, ws):
    y = torch.from_numpy(x)
    for w in ws:
        y = torch.tanh(y @ torch.from_numpy(w))
    return y.numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo ranks' outputs and the reference's, on the same inputs."""
    wd = tmp_path_factory.mktemp("pipeline")
    inp = _inputs()
    np.savez(wd / "inputs.npz", **inp)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE),
                            str(wd / "inputs.npz"), str(wd / "reference.npy")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        torch.save(inp, wd / "inputs.pt")
        result = run_ranks("pipeline", STAGES, wd, timeout=RANKS_TIMEOUT_S)
        out, err = ref.communicate(timeout=REFERENCE_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    assert "DEVICES 4" in out
    return inp, result, np.load(wd / "reference.npy")


@pytest.mark.parametrize("params", ["whole", "sharded"])
def test_gpipe_matches_the_sequential_stack_on_every_rank(runs, params):
    inp, result, _ = runs
    want = _sequential(inp["x"], inp["ws"])
    for rank, y in enumerate(result[params]):
        np.testing.assert_allclose(y, want, err_msg=f"rank {rank}", **TOL)


def test_gpipe_matches_the_reference(runs):
    _, result, reference = runs
    np.testing.assert_allclose(result["whole"][0], reference, **TOL)
    np.testing.assert_array_equal(result["sharded"][0], result["whole"][0])


@pytest.fixture
def one_stage():
    """A (1,) ``pod`` mesh on a one-rank ``fake`` group: one stage moves
    nothing, so no collective runs."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    finally:
        dist.destroy_process_group()


def test_one_stage_is_the_stack_on_each_microbatch(one_stage):
    inp = _inputs()
    ws = torch.from_numpy(inp["ws"][:1])
    calls = []

    def stage(h, w):
        calls.append(tuple(h.shape))
        return torch.tanh(h @ w)

    y = pipeline_apply(stage, torch.from_numpy(inp["x"]), ws, mesh=one_stage, n_micro=N_MICRO)
    assert calls == [(B // N_MICRO, D)] * N_MICRO       # n_micro + 1 - 1 ticks
    want = torch.cat([torch.tanh(torch.from_numpy(inp["x"])[i:i + B // N_MICRO] @ ws[0])
                      for i in range(0, B, B // N_MICRO)])
    assert torch.equal(y, want)


def test_n_micro_must_divide_the_batch(one_stage):
    with pytest.raises(ValueError, match="does not divide"):
        pipeline_apply(lambda h, w: h, torch.zeros(6, D), torch.zeros(1, D, D),
                       mesh=one_stage, n_micro=4)


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8, 16])
def test_bubble_fraction_equals_the_reference(n_stages):
    for n_micro in (1, 4, 8, 32):
        assert bubble_fraction(n_stages, n_micro) == jax_bubble_fraction(n_stages, n_micro)
    assert bubble_fraction(1, 4) == 0.0
