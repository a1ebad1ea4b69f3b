"""The port's serving CLI (``python -m repro_torch.launch.serve``) on the
CPU against the reference's (``python -m repro.launch.serve``): the same
flags and demo configuration print the same lines (the tokens aside: the
two packages draw their weights from different generators, and the
timing), 0 sandbox violations; ``--sleep-us`` reaches the engine's
busy-wait policy as the reference's does; without ``--device`` the CLI
runs on the card and raises where there is none.

The port's training CLI (``python -m repro_torch.launch.train``) the same
way against ``python -m repro.launch.train`` at a tiny size: the same
printed lines (the losses, gradient norms and rates aside: the weights
differ), checkpoints every ``--ckpt-every`` steps, and a ``--resume``
after a crash that ends where the uninterrupted run ends, bitwise.
"""

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import PoolConfig as JaxPoolConfig  # noqa: E402
from repro.serving import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import PoolConfig, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--requests", "4", "--max-new", "4", "--d-model", "128", "--layers", "2"]


def _comparable(out: str):
    """The printed lines without the wall time and the tokens."""
    lines = out.strip().splitlines()
    return [re.sub(r" in [0-9.]+s \([0-9.]+ tok/s\)", " in <t>", line)
            for line in lines if not line.startswith("  req ")]


@pytest.fixture(scope="module")
def reference_out():
    argv = sys.argv
    sys.argv = ["serve.py"] + SMALL
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    return buf.getvalue()


def test_cli_on_cpu_prints_the_reference_lines(reference_out, capsys):
    eng = tserve.main(["--device", "cpu"] + SMALL)
    out = capsys.readouterr().out
    assert _comparable(out) == _comparable(reference_out)
    assert _comparable(out)[1] == "4 requests, 16 tokens in <t>"
    assert "sandbox violations: 0" in out
    assert len([line for line in out.splitlines() if line.startswith("  req ")]) == 4
    assert eng.device.type == "cpu" and eng.oob_events == 0
    assert eng.policy.fixed is None
    assert eng.pool.stats()["sealed_pages"] == 0


def test_cli_runs_as_a_module_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--sleep-us", "5"] + SMALL,
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("serving serve-demo: 2.7M params")
    assert "sandbox violations: 0" in res.stdout


@pytest.mark.parametrize("sleep_us", [5.0, 0.0])
def test_cli_sleep_us_reaches_the_engine_policy(sleep_us, capsys):
    eng = tserve.main(["--device", "cpu", "--sleep-us", str(sleep_us)] + SMALL)
    capsys.readouterr()
    assert eng.policy.fixed == sleep_us
    assert eng.policy.delay_s() == sleep_us * 1e-6
    assert eng.oob_events == 0


@pytest.mark.parametrize("sleep_us", [None, 0.0, 5.0, 150.0])
def test_engine_sleep_us_matches_the_reference_policy(sleep_us):
    """``ServeEngine(sleep_us=...)`` fixes the policy's back-off as the
    reference engine's does; ``None`` keeps the adaptive policy, which
    prescribes no sleep on a fresh engine."""
    pool = dict(num_pages=16, page_tokens=8, max_pages_per_seq=4)
    jcfg = jax_smoke("yi_9b")
    jeng = JaxServeEngine(jcfg, jax_build(jcfg).init(jax.random.PRNGKey(0)),
                          JaxPoolConfig(**pool), backend="ref", sleep_us=sleep_us)
    cfg = get_smoke_config("yi_9b")
    teng = ServeEngine(cfg, build_model(cfg).init(torch.Generator().manual_seed(0), "cpu"),
                       PoolConfig(**pool), sleep_us=sleep_us, device="cpu")
    assert teng.policy.fixed == jeng.policy.fixed == sleep_us
    assert teng.policy.delay_s() == jeng.policy.delay_s()
    for found in (True, False, True):
        teng.policy.record(found)
        jeng.policy.record(found)
    assert teng.policy.delay_s() == jeng.policy.delay_s()


def test_cli_without_device_raises_where_there_is_no_card(monkeypatch, capsys):
    """No ``--device``: the CLI runs on the card, and raises before it
    builds anything when CUDA is absent. No fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(SMALL)
    assert capsys.readouterr().out == ""


def test_cli_rejects_an_unknown_flag(capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--device", "cpu", "--backend", "ref"])
    assert exc.value.code == 2
    assert "unrecognized arguments: --backend" in capsys.readouterr().err


def test_cli_prompts_are_the_reference_prompts(capsys, monkeypatch):
    """The demo's prompts come from numpy seed 0 as the reference's do:
    the engine is handed the same 4 prompts."""
    seen = []
    submit = ServeEngine.submit
    monkeypatch.setattr(ServeEngine, "submit",
                        lambda self, prompt, max_new=16: seen.append(list(prompt))
                        or submit(self, prompt, max_new))
    tserve.main(["--device", "cpu"] + SMALL)
    capsys.readouterr()
    rng = np.random.default_rng(0)
    want = [list(rng.integers(1, 8192, size=int(rng.integers(4, 24)))) for _ in range(4)]
    assert seen == want


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------
TRAIN_SMALL = ["--steps", "4", "--d-model", "128", "--layers", "2", "--batch", "2",
               "--seq", "32", "--ckpt-every", "2", "--log-every", "1"]


def _train_lines(out: str):
    """The printed lines with the losses, gradient norms and rates masked."""
    return [re.sub(r"loss +[0-9.]+|gnorm +[0-9.]+|[0-9,]+ tok/s", "<x>", line)
            for line in out.strip().splitlines()]


def _run_reference_train(argv):
    saved = sys.argv
    sys.argv = ["train.py"] + argv
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jtrain.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def _crash_after(ckpt_dir: Path, step: int):
    """Leave the checkpoints as a run that crashed after ``step``'s save."""
    for d in ckpt_dir.glob("step_*"):
        if int(d.name[5:]) > step:
            shutil.rmtree(d)


def test_train_cli_prints_the_reference_lines_and_resumes(tmp_path, capsys):
    """Both CLIs at the same tiny flags print the same lines (lr to the
    digit); each crashed after step 2's checkpoint and resumed prints the
    reference's resume lines; the port's resumed run ends with the
    uninterrupted run's parameters and optimizer state, bitwise."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_out = _run_reference_train(TRAIN_SMALL + ["--ckpt-dir", str(ref_dir)])
    whole = ttrain.main(["--device", "cpu", "--ckpt-dir", str(port_dir)] + TRAIN_SMALL)
    out = capsys.readouterr().out
    assert _train_lines(out) == _train_lines(ref_out)
    assert out.splitlines()[0] == "model olmo-128x2: 5.0M params"
    assert out.splitlines()[-1] == "done; stragglers skipped: 0"
    assert _ckpt_steps(port_dir) == _ckpt_steps(ref_dir) == [2, 4]
    assert whole["start"] == 0 and len(whole["losses"]) == 4
    assert whole["model"].device.type == "cpu"

    _crash_after(ref_dir, 2)
    _crash_after(port_dir, 2)
    ref_out = _run_reference_train(TRAIN_SMALL + ["--ckpt-dir", str(ref_dir), "--resume"])
    resumed = ttrain.main(["--device", "cpu", "--ckpt-dir", str(port_dir), "--resume"]
                          + TRAIN_SMALL)
    out = capsys.readouterr().out
    assert _train_lines(out) == _train_lines(ref_out)
    assert "resumed from step 2" in out.splitlines()
    assert resumed["start"] == 2 and resumed["losses"] == whole["losses"][2:]
    for (name, a), (_, b) in zip(resumed["model"].named_parameters(),
                                 whole["model"].named_parameters()):
        assert torch.equal(a, b), name
    for key in ("m", "v"):
        for a, b in zip(_leaves(resumed["opt_state"][key]), _leaves(whole["opt_state"][key])):
            assert torch.equal(a, b)
    assert int(resumed["opt_state"]["step"]) == 4


def _ckpt_steps(d: Path):
    return sorted(int(p.name[5:]) for p in d.glob("step_*") if not p.name.endswith(".tmp"))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_train_cli_runs_as_a_module_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path), "--grad-accum", "2"] + TRAIN_SMALL,
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("model olmo-128x2: 5.0M params")
    assert res.stdout.strip().endswith("done; stragglers skipped: 0")
    assert (tmp_path / "LATEST").read_text() == "4"


def test_train_cli_without_device_raises_where_there_is_no_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--ckpt-dir", str(tmp_path)] + TRAIN_SMALL)
    assert capsys.readouterr().out == ""
    assert not any(tmp_path.iterdir())
