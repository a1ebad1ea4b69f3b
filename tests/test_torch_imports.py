"""Import guard for the port: ``src/repro_torch``, ``chip_smoke.py`` and
the card-only tests (run where jax is not installed) import neither jax
nor anything of the reference package, and every on-path kernel has its
CUDA source."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tests" / "test_torch_cuda.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.relative_to(ROOT)}:{line}: {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert bad == []


def test_guard_covers_the_launch_package():
    """The CLI (``repro_torch/launch/``) is among the files guarded."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {"launch/__init__.py", "launch/serve.py"} <= names


def test_guard_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import heap\n"
                   "from repro_torch.core import heap as ok\n"
                   "import importlib\nimportlib.import_module('repro.models')\n")
    assert [m for _, m in _imports(src) if _forbidden(m)] == \
        ["jax.numpy", "repro.core", "repro.models"]


@pytest.mark.parametrize("kernel,source", [
    ("paged_attention", "paged_attention.cu"),
    ("scope_copy", "scope_copy.cu"),
    ("ssd", "ssd.cu"),
    ("flash_prefill", "flash_prefill.cu"),
])
def test_every_on_path_kernel_has_a_cuda_source(kernel, source):
    cu = PORT / "csrc" / source
    assert cu.is_file()
    text = cu.read_text()
    assert "__global__" in text and 'extern "C"' in text
    # beside it: the plain version and the dispatching wrapper
    for part in ("ref.py", "kernel.py", "ops.py"):
        assert (PORT / "kernels" / kernel / part).is_file()


def test_guard_covers_the_sanitizer_package():
    """ShmCheck's port (``repro_torch/analysis/``) is among the files
    guarded: host code that imports neither jax nor the reference."""
    names = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    assert {f"analysis/{m}.py" for m in ("__init__", "findings", "hb", "runtime",
                                         "tracer")} <= names
