"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper) into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, one ``nvcc`` per source started together, and
lands in ``build/repro_torch_kernels/<hash of the sources>/`` at the root
of the checkout, so a change to any source rebuilds and an unchanged tree
reuses the library. nvcc's output (ptxas's register and spill report) is
kept beside the library and read back into ``build_log`` when it is
reused.

C entry points launch on the stream they are given (the caller passes
``torch.cuda.current_stream().cuda_stream``) and return
``cudaGetLastError()``; ``check`` turns a non-zero code into an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
LOG_NAME = "nvcc.log"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: name → argtypes (restype is int)
SIGNATURES = {
    # q, k_pool, v_pool, block_tab, seq_lens, perm, sandbox, bitmap,
    # out, oob, B, Hq, Hkv, D, P, T, MAXP, dtype code, stream
    "paged_attention_launch": [_P] * 10 + [_I] * 8 + [_P],
    # B, Hkv; the bf16 launch's cluster size, or -(CUDA error)
    "paged_attention_cluster_size": [_I, _I],
    # src, dst, pages, n, row_bytes, P, stream
    "gather_pages_launch": [_P] * 3 + [_I] * 3 + [_P],
    # pool, buf, pages, n, row_bytes, P, stream
    "scatter_pages_launch": [_P] * 3 + [_I] * 3 + [_P],
    # x, dt, A, Bm, Cm, y, states, decay, B, S, H, P, N, Q, dtype code, stream
    "ssd_intra_chunk_launch": [_P] * 8 + [_I] * 7 + [_P],
    # no arguments; blocks of the bf16 kernel an SM, or -(CUDA error)
    "ssd_intra_chunk_bf16_blocks_per_sm": [],
    # q, k, v, out, lse (or null), B, S, Hq, Hkv, D, window, dtype code, softcap, stream
    "flash_prefill_launch": [_P] * 5 + [_I] * 7 + [ctypes.c_float, _P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, Hq, Hkv, D, window,
    # dtype code, softcap, stream
    "flash_prefill_bwd_launch": [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P],
}
ERROR_STRING = "repro_cuda_error_string"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: List[str] = []   # nvcc's output of the build in use (ptxas report)


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(needs the CUDA toolkit, on PATH or in /usr/local/cuda)")


def _run_all(cmds: List[List[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        build_log.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels (if the sources changed) and return the
    library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib, log_path = out_dir / LIB_NAME, out_dir / LOG_NAME
    if lib.exists():
        if not build_log and log_path.exists():
            build_log.append(log_path.read_text())
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        srcs = _sources()
        objs = [Path(tmp) / (src.stem + ".o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(srcs, objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        _run_all([[nvcc, "-shared", *NVCC_FLAGS[:2], *map(str, objs),
                   "-o", str(tmp_lib)]])
        log_path.write_text("\n".join(build_log))   # before the library appears
        os.replace(tmp_lib, lib)   # atomic: a concurrent loader sees all or nothing
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, ERROR_STRING)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def variant_source(src: str, subs) -> str:
    """``src`` with each (old, new) substitution applied; each ``old`` must
    occur exactly once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"substitution anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(source: str, variants: dict, out_name: str, entry: str) -> dict:
    """Build each variant of ``csrc/<source>`` (name → its substitutions)
    as a library of its own in ``build/<out_name>/``, one nvcc each, all
    started together. Returns name → (the loaded library, with ``entry``'s
    signature set, or None if the build failed; nvcc's output)."""
    src = (CSRC / source).read_text()
    out_dir = BUILD_ROOT.parent / out_name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", str(cu), "-o", str(out_dir / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        lib = None
        if proc.returncode == 0:
            lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
            getattr(lib, entry).argtypes = SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        built[name] = (lib, out)
    return built


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if code != 0:
        msg = getattr(library(), ERROR_STRING)(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
