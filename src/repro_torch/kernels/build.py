"""Build plumbing for the port's kernels.

CUDA C++ sources live in ``src/repro_torch/csrc/`` and are compiled with
``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Outputs go to
``build/repro_torch_kernels/`` at the root of the checkout, named by the
source's content hash so an edited source never loads a stale library.
Triton's own cache is pointed at the same directory.  Nothing here runs at
import time: kernels build at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent.parent / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-I", str(CSRC_DIR),
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required")
    return nvcc


def library_path(source: str) -> Path:
    """Where the shared library of ``csrc/<source>`` is built: named by the
    hash of the source and of every header in ``csrc/``."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def compile_command(source: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / source)]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    return build_all([source])[0]


def build_all(sources: list[str]) -> list[Path]:
    """Compile every ``csrc/<source>`` whose library is not built yet, one
    ``nvcc`` process each, all started together; raise if any fails."""
    outs = [library_path(src) for src in sources]
    procs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            compile_command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        procs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = ctypes.CDLL(str(build(source)))
        return lib


def use_local_triton_cache() -> None:
    """Keep Triton's compile cache inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
