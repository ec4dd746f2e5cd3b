"""Build the CUDA sources under ``kpvid_tpu_torch/csrc`` and bind them.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, which is loaded with ``ctypes``. Libraries are cached in
a build directory (``build/kpvid_tpu_torch`` at the root of the checkout,
or ``$KPVID_TORCH_BUILD_DIR``) under a name that carries the hash of the
source, of every header in ``csrc`` (``*.cuh``, ``*.h``) and of the flags,
so an edited source or header is rebuilt at its next use.
Nothing is built when a module is imported: the first kernel launch, or
:func:`build_all`, builds. Both are safe to call from several threads at
once (the serving daemon launches from its dispatcher thread): one lock
covers the check and the build, and each compile writes to a temporary
name that carries the process and the thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("conv3x3.cu", "keypoint.cu", "bias_bn_relu.cu", "lstm_cell.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("KPVID_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "kpvid_tpu_torch"


def nvcc() -> str:
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p for pattern in ("*.cuh", "*.h") for p in CSRC.glob(pattern))
    for path in (CSRC / source, *headers):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> float:
    """Compile every source whose library is not cached yet, one ``nvcc``
    per source, all started together. Returns the seconds it took; the
    compiler's output (register and shared-memory use per kernel) lands
    in :data:`build_log`. Raises if any compile fails."""
    with _lock:
        return _build_all(sources)


def _build_all(sources) -> float:
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        target = _target(src)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, target, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            target = _target(source)
            if not target.exists():
                _build_all((source,))
            lib = ctypes.CDLL(str(target))
            _libs[source] = lib
        return lib
