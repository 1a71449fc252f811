"""Build and load the package's CUDA kernels.

Each kernel source in ``laryngeal_tpu_torch/csrc/`` has a plain C interface.
It is compiled on first use with ``nvcc`` for ``sm_90a`` into a shared
library under ``laryngeal_tpu_torch/_build/`` and loaded with ``ctypes``.
The library's name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. A file lock serialises
concurrent builds (several processes, or several sources at once).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# Seconds each library took to build in this process (0.0 when it was found
# already built); read by chip_smoke.py.
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA toolkit is needed to build the package's kernels")


def library_path(source: str) -> Path:
    """The library's path; its name hashes the source, every shared header
    (``csrc/*.cuh``) and the flags."""
    src = CSRC_DIR / source
    content = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of its current content
    exists. Returns the library path; raises with nvcc's output on failure."""
    lib = library_path(source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{Path(source).stem}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if lib.exists():
                build_seconds.setdefault(source, 0.0)
                return lib
            t0 = time.perf_counter()
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = lib.with_suffix(".log")
            log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for {source} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
            build_seconds[source] = time.perf_counter() - t0
            return lib
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def build_log(source: str) -> Optional[str]:
    """nvcc's output (ptxas register / shared-memory report) of the last
    build of ``source``, or None if it was not built here."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one handle per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
