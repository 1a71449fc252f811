"""Build and load the package's CUDA kernels.

Each kernel library has a plain C interface. It is compiled on first use
with ``nvcc`` for ``sm_90a`` into a shared library under
``laryngeal_tpu_torch/_build/`` and loaded with ``ctypes``. A library is
named by its first source in ``laryngeal_tpu_torch/csrc/``; most have one
source, and those in ``MEMBERS`` have several, compiled to objects in
parallel and linked together (the window kernels: the held and wide designs
of ``window_attention.cu`` beside the wgmma design of
``window_attention_wgmma.cu``, whose launchers the former's C entries call;
the short kernels: ``short_attention.cu`` beside its f32 tensor-core
designs ``short_attention_tf32.cu`` and ``short_attention_tf32_mma.cu``;
the flash backward: ``flash_attention_bwd.cu`` beside its f32 tensor-core
design ``flash_attention_bwd_tf32.cu``; the tubelet embedding:
``tubelet_embed.cu`` beside its wgmma/TMA designs
``tubelet_embed_wgmma.cu``).
The library's name carries a hash of its sources and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. A file lock serialises concurrent builds (several processes,
or several libraries at once).
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# Libraries of more than one source, by library name (its first source).
MEMBERS: Dict[str, Tuple[str, ...]] = {
    "flash_attention_bwd.cu": ("flash_attention_bwd.cu", "flash_attention_bwd_tf32.cu"),
    "short_attention.cu": ("short_attention.cu", "short_attention_tf32.cu",
                           "short_attention_tf32_mma.cu"),
    "tubelet_embed.cu": ("tubelet_embed.cu", "tubelet_embed_wgmma.cu"),
    "window_attention.cu": ("window_attention.cu", "window_attention_wgmma.cu")}

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


def members(source: str) -> Tuple[str, ...]:
    """The sources of library ``source``."""
    return MEMBERS.get(source, (source,))


def library_sources() -> List[str]:
    """Every library's name: the sources in ``csrc/`` that are not a later
    member of another library."""
    later = {m for ms in MEMBERS.values() for m in ms[1:]}
    return sorted(p.name for p in CSRC_DIR.glob("*.cu") if p.name not in later)


def library_path(source: str) -> Path:
    """The library's path; its name hashes its sources, every shared header
    (``csrc/*.cuh``) and the flags."""
    content = b"".join((CSRC_DIR / m).read_bytes() for m in members(source))
    content += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _nvcc(args: List[str]) -> Tuple[str, subprocess.CompletedProcess]:
    cmd = [find_nvcc(), *args]
    return " ".join(cmd), subprocess.run(cmd, capture_output=True, text=True)


def _compile(source: str, out: Path) -> List[Tuple[str, subprocess.CompletedProcess]]:
    """nvcc runs of library ``source`` into ``out``: one for a single
    source; for several, each compiled to an object at once, then a link."""
    srcs = members(source)
    if len(srcs) == 1:
        return [_nvcc([*NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / source)])]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out.with_name(f"{out.name}.{Path(m).stem}.o") for m in srcs]
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        runs = list(pool.map(lambda mo: _nvcc([*flags, "-c", "-o", str(mo[1]),
                                               str(CSRC_DIR / mo[0])]), zip(srcs, objs)))
    if all(r.returncode == 0 for _, r in runs):
        runs.append(_nvcc(["-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                           str(out), *map(str, objs)]))
    for o in objs:
        o.unlink(missing_ok=True)
    return runs


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
            runs = _compile(source, tmp)
            text = "".join(f"{cmd}\n{proc.stdout}{proc.stderr}" for cmd, proc in runs)
            lib.with_suffix(".log").write_text(text)
            failed = [proc for _, proc in runs if proc.returncode != 0]
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for {source} (exit {failed[0].returncode}):\n{text}")
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
