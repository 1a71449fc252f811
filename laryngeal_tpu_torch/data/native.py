"""ctypes bindings of the native C++ clip decoder and wire encoder
(counterpart of ``laryngeal_tpu/data/native.py``).

The source is the port's own copy, ``laryngeal_tpu_torch/native/cliploader.cpp``.
At first use it is compiled with ``g++ -shared -fPIC -O3 -std=c++17 -Wall``
(and ``-march=native`` where the compiler takes it: the flags of the JAX
package's ``native/Makefile``, so the two builds round alike) against
``pkg-config --cflags --libs libavformat libavcodec libavutil libswscale``,
into ``laryngeal_tpu_torch/_build/libcliploader-<digest>.so``. The digest
covers the source, the flags, pkg-config's answer and the host CPU, so an
edited source is rebuilt and a library built for another CPU is never
loaded. A file lock serialises concurrent builds.

Where g++ or the libav development files are missing, or the build fails,
``available()`` is False, ``unavailable_reason()`` says why (the build's
failure is logged as a warning), and callers take the JAX package's
fallbacks: ``decode_frames_auto`` decodes with cv2, the dct encoder with
numpy (``preprocess/dct_wire.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "cliploader.cpp"
BUILD_DIR = PKG_DIR / "_build"
PKGS = ("libavformat", "libavcodec", "libavutil", "libswscale")
CXX_FLAGS = ("-shared", "-fPIC", "-O3", "-std=c++17", "-Wall")

_lock = threading.Lock()
_state = {"tried": False, "lib": None, "reason": None}
# Seconds the library took to build in this process (0.0 when it was found
# built), or None before the first load; read by chip_smoke.py.
build_seconds: Optional[float] = None


def _run(cmd, timeout=120) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)


def toolchain() -> Tuple[bool, str]:
    """(whether g++ and the libav development files are present, what was
    found or what is missing)."""
    cxx = shutil.which("g++")
    if cxx is None:
        return False, "g++ not found on PATH"
    if shutil.which("pkg-config") is None:
        return False, "pkg-config not found on PATH"
    probe = _run(["pkg-config", "--exists", *PKGS])
    if probe.returncode != 0:
        return False, f"pkg-config --exists {' '.join(PKGS)} failed (libav headers missing)"
    versions = _run(["pkg-config", "--modversion", *PKGS]).stdout.split()
    compiler = _run([cxx, "--version"]).stdout.splitlines()[:1]
    return True, f"{compiler[0] if compiler else cxx}; " + ", ".join(
        f"{p} {v}" for p, v in zip(PKGS, versions))


def _cpu_key() -> str:
    """The host CPU's model and feature flags (``-march=native`` builds for
    them)."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")) and line not in keep:
                    keep.append(line)
                if len(keep) == 2:
                    break
    except OSError:
        pass
    return "".join(keep) or f"{platform.machine()} {platform.processor()}"


def _compile_command(out: Path):
    flags = list(CXX_FLAGS)
    if _run(["g++", "-march=native", "-E", "-x", "c++", os.devnull]).returncode == 0:
        flags.append("-march=native")
    pkg = _run(["pkg-config", "--cflags", "--libs", *PKGS]).stdout.split()
    return ["g++", *flags, str(SOURCE), "-o", str(out), *pkg]


def library_path() -> Path:
    """The library's path; its name hashes the source, the compile command
    and the host CPU."""
    cmd = " ".join(_compile_command(Path("out"))).encode()
    digest = hashlib.sha1(SOURCE.read_bytes() + cmd + _cpu_key().encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcliploader-{digest}.so"


def build() -> Path:
    """Compile the library unless one of the current digest exists. Returns
    its path; raises RuntimeError with the compiler's output on failure."""
    global build_seconds
    lib = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libcliploader.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if lib.exists():
                build_seconds = 0.0
                return lib
            t0 = time.perf_counter()
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = _run(_compile_command(tmp), timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
            build_seconds = time.perf_counter() - t0
            return lib
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_u8, c_i8 = ctypes.c_int, ctypes.c_uint8, ctypes.c_int8
    p = ctypes.POINTER
    signatures = {
        "cliploader_abi": ([], c_int),
        "video_props": ([ctypes.c_char_p, p(c_int), p(ctypes.c_double), p(c_int), p(c_int)],
                        c_int),
        "clip_decode": ([ctypes.c_char_p, p(c_int), c_int, c_int, c_int, c_int, p(c_u8),
                         p(c_int)], c_int),
        "clip_decode_ex": ([ctypes.c_char_p, p(c_int), c_int, c_int, c_int, c_int, c_int,
                            p(c_u8), p(c_int)], c_int),
        "clip_encode_h264": ([ctypes.c_char_p, p(c_u8), c_int, c_int, c_int, ctypes.c_double,
                              c_int, ctypes.c_char_p], c_int),
        "clip_dct_encode": ([p(c_u8), c_int, c_int, c_int, c_int, p(ctypes.c_int16), p(c_i8)],
                            c_int),
        "clip_dct_encode_k": ([p(c_u8), c_int, c_int, c_int, c_int, c_int, p(ctypes.c_int16),
                               p(c_i8)], c_int),
        "ac_pack_nibble": ([p(c_i8), c_int, ctypes.c_longlong, p(c_u8)], c_int),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the library once per process; None, with
    ``unavailable_reason()`` set, when that cannot be done."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        ok, detail = toolchain()
        if not ok:
            _state["reason"] = detail
            logger.info("native cliploader not built: %s (decode falls back to cv2)", detail)
            return None
        try:
            _state["lib"] = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError, subprocess.TimeoutExpired, AttributeError) as e:
            _state["reason"] = f"build or load failed: {e}"
            logger.warning("native cliploader %s (decode falls back to cv2, the dct "
                           "encoder to numpy)", _state["reason"])
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is not loaded (None when it is)."""
    return None if available() else _state["reason"]


def _abi(lib) -> int:
    """Feature level of the loaded library (``cliploader_abi``): 2 carries
    the lowres level in ``clip_decode_ex``'s flags."""
    return int(lib.cliploader_abi())


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native cliploader unavailable: {_state['reason']}")
    return lib


def get_video_properties(path) -> Tuple[int, float, float, int, int]:
    """(total_frames, fps, duration, width, height) via libavformat."""
    lib = _require()
    total, fps = ctypes.c_int(), ctypes.c_double()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.video_props(str(path).encode(), ctypes.byref(total), ctypes.byref(fps),
                         ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"Could not open video ({rc}): {path}")
    f = fps.value if fps.value > 0 else 30.0
    return total.value, f, total.value / f, w.value, h.value


def decode_frames(path, indices: Sequence[int], resize_to: Optional[Tuple[int, int]] = None,
                  fmt: str = "rgb", fast: bool = False, lowres: int = 0) -> np.ndarray:
    """Decode ``indices`` natively. ``fmt`` 'rgb' -> (N, H, W, 3); 'i420' ->
    (N, H*3/2, W) packed planes (cv2's I420 layout; even H and W).

    ``fast`` skips the h264 in-loop deblocking filter (pixels drift a
    little; for the lossy wires). ``lowres=n`` (mpegvideo-family codecs:
    mpeg4, mjpeg; not h264) decodes at 1/2**n resolution, the decoder's own
    partial iDCT: without ``resize_to`` the output is the source's size
    divided by 2**n; ``resize_to`` is (w, h) in output coordinates. Raises on
    a codec without lowres."""
    lib = _require()
    lowres = int(lowres)
    if not 0 <= lowres <= 3:
        raise ValueError(f"lowres must be in [0,3], got {lowres}")
    if lowres and _abi(lib) < 2:
        raise RuntimeError("loaded library predates lowres support (abi < 2)")
    idx = sorted(int(i) for i in indices)
    if not idx:
        raise ValueError("decode_frames requires at least one index")
    if resize_to is not None:
        out_w, out_h = resize_to
    else:
        _, _, _, out_w, out_h = get_video_properties(path)
        out_w >>= lowres
        out_h >>= lowres
    if fmt == "i420" and (out_w % 2 or out_h % 2):
        raise ValueError("i420 output needs even dimensions")
    n = len(idx)
    if fmt == "i420":
        out = np.full((n, out_h * 3 // 2, out_w), 127, np.uint8)
        code = 1
    else:
        out = np.full((n, out_h, out_w, 3), 127, np.uint8)
        code = 0
    c_idx = (ctypes.c_int * n)(*idx)
    decoded = ctypes.c_int()
    out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if fast or lowres:
        flags = (1 if fast else 0) | (lowres << 1)
        rc = lib.clip_decode_ex(str(path).encode(), c_idx, n, out_w, out_h, code, flags,
                                out_ptr, ctypes.byref(decoded))
    else:
        rc = lib.clip_decode(str(path).encode(), c_idx, n, out_w, out_h, code, out_ptr,
                             ctypes.byref(decoded))
    if rc != 0:
        raise ValueError(f"native decode failed ({rc}): {path}")
    if decoded.value < n:
        logger.warning("native decode: %d/%d frames decoded for %s (the rest are gray "
                       "placeholders)", decoded.value, n, path)
    # The caller's order (a duplicate index maps to the first decoded copy,
    # which the C side fills identically).
    if list(indices) != idx:
        out = out[[idx.index(int(i)) for i in indices]]
    return out


def dct_encode(i420: np.ndarray, quality: int, keep_ac: int = 63):
    """Native dct wire encode: uint8 I420 clip (T, H*3/2, W) -> (dc int16
    (T, NB), ac int8 (keep_ac, T, NB)), the tables and rounding of
    ``preprocess.dct_wire.encode_clip_np``."""
    lib = _require()
    i420 = np.ascontiguousarray(i420, dtype=np.uint8)
    t, h15, w = i420.shape
    h = h15 * 2 // 3
    if h % 16 or w % 16:
        raise ValueError(f"DCT wire needs h, w multiples of 16, got {h}x{w}")
    nb = (h // 8) * (w // 8) + 2 * (h // 16) * (w // 16)
    keep_ac = int(keep_ac)
    if not 0 <= keep_ac <= 63:
        raise ValueError(f"keep_ac must be in [0,63], got {keep_ac}")
    dc = np.empty((t, nb), np.int16)
    ac = np.empty((keep_ac, t, nb), np.int8)
    rc = lib.clip_dct_encode_k(
        i420.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w, int(quality), keep_ac,
        dc.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ac.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if rc != 0:
        raise ValueError(f"native dct encode failed ({rc})")
    return dc, ac


def ac_pack(ac: np.ndarray) -> np.ndarray:
    """Nibble-pack AC planes (N, ...) int8 -> ((N+1)//2, ...) uint8, pairs of
    planes clamped to [-8, 7], the even plane in the low nibble (an odd last
    plane pairs with an implicit zero plane)."""
    lib = _require()
    ac = np.ascontiguousarray(ac, dtype=np.int8)
    nplanes = ac.shape[0]
    elems = int(np.prod(ac.shape[1:], dtype=np.int64))
    out = np.empty(((nplanes + 1) // 2,) + ac.shape[1:], np.uint8)
    rc = lib.ac_pack_nibble(ac.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), nplanes, elems,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"native ac_pack_nibble failed ({rc})")
    return out


def encoder_available() -> bool:
    """True when the library is loaded (``clip_encode_h264`` then exists;
    whether libavcodec has libx264 shows at the first encode)."""
    return available()


def encode_h264(path, frames_rgb: np.ndarray, fps: float = 30.0, crf: int = 23,
                preset: str = "veryfast") -> None:
    """Encode RGB uint8 (T, H, W, 3) to h264 in mp4 through libx264. Raises
    RuntimeError when the library or libx264 is missing."""
    lib = _require()
    frames = np.ascontiguousarray(frames_rgb, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T,H,W,3) RGB, got {frames.shape}")
    t, h, w, _ = frames.shape
    rc = lib.clip_encode_h264(str(path).encode(),
                              frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              t, w, h, float(fps), int(crf), preset.encode())
    if rc == 1:
        raise RuntimeError("libavcodec has no libx264 encoder on this host")
    if rc != 0:
        raise ValueError(f"native h264 encode failed ({rc}): {path}")


def decode_frames_auto(path, indices, resize_to=None, fmt: str = "rgb", fast: bool = False,
                       lowres: int = 0) -> np.ndarray:
    """The native decoder when it is loaded, else cv2. ``fast`` and
    ``lowres`` are native-only: cv2 decodes exactly at full resolution and
    then resizes to the geometry a lowres decode would have given."""
    from . import video as _video

    if available():
        try:
            return decode_frames(path, indices, resize_to, fmt, fast=fast, lowres=lowres)
        except (RuntimeError, ValueError) as e:
            logger.warning("native decode failed (%s); falling back to cv2", e)
    if lowres and resize_to is None:
        _, _, _, w, h = (get_video_properties(path) if available()
                         else _video.get_video_properties(path))
        resize_to = (w >> lowres, h >> lowres)
    rgb = _video.decode_frames(path, indices, resize_to=resize_to)
    if fmt == "i420":
        return _video.rgb_to_yuv420(rgb)
    return rgb
