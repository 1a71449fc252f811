"""Tubelet embedding: patch-matmul forms of the ViViT stem, and kernel 10.

Counterpart of ``laryngeal_tpu/ops/tubelet.py``. A conv3d whose kernel
equals its stride (the tubelet, (2, 16, 16)) is a gather of
non-overlapping patches and one (B·N, kt·kh·kw·C) x (kt·kh·kw·C, D)
product. Three routes, picked by ``tubelet_embed(impl=...)`` or
``LARYNGEAL_TUBELET_IMPL`` (default ``conv``), as in the JAX package:

- ``conv``: ``F.conv3d`` (cuDNN on the card), the bias added in the output
  dtype, as the JAX conv adds it (``:69``);
- ``matmul``: ``extract_tubelets`` and one ``torch.matmul`` accumulated in
  f32, the bias added in f32 (``:56-60``; JAX's XLA route);
- ``kernel`` (the JAX package's ``pallas``, accepted as an alias): kernel
  10, ``tubelet_embed_kernel``. It replaces ``_matmul_kernel`` (``:73``,
  launched at ``:94``) with ``csrc/tubelet_embed.cu``, which reads the
  video directly instead of a materialised patch matrix. On a CPU tensor it
  runs its plain twin ``tubelet_embed_plain``, which rounds where the TPU
  kernel rounds: the weight and the bias are cast to the video's dtype, the
  product is accumulated in f32, the bias added in f32 and the output
  rounded once. Kernel 10 takes every shape, as the TPU kernel does; the C
  side picks its design (``c_design``; ``design_takes`` mirrors it) and
  ``last_design`` reports which ran. kw·C in ``RUN_LENGTHS`` with W·C and
  D multiples of 8 (ViViT-B's stem) runs the wgmma/TMA designs of
  ``csrc/tubelet_embed_wgmma.cu``: ``wgmma`` in bf16, ``wgmma.tf32x3`` in
  f32 (TF32 operands split into big and small parts, three products a
  product, each K-step's products added to an f32 sum on the FMA units):
  persistent blocks, the video's patch runs read by TMA as boxes of a 5-D
  tensor map (an h'-row of patches a 16-row slot of the tile) and shared by
  multicast among the blocks of a cluster that compute one row tile's
  column tiles, W transposed (and split) once a call into scratch the
  wrapper allocates (``scratch_bytes``) and loaded by TMA. ``tubelet_embed_mma_cuda`` runs the
  earlier run-length instances there (``mma.sync`` in bf16, ``fma`` in
  f32), to time the new designs against; every other shape runs the
  general path (the FMA units, scalar loads). The TPU kernel has no VJP, so this route raises
  ``RuntimeError`` when autograd would need a gradient, on both devices.

All take channels-last video (B, T, H, W, C) and the Flax kernel layout
(kt, kh, kw, C, D) with a (D,) bias; ``kernel_from_conv3d`` turns a
``nn.Conv3d`` weight (D, C, kt, kh, kw) into that layout. Tokens are
ordered t-major, then h, then w (HF ``flatten(2)``). The port's ViViT keeps
its own ``nn.Conv3d`` stem, as the JAX ViViT keeps ``nn.Conv``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

SOURCE = "tubelet_embed.cu"
# Patch-row lengths kw·C of the run-length instances (their K-step); every
# other shape takes the general path.
RUN_LENGTHS = (16, 32, 48, 64)
# Designs of kernel 10, by the code ``tubelet_embed_last_design`` returns.
DESIGNS = ("fma", "mma.sync", "general", "wgmma", "wgmma.tf32x3")
# Kernel launches since the count was last set to 0 (plain CPU calls do not
# count); ``chip_smoke.py`` reads it to prove the path used the kernel.
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns: Dict[str, Callable] = {}


def reset_launches() -> None:
    global launches
    launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of kernel 10, by its CUDA entry name."""
    return {"tubelet_embed": launches}


def extract_tubelets(video: torch.Tensor, tubelet: Tuple[int, int, int]) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, N, kt·kh·kw·C) patch matrix, token order
    t-major, then h, then w."""
    b, t, h, w, c = video.shape
    kt, kh, kw = tubelet
    x = video.reshape(b, t // kt, kt, h // kh, kh, w // kw, kw, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)  # (B, T', H', W', kt, kh, kw, C)
    return x.reshape(b, (t // kt) * (h // kh) * (w // kw), kt * kh * kw * c)


def flatten_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Flax conv kernel (kt, kh, kw, C, D) -> matmul weight (kt·kh·kw·C, D)."""
    kt, kh, kw, c, d = kernel.shape
    return kernel.reshape(kt * kh * kw * c, d)


def kernel_from_conv3d(weight: torch.Tensor) -> torch.Tensor:
    """``nn.Conv3d`` weight (D, C, kt, kh, kw) -> Flax layout (kt, kh, kw, C, D)."""
    return weight.permute(2, 3, 4, 1, 0)


def tubelet_embed_conv(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    w = kernel.to(video.dtype).permute(4, 3, 0, 1, 2)
    out = F.conv3d(video.permute(0, 4, 1, 2, 3), w, stride=tuple(tubelet))
    out = out + bias.to(out.dtype)[:, None, None, None]
    return out.flatten(2).transpose(1, 2)


def tubelet_embed_matmul(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    patches = extract_tubelets(video, tubelet)
    w = flatten_kernel(kernel).to(patches.dtype)
    out = torch.matmul(patches.float(), w.float())
    return (out + bias.float()).to(video.dtype)


def tubelet_embed_plain(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    """Kernel 10's function in plain PyTorch: ``tubelet_embed_matmul`` with
    the bias rounded to the video's dtype first (``:105``)."""
    return tubelet_embed_matmul(video, kernel, bias.to(video.dtype), tubelet)


def error_limit(video, kernel, ref, tubelet=(2, 16, 16)) -> torch.Tensor:
    """Elementwise limit on |kernel 10 - tubelet_embed_plain| for the on-card
    checks. With A = sum_k |x_k·w_k| (f32): the summation order, 1e-5·A
    (the worst case is 1536·2^-24·A ~ 9e-5·A; a random walk gives ~2e-6·A);
    bf16 adds one ulp of the output, 2^-7·|ref|, since both sides round an
    f32 value to bf16 and two nearly equal values can round to neighbours.
    1e-6 absolute keeps exact zeros from dividing by zero."""
    a = torch.matmul(extract_tubelets(video.float().abs(), tubelet),
                     flatten_kernel(kernel.to(video.dtype)).float().abs())
    out_rel = 0.0 if video.dtype == torch.float32 else 2.0 ** -7
    return 1e-5 * a + out_rel * ref.float().abs() + 1e-6


def _shape_problem(video, kernel, tubelet) -> Optional[str]:
    """Why video and kernel do not fit the tubelet, or None if they do."""
    if video.ndim != 5 or kernel.ndim != 5:
        return "tubelet_embed expects video (B, T, H, W, C) and kernel (kt, kh, kw, C, D)"
    _, t, h, w, c = video.shape
    kt, kh, kw = tubelet
    if tuple(kernel.shape[:4]) != (kt, kh, kw, c):
        return (f"kernel {tuple(kernel.shape)} does not match tubelet {tuple(tubelet)} and "
                f"{c} channels")
    if t % kt or h % kh or w % kw:
        return f"video {tuple(video.shape)} is not a whole number of {tuple(tubelet)} tubelets"
    return None


def _check(video, kernel, bias, tubelet):
    problem = _shape_problem(video, kernel, tubelet)
    if problem is None and (bias.ndim != 1 or bias.shape[0] != kernel.shape[4]):
        problem = f"bias {tuple(bias.shape)} is not (D,) = ({kernel.shape[4]},)"
    if problem:
        raise ValueError(problem)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def run_length_takes(video, kernel, tubelet=(2, 16, 16)) -> bool:
    """Whether a run-length instance of kernel 10 takes this shape: kw·C in
    ``RUN_LENGTHS``, W·C and D multiples of 8 (else its general path runs)."""
    c, w, d = video.shape[-1], video.shape[-2], kernel.shape[-1]
    return tubelet[2] * c in RUN_LENGTHS and (w * c) % 8 == 0 and d % 8 == 0


def design_takes(video_shape, d: int, tubelet=(2, 16, 16), dtype=torch.bfloat16) -> str:
    """The design (``DESIGNS``) kernel 10 runs for a video of ``video_shape``
    (B, T, H, W, C), ``d`` outputs and ``tubelet`` in ``dtype``: a mirror of
    the C entry's choice (``tubelet_embed_design``, which ``c_design`` asks)
    for the CPU tests and the checks that name the design a shape should
    run. ``wgmma`` (bf16) or ``wgmma.tf32x3`` (f32) at the run-length shapes,
    ``general`` elsewhere (``tubelet_embed_mma_cuda`` runs ``mma.sync`` or
    ``fma`` where these run)."""
    c, w = video_shape[-1], video_shape[-2]
    if not (tubelet[2] * c in RUN_LENGTHS and (w * c) % 8 == 0 and d % 8 == 0):
        return "general"
    return "wgmma" if dtype == torch.bfloat16 else "wgmma.tf32x3"


def _c_fn(name: str, restype, argtypes):
    if name not in _fns:
        fn = getattr(_build.load(SOURCE), name)
        fn.restype, fn.argtypes = restype, argtypes
        _fns[name] = fn
    return _fns[name]


def c_design(video_shape, d: int, tubelet=(2, 16, 16), dtype=torch.bfloat16,
             mma_only: bool = False) -> str:
    """The design (``DESIGNS``) the C entry (``tubelet_embed``, or
    ``tubelet_embed_mma`` with ``mma_only``) runs for this call. Needs the
    built library."""
    fn = _c_fn("tubelet_embed_design", ctypes.c_int, [ctypes.c_int] * 8)
    code = fn(_DTYPE_CODE[dtype], video_shape[-2], video_shape[-1], *tubelet, d, int(mma_only))
    if code < 0:
        raise ValueError(f"tubelet_embed_design refuses {tuple(video_shape)}, D = {d}, "
                         f"{tuple(tubelet)}, {dtype}")
    return DESIGNS[code]


def scratch_bytes(video_shape, d: int, tubelet=(2, 16, 16), dtype=torch.bfloat16) -> int:
    """Bytes of scratch the C entry needs for this call (W transposed, and in
    f32 split, by the wgmma designs' pre-pass; 0 for the other designs), as
    the C side sizes it (``tubelet_embed_scratch_bytes``). Needs the built
    library."""
    fn = _c_fn("tubelet_embed_scratch_bytes", ctypes.c_longlong, [ctypes.c_int] * 7)
    n = fn(_DTYPE_CODE[dtype], video_shape[-2], video_shape[-1], *tubelet, d)
    if n < 0:
        raise ValueError(f"tubelet_embed_scratch_bytes refuses {tuple(video_shape)}, D = {d}")
    return n


def kernel_takes(video, kernel, tubelet=(2, 16, 16)) -> bool:
    """Whether kernel 10 takes this shape: every shape that fits the tubelet,
    as the TPU kernel takes any (it pads M)."""
    return _shape_problem(video, kernel, tubelet) is None


def last_design() -> Optional[str]:
    """The design (``DESIGNS``) of kernel 10's last launch in this process,
    as the C side chose it; None before the first."""
    code = _c_fn("tubelet_embed_last_design", ctypes.c_int, [])()
    return DESIGNS[code] if code >= 0 else None


def _launch(video, kernel, bias, tubelet, entry: str) -> torch.Tensor:
    """One launch of C entry ``entry`` (``tubelet_embed`` or
    ``tubelet_embed_mma``) on CUDA tensors; raises if it cannot launch."""
    _check(video, kernel, bias, tubelet)
    if not (video.is_cuda and kernel.is_cuda and bias.is_cuda):
        raise ValueError("tubelet_embed_cuda needs CUDA tensors")
    if video.dtype not in _DTYPE_CODE:
        raise ValueError(f"tubelet_embed_cuda supports float32 and bfloat16, got {video.dtype}")
    b, t, h, w, c = video.shape
    kt, kh, kw = tubelet
    d = kernel.shape[4]
    x = _aligned(video)
    wk = _aligned(flatten_kernel(kernel).to(video.dtype))
    bk = _aligned(bias.to(video.dtype))
    n = (t // kt) * (h // kh) * (w // kw)
    out = torch.empty((b, n, d), dtype=video.dtype, device=video.device)
    if b * n == 0:
        return out
    fn = _c_fn(entry, ctypes.c_int, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
               + [ctypes.c_void_p])
    with torch.cuda.device(video.device):
        nbytes = 0 if entry != "tubelet_embed" else scratch_bytes(video.shape, d, tubelet,
                                                                   video.dtype)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=video.device)
        err = fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                 scratch.data_ptr() if nbytes else None, _DTYPE_CODE[video.dtype], b, t, h, w,
                 c, kt, kh, kw, d, torch.cuda.current_stream(video.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def tubelet_embed_cuda(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    """Kernel 10 on CUDA tensors: (B, N, D) in the video's dtype, float32 or
    bfloat16, at every shape, in the design the C side picks; raises if it
    cannot launch (the wgmma designs' failures included: there is no
    fallback)."""
    global launches
    out = _launch(video, kernel, bias, tubelet, "tubelet_embed")
    launches += 1
    return out


def tubelet_embed_mma_cuda(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    """Kernel 10 with the earlier run-length instances (``mma.sync`` in bf16,
    ``fma`` in f32) wherever the wgmma designs would run (their yardstick),
    on CUDA tensors; counts no launch, raises if it cannot launch."""
    return _launch(video, kernel, bias, tubelet, "tubelet_embed_mma")


def tubelet_embed_kernel(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    """Kernel 10 on CUDA tensors, its plain twin on CPU tensors. Raises
    ``RuntimeError`` where autograd would need a gradient: the TPU kernel
    has none."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (video, kernel, bias)):
        raise RuntimeError(
            "tubelet_embed impl 'kernel' (kernel 10) has no gradient, as the JAX "
            "package's Pallas route has none; use impl 'conv' or 'matmul' to train")
    if video.is_cuda:
        return tubelet_embed_cuda(video, kernel, bias, tubelet)
    if video.device.type != "cpu":
        raise ValueError(f"tubelet_embed runs on CUDA or CPU, got {video.device}")
    _check(video, kernel, bias, tubelet)
    return tubelet_embed_plain(video, kernel, bias, tubelet)


IMPLS: Dict[str, Callable] = {
    "conv": tubelet_embed_conv,
    "matmul": tubelet_embed_matmul,
    "kernel": tubelet_embed_kernel,
}
# The JAX package's name for the kernel route, so one setting of
# LARYNGEAL_TUBELET_IMPL picks the same route in both packages.
ALIASES = {"pallas": "kernel"}


def tubelet_embed(video, kernel, bias, tubelet=(2, 16, 16),
                  impl: Optional[str] = None) -> torch.Tensor:
    impl = impl or os.environ.get("LARYNGEAL_TUBELET_IMPL", "conv")
    impl = ALIASES.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(f"Unknown tubelet impl {impl!r}")
    return IMPLS[impl](video, kernel, bias, tubelet)
