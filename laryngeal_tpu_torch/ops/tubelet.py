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
  rounded once. Kernel 10 takes every shape, as the TPU kernel does: kw·C
  in ``RUN_LENGTHS`` with W·C and D multiples of 8 (ViViT-B's stem) runs
  its run-length instance (``mma.sync`` in bf16), every other shape its
  general path (the FMA units, scalar loads); ``last_design`` reports which
  ran. The TPU kernel has no VJP, so this route raises ``RuntimeError``
  when autograd would need a gradient, on both devices.

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
DESIGNS = ("fma", "mma.sync", "general")
# Kernel launches since the count was last set to 0 (plain CPU calls do not
# count); ``chip_smoke.py`` reads it to prove the path used the kernel.
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


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


def kernel_takes(video, kernel, tubelet=(2, 16, 16)) -> bool:
    """Whether kernel 10 takes this shape: every shape that fits the tubelet,
    as the TPU kernel takes any (it pads M)."""
    return _shape_problem(video, kernel, tubelet) is None


def last_design() -> Optional[str]:
    """The design (``DESIGNS``) of kernel 10's last launch in this process,
    as the C side chose it; None before the first."""
    fn = _build.load(SOURCE).tubelet_embed_last_design
    fn.restype, fn.argtypes = ctypes.c_int, []
    code = fn()
    return DESIGNS[code] if code >= 0 else None


def tubelet_embed_cuda(video, kernel, bias, tubelet=(2, 16, 16)) -> torch.Tensor:
    """Kernel 10 on CUDA tensors: (B, N, D) in the video's dtype, float32 or
    bfloat16, at every shape; raises if it cannot launch."""
    global launches, _fn
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
    if _fn is None:
        fn = _build.load(SOURCE).tubelet_embed
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        _fn = fn
    with torch.cuda.device(video.device):
        err = _fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                  _DTYPE_CODE[video.dtype], b, t, h, w, c, kt, kh, kw, d,
                  torch.cuda.current_stream(video.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tubelet_embed launch failed: cudaError {err}")
    launches += 1
    return out


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
