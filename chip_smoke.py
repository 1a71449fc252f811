"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. Print the card's name and power limit; build every kernel library in
   ``laryngeal_tpu_torch/csrc/`` (one nvcc per source, all at once; the window
   library links two).
2. Hold the flash-attention forward, kernels 1 and 2, in both designs of
   each dtype (bf16: wgmma, and the earlier mma.sync one; f32: wgmma.tf32x3,
   the tensor cores on TF32 operands split in two parts, and the FMA kernel;
   the earlier ones through ``flash_attention_mma_cuda`` /
   ``flash_attention_lse_mma_cuda``) against the plain PyTorch version over
   phase 2b's cases (the ViViT-B shape B=8, N=3137, H=12, D=64; N=300 with
   kv_valid; Nq != Nk both ways; D = 32, 40, 128; fused-qkv and (B, H, N, D)
   views), lse within ``LSE_TOL``, in both dtypes, each bitwise the same
   on a second call and on the design the C side must choose (f32:
   wgmma.tf32x3 at D <= 64, FMA at 128); print the design each case ran and
   the ptxas report of the wgmma instances; time at the ViViT-B shape, in
   bf16 and f32, the entries' design and the earlier one in turns and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   single calls and queued, beside the plain version and the bound (f32:
   3xTF32 at the TF32 peak; the FMA design's bound and that of a bf16x3
   split, which no kernel runs, logged beside it), and name sdpa's kernels
   (torch.profiler).
3. The main path at full width: a ViViT-B/16x2 32-frame 224^2 Predictor on
   the card in bf16, weights from a seeded torch.Generator, fed a
   (8, 32, 224, 224, 3) uint8 batch. Probabilities are finite and sum to 1,
   the kernel launches 12 times per forward, and the logits match the same
   model with the plain attention (f32 logits). The same weights in f32, the
   compute dtype a checkpoint gets when its metadata names none, go through
   a Predictor once more on two clips and are held to the plain attention
   too; then the f32 forward at B=8 is timed (kernel 1 on wgmma.tf32x3, its
   share of the forward).
4. Serving: an InferenceServer on port 0 around that predictor answers
   /healthz and /stats and resolves clips submitted from threads.
2b. (run after 2) Kernels 2-4, the training path's: the lse forward and the
   dQ and dK/dV backward against their plain twins (``attention_plain_lse``,
   ``attention_plain_bwd``) at the ViViT-B shape in bf16 and f32, at N=300
   with kv_valid (masked keys' dK/dV exactly 0), at Nq < Nk and Nq > Nk, at
   D = 32, 40 (padded to 48) and 128, and on views of a fused qkv and of a
   (B, H, N, D) layout, each under its elementwise limit; kernels 3-4 in
   the design the entries run (bf16: wgmma; f32: wgmma.tf32x3 at D <= 64,
   FMA at 128), bitwise the same on a second call, and in the earlier one
   (``flash_attention_*_mma_cuda``: mma.sync in bf16, FMA in f32). The
   ptxas report of the wgmma and tf32 instances is printed. Timed at the
   ViViT-B shape beside the plain versions, their bounds (f32 kernels 3-4:
   3xTF32 at the TF32 peak, the FMA design's bound logged) and
   ``F.scaled_dot_product_attention``'s forward and autograd backward (its
   kernels named); kernels 2-4 also beside their earlier design in turns,
   single calls and queued, and sdpa both ways.
5. Training at full width: ViViT-B/16x2 32f 224^2, B=8, bf16 compute, seeded
   weights, through ``make_train_step`` on a uint8 batch: 12 launches each
   of kernels 2-4 and none of kernel 1 per step, 12 of kernel 1 and none of
   2-4 per eval step; loss finite; step time, clips/s, peak memory and the
   time of each stage. The f32 train step at B=8 (kernels 2-4 on
   wgmma.tf32x3): the median of 3 after a warm-up and kernels 2-4's
   shares. Then every parameter's gradient at B=2, with the kernels against
   the same model on the plain attention, f32 and bf16.
6. The training CLI at full width: ``cli.main --model vivit --bf16`` on a
   small synthetic dataset in a temporary directory, 1 epoch, then
   ``--resume auto`` for a second; best_model/, latest/,
   training_history.json and test_metrics_uniform.json exist;
   ``Predictor.from_checkpoint`` serves best_model/ in f32 through kernel 1.
   The directory is deleted at the end.
7. (run after 2b) Kernels 6-7, TimeSformer's short-sequence attention: the
   forward and the backward against their plain twins
   (``short_attention_plain``, ``short_attention_plain_bwd``) at the two
   TimeSformer-B shapes (temporal (1568, 32, 12, 64), spatial
   (256, 197, 12, 64), views of a fused qkv) in bf16 and f32, and at N from
   1 to 511 with D from 16 to 128 and odd B*H (kernel 7's wgmma edges, N =
   65, 128, 129, 192, 256 at D = 64 and N = 197 at D = 32, on fused-qkv
   views and on transposed (B, H, N, D) ones), each under its elementwise
   limit; in f32 also the edges of the f32 designs, wgmma.tf32x3 (N = 65,
   128, 129, 192, 197, 200, 256 at D = 32, 40, 64) and mma.tf32x3 (N = 1, 2,
   7, 8, 16, 31, 32, 33, 63, 64 at D = 16, 32, 40, 64), fused and
   transposed; the
   earlier designs (``short_attention_fwd_mma``, ``short_attention_bwd_mma``:
   mma.sync in bf16, FMA in f32) under the same limits at every case, and
   the design each entry ran (``short_attention.last_designs``) printed and
   held to ``short_attention.design_takes``. The ptxas report of kernels
   6-7's wgmma and tf32 instances is printed. Timed beside the plain twins,
   their bounds (f32 on wgmma.tf32x3 and mma.tf32x3: 3xTF32 at the TF32 peak
   against the bytes; the FMA and bf16x3 bounds in the log) and
   ``F.scaled_dot_product_attention``'s
   forward and autograd backward (single calls and queued); each kernel
   also beside its earlier design in turns (old, new, new, old), single
   calls and queued (20 calls back to back: the card's time without the
   wrapper's host-side launch).
7b. The routing decision's data: kernel 1, and the flash training pair
   (kernel 2; delta and kernels 3-4), timed at the same two shapes.
8. TimeSformer-B serving at full width: a 32-frame 224^2 Predictor in bf16,
   seeded weights, a (8, 32, 224, 224, 3) uint8 batch: probabilities finite
   and summing to 1, exactly 24 launches of kernel 6 and none of kernels 1-4
   per forward, logits against the same model on the plain attention in
   bf16 and (two clips) f32; an InferenceServer round trip.
9. TimeSformer-B training at full width, B=8, bf16 compute: 24 launches
   each of kernels 6 and 7 and none of kernels 1-4 per step (of kernel 7,
   the 12 spatial calls on its wgmma design and the 12 temporal ones on
   mma.sync), 24 of kernel 6 per eval step; loss finite; step time, clips/s, stages, peak memory. Then
   in f32 (the CLI's default compute dtype) at B=8: the forward (median of
   5) with its logits against the same model on the plain attention, and
   the train step (median of 3 after a warm-up), each with kernels 6-7's
   launches by design (the 12 spatial calls on wgmma.tf32x3, the 12
   temporal ones on mma.tf32x3) and their share from phase 7's f32 times, peak
   memory. Then every parameter's gradient at B=2, kernels against plain
   attention, f32 and bf16.
10. ``cli.main --model timesformer --bf16``: 1 epoch, ``--resume auto`` for
   a second, ``Predictor.from_checkpoint("timesformer", best_model)``.
11. (run after 7) Kernels 8-9, Swin3D's shifted-window attention: the
   forward and the backward (dq, dk, dv and the cross-window dbias) against
   their plain twins, in both designs of each dtype (the entries' wgmma one
   in bf16 and wgmma.tf32x3 in f32, and the kept mma.sync / FMA ones,
   ``window_attention_*_mma_cuda``), at the four Swin3D-T
   32f 224^2 B=8 stage shapes (N = 392, D = 32; 1024/256/64/16 windows,
   3/6/12/24 heads), shifted (the model's own region ids) and unshifted, at
   the wgmma design's edges (N = 8, 56, 200, 392 with one id row, 448 at
   D = 32, N = 392 at D = 64; on fused-qkv and on transposed (B·nW, H, N, D)
   views), at other held shapes (N % 8 != 0, D 64 and 128) and at four
   shapes of the wide path (N = 512 and 784 at D = 32, N = 392 at D = 192
   and 256), bf16 and f32, each under its elementwise limit, bitwise the
   same on a second call, and in the design ``design_takes`` names (wgmma,
   and wgmma.tf32x3 in f32, at every stage shape). The ptxas report of the
   wgmma and tf32 instances is printed. Timed at each stage in both dtypes
   beside the bound (f32: 3xTF32 at the TF32 peak; the FMA design's bound
   and a bf16x3 split's in the log), the exponential floor, the twins and
   ``F.scaled_dot_product_attention`` with the materialised (B·nW, H, N, N)
   bias (forward, and backward with the mask's gradient), single calls and
   queued, both designs in turns; the backward's per-launch split.
11b. Kernels 11-12, the ablation variants of kernel 8 (the counterpart of
   ``scripts/bench_window_kernel.py``): bf16 and exp2 softmaxes, 2-3 heads
   a block, at the four stage shapes; the launch counts (and kernel 12's
   by design) are set to 0 around the ablation; then each is held against
   its twin and timed beside kernel 8. Kernel 11 runs kernel 8's wgmma
   design (its softmax mode a template parameter), kernel 12 its own (the
   bias streamed by TMA); each is checked in the design ``design_takes``
   names, bitwise repeatable, with the held mma.sync design under the same
   limit and the two timed in turns beside sdpa; their ptxas reports.
12. Swin3D-T serving at full width and depth: a 32-frame 224^2 Predictor in
   bf16, seeded weights, a (8, 32, 224, 224, 3) uint8 batch: probabilities
   finite and summing to 1, exactly 12 launches of kernel 8, all on its
   wgmma design, and none of any other kernel per forward, logits against
   the same model on the plain attention in bf16 and (two clips) f32; an
   InferenceServer round trip.
13. Swin3D-T training, B=8, bf16 compute, the pytorchvideo augmentation and
   stochastic depth 0.1 on: 12 launches each of kernels 8 and 9 per step, all
   on their wgmma design, and none of any other kernel, 12 of kernel 8 per
   eval step; loss finite; step
   time, clips/s, stages, peak memory. Then in f32 (the CLI's default
   compute dtype) the forward at B=8 (median of 5) and the train step at
   B=8 (median of 3 after a warm-up), kernels 8-9 all on wgmma.tf32x3, with
   their share from phase 11's f32 times. Then every parameter's gradient at
   B=2 (every relative-position table included), kernels against plain
   attention, f32 and bf16.
14. ``cli.main --model swin3d --model_size tiny --bf16``: 1 epoch (no early
   stopping), ``--resume auto`` for a second, and
   ``Predictor.from_checkpoint("swin3d", best_model)`` in f32.
15. Kernel 10, the tubelet embedding: against ``tubelet_embed_plain`` at the
   ViViT-B stem shape (video (8, 32, 224, 224, 3), D = 768), an M tail,
   D = 48, and four shapes of the general path (kw*C = 24 and 42, D = 100,
   an odd W*C), bf16 and f32, under ``tubelet.error_limit`` and in the
   design ``tubelet.design_takes`` names (wgmma, wgmma.tf32x3 at the
   run-length shapes), bitwise repeatable; at the stem shape the new design
   and the earlier one (``tubelet_embed_mma_cuda``) timed in turns, single
   calls and queued, beside cuDNN's conv3d and extract_tubelets + addmm,
   and the new design's ptxas report. Then the path: the port's vivit
   preprocessing of a uint8 batch, ``tubelet_embed(impl="kernel")`` with the
   seeded ViViT-B model's own projection weights, held against the model's
   conv3d stem; one launch of kernel 10 and none of any other kernel.
16. Kernel 5, the biased flash forward, in both designs of each dtype
   (bf16: wgmma, f32: wgmma.tf32x3, each against the mma.sync / FMA
   template of its _mma entry): against ``attention_plain_bias`` at the
   ViViT-B shape with a (1, 12, N, N) per-head and an (8, 1, 1, N)
   key-padding bias, at N = 300 with kv_valid and at Nq != Nk, bf16 and f32,
   in the design ``forward_design`` names, bitwise repeatable; both designs
   timed in turns beside the twin and
   ``F.scaled_dot_product_attention(attn_mask=)``; the ptxas report of the
   biased instances.
   Then the path: ViViT-B's first TransformerBlock on the model's embeddings
   of the batch with each bias, bf16 and f32, against plain attention (one
   launch of kernel 5 a call, no other kernel); every gradient and dbias at
   B=2 against plain attention; one forward + backward + AdamW step of the
   block at B=8 timed, with its peak memory.

17. 3D-ResNet50 (slow_r50) at full width and depth, 32f 224^2, seeded
   weights; no kernel of the table lies on its path (cuDNN convolutions), so
   every launch count must read 0 across the phase. Serving:
   ``Predictor.predict_clip`` on a (8, 32, 224, 224, 3) uint8 batch in f32
   (the CLI's default) and bf16, probabilities finite and summing to 1; the
   f32 eval logits against the same weights in float64 on the card (B=1)
   within 1e-4 x max(1, max |logit|) with TF32 off, the bf16 logits against
   the f32 ones within 3e-2 x max(1, max |logit|); the forward's time and
   clips/s with cuDNN's TF32 off and on (on is torch's default, which the
   CLI runs with; this script turns both TF32 flags off at its start), the
   TF32 logits' deviation from float64 printed, not held. The train step at
   B=8 in f32 (Adam, CE, the pytorchvideo augmentation, dropout on): loss
   finite, the last BatchNorm's running statistics moved by the biased rule
   (recomputed on the host from its captured input, and told apart from
   torch's unbiased one), the step's time, clips/s and peak memory with
   cuDNN's TF32 off and on, its device time by kernel (torch.profiler) with
   it on. Then ``cli.main --model resnet3d`` for one epoch on 8 / 4 / 4
   synthetic videos and ``Predictor.from_checkpoint`` on its best_model/.
18. ResNet50-2D + LSTM(256, 2 layers) the same way, with BCE and pos_weight
   and the trunk frozen in the train step: every trunk parameter bitwise
   unchanged while its BN statistics moved, every LSTM and classifier
   parameter moved.

19. Remat: ViViT-B, TimeSformer-B and Swin3D-T (stochastic depth 0.1, the
   step's generators from the same seed) at full width, 32f 224^2, B=8, f32
   (TF32 off, as set at the start): one train step with ``remat=True`` and one
   without, from the same weights and batch; loss and every gradient held
   to each other within the f32 limits of the gradient checks; every kernel,
   the forward kernels 2, 6 and 8 included, launching as often each way;
   the step time and ``torch.cuda.max_memory_allocated()`` each way.
20. Gradient accumulation: ViViT-B f32 B=8 at ``grad_accum=2`` against
   phase 19's step at 1 (gradients within the f32 limits, one optimizer
   update, peak memory both ways); slow_r50 f32 B=8 at ``grad_accum=2``,
   its running statistics against two train-mode forwards over the strided
   micro-batches in order, recomputed here.
21. TimeSformer-B ``layout="nt"`` against the flat layout on the same
   weights: the B=8 forward's logits in f32 (1e-4) and bf16 (3e-2, times
   max(1, max |logit|)), forward times both ways, kernel 6 launching 12
   times per nt forward; the nt f32 train step (kernels 6-7, 12 each) against
   phase 19's flat one: gradients, time and peak memory.
22. ``cli.main --model vivit --num_layers 2`` (f32) with ``--grad_accum_steps
   2 --remat --torch_weights <a .pth it writes> --clip_cache_dir
   --profile_dir``: the weights load, the cache holds every clip and a
   second pass decodes nothing, the trace names kernels 2-4's CUDA symbols.

The kernel checks (2, 2b, 7, 11, 11b, 15, 16) run first, then the paths. The
launch counts are set to 0 before each path (ViViT serving 3-4, ViViT
training 5-6, TimeSformer serving 8, TimeSformer training 9-10, Swin3D
serving 12, Swin3D training 13-14, the ablation of 11b, the ViViT-B stem of
15, the biased block of 16, the CNN families of 17 and 18, and phases 19,
20, 21 and 22) and read after it; each of phases 19-22 must launch every
kernel of its path. Each phase
prints its time. The second-to-last line of output is ``{"kernels": [...]}``;
the last is ``{"ok": true, "device": {...}}``. Decode is skipped in 3-5, 8-9,
12-13, 15-16 and the serving and train steps of 17-18 (clips are uint8
arrays); phases 6, 10, 14 and the CLI runs of 17-18 decode mp4s.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet) at the 700 W power limit: bf16
# tensor cores, f32 on the FMA units; TF32 tensor cores (PEAK_TF32).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES_PER_S = 3.35e12
VIVIT_B = dict(B=8, N=3137, H=12, D=64)
# TimeSformer-B 32f 224^2 at B=8: the temporal (B*196 sequences of T=32) and
# spatial (B*32 sequences of 1+196) attention calls of every layer.
TS_SHAPES = {"temporal": (8 * 196, 32, 12, 64), "spatial": (8 * 32, 197, 12, 64)}
F32_TOL = 1e-4  # f32 kernel vs plain, absolute (TF32 off)
# Model logits, kernel vs plain attention, absolute, scaled by max(1, max |logit|).
LOGIT_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# Full-width gradients, kernels vs plain attention: relative L2 over all the
# parameters but the key biases (their gradient is round-off: softmax is
# shift-invariant per query row), and per parameter tensor in f32. In bf16 the
# key projections' weight gradients are differences of nearly equal sums
# (sum_k dK_k = 0), so the kernels' bf16 dS, rounded where the JAX kernels
# round it, moves them by tens of percent against the plain attention's f32
# autograd; the per-tensor reading is printed, and the f32 check bounds them.
GRAD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (3e-2, None)}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """Every kernel's launches since the counts were last set to 0; kernels
    8 and 9's launches on their wgmma design also under ``<entry>@wgmma``."""
    from laryngeal_tpu_torch.ops import flash_attention as fa
    from laryngeal_tpu_torch.ops import short_attention as sa
    from laryngeal_tpu_torch.ops import tubelet as tt
    from laryngeal_tpu_torch.ops import window_attention as wa

    return {**fa.launch_counts(), **sa.launch_counts(), **wa.launch_counts(),
            **tt.launch_counts(),
            **{f"{e}@wgmma": c["wgmma"] for e, c in wa.design_launches.items()}}


def reset_launches() -> None:
    from laryngeal_tpu_torch.ops import flash_attention as fa
    from laryngeal_tpu_torch.ops import short_attention as sa
    from laryngeal_tpu_torch.ops import tubelet as tt
    from laryngeal_tpu_torch.ops import window_attention as wa

    fa.reset_launches()
    sa.reset_launches()
    wa.reset_launches()
    tt.reset_launches()


def build_kernels():
    from laryngeal_tpu_torch.ops import _build

    sources = _build.library_sources()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(_build.build, sources))
    for s in sources:
        log(f"built {s} in {_build.build_seconds[s]:.2f} s")
        for line in (_build.build_log(s) or "").splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
    log(f"build phase: {time.perf_counter() - t0:.2f} s")


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2, queued: bool = False) -> float:
    """Median over ``reps`` single calls timed with CUDA events. With
    ``queued``, the median over 3 rounds of ``reps`` calls launched back to
    back between one pair of events, divided by ``reps``: the card's time
    for a call whose host-side launch (the Python wrapper, tens of
    microseconds) would otherwise show in the single-call reading."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(3 if queued else reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps if queued else 1):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (reps if queued else 1))
    return float(np.median(times))


def attention_bound_ms(b, nq, nk, h, d, dtype):
    """Least time for the work: two (Nq x Nk x D) products per head at the
    tensor-core (bf16) or FMA (f32) peak, against q/k/v read and o written
    once at the memory rate. Returns (ms, 'operations' | 'bytes')."""
    flops = 4.0 * b * h * nq * nk * d
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * nq * h * d + 2 * b * nk * h * d) * size
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def qkv(b, nq, nk, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda n: torch.randn((b, n, h, d), generator=g, device="cuda").to(dtype)
    return mk(nq), mk(nk), mk(nk)


def turns_ms(fns: dict, order=("old", "new", "new", "old")) -> dict:
    """Two designs timed in turns (old, new, new, old), single calls and
    queued (see cuda_time_ms): {which: mean ms, which + "_q": mean queued ms}."""
    t = {}
    for which in order:
        t.setdefault(which, []).append(cuda_time_ms(fns[which]))
        t.setdefault(which + "_q", []).append(cuda_time_ms(fns[which], reps=20, queued=True))
    return {x: sum(v) / len(v) for x, v in t.items()}


# Kernels 1-2's wgmma designs; which design a call runs is the C side's
# choice (``launch_fwd``), read back with ``last_forward_designs``.
FLASH_FWD_DESIGN = ("wgmma + TMA: a persistent block an SM walking work items of 192 query "
                    "rows (3 consumer warpgroups; 128 at D = 128), Q the register A operand of "
                    "S = Q K^T, 64-key K/V tiles streamed through a 4-stage mbarrier ring (K and "
                    "V on barriers of their own), per step the online softmax, then P V and the "
                    "next step's S as one batch, the warpgroups' softmaxes overlapping each "
                    "other's products")
FLASH_FWD_F32_DESIGN = ("wgmma.tf32x3 (D <= 64): the bf16 design's schedule on TF32 operands "
                        "split into big + small parts, three products a product; 2 consumer "
                        "warpgroups (128 query rows an item), Q's big part in registers and its "
                        "small part in shared memory, each step's P V in an accumulator of its "
                        "own added to O on the FMA units, TMA streaming f32 K and V tiles "
                        "through rings of their own, 3 transform warps splitting each K tile "
                        "and writing V^T's parts; FMA above D = 64 and for strides of 0")


def sdpa_kernel_names(fn) -> str:
    """The CUDA kernels one call of ``fn`` runs, by name with their device
    ms (torch.profiler), largest first."""
    by_name = launch_breakdown(fn, reps=1)
    return ", ".join(f"{n} {t:.3f} ms" for n, t in sorted(by_name.items(), key=lambda x: -x[1]))


def check_attention():
    """Phase 2: kernel 1 in both designs of each dtype (the design the entries
    run, and the earlier one through ``flash_attention_mma_cuda``: mma.sync in
    bf16, FMA in f32) vs plain on the card over phase 2b's cases in both
    dtypes, with kernel 2's lse of both within ``LSE_TOL``, and the design the
    entries ran as the C side must choose it. Timings at the ViViT-B shape: the two designs in turns and sdpa's forward, single calls
    and queued; sdpa's kernels by name."""
    import torch.nn.functional as F

    from laryngeal_tpu_torch.ops import flash_attention as fa

    for kernel in ("fwd_wgmma_kernel", "fwd_tf32_kernel"):
        for line in ptxas_lines("flash_attention_fwd.cu", kernel):
            log(f"ptxas {line}")
    entry, worst = {}, [0.0, 0.0]
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        earlier = "mma.sync" if dtype == torch.bfloat16 else "FMA"
        for seed, (name, b, nq, nk, h, d, kv_valid, layout) in enumerate(TRAIN_CASES):
            # every case's strides are positive: bf16 runs wgmma, f32
            # wgmma.tf32x3 at D <= 64 and FMA above
            want = "wgmma" if dtype == torch.bfloat16 else "wgmma.tf32x3" if d <= 64 else "fma"
            q, k, v, _ = train_inputs(b, nq, nk, h, d, dtype, layout, seed)
            ref, lse_ref = fa.attention_plain_lse(q, k, v, kv_valid)
            limit = fa.error_limit(q, k, v, kv_valid, ref, F32_TOL)
            runs = {"new": (fa.flash_attention(q, k, v, kv_valid),
                            *fa.flash_attention_lse_cuda(q, k, v, kv_valid))}
            design = "/".join(fa.last_forward_designs())
            again = fa.flash_attention_lse_cuda(q, k, v, kv_valid)
            same = torch.equal(again[0], runs["new"][1]) and torch.equal(again[1], runs["new"][2])
            del again
            runs["old"] = (fa.flash_attention_mma_cuda(q, k, v, kv_valid),
                           *fa.flash_attention_lse_mma_cuda(q, k, v, kv_valid))
            errs, uses, lse_errs = {}, {}, {}
            for which, (out, o2, lse) in runs.items():
                diff = (out.float() - ref.float()).abs()
                errs[which] = diff.max().item()
                uses[which] = max((diff / limit).max().item(),
                                  ((o2.float() - ref.float()).abs() / limit).max().item())
                lse_errs[which] = (lse - lse_ref).abs().max().item()
            ok = (max(uses.values()) <= 1.0 and max(lse_errs.values()) <= fa.LSE_TOL and same
                  and design == f"{want}/{want}"
                  and all(math.isfinite(x) for x in [*errs.values(), *lse_errs.values()]))
            log(f"attention {name} (B={b}, Nq={nq}, Nk={nk}, H={h}, D={d}, kv_valid={kv_valid}, "
                f"{layout}) {tag}: kernels 1/2 ({design}) max_abs_err {errs['new']:.3e}, largest "
                f"|err| / limit {uses['new']:.3f}, lse max_abs_err {lse_errs['new']:.2e}, "
                f"bitwise the same on a second call: {same}; {earlier} design max_abs_err "
                f"{errs['old']:.3e}, |err| / limit {uses['old']:.3f}, lse {lse_errs['old']:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            del runs, limit
            if not ok:
                raise AssertionError(f"kernel disagrees with plain version or ran {design}, "
                                     f"want {want}: {name} {dtype}")
            if dtype == torch.bfloat16:
                worst = [max(worst[0], errs["new"]), max(worst[1], uses["new"])]
            if name != "vivit_b":
                del q, k, v, ref, lse_ref
                torch.cuda.empty_cache()
                continue
            t = turns_ms({"new": lambda: fa.flash_attention_cuda(q, k, v),
                          "old": lambda: fa.flash_attention_mma_cuda(q, k, v)})
            ms = t["new"]
            plain_ms = cuda_time_ms(lambda: fa.attention_plain(q, k, v), reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
            library_ms = cuda_time_ms(sdpa)
            library_q = cuda_time_ms(sdpa, reps=20, queued=True)
            sdpa_kernels = sdpa_kernel_names(sdpa)
            if dtype == torch.bfloat16:
                bound_ms, bound_by = attention_bound_ms(b, nq, nk, h, d, dtype)
            else:
                bound_ms, bound_by, fma_bound, bf16x3 = f32_forward_bounds(b, nq, nk, h, d, 0)
            numbers = dict(max_abs_err=errs["new"], err_over_limit=uses["new"], ms=ms,
                           kernel_ms=ms, queued_ms=t["new_q"], plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                           library_queued_ms=library_q, old_ms=t["old"],
                           old_queued_ms=t["old_q"], design=design,
                           library_kernels=sdpa_kernels)
            line = (f"flash_attention_fwd vivit_b {tag}: kernel {ms:.4f} ms ({design}), queued "
                    f"{t['new_q']:.4f} ms, plain {plain_ms:.3f} ms, sdpa {library_ms:.4f} / "
                    f"queued {library_q:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}"
                    f"{'' if dtype == torch.bfloat16 else ', ' + TF32X3_BOUND}), "
                    f"{bound_ms / ms:.3f} / {bound_ms / t['new_q']:.3f} of the bound; the "
                    f"{earlier} design {t['old']:.4f} ms ({t['old'] / ms:.2f}x), queued "
                    f"{t['old_q']:.4f} ms ({t['old_q'] / t['new_q']:.2f}x); against sdpa "
                    f"{ms / library_ms:.3f}x / {t['new_q'] / library_q:.3f}x")
            if dtype == torch.bfloat16:
                entry.update(numbers)
            else:
                line += (f"; the FMA design's bound {fma_bound:.4f} ms (67 TFLOP/s), "
                         f"{fma_bound / t['old']:.3f} of it; {BF16X3_BOUND} {bf16x3:.4f} ms, "
                         f"{bf16x3 / ms:.3f} / {bf16x3 / t['new_q']:.3f} of it")
                entry["f32"] = numbers
            log(line)
            log(f"sdpa {tag} at vivit_b runs: {sdpa_kernels}")
            del q, k, v, qt, kt, vt, ref, lse_ref
            torch.cuda.empty_cache()
    entry.update(max_abs_err=worst[0], err_over_limit=worst[1],
                 tol=(f"bf16: error_limit (2^-8*plain(|v|)+2^-7*|ref|+1e-5), lse "
                      f"{fa.LSE_TOL:g}; f32: {F32_TOL:g}"),
                 headline="vivit_b (8, 3137, 12, 64) bf16; max_abs_err and err_over_limit over "
                          "every phase-2 case, of the design the entries ran (the earlier "
                          "design's |err|/limit is logged per case)")
    entry["design"] = f"{entry['design']} at vivit_b; {FLASH_FWD_DESIGN}"
    entry["f32"]["design"] = f"{entry['f32']['design']} at vivit_b; {FLASH_FWD_F32_DESIGN}"
    return entry


def kernel_bound_ms(b, nq, nk, h, d, dtype, matmuls, q_tensors, k_tensors, f32_rows,
                    peak=None):
    """Least time for ``matmuls`` (Nq x Nk x D) products per head at the
    tensor-core (bf16) or FMA (f32) peak, or at ``peak`` FLOP/s, against the
    bytes moved once: ``q_tensors`` (B, Nq, H, D) and ``k_tensors``
    (B, Nk, H, D) tensors of the input dtype read or written, and
    ``f32_rows`` f32 (B, H, Nq) rows (lse, delta). Returns (ms,
    'operations' | 'bytes')."""
    flops = 2.0 * matmuls * b * h * nq * nk * d
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (q_tensors * nq + k_tensors * nk) * b * h * d * size + f32_rows * b * h * nq * 4
    t_ops, t_bytes = flops / (peak or PEAK_FLOPS[dtype]), nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The f32 bound of kernels 1-2's wgmma.tf32x3 design: each product is three
# TF32 products (3xTF32) on the tensor cores.
TF32X3_BOUND = "3xTF32: three TF32 products a product at 495 TFLOP/s"
# A split no kernel here runs, whose CPU emulation also holds the 1e-4 limit
# (tests/test_torch_flash_attention.py): the bound of the same work on it.
BF16X3_BOUND = "bf16x3 (hi + lo bf16, three products a product at 989 TFLOP/s, not built)"


def f32_forward_bounds(b, nq, nk, h, d, f32_rows):
    """Kernels 1-2 in f32 (``f32_rows``: 1 with kernel 2's lse): (bound ms,
    bound_by) of the design the entries run, 3xTF32 at D <= 64 and the FMA
    units above; the FMA design's bound ms; and the bound ms of bf16x3."""
    fma = kernel_bound_ms(b, nq, nk, h, d, torch.float32, 2, 2, 2, f32_rows)
    bf16x3 = kernel_bound_ms(b, nq, nk, h, d, torch.float32, 3 * 2, 2, 2, f32_rows,
                             peak=PEAK_FLOPS[torch.bfloat16])[0]
    if d > 64:
        return (*fma, fma[0], bf16x3)
    return (*kernel_bound_ms(b, nq, nk, h, d, torch.float32, 3 * 2, 2, 2, f32_rows,
                             peak=PEAK_TF32), fma[0], bf16x3)


# Kernels 3-4's wgmma design; which design a call runs is the C side's choice
# (``launch_dq`` / ``launch_dkv``), read back with ``last_backward_designs``.
FLASH_BWD_DESIGN = ("wgmma + TMA: a block's 128 (dK/dV) or 192 (dQ, D <= 64) rows resident in "
                    "shared memory, the other side's 64-row tiles streamed through a 3-4 stage "
                    "mbarrier ring that 2-3 consumer warpgroups share, P and dS from the "
                    "accumulators in registers, no atomics")


FLASH_BWD_F32_DESIGN = ("wgmma.tf32x3 (D <= 64): a persistent block an SM walking items of 128 "
                        "rows (2 consumer warpgroups), 32-row steps streamed by TMA in rows and "
                        "transposed forms split into big + small TF32 parts, three TF32 products "
                        "a product, each step's dQ / dK / dV product added on the FMA units; dQ: "
                        "Q's and dO's big parts in registers, their small parts in shared memory, "
                        "raw K and V steps split by 3 transform warps, two batches a step; dK/dV: "
                        "a pre-pass splits q and dO once a call into scratch, K and V resident "
                        "and split into registers each step, Q and dO forms with their lse and "
                        "delta streamed; FMA above D = 64 and for strides of 0")


def bwd_entry_designs(dtype, d):
    """The designs kernels 3 and 4's entries run at head dim ``d`` with
    positive strides, as ``last_backward_designs`` joins them: wgmma in bf16
    (dK/dV mma.sync at D = 128); wgmma.tf32x3 in f32 at D <= 64, FMA above."""
    if dtype == torch.bfloat16:
        return "wgmma/wgmma" if d <= 64 else "wgmma/mma.sync"
    return "wgmma.tf32x3/wgmma.tf32x3" if d <= 64 else "fma/fma"


# Phase 2b's cases: (name, B, Nq, Nk, H, D, kv_valid, layout). "fused": q, k
# and v are views of one (B, N, 3, H, D) projection; "bhnd": (B, H, N, D)
# tensors transposed to (B, N, H, D) views.
TRAIN_CASES = [("vivit_b", VIVIT_B["B"], VIVIT_B["N"], VIVIT_B["N"], 12, 64, None, "contiguous"),
               ("n300_kv_valid", 2, 300, 300, 12, 64, 250, "contiguous"),
               ("nq_ne_nk", 2, 257, 1100, 12, 64, None, "contiguous"),
               ("nq_gt_nk_kv_valid", 2, 1100, 257, 12, 64, 200, "contiguous"),
               ("d32_kv_valid", 2, 1000, 1000, 6, 32, 900, "contiguous"),
               ("d40", 2, 700, 700, 6, 40, None, "contiguous"),
               ("d128_kv_valid", 2, 600, 600, 4, 128, 555, "contiguous"),
               ("fused_qkv", 2, 3137, 3137, 12, 64, None, "fused"),
               ("bhnd_view", 2, 1000, 777, 5, 64, 700, "bhnd")]


def train_inputs(b, nq, nk, h, d, dtype, layout, seed):
    """q, k, v (in ``layout``) and a contiguous output gradient g, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if layout == "fused":
        q, k, v = mk(b, nq, 3, h, d).unbind(2)
    elif layout == "bhnd":
        q = mk(b, h, nq, d).transpose(1, 2)
        k, v = (mk(b, h, nk, d).transpose(1, 2) for _ in range(2))
    else:
        q, k, v = mk(b, nq, h, d), mk(b, nk, h, d), mk(b, nk, h, d)
    return q, k, v, mk(b, nq, h, d)


def check_training_kernels():
    """Phase 2b: kernels 2-4 vs their plain twins on the card (kernels 3-4 in
    the entries' design and the earlier one, in both dtypes); timings at the
    ViViT-B shape, kernels 2-4 beside their earlier design in turns. Returns
    {entry name: numbers} for the kernels line."""
    import torch.nn.functional as F

    from laryngeal_tpu_torch.ops import flash_attention as fa

    for kernel in ("dq_wgmma_kernel", "dkv_wgmma_kernel", "bwd_dq_tf32_kernel",
                   "bwd_dkv_tf32_kernel", "bwd_forms_tf32_kernel"):
        for line in ptxas_lines("flash_attention_bwd.cu", kernel):
            log(f"ptxas {line}")
    entries = {"flash_attention_fwd_lse": {}, "flash_attention_bwd_dq": {},
               "flash_attention_bwd_dkv": {}}
    worst = {e: [0.0, 0.0] for e in entries}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for seed, (name, b, nq, nk, h, d, kv_valid, layout) in enumerate(TRAIN_CASES):
            q, k, v, g = train_inputs(b, nq, nk, h, d, dtype, layout, 10 + seed)
            # kernel 2
            o, lse = fa.flash_attention_lse(q, k, v, kv_valid)
            o_ref, lse_ref = fa.attention_plain_lse(q, k, v, kv_valid)
            o_use = ((o.float() - o_ref.float()).abs()
                     / fa.error_limit(q, k, v, kv_valid, o_ref, F32_TOL)).max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            o_err = (o.float() - o_ref.float()).abs().max().item()
            # kernels 3 and 4, fed the plain forward's o and lse: the design
            # the entries choose, then the earlier one (mma.sync; f32 FMA)
            refs = fa.attention_plain_bwd(q, k, v, o_ref, lse_ref, g, kv_valid)
            limits = fa.backward_error_limit(q, k, v, o_ref, lse_ref, g, kv_valid, refs)
            delta = fa.attention_delta(o_ref, g)
            runs = {"new": fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, g, kv_valid)}
            design = "/".join(fa.last_backward_designs())
            again = fa.flash_attention_bwd(q, k, v, o_ref, lse_ref, g, kv_valid)
            same = all(torch.equal(x, y) for x, y in zip(runs["new"], again))
            del again
            want = bwd_entry_designs(dtype, d)
            runs["old"] = (fa.flash_attention_dq_mma_cuda(q, k, v, g, lse_ref, delta, kv_valid),
                           *fa.flash_attention_dkv_mma_cuda(q, k, v, g, lse_ref, delta,
                                                            kv_valid))
            uses, errs, masked_zero = {}, {}, True
            for which, grads in runs.items():
                uses[which], errs[which] = [], []
                for got, ref, lim in zip(grads, refs, limits):
                    diff = (got.float() - ref.float()).abs()
                    uses[which].append((diff / lim).max().item())
                    errs[which].append(diff.max().item())
                if kv_valid is not None and kv_valid < nk:
                    masked_zero &= (torch.count_nonzero(grads[1][:, kv_valid:]).item() == 0
                                    and torch.count_nonzero(grads[2][:, kv_valid:]).item() == 0)
            del limits
            every = uses["new"] + uses["old"] + errs["new"] + errs["old"] + [o_err, lse_err]
            ok = (o_use <= 1.0 and lse_err <= fa.LSE_TOL and max(uses["new"] + uses["old"]) <= 1.0
                  and masked_zero and same and design == want
                  and all(math.isfinite(x) for x in every))
            log(f"training kernels {name} (B={b}, Nq={nq}, Nk={nk}, H={h}, D={d}, kv_valid="
                f"{kv_valid}, {layout}) {tag}: lse o max_abs_err {o_err:.3e} (|err|/limit "
                f"{o_use:.3f}), lse max_abs_err {lse_err:.3e} (tol {fa.LSE_TOL:g}); dq/dk/dv "
                f"({design}) max_abs_err {'/'.join(f'{x:.3e}' for x in errs['new'])}, largest "
                f"|err|/limit {'/'.join(f'{x:.3f}' for x in uses['new'])}, bitwise the same on a "
                f"second call: {same}; {'mma.sync' if dtype == torch.bfloat16 else 'FMA'} design "
                f"{'/'.join(f'{x:.3f}' for x in uses['old'])}; masked dk/dv exactly 0: "
                f"{masked_zero} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"training kernels disagree with plain twins or ran "
                                     f"{design}, want {want}: {name} {tag}")
            if dtype == torch.bfloat16:
                for e, err, use in (
                        ("flash_attention_fwd_lse", max(o_err, lse_err),
                         max(o_use, lse_err / fa.LSE_TOL)),
                        ("flash_attention_bwd_dq", errs["new"][0], uses["new"][0]),
                        ("flash_attention_bwd_dkv", max(errs["new"][1:]),
                         max(uses["new"][1:]))):
                    worst[e] = [max(worst[e][0], err), max(worst[e][1], use)]
            del runs, refs
            if name != "vivit_b":
                del q, k, v, g, o, lse, o_ref, lse_ref, delta
                torch.cuda.empty_cache()
                continue
            # Kernels 2, 3 and 4 beside their earlier design (mma.sync; f32
            # FMA) in turns (old, new, new, old), single calls and queued (the
            # card's time; see cuda_time_ms); the twins single-call.
            turns, designs = {}, {}
            calls = {"flash_attention_fwd_lse": {
                         "new": lambda: fa.flash_attention_lse_cuda(q, k, v),
                         "old": lambda: fa.flash_attention_lse_mma_cuda(q, k, v)},
                     "flash_attention_bwd_dq": {
                         "new": lambda: fa.flash_attention_dq_cuda(q, k, v, g, lse_ref, delta),
                         "old": lambda: fa.flash_attention_dq_mma_cuda(q, k, v, g, lse_ref,
                                                                       delta)},
                     "flash_attention_bwd_dkv": {
                         "new": lambda: fa.flash_attention_dkv_cuda(q, k, v, g, lse_ref, delta),
                         "old": lambda: fa.flash_attention_dkv_mma_cuda(q, k, v, g, lse_ref,
                                                                        delta)}}
            for e, fns in calls.items():
                t = {"old": [], "new": [], "old_q": [], "new_q": []}
                # each entry's design against the earlier one (f32: FMA)
                for which in ("old", "new", "new", "old"):
                    t[which].append(cuda_time_ms(fns[which]))
                    t[which + "_q"].append(cuda_time_ms(fns[which], reps=20, queued=True))
                    if which == "new":
                        designs[e] = (fa.last_forward_designs()[1] if "lse" in e else
                                      fa.last_backward_designs()[0 if "dq" in e else 1])
                turns[e] = {x: (sum(v) / len(v) if v else None) for x, v in t.items()}
            plain_fwd = cuda_time_ms(lambda: fa.attention_plain_lse(q, k, v), reps=3, warmup=1)
            plain_bwd = cuda_time_ms(
                lambda: fa.attention_plain_bwd(q, k, v, o_ref, lse_ref, g), reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            gt = g.transpose(1, 2)
            lib_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            lib_fwd_q = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                     reps=20, queued=True)
            out = F.scaled_dot_product_attention(qt, kt, vt)
            sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
            lib_bwd = cuda_time_ms(sdpa_bwd)
            lib_bwd_q = cuda_time_ms(sdpa_bwd, reps=20, queued=True)
            bwd_kernels = sdpa_kernel_names(sdpa_bwd)
            log(f"sdpa {tag} backward at vivit_b runs: {bwd_kernels}")
            del out, qt, kt, vt, gt
            # (entry, kernel ms, plain ms, library ms, products, Nq-long
            # tensors, Nk-long tensors, f32 rows)
            for entry, ms, plain_ms, lib_ms, mm, nq_t, nk_t, rows in (
                    ("flash_attention_fwd_lse", turns["flash_attention_fwd_lse"]["new"],
                     plain_fwd, lib_fwd, 2, 2, 2, 1),
                    ("flash_attention_bwd_dq", turns["flash_attention_bwd_dq"]["new"], plain_bwd,
                     lib_bwd, 3, 3, 2, 2),
                    ("flash_attention_bwd_dkv", turns["flash_attention_bwd_dkv"]["new"],
                     plain_bwd, lib_bwd, 4, 2, 4, 2)):
                fwd = entry == "flash_attention_fwd_lse"
                if fwd and dtype == torch.float32:
                    bound_ms, bound_by, fma_bound, bf16x3 = f32_forward_bounds(b, nq, nk, h, d,
                                                                               rows)
                elif dtype == torch.float32:  # kernels 3-4 on wgmma.tf32x3: 3xTF32
                    bound_ms, bound_by = kernel_bound_ms(b, nq, nk, h, d, dtype, 3 * mm, nq_t,
                                                         nk_t, rows, peak=PEAK_TF32)
                    fma_bound = kernel_bound_ms(b, nq, nk, h, d, dtype, mm, nq_t, nk_t, rows)[0]
                else:
                    bound_ms, bound_by = kernel_bound_ms(b, nq, nk, h, d, dtype, mm, nq_t,
                                                         nk_t, rows)
                numbers = dict(ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=lib_ms)
                line = (f"{entry} vivit_b {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                        f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                        f"{bound_ms / ms:.3f} of the bound")
                tt = turns[entry]
                lib_q = lib_fwd_q if fwd else lib_bwd_q
                numbers.update(queued_ms=tt["new_q"], library_queued_ms=lib_q,
                               design=designs[entry], old_ms=tt["old"], old_queued_ms=tt["old_q"])
                if not fwd:
                    numbers["library_kernels"] = bwd_kernels
                line += (f"; design {numbers['design']}; queued {tt['new_q']:.4f} ms "
                         f"({bound_ms / tt['new_q']:.3f} of the bound), sdpa "
                         f"{'forward' if fwd else 'backward'} queued {lib_q:.4f} ms "
                         f"({tt['new_q'] / lib_q:.3f}x)")
                line += (f"; the {'mma.sync' if dtype == torch.bfloat16 else 'FMA'} design "
                         f"{tt['old']:.4f} ms ({tt['old'] / ms:.2f}x), queued "
                         f"{tt['old_q']:.4f} ms ({tt['old_q'] / tt['new_q']:.2f}x)")
                if dtype == torch.float32:
                    line += (f"; bound {TF32X3_BOUND}; the FMA design's bound {fma_bound:.4f} "
                             f"ms (67 TFLOP/s), {fma_bound / tt['old']:.3f} of it")
                if fwd and dtype == torch.float32:
                    line += (f"; {BF16X3_BOUND} {bf16x3:.4f} ms, "
                             f"{bf16x3 / ms:.3f} / {bf16x3 / tt['new_q']:.3f} of it")
                log(line)
                if dtype == torch.bfloat16:
                    entries[entry].update(numbers)
                else:
                    entries[entry]["f32"] = numbers
            pair, pair_q, old, old_q = (turns["flash_attention_bwd_dq"][x]
                                        + turns["flash_attention_bwd_dkv"][x]
                                        for x in ("new", "new_q", "old", "old_q"))
            log(f"kernels 3 + 4 vivit_b {tag} ({designs['flash_attention_bwd_dq']}): {pair:.4f} "
                f"ms single-call, {pair_q:.4f} ms queued, against sdpa's backward {lib_bwd:.4f} / "
                f"{lib_bwd_q:.4f} ms ({pair / lib_bwd:.3f}x / {pair_q / lib_bwd_q:.3f}x); the "
                f"earlier design's pair {old:.4f} / {old_q:.4f} ms")
            del q, k, v, g, o, lse, o_ref, lse_ref, delta
            torch.cuda.empty_cache()
    tol = ("bf16: error_limit / backward_error_limit (rounding-derived, elementwise), "
           f"lse {fa.LSE_TOL:g}; f32: {F32_TOL:g} (o), F32_REL*A (grads)")
    for e, nums in entries.items():
        nums.update(max_abs_err=worst[e][0], err_over_limit=worst[e][1], tol=tol,
                    headline="vivit_b (8, 3137, 12, 64) bf16; max_abs_err and err_over_limit "
                             "over every phase-2b case, of the design the entries ran (the "
                             "mma.sync design's |err|/limit is logged per case)")
    for e in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        entries[e]["design"] = f"{entries[e]['design']} at vivit_b; {FLASH_BWD_DESIGN}"
        entries[e]["f32"]["design"] = (f"{entries[e]['f32']['design']} at vivit_b; "
                                       f"{FLASH_BWD_F32_DESIGN}")
        entries[e]["f32"]["source"] = "laryngeal_tpu_torch/csrc/flash_attention_bwd_tf32.cu"
    e = "flash_attention_fwd_lse"
    entries[e]["design"] = f"{entries[e]['design']} at vivit_b; {FLASH_FWD_DESIGN}"
    entries[e]["f32"]["design"] = (f"{entries[e]['f32']['design']} at vivit_b; "
                                   f"{FLASH_FWD_F32_DESIGN}")
    return entries


def check_logits(label, logits, logits_plain, tol, model="vivit-b"):
    scale = max(1.0, logits_plain.abs().max().item())
    err = (logits.float() - logits_plain.float()).abs().max().item()
    log(f"{model} {label} logits kernel vs plain attention: max_abs_err {err:.3e} "
        f"(tol {tol:g} x {scale:.3f})")
    if not (np.isfinite(err) and err <= tol * scale):
        raise AssertionError(f"{label} model logits with the kernel disagree with "
                             "plain attention")


def main_path(kernel1_f32_ms: float) -> dict:
    """Phases 3 and 4: the ViViT-B serving path on the card (kernel 1's f32
    time from phase 2 gives its share of the f32 forward). Returns each
    kernel's launches since the counts were set to 0."""
    from laryngeal_tpu_torch.infer.predictor import Predictor
    from laryngeal_tpu_torch.models.registry import get_model_spec
    from laryngeal_tpu_torch.models.vivit import create_vivit
    from laryngeal_tpu_torch.ops import attention as att
    from laryngeal_tpu_torch.ops import flash_attention as fa
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.serve.server import InferenceServer

    model = create_vivit(num_classes=2, num_frames=32, image_size=224,
                         dtype=torch.bfloat16, seed=0)
    predictor = Predictor(model, get_model_spec("vivit"), num_frames=32, crop_size=224,
                          device="cuda")
    n_layers = model.config.num_layers
    clips = np.random.default_rng(0).integers(0, 256, (8, 32, 224, 224, 3), dtype=np.uint8)

    # -- phase 3: forward, probabilities, launches, kernel vs plain logits --
    probs = predictor.predict_clip(clips)
    if fa.launches != n_layers:
        raise AssertionError(f"{fa.launches} kernel launches in one forward, want {n_layers}")
    if probs.shape != (8, 2) or not np.isfinite(probs).all() \
            or not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad probabilities {probs}")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clips_dev = torch.from_numpy(clips).cuda()
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        pixel = batch_preprocess(clips_dev, "vivit", crop=224)
        preprocess_ms = cuda_time_ms(lambda: batch_preprocess(clips_dev, "vivit", crop=224),
                                     reps=5, warmup=1)
        before = fa.launches
        logits = model(pixel)
        forward_launches = fa.launches - before
        forward_design = fa.last_forward_designs()[0]
        att.set_attention_impl("plain")
        try:
            logits_plain = model(pixel)
        finally:
            att.set_attention_impl(None)
        forward_ms = cuda_time_ms(lambda: model(pixel), reps=5, warmup=1)
    if forward_launches != n_layers:
        raise AssertionError(f"{forward_launches} launches per forward, want {n_layers}")
    if forward_design != "wgmma":
        raise AssertionError(f"the bf16 ViViT-B forward ran kernel 1 as {forward_design}")
    log(f"vivit-b bf16 forward: {forward_launches} launches of kernel 1 ({forward_design})")
    check_logits("bf16", logits, logits_plain, LOGIT_TOL[torch.bfloat16])

    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict_clip(clips)
    e2e_s = (time.perf_counter() - t0) / reps
    log(f"vivit-b 32f 224 bf16 B=8: h2d {h2d_ms:.2f} ms (uint8 batch, host clock), "
        f"preprocess {preprocess_ms:.2f} ms, forward {forward_ms:.2f} ms (model only), "
        f"predict_clip {e2e_s * 1e3:.2f} ms -> {8 / e2e_s:.2f} clips/s "
        f"(uint8 host batch -> probabilities on the host)")

    # -- the same weights in f32 (no dtype in a checkpoint's metadata) --
    model_f32 = create_vivit(num_classes=2, num_frames=32, image_size=224, seed=0)
    pred_f32 = Predictor(model_f32, get_model_spec("vivit"), num_frames=32, crop_size=224,
                         device="cuda")
    before = fa.launches
    probs_f32 = pred_f32.predict_clip(clips[:2])
    if fa.launches - before != n_layers:
        raise AssertionError(f"{fa.launches - before} launches in one f32 forward, "
                             f"want {n_layers}")
    if not np.isfinite(probs_f32).all() or not np.allclose(probs_f32.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad f32 probabilities {probs_f32}")
    with torch.inference_mode():
        logits_f32 = model_f32(pixel[:2])
        att.set_attention_impl("plain")
        try:
            logits_f32_plain = model_f32(pixel[:2])
        finally:
            att.set_attention_impl(None)
    check_logits("f32", logits_f32, logits_f32_plain, LOGIT_TOL[torch.float32])
    with torch.inference_mode():  # the f32 forward at B=8, kernel 1's share
        before = fa.launches
        model_f32(pixel)
        f32_launches, f32_design = fa.launches - before, fa.last_forward_designs()[0]
        f32_forward_ms = cuda_time_ms(lambda: model_f32(pixel), reps=5, warmup=1)
    if f32_launches != n_layers or f32_design != "wgmma.tf32x3":
        raise AssertionError(f"the f32 ViViT-B forward ran kernel 1 {f32_launches} times as "
                             f"{f32_design}, want {n_layers} on wgmma.tf32x3")
    k1_ms = n_layers * kernel1_f32_ms
    log(f"vivit-b 32f 224 f32 B=8 forward: {f32_forward_ms:.2f} ms (model only, CUDA events, "
        f"median of 5), {f32_launches} launches of kernel 1 ({f32_design}); kernel 1 "
        f"{n_layers} x {kernel1_f32_ms:.4f} = {k1_ms:.2f} ms = {k1_ms / f32_forward_ms:.3f} of "
        f"the forward")
    # What the kernel's bf16 P costs the bf16 model, against the f32 model on
    # the plain attention (a reading, held to no limit).
    err_kernel = (logits[:2] - logits_f32_plain).abs().max().item()
    err_plain = (logits_plain[:2] - logits_f32_plain).abs().max().item()
    log(f"vivit-b bf16 logits vs the f32 model (2 clips): kernel {err_kernel:.3e}, "
        f"plain attention {err_plain:.3e}")
    log(f"vivit-b f32 vs bf16 probabilities (2 clips): max_abs_diff "
        f"{np.abs(probs_f32 - probs[:2]).max():.3e}")
    del pred_f32, model_f32
    torch.cuda.empty_cache()

    # -- phase 4: the server --
    server = InferenceServer(predictor, port=0, max_batch=8, batch_timeout_ms=50)
    thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("model") != "vivit":
            raise AssertionError(f"/healthz: {health}")
        n_req = 12
        futures = [None] * n_req

        def submit(i):
            futures[i] = server.batcher.submit(clips[i % 8])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(n_req)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        rows = np.stack([f.result(timeout=300) for f in futures])
        serve_s = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.close()
        thread.join(timeout=10)
    if not np.isfinite(rows).all() or not np.allclose(rows.sum(-1), 1.0, atol=1e-5):
        raise AssertionError("server returned bad probabilities")
    if stats["requests"] != n_req or stats["batches"] < 2 or stats["batch_errors"]:
        raise AssertionError(f"/stats: {stats}")
    np.testing.assert_allclose(rows[:8], probs, atol=2e-2)
    log(f"server: {n_req} clips in {stats['batches']} batches "
        f"(mean fill {stats['mean_batch_fill']:.2f}) in {serve_s:.2f} s")
    counts = launch_counts()
    if any(counts[k] for k in counts if k != "flash_attention_fwd"):
        raise AssertionError(f"the ViViT serving path launched another kernel than kernel 1: "
                             f"{counts}")
    return counts


def launched(fn):
    """Run ``fn``, synchronise; returns (its result, each kernel's launches
    during it)."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def vivit_train_flops(cfg, batch: int) -> float:
    """Model operations of one train step: 3x the forward's products (the
    backward does two per forward product); the flash backward's recompute
    of S is not counted."""
    n, dim, inter = cfg.num_patches + 1, cfg.hidden_size, cfg.intermediate_size
    t, ph, pw = cfg.tubelet_size
    embed = 2.0 * cfg.num_patches * 3 * t * ph * pw * dim
    layer = 2.0 * n * dim * dim * 4 + 2.0 * n * dim * inter * 2 + 4.0 * n * n * dim
    return 3.0 * batch * (embed + cfg.num_layers * layer)


def vivit_key_free(name, grad):
    """ViViT's gradients without the key biases (round-off, see GRAD_TOL)."""
    return None if name.endswith("attention.attention.key.bias") else grad


def timesformer_key_free(name, grad):
    """TimeSformer's gradients without the key slice [D, 2D) of each fused
    qkv bias (round-off, see GRAD_TOL)."""
    if name.endswith("attention.attention.qkv.bias"):
        d = grad.shape[0] // 3
        return torch.cat([grad[:d], grad[2 * d:]])
    return grad


def grad_check(make_model, pixel, labels, dtype, key_free=vivit_key_free, label="vivit-b"):
    """Every parameter's gradient at full width and depth, with the kernels
    against the same model on the plain attention (relative L2)."""
    from laryngeal_tpu_torch.ops import attention as att
    from laryngeal_tpu_torch.train.losses import cross_entropy

    model = make_model(dtype).cuda().train()

    def grads():
        model.zero_grad(set_to_none=True)
        cross_entropy(model(pixel), labels).backward()
        out = {n: key_free(n, p.grad.float()) for n, p in model.named_parameters()}
        return {n: g for n, g in out.items() if g is not None}

    with_kernels = grads()
    att.set_attention_impl("plain")
    try:
        plain = grads()
    finally:
        att.set_attention_impl(None)
    names = list(plain)
    num = math.sqrt(sum(((with_kernels[n] - plain[n]) ** 2).sum().item() for n in names))
    den = math.sqrt(sum((plain[n] ** 2).sum().item() for n in names))
    per = {n: ((with_kernels[n] - plain[n]).norm() / plain[n].norm().clamp_min(1e-30)).item()
           for n in names}
    worst = max(per, key=per.get)
    finite = all(torch.isfinite(g).all().item() for g in with_kernels.values())
    tol_all, tol_each = GRAD_TOL[dtype]
    ok = finite and num / den <= tol_all and (tol_each is None or per[worst] <= tol_each)
    log(f"{label} {str(dtype)[6:]} gradients B=2, kernels vs plain attention: relative L2 "
        f"{num / den:.3e} over {len(names)} tensors (tol {tol_all:g}), worst tensor "
        f"{worst} {per[worst]:.3e} (tol {tol_each}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{dtype} gradients with the kernels disagree with plain attention")
    del model, with_kernels, plain
    torch.cuda.empty_cache()


def training_path(kernel_ms: dict, f32_kernel_ms: dict) -> None:
    """Phases 5 and 6: the ViViT-B training path on the card, and the CLI.
    ``kernel_ms`` / ``f32_kernel_ms``: kernels 2-4's times from phase 2b in
    bf16 / f32, for their share of the step."""
    from laryngeal_tpu_torch.models.vivit import create_vivit
    from laryngeal_tpu_torch.ops import flash_attention as fa
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.train.losses import cross_entropy
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_eval_step, make_train_step

    b = 8
    model = create_vivit(num_classes=2, num_frames=32, image_size=224, dtype=torch.bfloat16,
                         seed=0).cuda()
    n_layers = model.config.num_layers
    state = create_train_state(model, "adamw", 1e-4, 0.01)
    step = make_train_step(model, "vivit", "ce", crop=224)
    eval_step = make_eval_step(model, "vivit", "ce", crop=224)
    rng = np.random.default_rng(1)
    clips = rng.integers(0, 256, (b, 32, 224, 224, 3), dtype=np.uint8)
    labels = torch.from_numpy(rng.integers(0, 2, b)).cuda()
    mask = torch.ones(b, dtype=torch.bool, device="cuda")
    pixel_u8 = torch.from_numpy(clips).cuda()

    # -- phase 5: launches per step, loss, timing --
    (state, m), per_step = launched(lambda: step(state, pixel_u8, labels, mask))
    want = {k: 0 for k in per_step}
    want.update(flash_attention_fwd_lse=n_layers, flash_attention_bwd_dq=n_layers,
                flash_attention_bwd_dkv=n_layers)
    if per_step != want:
        raise AssertionError(f"launches per train step {per_step}, want {want}")
    step_designs = (fa.last_forward_designs()[1], *fa.last_backward_designs())
    em, per_eval = launched(lambda: eval_step(state, pixel_u8, labels, mask))
    want_eval = {k: (n_layers if k == "flash_attention_fwd" else 0) for k in want}
    if per_eval != want_eval:
        raise AssertionError(f"launches per eval step {per_eval}, want {want_eval}")
    if step_designs != ("wgmma",) * 3 or fa.last_forward_designs()[0] != "wgmma":
        raise AssertionError(f"the train step ran kernels 2-4 as {step_designs} and the eval "
                             f"step kernel 1 as {fa.last_forward_designs()[0]}, want wgmma")
    log(f"launches per train step {per_step}; per eval step {per_eval}; designs: kernels 2-4 "
        f"{step_designs}, kernel 1 {fa.last_forward_designs()[0]}")
    for _ in range(2):
        step(state, pixel_u8, labels, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    losses = [step(state, pixel_u8, labels, mask)[1]["loss"] for _ in range(reps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in [m["loss"], em["loss"]] + losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    flops = vivit_train_flops(model.config, b)
    log(f"vivit-b 32f 224 bf16 B=8 train step: {step_s * 1e3:.2f} ms -> {b / step_s:.2f} "
        f"clips/s (uint8 batch on the card -> updated weights), peak memory "
        f"{peak / 2**30:.2f} GiB, model operations {flops:.4e} per step = "
        f"{flops / step_s / 989e12:.4f} of 989 TFLOP/s; losses {losses}")

    # Where the step's time goes: each stage between CUDA events, median of 3.
    t0 = time.perf_counter()
    torch.from_numpy(clips).cuda()
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    pre_ms = cuda_time_ms(lambda: batch_preprocess(pixel_u8, "vivit", crop=224), reps=3)
    stages = []
    model.train()
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        pixel = batch_preprocess(pixel_u8, "vivit", crop=224)
        ev[0].record()
        loss = cross_entropy(model(pixel), labels, mask)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        stages.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd_ms, bwd_ms, opt_ms = np.median(np.asarray(stages[1:]), axis=0)
    attn_ms = n_layers * sum(kernel_ms.values())
    log(f"train step stages (bf16 B=8): h2d {h2d_ms:.2f} ms (pageable uint8 batch, host "
        f"clock), preprocess {pre_ms:.2f} ms, forward+loss {fwd_ms:.2f} ms, backward "
        f"{bwd_ms:.2f} ms, optimizer {opt_ms:.2f} ms; attention kernels {n_layers} x "
        f"({' + '.join(f'{v:.3f}' for v in kernel_ms.values())}) = {attn_ms:.2f} ms = "
        f"{attn_ms / (step_s * 1e3):.3f} of the step")
    del state, step, eval_step, model, m, em, loss, pixel
    torch.cuda.empty_cache()

    # The f32 train step at B=8 (the training CLI's default compute dtype):
    # launches and designs on a warm-up step, then the median of 3 steps.
    model = create_vivit(num_classes=2, num_frames=32, image_size=224, seed=0).cuda()
    state = create_train_state(model, "adamw", 1e-4, 0.01)
    step = make_train_step(model, "vivit", "ce", crop=224)
    (state, m), per_step = launched(lambda: step(state, pixel_u8, labels, mask))
    designs = (fa.last_forward_designs()[1], *fa.last_backward_designs())
    if per_step != want or designs != ("wgmma.tf32x3",) * 3:
        raise AssertionError(f"f32 train step: launches {per_step}, designs {designs}")
    times, losses = [], [m["loss"].item()]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, pixel_u8, labels, mask)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite f32 loss {losses}")
    f32_step_ms = float(np.median(times))
    shares = {e: n_layers * ms / f32_step_ms for e, ms in f32_kernel_ms.items()}
    log(f"vivit-b 32f 224 f32 B=8 train step: {f32_step_ms:.2f} ms (median of 3 after a "
        f"warm-up, host clock) -> {b / f32_step_ms * 1e3:.2f} clips/s, peak memory "
        f"{peak / 2**30:.2f} GiB; designs {designs}; kernels 2-4 {n_layers} x "
        f"({' + '.join(f'{v:.3f}' for v in f32_kernel_ms.values())}) ms, shares of the step "
        f"{', '.join(f'{e} {x:.3f}' for e, x in shares.items())}; losses {losses}")
    del state, step, model, m
    torch.cuda.empty_cache()

    pixel2 = batch_preprocess(pixel_u8[:2], "vivit", crop=224)
    make = lambda dt: create_vivit(num_classes=2, num_frames=32, image_size=224, dtype=dt,
                                   seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        grad_check(make, pixel2, labels[:2], dtype)
    del pixel_u8, pixel2
    torch.cuda.empty_cache()

    # -- phase 6: the training CLI, then the predictor on its checkpoint --
    cli_phase("vivit", [], 0, "flash_attention_fwd", n_layers, clips, "vivit-b")


def cli_phase(model: str, extra: list, seed: int, launch_key: str, n_calls: int, clips,
              label: str):
    """The training CLI at full width on 8 / 4 / 4 synthetic videos in a
    temporary directory (deleted at the end): ``cli.main --model <model>
    --bf16`` for one epoch, then ``--resume auto`` for a second; the
    checkpoints, history and test metrics are checked, and best_model/ is
    served in f32 by ``Predictor.from_checkpoint`` on two clips with
    ``n_calls`` launches of ``launch_key``. Returns (the served model's
    config, the first run's training_config.json)."""
    from laryngeal_tpu_torch.cli import main as cli
    from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
    from laryngeal_tpu_torch.infer.predictor import Predictor

    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{model}_cli_"))
    try:
        data = make_synthetic_dataset(str(tmp / "data"), {"train": 4, "val": 2, "test": 2},
                                      num_frames=40, h=112, w=112, seed=seed)
        flags = ["--model", model, *extra, "--data_dir", str(data), "--log_dir",
                 str(tmp / "logs"), "--bf16", "--batch_size", "8", "--no-pretrained",
                 "--decode_workers", "4"]
        t0 = time.perf_counter()
        first = cli.main(flags + ["--epochs", "1"])
        t1 = time.perf_counter()
        time.sleep(1.1)  # experiment directories are stamped to the second
        second = cli.main(flags + ["--epochs", "2", "--resume", "auto"])
        t2 = time.perf_counter()
        exp1, exp2 = Path(first["exp_dir"]), Path(second["exp_dir"])
        for f in ("best_model", "latest", "training_history.json", "test_metrics_uniform.json"):
            if not (exp1 / f).exists():
                raise AssertionError(f"{label} cli run 1 wrote no {f}")
        for f in ("latest", "training_history.json", "test_metrics_uniform.json"):
            if not (exp2 / f).exists():
                raise AssertionError(f"{label} cli run 2 wrote no {f}")
        h1, h2 = first["history"], second["history"]
        if len(h2["train_loss"]) != 2 or h2["train_loss"][0] != h1["train_loss"][0] \
                or not all(math.isfinite(x) for x in h2["train_loss"] + h2["val_loss"]):
            raise AssertionError(f"resumed history {h2} does not continue {h1}")
        log(f"{label} cli --bf16: 1 epoch in {t1 - t0:.1f} s, resumed for epoch 2 in "
            f"{t2 - t1:.1f} s (8 train / 4 val / 4 test videos, checkpoints with the AdamW "
            f"state); history {h2['train_loss']} / {h2['val_loss']}; test auroc "
            f"{second['auroc']:.3f}")
        predictor = Predictor.from_checkpoint(model, exp1 / "best_model")
        if predictor.model.config.dtype != torch.float32:
            raise AssertionError("a checkpoint without a dtype must be served in f32")
        probs, per = launched(lambda: predictor.predict_clip(clips[:2]))
        if per[launch_key] != n_calls or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"predictor on the {label} cli checkpoint: {probs}, {per}")
        log(f"Predictor.from_checkpoint({model!r}, best_model) f32: {n_calls} launches of "
            f"{launch_key}, probabilities {probs.tolist()}")
        config = predictor.model.config
        saved = json.loads((exp1 / "training_config.json").read_text())
        del predictor
        return config, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def fused_qkv(shape, dtype, seed):
    """q, k, v as views of one fused (B, N, 3, H, D) tensor (TimeSformer's
    qkv projection), and an output gradient g, on the card."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fused = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
    return (*fused.unbind(2), g)


def bhnd_qkv(shape, dtype, seed):
    """q, k, v and g as (B, H, N, D) tensors transposed to (B, N, H, D)
    views (the sequence stride below the head stride), on the card."""
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
                 for _ in range(4))


def short_bound_ms(shape, dtype, backward: bool, products: int = 1, peak=None):
    """Kernel 6: two (N x N x D) products per head, q/k/v read and o written
    once (4 tensors). Kernel 7: five products, q/k/v/g read and dq/dk/dv
    written once (7 tensors). Each product counts as ``products`` products
    at ``peak`` FLOP/s (the tensor cores in bf16, the FMA units in f32,
    unless given)."""
    b, n, h, d = shape
    if backward:
        return kernel_bound_ms(b, n, n, h, d, dtype, 5 * products, 3, 4, 0, peak=peak)
    return kernel_bound_ms(b, n, n, h, d, dtype, 2 * products, 2, 2, 0, peak=peak)


def short_f32_bounds(shape, backward: bool, design: str):
    """Kernels 6-7 in f32: (bound ms, bound_by) of the design that ran,
    3xTF32 (three TF32 products a product at the TF32 peak) for
    the tensor-core designs (wgmma.tf32x3, mma.tf32x3) and the FMA units
    for fma; the other kind's bound ms; the bound ms of bf16x3, a split no
    kernel runs."""
    f32 = torch.float32
    tf32x3 = short_bound_ms(shape, f32, backward, 3, PEAK_TF32)
    fma = short_bound_ms(shape, f32, backward)
    bf16x3 = short_bound_ms(shape, f32, backward, 3, PEAK_FLOPS[torch.bfloat16])[0]
    if design in SHORT_TF32_DESIGNS:
        return (*tf32x3, fma[0], bf16x3)
    return (*fma, tf32x3[0], bf16x3)


# Kernels 6-7's bf16 designs; which design a call runs is the C side's choice
# (``launch_fwd`` / ``launch_bwd``), read back with ``short_attention.last_designs``.
SHORT_FWD_DESIGN = ("wgmma + TMA, a persistent block per SM, a (sequence, head) pair's q/k/v "
                    "resident in shared memory, one-pass whole-row softmax (64 < N <= 256); "
                    "mma.sync two-pass over streamed key tiles elsewhere")
SHORT_BWD_DESIGN = ("wgmma + TMA (64 < N <= 256, D <= 64), a persistent block per SM, a "
                    "(sequence, head) pair's q/k/v/dO resident in shared memory (K/V a pair "
                    "ahead, Q/dO 64 rows at a time): query tiles as rows (whole-row S, delta, "
                    "dQ), then key tiles as rows (dK, dV), the last chunk 16 wide; mma.sync "
                    "elsewhere")
SHORT_F32_DESIGN = ("f32 at D <= 64, positive strides, three TF32 products a product: at "
                    "1 <= N <= 64 mma.tf32x3 (short_attention_tf32_mma.cu): persistent blocks "
                    "(a producer warp; a consumer warp a 16-row tile, two in the backward, "
                    "which split the keys and the head dim), a (sequence, head) "
                    "pair whole brought in once by TMA through a ring of pair stages (2 in "
                    "the forward, 1 in the backward), mma.sync fragments split in registers "
                    "as they are read, the small terms in accumulators of their own, "
                    "whole-row S in registers, kernel 7 in one launch (S and dP once, P and "
                    "dS through shared memory for dK and dV); at 64 < N <= 256 wgmma.tf32x3 "
                    "(short_attention_tf32.cu): persistent blocks over items of two 64-row "
                    "tiles of a pair, raw f32 rows brought in 32 at a time by TMA through a "
                    "ring and split by 3 transform warps (rows form in place, T form "
                    "transposed), whole-row S in registers; kernel 7 in two launches (row "
                    "statistics and dQ; dK and dV); FMA elsewhere")
# Kernels 6-7's f32 tensor-core designs.
SHORT_TF32_DESIGNS = ("wgmma.tf32x3", "mma.tf32x3")
# Their edges (f32 only): wgmma.tf32x3 at 64 < N <= 256, D 32, 40, 64;
# mma.tf32x3 at 1 <= N <= 64 across its 16-row tiles, D 16, 32, 40, 64.
SHORT_TF32_EDGES = [(f"n{n}_d{d}", (3, n, 5, d)) for n in (65, 128, 129, 192, 197, 200, 256)
                    for d in (32, 40, 64)] + [
                    (f"n{n}_d{d}", (3, n, 5, d)) for n in (1, 2, 7, 8, 16, 31, 32, 33, 63, 64)
                    for d in (16, 32, 40, 64)]


def ptxas_lines(source: str, kernel: str) -> list:
    """The ptxas report (registers, shared memory, spills) of every
    instance of ``kernel`` in the last build of ``source``, and ptxas's
    performance advisories that name it (C75xx: a serialised wgmma
    pipeline, an ignored setmaxnreg), which it prints apart from the
    report."""
    from laryngeal_tpu_torch.ops import _build

    def instance(line):  # kernel<template arguments> from a mangled name
        m = re.search(re.escape(kernel) + r"I((?:L[ib]\d+E)+)E", line)
        return f"{kernel}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(1)))}>" if m else None

    out, keep = [], False
    for line in (_build.build_log(source) or "").splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
            if keep:
                out.append(instance(line) or line.split("'")[1][-60:])
        elif "(C75" in line and kernel in line:
            out.append("  " + line[line.index("(C75"):].strip()[:100]
                       + (f" in {instance(line)}" if instance(line) else ""))
        elif keep and ("Used" in line or "spill" in line):
            out.append("  " + line.strip()[:200])
    return out


def max_use(got, refs, limits):
    """(largest |err| / limit, largest |err|) of each tensor of ``got``."""
    uses, errs = [], []
    for x, ref, lim in zip(got, refs, limits):
        diff = (x.float() - ref.float()).abs()
        uses.append((diff / lim).max().item())
        errs.append(diff.max().item())
    return uses, errs


def check_short_kernels():
    """Phases 7 and 7b: kernels 6-7 in both dtypes, the entries' designs and
    the kept earlier ones (the _mma entries: mma.sync in bf16, FMA in f32),
    vs their plain twins on the card, across the router's domain and (f32)
    the f32 tensor-core designs' edges, each case printing the design the C
    side ran and holding it to ``design_takes``; timings at the TimeSformer-B
    shapes beside the twins, the bounds (3xTF32 where a tensor-core design
    ran), sdpa
    (single and queued), the earlier designs in turns, and kernel 1 and the
    flash training pair (the routing decision's data). Returns {entry name:
    numbers}."""
    import torch.nn.functional as F

    from laryngeal_tpu_torch.ops import flash_attention as fa
    from laryngeal_tpu_torch.ops import short_attention as sa

    for kernel in ("short_fwd_wgmma_kernel", "short_bwd_wgmma_kernel", "short_fwd_tf32_kernel",
                   "short_bwd_dq_tf32_kernel", "short_bwd_dkv_tf32_kernel",
                   "short_fwd_mma_tf32_kernel", "short_bwd_mma_tf32_kernel"):
        for line in ptxas_lines("short_attention.cu", kernel):
            log(f"ptxas {line}")
    entries = {"short_attention_fwd": {}, "short_attention_bwd": {}}
    worst = {"short_attention_fwd": [0.0, 0.0], "short_attention_bwd": [0.0, 0.0]}
    # (name, (B, N, H, D), layout): the TimeSformer-B shapes, then N in
    # 1..511 and D in 16..128 (40 is padded to 48 inside the wrapper), odd
    # B*H; the wgmma designs' edges (N = 65, 256, D = 32, 128), kernel 7's at
    # D = 64 and D = 32, on fused-qkv views and on transposed (B, H, N, D).
    cases = [(name, shape, "fused") for name, shape in TS_SHAPES.items()] + [
        ("n1_d64", (3, 1, 5, 64), "fused"), ("n5_d16", (5, 5, 3, 16), "fused"),
        ("n33_d40", (3, 33, 5, 40), "fused"), ("n300_d128", (1, 300, 3, 128), "fused"),
        ("n511_d64", (1, 511, 3, 64), "fused"), ("n511_d128", (3, 511, 1, 128), "fused"),
        ("n100_d16", (7, 100, 3, 16), "fused"), ("n65_d32", (3, 65, 5, 32), "fused"),
        ("n256_d128", (3, 256, 1, 128), "fused")] + [
        (f"{name}_{layout}", shape, layout)
        for name, shape in (("n65_d64", (3, 65, 5, 64)), ("n128_d64", (3, 128, 5, 64)),
                            ("n129_d64", (3, 129, 5, 64)), ("n192_d64", (3, 192, 5, 64)),
                            ("n256_d64", (1, 256, 5, 64)), ("n197_d32", (3, 197, 5, 32)))
        for layout in ("fused", "bhnd")]
    f32_edges = [(f"{name}_{layout}", shape, layout) for name, shape in SHORT_TF32_EDGES
                 for layout in ("fused", "bhnd")]
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        earlier = "mma.sync" if dtype == torch.bfloat16 else "FMA"
        for seed, (name, shape, layout) in enumerate(
                cases + (f32_edges if dtype == torch.float32 else [])):
            q, k, v, g = (fused_qkv if layout == "fused" else bhnd_qkv)(shape, dtype, 30 + seed)
            ref = sa.short_attention_plain(q, k, v)
            limit = sa.error_limit(q, k, v, ref, F32_TOL)
            diff = (sa.short_attention_fwd_cuda(q, k, v).float() - ref.float()).abs()
            use_f = (diff / limit).max().item()
            err_f = diff.max().item()
            design_f = sa.last_designs()[0]
            # The earlier design (the _mma entry: mma.sync in bf16, FMA in f32)
            # under the same limit.
            use_old = ((sa.short_attention_fwd_mma_cuda(q, k, v).float() - ref.float()).abs()
                       / limit).max().item()
            del diff, ref, limit
            refs = sa.short_attention_plain_bwd(q, k, v, g)
            limits = sa.backward_error_limit(q, k, v, g, refs)
            uses, errs = max_use(sa.short_attention_bwd_cuda(q, k, v, g), refs, limits)
            design_b = sa.last_designs()[1]
            uses_old, _ = max_use(sa.short_attention_bwd_mma_cuda(q, k, v, g), refs, limits)
            del refs, limits
            # The design each entry ran is the one the C side's rule names
            # (every layout here has positive strides).
            want = tuple(sa.design_takes(w, shape[1], shape[3], dtype) for w in (0, 1))
            ok = (max([use_f, use_old] + uses + uses_old) <= 1.0
                  and all(math.isfinite(x) for x in [err_f] + errs)
                  and (design_f, design_b) == want)
            log(f"short attention {name} {shape} {tag}: fwd ({design_f}) max_abs_err "
                f"{err_f:.3e} (|err|/limit {use_f:.3f}; {earlier} design {use_old:.3f}); bwd "
                f"({design_b}) dq/dk/dv max_abs_err {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, "
                f"|err|/limit {uses[0]:.3f}/{uses[1]:.3f}/{uses[2]:.3f} ({earlier} design "
                f"{max(uses_old):.3f}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernels 6-7 disagree with their plain twins or ran "
                                     f"another design than {want}: {name} {tag}")
            if dtype == torch.bfloat16:
                for e, (err, use) in (("short_attention_fwd", (err_f, use_f)),
                                      ("short_attention_bwd", (max(errs), max(uses)))):
                    worst[e] = [max(worst[e][0], err), max(worst[e][1], use)]
            if name not in TS_SHAPES:
                del q, k, v, g
                continue
            # Each kernel and its earlier design in turns (old, new, new,
            # old), single calls and queued (the card's time; see
            # cuda_time_ms), each time beside sdpa.
            t6 = turns_ms({"old": lambda: sa.short_attention_fwd_mma_cuda(q, k, v),
                           "new": lambda: sa.short_attention_fwd_cuda(q, k, v)})
            t7 = turns_ms({"old": lambda: sa.short_attention_bwd_mma_cuda(q, k, v, g),
                           "new": lambda: sa.short_attention_bwd_cuda(q, k, v, g)})
            sa.short_attention_fwd_cuda(q, k, v)
            sa.short_attention_bwd_cuda(q, k, v, g)
            design6, design7 = sa.last_designs()
            plain6 = cuda_time_ms(lambda: sa.short_attention_plain(q, k, v), reps=3, warmup=1)
            plain7 = cuda_time_ms(lambda: sa.short_attention_plain_bwd(q, k, v, g), reps=3,
                                  warmup=1)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            gt = g.transpose(1, 2)
            lib6 = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            lib6_q = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=20,
                                  queued=True)
            lib_out = F.scaled_dot_product_attention(qt, kt, vt)
            lib7_fn = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt, retain_graph=True)
            lib7 = cuda_time_ms(lib7_fn)
            lib7_q = cuda_time_ms(lib7_fn, reps=20, queued=True)
            del lib_out, lib7_fn, qt, kt, vt, gt
            # 7b: what the flash kernels cost at the same shape.
            ms1 = cuda_time_ms(lambda: fa.flash_attention_cuda(q, k, v))
            ms2 = cuda_time_ms(lambda: fa.flash_attention_lse_cuda(q, k, v))
            o, lse = fa.flash_attention_lse_cuda(q, k, v)
            ms34 = cuda_time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, g))
            del o, lse
            log(f"routing data {name} {shape} {tag}: forward kernel 6 {t6['new']:.4f} ms vs "
                f"kernel 1 {ms1:.4f} ms; training forward kernel 6 {t6['new']:.4f} vs kernel 2 "
                f"{ms2:.4f} ms; backward kernel 7 {t7['new']:.4f} vs delta + kernels 3-4 "
                f"{ms34:.4f} ms")
            for e, t, plain_ms, lib_ms, lib_q, design, backward in (
                    ("short_attention_fwd", t6, plain6, lib6, lib6_q, design6, False),
                    ("short_attention_bwd", t7, plain7, lib7, lib7_q, design7, True)):
                extra = ""
                if dtype == torch.bfloat16:
                    bound_ms, bound_by = short_bound_ms(shape, dtype, backward)
                else:
                    bound_ms, bound_by, other, bf16x3 = short_f32_bounds(shape, backward, design)
                    tc = design in SHORT_TF32_DESIGNS
                    extra = (f" ({TF32X3_BOUND if tc else 'FMA, 67 TFLOP/s'}"
                             f"; the {'FMA' if tc else '3xTF32'} bound "
                             f"{other:.4f} ms, {BF16X3_BOUND} {bf16x3:.4f} ms)")
                ms = t["new"]
                numbers = dict(shape=list(shape), ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                               queued_ms=t["new_q"], old_ms=t["old"], old_queued_ms=t["old_q"],
                               library_queued_ms=lib_q, design=design)
                if backward:
                    numbers["flash_bwd_ms"] = ms34
                else:
                    numbers.update(flash_fwd_ms=ms1, flash_fwd_lse_ms=ms2)
                log(f"{e} {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
                    f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}){extra}, "
                    f"{bound_ms / ms:.3f} of the bound; design {design}, the earlier {earlier} "
                    f"design {t['old']:.4f} ms ({t['old'] / ms:.2f}x); queued: kernel "
                    f"{t['new_q']:.4f}, earlier design {t['old_q']:.4f} "
                    f"({t['old_q'] / t['new_q']:.2f}x), sdpa {lib_q:.4f} ms, "
                    f"{bound_ms / t['new_q']:.3f} of the bound")
                key = name if dtype == torch.bfloat16 else f"{name}_f32"
                entries[e][key] = numbers
            del q, k, v, g
            torch.cuda.empty_cache()
    tol = ("bf16: short_attention.error_limit / backward_error_limit (one-ulp bf16 rounding "
           f"flips, elementwise); f32: {F32_TOL:g} (o), F32_REL*A (grads)")
    for e, nums in entries.items():
        # The line's headline numbers: the spatial call in bf16, the larger of
        # the two; the temporal call and f32 stay under their own keys.
        nums.update({k: v for k, v in nums["spatial"].items() if k != "shape"})
        nums.update(max_abs_err=worst[e][0], err_over_limit=worst[e][1], tol=tol,
                    headline="spatial (256, 197, 12, 64) bf16")
    for e, text in (("short_attention_fwd", SHORT_FWD_DESIGN),
                    ("short_attention_bwd", SHORT_BWD_DESIGN)):
        entries[e]["design"] = f"{entries[e]['design']} at spatial; {text}; {SHORT_F32_DESIGN}"
    return entries


def timesformer_b(dtype, seed=0):
    from laryngeal_tpu_torch.models.timesformer import create_timesformer

    return create_timesformer(num_classes=2, num_frames=32, image_size=224, dtype=dtype,
                              seed=seed)


def serving_phase(name: str, label: str, make_model, launch_key: str, calls, flops, seed: int,
                  design_key: str = "") -> dict:
    """A model's serving path on the card at full width (TimeSformer-B, phase 8;
    Swin3D-T, phase 12): a 32-frame 224^2 Predictor in bf16 with seeded
    weights on a (8, 32, 224, 224, 3) uint8 batch: probabilities finite and
    summing to 1, exactly ``calls(model)`` launches of ``launch_key`` (in bf16
    all of them counted under ``design_key`` too, when given) and none of any
    other kernel per forward, logits against the same model on the
    plain attention in bf16 and (two clips) f32, the forward's device time by
    kernel, an InferenceServer round trip. Returns each kernel's launches
    since the counts were set to 0."""
    from laryngeal_tpu_torch.infer.predictor import Predictor
    from laryngeal_tpu_torch.models.registry import get_model_spec
    from laryngeal_tpu_torch.ops import attention as att
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.serve.server import InferenceServer

    spec = get_model_spec(name)
    regime = spec.preprocess_regime
    model = make_model(torch.bfloat16)
    predictor = Predictor(model, spec, num_frames=32, crop_size=224, device="cuda")
    want_f32 = {k: 0 for k in launch_counts()}
    want_f32[launch_key] = calls(model)
    want = dict(want_f32, **({design_key: calls(model)} if design_key else {}))
    clips = np.random.default_rng(seed).integers(0, 256, (8, 32, 224, 224, 3), dtype=np.uint8)

    probs, per_forward = launched(lambda: predictor.predict_clip(clips))
    if per_forward != want:
        raise AssertionError(f"launches per {label} forward {per_forward}, want {want}")
    if probs.shape != (8, 2) or not np.isfinite(probs).all() \
            or not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad probabilities {probs}")
    with torch.inference_mode():
        clips_dev = torch.from_numpy(clips).cuda()
        pixel = batch_preprocess(clips_dev, regime, crop=224)
        preprocess_ms = cuda_time_ms(lambda: batch_preprocess(clips_dev, regime, crop=224),
                                     reps=5, warmup=1)
        logits, per_model = launched(lambda: model(pixel))
        if per_model != want:
            raise AssertionError(f"launches per {label} forward {per_model}, want {want}")
        att.set_attention_impl("plain")
        try:
            logits_plain = model(pixel)
        finally:
            att.set_attention_impl(None)
        forward_ms = cuda_time_ms(lambda: model(pixel), reps=5, warmup=1)
        parts = launch_breakdown(lambda: model(pixel))
    check_logits("bf16", logits, logits_plain, LOGIT_TOL[torch.bfloat16], label)
    total = sum(parts.values())
    log(f"{label} forward device time (torch.profiler): {total:.2f} ms in kernels; top: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])[:10]))
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        predictor.predict_clip(clips)
    e2e_s = (time.perf_counter() - t0) / reps
    ops = flops(model)
    log(f"{label} 32f 224 bf16 B=8: preprocess {preprocess_ms:.2f} ms, forward "
        f"{forward_ms:.2f} ms (model only; {ops:.4e} model operations = "
        f"{ops / (forward_ms * 1e-3) / 989e12:.4f} of 989 TFLOP/s), predict_clip "
        f"{e2e_s * 1e3:.2f} ms -> {8 / e2e_s:.2f} clips/s (uint8 host batch -> probabilities "
        f"on the host); launches per forward {per_forward}")

    # The same weights in f32 (no dtype in a checkpoint's metadata), two clips.
    model_f32 = make_model(torch.float32)
    pred_f32 = Predictor(model_f32, spec, num_frames=32, crop_size=224, device="cuda")
    probs_f32, per_f32 = launched(lambda: pred_f32.predict_clip(clips[:2]))
    if per_f32 != want_f32 or not np.isfinite(probs_f32).all() \
            or not np.allclose(probs_f32.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"f32 {label} predictor: {probs_f32}, launches {per_f32}")
    with torch.inference_mode():
        logits_f32 = model_f32(pixel[:2])
        att.set_attention_impl("plain")
        try:
            logits_f32_plain = model_f32(pixel[:2])
        finally:
            att.set_attention_impl(None)
    check_logits("f32", logits_f32, logits_f32_plain, LOGIT_TOL[torch.float32], label)
    log(f"{label} bf16 logits vs the f32 model (2 clips): kernel "
        f"{(logits[:2] - logits_f32_plain).abs().max().item():.3e}, plain attention "
        f"{(logits_plain[:2] - logits_f32_plain).abs().max().item():.3e}")
    del pred_f32, model_f32, pixel, clips_dev
    torch.cuda.empty_cache()

    server = InferenceServer(predictor, port=0, max_batch=8, batch_timeout_ms=50)
    thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health.get("status") != "ok" or health.get("model") != name:
            raise AssertionError(f"/healthz: {health}")
        t0 = time.perf_counter()
        futures = [server.batcher.submit(clips[i]) for i in range(3)]
        rows = np.stack([f.result(timeout=300) for f in futures])
        serve_s = time.perf_counter() - t0
    finally:
        server.close()
        thread.join(timeout=10)
    if not np.isfinite(rows).all() or not np.allclose(rows.sum(-1), 1.0, atol=1e-5):
        raise AssertionError("server returned bad probabilities")
    np.testing.assert_allclose(rows, probs[:3], atol=2e-2)
    log(f"{label} server: /healthz ok, 3 clips in {serve_s * 1e3:.1f} ms")
    return launch_counts()


def timesformer_serving() -> dict:
    """Phase 8: the TimeSformer-B serving path (24 launches of kernel 6 a
    forward)."""
    return serving_phase("timesformer", "timesformer-b", timesformer_b, "short_attention_fwd",
                         lambda m: 2 * m.config.num_layers,
                         lambda m: timesformer_forward_flops(m.config, 8), seed=3)


def timesformer_forward_flops(cfg, batch: int) -> float:
    """Model operations of one forward: the per-frame patch embedding, per
    layer the temporal (qkv, out, temporal_dense) and spatial (qkv, out)
    projections, the MLP, and both attentions' two products."""
    d, inter, t = cfg.hidden_size, cfg.intermediate_size, cfg.num_frames
    n = cfg.num_spatial_patches
    tokens = n * t + 1
    embed = 2.0 * n * t * 3 * cfg.patch_size ** 2 * d
    dense = (2.0 * n * t * d * (3 * d + d + d) + 2.0 * (n + 1) * t * d * (3 * d + d)
             + 2.0 * tokens * d * inter * 2)
    attn = 4.0 * (n * t * t + t * (n + 1) ** 2) * d
    return batch * (embed + cfg.num_layers * (dense + attn))


def timesformer_f32_path(pixel_u8, labels, mask, f32_kernel_ms: dict, n_calls: int) -> None:
    """Phase 9's f32 part: TimeSformer-B at B=8 in f32, the compute dtype of
    the training CLI without ``--bf16``: the forward (model only, CUDA
    events, median of 5) and its logits against the same model on the
    plain attention, then the train step (host clock around a synchronised
    step, median of 3 after a warm-up), each with kernels 6-7's launches by
    design (the spatial calls on wgmma.tf32x3, the temporal ones on
    mma.tf32x3) and
    their share from phase 7's f32 times (``f32_kernel_ms``: {shape:
    (kernel 6 ms, kernel 7 ms)})."""
    from laryngeal_tpu_torch.ops import attention as att
    from laryngeal_tpu_torch.ops import short_attention as sa
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    b, half = pixel_u8.shape[0], n_calls // 2
    by_design = {"short_attention_fwd": sa.fwd_design_launches,
                 "short_attention_bwd": sa.bwd_design_launches}
    split = {"wgmma.tf32x3": half, "mma.tf32x3": half}
    model = timesformer_b(torch.float32).cuda().eval()
    pixel = batch_preprocess(pixel_u8, "timesformer", crop=224)
    with torch.no_grad():
        logits, fwd_designs = design_deltas(lambda: model(pixel), by_design)
        fwd_ms = cuda_time_ms(lambda: model(pixel), reps=5, warmup=1)
        att.set_attention_impl("plain")
        try:
            logits_plain = model(pixel)
        finally:
            att.set_attention_impl(None)
    check_logits("f32 B=8", logits, logits_plain, LOGIT_TOL[torch.float32], "timesformer-b")
    want_fwd = {"short_attention_fwd": split, "short_attention_bwd": {}}
    if fwd_designs != want_fwd:
        raise AssertionError(f"f32 TimeSformer-B forward: kernels 6-7 by design {fwd_designs}, "
                             f"want {want_fwd}")
    k6 = half * sum(ms[0] for ms in f32_kernel_ms.values())
    k7 = half * sum(ms[1] for ms in f32_kernel_ms.values())
    by_shape = {name: tuple(half * x for x in ms) for name, ms in f32_kernel_ms.items()}
    log(f"timesformer-b 32f 224 f32 B={b} forward: {fwd_ms:.2f} ms (model only, CUDA events, "
        f"median of 5); kernel 6 by design {fwd_designs['short_attention_fwd']}, {k6:.2f} ms "
        f"over the {n_calls} calls = {k6 / fwd_ms:.3f} of the forward (spatial on "
        f"wgmma.tf32x3 {by_shape['spatial'][0]:.2f} ms, temporal on mma.tf32x3 "
        f"{by_shape['temporal'][0]:.2f} ms)")
    del pixel, logits, logits_plain
    model.train()
    state = create_train_state(model, "adamw", 1e-4, 0.01)
    step = make_train_step(model, "timesformer", "ce", crop=224)
    ((state, m), per_step), designs = design_deltas(
        lambda: launched(lambda: step(state, pixel_u8, labels, mask)), by_design)
    want = {k: 0 for k in per_step}
    want.update(short_attention_fwd=n_calls, short_attention_bwd=n_calls)
    want_designs = {e: split for e in by_design}
    if per_step != want or designs != want_designs:
        raise AssertionError(f"f32 TimeSformer-B train step: launches {per_step}, by design "
                             f"{designs}; want {want}, {want_designs}")
    times, losses = [], [m["loss"].item()]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, pixel_u8, labels, mask)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite f32 loss {losses}")
    step_ms = float(np.median(times))
    log(f"timesformer-b 32f 224 f32 B={b} train step: {step_ms:.2f} ms (median of 3 after a "
        f"warm-up, host clock) -> {b / step_ms * 1e3:.2f} clips/s, peak memory "
        f"{peak / 2**30:.2f} GiB; kernels 6-7 by design {designs}; kernel 6 {k6:.2f} ms + "
        f"kernel 7 {k7:.2f} ms a step = {k6 / step_ms:.3f} + {k7 / step_ms:.3f} of the step "
        f"(kernel 7 spatial {by_shape['spatial'][1]:.2f}, temporal {by_shape['temporal'][1]:.2f}"
        f" ms); losses {losses}")
    del state, step, model, m
    torch.cuda.empty_cache()


def timesformer_training(kernel_ms: dict, f32_kernel_ms: dict) -> None:
    """Phases 9 and 10: the TimeSformer-B training path on the card (bf16,
    then f32: ``timesformer_f32_path``), and the training CLI."""
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.train.losses import cross_entropy
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_eval_step, make_train_step

    b = 8
    model = timesformer_b(torch.bfloat16).cuda()
    n_calls = 2 * model.config.num_layers
    state = create_train_state(model, "adamw", 1e-4, 0.01)
    step = make_train_step(model, "timesformer", "ce", crop=224)
    eval_step = make_eval_step(model, "timesformer", "ce", crop=224)
    rng = np.random.default_rng(4)
    clips = rng.integers(0, 256, (b, 32, 224, 224, 3), dtype=np.uint8)
    labels = torch.from_numpy(rng.integers(0, 2, b)).cuda()
    mask = torch.ones(b, dtype=torch.bool, device="cuda")
    pixel_u8 = torch.from_numpy(clips).cuda()

    # -- phase 9: launches per step (kernel 7's by design: the spatial calls
    # on wgmma, the temporal ones on mma.sync), loss, timing --
    from laryngeal_tpu_torch.ops import short_attention as sa

    designs_before = dict(sa.bwd_design_launches)
    (state, m), per_step = launched(lambda: step(state, pixel_u8, labels, mask))
    want = {k: 0 for k in per_step}
    want.update(short_attention_fwd=n_calls, short_attention_bwd=n_calls)
    if per_step != want:
        raise AssertionError(f"launches per TimeSformer train step {per_step}, want {want}")
    per_design = {d: sa.bwd_design_launches[d] - designs_before[d] for d in sa.DESIGNS}
    want_design = {d: 0 for d in sa.DESIGNS}
    want_design.update({"mma.sync": n_calls // 2, "wgmma": n_calls // 2})
    if per_design != want_design:
        raise AssertionError(f"kernel 7's launches by design per TimeSformer train step "
                             f"{per_design}, want {want_design}")
    em, per_eval = launched(lambda: eval_step(state, pixel_u8, labels, mask))
    want_eval = {k: (n_calls if k == "short_attention_fwd" else 0) for k in want}
    if per_eval != want_eval:
        raise AssertionError(f"launches per TimeSformer eval step {per_eval}, want {want_eval}")
    log(f"timesformer launches per train step {per_step} (kernel 7 by design {per_design}); "
        f"per eval step {per_eval}")
    for _ in range(2):
        step(state, pixel_u8, labels, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    losses = [step(state, pixel_u8, labels, mask)[1]["loss"] for _ in range(reps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in [m["loss"], em["loss"]] + losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    flops = 3.0 * timesformer_forward_flops(model.config, b)
    log(f"timesformer-b 32f 224 bf16 B=8 train step: {step_s * 1e3:.2f} ms -> "
        f"{b / step_s:.2f} clips/s (uint8 batch on the card -> updated weights), peak memory "
        f"{peak / 2**30:.2f} GiB, model operations {flops:.4e} per step = "
        f"{flops / step_s / 989e12:.4f} of 989 TFLOP/s; losses {losses}")

    pre_ms = cuda_time_ms(lambda: batch_preprocess(pixel_u8, "timesformer", crop=224), reps=3)
    stages = []
    model.train()
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        pixel = batch_preprocess(pixel_u8, "timesformer", crop=224)
        ev[0].record()
        loss = cross_entropy(model(pixel), labels, mask)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        stages.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd_ms, bwd_ms, opt_ms = np.median(np.asarray(stages[1:]), axis=0)
    attn_ms = model.config.num_layers * sum(kernel_ms.values())
    log(f"timesformer train step stages (bf16 B=8): preprocess {pre_ms:.2f} ms, forward+loss "
        f"{fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, optimizer {opt_ms:.2f} ms; attention "
        f"kernels {model.config.num_layers} x "
        f"({' + '.join(f'{k} {v:.4f}' for k, v in kernel_ms.items())}) = {attn_ms:.2f} ms = "
        f"{attn_ms / (step_s * 1e3):.3f} of the step")
    del state, step, eval_step, model, m, em, loss, pixel
    torch.cuda.empty_cache()
    timesformer_f32_path(pixel_u8, labels, mask, f32_kernel_ms, n_calls)

    pixel2 = batch_preprocess(pixel_u8[:2], "timesformer", crop=224)
    for dtype in (torch.float32, torch.bfloat16):
        grad_check(lambda dt: timesformer_b(dt, seed=1), pixel2, labels[:2], dtype,
                   timesformer_key_free, "timesformer-b")
    del pixel_u8, pixel2
    torch.cuda.empty_cache()

    # -- phase 10: the training CLI, then the predictor on its checkpoint --
    config, _ = cli_phase("timesformer", [], 1, "short_attention_fwd", n_calls, clips,
                          "timesformer-b")
    if config.num_frames != 32:
        raise AssertionError("the timesformer checkpoint must be served at 32 frames")


# Swin3D-T 32f 224^2 at B=8: each stage's window attention call, (B·nW, N, H,
# D), its patch grid (T, H, W) and its blocks. The windows are (8, 7, 7) and
# the shifted blocks' region ids come from the model's own helpers.
SWIN_STAGES = {1: ((1024, 392, 3, 32), (16, 56, 56), 2), 2: ((256, 392, 6, 32), (16, 28, 28), 2),
               3: ((64, 392, 12, 32), (16, 14, 14), 6), 4: ((16, 392, 24, 32), (16, 7, 7), 2)}


def stage_region_ids(grid):
    """The (nW, N) region ids of a shifted block on ``grid`` (the model's
    own ``adjust_window`` and ``shift_region_ids``), on the card."""
    from laryngeal_tpu_torch.models.swin3d import adjust_window, shift_region_ids

    window, shift = adjust_window(grid, (8, 7, 7), (4, 3, 3))
    return torch.from_numpy(shift_region_ids(grid, window, shift)).cuda()


def window_bound_ms(shape, dtype, backward: bool, rid, products: int = 1, peak=None):
    """Kernel 8 (and 11, 12): two (N x N x D) products per (window, head);
    q, k, v read and o written once, the f32 (H, N, N) bias read once.
    Kernel 9: five products; q, k, v, g read and dq, dk, dv written once,
    the bias read and dbias written once (f32). A shifted block's (nW, N)
    int32 region ids are read once; an unshifted block (``rid`` None) reads
    none. Each product counts as ``products`` products at ``peak`` FLOP/s
    (the tensor cores in bf16, the FMA units in f32, unless given)."""
    b, n, h, d = shape
    rid_bytes = 0 if rid is None else rid.numel() * rid.element_size()
    bias_bytes = h * n * n * 4 * (2 if backward else 1) + rid_bytes
    flops = 2.0 * products * (5 if backward else 2) * b * h * n * n * d
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (7 if backward else 4) * b * n * h * d * size + bias_bytes
    t_ops, t_bytes = flops / (peak or PEAK_FLOPS[dtype]), nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def window_f32_bounds(shape, backward: bool, rid):
    """Kernels 8-9 in f32: (bound ms, bound_by) of 3xTF32 (three TF32
    products a product at the TF32 peak: the wgmma.tf32x3 design's work);
    the FMA design's bound ms; the bound ms of bf16x3, a split no kernel
    runs."""
    f32 = torch.float32
    return (*window_bound_ms(shape, f32, backward, rid, 3, PEAK_TF32),
            window_bound_ms(shape, f32, backward, rid)[0],
            window_bound_ms(shape, f32, backward, rid, 3, PEAK_FLOPS[torch.bfloat16])[0])


def launch_breakdown(fn, reps: int = 3) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            key = e.key.replace("(anonymous namespace)::", "")
            name = key.split("(")[0].split("<")[0].split("::")[-1].replace("void ", "").strip()
            out[name] = out.get(name, 0.0) + e.device_time_total / reps / 1e3
    return out


def window_inputs(shape, dtype, seed, layout="fused"):
    """q, k, v (views of a fused qkv, or of (B·nW, H, N, D) tensors
    transposed: ``layout`` "bhnd"), g, and a unit-normal f32 bias."""
    q, k, v, g = (fused_qkv if layout == "fused" else bhnd_qkv)(shape, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    bias = torch.randn((shape[2], shape[1], shape[1]), generator=gen, device="cuda")
    return q, k, v, g, bias


def sdpa_bias(bias, rid, bw, dtype):
    """The materialised (B·nW, H, N, N) bias the library call takes: the
    table gather plus -100 across region boundaries, in the compute dtype."""
    from laryngeal_tpu_torch.ops import window_attention as wa

    h, n = bias.shape[0], bias.shape[1]
    full = bias[None].expand(bw, h, n, n)
    if rid is not None:
        nw = rid.shape[0]
        m = wa.region_mask(rid).float() * wa.MASK_VALUE
        full = (full.view(bw // nw, nw, h, n, n) + m[None, :, None]).reshape(bw, h, n, n)
    return full.to(dtype).contiguous()


# Kernels 8-9's wgmma design (window_attention_wgmma.cu); which design a call
# runs is the C side's choice, read back with ``window_attention.last_designs``.
WINDOW_FWD_DESIGN = ("wgmma + TMA (bf16, N <= 400, D <= 32): a block an SM per (head, 64-query "
                     "tile, window group) holding the tile's f32 bias rows, K/V whole a window "
                     "two stages deep, two consumer warpgroups splitting the keys (200 + 200), "
                     "one pass of S with the row max and sum exchanged; mma.sync elsewhere")
WINDOW_BWD_DESIGN = ("wgmma + TMA (bf16, N <= 400, D <= 32), two passes of S: a dQ launch "
                     "(bias rows held, keys split, row statistics written) and a dK/dV launch "
                     "(a (head, 64-key tile)'s bias columns held, queries split, Q/dO chunks "
                     "through a ring, dbias summed in registers over the window group), then "
                     "the groups' dbias sum; mma.sync elsewhere")
WINDOW_F32_DESIGN = ("f32 at the same shapes wgmma.tf32x3: a pre-pass splits q, k, v (dO) into "
                     "big + small TF32 parts once a call, K^T, V^T, Q^T, dO^T written "
                     "transposed; the bf16 design's blocks with K/V (Q/dO) streamed in 64-key "
                     "(32-query) chunks through a ring, three TF32 products a product, each "
                     "chunk's P V (ds K) added to O (dQ) on the FMA units; FMA elsewhere")


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reads it in this run."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def window_exp_estimate_ms(shape, clock_hz: float) -> float:
    """An estimate, not a bound: one pass over S, B·nW·H·N² exponentials,
    on the special-function units alone (16 a clock an SM, every SM at
    ``clock_hz``). Exponentials can also run on the FMA units, so a design
    may go below it."""
    b, n, h, _ = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * h * n * n / (16 * sms * clock_hz) * 1e3


def window_rid(grid, n, seed):
    """The region ids of a case: None, a shifted stage's own (``grid`` a
    patch grid), or random ones ("randK": K windows of N ids in 0..3)."""
    if grid is None:
        return None
    if isinstance(grid, str):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randint(0, 4, (int(grid[4:]), n), generator=gen, device="cuda",
                             dtype=torch.int32)
    return stage_region_ids(grid)


def check_window_kernels():
    """Phase 11: kernels 8-9 in both bf16 designs (the entries' and the kept
    mma.sync one, ``window_attention_*_mma_cuda``) vs their plain twins at the
    four Swin3D-T stage shapes, shifted and unshifted, at the wgmma design's
    edges (N = 8, 56, 144, 145, 200, 272, 392 with one window id row, 400,
    448 at D = 32, N = 273 at D = 24, N = 392 at D = 64; fused-qkv and
    transposed views), at other held shapes (N % 8
    != 0, D 64 and 128) and at the wide path's, f32 and bf16; dq, dk, dv and
    dbias elementwise; each case in the design the C side should pick
    (``window_attention.design_takes``), and bitwise the same on a second
    call. Timings at each stage shape (shifted) in bf16: both designs in
    turns, single calls and queued, beside the bound (and, in the log, an
    estimate of one pass of exponentials), the twins and sdpa with the materialised bias (forward, and the autograd
    backward with the mask's gradient), and the new backward's per-launch
    split. Returns {entry: numbers}."""
    import torch.nn.functional as F

    from laryngeal_tpu_torch.ops import window_attention as wa

    for kernel in ("window_fwd_wgmma_kernel", "window_bwd_dq_wgmma_kernel",
                   "window_bwd_dkv_wgmma_kernel", "window_fwd_tf32_kernel",
                   "window_bwd_dq_tf32_kernel", "window_bwd_dkv_tf32_kernel",
                   "tf32_split_kernel"):
        for line in ptxas_lines("window_attention.cu", kernel):
            log(f"ptxas {line}")
    entries = {"window_attention_fwd": {}, "window_attention_bwd": {}}
    worst = {e: [0.0, 0.0] for e in entries}
    clock_hz = sm_clock_hz()
    cases = []
    for stage, (shape, grid, _) in SWIN_STAGES.items():
        cases.append((f"stage{stage}", shape, grid, "fused"))
        cases.append((f"stage{stage}_unshifted", shape, None, "fused"))
    cases += [(f"edge_{name}_{layout}", shape, grid, layout)
              for name, shape, grid in (("n8", (6, 8, 3, 32), "rand2"),
                                        ("n56", (6, 56, 3, 32), "rand3"),
                                        ("n144", (6, 144, 3, 32), "rand3"),
                                        ("n145", (6, 145, 3, 32), "rand3"),
                                        ("n200", (6, 200, 3, 32), None),
                                        ("n272", (4, 272, 3, 32), "rand2"),
                                        ("n273_d24", (4, 273, 3, 24), "rand1"),
                                        ("n392_nw1", (4, 392, 3, 32), "rand1"),
                                        ("n400", (4, 400, 3, 32), "rand2"),
                                        ("n448", (4, 448, 3, 32), "rand2"),
                                        ("n392_d64", (4, 392, 3, 64), "rand2"))
              for layout in ("fused", "bhnd")]
    cases += [("n245_nw4", (64, 245, 4, 32), "rand4", "fused"),
              ("n100_d64", (32, 100, 6, 64), "rand4", "fused"),
              ("n27_d128", (12, 27, 2, 128), "rand3", "fused"),
              ("n1_d16", (4, 1, 3, 16), None, "fused"),
              ("n448_d40", (2, 448, 2, 40), "rand1", "fused"),
              # the wide path: shapes JAX's Pallas kernel takes beyond N <= 448, D <= 128
              ("wide_n512_d32", (8, 512, 3, 32), "rand2", "fused"),
              ("wide_n784_d32", (4, 784, 3, 32), None, "fused"),
              ("wide_n392_d192", (4, 392, 2, 192), "rand2", "fused"),
              ("wide_n392_d256", (2, 392, 2, 256), None, "fused")]
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for seed, (name, shape, grid, layout) in enumerate(cases):
            q, k, v, g, bias = window_inputs(shape, dtype, 40 + seed, layout)
            rid = window_rid(grid, shape[1], seed)
            want = wa.design_takes(shape[1], shape[3], dtype)
            ref = wa.window_attention_plain(q, k, v, bias, rid)
            limit = wa.error_limit(q, k, v, bias, rid, ref, f32_tol=F32_TOL)
            out = wa.window_attention_fwd_cuda(q, k, v, bias, rid)
            design_f = wa.last_designs()[0]
            same_f = torch.equal(out, wa.window_attention_fwd_cuda(q, k, v, bias, rid))
            diff = (out.float() - ref.float()).abs()
            use_f, err_f = (diff / limit).max().item(), diff.max().item()
            # The kept mma.sync design under the same limit.
            use_f_old = ((wa.window_attention_fwd_mma_cuda(q, k, v, bias, rid).float()
                          - ref.float()).abs() / limit).max().item()
            del diff, out, ref, limit
            refs = wa.window_attention_plain_bwd(q, k, v, bias, rid, g)
            limits = wa.backward_error_limit(q, k, v, bias, rid, g, refs)
            grads = wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)
            design_b = wa.last_designs()[1]
            same_b = all(torch.equal(a, b) for a, b in
                         zip(grads, wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)))
            uses, errs = max_use(grads, refs, limits)
            uses_old, _ = max_use(wa.window_attention_bwd_mma_cuda(q, k, v, bias, rid, g), refs,
                                  limits)
            del grads, refs, limits
            torch.cuda.empty_cache()
            ok = (max([use_f, use_f_old] + uses + uses_old) <= 1.0
                  and all(math.isfinite(x) for x in [err_f] + errs)
                  and (design_f, design_b) == (want, want) and same_f and same_b)
            log(f"window attention {name} {shape} nW={None if rid is None else rid.shape[0]} "
                f"{tag} ({design_f}/{design_b}, want {want}): fwd max_abs_err {err_f:.3e} "
                f"(|err|/limit {use_f:.3f}; the _mma entry {use_f_old:.3f}); dq/dk/dv/dbias "
                f"max_abs_err {'/'.join(f'{e:.3e}' for e in errs)}, |err|/limit "
                f"{'/'.join(f'{u:.3f}' for u in uses)} (the _mma entry "
                f"{max(uses_old):.3f}); bitwise repeatable {same_f and same_b} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernels 8-9 disagree with their plain twins or ran "
                                     f"another design: {name} {tag}")
            if dtype == torch.bfloat16:
                for e, (err, use) in (("window_attention_fwd", (err_f, use_f)),
                                      ("window_attention_bwd", (max(errs), max(uses)))):
                    worst[e] = [max(worst[e][0], err), max(worst[e][1], use)]
            if not (name.startswith("stage") and not name.endswith("unshifted")):
                del q, k, v, g, bias, rid
                continue
            # Both designs in turns (old, new, new, old), single calls and
            # queued (the card's time; see cuda_time_ms), beside sdpa: the
            # _mma entries run mma.sync in bf16 and the FMA kernels in f32.
            f8 = lambda: wa.window_attention_fwd_cuda(q, k, v, bias, rid)
            f9 = lambda: wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)
            t8 = turns_ms({"old": lambda: wa.window_attention_fwd_mma_cuda(q, k, v, bias, rid),
                           "new": f8})
            t9 = turns_ms({"old": lambda: wa.window_attention_bwd_mma_cuda(q, k, v, bias, rid, g),
                           "new": f9})
            parts = launch_breakdown(lambda: wa.window_attention_bwd_cuda(q, k, v, bias, rid, g))
            log(f"window_attention_bwd {name} {tag} launches (torch.profiler device ms a call): "
                + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in parts.items()))
            wa.window_attention_fwd_cuda(q, k, v, bias, rid)
            wa.window_attention_bwd_cuda(q, k, v, bias, rid, g)
            design8, design9 = wa.last_designs()
            plain8 = cuda_time_ms(lambda: wa.window_attention_plain(q, k, v, bias, rid), reps=3,
                                  warmup=1)
            plain9 = cuda_time_ms(lambda: wa.window_attention_plain_bwd(q, k, v, bias, rid, g),
                                  reps=3, warmup=1)
            torch.cuda.empty_cache()
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            mask = sdpa_bias(bias, rid, shape[0], dtype).requires_grad_()
            gt = g.transpose(1, 2)
            lib8_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            lib9_fn = lambda: torch.autograd.grad(lib_out, (qt, kt, vt, mask), gt,
                                                  retain_graph=True)
            lib = {fn: (cuda_time_ms(fn), cuda_time_ms(fn, reps=20, queued=True))
                   for fn in (lib8_fn, lib9_fn)}
            (lib8, lib8_q), (lib9, lib9_q) = lib[lib8_fn], lib[lib9_fn]
            del lib_out, lib9_fn, lib8_fn, lib, qt, kt, vt, gt, mask
            for e, t, plain_ms, lib_ms, lib_q, design, backward in (
                    ("window_attention_fwd", t8, plain8, lib8, lib8_q, design8, False),
                    ("window_attention_bwd", t9, plain9, lib9, lib9_q, design9, True)):
                if dtype == torch.bfloat16:
                    bound_ms, bound_by = window_bound_ms(shape, dtype, backward, rid)
                    old, extra = "mma.sync", ""
                else:
                    bound_ms, bound_by, fma_bound, bf16x3 = window_f32_bounds(shape, backward,
                                                                              rid)
                    old = "FMA"
                    extra = (f"; bound of the FMA design {fma_bound:.4f} ms, of {BF16X3_BOUND} "
                             f"{bf16x3:.4f} ms")
                ms = t["new"]
                numbers = dict(shape=list(shape), ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                               design=design, queued_ms=t["new_q"], old_ms=t["old"],
                               old_queued_ms=t["old_q"], library_queued_ms=lib_q)
                if backward:
                    numbers["launches_ms"] = parts
                log(f"{e} {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa "
                    f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}"
                    f"{', ' + TF32X3_BOUND if dtype == torch.float32 else ''}), "
                    f"{bound_ms / ms:.3f} of the bound{extra}; design {design}; estimate of one "
                    f"pass of exponentials on the special-function units at "
                    f"{clock_hz / 1e9:.3f} GHz (nvidia-smi clocks.max.sm) "
                    f"{window_exp_estimate_ms(shape, clock_hz):.4f} ms, the {old} design "
                    f"{t['old']:.4f} ms ({t['old'] / ms:.2f}x); queued: kernel {t['new_q']:.4f}, "
                    f"{old} {t['old_q']:.4f} ({t['old_q'] / t['new_q']:.2f}x), sdpa "
                    f"{lib_q:.4f} ms")
                entries[e][name if dtype == torch.bfloat16 else f"{name}_f32"] = numbers
            del q, k, v, g, bias, rid
            torch.cuda.empty_cache()
    tol = ("bf16: window_attention.error_limit / backward_error_limit (one-ulp bf16 rounding "
           f"flips, elementwise; dbias F32_REL*A); f32: {F32_TOL:g} (o), F32_REL*A (grads)")
    for e, text in (("window_attention_fwd", f"{WINDOW_FWD_DESIGN}; {WINDOW_F32_DESIGN}"),
                    ("window_attention_bwd", f"{WINDOW_BWD_DESIGN}; {WINDOW_F32_DESIGN}")):
        nums = entries[e]
        nums.update({k: v for k, v in nums["stage1"].items() if k != "shape"})
        nums.update(max_abs_err=worst[e][0], err_over_limit=worst[e][1], tol=tol,
                    headline="stage 1 (1024, 392, 3, 32) shifted bf16")
        nums["design"] = f"{nums['design']} at every stage; {text}"
    return entries


# Kernel 12's wgmma design (window_attention_wgmma.cu, window_fwd_heads_kernel).
WINDOW_H2_DESIGN = ("wgmma + TMA: a block per (head group, 64-query tile, window group) walking "
                    "its windows, each window's 2-3 heads in turn, the region ids loaded once a "
                    "window; each head's K/V chunks and 64 x 64 f32 bias tiles streamed by TMA "
                    "through a ring of 24 KB slots, each slot kept by one consumer warpgroup (K "
                    "and bias freed after the logits, V after P V); kernel 8's two warpgroups "
                    "splitting the keys, S once, the exact softmax; mma.sync with the bias read "
                    "per element at other shapes and in the _mma entry")
# Kernel 11's wgmma design (window_attention_wgmma.cu, window_fwd_wgmma_kernel<KW, MODE>).
WINDOW_SM_DESIGN = ("wgmma + TMA: kernel 8's design with the softmax mode a template parameter "
                    "(mode 1 rounds z = S - max to bf16 before exp2(z log2e), mode 2 takes "
                    "exp2((S - max) log2e)): a block per (head, 64-query tile, window group) "
                    "holding the tile's f32 bias rows, two consumer warpgroups splitting the "
                    "keys, the row max and sum exchanged, S once; the held mma.sync design at "
                    "other shapes and in the _mma entry")


def window_variants(kernel8: dict):
    """Phase 11b, the counterpart of ``scripts/bench_window_kernel.py``'s
    ablation: kernels 11 (bf16sm, exp2 softmax) and 12 (heads a block) at
    the four stage shapes (shifted, bf16). The launch counts are set to 0,
    the ablation runs each variant once per stage, and the counts (and
    kernel 12's by design) are read; then each variant is held against its
    plain twin and timed beside kernel 8. Kernels 11 and 12 run wgmma
    designs (kernel 11 kernel 8's, its softmax mode a template parameter):
    each is checked in the design ``design_takes`` names, bitwise
    repeatable, with the held mma.sync design
    (``window_attention_variant_mma_cuda``) under the same limit, and the
    two timed in turns (single calls and queued) beside sdpa with the
    materialised bias. Returns ({entry: numbers}, launches during the
    ablation)."""
    from laryngeal_tpu_torch.ops import window_attention as wa

    for kernel in ("window_fwd_wgmma_kernel", "window_fwd_heads_kernel"):
        for line in ptxas_lines("window_attention.cu", kernel):
            log(f"ptxas {line}")
    inputs = {}
    for stage, (shape, grid, _) in SWIN_STAGES.items():
        q, k, v, _, bias = window_inputs(shape, torch.bfloat16, 80 + stage)
        inputs[stage] = (q, k, v, bias, stage_region_ids(grid))
    reset_launches()
    outs = {(stage, kind): wa.window_attention_variant(*inputs[stage], kind)
            for stage in SWIN_STAGES for kind in wa.VARIANTS}
    torch.cuda.synchronize()
    counts = launch_counts()
    ran = {kind: {d: n for d, n in wa.variant_design_launches[kind].items() if n}
           for kind in wa.VARIANTS}
    log(f"window ablation launches by design: {ran}")
    entries = {f"window_attention_fwd_{kind}": {} for kind in wa.VARIANTS}
    worst = {e: [0.0, 0.0] for e in entries}
    for stage, (shape, _, _) in SWIN_STAGES.items():
        q, k, v, bias, rid = inputs[stage]
        k8 = kernel8[f"stage{stage}"]
        row = [f"stage {stage} {shape}: kernel 8 {k8['ms']:.4f} ms"]
        for kind in wa.VARIANTS:
            e = f"window_attention_fwd_{kind}"
            out = outs[(stage, kind)]
            ref = wa.window_attention_plain(q, k, v, bias, rid, kind)
            limit = wa.error_limit(q, k, v, bias, rid, ref, kind)
            diff = (out.float() - ref.float()).abs()
            use = (diff / limit).max().item()
            err = diff.max().item()
            del diff
            new = lambda: wa.window_attention_variant_cuda(q, k, v, bias, rid, kind)
            want = wa.design_takes(shape[1], shape[3], torch.bfloat16, kind=kind)
            same = torch.equal(out, new())
            design = wa.last_designs()[0]
            old = lambda: wa.window_attention_variant_mma_cuda(q, k, v, bias, rid, kind)
            use_old = ((old().float() - ref.float()).abs() / limit).max().item()
            if not (same and design == want and use_old <= 1.0):
                raise AssertionError(f"{e} at stage {stage}: design {design} (want {want}), "
                                     f"bitwise repeatable {same}, the held design's "
                                     f"|err|/limit {use_old}")
            t = turns_ms({"old": old, "new": new})
            ms = t["new"]
            extra = dict(design=design, queued_ms=t["new_q"], old_ms=t["old"],
                         old_queued_ms=t["old_q"], library_queued_ms=k8["library_queued_ms"])
            log(f"{e} stage {stage} {shape}: {design} {ms:.4f} ms (queued {t['new_q']:.4f}), "
                f"the held mma.sync design {t['old']:.4f} ms ({t['old'] / ms:.2f}x; queued "
                f"{t['old_q']:.4f}), sdpa with the materialised bias {k8['library_ms']:.4f} "
                f"ms (queued {k8['library_queued_ms']:.4f}), kernel 8 {k8['ms']:.4f} ms; "
                f"|err|/limit {use:.3f} (held design {use_old:.3f}), bitwise repeatable")
            del ref, limit
            if not (math.isfinite(err) and use <= 1.0):
                raise AssertionError(f"kernel {e} disagrees with its twin at stage {stage}: "
                                     f"|err|/limit {use}")
            worst[e] = [max(worst[e][0], err), max(worst[e][1], use)]
            plain_ms = cuda_time_ms(lambda: wa.window_attention_plain(q, k, v, bias, rid, kind),
                                    reps=3, warmup=1)
            bound_ms, bound_by = window_bound_ms(shape, torch.bfloat16, False, rid)
            entries[e][f"stage{stage}"] = dict(
                shape=list(shape), ms=ms, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=k8["library_ms"], max_abs_err=err,
                err_over_limit=use, **extra)
            row.append(f"{kind} {ms:.4f} ms (|err|/limit {use:.3f})")
            torch.cuda.empty_cache()
        log("window ablation " + ", ".join(row))
    for e, nums in entries.items():
        nums.update({k: v for k, v in nums["stage1"].items()
                     if k not in ("shape", "max_abs_err", "err_over_limit")})
        nums.update(max_abs_err=worst[e][0], err_over_limit=worst[e][1],
                    tol="window_attention.error_limit (bf16; bf16sm adds its z-rounding term)",
                    headline="stage 1 (1024, 392, 3, 32) shifted bf16")
    for kind, text in (("bf16sm", WINDOW_SM_DESIGN), ("exp2", WINDOW_SM_DESIGN),
                       ("h2", WINDOW_H2_DESIGN)):
        nums = entries[f"window_attention_fwd_{kind}"]
        nums["design"] = f"{nums['design']} at every stage; {text}"
    del inputs, outs
    torch.cuda.empty_cache()
    return entries, counts


def swin3d_t(dtype, seed=0):
    from laryngeal_tpu_torch.models.swin3d import create_swin3d

    return create_swin3d("tiny", num_classes=2, dtype=dtype, seed=seed)


def swin_forward_flops(batch: int) -> float:
    """Model operations of one Swin3D-T forward at 32f 224^2: the patch
    embedding, per block the qkv, proj and MLP products and the two window
    attention products, the patch-merging products."""
    embed = 2.0 * 16 * 56 * 56 * (3 * 2 * 4 * 4) * 96
    total = embed
    dim = 96
    for stage, (shape, grid, depth) in SWIN_STAGES.items():
        tokens = grid[0] * grid[1] * grid[2]
        bw, n, h, d = shape
        block = 2.0 * tokens * dim * (3 * dim + dim + 8 * dim) + 4.0 * (bw // 8) * h * n * n * d
        total += depth * block
        if stage < 4:
            total += 2.0 * (tokens // 4) * 4 * dim * 2 * dim
            dim *= 2
    return batch * total


def swin_serving() -> dict:
    """Phase 12: the Swin3D-T serving path (12 launches of kernel 8 a
    forward, all on its wgmma design)."""
    return serving_phase("swin3d", "swin3d-t", swin3d_t, "window_attention_fwd",
                         lambda m: sum(m.config.depths), lambda m: swin_forward_flops(8),
                         seed=5, design_key="window_attention_fwd@wgmma")


def swin_key_free(name, grad):
    """Swin3D's gradients without the key slice [C, 2C) of each fused qkv
    bias (round-off, see GRAD_TOL)."""
    if name.endswith("attn.qkv.bias"):
        c = grad.shape[0] // 3
        return torch.cat([grad[:c], grad[2 * c:]])
    return grad


def design_deltas(fn, launches=None):
    """Run ``fn``, synchronise; returns (its result, the kernels' launches
    during it by design, the designs that ran none left out). ``launches``:
    {entry: {design: count}}, kernels 8-9's (``design_launches``) unless
    given."""
    from laryngeal_tpu_torch.ops import window_attention as wa

    launches = wa.design_launches if launches is None else launches
    before = {e: dict(c) for e, c in launches.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {e: {d: n - before[e][d] for d, n in c.items() if n != before[e][d]}
                 for e, c in launches.items()}


def swin_f32_path(pixel_u8, labels, mask, f32_kernel_ms: dict, n_calls: int) -> None:
    """Phase 13's f32 part: Swin3D-T at B=8 in f32, the compute dtype of the
    training CLI without ``--bf16``: the forward (model only, CUDA events,
    median of 5) and the train step (host clock around a synchronised step,
    median of 3 after a warm-up), each with kernels 8-9's launches by design
    (all on wgmma.tf32x3) and their share from phase 11's f32 times
    (``f32_kernel_ms``: {stage: (kernel 8 ms, kernel 9 ms)})."""
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    b = pixel_u8.shape[0]
    model = swin3d_t(torch.float32).cuda().eval()
    pixel = batch_preprocess(pixel_u8, "pytorchvideo", crop=224)
    with torch.no_grad():  # not inference_mode: the model trains next, on its cached indices
        _, fwd_designs = design_deltas(lambda: model(pixel))
        fwd_ms = cuda_time_ms(lambda: model(pixel), reps=5, warmup=1)
    want_fwd = {"window_attention_fwd": {"wgmma.tf32x3": n_calls}, "window_attention_bwd": {}}
    if fwd_designs != want_fwd:
        raise AssertionError(f"f32 Swin3D-T forward: kernels 8-9 by design {fwd_designs}, "
                             f"want {want_fwd}")
    depth = {stage: d for stage, (_, _, d) in SWIN_STAGES.items()}
    k8 = sum(depth[st] * ms[0] for st, ms in f32_kernel_ms.items())
    k9 = sum(depth[st] * ms[1] for st, ms in f32_kernel_ms.items())
    log(f"swin3d-t 32f 224 f32 B=8 forward: {fwd_ms:.2f} ms (model only, CUDA events, median of "
        f"5); kernel 8 by design {fwd_designs['window_attention_fwd']}, {k8:.2f} ms over the "
        f"{n_calls} blocks = {k8 / fwd_ms:.3f} of the forward")
    del pixel
    model.train()
    state = create_train_state(model, "adamw", 1e-4, 0.05)
    step = make_train_step(model, "pytorchvideo", "ce", crop=224, seed=0)
    ((state, m), per_step), designs = design_deltas(
        lambda: launched(lambda: step(state, pixel_u8, labels, mask)))
    want = {k: 0 for k in per_step}
    want.update({"window_attention_fwd": n_calls, "window_attention_bwd": n_calls})
    want_designs = {e: {"wgmma.tf32x3": n_calls} for e in designs}
    if per_step != want or designs != want_designs:
        raise AssertionError(f"f32 Swin3D-T train step: launches {per_step}, by design "
                             f"{designs}; want {want}, {want_designs}")
    times, losses = [], [m["loss"].item()]
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, pixel_u8, labels, mask)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite f32 loss {losses}")
    step_ms = float(np.median(times))
    log(f"swin3d-t 32f 224 f32 B=8 train step: {step_ms:.2f} ms (median of 3 after a warm-up, "
        f"host clock) -> {b / step_ms * 1e3:.2f} clips/s, peak memory {peak / 2**30:.2f} GiB; "
        f"kernels 8-9 by design {designs}; kernel 8 {k8:.2f} ms + kernel 9 {k9:.2f} ms a step = "
        f"{k8 / step_ms:.3f} + {k9 / step_ms:.3f} of the step; losses {losses}")
    del state, step, model, m
    torch.cuda.empty_cache()


def swin_training(kernel_ms: dict, f32_kernel_ms: dict) -> None:
    """Phases 13 and 14: the Swin3D-T training path on the card (with the
    pytorchvideo augmentation and stochastic depth 0.1 on), then its f32
    forward and train step (``swin_f32_path``), and the CLI."""
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess
    from laryngeal_tpu_torch.train.losses import cross_entropy
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_eval_step, make_train_step, step_generators

    b = 8
    model = swin3d_t(torch.bfloat16).cuda()
    n_calls = sum(depth for _, _, depth in SWIN_STAGES.values())
    state = create_train_state(model, "adamw", 1e-4, 0.05)
    step = make_train_step(model, "pytorchvideo", "ce", crop=224, seed=0)
    eval_step = make_eval_step(model, "pytorchvideo", "ce", crop=224)
    rng = np.random.default_rng(6)
    clips = rng.integers(0, 256, (b, 32, 224, 224, 3), dtype=np.uint8)
    labels = torch.from_numpy(rng.integers(0, 2, b)).cuda()
    mask = torch.ones(b, dtype=torch.bool, device="cuda")
    pixel_u8 = torch.from_numpy(clips).cuda()

    # -- phase 13: launches per step, loss, timing --
    (state, m), per_step = launched(lambda: step(state, pixel_u8, labels, mask))
    want = {k: 0 for k in per_step}
    want.update({"window_attention_fwd": n_calls, "window_attention_bwd": n_calls,
                 "window_attention_fwd@wgmma": n_calls, "window_attention_bwd@wgmma": n_calls})
    if per_step != want:
        raise AssertionError(f"launches per Swin3D train step {per_step}, want {want}")
    em, per_eval = launched(lambda: eval_step(state, pixel_u8, labels, mask))
    want_eval = {k: (n_calls if k in ("window_attention_fwd", "window_attention_fwd@wgmma")
                     else 0) for k in want}
    if per_eval != want_eval:
        raise AssertionError(f"launches per Swin3D eval step {per_eval}, want {want_eval}")
    log(f"swin3d launches per train step {per_step}; per eval step {per_eval}")
    for _ in range(2):
        step(state, pixel_u8, labels, mask)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    losses = [step(state, pixel_u8, labels, mask)[1]["loss"] for _ in range(reps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in [m["loss"], em["loss"]] + losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    flops = 3.0 * swin_forward_flops(b)
    log(f"swin3d-t 32f 224 bf16 B=8 train step: {step_s * 1e3:.2f} ms -> {b / step_s:.2f} "
        f"clips/s (uint8 batch on the card -> augmented -> updated weights), peak memory "
        f"{peak / 2**30:.2f} GiB, model operations {flops:.4e} per step = "
        f"{flops / step_s / 989e12:.4f} of 989 TFLOP/s; losses {losses}")

    aug, drop = step_generators(0, 99, "cuda")
    pre_ms = cuda_time_ms(lambda: batch_preprocess(pixel_u8, "pytorchvideo", train=True,
                                                   crop=224, generator=aug), reps=3)
    stages = []
    model.train()
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        pixel = batch_preprocess(pixel_u8, "pytorchvideo", train=True, crop=224, generator=aug)
        ev[0].record()
        loss = cross_entropy(model(pixel, generator=drop), labels, mask)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        stages.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd_ms, bwd_ms, opt_ms = np.median(np.asarray(stages[1:]), axis=0)
    attn_ms = sum(depth * kernel_ms[stage] for stage, (_, _, depth) in SWIN_STAGES.items())
    log(f"swin3d train step stages (bf16 B=8): preprocess with augmentation {pre_ms:.2f} ms, "
        f"forward+loss {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, optimizer {opt_ms:.2f} ms; "
        f"kernels 8 + 9 over the 12 blocks "
        f"({', '.join(f'stage {s} {v:.4f}' for s, v in kernel_ms.items())} ms a block) = "
        f"{attn_ms:.2f} ms = {attn_ms / (step_s * 1e3):.3f} of the step")
    # Where the step's device time goes: every kernel of one train step.
    parts = launch_breakdown(lambda: step(state, pixel_u8, labels, mask), reps=2)
    total = sum(parts.values())
    window = sum(v for k, v in parts.items() if "window" in k or "dbias" in k)
    top = sorted(parts.items(), key=lambda kv: -kv[1])[:12]
    log(f"swin3d train step device time (torch.profiler, a step): {total:.2f} ms in kernels, "
        f"{window:.2f} ms = {window / total:.3f} in the window kernels; top: "
        + ", ".join(f"{k} {v:.2f}" for k, v in top))
    del state, step, eval_step, model, m, em, loss, pixel
    torch.cuda.empty_cache()
    swin_f32_path(pixel_u8, labels, mask, f32_kernel_ms, n_calls)

    pixel2 = batch_preprocess(pixel_u8[:2], "pytorchvideo", crop=224)
    for dtype in (torch.float32, torch.bfloat16):
        grad_check(lambda dt: swin3d_t(dt, seed=1), pixel2, labels[:2], dtype, swin_key_free,
                   "swin3d-t")
    del pixel_u8, pixel2
    torch.cuda.empty_cache()

    # -- phase 14: the training CLI (no early stopping), the predictor on its checkpoint --
    config, saved = cli_phase("swin3d", ["--model_size", "tiny"], 2, "window_attention_fwd",
                              n_calls, clips, "swin3d-t")
    if saved.get("use_early_stopping") is not False:
        raise AssertionError("swin3d must train without early stopping")
    if config.depths != (2, 2, 6, 2) or config.embed_dim != 96:
        raise AssertionError("the swin3d checkpoint must be served as Swin3D-T")


# Phase 15: (name, video (B, T, H, W, C), D), tubelet (2, 16, 16); M = B*T'*H'*W'.
TUBELET = (2, 16, 16)
TUBELET_CASES = [("vivit_b", (8, 32, 224, 224, 3), 768, TUBELET),  # M = 25088
                 ("m_tail", (5, 4, 64, 112, 3), 768, TUBELET),      # M = 280, not a tile multiple
                 ("d48", (2, 6, 48, 64, 3), 48, TUBELET),           # M = 72, D = 48
                 # the general path: shapes the run-length instances do not take
                 ("kwc24", (2, 4, 64, 64, 3), 96, (2, 8, 8)),       # kw*C = 24
                 ("kwc42", (2, 4, 56, 56, 3), 768, (2, 14, 14)),    # kw*C = 42
                 ("d100", (2, 4, 32, 48, 3), 100, TUBELET),         # D not a multiple of 8
                 ("odd_wc", (2, 4, 21, 49, 3), 64, (2, 7, 7))]      # W*C = 147, kw*C = 21
# Phase 16: (name, B, Nq, Nk, kv_valid, bias), H = 12, D = 64. Biases: "head" a
# (1, H, Nq, Nk) f32 per-head bias; "keys" a (B, 1, 1, Nk) f32 key-padding bias
# (0, and -1e9 on the last 64 keys: TrailingKeyMask.materialize's form); "full"
# a (B, H, Nq, Nk) bf16 bias.
BIAS_CASES = [("vivit_b", VIVIT_B["B"], VIVIT_B["N"], VIVIT_B["N"], None, "head"),
              ("vivit_b", VIVIT_B["B"], VIVIT_B["N"], VIVIT_B["N"], None, "keys"),
              ("n300_kv_valid", 2, 300, 300, 250, "head"),
              ("nq_ne_nk", 2, 257, 1100, None, "full")]


def tubelet_bound_ms(video_shape, d, dtype, products: int = 1, peak=None):
    """Least time for kernel 10: ``products`` times 2*M*K*D operations at
    ``peak`` (the peak for the type unless given; the f32 design's 3xTF32
    is 3 products at the TF32 peak), against the video, W and bias read
    once and the output written once."""
    b, t, h, w, c = video_shape
    kt, kh, kw = TUBELET
    m, k = b * (t // kt) * (h // kh) * (w // kw), kt * kh * kw * c
    size = torch.tensor([], dtype=dtype).element_size()
    t_ops = products * 2.0 * m * k * d / (peak or PEAK_FLOPS[dtype])
    t_bytes = (b * t * h * w * c + k * d + d + m * d) * size / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# Kernel 10's wgmma designs (tubelet_embed_wgmma.cu, tubelet_wgmma_kernel).
TUBELET_DESIGN = ("wgmma + TMA: persistent CTAs, one an SM, walking 128-row output tiles, "
                  "each a ring of K-steps (dt, dh) filled by warp 0's lanes: lane j slot j's "
                  "box of a 5-D tensor map over the video (an h'-row of patches a 16-row slot), "
                  "lane 8 the rows of W^T (written once a call by a pre-pass); the CTAs that "
                  "compute one row tile's column tiles form a cluster of 4 or 2 and share its "
                  "video boxes by multicast; two consumer warpgroups; bf16 128 x 192 tiles on "
                  "wgmma.m64n192k16, one batch in flight; f32 (wgmma.tf32x3) 128 x 128 tiles, "
                  "A fragments split into TF32 big and small parts in registers, three "
                  "wgmma.m64n128k8 a k8 step, each K-step's products added to the f32 sum on "
                  "the FMA units; the mma.sync / FMA designs in the _mma entry")


def tubelet_inputs(shape, d, dtype, seed, tubelet=TUBELET):
    """A unit-normal video, a LeCun-normal Flax-layout kernel, a small bias."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    video = torch.randn(shape, generator=g, device="cuda").to(dtype)
    fan_in = tubelet[0] * tubelet[1] * tubelet[2] * shape[-1]
    kernel = torch.randn((*tubelet, shape[-1], d), generator=g, device="cuda") / math.sqrt(fan_in)
    return video, kernel, 0.1 * torch.randn((d,), generator=g, device="cuda")


def check_tubelet_kernel():
    """Phase 15, the kernel: kernel 10 vs ``tubelet_embed_plain`` under
    ``tubelet.error_limit`` at the ViViT-B stem shape, an M tail, D = 48, and
    four shapes of the general path (kw*C = 24 and 42, D = 100, an odd W*C),
    bf16 and f32, each in the design ``tubelet.design_takes`` names and
    bitwise repeatable; at the stem shape the new design and the earlier one
    (``tubelet_embed_mma_cuda``: mma.sync, FMA) timed in turns, single calls
    and queued, beside cuDNN's conv3d (the model's stem) and
    extract_tubelets + addmm, yardsticks the kernel route never calls; the
    ptxas report of the new design's instances."""
    import torch.nn.functional as F

    from laryngeal_tpu_torch.ops import tubelet as tt

    for kernel in ("tubelet_wgmma_kernel", "transpose_w_kernel"):
        for line in ptxas_lines("tubelet_embed.cu", kernel):
            log(f"ptxas {line}")
    entry = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for seed, (name, shape, d, tubelet) in enumerate(TUBELET_CASES):
            video, kernel, bias = tubelet_inputs(shape, d, dtype, 40 + seed, tubelet)
            out = tt.tubelet_embed_cuda(video, kernel, bias, tubelet)
            design = tt.last_design()
            want = tt.design_takes(shape, d, tubelet, dtype)
            same = torch.equal(out, tt.tubelet_embed_cuda(video, kernel, bias, tubelet))
            ref = tt.tubelet_embed_plain(video, kernel, bias, tubelet)
            diff = (out.float() - ref.float()).abs()
            limit = tt.error_limit(video, kernel, ref, tubelet)
            err, use = diff.max().item(), (diff / limit).max().item()
            ok = (out.shape == ref.shape and math.isfinite(err) and use <= 1.0
                  and design == want and same)
            log(f"tubelet {name} {tag} (M={out.shape[0] * out.shape[1]}, kw*C="
                f"{tubelet[2] * shape[-1]}, W*C={shape[3] * shape[4]}, D={d}; {design}): "
                f"max_abs_err {err:.3e}, largest |err| / limit {use:.3f}, bitwise repeatable "
                f"{same} {'ok' if ok else 'FAIL'}")
            del diff, limit
            if not ok:
                raise AssertionError(f"kernel 10 disagrees with its plain twin or runs another "
                                     f"design: {name} {tag} ({design}, want {want})")
            if name != "vivit_b":
                continue
            old = lambda: tt.tubelet_embed_mma_cuda(video, kernel, bias)
            use_old = ((old().float() - ref.float()).abs()
                       / tt.error_limit(video, kernel, ref)).max().item()
            if use_old > 1.0:
                raise AssertionError(f"kernel 10's earlier design disagrees: {tag} {use_old}")
            t = turns_ms({"old": old, "new": lambda: tt.tubelet_embed_cuda(video, kernel, bias)})
            ms = t["new"]
            plain_ms = cuda_time_ms(lambda: tt.tubelet_embed_plain(video, kernel, bias),
                                    reps=3, warmup=1)
            x_cf, b_dt = video.permute(0, 4, 1, 2, 3), bias.to(dtype)
            w_cf = kernel.to(dtype).permute(4, 3, 0, 1, 2).contiguous()
            conv_ms = cuda_time_ms(lambda: F.conv3d(x_cf, w_cf, b_dt, stride=TUBELET))
            w2 = tt.flatten_kernel(kernel).to(dtype)
            mm = lambda: torch.addmm(
                b_dt, tt.extract_tubelets(video, TUBELET).reshape(-1, w2.shape[0]), w2)
            mm_ms = cuda_time_ms(mm)
            mm_q = cuda_time_ms(mm, reps=20, queued=True)
            bound_ms, bound_by = (tubelet_bound_ms(shape, d, dtype) if dtype == torch.bfloat16
                                  else tubelet_bound_ms(shape, d, dtype, 3, PEAK_TF32))
            log(f"tubelet_embed vivit_b {tag}: {design} {ms:.4f} ms (queued {t['new_q']:.4f}), "
                f"the earlier design {t['old']:.4f} ms ({t['old'] / ms:.2f}x; queued "
                f"{t['old_q']:.4f}), plain {plain_ms:.3f} ms, cuDNN conv3d {conv_ms:.4f} ms, "
                f"extract_tubelets + addmm {mm_ms:.4f} ms (queued {mm_q:.4f}), bound "
                f"{bound_ms:.4f} ms ({bound_by}{', 3xTF32' if dtype == torch.float32 else ''}); "
                f"|err|/limit {use:.3f} (earlier design {use_old:.3f})")
            tol = ("1e-5*sum|x*w| + 1e-6" if dtype == torch.float32
                   else "2^-7*|ref| + 1e-5*sum|x*w| + 1e-6")
            numbers = dict(max_abs_err=err, tol=tol, err_over_limit=use, ms=ms, kernel_ms=ms,
                           queued_ms=t["new_q"], old_ms=t["old"], old_queued_ms=t["old_q"],
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=conv_ms, matmul_ms=mm_ms, matmul_queued_ms=mm_q,
                           design=f"{design}; {TUBELET_DESIGN}")
            if dtype == torch.bfloat16:
                entry.update(numbers)
            else:
                entry["f32"] = numbers
            del video, kernel, bias, out, ref, x_cf, w_cf, w2
            torch.cuda.empty_cache()
    return entry


def vivit_b_and_pixels():
    """The seeded ViViT-B (bf16 compute) on the card, and the port's vivit
    preprocessing of a seeded uint8 (8, 32, 224, 224, 3) batch."""
    from laryngeal_tpu_torch.models.vivit import create_vivit
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess

    model = create_vivit(num_classes=2, num_frames=32, image_size=224, dtype=torch.bfloat16,
                         seed=0).cuda()
    clips = np.random.default_rng(0).integers(0, 256, (8, 32, 224, 224, 3), dtype=np.uint8)
    with torch.inference_mode():
        pixel = batch_preprocess(torch.from_numpy(clips).cuda(), "vivit", crop=224)
    return model, pixel


def tubelet_path(model, pixel) -> dict:
    """Phase 15, the path: the ViViT-B stem computed by kernel 10 from the
    seeded ViViT-B model's own projection weights, on the port's
    preprocessing of a uint8 batch (``vivit_b_and_pixels``), held against
    the model's own stem (cuDNN conv3d, which may round the product to bf16
    before it adds the bias: 2^-8*|ref - bias| more than kernel 10's limit),
    in kernel 10's bf16 wgmma design. Returns the launches."""
    from laryngeal_tpu_torch.ops import tubelet as tt

    proj = model.vivit.embeddings.patch_embeddings.projection
    with torch.inference_mode():
        video = pixel.to(torch.bfloat16)
        kernel = tt.kernel_from_conv3d(proj.weight)
        tokens, counts = launched(
            lambda: tt.tubelet_embed(video, kernel, proj.bias, TUBELET, impl="kernel"))
        design = tt.last_design()
        ref = model.vivit.embeddings.patch_embeddings(pixel)
        limit = (tt.error_limit(video, kernel, ref)
                 + 2.0 ** -8 * (ref.float() - proj.bias.to(torch.bfloat16).float()).abs())
        diff = (tokens.float() - ref.float()).abs()
        err, use = diff.max().item(), (diff / limit).max().item()
    want = {k: 0 for k in counts}
    want["tubelet_embed"] = 1
    ok = (counts == want and tokens.shape == ref.shape == (8, 3136, 768)
          and math.isfinite(err) and use <= 1.0 and design == "wgmma")
    log(f"vivit-b stem through kernel 10 ({design}, bf16, B=8, the model's weights): tokens "
        f"{tuple(tokens.shape)}, vs the model's conv3d stem max_abs_err {err:.3e}, largest "
        f"|err| / limit {use:.3f}; launches {counts} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ViViT-B stem through kernel 10 disagrees with the model's")
    del video, tokens, ref, limit, diff
    torch.cuda.empty_cache()
    return launch_counts()


def attention_bias(kind, b, nq, nk, h, seed):
    """A phase-16 bias (see BIAS_CASES)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "head":
        return torch.randn((1, h, nq, nk), generator=g, device="cuda")
    if kind == "full":
        return torch.randn((b, h, nq, nk), generator=g, device="cuda").to(torch.bfloat16)
    bias = torch.zeros((b, 1, 1, nk), device="cuda")
    bias[..., nk - 64:] = -1e9
    return bias


def bias_bound_ms(b, nq, nk, h, d, dtype, bias, peak=None):
    """Least time for kernel 5: kernel 1's two products (three TF32 products
    each for the f32 design at D <= 64, at the TF32 peak; or at ``peak``)
    against q, k, v and o plus the bias in its own shape, each moved once.
    Returns (ms, 'operations' | 'bytes')."""
    size = torch.tensor([], dtype=dtype).element_size()
    products = 3 * 2 if dtype == torch.float32 and d <= 64 and peak is None else 2
    flops = 2.0 * products * b * h * nq * nk * d
    peak = peak or (PEAK_TF32 if products == 6 else PEAK_FLOPS[dtype])
    t_ops = flops / peak
    t_bytes = ((2 * nq + 2 * nk) * b * h * d * size
               + bias.numel() * bias.element_size()) / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# Kernel 5's designs: kernels 1-2's with the bias as a template parameter.
FLASH_BIAS_DESIGN = ("kernels 1-2's designs with the bias a template parameter: bf16 on wgmma + "
                     "TMA, f32 at D <= 64 on wgmma.tf32x3; each consumer thread loads its S "
                     "fragment's bias values of the next 64-key step (4-byte loads through L1, "
                     "the bias read through its broadcast view) into the next S's accumulators, "
                     "divided by the scale, at the top of the step, and S = Q K^T accumulates "
                     "onto them; the persistent blocks walk the items with the bias's broadcast "
                     "axes fastest; mma.sync / FMA for strides of 0, f32 at D = 128 and in the "
                     "_mma entry")


def check_bias_kernel():
    """Phase 16, the kernel: kernel 5 in both designs of each dtype (the
    entry's, wgmma in bf16 and wgmma.tf32x3 in f32, and the earlier mma.sync /
    FMA template through ``flash_attention_bias_mma_cuda``) vs
    ``attention_plain_bias`` under ``error_limit`` (bf16) and 1e-4 (f32) at
    the ViViT-B shape with a per-head and a key-padding bias, at N = 300 with
    kv_valid and at Nq != Nk with a bf16 bias; each case in the design
    ``forward_design`` names and bitwise the same on a second call. Timed at
    the ViViT-B shape: both designs in turns (single calls and queued), beside
    the twin and ``F.scaled_dot_product_attention(attn_mask=...)``, a
    yardstick the port never calls."""
    import torch.nn.functional as F

    from laryngeal_tpu_torch.ops import flash_attention as fa

    for kernel in ("fwd_wgmma_kernel", "fwd_tf32_kernel"):  # the biased instances
        biased = False
        for line in ptxas_lines("flash_attention_fwd.cu", kernel):
            if not line.startswith(" "):
                biased = re.search(r", [12]>$", line) is not None
            if biased or ("(C75" in line and re.search(r", [12]>$", line)):
                log(f"ptxas {line}")
    entry = {}
    h, d = VIVIT_B["H"], VIVIT_B["D"]
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for seed, (name, b, nq, nk, kv_valid, kind) in enumerate(BIAS_CASES):
            q, k, v = qkv(b, nq, nk, h, d, dtype, 60 + seed)
            bias = attention_bias(kind, b, nq, nk, h, 70 + seed)
            out = fa.flash_attention_bias_cuda(q, k, v, bias, kv_valid)
            design, want = fa.last_bias_design(), fa.forward_design(dtype, d)
            same = torch.equal(out, fa.flash_attention_bias_cuda(q, k, v, bias, kv_valid))
            ref = fa.attention_plain_bias(q, k, v, bias, kv_valid)
            limit = fa.error_limit(q, k, v, kv_valid, ref, F32_TOL, bias.to(dtype))
            diff = (out.float() - ref.float()).abs()
            err, use = diff.max().item(), (diff / limit).max().item()
            old = fa.flash_attention_bias_mma_cuda(q, k, v, bias, kv_valid)
            use_old = ((old.float() - ref.float()).abs() / limit).max().item()
            ok = math.isfinite(err) and max(use, use_old) <= 1.0 and same and design == want
            log(f"biased attention {name} {kind} bias {tuple(bias.shape)} "
                f"{str(bias.dtype)[6:]}, {tag} ({design}, want {want}): max_abs_err {err:.3e}, "
                f"largest |err| / limit {use:.3f} (the _mma entry {use_old:.3f}); bitwise "
                f"repeatable {same} {'ok' if ok else 'FAIL'}")
            del diff, limit, old
            if not ok:
                raise AssertionError(f"kernel 5 disagrees with its plain twin or ran another "
                                     f"design: {name} {kind} {tag}")
            if name != "vivit_b":
                continue
            t = turns_ms({"old": lambda: fa.flash_attention_bias_mma_cuda(q, k, v, bias),
                          "new": lambda: fa.flash_attention_bias_cuda(q, k, v, bias)})
            ms = t["new"]
            plain_ms = cuda_time_ms(lambda: fa.attention_plain_bias(q, k, v, bias),
                                    reps=3, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = bias.to(dtype)
            lib_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            library_ms = cuda_time_ms(lib_fn)
            library_q = cuda_time_ms(lib_fn, reps=20, queued=True)
            bound_ms, bound_by = bias_bound_ms(b, nq, nk, h, d, dtype, bias)
            fma_ms = bias_bound_ms(b, nq, nk, h, d, dtype, bias, peak=PEAK_FLOPS[dtype])[0]
            bias_ms = bias.numel() * bias.element_size() / PEAK_BYTES_PER_S * 1e3
            old_name = "mma.sync" if dtype == torch.bfloat16 else "FMA"
            log(f"flash_attention_fwd_bias vivit_b {kind} bias {tag}: {design} {ms:.3f} ms "
                f"(queued {t['new_q']:.3f}), the {old_name} design {t['old']:.3f} ms "
                f"({t['old'] / ms:.2f}x; queued {t['old_q']:.3f}), plain {plain_ms:.3f} ms, "
                f"sdpa with attn_mask {library_ms:.3f} ms (queued {library_q:.3f}), bound "
                f"{bound_ms:.4f} ms ({bound_by}"
                f"{', ' + TF32X3_BOUND if dtype == torch.float32 else ''}), "
                f"{bound_ms / ms:.3f} of it; the bias alone {bias_ms:.4f} ms"
                + (f"; the FMA design's bound {fma_ms:.4f} ms" if dtype == torch.float32 else ""))
            tol = F32_TOL if dtype == torch.float32 else "2^-8*plain(|v|)+2^-7*|ref|+1e-5"
            numbers = dict(max_abs_err=err, tol=tol, err_over_limit=use, ms=ms, kernel_ms=ms,
                           plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms, design=design, queued_ms=t["new_q"],
                           old_ms=t["old"], old_queued_ms=t["old_q"],
                           library_queued_ms=library_q)
            target = entry if dtype == torch.bfloat16 else entry.setdefault("f32", {})
            if kind == "head":
                target.update(numbers)
            else:
                target["key_padding"] = numbers
            del q, k, v, bias, out, ref, qt, kt, vt, mask
            torch.cuda.empty_cache()
    entry["design"] = f"{entry['design']} (f32 {entry['f32']['design']}); {FLASH_BIAS_DESIGN}"
    return entry


def bias_block_path(model, pixel) -> dict:
    """Phase 16, the path: ViViT-B's first TransformerBlock, from the seeded
    full model, on the model's embeddings of the batch
    (``vivit_b_and_pixels``), with a per-head and a key-padding bias: the
    forward in bf16 and f32 against the same block on the plain attention
    (exactly one launch of kernel 5 a call, no other kernel); the gradients
    at B=2 (kernel 5 forward, the f32 recompute backward) of every parameter
    and of the bias against plain attention; then one forward + backward +
    AdamW step of the block at B=8 timed (it updates the model's block), with
    its peak memory. Returns the launches."""
    from laryngeal_tpu_torch.models.layers import TransformerBlock, gelu_fast
    from laryngeal_tpu_torch.ops import attention as att
    from laryngeal_tpu_torch.ops import flash_attention as fa

    cfg = model.config
    with torch.inference_mode():
        x = model.vivit.embeddings(pixel)
    x = x.clone()  # a normal tensor, which autograd may save
    blocks = {torch.bfloat16: model.vivit.encoder.layer[0]}
    blocks[torch.float32] = TransformerBlock(
        cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, act=gelu_fast,
        layer_norm_eps=cfg.layer_norm_eps, dtype=torch.float32).cuda()
    blocks[torch.float32].load_state_dict(blocks[torch.bfloat16].state_dict())
    b, n, h = x.shape[0], x.shape[1], cfg.num_heads
    biases = {kind: attention_bias(kind, b, n, n, h, 80) for kind in ("head", "keys")}

    def one_launch(counts):
        want = {k: 0 for k in counts}
        want["flash_attention_fwd_bias"] = 1
        if counts != want:
            raise AssertionError(f"a biased block call launched {counts}, want {want}")

    for dtype, block in blocks.items():
        xd = x.to(dtype)
        for kind, bias in biases.items():
            with torch.inference_mode():
                out, counts = launched(lambda: block(xd, bias))
                att.set_attention_impl("plain")
                try:
                    ref = block(xd, bias)
                finally:
                    att.set_attention_impl(None)
            one_launch(counts)
            scale = max(1.0, ref.abs().max().item())
            err = (out.float() - ref.float()).abs().max().item()
            # the model-logit limits, scaled by max(1, max |ref|): the bf16
            # block rounds P and its projections in bf16
            ok = out.shape == (b, n, cfg.hidden_size) and math.isfinite(err) \
                and err <= LOGIT_TOL[dtype] * scale
            log(f"vivit-b block 0 with the {kind} bias, {str(dtype)[6:]} B=8: kernel 5 vs plain "
                f"attention max_abs_err {err:.3e} (tol {LOGIT_TOL[dtype]:g} x {scale:.3f}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"the biased block disagrees with plain attention: {kind}")
            del out, ref

    # Gradients at B=2: kernel 5 forward + recompute backward vs plain attention.
    g = torch.Generator(device="cuda").manual_seed(81)
    weight = torch.randn((2, n, cfg.hidden_size), generator=g, device="cuda")
    for dtype, block in blocks.items():
        x2 = x[:2].to(dtype)
        bias = biases["head"].clone().requires_grad_()

        def grads():
            block.zero_grad(set_to_none=True)
            bias.grad = None
            (block(x2, bias).float() * weight).sum().backward()
            out = {nm: vivit_key_free(nm, p.grad.float()) for nm, p in block.named_parameters()}
            out = {nm: gr for nm, gr in out.items() if gr is not None}
            out["dbias"] = bias.grad.float()
            return out

        with_kernel, counts = launched(grads)
        one_launch(counts)
        att.set_attention_impl("plain")
        try:
            plain = grads()
        finally:
            att.set_attention_impl(None)
        names = list(plain)
        num = math.sqrt(sum(((with_kernel[nm] - plain[nm]) ** 2).sum().item() for nm in names))
        den = math.sqrt(sum((plain[nm] ** 2).sum().item() for nm in names))
        per = {nm: ((with_kernel[nm] - plain[nm]).norm()
                    / plain[nm].norm().clamp_min(1e-30)).item() for nm in names}
        worst = max(per, key=per.get)
        tol_all, tol_each = GRAD_TOL[dtype]
        finite = all(torch.isfinite(t).all().item() for t in with_kernel.values())
        ok = (finite and with_kernel["dbias"].shape == bias.shape and num / den <= tol_all
              and (tol_each is None or per[worst] <= tol_each))
        log(f"vivit-b block 0 {str(dtype)[6:]} gradients B=2 with the head bias, kernel 5 vs "
            f"plain attention: relative L2 {num / den:.3e} over {len(names)} tensors (tol "
            f"{tol_all:g}), dbias {per['dbias']:.3e}, worst tensor {worst} {per[worst]:.3e} "
            f"(tol {tol_each}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{dtype} gradients through kernel 5 disagree with plain")
        del with_kernel, plain, bias
    del blocks[torch.float32]
    torch.cuda.empty_cache()

    # One forward + backward + AdamW step of the bf16 block at B=8.
    block = blocks[torch.bfloat16]
    bias = biases["head"].clone().requires_grad_()
    opt = torch.optim.AdamW(list(block.parameters()) + [bias], lr=1e-4)
    weight = torch.randn(x.shape, generator=g, device="cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = (block(x, bias).float() * weight).sum()
        loss.backward()
        opt.step()
        return loss

    _, counts = launched(step)
    one_launch(counts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = step().item()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    log(f"vivit-b block 0 bf16 B=8 with the head bias: forward + backward (f32 recompute) + "
        f"AdamW {np.median(times) * 1e3:.2f} ms (host clock, median of 3), peak memory "
        f"{peak / 2**30:.2f} GiB")
    del blocks, block, opt, x, biases, bias, weight
    torch.cuda.empty_cache()
    log(f"biased block path: kernel 5 launches by design "
        f"{ {d: n for d, n in fa.bias_design_launches.items() if n} }")
    return launch_counts()


# Phases 17-18: the CNN families. No kernel of the table lies on their path
# (cuDNN convolutions, the LSTM's products); every launch count must stay 0.
# Each family's label, seed and the BatchNorm whose update phase 17b / 18b recomputes
# (the last: the fewest elements a channel, so the biased and unbiased rules lie furthest apart).
CNN_FAMILIES = {
    "resnet3d": dict(label="resnet3d (slow_r50)", seed=17,
                     bn="blocks.4.res_blocks.2.branch2.norm_c"),
    "resnet50_lstm": dict(label="resnet50-2d + lstm(256, 2)", seed=18, bn="resnet50.7.2.bn3"),
}


def cnn_model(name: str, dtype, seed: int):
    """The family's model at full width and depth with seeded weights: slow_r50
    (2 classes) or ResNet50 + LSTM(256, 2 layers)."""
    from laryngeal_tpu_torch.models.registry import create_model

    return create_model(name, num_classes=2, dtype=dtype, seed=seed)


def conv_flops(model, pixel) -> float:
    """Operations of one forward, counted from this run's shapes: 2 x the
    multiply-adds of every convolution and linear layer (hooks)."""
    total = [0.0]

    def hook(m, args, out):
        if isinstance(m, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * m.in_features
        else:
            total[0] += 2.0 * out.numel() * m.weight[0].numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear))]
    try:
        with torch.inference_mode():
            model(pixel)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def set_tf32(on: bool) -> None:
    """TF32 for cuDNN's f32 convolutions: on is torch's default, which the
    CLI runs with (it sets no flag); matmuls stay off, torch's default too."""
    torch.backends.cudnn.allow_tf32 = on


def cnn_serving(name: str, card: str) -> None:
    """Phase 17a / 18a: ``Predictor.predict_clip`` at full width on a
    (8, 32, 224, 224, 3) uint8 batch in f32 (the CLI's default) and bf16:
    probabilities finite and summing to 1; the f32 eval logits against the
    same model and weights in float64 on the card (B=1: cuDNN's float64
    convolutions are slow) within 1e-4 x max(1, max |logit|) with TF32 off;
    the bf16 logits against the f32 ones within 3e-2 x max(1, max |logit|);
    the forward's time and clips/s with cuDNN's TF32 off and on (and the
    logits' deviation from float64 with it on, not held)."""
    from laryngeal_tpu_torch.infer.predictor import Predictor
    from laryngeal_tpu_torch.models.registry import get_model_spec
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess

    fam = CNN_FAMILIES[name]
    label, seed = fam["label"], fam["seed"]
    spec = get_model_spec(name)
    clips = np.random.default_rng(seed).integers(0, 256, (8, 32, 224, 224, 3), dtype=np.uint8)
    with torch.inference_mode():
        pixel = batch_preprocess(torch.from_numpy(clips).cuda(), spec.preprocess_regime,
                                 crop=224)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = cnn_model(name, dtype, seed).cuda().eval()
        predictor = Predictor(model, spec, num_frames=32, crop_size=224, device="cuda")
        probs = predictor.predict_clip(clips)
        if probs.shape != (8, 2) or not np.isfinite(probs).all() \
                or not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"{label} {dtype} predictor: bad probabilities {probs}")
        with torch.inference_mode():
            logits = model(pixel)
            forward_ms = cuda_time_ms(lambda: model(pixel), reps=5, warmup=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                predictor.predict_clip(clips)
            e2e_s = (time.perf_counter() - t0) / 3
            results[dtype] = logits.float()
            ops = conv_flops(model, pixel)
            log(f"{label} 32f 224 {str(dtype)[6:]} B=8 TF32 off: forward {forward_ms:.2f} ms "
                f"-> {8e3 / forward_ms:.2f} clips/s (model only; {ops:.4e} operations counted "
                f"from the convolutions and linear layers), predict_clip {e2e_s * 1e3:.2f} ms "
                f"-> {8 / e2e_s:.2f} clips/s (uint8 host batch -> probabilities on the host); "
                f"{card}")
            if dtype == torch.float32:
                wide = cnn_model(name, torch.float64, seed).double().cuda().eval()
                ref = wide(pixel[:1].double())
                t0 = time.perf_counter()
                wide(pixel[:1].double())
                torch.cuda.synchronize()
                f64_s = time.perf_counter() - t0
                del wide
                scale = max(1.0, ref.abs().max().item())
                err = (logits[:1].double() - ref).abs().max().item()
                log(f"{label} f32 eval logits vs float64 on the card (B=1, TF32 off): "
                    f"max_abs_err {err:.3e} (tol 1e-4 x {scale:.3f}); float64 forward "
                    f"{f64_s * 1e3:.1f} ms")
                if not (np.isfinite(err) and err <= 1e-4 * scale):
                    raise AssertionError(f"{label} f32 logits disagree with float64")
                set_tf32(True)
                try:
                    tf32_logits = model(pixel)
                    tf32_ms = cuda_time_ms(lambda: model(pixel), reps=5, warmup=1)
                finally:
                    set_tf32(False)
                dev = (tf32_logits[:1].double() - ref).abs().max().item()
                log(f"{label} 32f 224 f32 B=8 cuDNN TF32 on (torch's default, the CLI's): "
                    f"forward {tf32_ms:.2f} ms -> {8e3 / tf32_ms:.2f} clips/s; logits vs "
                    f"float64 max_abs_err {dev:.3e} (not held); {card}")
        del predictor, model
        torch.cuda.empty_cache()
    f32, bf16 = results[torch.float32], results[torch.bfloat16]
    scale = max(1.0, f32.abs().max().item())
    err = (bf16 - f32).abs().max().item()
    log(f"{label} bf16 logits vs f32 (B=8): max_abs_err {err:.3e} (tol 3e-2 x {scale:.3f})")
    if not (np.isfinite(err) and err <= 3e-2 * scale):
        raise AssertionError(f"{label} bf16 logits disagree with f32")
    del pixel
    torch.cuda.empty_cache()


def cnn_training(name: str, card: str) -> None:
    """Phase 17b / 18b: the train step at full width, B=8, f32 (the CLI's
    default), Adam with CE (resnet3d) or BCE with pos_weight and the trunk
    frozen (resnet50_lstm), the pytorchvideo augmentation and dropout on:
    the loss finite; one BatchNorm layer's running statistics moved by the
    biased rule, recomputed on the host from its captured input; for
    resnet50_lstm every trunk parameter bitwise unchanged while its BN
    buffers moved, and every LSTM and classifier parameter moved; the step's
    time, clips/s and peak memory with cuDNN's TF32 off and on, and its
    device time by kernel with it on."""
    from laryngeal_tpu_torch.models.resnet import backbone_param_mask
    from laryngeal_tpu_torch.models.registry import get_model_spec
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    fam = CNN_FAMILIES[name]
    label, seed = fam["label"], fam["seed"]
    spec = get_model_spec(name)
    b = 8
    model = cnn_model(name, torch.float32, seed).cuda()
    mask_fn = backbone_param_mask(model) if name == "resnet50_lstm" else None
    state = create_train_state(model, spec.optimizer, spec.default_lr,
                               spec.default_weight_decay, trainable_mask=mask_fn)
    pos_weight = 1.5
    step = make_train_step(model, spec.preprocess_regime, spec.loss, pos_weight, crop=224,
                           seed=0)
    rng = np.random.default_rng(seed + 100)
    pixel_u8 = torch.from_numpy(rng.integers(0, 256, (b, 32, 224, 224, 3),
                                             dtype=np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, 2, b)).cuda()
    mask = torch.ones(b, dtype=torch.bool, device="cuda")

    bn = model.get_submodule(fam["bn"])
    captured = {}

    def capture(module, args):
        if "x" not in captured:
            captured["x"] = args[0].detach().float().cpu()

    hook = bn.register_forward_pre_hook(capture)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    try:
        state, m = step(state, pixel_u8, labels, mask)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    loss0 = m["loss"].item()
    if not math.isfinite(loss0):
        raise AssertionError(f"{label} train step: non-finite loss {loss0}")
    x = captured["x"].double().numpy()
    axes = (0,) + tuple(range(2, x.ndim))
    n = x.size // x.shape[1]
    mean, var = x.mean(axis=axes), x.var(axis=axes)
    old_m = before[f"{fam['bn']}.running_mean"].double().cpu().numpy()
    old_v = before[f"{fam['bn']}.running_var"].double().cpu().numpy()
    new_m = bn.running_mean.double().cpu().numpy()
    new_v = bn.running_var.double().cpu().numpy()
    want_m, want_v = 0.9 * old_m + 0.1 * mean, 0.9 * old_v + 0.1 * var
    torch_v = 0.9 * old_v + 0.1 * var * n / (n - 1)
    err_m, err_v = np.abs(new_m - want_m).max(), np.abs(new_v - want_v).max()
    gap = np.abs(torch_v - want_v).max()
    log(f"{label} BN {fam['bn']} (n = {n} a channel): running mean off the biased rule by "
        f"{err_m:.3e}, running var by {err_v:.3e}; torch's unbiased rule would sit {gap:.3e} "
        f"off (max |var| {np.abs(var).max():.3e})")
    if not (err_m <= 1e-5 * max(1.0, np.abs(want_m).max()) and err_v <= 0.1 * gap):
        raise AssertionError(f"{label} BN running statistics did not move by the biased rule")
    after = model.state_dict()
    if name == "resnet50_lstm":
        frozen = [k for k, t in mask_fn.items() if not t]
        moved_params = [k for k, t in mask_fn.items() if t]
        bad = [k for k in frozen if not torch.equal(after[k], before[k])]
        still = [k for k in moved_params if torch.equal(after[k], before[k])]
        stats = [k for k in after if k.startswith("resnet50.") and "running_" in k]
        unmoved = [k for k in stats if torch.equal(after[k], before[k])]
        if bad or still or unmoved:
            raise AssertionError(f"frozen trunk: changed {bad[:3]}, unmoved trainable "
                                 f"{still[:3]}, unmoved BN statistics {unmoved[:3]}")
        log(f"{label}: {len(frozen)} trunk parameters bitwise unchanged, its {len(stats)} BN "
            f"statistics moved, {len(moved_params)} LSTM / classifier parameters moved; "
            f"optimizer state for {len(state.optimizer.state)} tensors")
    del captured, before, after
    for tf32 in (False, True):
        set_tf32(tf32)
        try:
            for _ in range(2):
                step(state, pixel_u8, labels, mask)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reps = 5
            t0 = time.perf_counter()
            losses = [step(state, pixel_u8, labels, mask)[1]["loss"] for _ in range(reps)]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / reps
        finally:
            set_tf32(False)
        peak = torch.cuda.max_memory_allocated()
        losses = [x.item() for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label} non-finite loss {losses}")
        log(f"{label} 32f 224 f32 B=8 train step, cuDNN TF32 {'on' if tf32 else 'off'}: "
            f"{step_s * 1e3:.2f} ms -> {b / step_s:.2f} clips/s (uint8 batch on the card -> "
            f"augmented -> updated weights), peak memory {peak / 2**30:.2f} GiB; losses "
            f"{[loss0] + losses}; {card}")
    # Where the step's device time goes under the CLI's setting.
    set_tf32(True)
    try:
        parts = launch_breakdown(lambda: step(state, pixel_u8, labels, mask), reps=2)
    finally:
        set_tf32(False)
    total = sum(parts.values())
    top = sorted(parts.items(), key=lambda kv: -kv[1])[:10]
    log(f"{label} train step device time (torch.profiler, a step, cuDNN TF32 on): "
        f"{total:.2f} ms in kernels; top: " + ", ".join(f"{k} {v:.2f}" for k, v in top))
    del state, step, model, pixel_u8
    torch.cuda.empty_cache()


def cnn_cli(name: str) -> None:
    """Phase 17c / 18c: ``cli.main --model <name>`` (f32, the defaults) for
    one epoch over 8 / 4 / 4 synthetic videos in a temporary directory
    (deleted at the end), then ``Predictor.from_checkpoint`` on best_model/
    for two clips."""
    from laryngeal_tpu_torch.cli import main as cli
    from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset
    from laryngeal_tpu_torch.infer.predictor import Predictor

    label = CNN_FAMILIES[name]["label"]
    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_cli_"))
    try:
        data = make_synthetic_dataset(str(tmp / "data"), {"train": 4, "val": 2, "test": 2},
                                      num_frames=40, h=112, w=112, seed=CNN_FAMILIES[name]["seed"])
        t0 = time.perf_counter()
        out = cli.main(["--model", name, "--data_dir", str(data), "--log_dir",
                        str(tmp / "logs"), "--batch_size", "4", "--epochs", "1",
                        "--no-pretrained", "--decode_workers", "4"])
        dt = time.perf_counter() - t0
        exp = Path(out["exp_dir"])
        for f in ("best_model", "latest", "training_history.json", "test_metrics_uniform.json"):
            if not (exp / f).exists():
                raise AssertionError(f"{label} cli wrote no {f}")
        h = out["history"]
        if not all(math.isfinite(x) for x in h["train_loss"] + h["val_loss"]):
            raise AssertionError(f"{label} cli history {h}")
        predictor = Predictor.from_checkpoint(name, exp / "best_model")
        clips = np.random.default_rng(3).integers(0, 256, (2, 32, 112, 112, 3), dtype=np.uint8)
        probs = predictor.predict_clip(clips)
        if not np.isfinite(probs).all() or not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"predictor on the {label} cli checkpoint: {probs}")
        log(f"{label} cli (f32, B=4): 1 epoch over 8 / 4 / 4 videos in {dt:.1f} s; history "
            f"{h['train_loss']} / {h['val_loss']}; test auroc {out['auroc']:.3f}; "
            f"Predictor.from_checkpoint({name!r}, best_model): {probs.tolist()}")
        del predictor
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def cnn_path(name: str, card: str) -> dict:
    """Phases 17 (resnet3d) and 18 (resnet50_lstm): serving, the train step
    and the CLI. Returns the launch counts, all of which must read 0."""
    cnn_serving(name, card)
    cnn_training(name, card)
    cnn_cli(name)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"a kernel launched on the {name} path: {counts}")
    return counts


# ---------- phases 19-22: remat, accumulation, the nt layout, the CLI's options ----------

# family: (label, preprocess regime, (optimizer, lr, weight decay), key_free, forward kernel)
TRAIN_PATHS = {
    "vivit": ("vivit-b", "vivit", ("adamw", 1e-4, 0.01), vivit_key_free,
              "flash_attention_fwd_lse"),
    "timesformer": ("timesformer-b", "timesformer", ("adamw", 1e-4, 0.01),
                    timesformer_key_free, "short_attention_fwd"),
    "swin3d": ("swin3d-t", "pytorchvideo", ("adamw", 1e-4, 0.05), swin_key_free,
               "window_attention_fwd"),
    "resnet3d": ("resnet3d (slow_r50)", "pytorchvideo", ("adam", 1e-3, 0.0),
                 lambda n, g: g, None),
}


def full_width(family: str, seed=None, dtype=torch.float32, **kwargs):
    """ViViT-B / TimeSformer-B (32f 224^2), Swin3D-T or slow_r50, 2 classes,
    on the CPU, its weights drawn from ``seed`` (None: no init, the caller
    loads them)."""
    from laryngeal_tpu_torch.models.registry import create_model

    size = {"swin3d": dict(model_size="tiny"), "resnet3d": {}}.get(
        family, dict(num_frames=32, image_size=224))
    return create_model(family, num_classes=2, dtype=dtype, seed=seed, **size, **kwargs)


def path_batch(seed: int, b: int = 8):
    """A (b, 32, 224, 224, 3) uint8 batch, labels and an all-valid mask on
    the card."""
    rng = np.random.default_rng(seed)
    pixel = torch.from_numpy(rng.integers(0, 256, (b, 32, 224, 224, 3), dtype=np.uint8)).cuda()
    return pixel, torch.from_numpy(rng.integers(0, 2, b)).cuda(), torch.ones(
        b, dtype=torch.bool, device="cuda")


def train_run(model, family: str, batch, grad_accum: int = 1, timed: int = 2) -> dict:
    """``make_train_step`` (step seed 0) on ``model``, moved to the card: the
    first step's launches and loss, the gradients it left (on the host,
    without the key biases, as ``grad_check`` takes them), the step
    counters; then ``timed`` steps, host clock around each synchronised
    step (median), and the peak memory over them: weights, AdamW moments,
    activations, gradients (over the first step when ``timed`` is 0)."""
    from laryngeal_tpu_torch.train.state import create_train_state
    from laryngeal_tpu_torch.train.steps import make_train_step

    _, regime, (opt, lr, wd), key_free, _ = TRAIN_PATHS[family]
    model = model.cuda()
    state = create_train_state(model, opt, lr, wd)
    step = make_train_step(model, regime, "ce", crop=224, grad_accum=grad_accum, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, m), counts = launched(lambda: step(state, *batch))
    grads = ((n, key_free(n, p.grad.detach().float().cpu())) for n, p in model.named_parameters())
    out = dict(loss=m["loss"].item(), counts=counts, state_step=state.step, ms=None,
               opt_steps=sorted({int(s["step"]) for s in state.optimizer.state.values()}),
               grads={n: g for n, g in grads if g is not None})
    times = []
    if timed:
        torch.cuda.reset_peak_memory_stats()
    for _ in range(timed):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        m["loss"].item()
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(ms=float(np.median(times)) if times else None,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del state, step, m, model
    torch.cuda.empty_cache()
    return out


def compare_run(label: str, got: dict, want: dict) -> str:
    """The loss within the f32 logit limit and the gradients within the f32
    limits of ``grad_check`` (relative L2 over all, and per tensor)."""
    tol_all, tol_each = GRAD_TOL[torch.float32]
    names = list(want["grads"])
    diff = {n: got["grads"][n] - want["grads"][n] for n in names}
    num = math.sqrt(sum((d ** 2).sum().item() for d in diff.values()))
    den = math.sqrt(sum((want["grads"][n] ** 2).sum().item() for n in names))
    per = {n: (diff[n].norm() / want["grads"][n].norm().clamp_min(1e-30)).item() for n in names}
    worst = max(per, key=per.get)
    dloss = abs(got["loss"] - want["loss"])
    ok = (set(got["grads"]) == set(names) and num / den <= tol_all and per[worst] <= tol_each
          and dloss <= LOGIT_TOL[torch.float32] * max(1.0, abs(want["loss"])))
    text = (f"loss {got['loss']:.7f} vs {want['loss']:.7f}; gradients relative L2 "
            f"{num / den:.3e} (tol {tol_all:g}), worst tensor {worst} {per[worst]:.3e} (tol "
            f"{tol_each:g})")
    if not ok:
        raise AssertionError(f"{label}: {text}")
    return text


def remat_phase() -> dict:
    """Phase 19: ViViT-B, TimeSformer-B and Swin3D-T (stochastic depth 0.1,
    the step's generators from the same seed both ways) at full width, f32,
    B=8: a train step with remat and one without from the same weights and
    batch, held to each other (``compare_run``), every kernel launching as
    often each way (the forward kernels 2, 6 and 8 included); the step time
    and peak memory each way. Returns each family's run without remat."""
    refs = {}
    for family, seed in (("vivit", 31), ("timesformer", 32), ("swin3d", 33)):
        label, _, _, _, fwd_key = TRAIN_PATHS[family]
        sd = full_width(family, seed).state_dict()
        batch = path_batch(seed)
        runs = {}
        for remat in (False, True):
            model = full_width(family, remat=remat)
            model.load_state_dict(sd)
            runs[remat] = train_run(model, family, batch)
        plain, remat = runs[False], runs[True]
        if plain["counts"] != remat["counts"] or plain["counts"][fwd_key] < 1:
            raise AssertionError(f"{label} launches without remat {plain['counts']}, with "
                                 f"{remat['counts']}")
        text = compare_run(f"{label} remat", remat, plain)
        log(f"{label} 32f 224 f32 B=8 train step, remat vs none: {text}; launches each way "
            f"{ {k: v for k, v in remat['counts'].items() if v} }; step {remat['ms']:.2f} ms "
            f"with remat, {plain['ms']:.2f} ms without (x{remat['ms'] / plain['ms']:.3f}); "
            f"peak memory {remat['peak_gib']:.2f} GiB with, {plain['peak_gib']:.2f} GiB "
            f"without (median of 2 steps after the first, host clock)")
        refs[family] = plain
        del batch, sd, runs
    return refs


def accumulation_phase(vivit_ref: dict) -> dict:
    """Phase 20: ViViT-B f32 B=8 at grad_accum 2 against phase 19's run at 1
    (the same weights and batch): loss and gradients within the f32 limits,
    one optimizer update, the step time and peak memory. Then slow_r50 f32
    B=8 at grad_accum 2 (Adam, the pytorchvideo augmentation and dropout
    on): its BatchNorm running statistics after the step against two
    train-mode forwards of the same weights over the strided micro-batches,
    in order, each with its micro-batch's generators (seed, step, i).
    Returns the ViViT-B run's launches."""
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess, decode_wire_batch
    from laryngeal_tpu_torch.train.steps import step_generators

    model = full_width("vivit")
    model.load_state_dict(full_width("vivit", 31).state_dict())
    run = train_run(model, "vivit", path_batch(31), grad_accum=2)
    text = compare_run("vivit-b grad_accum 2", run, vivit_ref)
    key = "flash_attention_fwd_lse"
    if run["state_step"] != 1 or run["opt_steps"] != [1] \
            or run["counts"][key] != 2 * vivit_ref["counts"][key]:
        raise AssertionError(f"grad_accum 2: state.step {run['state_step']}, optimizer steps "
                             f"{run['opt_steps']}, launches {run['counts']}")
    log(f"vivit-b 32f 224 f32 B=8 grad_accum 2 vs 1: {text}; one optimizer update; step "
        f"{run['ms']:.2f} ms vs {vivit_ref['ms']:.2f} ms, peak memory {run['peak_gib']:.2f} "
        f"GiB vs {vivit_ref['peak_gib']:.2f} GiB; launches "
        f"{ {k: v for k, v in run['counts'].items() if v} }")

    start = full_width("resnet3d", 34).state_dict()
    model = full_width("resnet3d")
    model.load_state_dict(start)
    pixel, labels, mask = batch = path_batch(34)
    r3d = train_run(model, "resnet3d", batch, grad_accum=2, timed=0)
    if not math.isfinite(r3d["loss"]) or r3d["opt_steps"] != [1] or any(r3d["counts"].values()):
        raise AssertionError(f"slow_r50 grad_accum 2: loss {r3d['loss']}, optimizer steps "
                             f"{r3d['opt_steps']}, launches {r3d['counts']}")
    twin = full_width("resnet3d")
    twin.load_state_dict(start)
    twin.cuda().train()
    with torch.no_grad():
        for i in range(2):
            aug, drop = step_generators(0, 0, "cuda", micro=i)
            twin(batch_preprocess(decode_wire_batch(pixel[i::2], "rgb"), "pytorchvideo",
                                  train=True, crop=224, generator=aug), generator=drop)
    got, want = model.state_dict(), twin.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    err = max(((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1.0)).item()
              for k in stats)
    moved = sum(not torch.equal(got[k], start[k].cuda()) for k in stats)
    counted = {int(got[k].item()) for k in got if k.endswith("num_batches_tracked")}
    if err > 1e-6 or moved != len(stats) or counted != {2}:
        raise AssertionError(f"slow_r50 grad_accum 2 statistics: err {err:.3e}, {moved} of "
                             f"{len(stats)} moved, num_batches_tracked {counted}")
    log(f"resnet3d (slow_r50) 32f 224 f32 B=8 grad_accum 2: loss {r3d['loss']:.6f}, one "
        f"optimizer update, peak memory {r3d['peak_gib']:.2f} GiB; all {len(stats)} BatchNorm "
        f"running statistics moved twice (num_batches_tracked 2) and match two train-mode "
        f"forwards over rows 0::2 then 1::2 to {err:.3e} (relative to max(1, |stat|), "
        f"tol 1e-6)")
    del model, twin, got, want, start, batch, pixel
    torch.cuda.empty_cache()
    return run["counts"]


def nt_phase(flat_ref: dict) -> dict:
    """Phase 21: TimeSformer-B nt against flat on the same weights (phase
    19's): the B=8 forward's logits in f32 (within 1e-4 x max(1, max
    |logit|)) and bf16 (within 3e-2 x ...), the forward times (CUDA events,
    median of 3); kernel 6 launched 12 times per nt forward (the temporal
    calls; the spatial attention is plain PyTorch) against 24 per flat
    one; then the nt f32 train step at B=8: 12 launches each of kernels 6
    and 7, its gradients against the flat run of phase 19 within the f32
    limits, its time and peak memory beside the flat one's. Returns the nt
    step's launches."""
    from laryngeal_tpu_torch.preprocess.transforms import batch_preprocess

    sd = full_width("timesformer", 32).state_dict()
    batch = path_batch(32)
    pixel = batch_preprocess(batch[0], "timesformer", crop=224)
    fwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ("flat", "nt"):
            model = full_width("timesformer", dtype=dtype, layout=layout)
            model.load_state_dict(sd)
            model.cuda().eval()
            with torch.inference_mode():
                logits, counts = launched(lambda: model(pixel))
                ms = cuda_time_ms(lambda: model(pixel), reps=3, warmup=1)
            fwd[dtype, layout] = (logits.float(), counts, ms)
            del model
            torch.cuda.empty_cache()
        (flat, flat_counts, flat_ms), (nt, nt_counts, nt_ms) = fwd[dtype, "flat"], fwd[dtype, "nt"]
        scale = max(1.0, flat.abs().max().item())
        err = (nt - flat).abs().max().item()
        want = {k: 0 for k in nt_counts}
        want["short_attention_fwd"] = 12
        if nt_counts != want or flat_counts["short_attention_fwd"] != 24 \
                or not err <= LOGIT_TOL[dtype] * scale:
            raise AssertionError(f"timesformer-b nt {dtype}: logits err {err:.3e}, launches "
                                 f"nt {nt_counts}, flat {flat_counts}")
        log(f"timesformer-b 32f 224 {str(dtype)[6:]} B=8 forward, nt vs flat: logits "
            f"max_abs_err {err:.3e} (tol {LOGIT_TOL[dtype]:g} x {scale:.3f}); {nt_ms:.2f} ms "
            f"nt, {flat_ms:.2f} ms flat (x{nt_ms / flat_ms:.3f}); kernel 6 launches 12 nt, "
            f"24 flat")
    model = full_width("timesformer", layout="nt")
    model.load_state_dict(sd)
    run = train_run(model, "timesformer", batch)
    want = {k: 0 for k in run["counts"]}
    want.update(short_attention_fwd=12, short_attention_bwd=12)
    if run["counts"] != want:
        raise AssertionError(f"nt train step launches {run['counts']}, want {want}")
    text = compare_run("timesformer-b nt step", run, flat_ref)
    log(f"timesformer-b 32f 224 f32 B=8 train step, nt vs flat: {text}; step {run['ms']:.2f} "
        f"ms nt, {flat_ref['ms']:.2f} ms flat (x{run['ms'] / flat_ref['ms']:.3f}); peak memory "
        f"{run['peak_gib']:.2f} GiB nt, {flat_ref['peak_gib']:.2f} GiB flat")
    del pixel, batch, sd
    torch.cuda.empty_cache()
    return run["counts"]


# Kernels 2-4's CUDA symbols in every f32 design at D = 64 (flash_attention_fwd.cu,
# flash_attention_bwd*.cu): what the CLI phase's trace must name.
FLASH_SYMBOLS = {"kernel 2": ("fwd_tf32_kernel", "flash_fwd_f32_kernel"),
                 "kernel 3": ("bwd_dq_tf32_kernel", "dq_f32_kernel"),
                 "kernel 4": ("bwd_dkv_tf32_kernel", "dkv_f32_kernel")}


def cli_options_phase() -> dict:
    """Phase 22: ``cli.main --model vivit --num_layers 2`` (ViViT-B's width,
    f32) for one epoch on 8 / 4 / 4 synthetic videos with
    ``--grad_accum_steps 2 --remat --torch_weights <a .pth written here>
    --clip_cache_dir <tmp> --profile_dir <tmp>``: the log says the weights
    loaded, every clip is in the cache and a second pass over the three
    splits decodes nothing, and the trace names kernels 2-4's CUDA
    symbols. Returns the run's launches."""
    from laryngeal_tpu_torch.cli import main as cli
    from laryngeal_tpu_torch.data import dataset as port_dataset
    from laryngeal_tpu_torch.data.synthetic import make_synthetic_dataset

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_options_"))
    try:
        data = make_synthetic_dataset(str(tmp / "data"), {"train": 4, "val": 2, "test": 2},
                                      num_frames=40, h=112, w=112, seed=35)
        weights = full_width("vivit", 35, num_layers=2)
        torch.save({"model_state_dict": weights.state_dict()}, tmp / "weights.pth")
        del weights
        t0 = time.perf_counter()
        out, counts = launched(lambda: cli.main([
            "--model", "vivit", "--num_layers", "2", "--data_dir", str(data), "--log_dir",
            str(tmp / "logs"), "--batch_size", "4", "--epochs", "1", "--no-pretrained",
            "--decode_workers", "4", "--grad_accum_steps", "2", "--remat", "--torch_weights",
            str(tmp / "weights.pth"), "--clip_cache_dir", str(tmp / "cache"), "--profile_dir",
            str(tmp / "prof")]))
        dt = time.perf_counter() - t0
        exp = Path(out["exp_dir"])
        text = (exp / "experiment.log").read_text()
        if "Loaded torch weights from" not in text or not all(
                math.isfinite(x) for x in out["history"]["train_loss"]):
            raise AssertionError(f"cli options run: {out['history']}")
        files = list((tmp / "cache").glob("*.npy"))
        decoded = []
        real = port_dataset.decode_frames
        port_dataset.decode_frames = lambda *a, **k: decoded.append(a[0]) or real(*a, **k)
        try:
            n_items = 0
            for split in ("train", "val", "test"):
                ds = port_dataset.VideoDataset(data, split, num_frames=32, resize_to=(224, 224),
                                               cache_clips=False, cache_dir=tmp / "cache")
                for i in range(len(ds)):
                    ds[i]
                n_items += len(ds)
        finally:
            port_dataset.decode_frames = real
        if len(files) != n_items or decoded:
            raise AssertionError(f"clip cache: {len(files)} files for {n_items} clips, "
                                 f"{len(decoded)} decodes on the second pass")
        traces = list((tmp / "prof").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile_dir holds {traces}")
        names = {e.get("name", "") for e in json.loads(traces[0].read_text())["traceEvents"]}
        found = {k: sorted({s for s in syms for n in names if s in n})
                 for k, syms in FLASH_SYMBOLS.items()}
        if not all(found.values()):
            raise AssertionError(f"the trace names no symbol of {found}")
        log(f"cli vivit (ViViT-B width, 2 layers, f32) --grad_accum_steps 2 --remat "
            f"--torch_weights --clip_cache_dir --profile_dir: 1 epoch in {dt:.1f} s, history "
            f"{out['history']['train_loss']} / {out['history']['val_loss']}; weights loaded; "
            f"{len(files)} cached clips, a second pass decoded {len(decoded)}; trace "
            f"{traces[0].name} ({traces[0].stat().st_size / 2**20:.1f} MiB) names {found}; "
            f"launches {counts}")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import laryngeal_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the laryngeal_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[phase {name}: {now - t_phase[0]:.1f} s]")
        t_phase[0] = now

    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_kernels()
    phase_done("1 build")
    entry = check_attention()
    phase_done("2 kernel 1")
    train_entries = check_training_kernels()
    phase_done("2b kernels 2-4")
    short_entries = check_short_kernels()
    phase_done("7 kernels 6-7")
    window_entries = check_window_kernels()
    phase_done("11 kernels 8-9")
    variant_entries, variant_counts = window_variants(window_entries["window_attention_fwd"])
    phase_done("11b kernels 11-12")
    tubelet_entry = check_tubelet_kernel()
    phase_done("15 kernel 10")
    bias_entry = check_bias_kernel()
    phase_done("16 kernel 5")

    reset_launches()
    serve_counts = main_path(entry["f32"]["ms"])
    phase_done("3-4 vivit serving")
    reset_launches()
    training_path({k: v["ms"] for k, v in train_entries.items()},
                  {k: v["f32"]["ms"] for k, v in train_entries.items()})
    train_counts = launch_counts()
    phase_done("5-6 vivit training")
    reset_launches()
    ts_serve_counts = timesformer_serving()
    phase_done("8 timesformer serving")
    reset_launches()
    timesformer_training({f"{e} {shape}": short_entries[e][shape]["ms"]
                          for e in short_entries for shape in TS_SHAPES},
                         {shape: tuple(short_entries[e][f"{shape}_f32"]["ms"]
                                       for e in ("short_attention_fwd", "short_attention_bwd"))
                          for shape in TS_SHAPES})
    ts_train_counts = launch_counts()
    phase_done("9-10 timesformer training")
    reset_launches()
    swin_serve_counts = swin_serving()
    phase_done("12 swin3d serving")
    reset_launches()
    swin_training({stage: window_entries["window_attention_fwd"][f"stage{stage}"]["ms"]
                   + window_entries["window_attention_bwd"][f"stage{stage}"]["ms"]
                   for stage in SWIN_STAGES},
                  {stage: tuple(window_entries[e][f"stage{stage}_f32"]["ms"]
                                for e in ("window_attention_fwd", "window_attention_bwd"))
                   for stage in SWIN_STAGES})
    swin_train_counts = launch_counts()
    phase_done("13-14 swin3d training")
    model, pixel = vivit_b_and_pixels()
    reset_launches()
    tubelet_counts = tubelet_path(model, pixel)
    phase_done("15 vivit-b stem through kernel 10")
    reset_launches()
    bias_counts = bias_block_path(model, pixel)
    phase_done("16 vivit-b block with a bias through kernel 5")
    del model, pixel
    torch.cuda.empty_cache()
    card = card_line()
    cnn_counts = {}
    for number, name in (("17", "resnet3d"), ("18", "resnet50_lstm")):
        reset_launches()
        cnn_counts[name] = cnn_path(name, card)
        phase_done(f"{number} {name} serving, training, cli")
    reset_launches()
    refs = remat_phase()
    remat_counts = launch_counts()
    phase_done("19 remat: vivit-b, timesformer-b, swin3d-t")
    reset_launches()
    accum_counts = accumulation_phase(refs["vivit"])
    phase_done("20 gradient accumulation: vivit-b, slow_r50")
    reset_launches()
    nt_counts = nt_phase(refs["timesformer"])
    phase_done("21 timesformer-b nt layout")
    del refs
    reset_launches()
    cli_counts = cli_options_phase()
    phase_done("22 cli --grad_accum_steps --remat --torch_weights --clip_cache_dir "
               "--profile_dir")
    for name, counts, keys in (
            ("remat", remat_counts, ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv", "short_attention_fwd",
                                     "short_attention_bwd", "window_attention_fwd",
                                     "window_attention_bwd")),
            ("accumulation", accum_counts, ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                                            "flash_attention_bwd_dkv")),
            ("nt", nt_counts, ("short_attention_fwd", "short_attention_bwd")),
            ("cli options", cli_counts, ("flash_attention_fwd", "flash_attention_fwd_lse",
                                         "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))):
        if not all(counts[k] > 0 for k in keys):
            raise AssertionError(f"a kernel of the {name} path never launched: {counts}")
    log(f"launches: remat path {remat_counts}; accumulation path {accum_counts}; nt path "
        f"{nt_counts}; cli options path {cli_counts}")
    log(f"launches: vivit serving path {serve_counts}; vivit training path {train_counts}; "
        f"timesformer serving path {ts_serve_counts}; timesformer training path "
        f"{ts_train_counts}; swin3d serving path {swin_serve_counts}; swin3d training path "
        f"{swin_train_counts}; window ablation {variant_counts}; vivit-b stem path "
        f"{tubelet_counts}; biased block path {bias_counts}; "
        + "; ".join(f"{name} path: all {len(c)} counts 0" for name, c in cnn_counts.items()))
    tpu = "laryngeal_tpu/ops/flash_attention.py"
    kernels = [dict(name="flash_attention_fwd", route="cuda",
                    source="laryngeal_tpu_torch/csrc/flash_attention_fwd.cu",
                    replaces=f"{tpu}:51", launches=serve_counts["flash_attention_fwd"],
                    **entry)]
    for name, src, line in (("flash_attention_fwd_lse", "flash_attention_fwd.cu", 93),
                            ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 131),
                            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 168)):
        kernels.append(dict(name=name, route="cuda", source=f"laryngeal_tpu_torch/csrc/{src}",
                            replaces=f"{tpu}:{line}", launches=train_counts[name],
                            **train_entries[name]))
    for name, line, counts in (("short_attention_fwd", 101, ts_serve_counts),
                               ("short_attention_bwd", 118, ts_train_counts)):
        kernels.append(dict(name=name, route="cuda",
                            source="laryngeal_tpu_torch/csrc/short_attention.cu",
                            replaces=f"laryngeal_tpu/ops/short_attention.py:{line}",
                            launches=counts[name], **short_entries[name]))
    for name, line, counts in (("window_attention_fwd", 55, swin_serve_counts),
                               ("window_attention_bwd", 95, swin_train_counts)):
        # The main path runs kernels 8-9's wgmma design (its own source).
        kernels.append(dict(name=name, route="cuda",
                            source="laryngeal_tpu_torch/csrc/window_attention_wgmma.cu",
                            replaces=f"laryngeal_tpu/ops/window_attention.py:{line}",
                            launches=counts[name], **window_entries[name]))
    # Kernels 11 and 12 run wgmma designs (window_attention_wgmma.cu); kernel 5
    # runs kernel 1's designs.
    for name, line in (("window_attention_fwd_bf16sm", 76), ("window_attention_fwd_exp2", 76),
                       ("window_attention_fwd_h2", 96)):
        kernels.append(dict(name=name, route="cuda",
                            source="laryngeal_tpu_torch/csrc/window_attention_wgmma.cu",
                            replaces=f"scripts/bench_window_kernel.py:{line}",
                            launches=variant_counts[name], **variant_entries[name]))
    kernels.append(dict(name="flash_attention_fwd_bias", route="cuda",
                        source="laryngeal_tpu_torch/csrc/flash_attention_fwd.cu",
                        replaces=f"{tpu}:213", launches=bias_counts["flash_attention_fwd_bias"],
                        **bias_entry))
    kernels.append(dict(name="tubelet_embed", route="cuda",
                        source="laryngeal_tpu_torch/csrc/tubelet_embed_wgmma.cu",
                        replaces="laryngeal_tpu/ops/tubelet.py:73",
                        launches=tubelet_counts["tubelet_embed"], **tubelet_entry))
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} never launched on its path")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
