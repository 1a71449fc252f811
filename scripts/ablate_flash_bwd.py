"""What the wgmma designs of kernels 3 (dQ) and 4 (dK/dV) spend their time on,
on one CUDA card.

    python3 scripts/ablate_flash_bwd.py

Builds ``laryngeal_tpu_torch/csrc/flash_attention_bwd.cu`` as it is and with
one part of the wgmma kernels' work taken out at a time (text edits of a copy
in a temporary directory; every variant but ``as_is`` and the two ring
depths computes a wrong result by design), then times kernel 4 and then
kernel 3 of each at the ViViT-B shape (8, 3137, 12, 64) bf16: 20 launches
back to back between CUDA events, the median of 3 rounds, the variants in
turns (in order, then reversed).
Variants:

- ``as_is``: the kernels;
- ``loads_only``: the consumers wait for each streamed tile and release it
  (the TMA loads, kernel 4's lse / delta copies and the stage ring alone);
- ``products_only``: the tile's scores are not computed: the score
  accumulators, rounded to bf16, go to the next products as they are (no
  exp2, no dS arithmetic; raw f32 bits read as bf16 would be no cheaper a
  pack, and their random bits slowed the card down);
- ``no_exp``: exp2 replaced by its argument (the special-function unit's
  share);
- ``no_pack``: the f32 -> bf16 pack of P and dS replaced by a byte permute
  (the conversion's share);
- ``no_dv``: kernel 4 without its dV += P^T dO product (kernel 3 as is);
- ``no_turns``: kernel 4's two consumer warpgroups issue their products
  without taking turns (the named-barrier ping-pong removed; kernel 3 takes
  none);
- ``dq_two_warpgroups``: kernel 3 with two consumer warpgroups (128 query
  rows a block) instead of three (kernel 4 as is);
- ``stages_3``, ``stages_5``: both kernels with a ring of 3 or 5 streamed
  tile pairs instead of 4 at D <= 64 (these two compute the right result:
  they time the choice of depth).

Prints the card's name and power limit, one line per variant, and the
variants as one JSON object last. Needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from laryngeal_tpu_torch.ops import _build  # noqa: E402
from laryngeal_tpu_torch.ops import flash_attention as fa  # noqa: E402

SHAPE = (8, 3137, 12, 64)
PERM = ("#include \"hopper.cuh\"\n#define PERM(a, b) "
        "__byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632)\n")


def _wait_release(tile_var: str) -> str:
    """Consumer code that waits for every streamed tile and releases it."""
    return ("    for (int t = 0; t < n_tiles; ++t) {  // ablation: loads only\n"
            "      hopper::mbar_wait(&full[t % S], (t / S) & 1);\n"
            "      __syncwarp();\n"
            "      if (lane == 0) hopper::mbar_arrive(&empty[t % S]);\n"
            "    }\n"
            f"    if (n_tiles > 0) return;\n    {tile_var}")


DQ_ANCHOR = "const unsigned char* q_w = smem + wg * G::kTileBytes;"
DKV_ANCHOR = "const unsigned char* k_w = smem + wg * G::kTileBytes;"
DQ_SCORES = ("    float p = hopper::exp2_approx(fmaf(s[i], sl2, -lse2[r]));\n"
             "    if (TAIL && 8 * (i >> 2) + 2 * t4 + (i & 1) >= n_valid) p = 0.f;\n"
             "    dp[i] = p * (dp[i] - dl[r]);\n")
DKV_SCORES = ("      const float p = hopper::exp2_approx(fmaf(st[4 * j + e], sl2, "
              "-((e & 1) ? l.y : l.x)));\n"
              "      st[4 * j + e] = p;\n"
              "      dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d.y : d.x));\n")
STAGES = "static constexpr int kStages = HD == 128 ? 3 : 4;"
VARIANTS = {
    "as_is": [],
    "loads_only": [[DQ_ANCHOR, _wait_release(DQ_ANCHOR)], [DKV_ANCHOR, _wait_release(DKV_ANCHOR)]],
    "products_only": [[DQ_SCORES, "    (void)r;  // ablation: the scores as they are\n"],
                      [DKV_SCORES, "      (void)l, (void)d;  // ablation\n"]],
    "no_exp": [["hopper::exp2_approx(fmaf(s[i], sl2, -lse2[r]))", "fmaf(s[i], sl2, -lse2[r])"],
               ["hopper::exp2_approx(fmaf(st[4 * j + e], sl2, -((e & 1) ? l.y : l.x)))",
                "fmaf(st[4 * j + e], sl2, -((e & 1) ? l.y : l.x))"]],
    "no_pack": [["#include \"hopper.cuh\"\n", PERM],
                ["pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1])",
                 "PERM(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1])"]],
    "no_dv": [["      wg_ab<HD>(acc_dv, pp, tile(t) + G::kTileBytes);\n", ""]],
    "no_turns": [["{ hopper::named_sync(1 + wg, 256); }", "{ (void)wg; }"],
                 ["{ hopper::named_arrive(2 - wg, 256); }", "{ (void)wg; }"]],
    "dq_two_warpgroups": [["constexpr int kDqWarpgroups = HD <= 64 ? 3 : 2;",
                           "constexpr int kDqWarpgroups = 2;"]],
    "stages_3": [[STAGES, STAGES.replace("? 3 : 4;", "? 3 : 3;")]],
    "stages_5": [[STAGES, STAGES.replace("? 3 : 4;", "? 3 : 5;")]],
}
ENTRIES = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")  # kernel 4, then kernel 3


def build(name: str, workdir: Path) -> dict:
    """The variant's two C entries, by name, from a library built in ``workdir``."""
    text = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: the source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    src, lib = workdir / f"{name}.cu", workdir / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    fns = {}
    for entry in ENTRIES:
        fn = getattr(dll, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = fa._kernel(entry).argtypes
        fns[entry] = fn
    return fns


def queued_ms(fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_flash_bwd: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    b, n, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attention_lse_cuda(q, k, v)
    delta = fa.attention_delta(o, do)
    calls = {"flash_attention_bwd_dkv": lambda: fa.flash_attention_dkv_cuda(q, k, v, do, lse,
                                                                            delta),
             "flash_attention_bwd_dq": lambda: fa.flash_attention_dq_cuda(q, k, v, do, lse,
                                                                          delta)}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda name: build(name, Path(tmp)), VARIANTS)))
        times = {entry: {name: [] for name in libs} for entry in ENTRIES}
        for entry in ENTRIES:
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    fa._fns[entry] = libs[name][entry]  # the wrapper launches the variant
                    times[entry][name].append(queued_ms(calls[entry]))
        fa._fns.clear()
    ms = {entry: {name: sum(t) / len(t) for name, t in by.items()} for entry, by in times.items()}
    for entry, by in ms.items():
        for name, t in by.items():
            print(f"{entry} {name}: {t:.4f} ms ({t / by['as_is']:.3f} of as_is)", flush=True)
    print(json.dumps({"shape": list(SHAPE), "queued_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
