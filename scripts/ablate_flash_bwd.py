"""What the designs of kernels 3 (dQ) and 4 (dK/dV) spend their time on, on
one CUDA card.

    python3 scripts/ablate_flash_bwd.py          # bf16, the wgmma design
    python3 scripts/ablate_flash_bwd.py --f32    # f32, the wgmma.tf32x3 design

Builds the backward library (``laryngeal_tpu_torch/csrc/flash_attention_bwd.cu``
with its member ``flash_attention_bwd_tf32.cu``, as ``ops/_build.py`` links
them) as it is and with one part of a design's work taken out or one of its
choices changed at a time (text edits of copies in a temporary directory;
the variants that take work out compute a wrong result by design, the
others the right one), then times kernel 4 and then kernel 3 of each at the
ViViT-B shape (8, 3137, 12, 64): 20 launches back to back between CUDA
events, the median of 3 rounds, the variants in turns (in order, then
reversed). bf16 variants (the wgmma design):

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

With ``--f32`` the same is done in f32 for the wgmma.tf32x3 kernels
(``bwd_dq_tf32_kernel``, ``bwd_dkv_tf32_kernel``), with their own variants:

- ``as_is``: the kernels;
- ``fma``: the FMA kernels, through the as-is library's ``_mma`` entries
  (no build of its own);
- ``loads_only``: the consumers wait for each slot and release it (TMA,
  kernel 3's transform warps, kernel 4's pre-pass and the rings alone);
- ``no_transform``: kernel 3's transform warps release each slot untouched
  (no split, no T form);
- ``no_products``: every wgmma replaced by a register fence (the
  accumulators keep what they held: the rest of the work stays);
- ``one_term``: one TF32 product a product (big.big) instead of three;
- ``no_exp``: exp2 replaced by its argument;
- ``dq_prepass``: kernel 3's split in a pre-pass instead of the block, as
  far as the kernel sees it: no transform, and the producer loads every
  form's bytes (each slot's and dO's parts) by TMA, as it would stream a
  pre-pass's output from L2 (the same raw box in each part, so the result is
  wrong). That pre-pass is not built; its bytes (k, v, dO read once, the
  forms written once) are printed with their time at 3.35 TB/s. Kernel 4
  takes the pre-pass; its split in the block (the design it replaced) was
  last timed beside the pre-pass in one call before the change (PERF.md);
- ``dkv_kernel_alone``, ``dkv_prepass_alone``: kernel 4's call without its
  pre-pass's launch (the kernel reads the forms an earlier call left), or
  with only the pre-pass;
- ``flush_2``, ``flush_4``: the step accumulators added to dQ, dK, dV every
  2 or 4 steps instead of every step (the tensor cores sum 64 or 128 keys
  or queries first; right, and less accurate);
- ``two_pass_forms``: a step's two forms in two passes (the transpose with
  4-byte reads, then, after the transform warps meet, the rows split)
  instead of one pass of 16-byte reads that writes both;
- ``int_small``: the TF32 split's small part rounded by an integer add and
  mask instead of ``cvt.rna`` (the same rounding; an edit of
  ``tf32_tiles.cuh``, every split of both kernels).

Prints the card's name and power limit, each variant's ptxas spills and
advisories (C75xx) of the tf32 kernels, one line per variant, and the
variants as one JSON object last. Needs nvcc and a card. Exits 1 if a
variant does not build (the others are still timed, unless it is
``as_is``).
"""

from __future__ import annotations

import ctypes
import json
import re
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
BF16_SOURCE, TF32_SOURCE = _build.members("flash_attention_bwd.cu")
HEADER = "tf32_tiles.cuh"
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

# The f32 design's variants (flash_attention_bwd_tf32.cu).
TF32_DQ_CONSUMER = "      uint32_t qb[HD / 8][4];  // Q's big part\n"
TF32_DQ_LOADS_ONLY = ("      hopper::mbar_wait(q_full, it & 1);  // ablation: loads only\n"
                      "      hopper::mbar_wait(d_ready, it & 1);\n"
                      "      for (int t = 0; t < n_steps; ++t) {\n"
                      "        kr.wait(idx0 + t);\n"
                      "        vr.wait(idx0 + t);\n"
                      "        kr.release(idx0 + t, lane);\n"
                      "        vr.release(idx0 + t, lane);\n"
                      "      }\n"
                      "      idx0 += n_steps;\n"
                      "      warp_arrive(q_empty, lane);\n"
                      "      warp_arrive(d_empty, lane);\n"
                      "      if (n_steps > 0) continue;\n")
TF32_DKV_CONSUMER = "        hopper::mbar_wait(kv_full, it & 1);\n"
TF32_DKV_LOADS_ONLY = ("        for (int j = 0; j < ns; ++j, idx += 2) {  // ablation: loads only\n"
                       "          ring.wait(idx);\n"
                       "          ring.wait(idx + 1);\n"
                       "          ring.release(idx, lane);\n"
                       "          ring.release(idx + 1, lane);\n"
                       "        }\n"
                       "        warp_arrive(kv_empty, lane);\n"
                       "        ++it;\n"
                       "        if (ns > 0) continue;\n")
FORMS = "tf32_step_forms<HD, kTransformThreads>(kp, kp + 2 * S, kp + 3 * S, tid);"
NO_TRANSFORM = [[call, ""] for call in (
    "tf32_split_rows<2 * T, kTransformThreads>(do_s, do_s + 2 * T, tid);", FORMS,
    "tf32_split_rows<S, kTransformThreads>(vp, vp + S, tid);")]
# Kernel 3's K forms in two passes over the raw step: the transpose (4-byte
# reads), then, after the transform warps meet, the rows split in place.
TWO_PASS = [[FORMS, "tf32_transpose<HD, 32, kTransformWarps>(kp, kp + 2 * S, kp + 3 * S, "
                    "tid / 32, lane);\n"
                    "          hopper::named_sync(1, kTransformThreads);\n"
                    "          tf32_split_rows<S, kTransformThreads>(kp, kp + S, tid);"]]
# Kernel 4's two launches alone: its pre-pass is not launched (the kernel
# reads the forms an earlier call left), or its kernel is not.
PREPASS_LAUNCH = ("  bwd_forms_tf32_kernel<HD><<<dim3(f.Npad / 32, f.BH, 2), 256, 0, s>>>(\n"
                  "      static_cast<const float*>(q), static_cast<const float*>(dout), lse, "
                  "delta, scratch, H, Nq,\n"
                  "      D, st[0], st[1], st[2], st[9], st[10], st[11], f);\n")
DKV_LAUNCH = "  bwd_dkv_tf32_kernel<HD><<<grid_for((long long)f.BH * ((Nk + 127) / 128)), kThreads,"


def _forms(acquire: str, parts: int, map_: str, pos: str, row: str) -> str:
    """Producer code that loads `parts` copies of a 32-row box into a slot."""
    return (f"{{  // ablation: every form's bytes by TMA\n"
            f"              unsigned char* p_ = {acquire.replace(', S)', f', {parts} * S)')};\n"
            f"              for (int f = 0; f < {parts}; ++f)\n"
            f"                tf32_load_tile<HD, 32>(p_ + f * S, {map_}, {pos}, "
            f"{acquire.split('.')[0]}.bar(idx), h, {row}, b);\n"
            f"            }}")


DQ_PREPASS = NO_TRANSFORM + [
    ["tf32_load_tile<HD, 32>(kr.acquire(idx, S), &tk, pos_k, kr.bar(idx), h, 32 * t, b);",
     _forms("kr.acquire(idx, S)", 4, "&tk", "pos_k", "32 * t")],
    ["tf32_load_tile<HD, 32>(vr.acquire(idx, S), &tv, pos_v, vr.bar(idx), h, 32 * t, b);",
     _forms("vr.acquire(idx, S)", 2, "&tv", "pos_v", "32 * t")],
    ["          hopper::mbar_arrive_expect_tx(d_full, 2 * T);\n"
     "          for (int r = 0; r < 2; ++r)\n"
     "            tf32_load_tile<HD>(do_s + r * T, &tdo, pos_do, d_full, h, row0 + 64 * r, b);",
     "          hopper::mbar_arrive_expect_tx(d_full, 4 * T);  // ablation: dO's small part too\n"
     "          for (int r = 0; r < 4; ++r)\n"
     "            tf32_load_tile<HD>(do_s + r * T, &tdo, pos_do, d_full, h, row0 + 64 * (r % 2),"
     " b);"]]
NOP_MMA = ["#include \"wgmma_tiles.cuh\"\n",
           "#include \"wgmma_tiles.cuh\"\n#define NOP_MMA(d, ...) hopper::fence_regs(d)\n"]
ONE_TERM_EDITS = [
    ("    hopper::wgmma_m64n32k8_tf32_ss(d, da + oa, bb + ob, k > 0);\n"
     "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bs + ob, 1);\n"
     "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + ob, 1);\n",
     "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + ob, k > 0);  // ablation: one term\n"),
    ("    hopper::wgmma_m64n32k8_tf32_rs(d, as[k], bb + ob, k > 0);\n"
     "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bs + ob, 1);\n"
     "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + ob, 1);\n",
     "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + ob, k > 0);  // ablation: one term\n"),
    ("    tf32_mma_hd<HD>(acc, as[kk], bb + 2 * kk, accumulate || kk > 0);\n"
     "    tf32_mma_hd<HD>(acc, ab[kk], bs + 2 * kk, 1);\n"
     "    tf32_mma_hd<HD>(acc, ab[kk], bb + 2 * kk, 1);\n",
     "    tf32_mma_hd<HD>(acc, ab[kk], bb + 2 * kk, accumulate || kk > 0);  // ablation\n")]
FLUSH = "constexpr int kFlushSteps = 1;"
# tf32_split's small part (in tf32_tiles.cuh) rounded by an integer add and
# mask (the same rounding, to nearest with ties away from zero).
INT_SMALL = [["  small = hopper::tf32_rna(x - __uint_as_float(big));\n",
              "  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;\n"]]
F32_VARIANTS = {
    "as_is": [],
    "fma": None,  # the as-is library's _mma entries
    "loads_only": [[TF32_DQ_CONSUMER, TF32_DQ_LOADS_ONLY + TF32_DQ_CONSUMER],
                   [TF32_DKV_CONSUMER, TF32_DKV_CONSUMER + TF32_DKV_LOADS_ONLY]],
    "no_transform": NO_TRANSFORM,
    "no_products": [NOP_MMA, ["hopper::wgmma_m64n32k8_tf32_ss(d, ", "NOP_MMA(d, "],
                    ["hopper::wgmma_m64n32k8_tf32_rs(d, ", "NOP_MMA(d, "],
                    ["tf32_mma_hd<HD>(acc, ", "NOP_MMA(acc, "]],
    "one_term": [list(e) for e in ONE_TERM_EDITS],
    "no_exp": [["hopper::exp2_approx(fmaf(s[i], sl2, -lse2[r]))", "fmaf(s[i], sl2, -lse2[r])"],
               ["hopper::exp2_approx(fmaf(st[4 * jj + e], sl2, -(odd ? l.y : l.x)))",
                "fmaf(st[4 * jj + e], sl2, -(odd ? l.y : l.x))"]],
    "dq_prepass": DQ_PREPASS,
    "dkv_kernel_alone": [[PREPASS_LAUNCH, ""]],
    "dkv_prepass_alone": [[DKV_LAUNCH, "  if (n_actual > 0) return cudaGetLastError();  // ablation\n"
                                       + DKV_LAUNCH]],
    "flush_2": [[FLUSH, FLUSH.replace("1;", "2;")]],
    "flush_4": [[FLUSH, FLUSH.replace("1;", "4;")]],
    "two_pass_forms": TWO_PASS,
    "int_small": INT_SMALL,
}
F32 = "--f32" in sys.argv[1:]
if F32:
    VARIANTS = F32_VARIANTS
DTYPE = torch.float32 if F32 else torch.bfloat16
KERNELS = ("bwd_dq_tf32_kernel", "bwd_dkv_tf32_kernel")
ENTRIES = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")  # kernel 4, then kernel 3


def edited(files, edits, name: str) -> dict:
    """{file: text} of ``files`` (csrc names) with ``edits`` applied, each to
    the first file that holds its old text."""
    texts = {f: (_build.CSRC_DIR / f).read_text() for f in files}
    for old, new in edits:
        where = next((f for f, text in texts.items() if old in text), None)
        if where is None:
            raise RuntimeError(f"variant {name}: {', '.join(files)} no longer hold {old[:60]!r}")
        texts[where] = texts[where].replace(old, new)
    return texts


def build(name: str, workdir: Path) -> dict:
    """The variant's C entries (and their _mma twins), by name, from the two
    members built into one library in ``workdir``. An edited shared header
    (tf32_tiles.cuh) is written beside the variant's sources, where their
    quoted includes find it first."""
    files = (TF32_SOURCE, HEADER) if F32 else (BF16_SOURCE,)
    texts = edited(files, VARIANTS[name], name)
    vdir = workdir / name
    vdir.mkdir()
    srcs = [vdir / BF16_SOURCE, vdir / TF32_SOURCE]
    for f in (BF16_SOURCE, TF32_SOURCE, HEADER):
        text = texts.get(f)
        if f != HEADER:
            (vdir / f).write_text(text if text is not None else (_build.CSRC_DIR / f).read_text())
        elif text is not None and text != (_build.CSRC_DIR / f).read_text():
            (vdir / f).write_text(text)
    lib = workdir / f"{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(lib), *map(str, srcs)], capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    if F32:
        notes, kernel = [], None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                kernel = next((k for k in KERNELS if k in line), None)
                m = re.search(r"ILi(\d+)EE", line)
                kernel = f"{kernel}<{m.group(1)}>" if kernel and m else kernel
            elif "(C75" in line and any(k in line for k in KERNELS):
                notes.append(line[line.index("(C75"):].strip()[:120])
            elif kernel and "spill" in line and " 0 bytes spill stores" not in line:
                notes.append(f"{kernel}: {line.strip()}")
        if notes:
            print(f"{name}: ptxas: {'; '.join(notes)}", flush=True)
    dll = ctypes.CDLL(str(lib))
    fns = {}
    for entry in ENTRIES:
        for e in (entry, entry + "_mma"):
            fn = getattr(dll, e)
            fn.restype = ctypes.c_int
            fn.argtypes = fa._kernel(entry).argtypes
            fns[e] = fn
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


def dq_prepass_gb() -> float:
    """GB kernel 3's pre-pass would move at SHAPE in f32: k, v, dO read once
    and the forms kernel 3 would stream written once (K: rows and T, two
    parts each; V: rows, two parts; dO: its small part)."""
    b, n, h, d = SHAPE
    return (3 + 4 + 2 + 1) * b * n * h * d * 4 / 1e9


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_flash_bwd: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    b, n, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(DTYPE)
                   for _ in range(4))
    o, lse = fa.flash_attention_lse_cuda(q, k, v)
    delta = fa.attention_delta(o, do)
    calls = {"flash_attention_bwd_dkv": lambda: fa.flash_attention_dkv_cuda(q, k, v, do, lse,
                                                                            delta),
             "flash_attention_bwd_dq": lambda: fa.flash_attention_dq_cuda(q, k, v, do, lse,
                                                                          delta)}

    def try_build(name, tmp):
        if VARIANTS[name] is None:
            return None
        try:
            return build(name, Path(tmp))
        except RuntimeError as err:  # a variant that does not build is reported, not timed
            print(f"{name}: not built: {str(err)[:2000]}", flush=True)
            return False

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda name: try_build(name, tmp), VARIANTS)))
        not_built = [name for name, fns in built.items() if fns is False]
        if "as_is" in not_built:
            return 1
        libs = {}
        for name, fns in built.items():
            if fns is None:  # the as-is library's _mma entries
                fns = {e: built["as_is"][e + "_mma"] for e in ENTRIES}
            if fns is not False:
                libs[name] = fns
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
    result = {"shape": list(SHAPE), "dtype": str(DTYPE)[6:], "queued_ms": ms,
              "not_built": not_built}
    if F32:
        gb = dq_prepass_gb()
        result["dq_prepass_gb"] = gb
        print(f"dq_prepass: the pre-pass itself (not built) moves {gb:.3f} GB, "
              f"{gb / 3.35:.4f} ms at 3.35 TB/s", flush=True)
    print(json.dumps(result), flush=True)
    return 1 if not_built else 0


if __name__ == "__main__":
    sys.exit(main())
