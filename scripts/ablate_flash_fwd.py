"""What the wgmma designs of kernels 1-2 (the flash-attention forward, without
and with lse) spend their time on, on one CUDA card.

    python3 scripts/ablate_flash_fwd.py          # bf16, the wgmma design
    python3 scripts/ablate_flash_fwd.py --f32    # f32, the wgmma.tf32x3 design

Builds ``laryngeal_tpu_torch/csrc/flash_attention_fwd.cu`` as it is and with
one part of the wgmma kernel's work taken out or changed at a time (text
edits of a copy in a temporary directory; the variants that take work out
compute a wrong result by design, the others compute the right one and time
a choice of the design), then times kernel 1 and then kernel 2 of each at
the ViViT-B shape (8, 3137, 12, 64) bf16: 20 launches back to back between
CUDA events, the median of 3 rounds, the variants in turns (in order, then
reversed). Variants:

- ``as_is``: the kernels;
- ``loads_only``: the consumers wait for each K and V tile and release it
  (the TMA loads and the stage ring alone);
- ``products_only``: no softmax: the score accumulators, rounded to bf16, go
  to P V as they are (no max, exp2, sums or rescale);
- ``no_exp``: exp2 of the probabilities replaced by its argument (the
  special-function unit's share);
- ``no_pack``: the f32 -> bf16 pack of P replaced by a byte permute (the
  conversion's share);
- ``schedule_next_s``: each consumer warpgroup issues the next 64-key
  step's S = Q K^T, runs this step's softmax while it runs, then issues
  P V, instead of running the softmax first and issuing P V with the next
  S as one batch;
- ``turns``, ``turns_next_s``: the consumer warpgroups take turns issuing
  their products (a ring of named barriers), in the kernel's schedule and
  in ``schedule_next_s``'s;
- ``q_in_smem``: S = Q K^T with Q read from shared memory by each product
  (SS wgmma) instead of held in registers (RS);
- ``two_warpgroups``: two consumer warpgroups (128 query rows a block)
  instead of three at D <= 64;
- ``keys_128``: steps of 128 keys (two K and two V tiles a ring stage)
  instead of 64 at D <= 64;
- ``not_persistent``: one block a work item (64 query rows a consumer
  warpgroup, one (b, h)) instead of one block an SM walking the items;
- ``stages_3``, ``stages_6``: a ring of 3 or 6 K/V tile pairs instead of 4.

With ``--f32`` the same is done at the ViViT-B shape in f32 for the
wgmma.tf32x3 kernel, with its own variants:

- ``as_is``: the kernels;
- ``loads_only``: the consumers wait for each transformed K and V tile and
  release it (TMA, the transform warps and the rings alone);
- ``no_transform``: the transform warps release each tile untouched (no
  TF32 split of K, no V^T); ``tma_only``: that and ``loads_only``;
- ``products_only``: no softmax: the scores, split as they are, go to P V;
- ``no_exp``: exp2 of the probabilities replaced by its argument;
- ``one_term``: one TF32 product per product (big.big) instead of three;
- ``rna_big``: the big part by ``cvt.rna.tf32.f32`` instead of masking its
  low 13 bits;
- ``int_round``: both parts rounded to nearest by integer add and mask;
- ``int_small``: the small part rounded by integer add and mask instead of
  ``cvt.rna`` (the big part still masked);
- ``regs_24_240``: the producer's warpgroup keeps 24 registers a thread and
  the consumers take 240 (instead of 40 and 232);
- ``o_in_tensor_cores``: O accumulated by the P V products themselves
  across all keys instead of each step's P V in an accumulator of its own
  added to O on the FMA units (less accurate: see the source);
- ``regs_56_224``: 56 / 224 registers.

Prints the card's name and power limit, one line per variant, and the
variants as one JSON object last. Needs nvcc and a card. Exits 1 if a
variant does not build (the others are still timed, unless it is ``as_is``).
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
SOURCE = "flash_attention_fwd.cu"
HEADER = "tf32_tiles.cuh"
PERM = ("#include \"wgmma_tiles.cuh\"\n#define PERM(a, b) "
        "__byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632)\n")
CONSUMER = ("    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {\n"
            "      [[maybe_unused]] const bool last_item")
LOADS_ONLY = ("    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {\n"
              "      hopper::mbar_wait(q_full, it & 1);  // ablation: loads only\n"
              "      arrive(q_empty);\n"
              "      for (int t = 0; t < n_steps; ++t) {\n"
              "        wait_k(t);\n"
              "        wait_v(t);\n"
              "        release(t);\n"
              "      }\n"
              "      step0 += n_steps;\n"
              "    }\n"
              "    if (n_items > 0) return;\n")
SOFTMAX = "  const float neg_inf = __int_as_float(0xff800000);\n"
PRODUCTS_ONLY = ("  alpha[0] = alpha[1] = 1.f;  // ablation: products only\n"
                 "#pragma unroll\n"
                 "  for (int j = 0; j < KT; ++j)\n"
                 "#pragma unroll\n"
                 "    for (int kk = 0; kk < 4; ++kk)\n"
                 "#pragma unroll\n"
                 "      for (int r = 0; r < 4; ++r)\n"
                 "        pa[j][kk][r] =\n"
                 "            pack_bf16(s[j][8 * kk + 2 * r], s[j][8 * kk + 2 * r + 1]);\n"
                 "  if (n_valid > -1) return;\n")
EXP = "hopper::exp2_approx(fmaf(s[j][i], sl2, -m[r]))"
PACK = "pack_bf16(s[j][8 * kk + 2 * r], s[j][8 * kk + 2 * r + 1]);\n}"
SCHEDULE = "constexpr Schedule kSchedule = kBatch;"
TURNS = "constexpr bool kTurns = false;"
QREGS = "constexpr bool kQRegs = true;"
WARPGROUPS = "constexpr int kFwdWarpgroups = HD <= 64 ? 3 : 2;"
KEY_TILES = "constexpr int kKeyTiles = 1;"
STAGES = "static constexpr int kStages = 4;"
PERSISTENT = "constexpr bool kPersistent = true;"
VARIANTS = {
    "as_is": [],
    "loads_only": [[CONSUMER, LOADS_ONLY + CONSUMER]],
    "products_only": [[SOFTMAX, PRODUCTS_ONLY + SOFTMAX]],
    "no_exp": [[EXP, "fmaf(s[j][i], sl2, -m[r])"]],
    "no_pack": [["#include \"wgmma_tiles.cuh\"\n", PERM],
                [PACK, PACK.replace("pack_bf16", "PERM")]],
    "schedule_next_s": [[SCHEDULE, SCHEDULE.replace("kBatch", "kNextSOverlap")]],
    "turns": [[TURNS, TURNS.replace("false", "true")]],
    "turns_next_s": [[SCHEDULE, SCHEDULE.replace("kBatch", "kNextSOverlap")],
                     [TURNS, TURNS.replace("false", "true")]],
    "q_in_smem": [[QREGS, QREGS.replace("true", "false")]],
    "two_warpgroups": [[WARPGROUPS, "constexpr int kFwdWarpgroups = 2;"]],
    "keys_128": [[KEY_TILES, "constexpr int kKeyTiles = HD <= 64 ? 2 : 1;"]],
    "not_persistent": [[PERSISTENT, PERSISTENT.replace("true", "false")]],
    "stages_3": [[STAGES, STAGES.replace("4", "3")]],
    "stages_6": [[STAGES, STAGES.replace("4", "6")]],
}
# The f32 design's variants (fwd_tf32_kernel).
TF32_SOFTMAX = ("  const float neg_inf = __int_as_float(0xff800000);\n  float mx[2] = {neg_inf, neg_inf};\n"
                "#pragma unroll\n  for (int i = 0; i < 32; ++i) {\n    if (TAIL && 8 * (i >> 2)")
TF32_PRODUCTS_ONLY = ("  alpha[0] = alpha[1] = 1.f;  // ablation: products only\n"
                      "#pragma unroll\n"
                      "  for (int kk = 0; kk < 8; ++kk)\n"
                      "#pragma unroll\n"
                      "    for (int r = 0; r < 4; ++r)\n"
                      "      tf32_split(s[4 * kk + r], pb[kk][r], ps[kk][r]);\n"
                      "  if (n_valid > -1) return;\n")
TF32_CONSUMER = ("    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {\n"
                 "#pragma unroll\n      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;")
TF32_LOADS_ONLY = ("    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {\n"
                   "      hopper::mbar_wait(q_full, it & 1);  // ablation: loads only\n"
                   "      arrive(q_empty);\n"
                   "      for (int t = 0; t < n_steps; ++t) {\n"
                   "        wait_k(t);\n"
                   "        arrive(&k_empty[(step0 + t) % KS]);\n"
                   "        wait_v(t);\n"
                   "        arrive(&v_empty[(step0 + t) % VS]);\n"
                   "      }\n"
                   "      step0 += n_steps;\n"
                   "    }\n"
                   "    if (n_items > 0) return;\n")
TF32_SCORES = ("    hopper::wgmma_m64n64k8_tf32_ss(d, dq + off, db + off, k > 0);\n"
               "    hopper::wgmma_m64n64k8_tf32_rs(d, qb[k], ds + off, 1);\n"
               "    hopper::wgmma_m64n64k8_tf32_rs(d, qb[k], db + off, 1);\n")
TF32_PV = ("    tf32_mma_hd<HD>(acc, ps[kk], db + off, kk > 0);\n"
           "    tf32_mma_hd<HD>(acc, pb[kk], ds + off, 1);\n"
           "    tf32_mma_hd<HD>(acc, pb[kk], db + off, 1);\n")
ONE_TERM = "  // ablation: one term\n"
# tf32_split's two lines (in the shared header tf32_tiles.cuh): the big part
# masked, the small part by cvt.rna.
BIG = "  big = __float_as_uint(x) & 0xffffe000u;\n"
SMALL = "  small = hopper::tf32_rna(x - __uint_as_float(big));\n"
INT_ROUND = [BIG + SMALL, "  // ablation: rounding by integer add and mask\n"
             "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
             "  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;\n"]
INT_SMALL = [SMALL, "  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;\n"]
RNA_BIG = [BIG, "  big = hopper::tf32_rna(x);\n"]
# O the P V products' own accumulator: O rescaled before the step's P V,
# which adds to it, in place of the step's accumulator added on the FMA units.
STEP_PV = "        hopper::wgmma_fence();\n        tf32_pv<HD>(pv, pb, ps, vt + T, vt + 2 * T);\n"
STEP_ADD = ("        hopper::fence_regs(pv);\n#pragma unroll\n"
            "        for (int i = 0; i < HD / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);\n")
TC_ACC = [[STEP_PV, "#pragma unroll\n        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];\n"
                    + STEP_PV.replace("(pv,", "(acc,")],
          ["tf32_mma_hd<HD>(acc, ps[kk], db + off, kk > 0);",
           "tf32_mma_hd<HD>(acc, ps[kk], db + off, 1);"],
          [STEP_ADD, "        hopper::fence_regs(acc);\n"]]
REGS = "constexpr int kTf32ProducerRegs = 40, kTf32ConsumerRegs = 232;"
NO_TRANSFORM = [["tf32_split_rows<T, 32 * kTransformWarps>(kst, kst + T, threadIdx.x - 32);", ""],
                ["tf32_transpose<HD, 64, kTransformWarps>(vst, vst + T, vst + 2 * T, tw, lane);",
                 ""]]
F32_VARIANTS = {
    "as_is": [],
    "loads_only": [[TF32_CONSUMER, TF32_LOADS_ONLY + TF32_CONSUMER]],
    "no_transform": NO_TRANSFORM,
    "tma_only": [[TF32_CONSUMER, TF32_LOADS_ONLY + TF32_CONSUMER], *NO_TRANSFORM],
    "products_only": [[TF32_SOFTMAX, TF32_PRODUCTS_ONLY + TF32_SOFTMAX]],
    "no_exp": [["hopper::exp2_approx(fmaf(s[i], sl2, -m[r]))", "fmaf(s[i], sl2, -m[r])"]],
    "one_term": [[TF32_SCORES, "    hopper::wgmma_m64n64k8_tf32_rs(d, qb[k], db + off, k > 0);"
                               + ONE_TERM],
                 [TF32_PV, "    tf32_mma_hd<HD>(acc, pb[kk], db + off, kk > 0);"
                           + ONE_TERM]],
    "int_round": [INT_ROUND],
    "rna_big": [RNA_BIG],
    "int_small": [INT_SMALL],
    "regs_24_240": [[REGS, REGS.replace("40", "24").replace("232", "240")]],
    "o_in_tensor_cores": TC_ACC,
    "regs_56_224": [[REGS, REGS.replace("40", "56").replace("232", "224")]],
}
F32 = "--f32" in sys.argv[1:]
if F32:
    VARIANTS = F32_VARIANTS
KERNEL = "fwd_tf32_kernel" if F32 else "fwd_wgmma_kernel"
DTYPE = torch.float32 if F32 else torch.bfloat16
ENTRIES = ("flash_attention_fwd", "flash_attention_fwd_lse")  # kernel 1, then kernel 2


def build(name: str, workdir: Path) -> dict:
    """The variant's two C entries, by name, from a library built in
    ``workdir``. An edit applies to the source, or else to the shared header
    ``tf32_tiles.cuh``, whose edited copy then sits beside the source (a
    quoted include finds it there first)."""
    files = {SOURCE: (_build.CSRC_DIR / SOURCE).read_text(),
             HEADER: (_build.CSRC_DIR / HEADER).read_text()}
    for old, new in VARIANTS[name]:
        where = next((f for f, text in files.items() if old in text), None)
        if where is None:
            raise RuntimeError(f"variant {name}: the sources no longer hold {old[:60]!r}")
        files[where] = files[where].replace(old, new)
    vdir = workdir / name
    vdir.mkdir()
    src, lib = vdir / SOURCE, workdir / f"{name}.so"
    src.write_text(files[SOURCE])
    if files[HEADER] != (_build.CSRC_DIR / HEADER).read_text():
        (vdir / HEADER).write_text(files[HEADER])
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    advisories = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                  if "(C75" in line and KERNEL in line]
    if advisories:
        print(f"{name}: {len(advisories)} ptxas advisories, e.g. {advisories[0][:160]}",
              flush=True)
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
        print("ablate_flash_fwd: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    b, n, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(DTYPE)
               for _ in range(3))
    calls = {"flash_attention_fwd": lambda: fa.flash_attention_cuda(q, k, v),
             "flash_attention_fwd_lse": lambda: fa.flash_attention_lse_cuda(q, k, v)}
    def try_build(name, tmp):
        try:
            return build(name, Path(tmp))
        except RuntimeError as err:  # a variant that does not build is reported, not timed
            print(f"{name}: not built: {str(err)[:2000]}", flush=True)
            return None

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda name: try_build(name, tmp), VARIANTS)))
        libs = {name: fns for name, fns in built.items() if fns is not None}
        not_built = [name for name in VARIANTS if name not in libs]
        if "as_is" in not_built:
            return 1
        ref = fa.attention_plain(q, k, v).float()
        for name, fns in libs.items():  # variants that take work out are wrong by design
            fa._fns["flash_attention_fwd"] = fns["flash_attention_fwd"]
            err = (calls["flash_attention_fwd"]().float() - ref).abs().max().item()
            print(f"{name}: kernel 1 max |err| against attention_plain {err:.3e}", flush=True)
        del ref
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
    print(json.dumps({"shape": list(SHAPE), "dtype": str(DTYPE)[6:], "queued_ms": ms,
                      "not_built": not_built}), flush=True)
    return 1 if not_built else 0


if __name__ == "__main__":
    sys.exit(main())
