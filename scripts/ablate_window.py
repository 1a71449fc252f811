"""What kernels 8-9's wgmma designs, and kernel 12's, spend their time on, on
one CUDA card.

    python3 scripts/ablate_window.py          # the bf16 design
    python3 scripts/ablate_window.py --f32    # the f32 design, wgmma.tf32x3
    python3 scripts/ablate_window.py --h2     # kernel 12's design (heads a block)

Builds ``laryngeal_tpu_torch/csrc/window_attention_wgmma.cu`` as it is and
with one part of its work taken out or one of its choices changed at a time
(text edits of a copy in a temporary directory, each built by its own
``nvcc`` with a plain C entry appended; every variant but ``as_is`` and
``bias_streamed`` computes a wrong result by design), then times kernel 9
(both of its launches, without the groups' dbias sum) and kernel 8 at
Swin3D-T's stage 1 (1024, 392, 3, 32) and stage 4 (16, 392, 24, 32), bf16,
on views of a fused qkv with the shifted stage's region ids: 20 launches
back to back between CUDA events, the median of 3 rounds, the variants in
turns (in order, then reversed). Variants:

- ``as_is``: the design;
- ``loads_only``: the consumers wait for each window's tiles and release
  them (the TMA and cp.async loads and the barriers alone);
- ``products_only``: no logits, softmax or ds arithmetic: the score
  accumulators go to the next products as they are (and dbias sums dP);
- ``no_exp``: exp2 replaced by its argument (the special-function units'
  share);
- ``no_mask``: the region ids ignored in the arithmetic (the mask's share;
  the ids still load);
- ``bias_streamed``: each logit reads its bias from device memory (L1 / L2)
  instead of the block's copy in shared memory;
- ``no_dbias``: the dK/dV launch does not sum dbias (the fused sum's
  registers and adds);
- ``dq_only`` / ``dkv_only``: kernel 9's dQ launch, or its dK/dV launch,
  alone (the other is not launched; ``dkv_only`` reads statistics left by
  an earlier ``as_is`` call).

The two consumer warpgroups split each row's keys (a row of 392 does not fit
one warpgroup's registers), so no one-warpgroup variant exists.

With ``--f32`` the same is done for the f32 design (``wgmma.tf32x3``, the
``tf32`` functions of the same source, through its ``fwd_tf32`` /
``bwd_tf32`` launchers), on f32 inputs. Variants:

- ``as_is``: the design (the pre-pass that splits the operands, then the
  kernels);
- ``prepass_only``: the pre-pass alone (``tf32_split_kernel``: the inputs
  read, their big and small TF32 parts written, the transposed forms too);
- ``kernels_only``: the kernels alone, reading the split operands an
  ``as_is`` call left;
- ``one_term``: one TF32 product a product instead of three (the tensor
  cores' share of the 3xTF32 split);
- ``no_products``: no wgmma at all (the chunk loads, barriers and the
  arithmetic on whatever the accumulators hold);
- ``loads_only``: ``no_products`` without the logits, softmax and ds
  arithmetic (the TMA traffic through the rings and the barriers alone);
- ``no_exp``: exp2 replaced by its argument;
- ``pipelined_s``: S = Q K^T's chunks one batch deep (the next chunk's
  products issued before the last ones are waited for) instead of each
  chunk waited for in turn, in the forward and the dQ launch;
- ``dq_only`` / ``dkv_only``: kernel 9's dQ launch or its dK/dV launch
  alone, after the pre-pass.

With ``--h2`` kernel 12's wgmma design (``window_fwd_heads_kernel``: 2-3
heads of a window a block, each head's K/V chunks and 64-key bias tiles
streamed by TMA) is timed at the same stages, bf16, with ``heads_per_block``
heads a block, beside kernel 8 (``kernel8``, the same library). Variants:

- ``as_is``: the design;
- ``loads_only``: the consumers wait for each unit's Q, K, bias and V and
  release them (the TMA traffic through the ring and the barriers alone);
- ``no_bias_stream``: the producer loads no bias tiles (the consumers read
  whatever the slots hold: the bias stream's share);
- ``one_head``: the design with one head a block (``as_is`` launched with
  HB = 1: the region ids loaded once a head instead of once a window).

Prints the card's name and power limit, each variant's ptxas spills, one
line per variant and shape, and the times as one JSON object last; exits
non-zero if a variant does not build or launch. Needs nvcc and a card.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from laryngeal_tpu_torch.ops import _build  # noqa: E402
from laryngeal_tpu_torch.ops import window_attention as wa  # noqa: E402

SOURCE = "window_attention_wgmma.cu"
# stage: ((B·nW, N, H, D), the shifted block's patch grid)
STAGES = {1: ((1024, 392, 3, 32), (16, 56, 56)), 4: ((16, 392, 24, 32), (16, 7, 7))}
ENTRIES = '''
extern "C" int ablate_fwd(const void* q, const void* k, const void* v, void* o, const float* bias,
                          const int* rid, int BW, int H, int N, int D, int nW,
                          const long long* st, float scale, void* s) {
  return (int)winwg::fwd(q, k, v, o, bias, rid, BW, H, N, D, nW, st, scale,
                         static_cast<cudaStream_t>(s));
}
extern "C" int ablate_bwd(const void* q, const void* k, const void* v, const void* g,
                          const float* bias, const int* rid, void* dq, void* dk, void* dv,
                          float* dbias, float* stats, float* partial, int BW, int H, int N, int D,
                          int nW, int per_group, int groups, const long long* st, float scale,
                          void* s) {
  return (int)winwg::bwd(q, k, v, g, bias, rid, dq, dk, dv, dbias, stats, partial, BW, H, N, D,
                         nW, per_group, groups, st, scale, static_cast<cudaStream_t>(s));
}
'''
H2_ENTRY = '''
extern "C" int ablate_heads(const void* q, const void* k, const void* v, void* o,
                            const float* bias, const int* rid, int BW, int H, int HB, int N, int D,
                            int nW, const long long* st, float scale, void* s) {
  return (int)winwg::fwd_heads(q, k, v, o, bias, rid, BW, H, HB, N, D, nW, st, scale,
                               static_cast<cudaStream_t>(s));
}
'''
F32_ENTRIES = '''
extern "C" int ablate_fwd(const void* q, const void* k, const void* v, void* o, const float* bias,
                          const int* rid, float* split, int BW, int H, int N, int D, int nW,
                          const long long* st, float scale, void* s) {
  return (int)winwg::fwd_tf32(q, k, v, o, bias, rid, split, BW, H, N, D, nW, st, scale,
                              static_cast<cudaStream_t>(s));
}
extern "C" int ablate_bwd(const void* q, const void* k, const void* v, const void* g,
                          const float* bias, const int* rid, void* dq, void* dk, void* dv,
                          float* dbias, float* stats, float* partial, float* split, int BW, int H,
                          int N, int D, int nW, int per_group, int groups, const long long* st,
                          float scale, void* s) {
  return (int)winwg::bwd_tf32(q, k, v, g, bias, rid, dq, dk, dv, dbias, stats, partial, split,
                              BW, H, N, D, nW, per_group, groups, st, scale,
                              static_cast<cudaStream_t>(s));
}
'''
# Anchors in the source (build() refuses a variant whose edit no longer applies).
LOGITS = "template <int NC>\n__device__ __forceinline__ void row_logits("
SOFTMAX = "template <int NC>\n__device__ __forceinline__ void softmax("
SCORES = "template <int W>\n__device__ __forceinline__ void dkv_scores("
NO_SCORES = ("#pragma unroll\n  for (int i = 0; i < W / 2; ++i) db[i] += dpt[i];"
             "  // ablation: no arithmetic\n  (void)st;\n  (void)r;\n")


def _stub(text: str, head: str, body: str) -> str:
    """The function that starts at ``head`` with its body replaced."""
    i = text.index(head)
    j = text.index("{\n", i) + 2
    k = text.index("\n}\n", j)
    return text[:j] + body + text[k:]


def _loads_only(text: str) -> str:
    # forward and dQ: no work between a window's full barrier and its release
    for start in ("    float sc[NC][32];\n    scores<NC>(sc, st, k_i);",):
        i = text.index(start)
        j = text.index("    __syncwarp();\n    if (lane == 0) hopper::mbar_arrive(&empty[s]);", i)
        text = text[:i] + text[j:]
        i = text.index(start)
        j = text.index("    __syncwarp();\n    if (lane == 0) hopper::mbar_arrive(&empty[s]);", i)
        text = text[:i] + text[j:]
    # dK/dV: chunks waited for and released, no steps, no exchange
    text = text.replace(
        "      if (c < NC - 1) {\n#pragma unroll\n        for (int hh = 0; hh < 2; ++hh)",
        "      if (false) {\n#pragma unroll\n        for (int hh = 0; hh < 2; ++hh)")
    text = text.replace(
        "      } else {\n        dkv_step<8>(db[kSteps - 1]",
        "      } else if (false) {\n        dkv_step<8>(db[kSteps - 1]")
    return text


VARIANTS = {
    "as_is": lambda t: t,
    "loads_only": _loads_only,
    "products_only": lambda t: _stub(
        _stub(_stub(t, LOGITS, "  (void)s;\n"), SOFTMAX,
              "  m2[0] = m2[1] = 0.f;\n  il[0] = il[1] = 1.f;\n  (void)s;\n"),
        SCORES, NO_SCORES),
    "no_exp": lambda t: t.replace("hopper::exp2_approx(", "("),
    "no_mask": lambda t: t.replace("return differ ? __fadd_rn(x, kRegion) : x;", "return x;"),
    "bias_streamed": lambda t: t.replace(
        "  const float* b0 = bias_s + lr0 * BS + wg * KW;",
        "  const float* b0 = bias + ((long long)h * N + min(q0 + lr0, N - 1)) * N + wg * KW;"
    ).replace(
        "  const float* b1 = b0 + 8 * BS;\n\n  for (int w = w0, n = 0; w < w_end; ++w, ++n) {\n"
        "    const int s = n & 1;\n    hopper::mbar_wait(&full[s]",
        "  const float* b1 = bias + ((long long)h * N + min(q0 + lr0 + 8, N - 1)) * N + wg * KW;"
        "\n\n  for (int w = w0, n = 0; w < w_end; ++w, ++n) {\n"
        "    const int s = n & 1;\n    hopper::mbar_wait(&full[s]"),
    "no_dbias": lambda t: t.replace("      db[4 * j + u] += ds;\n", ""),
    "dq_only": lambda t: t.replace(
        "  window_bwd_dkv_wgmma_kernel<KW><<<", "  if (false) window_bwd_dkv_wgmma_kernel<KW><<<"),
    "dkv_only": lambda t: t.replace(
        "  window_bwd_dq_wgmma_kernel<KW><<<", "  if (false) window_bwd_dq_wgmma_kernel<KW><<<"),
}
RIGHT = ("as_is", "bias_streamed")

# The f32 design's anchors.
TF_ABT = "template <int W, int N>\n__device__ __forceinline__ void tf_abt("
TF_AB = "template <int KK>\n__device__ __forceinline__ void tf_ab("
TF_SPLIT_LAUNCH = "  tf32_split_kernel<<<"
TF_AFTER_SPLITS = ("    return err;\n  CUtensorMap tq, tk, tk8, tvt;",
                   "    return err;\n  CUtensorMap tq, tq32, tq8, tqt,")


def _tf_no_math(text: str) -> str:
    """No logits, softmax or ds arithmetic in the f32 kernels (nor in the
    bf16 ones, which share them and are not timed here)."""
    return VARIANTS["products_only"](text)


def _tf_no_products(text: str) -> str:
    return _stub(_stub(text, TF_ABT, "  (void)d;\n"), TF_AB, "  (void)d;\n")


def _tf_one_term(text: str) -> str:
    for small in ("    tf_ss<W>(d, as + 2 * ks, bb + 2 * ks, ks > 0);\n",
                  "    tf_ss<W>(d, ab + 2 * ks, bs + 2 * ks, 1);\n",
                  "    hopper::wgmma_m64n32k8_tf32_rs(d, as[kk], bb + off, accumulate || kk > 0);\n",
                  "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[kk], bs + off, 1);\n"):
        if text.count(small) != 1:
            raise RuntimeError(f"one_term: anchor {small!r} not found once")
        text = text.replace(small, "")
    return text.replace("    tf_ss<W>(d, ab + 2 * ks, bb + 2 * ks, 1);",
                        "    tf_ss<W>(d, ab + 2 * ks, bb + 2 * ks, ks > 0);").replace(
        "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[kk], bb + off, 1);",
        "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[kk], bb + off, accumulate || kk > 0);")


TF_S_LOOP = (
    "      hopper::wgmma_commit();\n      hopper::wgmma_wait<0>();\n      if (c < NC - 1)\n"
    "        hopper::fence_regs(sc[c]);\n      else\n        fence_first<4>(sc[c]);\n"
    "      ring.release(idx, lane);\n    }\n")
TF_S_PIPELINED = (
    "      hopper::wgmma_commit();\n      if (c > 0) {\n        hopper::wgmma_wait<1>();\n"
    "        hopper::fence_regs(sc[c > 0 ? c - 1 : 0]);\n        ring.release(idx - 2, lane);\n"
    "      }\n    }\n    hopper::wgmma_wait<0>();\n    fence_first<4>(sc[NC - 1]);\n"
    "    ring.release(fill0 + 2 * (NC - 1) + wg, lane);\n")


def _tf_pipelined_s(text: str) -> str:
    if text.count(TF_S_LOOP) != 2:
        raise RuntimeError("pipelined_s: the S loops moved")
    return text.replace(TF_S_LOOP, TF_S_PIPELINED)


F32_VARIANTS = {
    "as_is": lambda t: t,
    "prepass_only": lambda t: t.replace(TF_AFTER_SPLITS[0], TF_AFTER_SPLITS[0].replace(
        "return err;\n", "return err;\n  if (true) return cudaSuccess;\n")).replace(
        TF_AFTER_SPLITS[1], TF_AFTER_SPLITS[1].replace(
            "return err;\n", "return err;\n  if (true) return cudaSuccess;\n")),
    "kernels_only": lambda t: t.replace(TF_SPLIT_LAUNCH, "  if (false) tf32_split_kernel<<<"),
    "one_term": _tf_one_term,
    "no_products": _tf_no_products,
    "loads_only": lambda t: _tf_no_math(_tf_no_products(t)),
    "no_exp": lambda t: t.replace("hopper::exp2_approx(", "("),
    "pipelined_s": _tf_pipelined_s,
    "dq_only": lambda t: t.replace(
        "  window_bwd_dkv_tf32_kernel<KW><<<", "  if (false) window_bwd_dkv_tf32_kernel<KW><<<"),
    "dkv_only": lambda t: t.replace(
        "  window_bwd_dq_tf32_kernel<KW><<<", "  if (false) window_bwd_dq_tf32_kernel<KW><<<"),
}
F32_RIGHT = ("as_is", "kernels_only", "pipelined_s")


# Kernel 12's anchors: its consumers' work per unit, its producer's bias tiles.
H2_WORK = ("      float sc[NC][32];\n      scores<NC, kHbSlot>(sc, q_s + qs * kTile, mine);\n",
           "        wgtile::wg_store<32>(acc, o + w * ob + h * oh, on, q0, N, N, D, 1.f, warp, g, "
           "t4);\n")
H2_LOADS_ONLY = ("      arrive(&q_empty[qs]);  // ablation: loads only\n"
                 "#pragma unroll\n"
                 "      for (int c = 0; c < NC; ++c) arrive(&kb_empty[wg * NC + c]);\n"
                 "      if (rid != nullptr && hh == HB - 1) arrive(&ids_empty[n & 1]);\n"
                 "#pragma unroll\n"
                 "      for (int c = 0; c < NC; ++c) hopper::mbar_wait(&v_full[wg * NC + c], u & 1);\n"
                 "#pragma unroll\n"
                 "      for (int c = 0; c < NC; ++c) arrive(&v_empty[wg * NC + c]);\n"
                 "      (void)h;\n")
H2_BIAS = [
    ("            hopper::mbar_arrive_expect_tx(&kb_full[i], kTile + 2 * kHbPanel);",
     "            hopper::mbar_arrive_expect_tx(&kb_full[i], kTile);  // ablation: no bias"),
    ("            hopper::tma_load_3d(sl + kHbBias, &tb, &kb_full[i], key, q0, h);\n"
     "            hopper::tma_load_3d(sl + kHbBias + kHbPanel, &tb, &kb_full[i], key + 32, q0, h);\n",
     ""),
    ("            hopper::mbar_arrive_expect_tx(&kb_full[i], kHbNarrowRows * 64 + 64 * 32);",
     "            hopper::mbar_arrive_expect_tx(&kb_full[i], kHbNarrowRows * 64);"),
    ("            hopper::tma_load_3d(sl + kHbBias, &tb8, &kb_full[i], key, q0, h);\n", "")]


def _h2_loads_only(text: str) -> str:
    i = text.index(H2_WORK[0])
    j = text.index(H2_WORK[1], i) + len(H2_WORK[1])
    return text[:i] + H2_LOADS_ONLY + text[j:]


def _h2_no_bias(text: str) -> str:
    for old, new in H2_BIAS:
        if text.count(old) != 1:
            raise RuntimeError(f"no_bias_stream: anchor {old[:60]!r} not found once")
        text = text.replace(old, new)
    return text


H2_VARIANTS = {"as_is": lambda t: t, "loads_only": _h2_loads_only, "no_bias_stream": _h2_no_bias}


def build(name: str, workdir: Path, f32: bool = False, h2: bool = False):
    variants, entries = (F32_VARIANTS, F32_ENTRIES) if f32 else (VARIANTS, ENTRIES)
    if h2:
        variants, entries = H2_VARIANTS, ENTRIES + H2_ENTRY
    text = variants[name]((_build.CSRC_DIR / SOURCE).read_text())
    if name != "as_is" and text == (_build.CSRC_DIR / SOURCE).read_text():
        raise RuntimeError(f"variant {name}: no edit applied (the source has moved on)")
    src, lib = workdir / f"{name}.cu", workdir / f"{name}.so"
    src.write_text(text + entries)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    st = ctypes.POINTER(ctypes.c_longlong)
    fwd, bwd = dll.ablate_fwd, dll.ablate_bwd
    fwd.restype = bwd.restype = ctypes.c_int
    fwd.argtypes = [ptr] * (7 if f32 else 6) + [i32] * 5 + [st, ctypes.c_float, ptr]
    bwd.argtypes = [ptr] * (13 if f32 else 12) + [i32] * 7 + [st, ctypes.c_float, ptr]
    spills = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    if h2:
        heads = dll.ablate_heads
        heads.restype = ctypes.c_int
        heads.argtypes = [ptr] * 6 + [i32] * 6 + [st, ctypes.c_float, ptr]
        spills += [line.strip()[:160] for line in (proc.stdout + proc.stderr).splitlines()
                   if "(C75" in line and "window_fwd_heads_kernel" in line]
        return (fwd, heads), spills
    return (fwd, bwd), spills


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


def stage_inputs(shape, grid, dtype=torch.bfloat16):
    from laryngeal_tpu_torch.models.swin3d import adjust_window, shift_region_ids

    bw, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((bw, n, 3, h, d), generator=gen, device="cuda").to(dtype).unbind(2)
    g = torch.randn((bw, n, h, d), generator=gen, device="cuda").to(dtype)
    bias = torch.randn((h, n, n), generator=gen, device="cuda")
    window, shift = adjust_window(grid, (8, 7, 7), (4, 3, 3))
    rid = torch.from_numpy(shift_region_ids(grid, window, shift)).to("cuda", torch.int32)
    return q, k, v, g, bias, rid.contiguous()


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_window: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    f32 = sys.argv[1:] == ["--f32"]
    if sys.argv[1:] not in ([], ["--f32"], ["--h2"]):
        print("usage: ablate_window.py [--f32 | --h2]", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--h2"]:
        return main_h2()
    variants, right = (F32_VARIANTS, F32_RIGHT) if f32 else (VARIANTS, RIGHT)
    dtype = torch.float32 if f32 else torch.bfloat16
    design = "wgmma.tf32x3" if f32 else "wgmma"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda name: build(name, Path(tmp), f32),
                                            variants)))
        for name, (_, spills) in built.items():
            for line in spills:
                print(f"{name}: ptxas {line}", flush=True)
        for stage, (shape, grid) in STAGES.items():
            bw, n, h, d = shape
            q, k, v, g, bias, rid = stage_inputs(shape, grid, dtype)
            nw = rid.shape[0]
            o, dq, dk, dv = (torch.empty((bw, n, h, d), dtype=dtype, device="cuda")
                             for _ in range(4))
            per_group, groups = wa.dbias_groups(bw, n, h, sms, design)
            # The f32 design's split operands, the forward's and the
            # backward's, each shared by the variants.
            splits = [torch.empty(wa.split_floats(i, bw, h, n), device="cuda") for i in (0, 1)
                      ] if f32 else []
            split_f, split_b = ((x.data_ptr(),) for x in splits) if f32 else ((), ())
            dbias = torch.empty((h, n, n), device="cuda")
            stats = torch.empty((bw, h, 3, n), device="cuda")
            partial = torch.empty((groups, h, n, n), device="cuda")
            st_f = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in x.stride()[:3]))
            st_b = (ctypes.c_longlong * 21)(*(s for x in (q, k, v, g, dq, dk, dv)
                                              for s in x.stride()[:3]))
            scale = 1.0 / math.sqrt(d)

            def fwd(name):
                err = built[name][0][0](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        bias.data_ptr(), rid.data_ptr(), *split_f, bw, h, n, d,
                                        nw, st_f, scale, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: forward launch failed: cudaError {err}")

            def bwd(name):
                err = built[name][0][1](*(x.data_ptr() for x in (q, k, v, g, bias, rid, dq, dk,
                                                                   dv, dbias, stats, partial)),
                                        *split_b, bw, h, n, d, nw, per_group, groups, st_b,
                                        scale, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: backward launch failed: cudaError {err}")

            fwd("as_is")
            bwd("as_is")
            want = [x.clone() for x in (o, dq, dk, dv, partial)]
            for name in right[1:]:
                fwd(name)
                bwd(name)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip((o, dq, dk, dv, partial), want))
                print(f"stage {stage} {name}: bitwise as_is {same}", flush=True)
            fns = {f"{kind} {name}": (lambda f=f, name=name: f(name))
                   for name in variants for kind, f in (("kernel 9", bwd), ("kernel 8", fwd))
                   if not (kind == "kernel 8" and name in ("no_dbias", "dq_only", "dkv_only"))}
            times = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times[key].append(queued_ms(fns[key]))
            ms = {key: sum(t) / len(t) for key, t in times.items()}
            for key, t in ms.items():
                base = ms[key.split(" ")[0] + " " + key.split(" ")[1] + " as_is"]
                print(f"stage {stage} {shape} {key}: {t:.4f} ms ({t / base:.3f} of as_is)",
                      flush=True)
            results[f"stage{stage}"] = {"shape": list(shape), "dtype": str(dtype)[6:],
                                        "queued_ms": ms}
            del q, k, v, g, bias, rid, o, dq, dk, dv, dbias, stats, partial, want, splits
            torch.cuda.empty_cache()
    print(json.dumps(results), flush=True)
    return 0


def main_h2() -> int:
    """``--h2``: kernel 12's design and its variants at stages 1 and 4,
    beside kernel 8, in turns; ``as_is`` and ``one_head`` checked bitwise
    equal (the same arithmetic a unit, grouped differently)."""
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(H2_VARIANTS)) as pool:
        built = dict(zip(H2_VARIANTS, pool.map(lambda name: build(name, Path(tmp), h2=True),
                                               H2_VARIANTS)))
        for name, (_, lines) in built.items():
            for line in lines:
                print(f"{name}: ptxas {line}", flush=True)
        for stage, (shape, grid) in STAGES.items():
            bw, n, h, d = shape
            q, k, v, _, bias, rid = stage_inputs(shape, grid)
            o = torch.empty((bw, n, h, d), dtype=torch.bfloat16, device="cuda")
            st = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, o) for s in x.stride()[:3]))
            hb, scale, nw = wa.heads_per_block(h), 1.0 / math.sqrt(d), rid.shape[0]
            args = lambda: (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            bias.data_ptr(), rid.data_ptr())

            def heads(name, blocking):
                err = built[name][0][1](*args(), bw, h, blocking, n, d, nw, st, scale, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: kernel 12 launch failed: cudaError {err}")

            def kernel8():
                err = built["as_is"][0][0](*args(), bw, h, n, d, nw, st, scale, stream)
                if err != 0:
                    raise RuntimeError(f"kernel 8 launch failed: cudaError {err}")

            heads("as_is", hb)
            want = o.clone()
            heads("as_is", 1)
            torch.cuda.synchronize()
            print(f"stage {stage}: one_head bitwise as_is {torch.equal(o, want)}", flush=True)
            fns = {f"kernel 12 {name}": (lambda name=name: heads(name, hb)) for name in H2_VARIANTS}
            fns["kernel 12 one_head"] = lambda: heads("as_is", 1)
            fns["kernel8"] = kernel8
            times = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    times[key].append(queued_ms(fns[key]))
            ms = {key: sum(t) / len(t) for key, t in times.items()}
            for key, t in ms.items():
                print(f"stage {stage} {shape} hb {hb} {key}: {t:.4f} ms "
                      f"({t / ms['kernel 12 as_is']:.3f} of as_is)", flush=True)
            results[f"stage{stage}"] = {"shape": list(shape), "heads_per_block": hb,
                                        "queued_ms": ms}
            del q, k, v, bias, rid, o, want
            torch.cuda.empty_cache()
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
