"""What kernel 7's wgmma designs spend their time on, on one CUDA card.

    python3 scripts/ablate_short_bwd.py [--f32 [--temporal]]

Builds the short-attention library (``laryngeal_tpu_torch/csrc/
short_attention.cu`` with its f32 members ``short_attention_tf32.cu`` and
``short_attention_tf32_mma.cu``) as it is and with one part of the backward's work taken out or one of its choices
changed at a time (text edits of a copy in a temporary directory, each built
by its own ``nvcc`` with only the 4-chunk instances of the bf16 wgmma
backward; every variant but ``as_is`` and the choices below computes a wrong
result by design), then times each at TimeSformer-B's spatial shape (256,
197, 12, 64) on views of a fused qkv: 20 launches back to back between CUDA
events, the median of 3 rounds, the variants in turns (in order, then
reversed). Without ``--f32``, the bf16 wgmma design in bf16:

- ``as_is``: the kernel;
- ``mma_sync``: the earlier design (``short_attention_bwd_mma`` of the
  ``as_is`` build), for scale;
- ``loads_only``: the consumers wait for each pair's tensors and release
  them (the TMA loads and the barriers alone);
- ``products_only``: no softmax and no dS arithmetic: the score
  accumulators, rounded to bf16, go to the next products as they are;
- ``phase_a_only``: no phase B (no dK, dV);
- ``phase_b_only``: no phase A (no dQ; the row statistics set to constants);
- ``no_exp2``: exp2 replaced by its argument (the special-function unit's
  share);
- ``one_consumer``: one consumer warpgroup instead of two (every tile of a
  pair in turn; no register hand-over);
- ``no_prefetch``: one K/V stage instead of two (the next pair's K and V
  load once this pair is done);
- ``tail_256``: every key and query chunk 64 wide (the last chunk's 5 valid
  rows of 64 computed in full: a key width of 256);
- ``tail_200``: the last chunk 8 wide (a key width of 200; ``as_is`` takes
  16, 208).

The choices (``one_consumer``, ``no_prefetch``, ``tail_256``, ``tail_200``)
compute the right result; the script checks them against ``as_is``.

With ``--f32``, the f32 design ``wgmma.tf32x3`` in f32, its 7-step
instances only: ``ablate_short_fwd.py``'s ``F32_VARIANTS`` (``as_is``,
``loads_only``, ``no_split``, ``no_products``, ``one_tf32``, ``no_exp``), the
FMA design (``fma``, the ``_mma`` entry) for scale, and ``dq_only``: the
first launch alone (row statistics and dQ; the second, dK and dV, is the
rest of ``as_is``).

With ``--f32 --temporal``, the f32 design ``mma.tf32x3`` at TimeSformer-B's
temporal shape (1568, 32, 12, 64): ``ablate_short_fwd.py``'s
``TEMPORAL_VARIANTS`` (``as_is``, ``loads_only``, ``no_products``,
``one_term_tf32``, ``no_exp``, and the choices ``one_chain``, ``stages_1``,
``stages_2``, ``stages_3``, the stage counts checked bitwise against
``as_is``) and ``fma`` for scale.

Prints the card's name and power limit, one line per variant, and the
variants as one JSON object last. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from ablate_short_fwd import (F32_VARIANTS, TEMPORAL, TEMPORAL_RIGHT,  # noqa: E402
                              TEMPORAL_VARIANTS, build_library, edited, f32_only_steps)
from laryngeal_tpu_torch.ops import _build  # noqa: E402

SHAPE = (256, 197, 12, 64)
# Only the 4-chunk instances of the wgmma backward are built.
DISPATCH = ("  if (nb == 3) SHORT_BWD_NB(3);\n  SHORT_BWD_NB(2);",
            "  SHORT_BWD_NB(4);")
PHASE_A = """      for (int qt = wg; qt < NB; qt += kBwdConsumers) {
        hopper::mbar_wait(&qd_full[qt], i & 1);
        bwd_rows<HD, NB, TW>(q_s, do_s, k_s, v_s, pair_stats, dq + b * st.dqb + h * st.dqh,
                             st.dqn, qt, N, D, sl2, scale, warp, g, t4);
      }
"""
PHASE_B = """      for (int kt = wg; kt < NB; kt += kBwdConsumers)
        bwd_keys<HD, NB, TW>(q_s, do_s, k_s, v_s, pair_stats, dk + b * st.dkb + h * st.dkh,
                             st.dkn, dv + b * st.dvb + h * st.dvh, st.dvn, kt, N, D, sl2, scale,
                             kt + kBwdConsumers >= NB ? qd_empty : nullptr, warp, lane, g, t4);
"""
RELEASE_QD = """      __syncwarp();  // ablation: release every chunk of Q and dO
      if (lane == 0)
        for (int j = 0; j < NB; ++j) hopper::mbar_arrive(&qd_empty[j]);
"""
CONST_STATS = """      for (int r = tid % 128 + 128 * wg; r < 64 * NB; r += 128 * kBwdConsumers) {
        pair_stats[r] = 0.f;  // ablation: no phase A, constant statistics
        pair_stats[kWgMaxN + r] = 1.f / N;
        pair_stats[2 * kWgMaxN + r] = 0.f;
      }
"""
SOFTMAX_START = "  // Keys >= N masked; the row max of rows g and g + 8 of this warp's 16 in\n"
SOFTMAX_END = "  // delta = sum_k P dP:"
NO_SOFTMAX = ("  auto live = [](int c, int i) { return c < NB - 1 || i < TW / 2; };\n"
              "  float mb[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};  // ablation: no softmax\n")
DSCORES = ("      a[kk][r] = pack_bf16(p[i] * (dp[i] - dl) * scale, "
           "p[i + 1] * (dp[i + 1] - dl) * scale);")
PT_START = "    for (int jj = 0; jj < 8; ++jj) {\n      if (j < NB - 1 || (jj < TW / 8"
PT_END = "    const unsigned char* q_j = q_s + j * kT;"


def _cut(text: str, start: str, end: str, insert: str) -> str:
    """``text`` with [start, end) replaced by ``insert``."""
    i, j = text.index(start), text.index(end)
    return text[:i] + insert + text[j:]


VARIANTS = {
    "as_is": [],
    "loads_only": [[PHASE_A, ""], [PHASE_B, RELEASE_QD],
                   ["hopper::named_sync(1, 128 * kBwdConsumers);", ";"]],
    "products_only": [["cut", SOFTMAX_START, SOFTMAX_END, NO_SOFTMAX],
                      [DSCORES, "      a[kk][r] = pack_bf16(dp[i], dp[i + 1]);"],
                      ["cut", PT_START, PT_END, ""]],
    "phase_a_only": [[PHASE_B, RELEASE_QD]],
    "phase_b_only": [[PHASE_A, CONST_STATS]],
    "no_exp2": [["hopper::exp2_approx(", "("]],
    "one_consumer": [["constexpr int kBwdConsumers = 2;", "constexpr int kBwdConsumers = 1;"]],
    "no_prefetch": [["constexpr int kBwdKvStages = 2;", "constexpr int kBwdKvStages = 1;"]],
    "tail_256": [["constexpr int kBwdTailKeys = 16;", "constexpr int kBwdTailKeys = 0;"]],
    "tail_200": [["constexpr int kBwdTailKeys = 16;", "constexpr int kBwdTailKeys = 8;"]],
}
RIGHT = ("as_is", "one_consumer", "no_prefetch", "tail_256", "tail_200")
BWD_F32_VARIANTS = {**F32_VARIANTS, "dq_only": [
    ["  if ((err = set_smem(short_bwd_dkv_tf32_kernel, kDkvSmem)) != cudaSuccess) return err;",
     "  return err;  // ablation: launch 1 alone"]]}


def variant_source(name: str) -> str:
    text = (_build.CSRC_DIR / "short_attention.cu").read_text()
    for edit in [list(DISPATCH)] + VARIANTS.get(name, []):
        anchors = edit[1:3] if edit[0] == "cut" else edit[:1]
        for a in anchors:
            if a not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {a[:60]!r}")
        text = _cut(text, *edit[1:]) if edit[0] == "cut" else text.replace(edit[0], edit[1])
    return text


def build(name: str, workdir: Path, f32: bool, temporal: bool = False):
    if temporal:
        dll, out = build_library(
            name, workdir, variant_source("as_is"),
            f32_only_steps((_build.CSRC_DIR / "short_attention_tf32.cu").read_text()),
            edited("short_attention_tf32_mma.cu", TEMPORAL_VARIANTS[name], name))
    elif f32:
        tf32_text = f32_only_steps(edited("short_attention_tf32.cu", BWD_F32_VARIANTS[name],
                                          name))
        dll, out = build_library(name, workdir, variant_source("as_is"), tf32_text)
    else:
        dll, out = build_library(name, workdir, variant_source(name),
                                 (_build.CSRC_DIR / "short_attention_tf32.cu").read_text())
    fns = {}
    for entry in ("short_attention_bwd", "short_attention_bwd_mma"):
        fn = getattr(dll, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
        fns[entry] = fn
    scratch = dll.short_attention_scratch_floats
    scratch.restype = ctypes.c_longlong
    scratch.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    fns["scratch_floats"] = scratch
    spills, kernel = [], None  # the bf16 wgmma and f32 mma backward's instances that spill
    for line in out.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(short_bwd_wgmma_kernel|short_bwd_mma_tf32_kernel)I((?:Li\d+E)+)E",
                          line)
            kernel = (f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
                      if m else None)
        elif kernel and "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{kernel}: {line.strip()}")
    return fns, spills


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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--f32", action="store_true",
                        help="ablate the f32 design wgmma.tf32x3 in f32")
    parser.add_argument("--temporal", action="store_true",
                        help="with --f32: the mma.tf32x3 design at the temporal shape")
    args = parser.parse_args()
    if args.temporal and not args.f32:
        parser.error("--temporal ablates the f32 design: give --f32 too")
    f32, temporal = args.f32, args.temporal
    if not torch.cuda.is_available():
        print("ablate_short_bwd: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dtype, variants = (torch.float32, BWD_F32_VARIANTS) if f32 else (torch.bfloat16, VARIANTS)
    if temporal:
        variants = TEMPORAL_VARIANTS
    shape = TEMPORAL if temporal else SHAPE
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype).unbind(2)
    g = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
    outs = [torch.empty((b, n, h, d), dtype=dtype, device="cuda") for _ in range(3)]
    strides = (ctypes.c_longlong * 21)(*(s for x in (q, k, v, g, *outs) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream
    code = 0 if f32 else 1
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda name: build(name, Path(tmp), f32, temporal),
                                            variants)))
        for name, (_, spills) in built.items():
            for line in spills:
                print(f"{name}: ptxas {line}", flush=True)
        floats = built["as_is"][0]["scratch_floats"](code, b, n, h, d, strides, 0)
        scratch = torch.empty(max(floats, 1), dtype=torch.float32, device="cuda")

        def launch(name, entry="short_attention_bwd"):
            err = built[name][0][entry](*(x.data_ptr() for x in (q, k, v, g, *outs)),
                                        scratch.data_ptr(), code, b, n, h, d, strides,
                                        1.0 / math.sqrt(d), stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed: cudaError {err}")

        launch("as_is")
        want = [x.clone() for x in outs]
        for name in TEMPORAL_RIGHT if temporal else [] if f32 else RIGHT[1:]:
            launch(name)
            torch.cuda.synchronize()
            diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(outs, want))
            print(f"{name}: max |d| against as_is {diff:.3e}", flush=True)
            if name.startswith("stages") and diff != 0:
                raise AssertionError(f"{name} differs from as_is")
        fns = {name: (lambda name=name: launch(name)) for name in variants}
        fns["fma" if f32 else "mma_sync"] = lambda: launch("as_is", "short_attention_bwd_mma")
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(queued_ms(fns[name]))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in ms.items():
        print(f"{name}: {t:.4f} ms ({t / ms['as_is']:.3f} of as_is)", flush=True)
    print(json.dumps({"shape": list(shape), "dtype": str(dtype)[6:], "queued_ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
