"""What kernel 6's wgmma designs spend their time on, on one CUDA card.

    python3 scripts/ablate_short_fwd.py [--f32 [--temporal]]

Builds the short-attention library (``laryngeal_tpu_torch/csrc/
short_attention.cu`` with its f32 members ``short_attention_tf32.cu`` and
``short_attention_tf32_mma.cu``) as it is and with one part of the kernel's
work taken out at a time (text edits of
a copy in a temporary directory, each variant built by its own ``nvcc``;
every variant but ``as_is`` computes a wrong result by design), then times
each at TimeSformer-B's spatial shape (256, 197, 12, 64) on views of a fused
qkv: 20 launches back to back between CUDA events, the median of 3 rounds,
in turns (in order, then reversed). Without ``--f32``, the bf16 wgmma
design in bf16:

- ``as_is``: the kernel;
- ``loads_only``: the consumers take no tile (the TMA loads and the stage
  ring alone);
- ``s_only``: each tile stops after S = Q K^T;
- ``no_pv``: each tile stops once P is packed (no P V, no O);
- ``no_exp2``: exp2 replaced by its argument (the special-function unit's
  share);
- ``no_cvt``: the f32 -> bf16 pack of P replaced by a byte permute (the
  conversion's share).

With ``--f32``, the f32 design ``wgmma.tf32x3`` in f32 (only its 7-step
instances, N = 193..224, are built; ``F32_VARIANTS``, shared with
``ablate_short_bwd.py --f32``):

- ``as_is``: the kernel; ``fma``: the FMA design (the ``_mma`` entry), for
  scale;
- ``loads_only``: the TMA loads, the transform warps' splits and the ring's
  barriers; no products, no softmax, nothing stored;
- ``no_split``: the transform warps release each slot unsplit (the split's
  share);
- ``no_products``: no wgmma (the tensor cores' share);
- ``one_tf32``: one TF32 product (big.big) a product instead of three;
- ``no_exp``: exp2 replaced by its argument.

With ``--f32 --temporal``, the f32 design ``mma.tf32x3`` at TimeSformer-B's
temporal shape (1568, 32, 12, 64) on views of a fused qkv (every instance of
it built, the wgmma.tf32x3 member only at 7 steps; ``TEMPORAL_VARIANTS``,
shared with ``ablate_short_bwd.py --f32 --temporal``):

- ``as_is``: the kernel; ``fma``: the FMA design (the ``_mma`` entry), for
  scale;
- ``loads_only``: the TMA loads and the ring's barriers alone (the consumer
  warps release each pair as it arrives: no products, no softmax, nothing
  stored);
- ``no_products``: no mma.sync (the tensor cores' share; the fragments are
  still read and split);
- ``one_term_tf32``: one TF32 product (big.big) a product instead of three;
- ``no_exp``: exp2 replaced by its argument;
- ``one_chain``: each product's three terms summed in one accumulator (a
  chain of dependent mma three deep a step) instead of the small terms in
  an accumulator of their own;
- ``stages_1``, ``stages_2``, ``stages_3``: rings of 1, 2 or 3 pair stages
  a block in both kernels (``as_is``: 2 in the forward, 1 in the backward;
  more blocks an SM against more pairs in flight a block).

The choices compute the right result: the stage counts bitwise, one_chain
with its sums in another order (its largest difference from ``as_is`` is
printed).

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
from laryngeal_tpu_torch.ops import _build  # noqa: E402

SHAPE = (256, 197, 12, 64)
PACK = ("        pa[c][kk][r] = pack_bf16(s[c][8 * kk + 2 * r] * inv[r & 1],\n"
        "                                 s[c][8 * kk + 2 * r + 1] * inv[r & 1]);")
SINK_P = ("  {\n    uint32_t x = 0;\n#pragma unroll\n    for (int c = 0; c < NB; ++c)\n"
          "#pragma unroll\n      for (int kk = 0; kk < 4; ++kk)\n#pragma unroll\n"
          "        for (int r = 0; r < 4; ++r) x ^= pa[c][kk][r];\n"
          "    if (x == 0x9e3779b9u) tile[0] = 1;\n    if (N > 0) return;\n  }\n")
ACC = "  float acc[T::kPanels][T::kPanelCols / 2];\n  hopper::wgmma_fence();"
VARIANTS = {
    "as_is": [],
    "loads_only": [["for (int qt = wg; qt < nb; qt += 2)", "for (int qt = wg; qt < 0; qt += 2)"]],
    "s_only": [["  // Keys >= N (the last chunk's tail) are masked;",
                "  if (N > 0) return;\n  // Keys >= N (the last chunk's tail) are masked;"]],
    "no_pv": [[ACC, SINK_P + ACC]],
    "no_exp2": [["hopper::exp2_approx(fmaf(s[c][4 * j + e], scale_log2, -mb[e >> 1]))",
                 "fmaf(s[c][4 * j + e], scale_log2, -mb[e >> 1])"]],
    "no_cvt": [[PACK, "        pa[c][kk][r] = __byte_perm(__float_as_uint(s[c][8 * kk + 2 * r]),"
                      " __float_as_uint(s[c][8 * kk + 2 * r + 1]), 0x7632);"]],
}


# The f32 design's three products a product (short_attention_tf32.cu).
_RS = ("    hopper::wgmma_m64n32k8_tf32_rs(d, as[k], bb + off, k > 0);\n"
       "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bs + off, 1);\n"
       "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + off, 1);\n")
_SS = ("    hopper::wgmma_m64n32k8_tf32_ss(d, das + oa, bb + ob, k > 0);\n"
       "    hopper::wgmma_m64n32k8_tf32_ss(d, dab + oa, bs + ob, 1);\n"
       "    hopper::wgmma_m64n32k8_tf32_ss(d, dab + oa, bb + ob, 1);\n")
_AB = ("    hopper::wgmma_m64n64k8_tf32_rs(acc, as[kk], bb + 2 * kk, accumulate || kk > 0);\n"
       "    hopper::wgmma_m64n64k8_tf32_rs(acc, ab[kk], bs + 2 * kk, 1);\n"
       "    hopper::wgmma_m64n64k8_tf32_rs(acc, ab[kk], bb + 2 * kk, 1);\n")
NO_PRODUCTS = [[_RS, ""], [_SS, ""], [_AB, ""]]
F32_VARIANTS = {
    "as_is": [],
    "loads_only": NO_PRODUCTS + [
        ["softmax_rows<NS>(s, N, sl2, t4, mb, inv);",
         "mb[0] = mb[1] = 0.f, inv[0] = inv[1] = 1.f;  // ablation: no softmax"],
        ["    if (row >= N) continue;\n", "    if (row >= 0) continue;  // ablation: no stores\n"],
        ["      if (t4 == 0) {\n        float* st = stats",
         "      if (t4 > 3) {  // ablation: no statistics\n        float* st = stats"]],
    "no_split": [
        ["split_rows<kStep>(ring.arrived(idx), tid);", "ring.arrived(idx);  // ablation"],
        ["          transpose(p, p + kStep, p + kStep + kT, tw, lane);\n", ""],
        ["        split_rows<2 * kTile>(do_s, tid);\n", ""],
        ["          transpose(p, p + 2 * kStep, p + 2 * kStep + kT, tw, lane);\n", ""],
        ["          split_rows<kStep>(p, tid);\n", ""]],
    "no_products": NO_PRODUCTS,
    "one_tf32": [
        [_RS, "    hopper::wgmma_m64n32k8_tf32_rs(d, ab[k], bb + off, k > 0);\n"],
        [_SS, "    hopper::wgmma_m64n32k8_tf32_ss(d, dab + oa, bb + ob, k > 0);\n"],
        [_AB, "    hopper::wgmma_m64n64k8_tf32_rs(acc, ab[kk], bb + 2 * kk, "
              "accumulate || kk > 0);\n"]],
    "no_exp": [["hopper::exp2_approx(", "("]],
}
F32_STEPS = 7  # the spatial shape's 32-key steps: only these instances are built

TEMPORAL = (1568, 32, 12, 64)
# The mma.tf32x3 design's three products a product (short_attention_tf32_mma.cu).
_MMA3 = "  mma(c, as, bb);\n  mma(c, ab, bs);\n  mma(d, ab, bb);\n"
_CONSUMER_WAITS = [f"    hopper::mbar_wait(&full[s], (i / k{k}Stages) & 1);\n"
                   for k in ("Fwd", "Bwd")]
_RELEASE = ("    if (N > 0) {  // ablation: no compute, nothing stored\n"
            "      __syncwarp();\n      if (lane == 0) hopper::mbar_arrive(&empty[s]);\n"
            "      continue;\n    }\n")
TEMPORAL_VARIANTS = {
    "as_is": [],
    "loads_only": [[w, w + _RELEASE] for w in _CONSUMER_WAITS],
    "no_products": [[_MMA3, '  asm volatile("" :: "r"(ab[0]), "r"(ab[1]), "r"(ab[2]), '
                            '"r"(ab[3]), "r"(as[0]), "r"(as[1]), "r"(as[2]), "r"(as[3]), '
                            '"r"(bb[0]), "r"(bb[1]), "r"(bs[0]), "r"(bs[1]));  // ablation\n']],
    "one_term_tf32": [[_MMA3, "  mma(d, ab, bb);\n"]],
    "no_exp": [["hopper::exp2_approx(", "("]],
    "one_chain": [["mma3(s[j], c[j],", "mma3(s[j], s[j],"],
                  ["mma3(acc[j], c[j],", "mma3(acc[j], acc[j],"],
                  ["mma3(adq[j], cq[j],", "mma3(adq[j], adq[j],"]],
    **{f"stages_{n}": [["constexpr int kFwdStages = 2, kBwdStages = 1;",
                        f"constexpr int kFwdStages = {n}, kBwdStages = {n};"]] for n in (1, 2, 3)},
}
# The choices that compute the right result: one_chain in another order (its
# largest difference from as_is is printed), the stage counts bitwise.
TEMPORAL_RIGHT = ("one_chain", "stages_1", "stages_2", "stages_3")


def edited(source: str, edits, name: str) -> str:
    """``csrc/<source>`` with every occurrence of each edit's first string
    replaced by its second; raises if one is missing."""
    text = (_build.CSRC_DIR / source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: {source} no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def f32_only_steps(text: str, steps: int = F32_STEPS) -> str:
    """short_attention_tf32.cu with the dispatch of every other step count
    taken out (the instances it would build)."""
    return "\n".join(line for line in text.split("\n")
                     if not re.match(r"\s+case (\d+): (return launch_fwd|err = launch_dq)", line)
                     or line.strip().startswith(f"case {steps}:"))


def build_library(name: str, workdir: Path, bf16_text: str, tf32_text: str,
                  mma_text: str = None):
    """The three members as one shared library (as ops/_build.py links
    them; ``mma_text`` None for short_attention_tf32_mma.cu as it is);
    returns (the loaded library, nvcc's output)."""
    if mma_text is None:
        mma_text = (_build.CSRC_DIR / "short_attention_tf32_mma.cu").read_text()
    srcs = [workdir / f"{name}.cu", workdir / f"{name}_tf32.cu", workdir / f"{name}_tf32_mma.cu"]
    for src, text in zip(srcs, (bf16_text, tf32_text, mma_text)):
        src.write_text(text)
    lib = workdir / f"{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(lib), *map(str, srcs)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def fwd_entry(dll, entry="short_attention_fwd"):
    fn = getattr(dll, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    return fn


def build(name: str, workdir: Path, f32: bool, temporal: bool = False):
    if temporal:
        dll, _ = build_library(
            name, workdir, (_build.CSRC_DIR / "short_attention.cu").read_text(),
            f32_only_steps((_build.CSRC_DIR / "short_attention_tf32.cu").read_text()),
            edited("short_attention_tf32_mma.cu", TEMPORAL_VARIANTS[name], name))
        return fwd_entry(dll), fwd_entry(dll, "short_attention_fwd_mma")
    if f32:
        bf16_text = (_build.CSRC_DIR / "short_attention.cu").read_text()
        tf32_text = f32_only_steps(edited("short_attention_tf32.cu", F32_VARIANTS[name], name))
    else:
        bf16_text = edited("short_attention.cu", VARIANTS[name], name)
        tf32_text = (_build.CSRC_DIR / "short_attention_tf32.cu").read_text()
    dll, _ = build_library(name, workdir, bf16_text, tf32_text)
    return fwd_entry(dll), fwd_entry(dll, "short_attention_fwd_mma")


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
        print("ablate_short_fwd: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dtype, variants = (torch.float32, F32_VARIANTS) if f32 else (torch.bfloat16, VARIANTS)
    if temporal:
        variants = TEMPORAL_VARIANTS
    shape = TEMPORAL if temporal else SHAPE
    b, n, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype).unbind(2)
    out = torch.empty((b, n, h, d), dtype=dtype, device="cuda")
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda name: build(name, Path(tmp), f32, temporal),
                                            variants)))
        fns = {name: entries[0] for name, entries in built.items()}
        if f32:
            fns["fma"] = built["as_is"][1]

        def launch(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     0 if f32 else 1, b, n, h, d, strides, 1.0 / math.sqrt(d), stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        launch(fns["as_is"])
        want = out.clone()
        for name in (TEMPORAL_RIGHT if temporal else ()):
            launch(fns[name])
            torch.cuda.synchronize()
            diff = (out - want).abs().max().item()
            print(f"{name}: max |d| against as_is {diff:.3e}", flush=True)
            if name.startswith("stages") and diff != 0:
                raise AssertionError(f"{name} differs from as_is")
        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(queued_ms(lambda: launch(fns[name])))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in ms.items():
        print(f"{name}: {t:.4f} ms ({t / ms['as_is']:.3f} of as_is)", flush=True)
    print(json.dumps({"shape": list(shape), "dtype": str(dtype)[6:], "queued_ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
