"""What kernel 6's wgmma design spends its time on, on one CUDA card.

    python3 scripts/ablate_short_fwd.py

Builds ``laryngeal_tpu_torch/csrc/short_attention.cu`` as it is and with one
part of the wgmma kernel's work taken out at a time (text edits of a copy in
a temporary directory; every variant but ``as_is`` computes a wrong result
by design), then times each at TimeSformer-B's spatial shape (256, 197, 12,
64) bf16 on views of a fused qkv: 20 launches back to back between CUDA
events, the median of 3 rounds, in turns. Variants:

- ``as_is``: the kernel;
- ``loads_only``: the consumers take no tile (the TMA loads and the stage
  ring alone);
- ``s_only``: each tile stops after S = Q K^T;
- ``no_pv``: each tile stops once P is packed (no P V, no O);
- ``no_exp2``: exp2 replaced by its argument (the special-function unit's
  share);
- ``no_cvt``: the f32 -> bf16 pack of P replaced by a byte permute (the
  conversion's share).

Prints the card's name and power limit, one line per variant, and the
variants as one JSON object last. Needs nvcc and a card.
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


def build(name: str, workdir: Path):
    text = (_build.CSRC_DIR / "short_attention.cu").read_text()
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
    fn = ctypes.CDLL(str(lib)).short_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    return fn


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
        print("ablate_short_fwd: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    b, n, h, d = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16).unbind(2)
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device="cuda")
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(lambda name: build(name, Path(tmp)), VARIANTS)))

        def launch(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, n, h, d,
                     strides, 1.0 / math.sqrt(d), stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        times = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                times[name].append(queued_ms(lambda: launch(fns[name])))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in ms.items():
        print(f"{name}: {t:.4f} ms ({t / ms['as_is']:.3f} of as_is)", flush=True)
    print(json.dumps({"shape": list(SHAPE), "queued_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
