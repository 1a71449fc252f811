"""What kernel 10's wgmma designs (the tubelet embedding) spend their time on,
on one CUDA card.

    python3 scripts/ablate_tubelet.py         # bf16, the wgmma design
    python3 scripts/ablate_tubelet.py --f32   # f32, the wgmma.tf32x3 design

Builds the tubelet library (``laryngeal_tpu_torch/csrc/tubelet_embed.cu`` and
``tubelet_embed_wgmma.cu``) as it is and with one part of the wgmma kernel's
work taken out or changed at a time (text edits of a copy in a temporary
directory, all variants built at once; the variants that take work out
compute a wrong result by design, the others the right one), then times
kernel 10 of each at the ViViT-B stem (video (8, 32, 224, 224, 3), D = 768):
20 launches back to back between CUDA events, the median of 3 rounds, the
variants in turns (in order, then reversed). Variants:

- ``as_is``: the kernel;
- ``loads_only``: the consumers wait for each stage and release it (the
  pre-pass, the loads and the ring alone);
- ``no_epilogue``: no output is stored;
- ``no_a_loads``, ``no_b_loads``: no A (video) boxes, or no B (W^T) boxes;
- ``products_only``: no loads at all: the consumers multiply whatever the
  ring holds (the products and the epilogue alone);
- ``no_cluster``: one CTA a tile, each loading its own A tile (the D tiles
  of one M tile read its lines from L2 at about the same time), instead of
  a cluster sharing the A loads by multicast;
- ``wait_each_step``: (bf16) each step's products waited for before the
  next are issued, instead of one batch kept in flight;
- ``half_b``: TMA brings half of each B tile's rows (its L2 traffic halved);
- ``stages_3``: a ring of 3 stages instead of 5 (bf16) or 3 (f32: 2).

Prints each variant's max |err| against the plain twin, its time and its
share of ``as_is``, then the times as one JSON object last. Needs nvcc and a
card. Exits 1 if a variant does not build (the others are still timed,
unless it is ``as_is``).
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
from laryngeal_tpu_torch.ops import tubelet as tt  # noqa: E402

VIDEO, D, TUBELET = (8, 32, 224, 224, 3), 768, (2, 16, 16)
SOURCES = ("tubelet_embed.cu", "tubelet_embed_wgmma.cu")
HEADER = "hopper.cuh"
F32 = "--f32" in sys.argv[1:]
DTYPE = torch.float32 if F32 else torch.bfloat16
WAIT = "        hopper::mbar_wait(&full[st], (it / S) & 1);\n"
VARIANTS = {
    "as_is": [],
    "loads_only": [(WAIT, WAIT + "        if (true) { release(st); continue; }\n")],
    "no_epilogue": [("if (m < 0) continue;", "if (m < 0 || m >= 0) continue;"),
                    ("if (m >= 0 && col < g.D)", "if (m < -1 && col < g.D)")],
    "no_a_loads": [("          if (mine) {", "          if (false) {"),
                   ("bytes = valid * kSlotRows", "bytes = 0 * kSlotRows")],
    "no_b_loads": [("            for (int f = 0; f < C::kForms; ++f) {",
                    "            for (int f = 0; f < 0; ++f) {"),
                   ("C::kRow + C::kForms * C::kBForm;", "C::kRow;")],
    "products_only": [("    if (threadIdx.x < 32) {", "    if (false) {"), (WAIT, "")],
    "no_cluster": [("  g.cluster = g.tiles_n % 4 == 0 ? 4 : g.tiles_n % 2 == 0 ? 2 : 1;",
                    "  g.cluster = 1;")],
    "wait_each_step": [("hopper::wgmma_wait<1>();", "hopper::wgmma_wait<0>();")],
    "half_b": [("(unsigned)C::kBN, 1};", "(unsigned)C::kBN / 2, 1};"),
               ("(unsigned)C::kBN, 1};", "(unsigned)C::kBN / 2, 1};"),
               ("C::kRow + C::kForms * C::kBForm;", "C::kRow + C::kForms * C::kBForm / 2;")],
    "stages_3": [("  static constexpr int kStages = kFit > 8 ? 8 : kFit;",
                  f"  static constexpr int kStages = {2 if F32 else 3};")],
}


def build(name: str, workdir: Path):
    """The variant's ``tubelet_embed`` entry from a library built in
    ``workdir``. An edit applies to the first file that holds its text (an
    edit listed twice applies to the first two places); the sources and
    copies of every header, ``hopper.cuh`` edited or not, sit in one
    directory."""
    files = {f: (_build.CSRC_DIR / f).read_text() for f in (*SOURCES, HEADER)}
    for old, new in VARIANTS[name]:
        where = next((f for f, text in files.items() if old in text), None)
        if where is None:
            raise RuntimeError(f"variant {name}: the sources no longer hold {old[:60]!r}")
        files[where] = files[where].replace(old, new, 1)
    vdir = workdir / name
    vdir.mkdir()
    for header in _build.CSRC_DIR.glob("*.cuh"):  # every include resolves in vdir
        (vdir / header.name).write_text(header.read_text())
    for f, text in files.items():
        (vdir / f).write_text(text)
    lib = workdir / f"{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           *(str(vdir / s) for s in SOURCES)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), "tubelet_embed")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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
        print("ablate_tubelet: no CUDA device is available", file=sys.stderr)
        return 2
    if not set(sys.argv[1:]) <= {"--f32"}:
        print("usage: ablate_tubelet.py [--f32]", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    video = torch.randn(VIDEO, generator=gen, device="cuda").to(DTYPE)
    fan_in = TUBELET[0] * TUBELET[1] * TUBELET[2] * VIDEO[-1]
    kernel = torch.randn((*TUBELET, VIDEO[-1], D), generator=gen, device="cuda") / fan_in ** 0.5
    bias = 0.1 * torch.randn((D,), generator=gen, device="cuda")

    def try_build(name, tmp):
        try:
            return build(name, Path(tmp))
        except RuntimeError as err:  # a variant that does not build is reported, not timed
            print(f"{name}: not built: {str(err)[:2000]}", flush=True)
            return None

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda name: try_build(name, tmp), VARIANTS)))
        libs = {name: fn for name, fn in built.items() if fn is not None}
        not_built = [name for name in VARIANTS if name not in libs]
        if "as_is" in not_built:
            return 1
        call = lambda: tt.tubelet_embed_cuda(video, kernel, bias, TUBELET)  # noqa: E731
        tt._c_fn("tubelet_embed_scratch_bytes", ctypes.c_longlong, [ctypes.c_int] * 7)
        ref = tt.tubelet_embed_plain(video, kernel, bias, TUBELET).float()
        for name, fn in libs.items():  # variants that take work out are wrong by design
            tt._fns["tubelet_embed"] = fn  # the wrapper launches the variant
            err = (call().float() - ref).abs().max().item()
            print(f"{name}: max |err| against the plain twin {err:.3e}", flush=True)
        del ref
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                tt._fns["tubelet_embed"] = libs[name]
                times[name].append(queued_ms(call))
        tt._fns.pop("tubelet_embed")
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    for name, t in ms.items():
        print(f"{name}: {t:.4f} ms ({t / ms['as_is']:.3f} of as_is)", flush=True)
    print(json.dumps({"video": list(VIDEO), "d": D, "dtype": str(DTYPE)[6:], "queued_ms": ms,
                      "not_built": not_built}), flush=True)
    return 1 if not_built else 0


if __name__ == "__main__":
    sys.exit(main())
