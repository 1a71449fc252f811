"""The port imports neither JAX nor any module of the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "laryngeal_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))

# `import jax`, `from jax...`, `import laryngeal_tpu`, `from laryngeal_tpu.x`
# but not the port's own name, which shares the prefix.
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|laryngeal_tpu)(?![\w])",
    re.MULTILINE)


def test_every_module_is_listed():
    assert "laryngeal_tpu_torch" in MODULES
    assert "laryngeal_tpu_torch.ops.flash_attention" in MODULES
    assert "laryngeal_tpu_torch.cli.serve" in MODULES
    assert "laryngeal_tpu_torch.ops.short_attention" in MODULES
    assert "laryngeal_tpu_torch.models.timesformer" in MODULES
    assert "laryngeal_tpu_torch.ops.window_attention" in MODULES
    assert "laryngeal_tpu_torch.models.swin3d" in MODULES
    assert "laryngeal_tpu_torch.ops.tubelet" in MODULES
    assert "laryngeal_tpu_torch.models.resnet3d" in MODULES
    assert "laryngeal_tpu_torch.models.resnet" in MODULES
    for name in ("ops.remat", "compat.loading", "compat.manifests", "utils.profiling",
                 "data.native", "preprocess.dct_wire", "preprocess.pil_resize"):
        assert f"laryngeal_tpu_torch.{name}" in MODULES


def test_native_library_builds_from_the_port_s_own_source():
    """The port compiles its own copy of the C++ decoder into its own build
    directory and reads nothing of the JAX package's ``native/``."""
    text = (PORT / "data" / "native.py").read_text()
    assert (PORT / "native" / "cliploader.cpp").is_file()
    assert 'PKG_DIR / "native" / "cliploader.cpp"' in text and 'PKG_DIR / "_build"' in text
    assert "parent.parent.parent" not in text and "make" not in text.split()


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'laryngeal_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'laryngeal_tpu_torch.ops.flash_attention' in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    assert not FORBIDDEN.findall(path.read_text())


def test_pattern_catches_jax_imports():
    for line in ("import jax", "from jax import numpy", "import laryngeal_tpu",
                 "from laryngeal_tpu.ops import attention", "  import flax.linen as nn"):
        assert FORBIDDEN.search(line), line
    for line in ("import laryngeal_tpu_torch", "from laryngeal_tpu_torch.ops import x",
                 "import jaxtyping_like_name_x"):
        assert not FORBIDDEN.search(line), line
