"""Expected torch state-dict layouts (key -> shape) of the pretrained
checkpoints the reference fine-tunes: the port's own copy of
``laryngeal_tpu/compat/manifests.py``, transcribed from the upstream module
definitions, not from the port's models, so that a drift of the port's
parameter names or shapes from the checkpoints ``--torch_weights`` loads
fails a test:

- ``swin3d_manifest``: torchvision ``swin3d_t/s/b``
  (torchvision/models/video/swin_transformer.py ``SwinTransformer3d``:
  patch_embed.{proj,norm}; features[0,2,4,6] = block stages with norm1 /
  attn.{relative_position_bias_table, relative_position_index buffer, qkv,
  proj} / norm2 / mlp.{0,3}; features[1,3,5] = PatchMerging {reduction
  (bias-free), norm}; final norm; head). Reference use:
  videoswintransformer/swin_video_classifier/models/swin3d.py:7-53.
- ``resnet3d_manifest``: pytorchvideo ``create_resnet`` with the kwargs of
  resnet50-3d-video/video_classifier/models/resnet3d.py:8-46
  (pytorchvideo/models/resnet.py ``Net.blocks``: [0] = ResNetBasicStem
  {conv, norm}; [1..4] = ResStage.res_blocks with branch1_{conv,norm}
  projections and branch2 BottleneckBlock {conv,norm}_{a,b,c}; [5] =
  ResNetBasicHead {proj}).

The YOLOv5 manifest comes with the glottis stage (ROADMAP A9). All shapes
are torch conventions: Linear (out, in), ConvNd (out, in, *k), BatchNorm
running stats 1-D and a scalar ``num_batches_tracked``.
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]

# Keys of real checkpoints that the port's models do not hold (buffers they
# recompute).
IGNORABLE_PATTERNS = (
    "relative_position_index",    # recomputed from the window geometry
)


def is_ignorable(key: str) -> bool:
    return any(p in key for p in IGNORABLE_PATTERNS)


def _bn(m: Dict[str, Shape], prefix: str, c: int) -> None:
    m[f"{prefix}.weight"] = (c,)
    m[f"{prefix}.bias"] = (c,)
    m[f"{prefix}.running_mean"] = (c,)
    m[f"{prefix}.running_var"] = (c,)
    m[f"{prefix}.num_batches_tracked"] = ()


def _ln(m: Dict[str, Shape], prefix: str, c: int) -> None:
    m[f"{prefix}.weight"] = (c,)
    m[f"{prefix}.bias"] = (c,)


def _linear(m: Dict[str, Shape], prefix: str, out: int, inp: int,
            bias: bool = True) -> None:
    m[f"{prefix}.weight"] = (out, inp)
    if bias:
        m[f"{prefix}.bias"] = (out,)


SWIN3D_SPECS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24)),
    "small": dict(embed_dim=96, depths=(2, 2, 18, 2), heads=(3, 6, 12, 24)),
    "base": dict(embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32)),
    "base_in22k": dict(embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32)),
}


def swin3d_manifest(size: str = "tiny", num_classes: int = 400,
                    window=(8, 7, 7), patch=(2, 4, 4)) -> Dict[str, Shape]:
    """torchvision SwinTransformer3d state dict (Kinetics-400 head=400)."""
    spec = SWIN3D_SPECS[size]
    c = spec["embed_dim"]
    m: Dict[str, Shape] = {}
    m["patch_embed.proj.weight"] = (c, 3) + tuple(patch)
    m["patch_embed.proj.bias"] = (c,)
    _ln(m, "patch_embed.norm", c)

    n_win = window[0] * window[1] * window[2]
    table_rows = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
    for stage, (depth, heads) in enumerate(zip(spec["depths"], spec["heads"])):
        dim = c * (2 ** stage)
        feat = 2 * stage
        for i in range(depth):
            p = f"features.{feat}.{i}"
            _ln(m, f"{p}.norm1", dim)
            m[f"{p}.attn.relative_position_bias_table"] = (table_rows, heads)
            m[f"{p}.attn.relative_position_index"] = (n_win, n_win)
            _linear(m, f"{p}.attn.qkv", 3 * dim, dim)
            _linear(m, f"{p}.attn.proj", dim, dim)
            _ln(m, f"{p}.norm2", dim)
            _linear(m, f"{p}.mlp.0", 4 * dim, dim)
            _linear(m, f"{p}.mlp.3", dim, 4 * dim)
        if stage < len(spec["depths"]) - 1:
            mp = f"features.{feat + 1}"
            _linear(m, f"{mp}.reduction", 2 * dim, 4 * dim, bias=False)
            _ln(m, f"{mp}.norm", 4 * dim)

    final = c * (2 ** (len(spec["depths"]) - 1))
    _ln(m, "norm", final)
    _linear(m, "head", num_classes, final)
    return m


# Exact kwargs of resnet50-3d-video/.../models/resnet3d.py:8-46.
_R3D_STAGE_BLOCKS = (3, 4, 6, 3)
_R3D_CONV_A_T = (1, 1, 3, 3)  # stage_conv_a_kernel_size temporal extents


def resnet3d_manifest(num_classes: int = 2) -> Dict[str, Shape]:
    """pytorchvideo create_resnet(model_depth=50) state dict."""
    m: Dict[str, Shape] = {}
    m["blocks.0.conv.weight"] = (64, 3, 3, 7, 7)  # stem (3,7,7), bias=False
    _bn(m, "blocks.0.norm", 64)
    dim_in = 64
    for stage, blocks in enumerate(_R3D_STAGE_BLOCKS):
        inner = 64 * (2 ** stage)
        out = 4 * inner
        ka = _R3D_CONV_A_T[stage]
        for i in range(blocks):
            p = f"blocks.{stage + 1}.res_blocks.{i}"
            if i == 0:  # projection shortcut (dim change)
                m[f"{p}.branch1_conv.weight"] = (out, dim_in, 1, 1, 1)
                _bn(m, f"{p}.branch1_norm", out)
            m[f"{p}.branch2.conv_a.weight"] = (inner, dim_in if i == 0 else out,
                                               ka, 1, 1)
            _bn(m, f"{p}.branch2.norm_a", inner)
            m[f"{p}.branch2.conv_b.weight"] = (inner, inner, 1, 3, 3)
            _bn(m, f"{p}.branch2.norm_b", inner)
            m[f"{p}.branch2.conv_c.weight"] = (out, inner, 1, 1, 1)
            _bn(m, f"{p}.branch2.norm_c", out)
        dim_in = out
    _linear(m, "blocks.5.proj", num_classes, 2048)
    return m


MANIFESTS = {
    "swin3d": swin3d_manifest,
    "resnet3d": resnet3d_manifest,
}


def validate_state_dict(state, manifest: Dict[str, Shape],
                        allow_extra: bool = False):
    """Compare a (numpy-ified) state dict against a manifest.

    Returns (missing, extra, mismatched) — empty lists mean a clean match.
    ``allow_extra`` tolerates unknown keys (e.g. EMA or optimizer entries in
    full ultralytics checkpoints) but still reports shape mismatches.
    """
    missing = [k for k in manifest if k not in state]
    extra = [] if allow_extra else [k for k in state if k not in manifest]
    mismatched = []
    for k, shape in manifest.items():
        if k in state:
            got = tuple(getattr(state[k], "shape", ()))
            if got != tuple(shape):
                mismatched.append((k, got, tuple(shape)))
    return missing, extra, mismatched
