"""TimeSformer-B — divided space-time attention (PyTorch).

Counterpart of ``laryngeal_tpu/models/timesformer.py`` (both layouts,
``:42-344``): architectural parity with HF
``TimesformerForVideoClassification``
(``facebook/timesformer-base-finetuned-k400``), the model the reference
trains (``timesformer/timesformer_classifier/models/timesformer_model.py:27-43``):

- per-frame Conv2d patch embedding (16x16), spatial position embeddings per
  frame, temporal embeddings per patch; patch tokens ordered
  spatial-major, time-innermost (``n*T + t``); cls token = cls + pos[0];
- each layer: temporal attention over the T axis per spatial location
  (projected by ``temporal_dense``, residual), then spatial attention per
  frame with the cls token tiled b-major over the frames and its residual
  the mean over frames, then the MLP (exact gelu);
- a fused qkv projection (one Dense of 3*hidden) per attention.

Both attention calls of a layer go through ``ops.attention`` with
Nq == Nk < 512 (temporal N = T, spatial N = 1 + 196), so on the card they
take the short-sequence kernels (kernel 6, and kernel 7 under autograd).

- Input is channels-last (B, T, H, W, C), as in the JAX package.
- Attribute names follow the HF state dict that
  ``laryngeal_tpu/compat/torch_port.py::port_timesformer`` reads
  (``timesformer.embeddings.*``, ``timesformer.encoder.layer.N.*``,
  ``timesformer.layernorm``, ``classifier``), so ``compat/flax_weights.py``
  maps the JAX package's params across.
- Precision follows Flax's ``dtype``: parameters stay float32; the
  convolution, the projections and attention compute in ``config.dtype``;
  LayerNorms and the classifier compute in float32, and logits are float32.
- ``layout="nt"`` (the JAX ``TimesformerLayerNT``, ``:152-256``) carries
  (cls (B, 1, D), patches (B, N, T, D)) through the layers: the temporal
  split is a free reshape (kernels 6-7 at the (B·N, T) shape on the card),
  and the spatial attention (``DividedSpatialAttention``) takes the cls row
  as one extra score column per frame in einsums, plain PyTorch, as the JAX
  package computes it outside any Pallas kernel. Its parameter tree is the
  flat layout's, so checkpoints interchange. No CLI flag reaches it, in
  either package: ``create_model("timesformer", layout="nt")`` only.
- ``remat=True`` rematerialises each layer in the backward and keeps its
  attention outputs (``layers.call_block``), as the JAX model's
  ``nn.remat(..., save_only_these_names("attn_out"))`` does, the nt
  layout's two spatial contexts included: kernel 6 runs twice a layer per
  step (once in nt), kernel 7 as without remat. Nothing turns it on by
  itself; the JAX CLI does so only on a TPU.
- The JAX model's sequence-parallel hooks are no-ops on one device and are
  left out; stochastic depth is 0 in the reference and omitted there too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import remat as _remat
from ..ops.attention import dot_product_attention
from .layers import Dense, LayerNorm, Mlp, _DenseOut, call_block, gelu_exact


@dataclasses.dataclass(frozen=True)
class TimesformerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    num_frames: int = 8
    patch_size: int = 16
    num_classes: int = 2
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    remat: bool = False
    layout: str = "flat"

    def __post_init__(self):
        if self.layout not in ("flat", "nt"):
            raise ValueError(f"layout must be 'flat' or 'nt', got {self.layout!r}")

    @property
    def num_spatial_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _FusedQKV(nn.Module):
    """HF ``TimesformerSelfAttention``: the fused qkv projection."""

    def __init__(self, hidden_size: int, dtype):
        super().__init__()
        self.qkv = Dense(hidden_size, 3 * hidden_size, True, dtype)


class FusedQKVAttention(nn.Module):
    """MHA with a fused qkv Dense (HF ``TimesformerAttention`` layout:
    ``attention.qkv``, ``output.dense``). q, k and v are strided views of the
    qkv projection; the kernels read them in place."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.attention = _FusedQKV(hidden_size, dtype)
        self.output = _DenseOut(hidden_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        qkv = self.attention.qkv(x).reshape(b, n, 3, self.num_heads,
                                            self.hidden_size // self.num_heads)
        q, k, v = qkv.unbind(2)
        out = dot_product_attention(q, k, v)
        return self.output.dense(out.reshape(b, n, self.hidden_size))


class TimesformerLayer(Mlp):
    """One divided space-time layer (the JAX ``TimesformerLayer``, flat
    layout). It is its own ``Mlp`` so the MLP parameters sit directly under
    the layer, as HF names them (``intermediate.dense``, ``output.dense``)."""

    def __init__(self, cfg: TimesformerConfig):
        super().__init__(cfg.hidden_size, cfg.intermediate_size, gelu_exact, cfg.dtype)
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.num_frames = cfg.num_frames
        self.temporal_layernorm = LayerNorm(d, eps=eps)
        self.temporal_attention = FusedQKVAttention(d, cfg.num_heads, cfg.dtype)
        self.temporal_dense = Dense(d, d, True, cfg.dtype)
        self.layernorm_before = LayerNorm(d, eps=eps)
        self.attention = FusedQKVAttention(d, cfg.num_heads, cfg.dtype)
        self.layernorm_after = LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, total, d = x.shape
        t = self.num_frames
        n = (total - 1) // t  # spatial patches
        cls, patches = x[:, :1], x[:, 1:]

        # Temporal attention: (B, N*T, D) -> (B*N, T, D), a free reshape.
        h = self.temporal_attention(self.temporal_layernorm(patches.reshape(b * n, t, d)))
        patches = patches + self.temporal_dense(h.reshape(b, n * t, d))

        # Spatial attention: (B, N, T, D) -> (B*T, 1+N, D) with the cls token
        # tiled b-major over the frames.
        sp = patches.reshape(b, n, t, d).transpose(1, 2).reshape(b * t, n, d)
        sp = torch.cat([cls.repeat_interleave(t, dim=0), sp], dim=1)
        h = self.attention(self.layernorm_before(sp))
        cls_res = h[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
        patch_res = h[:, 1:].reshape(b, t, n, d).transpose(1, 2).reshape(b, n * t, d)
        x = torch.cat([cls, patches], dim=1) + torch.cat([cls_res, patch_res], dim=1)

        return x + super().forward(self.layernorm_after(x))


def divided_spatial_attention_plain(q_p, k_p, v_p, q_c, k_c, v_c):
    """Per-frame attention over [cls | the frame's patches], the JAX
    ``DividedSpatialAttention`` einsums (``laryngeal_tpu/models/
    timesformer.py:186-200``) with f32 logits and softmax: patch queries
    (B, N, T, H, hd) and the cls query (B, H, hd), against keys and values
    of the same shapes. Returns (ctx_c (B, T, H, hd), ctx_p (B, N, T, H, hd))
    in q's dtype."""
    return _divided_spatial(q_p, k_p, v_p, q_c, k_c, v_c)


def _divided_spatial(q_p, k_p, v_p, q_c, k_c, v_c):
    dt = q_p.dtype
    q_p, k_p, v_p, q_c, k_c, v_c = (x.float() for x in (q_p, k_p, v_p, q_c, k_c, v_c))
    b, _, t, h, hd = q_p.shape
    scale = hd ** -0.5
    s_pp = torch.einsum("bnthd,bmthd->bthnm", q_p, k_p) * scale
    s_pc = torch.einsum("bnthd,bhd->bthn", q_p, k_c) * scale
    w = torch.softmax(torch.cat([s_pc[..., None], s_pp], dim=-1), dim=-1)
    ctx_p = (torch.einsum("bthn,bhd->bnthd", w[..., 0], v_c)
             + torch.einsum("bthnm,bmthd->bnthd", w[..., 1:], v_p))
    s_cc = torch.einsum("bhd,bhd->bh", q_c, k_c) * scale
    s_cp = torch.einsum("bhd,bnthd->bthn", q_c, k_p) * scale
    wc = torch.softmax(torch.cat([s_cc[:, None, :, None].expand(b, t, h, 1), s_cp], dim=-1),
                       dim=-1)
    ctx_c = (torch.einsum("bth,bhd->bthd", wc[..., 0], v_c)
             + torch.einsum("bthn,bnthd->bthd", wc[..., 1:], v_p))
    return ctx_c.to(dt), ctx_p.to(dt)


class DividedSpatialAttentionFn(torch.autograd.Function):
    """The nt layout's spatial attention with a recompute backward, as the
    attention kernels have: the forward saves q, k, v (the (B, T, H, N, 1+N)
    probabilities are never kept) and the backward recomputes the plain
    function and differentiates it. Inside a rematerialised layer the
    recompute takes both contexts off the layer's tape (``ops/remat.py``),
    the JAX ``checkpoint_name(..., "attn_out")`` on ``ctx_p`` and ``ctx_c``."""

    @staticmethod
    def forward(ctx, q_p, k_p, v_p, q_c, k_c, v_c):
        ctx.save_for_backward(q_p, k_p, v_p, q_c, k_c, v_c)
        return _remat.saved_output(divided_spatial_attention_plain, q_p, k_p, v_p, q_c, k_c, v_c)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_c, d_p):
        return divided_spatial_attention_bwd(*ctx.saved_tensors, d_c, d_p)


def divided_spatial_attention_bwd(q_p, k_p, v_p, q_c, k_c, v_c, d_c, d_p):
    """Gradients of the six inputs: the plain function recomputed and
    differentiated by autograd."""
    inputs = [x.detach().requires_grad_() for x in (q_p, k_p, v_p, q_c, k_c, v_c)]
    with torch.enable_grad():
        return torch.autograd.grad(_divided_spatial(*inputs), inputs, (d_c, d_p))


def divided_spatial_attention(q_p, k_p, v_p, q_c, k_c, v_c):
    """``divided_spatial_attention_plain``, under autograd through
    ``DividedSpatialAttentionFn``."""
    args = (q_p, k_p, v_p, q_c, k_c, v_c)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return DividedSpatialAttentionFn.apply(*args)
    return divided_spatial_attention_plain(*args)


class DividedSpatialAttention(FusedQKVAttention):
    """The nt layout's spatial attention (the JAX ``DividedSpatialAttention``):
    the same ``attention.qkv`` / ``output.dense`` parameters as
    ``FusedQKVAttention``, applied to the n-major patches (B, N, T, D) and
    the cls vector (B, 1, D). Returns (out_c (B, T, D), out_p (B, N, T, D))."""

    def forward(self, cls: torch.Tensor, patches: torch.Tensor):
        b, n, t, d = patches.shape
        h = self.num_heads
        qkv = self.attention.qkv
        q_p, k_p, v_p = qkv(patches).reshape(b, n, t, 3, h, d // h).unbind(3)
        q_c, k_c, v_c = qkv(cls).reshape(b, 3, h, d // h).unbind(1)
        ctx_c, ctx_p = divided_spatial_attention(q_p, k_p, v_p, q_c, k_c, v_c)
        out = self.output.dense
        return out(ctx_c.reshape(b, t, d)), out(ctx_p.reshape(b, n, t, d))


class TimesformerLayerNT(TimesformerLayer):
    """One layer of the transpose-free nt layout (the JAX
    ``TimesformerLayerNT``): carries (cls (B, 1, D), patches (B, N, T, D)).
    Its parameters, their names and their order are the flat layer's."""

    def __init__(self, cfg: TimesformerConfig):
        super().__init__(cfg)
        self.attention = DividedSpatialAttention(cfg.hidden_size, cfg.num_heads, cfg.dtype)

    def forward(self, cls: torch.Tensor, patches: torch.Tensor):
        b, n, t, d = patches.shape
        # Temporal attention: (B, N, T, D) -> (B*N, T, D), a free reshape.
        h = self.temporal_attention(self.temporal_layernorm(patches.reshape(b * n, t, d)))
        patches = patches + self.temporal_dense(h.reshape(b, n, t, d))

        out_c, out_p = self.attention(self.layernorm_before(cls), self.layernorm_before(patches))
        cls = cls + out_c.mean(dim=1, keepdim=True)
        patches = patches + out_p

        mlp = super(TimesformerLayer, self).forward  # per token, shared by both
        return (cls + mlp(self.layernorm_after(cls)),
                patches + mlp(self.layernorm_after(patches)))


class TimesformerPatchEmbeddings(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.projection = nn.Conv2d(3, cfg.hidden_size, kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(B*T, H, W, C) -> (B*T, N, D), row-major patch order."""
        dt = self.dtype
        w = self.projection
        x = F.conv2d(frames.permute(0, 3, 1, 2).to(dt), w.weight.to(dt), w.bias.to(dt),
                     stride=w.stride)
        return x.flatten(2).transpose(1, 2)


class TimesformerEmbeddings(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(torch.zeros(1, cfg.num_spatial_patches + 1, d))
        self.time_embeddings = nn.Parameter(torch.zeros(1, cfg.num_frames, d))
        self.patch_embeddings = TimesformerPatchEmbeddings(cfg)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, 1 + N*T, D), spatial-major, time-innermost."""
        b, t, hh, ww, c = pixel_values.shape
        x = self.patch_embeddings(pixel_values.reshape(b * t, hh, ww, c))
        n, d = x.shape[1], x.shape[2]
        pos = self.position_embeddings.to(x.dtype)
        x = x + pos[:, 1:]
        x = x.reshape(b, t, n, d).transpose(1, 2) + self.time_embeddings.to(x.dtype)[:, None]
        cls = (self.cls_token.to(x.dtype) + pos[:, :1]).expand(b, -1, -1)
        return torch.cat([cls, x.reshape(b, n * t, d)], dim=1)


class TimesformerEncoder(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        self.num_frames, self.remat, self.nt = cfg.num_frames, cfg.remat, cfg.layout == "nt"
        layer_cls = TimesformerLayerNT if self.nt else TimesformerLayer
        self.layer = nn.ModuleList(layer_cls(cfg) for _ in range(cfg.num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1 + N*T, D) -> the same (flat), or -> the cls row (B, 1, D)
        (nt: the JAX model normalises and classifies only that)."""
        if not self.nt:
            for layer in self.layer:
                x = call_block(layer, x, remat=self.remat)
            return x
        b, total, d = x.shape
        t = self.num_frames
        # The flat order is spatial-major, so the 4-D split is a reshape.
        cls, patches = x[:, :1], x[:, 1:].reshape(b, (total - 1) // t, t, d)
        for layer in self.layer:
            cls, patches = call_block(layer, cls, patches, remat=self.remat)
        return cls


class TimesformerModel(nn.Module):
    def __init__(self, cfg: TimesformerConfig):
        super().__init__()
        self.embeddings = TimesformerEmbeddings(cfg)
        self.encoder = TimesformerEncoder(cfg)
        self.layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.layernorm(self.encoder(self.embeddings(pixel_values)))


class TimesformerForVideoClassification(nn.Module):
    """pixel_values (B, T, H, W, C) float -> logits (B, num_classes) float32."""

    def __init__(self, config: TimesformerConfig):
        super().__init__()
        self.config = config
        self.timesformer = TimesformerModel(config)
        self.classifier = Dense(config.hidden_size, config.num_classes)

    def forward(self, pixel_values: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` is the train step's stochastic-depth generator;
        this model has no stochastic depth and ignores it."""
        x = self.timesformer(pixel_values)
        return self.classifier(x[:, 0]).float()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "TimesformerForVideoClassification":
        """Flax's initialisers, drawn from ``generator`` (CPU): LeCun-normal
        kernels (std 1/sqrt(fan_in)), zero biases, unit LayerNorm scales and
        zero cls / position / time embeddings (the JAX module's
        ``nn.initializers.zeros``)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(m.weight[0].numel()))
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        emb = self.timesformer.embeddings
        for p in (emb.cls_token, emb.position_embeddings, emb.time_embeddings):
            nn.init.zeros_(p)
        return self


def create_timesformer(num_classes: int = 2, num_frames: int = 8, image_size: int = 224,
                       dtype: torch.dtype = torch.float32, seed: Optional[int] = 0,
                       **kwargs) -> TimesformerForVideoClassification:
    """Build a TimeSformer on the CPU with weights drawn from ``seed`` (None
    leaves torch's own initialisation); move it with ``.to(device)``."""
    cfg = TimesformerConfig(num_classes=num_classes, num_frames=num_frames,
                            image_size=image_size, dtype=dtype, **kwargs)
    model = TimesformerForVideoClassification(cfg)
    if seed is not None:
        model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.eval()
