"""Flax params -> torch state_dict (HF / torchvision / pytorchvideo names).

The inverses of ``laryngeal_tpu/compat/torch_port.py::port_vivit``,
``::port_timesformer``, ``::port_swin3d``, ``::port_resnet3d`` and
``::port_resnet50_lstm``: each takes the nested dict of numpy arrays that the
JAX package's ``create_*(...).init`` produces (``variables["params"]``, and
for the two CNN families the whole ``variables`` with its
``"batch_stats"``, converted with ``np.asarray``) and returns the state_dict
of the port's model. No JAX import: the input is plain numpy.

- Dense ``kernel`` (in, out) -> ``weight`` (out, in);
- Conv3d ``kernel`` (kt, kh, kw, C, D) -> ``weight`` (D, C, kt, kh, kw);
- Conv2d ``kernel`` (kh, kw, C, D) -> ``weight`` (D, C, kh, kw);
- arrays without a layout (embeddings, Swin's relative-position tables) as
  they are;
- LayerNorm ``scale`` -> ``weight``;
- BatchNorm ``scale`` / ``bias`` and the batch stats ``mean`` / ``var`` ->
  ``weight`` / ``bias`` / ``running_mean`` / ``running_var``, with
  ``num_batches_tracked`` 0 (Flax keeps no count).

Every array is copied: a CPU JAX array can alias the numpy buffer it was
made from, and torch.from_numpy aliases too, so without the copy an
in-place torch update would write into the Flax params.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(p: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(p: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def vivit_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ViViT params (``layer_{i}`` blocks) -> HF-named torch state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    sd["vivit.embeddings.cls_token"] = _t(emb["cls_token"])
    sd["vivit.embeddings.position_embeddings"] = _t(emb["position_embeddings"])
    proj = emb["projection"]
    sd["vivit.embeddings.patch_embeddings.projection.weight"] = _t(
        np.asarray(proj["kernel"]).transpose(4, 3, 0, 1, 2))
    sd["vivit.embeddings.patch_embeddings.projection.bias"] = _t(proj["bias"])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        blk = params[f"layer_{i}"]
        p = f"vivit.encoder.layer.{i}"
        att = blk["attention"]
        for name in ("query", "key", "value"):
            _dense(att[name], f"{p}.attention.attention.{name}", sd)
        _dense(att["out"], f"{p}.attention.output.dense", sd)
        _dense(blk["mlp"]["fc1"], f"{p}.intermediate.dense", sd)
        _dense(blk["mlp"]["fc2"], f"{p}.output.dense", sd)
        _layernorm(blk["layernorm_before"], f"{p}.layernorm_before", sd)
        _layernorm(blk["layernorm_after"], f"{p}.layernorm_after", sd)
    _layernorm(params["layernorm"], "vivit.layernorm", sd)
    _dense(params["classifier"], "classifier", sd)
    return sd


def timesformer_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax TimeSformer params (flat layout, ``layer_{i}`` blocks) ->
    HF-named torch state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    e = "timesformer.embeddings"
    for name in ("cls_token", "position_embeddings", "time_embeddings"):
        sd[f"{e}.{name}"] = _t(emb[name])
    proj = emb["projection"]
    sd[f"{e}.patch_embeddings.projection.weight"] = _t(
        np.asarray(proj["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{e}.patch_embeddings.projection.bias"] = _t(proj["bias"])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        blk = params[f"layer_{i}"]
        p = f"timesformer.encoder.layer.{i}"
        for att in ("attention", "temporal_attention"):
            _dense(blk[att]["qkv"], f"{p}.{att}.attention.qkv", sd)
            _dense(blk[att]["out"], f"{p}.{att}.output.dense", sd)
        _dense(blk["temporal_dense"], f"{p}.temporal_dense", sd)
        _dense(blk["mlp_fc1"], f"{p}.intermediate.dense", sd)
        _dense(blk["mlp_fc2"], f"{p}.output.dense", sd)
        for ln in ("layernorm_before", "temporal_layernorm", "layernorm_after"):
            _layernorm(blk[ln], f"{p}.{ln}", sd)
    _layernorm(params["layernorm"], "timesformer.layernorm", sd)
    _dense(params["classifier"], "classifier", sd)
    return sd


def swin3d_state_dict_from_flax(params: Mapping, depths=(2, 2, 6, 2)) -> Dict[str, torch.Tensor]:
    """Flax Swin3D params (``stage{s}_block{i}``, ``merge{s}``) ->
    torchvision-named torch state_dict (``features.{2s}.{i}`` blocks,
    ``features.{2s+1}`` patch merging)."""
    sd: Dict[str, torch.Tensor] = {}
    proj = params["patch_embed_proj"]
    sd["patch_embed.proj.weight"] = _t(np.asarray(proj["kernel"]).transpose(4, 3, 0, 1, 2))
    sd["patch_embed.proj.bias"] = _t(proj["bias"])
    _layernorm(params["patch_embed_norm"], "patch_embed.norm", sd)
    for stage, depth in enumerate(depths):
        for i in range(depth):
            blk = params[f"stage{stage + 1}_block{i}"]
            p = f"features.{2 * stage}.{i}"
            _layernorm(blk["norm1"], f"{p}.norm1", sd)
            _dense(blk["attn"]["qkv"], f"{p}.attn.qkv", sd)
            _dense(blk["attn"]["proj"], f"{p}.attn.proj", sd)
            sd[f"{p}.attn.relative_position_bias_table"] = _t(
                blk["attn"]["relative_position_bias_table"])
            _layernorm(blk["norm2"], f"{p}.norm2", sd)
            _dense(blk["mlp_fc1"], f"{p}.mlp.0", sd)
            _dense(blk["mlp_fc2"], f"{p}.mlp.3", sd)
        if stage < len(depths) - 1:
            m = params[f"merge{stage + 1}"]
            _layernorm(m["norm"], f"features.{2 * stage + 1}.norm", sd)
            _dense(m["reduction"], f"features.{2 * stage + 1}.reduction", sd)
    _layernorm(params["norm"], "norm", sd)
    _dense(params["head"], "head", sd)
    return sd


RESNET50_STAGES = (3, 4, 6, 3)  # both CNN families' blocks a stage


def _conv(p: Mapping, prefix: str, out: Dict) -> None:
    """A bias-free Conv2d / Conv3d kernel, (k..., C, D) -> (D, C, k...)."""
    k = np.asarray(p["kernel"])
    out[f"{prefix}.weight"] = _t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))


def _batchnorm(p: Mapping, stats: Mapping, prefix: str, out: Dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def resnet3d_state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ResNet3D variables (``stem_*``, ``stage{s}_{i}``, ``proj``) ->
    pytorchvideo-named torch state_dict (``blocks.0`` stem,
    ``blocks.{s}.res_blocks.{i}``, ``blocks.5.proj``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(params["stem_conv"], "blocks.0.conv", sd)
    _batchnorm(params["stem_bn"], stats["stem_bn"], "blocks.0.norm", sd)
    for stage, blocks in enumerate(RESNET50_STAGES):
        for i in range(blocks):
            key = f"stage{stage + 1}_{i}"
            bp, bs = params[key], stats[key]
            p = f"blocks.{stage + 1}.res_blocks.{i}"
            if "shortcut_conv" in bp:
                _conv(bp["shortcut_conv"], f"{p}.branch1_conv", sd)
                _batchnorm(bp["shortcut_bn"], bs["shortcut_bn"], f"{p}.branch1_norm", sd)
            for br in ("a", "b", "c"):
                _conv(bp[f"conv_{br}"], f"{p}.branch2.conv_{br}", sd)
                _batchnorm(bp[f"bn_{br}"], bs[f"bn_{br}"], f"{p}.branch2.norm_{br}", sd)
    _dense(params["proj"], "blocks.5.proj", sd)
    return sd


def resnet50_lstm_state_dict_from_flax(variables: Mapping,
                                       num_layers: int = 2) -> Dict[str, torch.Tensor]:
    """Flax VideoResNet50LSTM variables -> the reference's sequential names
    (``resnet50.{0,1,4-7}``, ``lstm.*_l{k}``, ``classifier.{0,3}``)."""
    params, stats = variables["params"], variables["batch_stats"]
    trunk, trunk_stats = params["resnet50"], stats["resnet50"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(trunk["conv1"], "resnet50.0", sd)
    _batchnorm(trunk["bn1"], trunk_stats["bn1"], "resnet50.1", sd)
    for stage, blocks in enumerate(RESNET50_STAGES):
        for i in range(blocks):
            key = f"layer{stage + 1}_{i}"
            bp, bs = trunk[key], trunk_stats[key]
            p = f"resnet50.{stage + 4}.{i}"
            for j in (1, 2, 3):
                _conv(bp[f"conv{j}"], f"{p}.conv{j}", sd)
                _batchnorm(bp[f"bn{j}"], bs[f"bn{j}"], f"{p}.bn{j}", sd)
            if "downsample_conv" in bp:
                _conv(bp["downsample_conv"], f"{p}.downsample.0", sd)
                _batchnorm(bp["downsample_bn"], bs["downsample_bn"], f"{p}.downsample.1", sd)
    lstm = params["lstm"]
    for k in range(num_layers):
        sd[f"lstm.weight_ih_l{k}"] = _t(np.asarray(lstm[f"w_ih_l{k}"]).T)
        sd[f"lstm.weight_hh_l{k}"] = _t(np.asarray(lstm[f"w_hh_l{k}"]).T)
        sd[f"lstm.bias_ih_l{k}"] = _t(lstm[f"b_ih_l{k}"])
        sd[f"lstm.bias_hh_l{k}"] = _t(lstm[f"b_hh_l{k}"])
    _dense(params["fc1"], "classifier.0", sd)
    _dense(params["fc2"], "classifier.3", sd)
    return sd
