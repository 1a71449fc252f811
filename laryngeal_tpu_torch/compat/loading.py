"""Load a local torch checkpoint into a model (``--torch_weights``):
counterpart of ``laryngeal_tpu/compat/loading.py``.

The port's parameters already carry the names of the checkpoints the
reference fine-tunes (HF for ViViT and TimeSformer, torchvision for Swin3D,
pytorchvideo for slow_r50, the reference's sequential names for ResNet50 +
LSTM), so where the JAX package converts, the port reconciles the file's
state dict with the model's own and calls ``load_state_dict``:

- a tensor whose shape differs from the model's (the 400-class Kinetics
  head against a 2-class one) keeps the fresh initialisation, as the
  reference's ``ignore_mismatched_sizes=True`` does, with the JAX loader's
  warning; a ``time_embeddings`` table of another length is interpolated
  linearly instead (``resize_time_embeddings``, the JAX
  ``compat/torch_port.py:129-146``);
- a tensor of the model that the file lacks (a depth or width mismatch)
  keeps the fresh initialisation, with a warning;
- a tensor of the file the model does not hold (torchvision's
  ``relative_position_index`` buffers, layers past the model's depth) is
  left out, and counted in the log;
- BatchNorm running statistics (the CNN families) load with the weights.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` (torch.load) or ``.npz`` state dict, unwrapped
    from the reference's checkpoint dicts (``model_state_dict``,
    ``state_dict``) and stripped of DataParallel's ``module.`` prefixes
    (resnet50-3d-video/inference.py:55-60 tolerates both)."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as f:
            obj = {k: torch.from_numpy(np.array(f[k])) for k in f.files}
    else:
        # The reference's checkpoint dicts hold more than tensors (epoch,
        # optimizer, config), as the JAX loader reads them.
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "model_state_dict" in obj:
            obj = obj["model_state_dict"]
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in obj.items()}


def resize_time_embeddings(emb: np.ndarray, t_new: int) -> np.ndarray:
    """Linearly interpolate a (1, T, D) temporal embedding to T = ``t_new``
    (the 8-frame k400 TimeSformer into the reference's 32-frame
    fine-tune, timesformer/main.py:39). The reference re-initialises the
    mismatched table; the JAX package interpolates it, and so does this."""
    t_old = emb.shape[1]
    if t_old == t_new:
        return emb
    x = np.linspace(0.0, t_old - 1.0, t_new)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, t_old - 1)
    w = (x - i0)[None, :, None].astype(np.float32)
    out = emb[:, i0] * (1.0 - w) + emb[:, i1] * w
    return out.astype(emb.dtype)


def reconcile_state_dict(current: Mapping[str, torch.Tensor], loaded: Mapping, logger=None,
                         context: str = "") -> Dict[str, torch.Tensor]:
    """``current`` (the model's state dict) with every tensor of ``loaded``
    that fits it (module docstring), cast to the model's dtypes."""
    out = dict(current)
    dropped, interped = [], []
    unused = 0
    for k, v in loaded.items():
        cur = current.get(k)
        if cur is None or not isinstance(v, (torch.Tensor, np.ndarray)):
            unused += 1
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(cur.shape):
            if k.endswith("time_embeddings") and v.ndim == 3 and cur.ndim == 3:
                v = torch.from_numpy(resize_time_embeddings(
                    v.detach().float().numpy(), int(cur.shape[1])))
                interped.append(k)
            else:
                dropped.append(k)
                continue
        out[k] = v.detach().to(dtype=cur.dtype)
    missing = sorted(k for k in current if k not in loaded)
    if logger:
        if missing:
            logger.warning(
                "%s%d model tensors absent from the checkpoint keep RANDOM init "
                "(depth/width mismatch?): %s", context, len(missing),
                ", ".join(missing[:12]) + (" ..." if len(missing) > 12 else ""))
        if interped:
            logger.info("%sInterpolated temporal embeddings: %s", context, ", ".join(interped))
        if dropped:
            logger.warning(
                "%sKept fresh init for shape-mismatched tensors (the reference "
                "re-initializes these via ignore_mismatched_sizes=True): %s", context,
                ", ".join(dropped))
        if unused:
            logger.info("%s%d checkpoint entries the model does not hold were left out",
                        context, unused)
    return out


def load_torch_weights(model: torch.nn.Module, model_name: str, path, logger=None,
                       sd=None) -> torch.nn.Module:
    """Load the checkpoint at ``path`` (or the already-read state dict
    ``sd``) into ``model`` in place, reconciled as the module docstring
    says; returns ``model``."""
    if sd is None:
        sd = load_torch_state_dict(path)
    if logger:
        logger.info("Loaded torch weights from %s (%d tensors)", path, len(sd))
    merged = reconcile_state_dict(model.state_dict(), sd, logger, context=f"{model_name}: ")
    model.load_state_dict(merged)
    return model
