"""Train / eval step factories (counterpart of ``laryngeal_tpu/train/steps.py``).

One call per batch runs, eagerly on the model's device: the wire payload
(uint8 (B, T, H, W, C) on the rgb wire; I420 planes, their deltas or the
dct wires' tuples otherwise) -> ``decode_wire_batch`` -> ``batch_preprocess``
-> model -> masked loss -> backward -> optimizer step, and returns ``{loss, correct, count,
probs}`` as device tensors, so the caller can keep them on the device until
the epoch's end. Under autograd every attention call of the model goes
through ``FlashAttentionFn`` (kernels 2-4 on the card: ViViT),
``ShortAttentionFn`` (kernels 6-7: TimeSformer) or ``WindowAttentionFn``
(kernels 8-9: Swin3D); the eval step runs under ``torch.inference_mode`` and
takes kernel 1, 6 or 8. The two CNN families (3D-ResNet50, ResNet50 + LSTM)
reach no kernel of the port: cuDNN convolutions and the LSTM's products. The
step puts the model in train mode and the eval step in eval mode, so their
BatchNorm layers normalise with the batch's statistics (padded rows of a
last partial batch included, as the JAX step counts them) and move their
running statistics in the one, and use the running statistics in the other.

The step is model-agnostic: ``batch_preprocess`` dispatches on the regime.
Like the JAX step (``steps.py:108-123``), each step derives its randomness
from the seed and ``state.step``, so a resumed run draws what an
uninterrupted one draws: a CPU generator for the pytorchvideo regime's
augmentation and one on the model's device for Swin3D's stochastic depth and
the CNN families' dropout (every model's forward takes it as ``generator``).
The ViViT and TimeSformer regimes draw no augmentation and neither model has
dropout, so those forwards ignore it.
``LARYNGEAL_NO_AUGMENT=1``, read once when the step is made (as the JAX
factory reads it, ``:82-90``), trains the pytorchvideo regime on its
deterministic eval transform, so the port and JAX steps can be compared
without aligning their random streams.

``grad_accum > 1`` (the JAX step's ``lax.scan``, ``steps.py:128-188``)
splits the batch into strided micro-batches (micro-batch ``g`` takes rows
``g, g + ga, ...``), preprocesses and runs each on its own, so decoded-clip
and activation memory scale with the micro-batch, and accumulates their
gradients, each micro-batch's masked-mean loss weighted by its valid count
and the sum divided by ``max(total count, 1)``: for a model without
BatchNorm the update is the full batch's, and a micro-batch that is all
padding adds zero. One optimizer update a batch; probabilities come back in
batch order. BatchNorm statistics move once per micro-batch, in order, as
the JAX scan carry threads them. Micro-batch ``i`` draws its augmentation
and dropout from generators seeded by (seed, step, i). The payload stays
encoded through the split: each leaf of a dct wire's tuple is sliced, and
each micro-batch decodes its own rows.

Ported: one device and every wire. The mesh / tensor-parallel arguments
raise.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..preprocess.transforms import batch_preprocess, check_wire, decode_wire_batch
from .losses import make_loss_fn, probs_fn
from .state import TrainState


def _check_ported(mesh, tp: bool, grad_accum: int, wire: str, wire_hw) -> None:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    check_wire(wire, wire_hw)
    unported = {
        "a device mesh": mesh is not None,
        "tensor parallelism (tp)": tp,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not yet ported to laryngeal_tpu_torch, see ROADMAP.md")


def _metrics(loss_val, logits, labels, mask, get_probs) -> Dict[str, torch.Tensor]:
    probs = get_probs(logits.detach())
    preds = probs.argmax(-1)
    valid = mask.float()
    return {"loss": loss_val.detach(), "correct": ((preds == labels.long()) * valid).sum(),
            "count": valid.sum(), "probs": probs}


def step_generators(seed: int, step: int, device,
                    micro: Optional[int] = None) -> Tuple[torch.Generator, torch.Generator]:
    """(augmentation generator on the CPU, stochastic-depth generator on
    ``device``) of one train step, seeded from (seed, step) only, or of its
    micro-batch ``micro`` from (seed, step, micro)."""
    entropy = [int(seed), int(step)] + ([] if micro is None else [int(micro)])
    aug_seed, drop_seed = np.random.SeedSequence(entropy).generate_state(2)
    return (torch.Generator().manual_seed(int(aug_seed)),
            torch.Generator(device=device).manual_seed(int(drop_seed)))


def _leaves(pixel):
    return pixel if isinstance(pixel, tuple) else (pixel,)


def _rows(pixel, rows: slice):
    """Rows of a payload, each leaf of a dct wire's tuple alike."""
    if isinstance(pixel, tuple):
        return tuple(x[rows] for x in pixel)
    return pixel[rows]


def make_train_step(model: torch.nn.Module, regime: str, loss: str, pos_weight: float = 1.0,
                    mesh=None, crop: int = 224, tp: bool = False, grad_accum: int = 1,
                    wire: str = "rgb", wire_hw=None, wire_quality: int = 75,
                    wire_keep_ac: int = 31, seed: int = 0) -> Callable:
    """Returns train_step(state, pixel_u8, labels, mask) -> (state, metrics).

    ``state`` holds ``model`` and its optimizer; the step updates both in
    place and counts ``state.step``. ``seed`` and ``state.step`` seed the
    step's augmentation and stochastic depth (``step_generators``).
    ``grad_accum``: micro-batches a batch (module docstring); the batch size
    must be a multiple of it. ``wire`` names the payload's format
    (``decode_wire_batch``); dct and dctp need their geometry ``wire_hw=(h,
    w)``, and dctp ``wire_keep_ac``."""
    _check_ported(mesh, tp, grad_accum, wire, wire_hw)
    loss_fn = make_loss_fn(loss, pos_weight)
    get_probs = probs_fn(loss)
    augment = regime == "pytorchvideo" and os.environ.get("LARYNGEAL_NO_AUGMENT") != "1"

    def forward_loss(pixel_u8, labels, mask, generators):
        aug_gen, drop_gen = generators
        clips = batch_preprocess(
            decode_wire_batch(pixel_u8, wire, wire_hw, wire_quality, wire_keep_ac), regime,
            train=augment, crop=crop, generator=aug_gen)
        logits = model(clips, generator=drop_gen)
        return loss_fn(logits, labels, mask), logits

    def step(state: TrainState, pixel_u8, labels, mask):
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        device = _leaves(pixel_u8)[0].device
        if grad_accum == 1:
            loss_val, logits = forward_loss(pixel_u8, labels, mask,
                                            step_generators(seed, state.step, device))
            loss_val.backward()
        else:
            batch = _leaves(pixel_u8)[0].shape[0]
            if batch % grad_accum:
                raise ValueError(f"batch size {batch} not divisible by grad_accum {grad_accum}")
            denom = torch.clamp(mask.float().sum(), min=1.0)
            loss_sum, parts = 0.0, []
            for i in range(grad_accum):
                rows = slice(i, None, grad_accum)
                loss_i, logits_i = forward_loss(
                    _rows(pixel_u8, rows), labels[rows], mask[rows],
                    step_generators(seed, state.step, device, micro=i))
                weight = mask[rows].float().sum() / denom
                (loss_i * weight).backward()
                loss_sum = loss_sum + loss_i.detach() * weight
                parts.append(logits_i.detach())
            loss_val = loss_sum
            # Micro-batch g holds rows g, g + ga, ...: interleave them back.
            logits = torch.stack(parts, dim=1).reshape(batch, *parts[0].shape[1:])
        state.optimizer.step()
        state.step += 1
        return state, _metrics(loss_val, logits, labels, mask, get_probs)

    return step


def make_eval_step(model: torch.nn.Module, regime: str, loss: str, pos_weight: float = 1.0,
                   mesh=None, crop: int = 224, tp: bool = False, wire: str = "rgb",
                   wire_hw=None, wire_quality: int = 75, wire_keep_ac: int = 31) -> Callable:
    """Returns eval_step(state, pixel_u8, labels, mask) -> metrics (incl. probs)."""
    _check_ported(mesh, tp, 1, wire, wire_hw)
    loss_fn = make_loss_fn(loss, pos_weight)
    get_probs = probs_fn(loss)

    @torch.inference_mode()
    def step(state: TrainState, pixel_u8, labels, mask):
        model.eval()
        clips = batch_preprocess(
            decode_wire_batch(pixel_u8, wire, wire_hw, wire_quality, wire_keep_ac), regime,
            train=False, crop=crop)
        logits = model(clips)
        return _metrics(loss_fn(logits, labels, mask), logits, labels, mask, get_probs)

    return step


def prepare_batch(batch: Dict, device) -> Tuple:
    """Host batch dict -> (pixel, labels, mask) tensors on ``device``; a
    dct wire's payload tuple moves leaf by leaf."""
    pixel = batch["pixel_values"]
    if isinstance(pixel, tuple):
        pixel = tuple(torch.from_numpy(x).to(device) for x in pixel)
    else:
        pixel = torch.from_numpy(pixel).to(device)
    return (pixel,
            torch.from_numpy(np.asarray(batch["labels"], np.int64)).to(device),
            torch.from_numpy(np.asarray(batch["mask"], np.bool_)).to(device))
