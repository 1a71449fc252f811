"""Training CLI (counterpart of ``laryngeal_tpu/cli/main.py``).

``python -m laryngeal_tpu_torch.cli.main --model
{vivit,timesformer,swin3d,resnet3d,resnet50_lstm} --data_dir D
[--model_size tiny] [--stochastic_depth R] [--hidden_size 256] [--num_layers 2]
[--dropout 0.5] [--bf16] [--device cuda]`` runs the JAX CLI's chain (``cli/main.py:220-585``)
on one device: dataset and loaders, the trainer's train/validation epochs
with model selection, early stopping, best and rolling ``latest`` checkpoints
and the best-model reload, then the test-set evaluator. The parser keeps the
JAX flag surface, plus ``--device`` (default ``cuda``; the CPU only when
asked for). Ported: every model on every wire (``--wire rgb|i420|delta|dct|dctp``
with ``--wire_quality`` 75, ``--wire_keep_ac`` 15, ``--wire_pack_from`` 8 and
``--wire_lowres`` 0 unless given, the JAX CLI's defaults); Swin3D, as in the JAX CLI,
trains without early stopping; resnet50_lstm takes ``--hidden_size`` /
``--num_layers`` (256 / 2 unless given) and ``--dropout`` as its LSTM's,
resnet3d ``--dropout`` as its head's, and resnet3d's per-video sampled
indices are written as the JAX CLI writes them.

- ``--remat`` (ViViT, TimeSformer, Swin3D; a CNN family refuses it, as in
  the JAX CLI) rematerialises each block in the backward and keeps its
  attention outputs. The JAX CLI turns it on by itself for TimeSformer at
  32 frames x batch 8 on a TPU; this CLI never does.
- ``--grad_accum_steps k`` splits each batch into k strided micro-batches
  with one update a batch (``--batch_size`` must be a multiple of k).
- ``--torch_weights F`` loads a local ``.pth`` / ``.npz`` state dict into
  the model before ``--checkpoint_path`` and ``--resume``
  (``compat/loading.py``), in place of the pretrained warning.
- ``--clip_cache_dir D`` keeps every decoded clip on disk (``.npy`` files
  the JAX package reads too) and reads them back instead of decoding.
- ``--profile_dir D`` writes a ``torch.profiler`` trace of the training
  (``trainer.train()``, the region the JAX CLI traces) into D.

Flags of features not yet ported (ROADMAP.md) raise when set to anything
but their default: the mesh / pipeline / fsdp axes, the compile cache and
the multi-process flags. ``--pretrained`` (the default)
needs the network: it finds no weights, warns loudly and trains from the
seeded random init, as the JAX CLI does when no weights are found;
``--no-pretrained`` silences it.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np

PORTED_MODELS = ("vivit", "timesformer", "swin3d", "resnet3d", "resnet50_lstm")
# Flags of features not yet ported, with their defaults.
NOT_PORTED = {
    "mesh_data": None, "mesh_model": 1, "mesh_seq": 1, "pp_stages": 1,
    "pp_microbatches": None, "fsdp": False, "compile_cache_dir": None, "coordinator": None,
    "num_processes": None, "process_id": None,
}
TRANSFORMERS = ("vivit", "timesformer", "swin3d")


def build_parser(model_default: str = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Laryngeal video classifier training (PyTorch port)")
    p.add_argument("--model", type=str, default=model_default,
                   choices=["vivit", "timesformer", "resnet3d", "resnet50_lstm", "swin3d"],
                   required=model_default is None)
    # Data.
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--test_data_dir", "--test_dir", dest="test_data_dir",
                   type=str, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--model_dir", type=str, default=None,
                   help="Directory for best-model checkpoints (default: experiment dir)")
    p.add_argument("--train_sampling", type=str, default="uniform",
                   choices=["uniform", "random", "random_window"])
    p.add_argument("--val_sampling", type=str, default="uniform",
                   choices=["uniform", "random", "random_window"])
    p.add_argument("--test_sampling", type=str, default="uniform",
                   choices=["uniform", "random", "random_window"])
    p.add_argument("--num_frames", "--sequence_length", dest="num_frames",
                   type=int, default=None)
    # Model.
    p.add_argument("--model_name", type=str, default=None,
                   help="Pretrained id (informational; weights load via --torch_weights)")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--model_size", type=str, default="tiny",
                   help="swin3d size: tiny|small|base|base_in22k")
    p.add_argument("--pretrained", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="Start from the reference-default pretrained weights "
                        "(HF k400 for vivit/timesformer, torchvision Kinetics "
                        "for swin3d, ImageNet trunk for resnet50_lstm; "
                        "resnet3d is random-init in the reference). Fetched "
                        "from local caches or the network; on failure a LOUD "
                        "random-init warning fires. --no-pretrained disables.")
    p.add_argument("--torch_weights", type=str, default=None,
                   help="Path to a torch state_dict (.pth/.npz) to convert and load")
    p.add_argument("--hidden_size", type=int, default=None,
                   help="resnet50_lstm LSTM width (default 256); for "
                        "vivit/timesformer, an explicit transformer width "
                        "override (small-scale experiments / parity runs)")
    p.add_argument("--num_layers", type=int, default=None,
                   help="resnet50_lstm LSTM depth (default 2); for "
                        "vivit/timesformer, encoder depth override")
    p.add_argument("--num_heads", type=int, default=None,
                   help="vivit/timesformer attention heads override")
    p.add_argument("--intermediate_size", type=int, default=None,
                   help="vivit/timesformer MLP width override")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--stochastic_depth", type=float, default=None,
                   help="swin3d only: override the torchvision-parity "
                        "stochastic-depth rate (default 0.1); 0 disables "
                        "drop-path (used by the deterministic train A/B)")
    # Training.
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_workers", type=int, default=2,
                   help="Accepted for CLI parity; the pipeline uses a prefetch "
                        "thread and decode threads (--decode_workers)")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--patience", type=int, default=7)
    p.add_argument("--early_stopping_delta", type=float, default=0.001)
    p.add_argument("--loss_weight", type=float, default=0.3)
    p.add_argument("--acc_threshold", type=float, default=0.02)
    p.add_argument("--weighted_sampling", action="store_true",
                   help="Parsed-but-unused in the reference "
                        "(resnet50-3d-video/main.py:57); accepted for parity")
    p.add_argument("--eval_clips", type=int, default=1,
                   help="Average test predictions over N sampled clips per "
                        "video (clip-averaged eval; stochastic samplers only)")
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="Checkpoint dir to resume mid-training from "
                        "(restores optimizer state + epoch counter), or "
                        "'auto' to pick the newest latest/best checkpoint "
                        "under --log_dir for this model (preemption "
                        "restart: just relaunch with --resume auto)")
    p.add_argument("--save_every", type=int, default=1,
                   help="Write a rolling 'latest' checkpoint every N epochs "
                        "(preemption-safe resume point; 0 disables). Best-"
                        "model checkpoints are separate and unaffected")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Write a torch.profiler trace (Chrome / TensorBoard) of the "
                        "training into this directory")
    # Extras of the JAX package; the parallel axes are not yet ported.
    p.add_argument("--mesh_data", type=int, default=None,
                   help="Data-parallel device count (default: all devices)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="Model-axis (tensor-parallel) device count; composes "
                        "with --mesh_data on one mesh (Megatron-style "
                        "attention/MLP sharding; vivit/timesformer/swin3d)")
    p.add_argument("--mesh_seq", type=int, default=1,
                   help="Sequence-axis (context-parallel) device count: "
                        "token-sharded activations, k/v all-gathered per "
                        "attention (parallel/sp.py; vivit/timesformer). "
                        "Composes with --mesh_data/--mesh_model on one mesh")
    p.add_argument("--pp_stages", type=int, default=1,
                   help="GPipe pipeline stages: the transformer block stack "
                        "is split into this many stages, one per device "
                        "along a 'stage' mesh axis, with microbatch "
                        "activations ppermute'd stage-to-stage "
                        "(parallel/pp.py; vivit/timesformer). Uses its own "
                        "(data, stage) mesh — exclusive with "
                        "--mesh_model/--mesh_seq")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3-style fully-sharded data parallelism: shard "
                        "every large parameter (and its optimizer moments) "
                        "over the data axis; GSPMD all-gathers params before "
                        "use and reduce-scatters gradients (parallel/"
                        "fsdp.py). Per-device param+opt memory scales down "
                        "with --mesh_data; any model family")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="GPipe microbatches per batch (default: pp_stages; "
                        "bubble fraction is (S-1)/(M+S-1), so larger M "
                        "amortizes the pipeline ramp)")
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="Split each batch into this many strided micro-batches "
                        "and accumulate their gradients into one update "
                        "(activation memory / grad_accum, identical update "
                        "for BN-free models; batch_size must divide evenly)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--remat", action="store_true",
                   help="Rematerialize each transformer block in the backward "
                        "pass (torch.utils.checkpoint, attention outputs kept): "
                        "more FLOPs for less activation memory (transformer "
                        "families; never turned on by itself)")
    p.add_argument("--wire", type=str, default="rgb",
                   choices=("rgb", "i420", "delta", "dct", "dctp"),
                   help="host->device payload format for the training/eval "
                        "feed: rgb (reference parity), i420 (codec-native "
                        "4:2:0 planes, half the bytes, lossless vs source), "
                        "delta (i420 temporal deltas), dct (quantized DCT "
                        "planes, ~1/4 the bytes, bounded loss), dctp (dct "
                        "with nibble-packed high-frequency planes, ~3/4 the "
                        "dct bytes); the decode runs on the card in the step")
    p.add_argument("--wire_quality", type=int, default=75,
                   help="dct wire quantizer quality (1-100)")
    p.add_argument("--wire_keep_ac", type=int, default=15,
                   help="dct/dctp wire: zigzag AC planes kept (<=63); fewer "
                        "planes = fewer wire bytes at more quantization "
                        "loss. Default 15 = the measured bench operating "
                        "point; the round-4 learning A/B "
                        "(scripts/ab_train_wire_quality.py) shows k15p8 "
                        "training indistinguishable from k31p14 and the "
                        "rgb control. --wire_keep_ac 31 --wire_pack_from "
                        "14 restores the near-lossless wire")
    p.add_argument("--wire_pack_from", type=int, default=8,
                   help="dctp wire: first zigzag AC plane to nibble-pack "
                        "(planes >= this are clamped to [-8,7])")
    p.add_argument("--wire_lowres", type=int, default=0,
                   help="non-rgb wires: decode the source at 1/2**n "
                        "resolution (native mpeg4 lowres) and carry the "
                        "reduced geometry through the wire - ~4x less "
                        "decode transform work and wire bytes; lossy, "
                        "drift + learning A/B pinned in BASELINE.md")
    p.add_argument("--no_cache_clips", action="store_true")
    p.add_argument("--clip_cache_mb", type=int, default=2048,
                   help="RAM budget (MiB) for the decoded-clip LRU cache")
    p.add_argument("--clip_cache_dir", type=str, default=None,
                   help="Persistent on-disk decoded-clip cache (.npy per "
                        "clip; survives restarts, shared across runs)")
    p.add_argument("--compile_cache_dir", type=str, default=None,
                   help="Persistent XLA compilation cache (also via "
                        "LARYNGEAL_COMPILE_CACHE_DIR); repeat runs skip the "
                        "multi-minute remote train-step compile")
    p.add_argument("--verify_integrity", action="store_true",
                   help="Open and decode-check every video at dataset init, "
                        "dropping unreadable files (the ViViT reference does "
                        "this unconditionally, vivit_transformer/.../"
                        "data_config/dataset.py:48-112)")
    p.add_argument("--decode_workers", type=int, default=None,
                   help="Parallel decode threads per loader (default: auto)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="Multi-process (multi-host) coordinator address "
                        "host:port — process 0's reachable address. Also "
                        "via LARYNGEAL_COORDINATOR. Each process sees its "
                        "local chips; the mesh spans all of them "
                        "(parallel/distributed.py)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="Total process count for --coordinator mode "
                        "(LARYNGEAL_NUM_PROCESSES)")
    p.add_argument("--process_id", type=int, default=None,
                   help="This process's rank for --coordinator mode "
                        "(LARYNGEAL_PROCESS_ID)")
    p.add_argument("--image_size", type=int, default=None,
                   help="Model input size (defaults to crop_size)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p


def _refuse_unported(args) -> None:
    for flag, default in NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise SystemExit(f"--{flag} is not yet ported to laryngeal_tpu_torch "
                             "(see ROADMAP.md)")
    if args.model not in PORTED_MODELS:
        raise SystemExit(f"--model {args.model} is not yet ported to laryngeal_tpu_torch "
                         "(see ROADMAP.md)")
    # The JAX CLI's pure-flag refusals (cli/main.py:251-259).
    if args.remat and args.model not in TRANSFORMERS:
        raise SystemExit("--remat applies to the transformer families "
                         "(vivit/timesformer/swin3d)")
    if args.grad_accum_steps > 1 and args.batch_size % args.grad_accum_steps:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by "
                         f"--grad_accum_steps {args.grad_accum_steps}")
    # The JAX dataset's refusal of a wire geometry (data/dataset.py), made
    # before the experiment directory exists.
    side = args.crop_size >> args.wire_lowres
    if args.wire != "rgb" and side % 16:
        raise SystemExit(f"--wire {args.wire} needs (--crop_size >> --wire_lowres) multiples "
                         f"of 16, got {args.crop_size} >> {args.wire_lowres} = {side}")


def run(args) -> dict:
    import torch

    from ..data.pipeline import create_dataloaders
    from ..evals.evaluator import Evaluator
    from ..models.registry import create_model, get_model_spec
    from ..train.checkpoint import find_resume_checkpoint, load_checkpoint
    from ..train.trainer import Trainer
    from ..utils.device import resolve_device
    from ..utils.logger import ExperimentLogger

    # Flag validation before the experiment dir exists: a rejected run must
    # not litter --log_dir.
    _refuse_unported(args)
    device = resolve_device(args.device)
    spec = get_model_spec(args.model)
    num_frames = args.num_frames or spec.default_num_frames
    image_size = args.image_size or args.crop_size

    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    exp_logger = ExperimentLogger(args.log_dir, prefix=f"{args.model}-classifier")
    logger = exp_logger.get_logger()
    exp_dir = exp_logger.get_experiment_dir()
    logger.info("Arguments: %s", vars(args))
    logger.info("Device: %s (%s)", device,
                torch.cuda.get_device_name(device) if device.type == "cuda" else "host")

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    # The architecture pinned in the checkpoint's metadata, as the JAX CLI
    # pins it (cli/main.py:290-327).
    model_kwargs = dict(num_classes=args.num_classes, dtype=dtype, num_frames=num_frames,
                        image_size=image_size)
    for k in spec.arch_flags:
        if getattr(args, k) is not None:
            model_kwargs[k] = getattr(args, k)
    if args.model == "resnet50_lstm":
        model_kwargs.update(hidden_size=args.hidden_size or 256,
                            num_layers=args.num_layers or 2)
    if args.remat:
        model_kwargs["remat"] = True
    model = create_model(args.model, seed=args.seed, **model_kwargs)

    loaders = create_dataloaders(
        args.data_dir, test_data_dir=args.test_data_dir,
        sampling_methods={"train": args.train_sampling, "val": args.val_sampling,
                          "test": args.test_sampling},
        num_frames=num_frames, batch_size=args.batch_size, seed=args.seed,
        label_policy=spec.label_policy, per_video_seed=spec.per_video_seed,
        resize_to=(args.crop_size, args.crop_size), pad_last=True,
        cache_clips=not args.no_cache_clips, clip_cache_mb=args.clip_cache_mb,
        cache_dir=args.clip_cache_dir, verify_integrity=args.verify_integrity,
        num_workers=args.decode_workers, wire=args.wire, wire_lowres=args.wire_lowres,
        wire_quality=args.wire_quality, wire_keep_ac=args.wire_keep_ac,
        wire_pack_from=args.wire_pack_from)
    try:
        for split in ("train", "val", "test"):
            ds = loaders[split].dataset
            logger.info("%s: %d videos %s", split, len(ds), ds.class_counts)
            # The JAX CLI draws up to 3 items per split for its sampling plots
            # (cli/main.py:463-484); the draws advance stream-seeded samplers, so
            # they are kept (planning only: the plots are not ported).
            for i in range(min(3, len(ds))):
                ds.plan(i)
        if spec.per_video_seed:
            for split in ("train", "val", "test"):
                path = loaders[split].dataset.save_sampled_indices(exp_dir)
                if path:
                    logger.info("Sampled-indices audit -> %s", path)

        config = {
            "fsdp": args.fsdp,
            "data_dir": args.data_dir, "test_dir": args.test_data_dir or args.data_dir,
            "train_sampling": args.train_sampling, "val_sampling": args.val_sampling,
            "test_sampling": args.test_sampling, "num_frames": num_frames,
            "batch_size": args.batch_size, "epochs": args.epochs,
            "learning_rate": args.learning_rate or spec.default_lr,
            "weight_decay": (args.weight_decay if args.weight_decay is not None
                             else spec.default_weight_decay),
            "patience": args.patience, "early_stopping_delta": args.early_stopping_delta,
            "loss_weight": args.loss_weight, "acc_threshold": args.acc_threshold,
            "seed": args.seed, "crop_size": args.crop_size,
            "grad_accum_steps": args.grad_accum_steps,
            "save_every": args.save_every,
            "use_early_stopping": spec.name != "swin3d",
            # The architecture, without the compute dtype (as the JAX CLI pins
            # it): a --bf16 checkpoint is served in float32 by
            # Predictor.from_checkpoint.
            "model_kwargs": {k: v for k, v in model_kwargs.items() if k != "dtype"},
        }
        trainer = Trainer(model, spec, loaders, config, logger=logger, exp_dir=exp_dir,
                          device=device)

        if args.torch_weights:
            from ..compat.loading import load_torch_weights

            load_torch_weights(trainer.model, args.model, args.torch_weights, logger)
        elif args.pretrained and not args.checkpoint_path and not args.resume \
                and not args.skip_train:
            logger.warning(
                "PRETRAINED WEIGHTS UNAVAILABLE (no cache, no network): "
                "training %s from RANDOM INITIALIZATION. The reference "
                "default fine-tunes pretrained weights — results will NOT "
                "match it. Provide --torch_weights / a populated HF or "
                "torch-hub cache, or pass --no-pretrained to silence this.",
                args.model)
        if args.checkpoint_path:
            logger.info("Loading checkpoint %s", args.checkpoint_path)
            load_checkpoint(args.checkpoint_path, trainer.state, map_location=device)
        if args.resume == "auto":
            found = find_resume_checkpoint(args.log_dir, args.model)
            if found:
                trainer.resume(found)
            else:
                logger.info("--resume auto: no prior checkpoint under %s — starting fresh",
                            args.log_dir)
        elif args.resume:
            trainer.resume(args.resume)

        if not args.skip_train:
            from ..utils.profiling import trace

            with trace(args.profile_dir, cuda=device.type == "cuda"):
                trainer.train()

        evaluator = Evaluator(
            trainer.eval_step, loaders["test"],
            class_names=loaders["test"].dataset.class_labels or ["non_referral", "referral"],
            logger=logger, exp_dir=exp_dir, device=device)
        auroc, f1, cm = evaluator.evaluate(trainer.state, sampling_method=args.test_sampling,
                                           eval_clips=args.eval_clips)
        logger.info("Final test — AUROC %.4f F1 %.4f", auroc, f1)
        return {"auroc": auroc, "f1": f1, "cm": cm, "exp_dir": str(exp_dir),
                "history": trainer.history}
    finally:
        for loader in loaders.values():
            loader.close()


def main(argv=None, model_default=None):
    args = build_parser(model_default).parse_args(argv)
    return run(args)


if __name__ == "__main__":
    main()
