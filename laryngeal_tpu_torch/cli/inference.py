"""Inference CLI — single-video and batch modes (counterpart of
``laryngeal_tpu/cli/inference.py``).

``python -m laryngeal_tpu_torch.cli.inference --model
{vivit,timesformer,swin3d,resnet3d,resnet50_lstm} --model_path CKPT --video_path V.mp4
[--model_size tiny] [--hidden_size 256 --num_layers 2] [--device cuda]``

Single video -> JSON result (schema of ``vivit_transformer/inference.py:225-248``);
``--video_dir`` walks a tree of .mp4s and writes a CSV + JSON summary
(``resnet50-2d-lstm/inference.py:250-351``). Ported: every model on every
wire (``--wire rgb|i420|delta|dct|dctp`` with ``--wire_quality`` 75,
``--wire_keep_ac`` 31, ``--wire_pack_from`` 14 and ``--wire_lowres`` 0 unless
given, the JAX CLI's defaults). AOT artifacts (``--exported``), frame
visualisations and the batch-mode plots are not yet ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import csv
import json
from datetime import datetime
from pathlib import Path

MODELS = ["vivit", "timesformer", "resnet3d", "resnet50_lstm", "swin3d"]


def add_model_args(p: argparse.ArgumentParser) -> None:
    """Flags shared by the inference and serving CLIs."""
    p.add_argument("--model", type=str, default=None, choices=MODELS)
    p.add_argument("--model_path", "--checkpoint_path", dest="model_path",
                   type=str, default=None,
                   help="Checkpoint directory (model.pt + metadata.json)")
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--sampling_method", type=str, default="uniform",
                   choices=["uniform", "random", "random_window"])
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--crop_size", type=int, default=None,
                   help="Input resolution (default: checkpoint metadata, else 224)")
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--model_size", type=str, default="tiny",
                   help="swin3d size: tiny|small|base|base_in22k (checkpoint metadata wins)")
    p.add_argument("--hidden_size", type=int, default=None,
                   help="resnet50_lstm LSTM width (checkpoint metadata wins, else 256)")
    p.add_argument("--num_layers", type=int, default=None,
                   help="resnet50_lstm LSTM depth (checkpoint metadata wins, else 2)")
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--wire", type=str, default="rgb",
                   choices=("rgb", "i420", "delta", "dct", "dctp"),
                   help="host->device payload format for the clip transfer (dct/dctp "
                        "are lossy transform-coded wires; the decode runs on the card)")
    p.add_argument("--wire_quality", type=int, default=75)
    p.add_argument("--wire_keep_ac", type=int, default=31)
    p.add_argument("--wire_pack_from", type=int, default=14)
    p.add_argument("--wire_lowres", type=int, default=0,
                   help="non-rgb wires: decode the source at 1/2**n resolution (native "
                        "mpeg4 lowres) and carry the reduced geometry through the wire; "
                        "lossy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")


def load_predictor(args, logger):
    from ..infer.predictor import Predictor
    from ..models.registry import get_model_spec

    if not args.model or not args.model_path:
        raise SystemExit("--model and --model_path are required")
    arch_defaults = {k: getattr(args, k) for k in get_model_spec(args.model).arch_flags
                     if getattr(args, k, None) is not None}
    return Predictor.from_checkpoint(
        model_name=args.model, checkpoint_path=args.model_path,
        num_frames=args.num_frames, sampling_method=args.sampling_method,
        num_classes=args.num_classes, crop_size=args.crop_size,
        image_size=args.image_size, arch_defaults=arch_defaults, logger=logger,
        wire=args.wire, device=args.device, wire_quality=args.wire_quality,
        wire_keep_ac=args.wire_keep_ac, wire_pack_from=args.wire_pack_from,
        wire_lowres=args.wire_lowres)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Laryngeal video inference (PyTorch port)")
    add_model_args(p)
    p.add_argument("--video_path", type=str, default=None)
    p.add_argument("--video_dir", type=str, default=None,
                   help="Batch mode over a directory tree of .mp4s")
    p.add_argument("--batch_size", type=int, default=4)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.video_path and not args.video_dir:
        raise SystemExit("one of --video_path / --video_dir is required")

    from ..utils.logger import ExperimentLogger

    exp_logger = ExperimentLogger(args.log_dir, prefix=f"{args.model}-inference")
    logger = exp_logger.get_logger()
    predictor = load_predictor(args, logger)
    results_dir = exp_logger.get_experiment_dir() / "inference_results"
    results_dir.mkdir(parents=True, exist_ok=True)

    if args.video_path:
        result = predictor.predict_video(args.video_path)
        out = results_dir / f"{Path(args.video_path).stem}_result.json"
        with open(out, "w") as f:
            json.dump(result, f, indent=4)
        logger.info("Result: %s (confidence %.4f) -> %s",
                    result["predicted_class"], result["confidence"], out)
        print(json.dumps(result, indent=2))
        return result

    videos = sorted(Path(args.video_dir).rglob("*.mp4"))
    logger.info("Batch inference over %d videos", len(videos))
    results = predictor.predict_videos([str(v) for v in videos],
                                       batch_size=args.batch_size)
    predictor.save_sampled_frames(results_dir)
    csv_path = results_dir / "batch_results.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["video_path", "predicted_class", "confidence", "prob_referral"])
        for r in results:
            w.writerow([r["video_path"], r["predicted_class"], f"{r['confidence']:.6f}",
                        f"{r['probabilities'].get('referral', 0.0):.6f}"])
    summary = {
        "total": len(results),
        "predicted_referral": sum(r["predicted_class"] == "referral" for r in results),
        "timestamp": datetime.now().isoformat(),
    }
    with open(results_dir / "batch_summary.json", "w") as f:
        json.dump({"summary": summary, "results": results}, f, indent=4)
    logger.info("Batch results -> %s", csv_path)
    print(json.dumps(summary, indent=2))
    return results


if __name__ == "__main__":
    main()
