"""Serving CLI — online HTTP inference with dynamic batching (counterpart of
``laryngeal_tpu/cli/serve.py``).

``python -m laryngeal_tpu_torch.cli.serve --model
{vivit,timesformer,swin3d,resnet3d,resnet50_lstm} --model_path CKPT
[--model_size tiny] [--hidden_size 256 --num_layers 2] [--port N] [--device cuda]``

Loads a port checkpoint into ``infer.predictor.Predictor`` on the card and
serves it over the chosen wire (``--wire``, ``--wire_quality``,
``--wire_keep_ac``, ``--wire_pack_from``, ``--wire_lowres``, shared with
``cli.inference``); the checkpoint's ``model_kwargs.dtype`` sets the compute
dtype.
``serve/server.py`` gives the endpoint contract. AOT artifacts
(``--exported``) are not yet ported (ROADMAP.md).
"""

from __future__ import annotations

import argparse

from .inference import add_model_args, load_predictor


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Laryngeal video inference server (PyTorch port)")
    add_model_args(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008, help="0 picks a free port")
    p.add_argument("--max_batch", type=int, default=8,
                   help="Dynamic-batching window — also the largest batch shape")
    p.add_argument("--batch_buckets", type=str, default=None,
                   help="Comma-separated batch shapes (e.g. '1,4,8'): each "
                        "dispatch pads to the smallest bucket that fits")
    p.add_argument("--batch_timeout_ms", type=float, default=30.0,
                   help="Max wait to fill a batch before dispatching")
    p.add_argument("--decode_threads", type=int, default=None,
                   help="Concurrent host video decodes admitted (default: cpu count)")
    p.add_argument("--queue_depth", type=int, default=None,
                   help="Bound on queued requests awaiting the device "
                        "(default 4x max_batch; 0 = unbounded); a full queue "
                        "answers 503 + Retry-After")
    p.add_argument("--request_timeout_ms", type=float, default=0.0,
                   help="Per-request deadline (0 = none); expired requests "
                        "get 503 + Retry-After")
    p.add_argument("--max_upload_mb", type=float, default=512.0,
                   help="Reject /predict bodies larger than this (MB)")
    p.add_argument("--data_root", type=str, default=None,
                   help="Restrict path-based /predict requests to videos under "
                        "this directory (recommended when --host is not loopback)")
    return p


def parse_buckets(spec, max_batch: int):
    """'1,4,8' -> sorted bucket list ending at max_batch (validated)."""
    if spec:
        try:
            buckets = [int(b) for b in spec.split(",")]
        except ValueError:
            raise SystemExit(f"--batch_buckets must be comma-separated integers "
                             f"(e.g. '1,4,8'); got {spec!r}")
    else:
        buckets = [max_batch]
    bad = [b for b in buckets if b < 1 or b > max_batch]
    if bad:
        raise SystemExit(f"--batch_buckets entries {bad} outside [1, --max_batch="
                         f"{max_batch}]; raise --max_batch or drop the bucket")
    if max(buckets) < max_batch:
        buckets.append(max_batch)
    return sorted(set(buckets))


def main(argv=None):
    args = build_parser().parse_args(argv)
    buckets = parse_buckets(args.batch_buckets, args.max_batch)

    import numpy as np

    from ..serve.server import InferenceServer
    from ..utils.logger import ExperimentLogger

    logger = ExperimentLogger(args.log_dir, prefix=f"{args.model}-serve").get_logger()
    predictor = load_predictor(args, logger)
    # Run every batch shape once before accepting traffic (kernel build,
    # cuBLAS / cuDNN plan selection).
    rng = np.random.default_rng(0)
    for b in sorted(buckets, reverse=True):
        warm = rng.integers(0, 256, (b, predictor.num_frames, predictor.crop_size,
                                     predictor.crop_size, 3), dtype=np.uint8)
        predictor.predict_clip(warm)
        logger.info("Forward warmed for batch shape %s", warm.shape)

    server = InferenceServer(
        predictor, host=args.host, port=args.port, max_batch=args.max_batch,
        batch_timeout_ms=args.batch_timeout_ms, max_upload_mb=args.max_upload_mb,
        data_root=args.data_root, logger=logger,
        bucket_sizes=buckets if args.batch_buckets else None,
        decode_threads=args.decode_threads, queue_depth=args.queue_depth,
        request_timeout_ms=args.request_timeout_ms)
    print(f"serving on http://{args.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
