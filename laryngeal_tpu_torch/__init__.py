"""laryngeal_tpu_torch — the PyTorch / CUDA port of laryngeal_tpu for one
NVIDIA H100.

It mirrors the JAX package's layout (ops, models, preprocess, infer, serve,
data, train, cli, compat) and imports nothing from it. Its kernels are
written by hand in ``csrc/`` and built on first use (ops/_build.py). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.

Ported so far: ViViT and TimeSformer, serving (decode -> preprocess -> model
-> probabilities -> dynamic-batching server) and training (dataset, loader,
train step, AdamW, trainer, evaluator, CLI). See ROADMAP.md for the rest.
"""

__version__ = "0.1.0"
