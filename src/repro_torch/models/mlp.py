"""The Fig. 1 model: a one-hidden-layer ReLU MLP classifier (counterpart of
``benchmarks/run.py::_mlp``, which the port may not import).

At the paper experiment's widths, 192 inputs (8×8×3 images, flattened) →
128 (ReLU) → 10 classes: 25,994 fp32 parameters in the leaves ``w1`` (192,
128), ``b1`` (128,), ``w2`` (128, 10), ``b2`` (10,).
"""
from __future__ import annotations

import torch

N_IN, WIDTH, N_CLASSES = 192, 128, 10


def init(generator, n_in=N_IN, n_classes=N_CLASSES, width=WIDTH):
    """Parameters on the generator's device: w ~ N(0, 1/fan_in), b = 0."""
    dev = generator.device
    w1 = torch.randn((n_in, width), generator=generator, device=dev)
    w2 = torch.randn((width, n_classes), generator=generator, device=dev)
    return {"w1": w1 * n_in ** -0.5,
            "b1": torch.zeros((width,), device=dev),
            "w2": w2 * width ** -0.5,
            "b2": torch.zeros((n_classes,), device=dev)}


def logits(params, x):
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss(params, batch):
    """Mean cross-entropy, logsumexp − gold logit, of batch {"x" (b, n_in)
    fp32, "y" (b,) int64}."""
    lg = logits(params, batch["x"])
    gold = lg.gather(1, batch["y"][:, None])[:, 0]
    return (torch.logsumexp(lg, -1) - gold).mean()


def acc(params, x, y) -> float:
    """Share of ``x``'s rows whose argmax logit is the label ``y``."""
    return float((torch.argmax(logits(params, x), -1) == y).float().mean())
