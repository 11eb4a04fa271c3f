"""Client-side substrate: the paper's CNN (2 conv + 2 FC, §V-A) and local
training (LocalTrain in Algorithm 1, line 8), batched over clients.

Parameters keep the reference's JAX layout — conv weights HWIO, dense
weights (in, out), a dict in sorted key order — so a flattened update
lines up element for element with ``repro``'s ``ravel_rows``. Every
function takes an explicit leading client axis ``m``: one grouped
convolution (``groups=m``) and one batched matmul per layer run all
clients at once, and the gradient of the summed per-client losses is
each client's own gradient.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def cnn_init(generator: torch.Generator, input_shape: Tuple[int, int, int],
             n_classes: int, *, device: torch.device) -> Params:
    """He-normal init from ``generator`` (its own stream: the numbers differ
    from the reference's ``jax.random`` draw; carry weights across with
    ``repro_torch.convert.params_from_numpy``)."""
    h, w, c = input_shape
    flat = (h // 4) * (w // 4) * 64                   # two 2x2 pools

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device)
        return x * float(np.sqrt(2.0 / fan_in))

    def zeros(n):
        return torch.zeros(n, device=device)

    return {
        "conv1_b": zeros(32), "conv1_w": norm((3, 3, c, 32), 9 * c),
        "conv2_b": zeros(64), "conv2_w": norm((3, 3, 32, 64), 9 * 32),
        "fc1_b": zeros(128), "fc1_w": norm((flat, 128), flat),
        "fc2_b": zeros(n_classes), "fc2_w": norm((128, n_classes), 128),
    }


def _conv_relu_pool(x: Tensor, w: Tensor, b: Tensor, m: int) -> Tensor:
    """SAME 3x3 conv + ReLU + 2x2 max-pool for m clients at once.
    x (B, m·C, H, W); w (m, 3, 3, C, O) HWIO; b (m, O)."""
    c, o = w.shape[3], w.shape[4]
    w_oihw = w.permute(0, 4, 3, 1, 2).reshape(m * o, c, 3, 3)
    y = F.conv2d(x, w_oihw, b.reshape(m * o), padding=1, groups=m)
    return F.max_pool2d(torch.relu(y), 2)


def cnn_apply_batched(params: Params, x: Tensor) -> Tensor:
    """Per-client params (leading axis m) on x (m, B, H, W, C) ->
    logits (m, B, n_classes)."""
    m, bsz, h, w, c = x.shape
    z = x.permute(1, 0, 4, 2, 3).reshape(bsz, m * c, h, w)
    z = _conv_relu_pool(z, params["conv1_w"], params["conv1_b"], m)
    z = _conv_relu_pool(z, params["conv2_w"], params["conv2_b"], m)
    # the reference flattens NHWC before fc1
    _, _, hh, ww = z.shape
    z = z.reshape(bsz, m, -1, hh, ww).permute(1, 0, 3, 4, 2).reshape(m, bsz, -1)
    z = torch.relu(torch.baddbmm(params["fc1_b"][:, None, :], z,
                                 params["fc1_w"]))
    return torch.baddbmm(params["fc2_b"][:, None, :], z, params["fc2_w"])


def cnn_apply(params: Params, x: Tensor) -> Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    return cnn_apply_batched({k: v[None] for k, v in params.items()},
                             x[None])[0]


def xent_loss(params: Params, x: Tensor, y: Tensor) -> Tensor:
    """Mean cross-entropy of one client's batch."""
    return F.cross_entropy(cnn_apply(params, x), y)


def accuracy(params: Params, x, y, batch: int = 512) -> float:
    """Top-1 accuracy over (x, y) (numpy or tensors), in batches."""
    dev = params["fc2_b"].device
    correct, n = 0, int(x.shape[0])
    with torch.no_grad():
        for i in range(0, n, batch):
            xb = torch.as_tensor(x[i:i + batch], device=dev)
            yb = torch.as_tensor(y[i:i + batch], device=dev)
            correct += int((cnn_apply(params, xb).argmax(-1) == yb).sum())
    return correct / n


def steps_for(n_samples: int, epochs: int, batch: int) -> int:
    """Total SGD steps of one LocalTrain (the reference's schedule)."""
    return epochs * max(1, n_samples // batch)


def local_train(params: Params, x: Tensor, y: Tensor, idx: Tensor, *,
                lr: float) -> Params:
    """Minibatch SGD from the broadcast global ``params`` for m clients at
    once; returns the updates g_i = w_global - w_local, leading axis m.

    x (m, S, H, W, C), y (m, S), idx (m, steps, batch) int64 minibatch
    indices into each client's S samples (drawn by the caller — own
    stream or replayed from the reference's key schedule)."""
    m, steps = idx.shape[0], idx.shape[1]
    rows = torch.arange(m, device=x.device)[:, None]
    names = list(params)
    local = [params[k].detach()[None].repeat((m,) + (1,) * params[k].dim())
             for k in names]
    for s in range(steps):
        for p in local:
            p.requires_grad_(True)
        ix = idx[:, s]
        logits = cnn_apply_batched(dict(zip(names, local)), x[rows, ix])
        # Σ of per-client mean losses: each client's gradient is its own
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y[rows, ix].reshape(-1),
                               reduction="sum") / ix.shape[1]
        grads = torch.autograd.grad(loss, local)
        with torch.no_grad():
            local = [p - lr * g for p, g in zip(local, grads)]
    return {k: params[k].detach()[None] - p.detach()
            for k, p in zip(names, local)}
