"""Train steps (the port's copy of ``repro/train/steps.py``): the plain
one-device step. The federated steps (``MeshTopology``,
``make_two_phase_step``, ``make_fused_step``, ``make_fl_train_step``) are
not ported yet."""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves


def make_plain_step(model: Model, mesh, optimizer: Tuple[Callable, Callable],
                    loss_chunk: int = 512) -> Callable:
    """``step(params, opt_state, batch) -> (new_params, new_opt_state,
    {"loss", "lm_loss", "aux_loss"})``: ``model.grad_fn`` then the
    optimizer's update. The update writes into ``params`` and
    ``opt_state``'s moments and returns them (the reference's jitted step
    donates both). ``mesh`` must be ``None``: training over a mesh is not
    ported yet. The step holds the card to the port's numerics contract
    (``resolve_device``: fp32 matmuls, deterministic cuDNN)."""
    if mesh is not None:
        raise NotImplementedError("training over a mesh is not ported yet; "
                                  "pass mesh=None")
    _, opt_update = optimizer
    grad = model.grad_fn(loss_chunk)

    def step(params, opt_state, batch):
        resolve_device(tree_leaves(params)[0].device)
        (loss, metrics), g = grad(params, batch)
        new_params, new_opt = opt_update(g, opt_state, params)
        return new_params, new_opt, {"loss": loss, **metrics}

    return step
