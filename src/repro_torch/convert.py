"""Carry weights and round state across between the reference and the
port as numpy arrays. The port keeps the reference's parameter layout
(conv HWIO, dense (in, out), sorted keys), so conversion is a copy; for
the model zoo it also unstacks the reference's ``scanned``/``tail``
layer groups (and an encoder's stacked ``encoder.layers``) into the
port's per-layer lists, and stacks them back, and carries an optimizer
state (``OptState``) across the same way."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.federated.engine import RoundState
from repro_torch.models.transformer import layer_period
from repro_torch.optim import OptState
from repro_torch.tree import tree_map


def params_from_numpy(params: Mapping[str, np.ndarray], *,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Reference params (as numpy, e.g. ``{k: np.asarray(v)}``) -> port
    params (float32 on ``device``, sorted keys)."""
    return {k: torch.tensor(np.asarray(params[k], np.float32),
                            device=device)
            for k in sorted(params)}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """Port params -> numpy arrays in the reference's layout."""
    return {k: params[k].detach().cpu().numpy() for k in sorted(params)}


def round_state_from_numpy(params: Mapping[str, np.ndarray],
                           rep_ema: np.ndarray, res_edge: np.ndarray,
                           seed: int, *, device: torch.device,
                           res_client: Optional[np.ndarray] = None,
                           feat_sep: Optional[np.ndarray] = None
                           ) -> RoundState:
    """A port :class:`RoundState` holding the reference state's params,
    reputation EMA, residuals and feature separability (running totals
    start at 0). ``res_client``/``feat_sep`` default to (0,), the
    reference's shape when the client wire is inactive / under
    ``trust_features="scalar"``."""
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    empty = np.zeros(0, np.float32)
    return RoundState(params=params_from_numpy(params, device=device),
                      rep_ema=dev(rep_ema),
                      res_client=dev(empty if res_client is None
                                     else res_client),
                      res_edge=dev(res_edge), cum_cost=zero,
                      cum_intra_bytes=zero, cum_cross_bytes=zero,
                      feat_sep=dev(empty if feat_sep is None else feat_sep),
                      seed=int(seed))


# ---------------------------------------------------------------------------
# model zoo: the reference's stacked layer groups <-> the port's list

def _unstack(tree: Mapping[str, Any], cfg: ModelConfig) -> List[Any]:
    """Layer i of the reference's {"scanned": [...], "tail": [...]}."""
    p = layer_period(cfg)
    r = cfg.num_layers // p
    return [tree_map(lambda a, i=i: np.asarray(a)[i // p], tree["scanned"][i % p])
            if i < r * p else tree["tail"][i - r * p]
            for i in range(cfg.num_layers)]


def _stack_group(group: List[Any]) -> Any:
    """Trees of one structure stacked leaf by leaf on a new leading
    axis."""
    first = group[0]
    if isinstance(first, Mapping):
        return {k: _stack_group([g[k] for g in group]) for k in first}
    return np.stack(group)


def _stack(layers: List[Any], cfg: ModelConfig) -> Dict[str, List[Any]]:
    p = layer_period(cfg)
    r = cfg.num_layers // p
    return {"scanned": [_stack_group([layers[i * p + j] for i in range(r)])
                        for j in range(p)] if r > 0 else [],
            "tail": layers[r * p:]}


def _from_np(device, dtype) -> Callable:
    def conv(a) -> torch.Tensor:
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, device=device)
        return torch.tensor(a.astype(np.float32), device=device).to(dtype)
    return conv


def _to_np(t: torch.Tensor) -> np.ndarray:
    """A copy (decode updates attention caches in place)."""
    t = t.detach().cpu()
    return (t if not t.is_floating_point() else t.float()).numpy().copy()


def model_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, *,
                            device, dtype=torch.float32) -> Dict[str, Any]:
    """Reference model params (numpy leaves, e.g. ``jax.tree.map(
    np.asarray, params)``) -> the port's {"embed", "layers": [...],
    "final_norm"[, "lm_head"][, "encoder": {"layers": [...],
    "final_norm"}]} in ``dtype`` on ``device``."""
    conv = _from_np(device, dtype)
    out = {k: conv(v) for k, v in tree.items()
           if k not in ("scanned", "tail", "encoder")}
    out["layers"] = [tree_map(conv, lp) for lp in _unstack(tree, cfg)]
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [tree_map(lambda a, i=i: conv(np.asarray(a)[i]),
                                enc["layers"])
                       for i in range(cfg.enc_layers)],
            "final_norm": conv(enc["final_norm"])}
    return out


def model_params_to_numpy(params: Mapping[str, Any], cfg: ModelConfig
                          ) -> Dict[str, Any]:
    """The port's model params -> the reference's stacked tree (numpy
    leaves, float32 for floating tensors)."""
    out = {k: _to_np(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out.update(_stack([tree_map(_to_np, lp) for lp in params["layers"]], cfg))
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": _stack_group([tree_map(_to_np, lp)
                                    for lp in enc["layers"]]),
            "final_norm": _to_np(enc["final_norm"])}
    return out


def model_cache_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig, *,
                           device, dtype=torch.float32) -> Dict[str, Any]:
    """A reference decode cache {"scanned", "tail"} (numpy leaves) -> the
    port's {"layers": [...]} (``pos`` stays int32; an encoder-decoder's
    ``cross`` keys and values come along as any other leaf)."""
    conv = _from_np(device, dtype)
    return {"layers": [tree_map(conv, lc) for lc in _unstack(tree, cfg)]}


def model_cache_to_numpy(cache: Mapping[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """The port's decode cache -> the reference's stacked tree."""
    return _stack([tree_map(_to_np, lc) for lc in cache["layers"]], cfg)


def opt_state_from_numpy(state, cfg: ModelConfig, *, device) -> OptState:
    """A reference ``OptState`` (step, mu, nu) with numpy leaves and the
    moments in the reference's stacked layout -> the port's: the step an
    int32 0-d tensor, the moments (or ``None``) fp32 per layer, on
    ``device``."""
    step, mu, nu = state

    def moments(tree):
        return None if tree is None else model_params_from_numpy(
            tree, cfg, device=device)
    return OptState(torch.tensor(np.asarray(step), dtype=torch.int32,
                                 device=device), moments(mu), moments(nu))


def opt_state_to_numpy(state: OptState, cfg: ModelConfig) -> OptState:
    """The port's ``OptState`` -> one with numpy leaves in the reference's
    layout (``repro.optim.OptState(*it)`` rebuilds the reference's)."""
    def moments(tree):
        return None if tree is None else model_params_to_numpy(tree, cfg)
    return OptState(np.asarray(state.step.cpu().numpy(), np.int32),
                    moments(state.mu), moments(state.nu))
