"""Carry weights and round state across between the reference and the
port as numpy arrays. The port keeps the reference's parameter layout
(conv HWIO, dense (in, out), sorted keys), so conversion is a copy."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.federated.engine import RoundState


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
