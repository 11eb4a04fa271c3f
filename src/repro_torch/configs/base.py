"""Federated-learning hyper-parameters (the port's copy of
``repro.configs.base.FLConfig``: same fields, same defaults). The model
zoo's ``ModelConfig`` and arch registry come with a later slice."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """Cost-TrustFL hyper-parameters (paper §IV / §V-A)."""
    n_clouds: int = 3
    clients_per_cloud: int = 30
    clients_per_round: int = 30          # m in Eq. 10
    malicious_frac: float = 0.3
    attack: str = "none"                 # none|label_flip in this slice
    attack_scale: float = 10.0           # sign_flip/scaling/ipm/collusion knob
    gaussian_sigma: float = 1.0
    attack_z: float = 1.0                # ALIE mean − z·std evasion margin
    local_epochs: int = 5
    local_batch: int = 32
    lr: float = 0.01
    server_lr: float = 1.0
    rounds: int = 200
    ema_gamma: float = 0.9               # Eq. 9
    cost_lambda: float = 0.3             # λ in Eq. 4
    c_intra: float = 0.01                # $/GB intra-cloud
    c_cross: float = 0.09                # $/GB cross-cloud egress (AWS)
    ref_samples: int = 100
    dirichlet_alpha: float = 0.5
    aggregator: str = "cost_trustfl"     # or fedavg|krum|trimmed_mean|median|fltrust
    sketch_dim: int = 128                # fused-strategy lm-head grad sketch
    # gradient compression (repro_torch.compress)
    compressor: str = "none"             # none|topk|qsgd
    compress_ratio: float = 0.1          # top-k kept fraction
    qsgd_levels: int = 15                # QSGD states = 2*levels+1 (5 bits)
    link_policy: str = "cross_only"      # none|cross_only|intra_only|all
    # Eq. 7 contribution score: "scalar" = paper's norm-damped cosine,
    # "multi" = scalar gated by the adaptive multi-feature trust vector
    trust_features: str = "scalar"
