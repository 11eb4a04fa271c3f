"""Config dataclasses and the architecture registry: the port's copies
of ``repro.configs.base.FLConfig`` and ``ModelConfig`` (same fields,
same defaults, same properties), ``register_arch``/``get_arch`` and
``reduced``. Only the architectures the port runs are registered
(``recurrentgemma-2b`` and the dense ``gemma2-2b``, ``granite-3-8b``,
``h2o-danube-3-4b``, ``mistral-large-123b``); ``get_arch`` of another
raises ``KeyError``."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

# Block-type codes used in ``block_pattern`` (cycled over layers):
#   "A"  global (full) attention
#   "L"  local / sliding-window attention
#   "C"  chunked attention (llama4-style iRoPE chunks)
#   "R"  RG-LRU recurrent block (recurrentgemma)
#   "W"  RWKV6 time-mix block (not ported yet)
ATTN_BLOCKS = ("A", "L", "C")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("A",)
    window: int = 4096              # sliding window for "L" blocks
    chunk: int = 8192               # chunk size for "C" blocks
    attn_softcap: float = 0.0       # gemma2-style soft capping (0 = off)
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0              # 0 -> dense FFN
    moe_every: int = 1              # MoE on layers with i % moe_every == moe_every-1
    top_k: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ffn activation: "swiglu" | "geglu" | "gelu"
    ffn_act: str = "swiglu"
    # enc-dec (whisper)
    enc_layers: int = 0             # 0 -> decoder-only
    enc_frames: int = 1500          # stub audio frontend output length
    # vlm
    vis_tokens: int = 0             # >0 -> prefix of stub patch embeddings
    # recurrent (rglru / rwkv)
    rg_lru_dim: int = 0             # 0 -> d_model
    conv1d_width: int = 4
    # embeddings
    tie_embeddings: bool = True
    emb_scale: bool = False         # gemma-style sqrt(d_model) scaling
    norm_eps: float = 1e-6
    # distribution
    fl_strategy: str = "two_phase"  # "two_phase" | "fused"
    fsdp: bool = False              # shard params over data axis too
    remat: bool = True
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block type, cycling ``block_pattern``."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache,
        or the arch is explicitly long-context capable."""
        types = set(self.layer_types())
        if types <= {"R", "W", "L", "C"}:
            return True
        return "L" in types or "C" in types

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer + head): the
        reference's formula. It gives an "R" layer's gates, conv and
        Lambda 3*rd where the layer holds w_a and w_i (2*rd^2), conv_w
        (W*rd) and Lambda (rd), and leaves out ``final_norm``; the
        weights held are ``models.transformer.param_count``."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        attn = qkv + self.n_heads * hd * d
        if self.ffn_act in ("swiglu", "geglu"):
            ffn_dense = 3 * d * f
        else:
            ffn_dense = 2 * d * f
        total = v * d  # embeddings
        if not self.tie_embeddings:
            total += v * d
        for li, t in enumerate(self.layer_types()):
            total += 2 * d  # norms
            if t in ATTN_BLOCKS:
                total += attn
            elif t == "R":
                rd = self.rg_lru_dim or d
                total += 2 * d * rd + rd * d + 3 * rd  # linear in/out + gates
            elif t == "W":
                total += 4 * d * d + 2 * d  # r,k,v,o + decay params (approx)
            if self.is_moe_layer(li):
                total += self.n_experts * ffn_dense + d * self.n_experts
            else:
                total += ffn_dense
        total += self.enc_layers * (attn + ffn_dense + 4 * d)
        if self.is_encdec:
            total += self.num_layers * attn  # cross-attention
        return total

    def is_moe_layer(self, layer_idx: int) -> bool:
        return (self.n_experts > 0 and self.layer_types()[layer_idx] != "W"
                and layer_idx % self.moe_every == self.moe_every - 1)

    @property
    def n_moe_layers(self) -> int:
        return sum(self.is_moe_layer(i) for i in range(self.num_layers))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_exp = (3 if self.ffn_act in ("swiglu", "geglu") else 2) * d * f
        inactive = (self.n_experts - self.top_k) * per_exp * self.n_moe_layers
        return self.param_count() - inactive


@dataclass(frozen=True)
class FLConfig:
    """Cost-TrustFL hyper-parameters (paper §IV / §V-A)."""
    n_clouds: int = 3
    clients_per_cloud: int = 30
    clients_per_round: int = 30          # m in Eq. 10
    malicious_frac: float = 0.3
    attack: str = "none"                 # any repro_torch.core.attacks.UPDATE_ATTACKS
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


_ARCHES: Dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _ARCHES[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    """The registered config ``name``; ``KeyError`` for an architecture
    the port does not run yet."""
    if name not in _ARCHES:
        # import side-effect registration
        from repro_torch.configs import (  # noqa: F401
            gemma2_2b, granite_3_8b, h2o_danube_3_4b, mistral_large_123b,
            recurrentgemma_2b)
    if name not in _ARCHES:
        raise KeyError(f"arch {name!r} is not ported yet; ported: "
                       f"{sorted(_ARCHES)}")
    return _ARCHES[name]


def reduced(cfg: ModelConfig, *, d_model: int = 256, layers: int = 2
            ) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, small vocab/window — runs one step on CPU."""
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    # keep the pattern's first `layers` entries so every block type in the
    # family is exercised when layers >= len(pattern)
    pat = cfg.layer_types()[: max(layers, 1)]
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=d_model * 3,
        vocab_size=512,
        block_pattern=tuple(pat),
        window=64,
        chunk=64,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        enc_layers=2 if cfg.enc_layers else 0,
        enc_frames=16 if cfg.enc_layers else 1500,
        vis_tokens=8 if cfg.vis_tokens else 0,
        rg_lru_dim=d_model if cfg.rg_lru_dim else 0,
        rope_theta=10000.0,
        fsdp=False,
        remat=False,
    )
