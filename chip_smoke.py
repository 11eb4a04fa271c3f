#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. card: print the card's name and power limit (nvidia-smi); check that
   ``resolve_device`` put cuDNN on its deterministic algorithms;
2. build: compile every CUDA kernel of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (timed; registers and spills from ptxas);
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (exact for topk_mask and stochastic_quantize,
   1e-5 in fp32 and 5e-2 in bf16 for the others; linear_scan also at a
   ragged (3, 1000, 130) and a multi-segment (1, 12295, 64); the fused
   trust stage, scalar and multi, with every row delivering, one not,
   none, and an odd count, phi, ts, reputation, norms, features,
   separability and weights within 1e-5, gbar and f2 exact, the median
   within 1e-6 relative; trust_score and trust_features are its
   standalone modes; the standalone modes, weighted_agg and the QSGD
   round trip also at the shard paths' 90 rows; linear_scan's backward,
   the reverse scan through the same kernel, at (1, 4096, 2560) in bf16
   and (3, 1000, 130) in fp32 against autograd through the plain scan,
   ∂a and ∂b within 5e-2 / 1e-5), then
   device times (CUDA graph replays between CUDA events, median of
   repeats) of the kernel's wrapper, the plain version and, where one
   PyTorch call computes the same function, that call (a yardstick the
   port never calls), and the wrapper's eager time from Python
   (``call_ms``, launch overhead included); linear_scan also cold
   (``ms_cold``: the calls rotate over 4 input sets, 168 MB in bf16, so
   no call finds its inputs in the 50 MB L2), in bf16 and fp32; for the
   trust stage, the launch floor of an empty kernel on its grid, plain
   and as an 8-block cluster; weighted_agg also without segments
   (FLTrust's (30, 545098) -> (545098,), beside ``torch.mv``) and
   topk_mask also on the flat client wire's (30, 545098) rows, with the
   time of its threshold (``row_threshold``, ``torch.topk``) at both
   shapes;
4. agreement: two rounds of each FL path at a small configuration on the
   card against the same rounds on the CPU (plain versions), from one
   initial state and one set of draws — masks, bytes and $ exact,
   reputation and params (and, on the defense paths, the feature
   separability) within 1e-4 relative (1e-5 on the host-loop paths
   without QSGD); the shard paths on one rank holding both a gloo and
   an NCCL group; then each shard path against the round engine's
   ``Engine.step`` on the card at full width, ROUNDS rounds each from
   the engine's state: masks, bytes and $ exact, reputation, params and
   separability within 1e-4 (cuDNN deterministic, as the entry points
   set it);
   and the serve path in fp32 at
   the test configuration (recurrentgemma-2b's layout at d_model 128,
   8 layers, window 64): the prefill of two 96-token prompts on the card
   against the CPU from the same weights — last logits and every cache
   leaf within 1e-4 relative, ``pos`` tags exact — then 4 greedy decode
   steps with equal tokens and logits within 1e-4; the same for a dense
   test configuration (gemma2-2b's alternating "L", "A" layout, both
   softcaps on, 8 layers at d_model 128); and one training step at
   recurrentgemma-2b's test configuration, the card (linear_scan forward
   and backward kernels) against the CPU from the same weights and batch:
   ``Model.grad_fn``'s loss and every gradient leaf within 1e-4
   relative, then one ``make_plain_step`` with AdamW and its loss; then
   one two-phase and one fused federated step (``train.make_fl_train_step``:
   4 clients in 2 clouds, 3 selected, SGD, Ω given) at both test
   configurations on one rank holding the card's NCCL and the CPU's gloo
   groups, the card against the CPU: the selected mask exact, the cost
   units within 1e-6 relative, the loss, phi, trust, beta and reputation
   within 1e-5, the params within 1e-4, the scan launches as predicted;
   and that two gradients of one batch are bit-identical on the card;
   then the MoE and RWKV6 families at test configurations (mixtral's
   layout with capacity factor 0.5, so its full-sequence forward drops
   tokens; llama4's C, C, C, A period at chunk 64 with a 96-token prompt,
   top-1; rwkv6's 3 "W" layers with a 150-token prompt; d_model 128,
   fp32), the card against the CPU: the prefill logits and cache, 4
   greedy decode steps, ``forward_hidden`` with its aux loss and one
   ``Model.grad_fn`` (loss and every gradient leaf) within 1e-4, the MoE
   routes (the kept (expert, token) pairs of every capacity selection)
   exactly equal, no kernel launched; then the encoder-decoder and VLM
   families at the CPU tests' configurations (whisper-small's layout with
   2 encoder and 2 decoder layers, 16 frames and ``rope_theta`` 0, so
   the sinusoidal positions run; paligemma-3b's with 2 layers and 8
   patches; d_model 64, fp32), the card against the CPU: the same
   checks, the encoder's output (whisper) and ``make_prefill_step`` with
   patches (paligemma) besides, the cache's cross-attention keys and
   values included, no kernel launched; then the federated steps of
   those families at the same test configurations, the card against the
   CPU under the bounds of the recurrentgemma and dense ones: mixtral's
   fused step (its MoE layers dropping tokens), rwkv6's, whisper's (with
   frames) and paligemma's (with patches) two-phase steps and
   paligemma's fused step (which cuts the text offset), the MoE routes
   equal, no kernel launched; then the (1, 1) mesh of
   ``launch.mesh.make_debug_mesh(1)`` (``mesh_phase``): the two-phase
   and fused steps at the recurrentgemma and dense test configurations
   over the mesh (parameters and moments stored by the reference's
   specs, AdamW after the clip) equal the same steps over
   ``ClientMesh(1)`` bit for bit, launches too, and ``make_plain_step``
   with the mesh equals it with ``mesh=None``;
5. main paths, with every launch counter reset just before the path and
   read just after it:
   * HEADLINE and DEFENSE, each five rounds of ``FLServer.run_round``
     (the loop ``run_simulation`` runs) at full width — 3 clouds x 30
     clients, 30 selected, the paper's CNN (D = 545,098):
     - HEADLINE (README): label_flip, top-k 0.1 on cross-cloud links;
       trust_stage, weighted_agg and topk_mask once per round, the
       standalone trust_score and trust_features, QSGD and scan kernels
       never;
     - DEFENSE (README "Multi-feature Byzantine defense"): alie_norm,
       the multi-feature gate, QSGD (15 levels) on every client and edge
       uplink; trust_stage and weighted_agg once per round,
       stochastic_quantize twice (client wire, edge wire), topk_mask,
       the standalone trust kernels and linear_scan never; feature
       weights finite and summing to 1, residuals finite;
   * FEDAVG, KRUM, TRIMMED_MEAN, MEDIAN and FLTRUST (the paper's Fig. 8
     baseline arm), five rounds each at full width with the headline's
     knobs and ``aggregator=<method>``: the flat round, each client's
     one uplink (top-k across clouds); topk_mask once per round,
     weighted_agg once per round on FLTRUST (its aggregate) and never on
     the others, the trust and QSGD kernels never;
   * DROPOUT: Cost-TrustFL at the headline's wire under the registered
     ``dropout`` scenario (no attack, each selected client fails to
     deliver with probability 0.3); trust_stage, weighted_agg and
     topk_mask once per round; fewer than 30 deliver;
   * HOST_HEADLINE and HOST_DEFENSE: the headline's and the defense's
     knobs through the host round loop (``FLServer(engine="host")``:
     numpy selection, only the delivered clients train, the host twin
     ``cost_trustfl_aggregate``), with the same launches per round as
     HEADLINE and DEFENSE;
   * DROPOUT_MEDIAN: the coordinate median at the headline's wire under
     ``dropout``, which ``engine="auto"`` routes to the host loop (only
     it runs dropout under an order statistic); topk_mask once per
     round, every other kernel never;
   * SHARD_HEADLINE and SHARD_DEFENSE: the headline's and the defense's
     knobs on the mesh-sharded engine (``FLServer(engine="shard")``),
     one rank on NCCL: all 90 clients train (masked), the standalone
     trust_score once per round (and trust_features on SHARD_DEFENSE),
     weighted_agg once, topk_mask once (SHARD_HEADLINE) or
     stochastic_quantize twice (SHARD_DEFENSE), trust_stage never;
   every FL path: params finite; bytes and $ equal the cost model's for
   each delivered mask; then the test accuracy and rounds/s of each;
   * SERVE: ``repro_torch.launch.serve.serve`` at recurrentgemma-2b's
     full published widths and all 26 layers, bf16, weights from seed 0,
     4 slots, 8 requests of a 4096-token prompt (twice the window) and
     16 greedy tokens; linear_scan exactly once per "R" layer per
     prefill (8 x 18 = 144), every FL kernel never; logits finite,
     tokens in the vocabulary; the parameter count held, peak memory,
     prefill ms per request and decode tokens/s;
   * SERVE_GEMMA2, SERVE_DANUBE, SERVE_GRANITE: the same launcher at
     gemma2-2b's, h2o-danube-3-4b's and granite-3-8b's full published
     widths, bf16, weights from seed 0, 2 slots, 4 requests of 4096 + 16
     greedy tokens; every kernel never (no Pallas kernel lies on a dense
     path); the weights held ``param_count()`` + d_model (final_norm);
   * SERVE_MIXTRAL, SERVE_LLAMA4, SERVE_RWKV6: the same launcher, bf16,
     at the full published widths of mixtral-8x7b (16 of its 32 layers,
     8 experts, top-2; 2 slots, 4 requests of 4096 + 16: the window-4096
     ring wraps in decode), llama4-maverick-400b-a17b (one whole period
     C, C, C, A with MoE on layers 1 and 3, all 128 experts, top-1, the
     202,048-row tied embedding; 1 slot, 2 requests of 9216 + 16: the
     "C" layers' second 8192-token chunk) and rwkv6-1.6b (all 24 layers;
     2 slots, 4 requests of 4096 + 16), the depth cut by patching the
     launcher's ``build_model``; every kernel never; the weights held
     exactly (23,351,398,400 / 33,751,413,760 / 1,483,180,032); less
     than 2 GiB allocated before each, the weights released after; then
     one steady prefill and the 16 decode steps after it of each traced
     with ``torch.profiler`` (device events, busy ms by kernel group,
     idle share);
   * SERVE_WHISPER, SERVE_PALIGEMMA: the same launcher, bf16, at the
     full published widths and depths of whisper-small (12 encoder and
     12 decoder layers, d_model 768; 4 slots, 8 requests of 432 + 16
     tokens, the decoder's 448 positions, each request's 1500 frames
     from ``dummy_batch`` encoded first) and paligemma-3b (18 layers; 2
     slots, 4 requests of ``prompt_len`` 1280: 1024 text tokens, the
     launcher's prefill ignoring the 256 patches as the reference's does,
     then decoding from index 1280); every kernel never; the weights
     held exactly (238,060,800 / 2,508,662,784); each profiled as the
     MoE and RWKV6 paths are;
   * PREFIX_PREFILL_PALIGEMMA: ``serve.decode.make_prefill_step`` at
     paligemma-3b's full widths and depth in bf16 on 2 rows of 256
     patches (the bidirectional prefix) and 1024 text tokens; one
     warm-up call and 3 timed ones (first and steady ms), every kernel
     never, the logits finite;
   * TRAIN: recurrentgemma-2b at full width (26 layers, fp32 weights,
     every layer rematerialized) through ``train.make_plain_step``,
     AdamW on a cosine schedule after ``clip_by_global_norm(1.0)``,
     batches of 2 x 2048 tokens from ``token_batches``; one warm-up step
     and 3 timed ones, each exactly 36 linear_scan launches (18 "R"
     layers, forward and rematerialized forward) and 18 linear_scan_bwd,
     every FL kernel never; the loss finite and lower at the last step
     than at the first; step ms, tokens/s and peak memory;
   * FL_TRAIN_TWO_PHASE and FL_TRAIN_FUSED: the same model, optimizer and
     token stream through ``train.make_fl_train_step`` (4 clients of
     1 x 2048 tokens in 2 clouds, 3 selected, one 2048-token reference
     sequence a cloud, one NCCL rank): one warm-up step and 2 timed ones;
     the two-phase step launches linear_scan 36 and linear_scan_bwd 18
     per gradient evaluation (N + K in pass A, one per weighted client
     or falling-back cloud in pass B, read off the step's metrics), the
     fused step 72 and 18, every FL kernel never; the loss finite, the
     reputation summing to about 1; step ms, client tokens/s, peak
     memory; FL_TRAIN_TWO_PHASE first checks that two full-width
     gradients of one client's batch are bit-identical;
   * FL_TRAIN_MIXTRAL, FL_TRAIN_RWKV6, FL_TRAIN_WHISPER,
     FL_TRAIN_PALIGEMMA: the same step, optimizer, clients and clouds at
     the full published widths in fp32, each in its config's strategy:
     mixtral-8x7b cut to 2 of its 32 layers, fused, its MoE layers
     routing the 4 x 2048 tokens of the global batch (the routed pairs
     dropped counted); rwkv6-1.6b's 24 layers, two-phase, 1 x 256 tokens
     a client and one timed step; whisper-small's 12 + 12 layers,
     two-phase, 448 text tokens after 1500 stub frames; paligemma-3b's 18
     layers, two-phase, 256 stub patches before 1024 text tokens; every
     kernel never; less than 2 GiB allocated before each, the weights
     released after it; step ms, client tokens/s, peak memory, gradient
     evaluations a step;
   * FL_TRAIN_MIXTRAL_MESH: FL_TRAIN_MIXTRAL over the (1, 1) mesh, its
     parameters and moments stored by ``param_specs`` /
     ``opt_state_specs`` as DTensors; the mesh's one client holds the 4
     x 2048 tokens; every kernel never; step ms, peak and stored GiB;
   * FL_TRAIN_EXAMPLE: ``examples/federated_llm_train_torch.py`` at its
     defaults (60 steps); no kernel; the loss falls and the attacker's
     reputation ends below the honest mean;
   * LONG_DECODE_GEMMA2: one-token decode past the 2^20-slot chunk:
     one fp32 "A" layer at gemma2-2b's widths over 1,081,344 slots,
     chunked against the whole-cache softmax within 1e-5, one bf16
     layer's attention timed (chunked, whole, and PyTorch's
     ``scaled_dot_product_attention`` as a yardstick); then gemma2-2b at
     its full widths and 26 layers in bf16 through ``make_serve_step``
     over 13 "A" caches of 1,081,344 slots and 13 "L" caches of 4096,
     filled as after a prompt of 1,081,340 tokens, 8 greedy steps (the
     last 4 wrapping the ring), each held within 5e-2 of the same step
     through the whole cache; every kernel never; step ms against its
     bound, peak memory;
   * EXAMPLE_QUICKSTART, EXAMPLE_QUICKSTART_MULTI,
     EXAMPLE_BYZANTINE_DEFENSE, EXAMPLE_SERVE_BATCH: the reference's
     examples as ported (``examples/*_torch.py``) on the card, each
     ``run_simulation`` counted apart: Cost-TrustFL trust_stage and
     weighted_agg once a round, FLTrust weighted_agg once, the others
     never; quickstart's telemetry stream valid; every table cell
     finite; serve_batch on every arch of ``ARCH_IDS`` reduced,
     linear_scan once per "R" layer (2 on recurrentgemma-2b), and the
     tokens of gemma2-2b and recurrentgemma-2b equal to the CPU's;
6. telemetry (between the FL paths and SERVE): HEADLINE, DEFENSE and
   HOST_HEADLINE, ``ROUNDS`` rounds each through ``run_simulation`` with
   a JSONL and a list sink — every event valid, the JSONL file the
   stream, the last round's cumulative $ and bytes equal to the
   SimResult's, its ``params_l2`` within 1e-5 of a float64 norm of the
   final params, DEFENSE's feature weights in every round, launches
   exactly as ``PATHS`` states (telemetry adds none); the report CLI
   renders the HEADLINE stream and ``--validate-only`` refuses a broken
   line; ``run_simulation_batch``: one seed, streamed live, against the
   HEADLINE ``FLServer`` lines (masks, bytes, $ and the mask digest
   exact, floats within 1e-5; the count of byte-identical lines
   printed), with cuDNN put back on PyTorch's defaults before every
   entry point and checked deterministic after it (the entry points set
   the contract; nothing in this script does), two seeds on shared data
   against single-seed runs (totals exact); HEADLINE's steady rounds/s with telemetry off, on, on, off,
   off, on (``OVERHEAD_ROUNDS`` rounds a turn);
   a checkpoint of HEADLINE's params, reputation and a bf16 leaf,
   restored on the card bit for bit.

Prints one ``{"kernels": [...]}`` line (one entry per Pallas kernel,
launches per path under ``launches_by_path``; the fused trust stage's
launches count for trust_score on the Cost-TrustFL paths and for
trust_features on the defense paths, and the standalone modes' own
launches (the shard paths) too, apart under ``launches_standalone`` and
``launches_fused``; those two entries give the time, error and bound of
the stage, scalar for trust_score and multi for trust_features, with
their standalone modes' under ``standalone_*`` and at the shard's
shapes under ``shard``; linear_scan's entry carries its backward's
launches (``launches_bwd``, ``launches_bwd_by_path``) and its numbers
under ``bwd``) and, last, the ``{"ok": true, "device": ...}``
line. Exits non-zero without a CUDA device, and when
``src/repro_torch`` is not beside this script.

    torchrun --nproc-per-node 4 chip_smoke.py --mesh   # four cards

runs the four-card checks alone (``mesh_main``): first the serve paths
over a mesh (``MESH_SERVE_PATHS``: mistral-large-123b at all 88 layers
and mixtral-8x7b at all 32 over (1, 4); ``MESH_LONG``: gemma2-2b's
524,288-slot cache over (4, 1)), each after a 2-layer fp32 check against
one card; then the steps over the
(4, 1) and (2, 2) meshes against the whole-moment steps (bit for bit)
and a one-rank run (1e-5), the shard paths at world 4 and 3 against
``Engine.step``, and mixtral-8x7b at full width over the (4, 1) mesh
(fsdp, ZeRO-1) at 2 and 3 layers and the deepest depth that fits;
rank 0 writes ``chiprun_out/chip_smoke_mesh.json``.

    python3 chip_smoke.py --profile  # build, then trace steady work

traces two steady rounds of each FL path, and one steady prefill and 16
decode steps of the serve path, with ``torch.profiler`` and prints where
the device time goes (kernel groups, round phases — the ``round.*``
labels of ``Engine.step`` and the host loop —, top kernels, idle share
of the wall time) instead of running the checks, and checks that a
``telemetry.trace`` capture of a DEFENSE round holds the six labels. ``--out DIR`` also writes the
details (``chip_smoke.json``; with ``--profile``, ``profile.json`` and
the Chrome traces) into DIR.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32, outside the tensor cores
REPLACES = {       # Pallas kernel -> the port's CUDA source
    "trust_score": "src/repro/kernels/trust_score.py:76",
    "weighted_agg": "src/repro/kernels/weighted_agg.py:40",
    "topk_mask": "src/repro/kernels/topk_mask.py:48",
    "stochastic_quantize": "src/repro/kernels/quantize.py:58",
    "trust_features": "src/repro/kernels/trust_features.py:92",
    "linear_scan": "src/repro/kernels/linear_scan.py:54",
}
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = {n: f"{CSRC}/{n}.cu" for n in REPLACES}
SOURCES.update(trust_score=f"{CSRC}/trust_stage.cu",
               trust_features=f"{CSRC}/trust_stage.cu")
# the FL paths on which the fused trust_stage launch computes each
# function (trust_features only under trust_features="multi")
FUSED_INTO_STAGE = {"trust_score": ("headline", "defense", "dropout",
                                    "host_headline", "host_defense",
                                    "telemetry_headline", "telemetry_defense",
                                    "telemetry_host_headline",
                                    "batch_headline", "example_quickstart",
                                    "example_quickstart_multi",
                                    "example_byzantine_defense"),
                    "trust_features": ("defense", "host_defense",
                                       "telemetry_defense",
                                       "example_quickstart_multi")}
# the test suite's small topology at the same headline knobs
SMALL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
             local_epochs=1, local_batch=8, ref_samples=16)
HEADLINE = dict(attack="label_flip", malicious_frac=0.3, compressor="topk",
                compress_ratio=0.1, link_policy="cross_only")
DEFENSE = dict(attack="alie_norm", malicious_frac=0.3, trust_features="multi",
               compressor="qsgd", qsgd_levels=15, link_policy="all")
TOPK_WIRE = dict(compressor="topk", compress_ratio=0.1,
                 link_policy="cross_only")
FLAT = ("fedavg", "krum", "trimmed_mean", "median", "fltrust")


def _per_round(**launches):
    """Launches per round of every kernel on a path (0: never)."""
    out = dict(trust_stage=0, trust_score=0, weighted_agg=0, topk_mask=0,
               stochastic_quantize=0, trust_features=0, linear_scan=0,
               linear_scan_bwd=0)
    out.update(launches)
    return out


# path -> (FLConfig knobs, registered scenario or None, FLServer's
# ``engine=``, launches per round). "auto" is given only where it routes
# to the host round loop, and the path checks that it did
PATHS = {
    "headline": (HEADLINE, None, "jit",
                 _per_round(trust_stage=1, weighted_agg=1, topk_mask=1)),
    "defense": (DEFENSE, None, "jit",
                _per_round(trust_stage=1, weighted_agg=1,
                           stochastic_quantize=2)),
    # the paper's Fig. 8 baseline arm at the headline's knobs: each
    # client's one uplink, top-k across clouds (one topk_mask launch over
    # the selected rows); FLTrust's aggregate is one weighted_agg launch
    **{m: (dict(HEADLINE, aggregator=m), None, "jit",
           _per_round(topk_mask=1, weighted_agg=int(m == "fltrust")))
       for m in FLAT},
    # Cost-TrustFL at the headline's wire under the registered dropout
    # scenario (no attack, p_drop 0.3): the trust stage over rows with w = 0
    "dropout": (TOPK_WIRE, "dropout", "jit",
                _per_round(trust_stage=1, weighted_agg=1, topk_mask=1)),
    # the host round loop: the host twin's one trust_stage and one
    # segmented weighted_agg a round, the edge wire (and on defense the
    # client wire) through the same codecs
    "host_headline": (HEADLINE, None, "host",
                      _per_round(trust_stage=1, weighted_agg=1,
                                 topk_mask=1)),
    "host_defense": (DEFENSE, None, "host",
                     _per_round(trust_stage=1, weighted_agg=1,
                                stochastic_quantize=2)),
    # dropout under an order statistic: only the host loop runs it; the
    # median of the delivered rows, the flat wire top-k across clouds
    "dropout_median": (dict(TOPK_WIRE, aggregator="median"), "dropout",
                       "auto", _per_round(topk_mask=1)),
    # the mesh-sharded engine at world size 1 (NCCL): every client trains
    # (masked), the trust path's standalone modes over the 90 rows given
    # the all-reduced gbar and median, one segmented weighted_agg whose
    # partial sums are all-reduced; the client wire over the 90 rows
    "shard_headline": (HEADLINE, None, "shard",
                       _per_round(trust_score=1, weighted_agg=1,
                                  topk_mask=1)),
    "shard_defense": (DEFENSE, None, "shard",
                      _per_round(trust_score=1, trust_features=1,
                                 weighted_agg=1, stochastic_quantize=2)),
}
SHARD_PATHS = ("shard_headline", "shard_defense")
# the telemetry phase's paths (run_simulation with a JSONL sink), and the
# steady rounds a turn of its telemetry off/on rounds/s comparison
TELEMETRY_PATHS = ("headline", "defense", "host_headline")
OVERHEAD_ROUNDS = 16
# the round phases' profiler labels (Engine.step, the host round loop)
PHASES = ("round.select", "round.train", "round.attack", "round.compress",
          "round.aggregate", "round.account")
# the serve paths at full width, as the launcher runs them: path ->
# (launcher arguments, weights held, layers: None for the published depth,
# else the depth the launcher's model is cut to). recurrentgemma-2b holds
# w_a, w_i and final_norm beyond ModelConfig.param_count(); the dense and
# MoE archs hold param_count() + d_model (final_norm); rwkv6-1.6b holds
# its "W" layers' decay LoRA, w0, u, mixes and channel-mix w_r beyond it.
# mixtral-8x7b keeps 16 of its 32 layers (43.5 GiB in bf16), llama4 one
# whole period of 4 (C, C, C, A; MoE on 1 and 3; 62.9 GiB): the published
# depths do not fit one card
SERVE = dict(arch="recurrentgemma-2b", batch=4, requests=8, prompt_len=4096,
             gen=16, dtype="bfloat16", seed=0)
DENSE_SERVE = dict(SERVE, batch=2, requests=4)   # half the traffic
SERVE_PATHS = {
    "serve": (SERVE, 2_894_435_840, None),
    "serve_gemma2": (dict(DENSE_SERVE, arch="gemma2-2b"),
                     2_614_219_776 + 2304, None),
    "serve_danube": (dict(DENSE_SERVE, arch="h2o-danube-3-4b"),
                     3_838_955_520 + 3840, None),
    "serve_granite": (dict(DENSE_SERVE, arch="granite-3-8b"),
                      8_170_844_160 + 4096, None),
    "serve_mixtral": (dict(DENSE_SERVE, arch="mixtral-8x7b"),
                      23_351_398_400, 16),
    # 9216 tokens: the "C" layers' second chunk of 8192
    "serve_llama4": (dict(DENSE_SERVE, arch="llama4-maverick-400b-a17b",
                          batch=1, requests=2, prompt_len=9216),
                     33_751_413_760, 4),
    "serve_rwkv6": (dict(DENSE_SERVE, arch="rwkv6-1.6b"), 1_483_180_032,
                    None),
    # 432 + 16: the decoder's 448 positions; 1500 frames a request
    "serve_whisper": (dict(SERVE, arch="whisper-small", prompt_len=432),
                      238_060_800, None),
    # 256 patches + 1024 text tokens; decoding starts at index 1280
    "serve_paligemma": (dict(DENSE_SERVE, arch="paligemma-3b",
                             prompt_len=1280), 2_508_662_784, None),
}
# the serve paths of the MoE, RWKV6, encoder-decoder and VLM families:
# each is also profiled, one steady prefill and its decode steps
# (``profile_serve``)
FAMILY_SERVE = ("serve_mixtral", "serve_llama4", "serve_rwkv6",
                "serve_whisper", "serve_paligemma")
# phase 4's test configurations of those families (``_family_test_model``)
FAMILY_TESTS = ("mixtral", "llama4", "rwkv6", "whisper", "paligemma")
# the VLM's prefill with its image prefix, ``serve.decode.make_prefill_step``
# at paligemma-3b's full widths and depth: one warm-up call, then CALLS
PREFIX_PREFILL = dict(arch="paligemma-3b", batch=2, seq=256 + 1024, calls=3,
                      dtype="bfloat16", seed=0, held=2_508_662_784)
# the train path: recurrentgemma-2b at full width in fp32, every layer
# rematerialized, AdamW on a cosine schedule after global-norm clipping,
# batches of 2 x 2048 tokens from the token stream; one warm-up step,
# then STEPS timed ones
TRAIN = dict(arch="recurrentgemma-2b", batch=2, seq=2048, warmup=1, steps=3,
             lr=3e-4, clip=1.0, loss_chunk=512, stream_tokens=50_000, seed=0)
# the federated train paths: the same model, optimizer and token stream
# as TRAIN through the Cost-TrustFL step of each strategy, 4 clients of
# 1 x 2048 tokens in 2 clouds, 3 selected, one 2048-token reference
# sequence a cloud; one warm-up step, then STEPS timed ones; ``layers``
# cuts the depth (None: the published one)
FL_TRAIN = dict(TRAIN, clients=4, clouds=2, selected=3, per=1, ref_rows=1,
                steps=2, layers=None)
# then the other families at their full published widths, fp32, each
# through its config's strategy: mixtral-8x7b cut to 2 of its 32 layers
# (a layer holds 1.41 B expert weights, 16 B each with the gradient and
# AdamW's moments); rwkv6-1.6b on 256 tokens a row (four 64-token chunks:
# its per-token loop makes a step launch-bound) and one timed step;
# whisper-small's 448 text tokens after 1500 stub frames; paligemma-3b's
# 256 stub patches before 1024 text tokens (``seq`` counts both).
# llama4-maverick's one MoE layer alone would take 64 GB in fp32: it
# trains reduced, on the CPU only
FL_TRAIN_PATHS = {
    "fl_train_two_phase": dict(FL_TRAIN, strategy="two_phase"),
    "fl_train_fused": dict(FL_TRAIN, strategy="fused"),
    "fl_train_mixtral": dict(FL_TRAIN, arch="mixtral-8x7b", layers=2,
                             strategy="fused"),
    "fl_train_rwkv6": dict(FL_TRAIN, arch="rwkv6-1.6b", seq=256, steps=1,
                           strategy="two_phase"),
    "fl_train_whisper": dict(FL_TRAIN, arch="whisper-small", seq=448,
                             strategy="two_phase"),
    "fl_train_paligemma": dict(FL_TRAIN, arch="paligemma-3b",
                               seq=256 + 1024, strategy="two_phase"),
    # fl_train_mixtral over the (1, 1) mesh of ``make_debug_mesh(1)``:
    # parameters and moments stored by the reference's specs (whole on
    # one rank); its data axis holds one client, given the 4 x 2048
    # tokens of fl_train_mixtral's four
    "fl_train_mixtral_mesh": dict(FL_TRAIN, arch="mixtral-8x7b", layers=2,
                                  strategy="fused", mesh=(1, 1), clients=1,
                                  clouds=1, per=4, selected=1),
}
# the four-card mode's federated paths (``--mesh`` under torchrun, one
# card a rank): mixtral-8x7b at full width, fused, over the (4, 1) mesh,
# a client a card in 2 clouds, parameters stored over data (fsdp) and
# AdamW's moments by ZeRO-1; at 2 layers, 3, then the deepest depth the
# two runs' peaks say fits beside the memory outside PyTorch's allocator
# (MESH4_HEADROOM_GIB left free)
MESH4_TRAIN = dict(FL_TRAIN_PATHS["fl_train_mixtral"], mesh=(4, 1))
MESH4_HEADROOM_GIB = 4.0
# the four-card mode's serve paths over a mesh (``mesh_serve_phase``): the
# arch at its full published widths and depth in bf16, its weights drawn
# straight into their shards (``Model.init(..., mesh=)``); a batch of
# ``batch`` prompts of ``prompt`` tokens prefilled by ``Model.prefill``
# over the mesh (twice: first and steady), ``gen`` greedy steps of
# ``make_serve_step(batch=, max_len=prompt + gen)``, then
# ``make_prefill_step`` on ``prefill_rows`` x ``prompt`` (a warm-up call,
# then ``calls``). mistral-large-123b (245 GB in bf16) fits only as a
# quarter a card; mixtral's "L" ring of 4096 slots wraps in the greedy
# steps, its 8 experts 2 a card
MESH_SERVE = dict(batch=4, prompt=4096, gen=16, prefill_rows=2, calls=2,
                  dtype="bfloat16", seed=0)
MESH_SERVE_PATHS = {
    "serve_mistral_large_mesh4": dict(MESH_SERVE, arch="mistral-large-123b",
                                      mesh=(1, 4)),
    "serve_mixtral_mesh4": dict(MESH_SERVE, arch="mixtral-8x7b",
                                mesh=(1, 4)),
}
# the reference's long_500k over the (4, 1) mesh: gemma2-2b at its full
# widths and depth in bf16, batch 1, caches of ``slots`` slots whose
# sequence is cut over data (the "A" layers' 2^17 a card, the "L"
# layers' 4096-slot window 1024 a card); keys and values drawn on each
# card into its shard, the positions those of a prefilled prompt of
# ``slots - empty`` tokens; ``steps`` greedy steps
MESH_LONG = dict(arch="gemma2-2b", mesh=(4, 1), slots=1 << 19, empty=4,
                 steps=8, dtype="bfloat16", seed=0)
# beside each: the arch at 2 layers, full width, fp32 over the same mesh
# against one card's ``mesh=None`` steps on every rank: a batch of the
# path's prompts of ``prompt`` tokens, ``steps`` greedy steps (logits
# within 1e-4 of max |logit|, tokens equal) and ``make_prefill_step``;
# the long path over one cache of its ``slots`` slots, whole on the card
# and cut over the ranks, ``_DECODE_CHUNK`` at ``chunk`` on both sides so
# that both scan chunks (``long_steps`` steps within 1e-5)
MESH_PARITY = dict(layers=2, prompt=256, steps=4, seed=1, chunk=1 << 16,
                   long_steps=2)
# phase 4's federated steps of those families, at their test
# configurations (``_family_test_model``), in their configs' strategies;
# paligemma in both, so the fused step cuts its text offset on the card
FL_TRAIN_FAMILIES = {"mixtral": ("fused",), "rwkv6": ("two_phase",),
                     "whisper": ("two_phase",),
                     "paligemma": ("two_phase", "fused")}
# examples/federated_llm_train_torch.py at its own defaults
FL_EXAMPLE = dict(steps=60, seq=128, d_model=256, layers=4)
# one-token decode over a cache past the 2^20-slot chunk: gemma2-2b at
# its full published widths and depth in bf16, batch 1; the 13 "A"
# layers hold SLOTS = 2^20 + 2^15 (one whole chunk and a ragged 32,768),
# the 13 "L" layers their 4096-token window, as if a prompt of SLOTS - 4
# tokens had been prefilled; STEPS greedy steps from index SLOTS - 4, the
# last four wrapping the "A" ring (index % SLOTS, as the reference's)
LONG_DECODE = dict(arch="gemma2-2b", slots=(1 << 20) + (1 << 15), empty=4,
                   steps=8, dtype="bfloat16", seed=0, held=2_614_222_080)
# the reference's four examples, ported: quickstart at its defaults and
# with the multi-feature gate; byzantine_defense on the paper's four
# static attacks; serve_batch on every arch of ARCH_IDS, reduced
QUICKSTART_RUNS = {"example_quickstart": [],
                   "example_quickstart_multi": ["--trust-features", "multi",
                                                "--rounds", "4"]}
BYZANTINE = dict(rounds=2)
SERVE_BATCH_ON_CPU = ("gemma2-2b", "recurrentgemma-2b")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def _events_ms(torch, run, repeats: int, per_run: int) -> float:
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_run)
    return statistics.median(times)


def time_ms(torch, fn, repeats: int = 21, inner: int = 10) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    the graph replayed between CUDA events, the median over ``repeats``
    divided by ``inner``. The graph takes Python and launch overhead off
    the clock, so this is what the card spends."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, repeats, inner)


def time_cold_ms(torch, fn, sets, repeats: int = 21) -> float:
    """:func:`time_ms` of ``fn(*inputs)`` with each call's inputs cold in
    the 50 MB L2: the captured calls cycle through ``sets`` (more bytes
    in all than the L2 holds), so a call's inputs were last read
    ``len(sets) - 1`` calls earlier. Twice ``len(sets)`` calls a graph
    keep the cycle unbroken from one replay to the next."""
    calls = itertools.cycle(sets)
    return time_ms(torch, lambda: fn(*next(calls)), repeats,
                   inner=2 * len(sets))


def call_ms(torch, fn, repeats: int = 21, inner: int = 10) -> float:
    """Eager time of one call from Python (wrapper and launch overhead
    included), between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()
    return _events_ms(torch, run, repeats, inner)


def bound(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(torch, a, b, tol: float) -> bool:
    return bool(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))


def kernel_phase(torch, ops, dev):
    """Each kernel against its plain version at the main path's shapes,
    then timings. Returns {name: record} without ``launches``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m, k, L, D = 30, 3, 1290, 545_098
    k_keep = 54_510
    seg = torch.arange(k, device=dev, dtype=torch.int32).repeat_interleave(
        m // k)
    rec = {}

    # trust_score: (30, 1290) last layers, (3, 1290) own-cloud refs
    g = torch.randn(m, L, generator=gen, device=dev)
    refs = torch.randn(k, L, generator=gen, device=dev)
    rep = torch.rand(m, generator=gen, device=dev)
    gbar = g.mean(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        gd, rd = g.to(dtype), refs.to(dtype)
        for ref, idx in ((rd, seg), (rd[0], None)):
            got = ops.trust_score(gd, gbar, ref, rep, ref_idx=idx)
            want = ops.trust_score_plain(gd, gbar, ref, rep, ref_idx=idx)
            for a, b, what in zip(got, want, ("phi", "ts", "norms")):
                check(close(torch, a, b, tol),
                      f"trust_score {dtype} {what}: max err "
                      f"{max_err(torch, a, b)} > {tol}")
    got = ops.trust_score(g, gbar, refs, rep, ref_idx=seg)
    want = ops.trust_score_plain(g, gbar, refs, rep, ref_idx=seg)
    torch.cuda.synchronize()
    b_ms, b_by = bound(4 * (m * L + L + k * L + m + m + 3 * m), 10 * m * L)
    run = lambda: ops.trust_score(g, gbar, refs, rep, ref_idx=seg)  # noqa: E731
    rec["trust_score"] = dict(
        max_abs_err=max(max_err(torch, a, b) for a, b in zip(got, want)),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.trust_score_plain(
            g, gbar, refs, rep, ref_idx=seg)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"G ({m}, {L}) f32, refs ({k}, {L})")

    # weighted_agg: (30, 545098) updates -> (3, 545098) cloud aggregates
    g = torch.randn(m, D, generator=gen, device=dev)
    ts = torch.rand(m, generator=gen, device=dev) + 0.1
    ref_norm = torch.rand(k, generator=gen, device=dev) + 1.0
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        gd = g.to(dtype)
        norms = torch.linalg.vector_norm(gd.float(), dim=1)
        for sg, n_seg, rn in ((seg, k, ref_norm), (None, 1, ref_norm[:1])):
            got = ops.weighted_agg(gd, ts, norms, rn, seg=sg, n_seg=n_seg)
            want = ops.weighted_agg_plain(gd, ts, norms, rn, seg=sg,
                                          n_seg=n_seg)
            check(close(torch, got, want, tol),
                  f"weighted_agg {dtype} n_seg={n_seg}: max err "
                  f"{max_err(torch, got, want)} > {tol}")
    norms = torch.linalg.vector_norm(g, dim=1)
    got = ops.weighted_agg(g, ts, norms, ref_norm, seg=seg, n_seg=k)
    want = ops.weighted_agg_plain(g, ts, norms, ref_norm, seg=seg, n_seg=k)
    w = ops.agg_weights(ts, norms, ref_norm, seg, k)
    w_mat = torch.zeros(k, m, device=dev)
    w_mat[seg.long(), torch.arange(m, device=dev)] = w
    check(close(torch, torch.mm(w_mat, g), want, 1e-5),
          "weighted_agg: the library yardstick disagrees")
    b_ms, b_by = bound(4 * (m * D + 2 * m + k * D), 2 * m * D)
    run = lambda: ops.weighted_agg_rows(g, w, seg, k)  # noqa: E731
    rec["weighted_agg"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.weighted_agg_rows_plain(
            g, w, seg, k)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: torch.mm(w_mat, g)),
        shape=f"G ({m}, {D}) f32 -> ({k}, {D})")
    # FLTrust's aggregate: the same G, one segment -> (D,)
    rn = ref_norm[:1]
    got = ops.weighted_agg(g, ts, norms, rn)
    want = ops.weighted_agg_plain(g, ts, norms, rn)
    check(close(torch, got, want, 1e-5), f"weighted_agg unsegmented: max "
          f"err {max_err(torch, got, want)} > 1e-5")
    w1 = ops.agg_weights(ts, norms, rn, None, 1)
    check(close(torch, torch.mv(g.t(), w1), want, 1e-5),
          "weighted_agg unsegmented: the library yardstick disagrees")
    run = lambda: ops.weighted_agg_rows(g, w1)  # noqa: E731
    rec["weighted_agg"]["flat"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.weighted_agg_rows_plain(g, w1)),
        bound_ms=bound(4 * (m * D + m + D), 2 * m * D)[0],
        library_ms=time_ms(torch, lambda: torch.mv(g.t(), w1)),
        shape=f"G ({m}, {D}) f32 -> ({D},) (FLTrust, no segments)")

    # topk_mask: the (3, 545098) edge uplinks, k = 54,510 per row
    y = torch.randn(k, D, generator=gen, device=dev) * 1e-3
    thr = ops.row_threshold(y, k_keep)
    for f16 in (False, True):
        got = ops.topk_mask(y, thr, fp16_roundtrip=f16)
        want = ops.topk_mask_plain(y, thr, fp16_roundtrip=f16)
        check(torch.equal(got, want),
              f"topk_mask fp16_roundtrip={f16}: not exact "
              f"(max err {max_err(torch, got, want)})")
    yb = y.to(torch.bfloat16)
    check(torch.equal(ops.topk_mask(yb, thr[:2]),
                      ops.topk_mask_plain(yb, thr[:2])),
          "topk_mask bf16 with a short threshold vector: not exact")
    b_ms, b_by = bound(4 * (2 * k * D + k), k * D)
    run = lambda: ops.topk_mask(y, thr, fp16_roundtrip=True)  # noqa: E731
    rec["topk_mask"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.topk_mask_plain(
            y, thr, fp16_roundtrip=True)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"G ({k}, {D}) f32, fp16 round trip fused",
        # the threshold: torch.topk outside the kernel, as the reference
        # takes it from lax.top_k (read the rows, write one value a row)
        row_threshold_ms=time_ms(torch, lambda: ops.row_threshold(y, k_keep)),
        row_threshold_bound_ms=bound(4 * (k * D + k), k * D)[0])
    # the flat client wire: every selected client's row, (30, D)
    y30 = torch.randn(m, D, generator=gen, device=dev) * 1e-3
    thr30 = ops.row_threshold(y30, k_keep)
    got = ops.topk_mask(y30, thr30, fp16_roundtrip=True)
    want = ops.topk_mask_plain(y30, thr30, fp16_roundtrip=True)
    check(torch.equal(got, want), "topk_mask (30 rows): not exact")
    run = lambda: ops.topk_mask(y30, thr30, fp16_roundtrip=True)  # noqa: E731
    rec["topk_mask"]["flat"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.topk_mask_plain(
            y30, thr30, fp16_roundtrip=True)),
        bound_ms=bound(4 * (2 * m * D + m), m * D)[0], library_ms=None,
        row_threshold_ms=time_ms(torch, lambda: ops.row_threshold(
            y30, k_keep)),
        row_threshold_bound_ms=bound(4 * (m * D + m), m * D)[0],
        shape=f"G ({m}, {D}) f32, k = {k_keep}, fp16 round trip fused "
              "(the flat client wire)")

    # stochastic_quantize: the client wire (30, D) and the edge wire
    # (3, D) at 15 levels, a zero row included; q and the fused round
    # trip (x_hat, residual) exact
    yq = torch.randn(m, D, generator=gen, device=dev) * 1e-3
    yq[0] = 0.0
    u = torch.rand(m, D, generator=gen, device=dev)
    levels = 15
    for rows in (m, k):
        y_r, u_r = yq[:rows], u[:rows]
        s_r = torch.amax(y_r.abs(), dim=1)
        check(torch.equal(
            ops.stochastic_quantize(y_r, s_r, u_r, levels=levels),
            ops.stochastic_quantize_plain(y_r, s_r, u_r, levels)),
            f"stochastic_quantize ({rows}, {D}): q not exact")
        for a, b, what in zip(
                ops.quantize_roundtrip(y_r, s_r, u_r, levels=levels),
                ops.quantize_roundtrip_plain(y_r, s_r, u_r, levels),
                ("x_hat", "residual")):
            check(torch.equal(a, b), f"stochastic_quantize ({rows}, {D}): "
                  f"{what} not exact (max err {max_err(torch, a, b)})")
    yb = yq[:k].to(torch.bfloat16)
    sb = torch.amax(yb.float().abs(), dim=1)
    check(torch.equal(ops.stochastic_quantize(yb, sb, u[:k], levels=levels),
                      ops.stochastic_quantize_plain(yb, sb, u[:k], levels)),
          "stochastic_quantize bf16: q not exact")
    scale = torch.amax(yq.abs(), dim=1)
    got = ops.quantize_roundtrip(yq, scale, u, levels=levels)
    want = ops.quantize_roundtrip_plain(yq, scale, u, levels)
    # fused round trip: read y and u, write x_hat and the residual
    b_ms, b_by = bound(4 * (4 * m * D + m), 11 * m * D)
    run = lambda: ops.quantize_roundtrip(yq, scale, u, levels=levels)  # noqa: E731
    s3 = scale[:k]
    q_b_ms, _ = bound(4 * (3 * m * D + m), 8 * m * D)
    rec["stochastic_quantize"] = dict(
        max_abs_err=max(max_err(torch, a, b) for a, b in zip(got, want)),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.quantize_roundtrip_plain(
            yq, scale, u, levels)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"y ({m}, {D}) f32, levels {levels}, fused round trip "
              "(x_hat, residual)",
        edge_ms=time_ms(torch, lambda: ops.quantize_roundtrip(
            yq[:k], s3, u[:k], levels=levels)),
        edge_bound_ms=bound(4 * (4 * k * D + k), 11 * k * D)[0],
        q_only_ms=time_ms(torch, lambda: ops.stochastic_quantize(
            yq, scale, u, levels=levels)),
        q_only_bound_ms=q_b_ms)

    # trust_features: (30, 1290) last layers, (3, 1290) own-cloud refs
    g = torch.randn(m, L, generator=gen, device=dev)
    refs = torch.randn(k, L, generator=gen, device=dev)
    w = torch.ones(m, device=dev)
    w[1] = 0.0
    gbar = (w @ g) / w.sum()
    med = torch.nanquantile(torch.linalg.vector_norm(g, dim=1), 0.5)
    nan = torch.tensor(float("nan"), device=dev)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        gd, rd = g.to(dtype), refs.to(dtype)
        for ref, idx, md in ((rd, seg, med), (rd[seg.long()], None, med),
                             (rd, seg, nan), (rd, seg, med * 0)):
            got = ops.trust_features(gd, ref, gbar, md, w, ref_idx=idx)
            want = ops.trust_features_plain(gd, ref, gbar, md, w,
                                            ref_idx=idx)
            check(close(torch, got, want, tol),
                  f"trust_features {dtype}: max err "
                  f"{max_err(torch, got, want)} > {tol}")
    got = ops.trust_features(g, refs, gbar, med, w, ref_idx=seg)
    want = ops.trust_features_plain(g, refs, gbar, med, w, ref_idx=seg)
    torch.cuda.synchronize()
    b_ms, b_by = bound(4 * (m * L + k * L + L + 1 + m + m + 4 * m),
                       8 * m * L)
    run = lambda: ops.trust_features(g, refs, gbar, med, w, ref_idx=seg)  # noqa: E731
    rec["trust_features"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=time_ms(torch, lambda: ops.trust_features_plain(
            g, refs, gbar, med, w, ref_idx=seg)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"G ({m}, {L}) f32, refs ({k}, {L})")

    rec["trust_stage"] = stage_record(torch, ops, dev, gen)
    shard_records(torch, ops, dev, gen, rec)

    # linear_scan: one serving prefill's (1, 4096, 2560) per "R" layer;
    # a ragged (3, 1000, 130) (T not a multiple of a cluster's steps, D
    # not of the 32 channels a block, rows not 16-byte aligned: the
    # plain-load staging); and (1, 12295, 64), several segments of a
    # cluster in either dtype; a in (0.1, 0.99) as tests/test_kernels.py
    # draws it
    errs = {}
    for shape in ((1, 4096, 2560), (3, 1000, 130), (1, 12295, 64)):
        a = 0.1 + 0.89 * torch.rand(*shape, generator=gen, device=dev)
        x = torch.randn(*shape, generator=gen, device=dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
            ad, xd = a.to(dtype), x.to(dtype)
            got = ops.linear_scan(ad, xd)
            want = ops.linear_scan_plain(ad, xd)
            check(got.dtype == dtype and close(torch, got, want, tol),
                  f"linear_scan {shape} {dtype}: max err "
                  f"{max_err(torch, got, want)} > {tol}")
            errs[(shape, dtype)] = max_err(torch, got, want)
    sets = scan_inputs(torch, gen, dev)
    (a, x), (ab, xb) = sets[torch.float32][0], sets[torch.bfloat16][0]
    n = a.numel()
    b_ms, b_by = bound(3 * n * 2, 2 * n)
    run = lambda: ops.linear_scan(ab, xb)  # noqa: E731
    rec["linear_scan"] = dict(
        max_abs_err=errs[((1, 4096, 2560), torch.bfloat16)],
        max_abs_err_fp32=errs[((1, 4096, 2560), torch.float32)],
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        ms_cold=time_cold_ms(torch, ops.linear_scan, sets[torch.bfloat16]),
        plain_ms=time_ms(torch, lambda: ops.linear_scan_plain(ab, xb)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="a, b (1, 4096, 2560) bf16 -> h bf16",
        fp32_ms=time_ms(torch, lambda: ops.linear_scan(a, x)),
        fp32_ms_cold=time_cold_ms(torch, ops.linear_scan,
                                  sets[torch.float32]),
        fp32_bound_ms=bound(3 * n * 4, 2 * n)[0],
        # not the scan: an elementwise add moves the same bytes (reads a
        # and b once, writes one output once), so it shows the rate that
        # the scan's traffic reaches on this card, below the data sheet's
        add_ms_cold=time_cold_ms(torch, torch.add, sets[torch.bfloat16]))
    rec["linear_scan"]["bwd"] = scan_bwd_record(torch, ops, dev, gen)
    return rec


def scan_bwd_record(torch, ops, dev, gen):
    """linear_scan's backward (``LinearScan``: the reverse scan, one
    launch of the same kernel) at the serve shape (1, 4096, 2560) in bf16
    and a ragged (3, 1000, 130) in fp32, against autograd through
    ``linear_scan_plain``: ∂a and ∂b within 5e-2 / 1e-5. Then, at the
    serve shape in bf16: the device time of ``linear_scan_bwd`` (CUDA
    graph), its eager call, and the plain backward (autograd through the
    plain scan, its graph kept, eager between CUDA events: autograd's
    backward does not capture). The bound is the function's own traffic:
    a, h, dh read once, ∂a and ∂b written once. The wrapper's three
    contiguous copies (the two time-reversing gathers and the flip back,
    each read once and written once) are not in it: they are timed apart
    (``copies_ms``, in a CUDA graph) beside their bytes
    (``copy_bytes``)."""
    errs = {}
    for shape, dtype, tol in (((1, 4096, 2560), torch.bfloat16, 5e-2),
                              ((3, 1000, 130), torch.float32, 1e-5)):
        a = (0.1 + 0.89 * torch.rand(*shape, generator=gen, device=dev)
             ).to(dtype)
        x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        dh = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        ar, xr = a.clone().requires_grad_(), x.clone().requires_grad_()
        h = ops.linear_scan(ar, xr)
        check(h.grad_fn is not None, "linear_scan: no grad_fn on the card")
        before = ops.linear_scan_bwd.launches
        got = torch.autograd.grad(h, (ar, xr), dh)
        check(ops.linear_scan_bwd.launches == before + 1,
              "linear_scan backward: the kernel did not launch once")
        ap, xp = a.clone().requires_grad_(), x.clone().requires_grad_()
        want = torch.autograd.grad(ops.linear_scan_plain(ap, xp), (ap, xp),
                                   dh)
        for g, w, what in zip(got, want, ("da", "db")):
            check(g.dtype == dtype and close(torch, g, w, tol),
                  f"linear_scan backward {shape} {dtype} {what}: max err "
                  f"{max_err(torch, g, w)} > {tol}")
        errs[dtype] = max(max_err(torch, g, w) for g, w in zip(got, want))
    shape = (1, 4096, 2560)
    a = (0.1 + 0.89 * torch.rand(*shape, generator=gen, device=dev)
         ).to(torch.bfloat16)
    x = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    dh = torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)
    h = ops.linear_scan(a, x)
    ap, xp = a.clone().requires_grad_(), x.clone().requires_grad_()
    hp = ops.linear_scan_plain(ap, xp)
    n = a.numel()
    b_ms, b_by = bound(5 * n * 2, 3 * n)
    run = lambda: ops.linear_scan_bwd(a, h, dh)  # noqa: E731

    def copies():
        # the wrapper's copies alone, with the index vectors it builds
        rev = torch.arange(shape[1] - 1, -1, -1, device=dev)
        a.index_select(1, torch.remainder(rev + 1, shape[1]))
        dh.index_select(1, rev)
        h.flip(1)
    return dict(
        max_abs_err=errs[torch.bfloat16], max_abs_err_fp32=errs[torch.float32],
        ms=time_ms(torch, run), call_ms=call_ms(torch, run),
        plain_ms=call_ms(torch, lambda: torch.autograd.grad(
            hp, (ap, xp), dh, retain_graph=True)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        copies_ms=time_ms(torch, copies), copy_bytes=3 * 2 * n * 2,
        shape="a, h, dh (1, 4096, 2560) bf16 -> da, db bf16")


def shard_records(torch, ops, dev, gen, rec, n=90, k=3, L=1290,
                  D=545_098) -> None:
    """The kernels at the shard paths' shapes (world size 1: one rank's
    90 rows, every client trained and masked), each against its plain
    version and timed, into ``rec[name]["shard"]``: the standalone
    ``trust_score`` and ``trust_features`` modes over (90, 1290) given
    gbar and the median, ``weighted_agg`` (its rows' kernel) over (90,
    545098) in 3 segments, and the client wire's ``stochastic_quantize``
    round trip over (90, 545098); a third of the rows delivering, the
    others zero with w = 0, as on the path."""
    cloud = torch.arange(k, device=dev).repeat_interleave(n // k)
    w = (torch.rand(n, generator=gen, device=dev) < 1 / 3).float()
    g = torch.randn(n, L, generator=gen, device=dev) * w[:, None]
    refs = torch.randn(k, L, generator=gen, device=dev)
    ones = torch.ones(n, device=dev)
    gbar = (w @ g) / w.sum()
    norms = torch.linalg.vector_norm(g, dim=1)
    med = torch.nanquantile(torch.where(w > 0, norms,
                                        torch.full_like(norms, float("nan"))),
                            0.5)

    def entry(fn, plain, tol, nbytes, flops, library=None, shape=""):
        got, want = fn(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            check(close(torch, a, b, tol) if tol else torch.equal(a, b),
                  f"{shape}: max err {max_err(torch, a, b)} > {tol}")
        b_ms, b_by = bound(nbytes, flops)
        return dict(max_abs_err=max(max_err(torch, a, b)
                                    for a, b in zip(got, want)),
                    ms=time_ms(torch, fn), call_ms=call_ms(torch, fn),
                    plain_ms=time_ms(torch, plain), bound_ms=b_ms,
                    bound_by=b_by, library_ms=(time_ms(torch, library)
                                               if library else None),
                    shape=shape)

    rec["trust_score"]["shard"] = entry(
        lambda: ops.trust_score(g, gbar, refs, ones, ref_idx=cloud),
        lambda: ops.trust_score_plain(g, gbar, refs, ones, ref_idx=cloud),
        1e-5, 4 * (n * L + L + k * L + n + 3 * n) + 8 * n, 10 * n * L,
        shape=f"G ({n}, {L}) f32, refs ({k}, {L}), rep 1")
    rec["trust_features"]["shard"] = entry(
        lambda: ops.trust_features(g, refs, gbar, med, w, ref_idx=cloud),
        lambda: ops.trust_features_plain(g, refs, gbar, med, w,
                                         ref_idx=cloud),
        1e-5, 4 * (n * L + k * L + L + 1 + n + 4 * n) + 8 * n, 8 * n * L,
        shape=f"G ({n}, {L}) f32, refs ({k}, {L})")
    big = torch.randn(n, D, generator=gen, device=dev) * w[:, None]
    wt = torch.rand(n, generator=gen, device=dev) * w
    seg = cloud.to(torch.int32)
    w_mat = torch.zeros(k, n, device=dev)
    w_mat[cloud, torch.arange(n, device=dev)] = wt
    rec["weighted_agg"]["shard"] = entry(
        lambda: ops.weighted_agg_rows(big, wt, seg, k),
        lambda: ops.weighted_agg_rows_plain(big, wt, seg, k), 1e-5,
        4 * (n * D + 2 * n + k * D), 2 * n * D,
        library=lambda: torch.mm(w_mat, big),
        shape=f"G ({n}, {D}) f32 -> ({k}, {D}), weights formed outside")
    u = torch.rand(n, D, generator=gen, device=dev)
    scale = torch.amax(big.abs(), dim=1)
    rec["stochastic_quantize"]["shard"] = entry(
        lambda: ops.quantize_roundtrip(big, scale, u, levels=15),
        lambda: ops.quantize_roundtrip_plain(big, scale, u, 15), None,
        4 * (4 * n * D + n), 11 * n * D,
        shape=f"y ({n}, {D}) f32, levels 15, fused round trip (the "
              "client wire over every row)")


def stage_inputs(torch, gen, dev, m=30, k=3, n=90, d=545_098,
                 length=1290):
    """The round's trust-stage inputs at the main paths' shapes: the wire
    (m, d) with the last layer at columns [d - length, d), the own-cloud
    references (k, d), clouds, the reputation EMA of n clients and the
    selected ids, the separability EMA. The rows' norms and alignments
    with their references are spread evenly, as honest and attacked
    updates differ: the separability divides by each feature's spread,
    so rows with nearly equal features would make it ill-conditioned
    (tests/test_torch_trust_stage.py)."""
    import math
    lo = d - length
    flat = torch.randn(m, d, generator=gen, device=dev)
    refs = torch.randn(k, d, generator=gen, device=dev)
    cloud = torch.arange(k, device=dev).repeat_interleave(m // k)
    scale = torch.logspace(math.log10(0.3), math.log10(3.0), m, device=dev)
    align = torch.linspace(-0.5, 1.5, m, device=dev)
    scale = scale[torch.randperm(m, generator=gen, device=dev)]
    align = align[torch.randperm(m, generator=gen, device=dev)]
    flat[:, lo:] = scale[:, None] * (
        align[:, None] * refs[cloud, lo:]
        + torch.randn(m, length, generator=gen, device=dev))
    rep_ema = 0.01 + 0.19 * torch.rand(n, generator=gen, device=dev)
    sel_idx = torch.sort(torch.randperm(n, generator=gen, device=dev)[:m])[0]
    feat_sep = torch.rand(4, generator=gen, device=dev)
    return dict(flat=flat, refs=refs, lo=lo, length=length, ref_idx=cloud,
                rep_ema=rep_ema, sel_idx=sel_idx, n=n, feat_sep=feat_sep)


def check_stage(torch, got, want, what: str) -> float:
    """Kernel against plain: floats within 1e-5, gbar and f2 exact, the
    median within 1e-6 relative (or both NaN). Returns the max error."""
    import math
    worst = 0.0
    for name in ("phi", "ts", "rep_sel", "norms", "feats", "new_sep",
                 "feat_w"):
        a, b = getattr(got, name), getattr(want, name)
        check((a is None) == (b is None), f"trust_stage {what}: {name}")
        if a is None:
            continue
        worst = max(worst, max_err(torch, a, b))
        check(close(torch, a, b, 1e-5), f"trust_stage {what} {name}: max "
              f"err {max_err(torch, a, b)} > 1e-5")
    check(torch.equal(got.gbar, want.gbar), f"trust_stage {what}: gbar not "
          f"exact (max err {max_err(torch, got.gbar, want.gbar)})")
    if got.feats is not None:
        check(torch.equal(got.feats[:, 2], want.feats[:, 2]),
              f"trust_stage {what}: f2 not exact")
    a, b = float(got.med), float(want.med)
    check((math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-6 * abs(b),
          f"trust_stage {what}: med {a} against {b}")
    return worst


def stage_record(torch, ops, dev, gen):
    """The fused trust stage at the main paths' shapes against its plain
    version (scalar and multi; every row delivering, one not, none, an
    odd count), then its device time (``ms``, CUDA graph), its eager time
    (``call_ms``: what a round pays), the plain version's, the bound and
    the largest error (suffix ``_multi`` for the multi stage), and the
    launch floor."""
    from repro_torch.kernels.trust_stage import launch_floor

    x = stage_inputs(torch, gen, dev)
    m, k, n = x["flat"].shape[0], x["refs"].shape[0], x["n"]
    length, gamma = x["length"], 0.9
    ones = torch.ones(m, device=dev)
    cases = {"ones": ones, "one_zero": ones.clone(),
             "none": torch.zeros(m, device=dev), "odd": ones.clone()}
    cases["one_zero"][1] = 0.0
    cases["odd"][:7] = 0.0                     # 23 rows deliver

    def args(w, multi):
        return (x["flat"], x["refs"], x["lo"], length, x["ref_idx"], w,
                x["rep_ema"], x["sel_idx"], gamma, n), dict(
                    feat_sep=x["feat_sep"] if multi else None)

    err = {False: 0.0, True: 0.0}
    for (name, w), multi in itertools.product(cases.items(), (False, True)):
        a, kw = args(w, multi)
        got = ops.trust_stage(*a, **kw)
        want = ops.trust_stage_plain(*a, **kw)
        err[multi] = max(err[multi], check_stage(
            torch, got, want, f"w {name}, multi={multi}"))
    torch.cuda.synchronize()

    def timed(fn):
        return time_ms(torch, fn), call_ms(torch, fn)

    out = {}
    for multi in (False, True):
        a, kw = args(ones, multi)
        tag = "_multi" if multi else ""
        out["ms" + tag], out["call_ms" + tag] = timed(
            lambda: ops.trust_stage(*a, **kw))
        out["plain_ms" + tag], out["plain_call_ms" + tag] = timed(
            lambda: ops.trust_stage_plain(*a, **kw))
        # read: the wire's and the references' last layer, clouds and ids
        # (int64), w, the m reputations gathered and (multi) feat_sep;
        # written: phi, ts, rep_sel, norms, med, gbar and (multi) the
        # features, new_sep and feat_w
        nf = 4 if multi else 0
        nbytes = (4 * (m * length + k * length + 2 * m + nf) + 8 * 2 * m
                  + 4 * (4 * m + 1 + length + nf * m + 2 * nf))
        out["bound_ms" + tag], out["bound_by" + tag] = bound(
            nbytes, 12 * m * length)
        out["max_abs_err" + tag] = err[multi]
    out["floor_ms"], out["floor_call_ms"] = timed(
        lambda: launch_floor(dev, cluster=False))
    out["cluster_floor_ms"], out["cluster_floor_call_ms"] = timed(
        lambda: launch_floor(dev, cluster=True))
    return dict(library_ms=None, **out,
                shape=f"wire ({m}, 545098) f32 at columns [543808, 545098), "
                      f"refs ({k}, 545098), {n} clients")


SCAN_SETS = 4     # rotated input sets for cold timing: 168 MB in bf16


def scan_inputs(torch, gen, dev):
    """{dtype: [(a, b)] * SCAN_SETS}: the serving prefill's (1, 4096,
    2560) scan inputs, drawn in fp32 and rounded to bf16."""
    sets = {torch.float32: [], torch.bfloat16: []}
    for _ in range(SCAN_SETS):
        a = 0.1 + 0.89 * torch.rand(1, 4096, 2560, generator=gen, device=dev)
        x = torch.randn(1, 4096, 2560, generator=gen, device=dev)
        sets[torch.float32].append((a, x))
        sets[torch.bfloat16].append((a.to(torch.bfloat16),
                                     x.to(torch.bfloat16)))
    return sets


def end_group() -> None:
    """End the default process group a shard phase started, so that later
    phases run as before."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def state_to(state, dev):
    """A RoundState with every tensor moved to ``dev``."""
    return state._replace(
        params={k: v.to(dev) for k, v in state.params.items()},
        **{f: getattr(state, f).to(dev) for f in state._fields
           if f not in ("params", "seed")})


def rel_err(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def flat_params(torch, params):
    return torch.cat([params[k].reshape(-1).cpu() for k in sorted(params)])


def agreement_phase(torch, dev, path: str):
    """Two small rounds of ``path`` on the card (kernels) against the CPU
    (plain versions) from one state and one set of draws (the CPU's,
    wire noise included)."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import engine as engine_mod
    from repro_torch.federated.simulation import make_data, make_topology

    from repro_torch.scenarios import get_scenario

    knobs, scenario, engine, _ = PATHS[path]
    if engine not in ("jit", "shard"):
        return host_agreement_phase(torch, dev, path)
    scenario = get_scenario(scenario) if scenario else None
    fl = FLConfig(**SMALL, **knobs)
    if scenario is not None:
        fl = scenario.apply(fl)
    topo = make_topology(fl)
    data = make_data(fl, n_samples=600, samples_per_client=16)
    cpu = torch.device("cpu")
    full = {d: engine_mod.make_client_data(fl, topo, data, 0, device=d)
            for d in (cpu, dev)}
    if engine == "shard":
        # one rank holding the card's (NCCL) and the CPU's (gloo) groups
        from repro_torch.federated import sharded
        sharded.ensure_group(dev)
        engs = {d: sharded.engine_for(fl, topo, data, fl.aggregator,
                                      scenario, device=d) for d in full}
        cds = {d: eng.stage_data(full[d]) for d, eng in engs.items()}
        draw_eng = engs[cpu].eng
    else:
        static = engine_mod.static_from(fl, topo, fl.aggregator, scenario)
        engs = {d: engine_mod.Engine(static, d) for d in full}
        cds = full
        draw_eng = engs[cpu]
    s_cpu = engs[cpu].init_state(0)
    states = {cpu: s_cpu, dev: state_to(s_cpu, dev)}

    worst = {"rep": 0.0, "params": 0.0, "feat_sep": 0.0}
    for t in range(2):
        draws = draw_eng.draws(0, t, full[cpu], full_noise=True)
        outs = {}
        for d, eng in engs.items():
            states[d], outs[d] = eng.step(states[d], cds[d], t, draws)
        mask_c = outs[cpu].delivered.numpy()
        mask_g = outs[dev].delivered.cpu().numpy()
        check(np.array_equal(mask_c, mask_g),
              f"{path} round {t}: masks differ")
        check(np.array_equal(
            engs[cpu].host_round_accounting(mask_c[None], t0=t),
            engs[dev].host_round_accounting(mask_g[None], t0=t)),
            f"{path} round {t}: bytes/$ differ")
        worst["rep"] = max(worst["rep"], rel_err(torch, states[dev].rep_ema,
                                                 states[cpu].rep_ema))
        worst["feat_sep"] = max(worst["feat_sep"], rel_err(
            torch, states[dev].feat_sep, states[cpu].feat_sep))
        worst["params"] = max(worst["params"], rel_err(
            torch, flat_params(torch, states[dev].params),
            flat_params(torch, states[cpu].params)))
    end_group()
    check(max(worst.values()) <= 1e-4,
          f"{path}: card vs CPU drift {worst} > 1e-4")
    return worst


def shard_engine_phase(torch, dev, path: str, fl_over=None, group=None):
    """The sharded engine (``path``'s, over ``group``: default the default
    group, a one-rank NCCL group started and ended here when none is
    initialized) against the round engine's ``Engine.step`` on the card
    at full width, ``ROUNDS`` rounds, each from the round engine's state
    of the round before and on one set of own-mode draws (the wire noise
    materialized), with cuDNN on its deterministic algorithms as
    ``resolve_device`` sets them: masks and float64 bytes and $ exact;
    reputation, params and separability within 1e-4 relative.
    ``fl_over`` replaces ``FLConfig`` fields of the path's knobs.
    Returns the worst drifts (the residuals' too, unchecked) and this
    rank's kernel launches in the shard's steps."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import engine as engine_mod
    from repro_torch.federated import sharded
    from repro_torch.federated.simulation import make_data, make_topology
    from repro_torch.kernels import ops

    knobs, _, engine, _ = PATHS[path]
    check(engine == "shard", f"{path} is not a shard path")
    fl = FLConfig(**dict(knobs, **(fl_over or {})))
    topo = make_topology(fl)
    data = make_data(fl)
    started = sharded.ensure_group(dev)
    eng = engine_mod.Engine(engine_mod.static_from(
        fl, topo, fl.aggregator, input_shape=tuple(data.client_x.shape[2:]),
        n_classes=data.n_classes), dev)
    shard = sharded.engine_for(fl, topo, data, fl.aggregator, device=dev,
                               group=group)
    full = engine_mod.make_client_data(fl, topo, data, 0, device=dev)
    cd = shard.stage_data(full)
    worst = {k: 0.0 for k in ("rep", "params", "feat_sep", "res_client",
                              "res_edge")}
    launches = {name: 0 for name in ops.launch_counts()}
    state = eng.init_state(0)
    for t in range(ROUNDS):
        draws = eng.draws(0, t, full, full_noise=True)
        # the shard first: Engine.step updates res_client in place
        ops.reset_launch_counts()
        # a rank's state holds the client wire's residuals of its rows
        mine = state._replace(res_client=state.res_client[shard.rows].clone()
                              if state.res_client.numel() else
                              state.res_client)
        b, ob = shard.step(mine, cd, t, draws)
        launches = _add_counts(launches, ops.launch_counts())
        state, oa = eng.step(state, full, t, draws)
        da, db = oa.delivered.cpu().numpy(), ob.delivered.cpu().numpy()
        check(np.array_equal(da, db), f"{path} round {t}: masks differ "
              "from the round engine's")
        check(np.array_equal(eng.host_round_accounting(da[None], t0=t),
                             shard.host_round_accounting(db[None], t0=t)),
              f"{path} round {t}: bytes/$ differ from the round "
              "engine's")
        for name, x, y in (
                ("rep", b.rep_ema, state.rep_ema),
                ("params", flat_params(torch, b.params),
                 flat_params(torch, state.params)),
                ("feat_sep", b.feat_sep, state.feat_sep),
                ("res_client", b.res_client, state.res_client[shard.rows]
                 if state.res_client.numel() else state.res_client),
                ("res_edge", b.res_edge, state.res_edge)):
            if y.numel():
                worst[name] = max(worst[name], rel_err(torch, x, y))
    if started:
        end_group()
    checked = {k: worst[k] for k in ("rep", "params", "feat_sep")}
    check(max(checked.values()) <= 1e-4, f"{path}: shard vs round engine "
          f"drift {checked} > 1e-4")
    return dict(worst, launches=launches)


def host_agreement_phase(torch, dev, path: str):
    """:func:`agreement_phase` of a host-loop path: two ``FLServer``s of
    the path's ``engine=`` (both must resolve to the host loop), the
    card's given the CPU's initial params, each round run on the CPU
    server's draws; the selection and delivery masks come from the
    round's numpy generator on both. Within 1e-5 (1e-4 under QSGD)."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import FLServer, make_data, make_topology

    knobs, scenario, engine, _ = PATHS[path]
    fl = FLConfig(**SMALL, **knobs)
    data = make_data(fl, n_samples=600, samples_per_client=16)
    host, card = (FLServer(fl, make_topology(fl), data, method=fl.aggregator,
                           seed=0, scenario=scenario, device=d,
                           engine=engine)
                  for d in (torch.device("cpu"), dev))
    check(host.engine_resolved == card.engine_resolved == "host",
          f"{path}: engine={engine!r} did not route to the host loop")
    card.params = {k: v.to(dev) for k, v in host.params.items()}
    worst = {"rep": 0.0, "params": 0.0, "feat_sep": 0.0}
    for t in range(2):
        draws = host.draws(t, full_noise=True)
        mh, mc = host.run_round(t, draws), card.run_round(t, draws)
        check(np.array_equal(mh.selected, mc.selected),
              f"{path} round {t}: masks differ")
        check((mh.cost, mh.extra["intra_bytes"], mh.extra["cross_bytes"])
              == (mc.cost, mc.extra["intra_bytes"], mc.extra["cross_bytes"]),
              f"{path} round {t}: bytes/$ differ")
        worst["rep"] = max(worst["rep"], rel_err(torch, card.rep.ema,
                                                 host.rep.ema))
        if host._feat_sep is not None:
            worst["feat_sep"] = max(worst["feat_sep"], rel_err(
                torch, card._feat_sep, host._feat_sep))
        worst["params"] = max(worst["params"], rel_err(
            torch, flat_params(torch, card.params),
            flat_params(torch, host.params)))
    # QSGD: an entry whose |v| + u lies within rounding of a level takes
    # the other level on one device (ROADMAP.md C.4), a jump of scale/L,
    # so a QSGD path is held at 1e-4, as the engine's paths are
    tol = 1e-4 if knobs.get("compressor") == "qsgd" else 1e-5
    check(max(worst.values()) <= tol,
          f"{path}: card vs CPU drift {worst} > {tol}")
    return worst


def server_tensors(server):
    """{name: tensor} of what a round mutates, under either engine."""
    state = server.round_state
    if state is not None:
        return {name: getattr(state, name) for name in
                ("rep_ema", "res_client", "res_edge", "feat_sep")}
    out = {"rep_ema": server.rep.ema}
    for name in ("_res_client", "_res_edge", "_feat_sep"):
        if getattr(server, name) is not None:
            out[name] = getattr(server, name)
    return out


def _serve_test_model():
    """recurrentgemma-2b's layout at the test suite's width: 2 stacked
    R, R, L cycles and a tail of two R layers, d_model 128, window 64."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models.model import Model
    return Model(replace(reduced(get_arch("recurrentgemma-2b"), d_model=128,
                                 layers=3), num_layers=8))


def _dense_test_model():
    """gemma2-2b's layout at the test width: alternating "L", "A" layers
    (8), both softcaps on (50, 30), GeGLU, d_model 128, window 64."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models.model import Model
    return Model(replace(reduced(get_arch("gemma2-2b"), d_model=128,
                                 layers=2), num_layers=8))


def serve_agreement_phase(torch, ops, dev, t: int = 96, max_len: int = 104,
                          steps: int = 4, model=None):
    """The fp32 prefill of two ``t``-token prompts (t > the window, so the
    ring wraps) and ``steps`` greedy decode steps on the card (the
    linear_scan kernel, once per "R" layer) against the CPU (its plain
    version), from the same weights and prompts (an encoder-decoder's
    frames too; a VLM's ``t`` counts its patches, which the prefill
    ignores, and decoding starts at ``t`` as in the launcher); ``model``
    defaults to recurrentgemma-2b's test configuration."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    model = model or _serve_test_model()
    cfg = model.cfg
    cpu = torch.device("cpu")
    p_cpu = model.init(0, device=cpu)
    batch = model.dummy_batch(0, 2, t)

    def run(d, params):
        before = ops.linear_scan.launches
        logits, cache = model.prefill(
            params, {k: v.to(d) for k, v in batch.items()}, max_len)
        scans = ops.linear_scan.launches - before
        # copies: decode updates attention caches in place
        out = dict(prefill=logits.cpu(),
                   cache=[x.detach().cpu().clone()
                          for x in tree_leaves(cache)],
                   scans=scans, logits=[], tokens=[])
        tok = torch.argmax(logits, dim=-1)
        for i in range(steps):
            logits, cache = tfm.decode_step(params, cfg, cache, tok, t + i)
            tok = torch.argmax(logits, dim=-1)
            out["logits"].append(logits.cpu())
            out["tokens"].append(tok.cpu())
        return out

    host = run(cpu, p_cpu)
    card = run(dev, tree_map(lambda x: x.to(dev, copy=True), p_cpu))
    n_r = cfg.layer_types().count("R")
    check(card["scans"] == n_r and host["scans"] == 0,
          f"serve agreement: {card['scans']} scan launches on the card "
          f"(expected {n_r}), {host['scans']} on the CPU")
    worst = {"prefill_logits": rel_err(torch, card["prefill"],
                                       host["prefill"]),
             "cache": 0.0, "decode_logits": 0.0}
    check(len(card["cache"]) == len(host["cache"]),
          "serve agreement: the caches differ in structure")
    for i, (got, want) in enumerate(zip(card["cache"], host["cache"])):
        if want.is_floating_point():
            worst["cache"] = max(worst["cache"],
                                 rel_err(torch, got, want))
        else:
            check(torch.equal(got, want),
                  f"serve agreement: cache leaf {i} differs")
    for a, b, ta, tb in zip(card["logits"], host["logits"], card["tokens"],
                            host["tokens"]):
        check(torch.equal(ta, tb), f"serve agreement: greedy tokens "
              f"{ta.tolist()} on the card, {tb.tolist()} on the CPU")
        worst["decode_logits"] = max(worst["decode_logits"],
                                      rel_err(torch, a, b))
    check(max(worst.values()) <= 1e-4,
          f"serve: card vs CPU drift {worst} > 1e-4")
    worst["tokens"] = np.stack([x.numpy() for x in card["tokens"]],
                               1).tolist()
    return worst


def train_agreement_phase(torch, ops, dev, seq: int = 96, chunk: int = 40):
    """One training step at recurrentgemma-2b's test configuration (R, R,
    L; 8 layers, d_model 128, fp32) on the card (the linear_scan kernel
    forward and backward) against the CPU (the plain scan), from the same
    weights and batch: ``Model.grad_fn``'s loss and every gradient leaf
    within 1e-4 relative, then ``make_plain_step`` with AdamW, its loss
    the same. The scan launches: once forward and once backward per "R"
    layer and pass, none on the CPU."""
    from repro_torch.optim import adamw
    from repro_torch.train import make_plain_step
    from repro_torch.tree import tree_leaves, tree_map

    model = _serve_test_model()
    n_r = model.cfg.layer_types().count("R")
    cpu = torch.device("cpu")
    p_cpu = model.init(0, device=cpu)
    # a copy: the train step updates its params in place
    p_dev = tree_map(lambda x: x.to(dev, copy=True), p_cpu)
    batch = model.dummy_batch(0, 2, seq)

    def run(d, params):
        b = {k: v.to(d) for k, v in batch.items()}
        before = (ops.linear_scan.launches, ops.linear_scan_bwd.launches)
        (loss, _), grads = model.grad_fn(chunk)(params, b)
        step = make_plain_step(model, None, adamw(1e-3), loss_chunk=chunk)
        opt_state = adamw(1e-3)[0](params)
        params, opt_state, met = step(params, opt_state, b)
        scans = (ops.linear_scan.launches - before[0],
                 ops.linear_scan_bwd.launches - before[1])
        return dict(loss=loss.cpu(), grads=[g.cpu() for g in
                                            tree_leaves(grads)],
                    step_loss=met["loss"].cpu(), scans=scans,
                    params=[p.cpu() for p in tree_leaves(params)])

    host = run(cpu, p_cpu)
    card = run(dev, p_dev)
    check(card["scans"] == (2 * n_r, 2 * n_r) and host["scans"] == (0, 0),
          f"train agreement: scan launches {card['scans']} on the card "
          f"(expected {(2 * n_r, 2 * n_r)}), {host['scans']} on the CPU")
    worst = {"loss": rel_err(torch, card["loss"], host["loss"]),
             "grads": max(rel_err(torch, a, b) for a, b in
                          zip(card["grads"], host["grads"])),
             "step_loss": rel_err(torch, card["step_loss"],
                                  host["step_loss"])}
    check(max(worst.values()) <= 1e-4,
          f"train: card vs CPU drift {worst} > 1e-4")
    # not held: AdamW's first step moves every weight by about lr times
    # the sign of its gradient, so a gradient within rounding of 0 may
    # step either way
    worst["params_after_step"] = max(
        rel_err(torch, a, b) for a, b in zip(card["params"],
                                               host["params"]))
    worst["loss_value"] = float(host["loss"])
    return worst


def _family_test_model(family: str):
    """(model, prompt length) of phase 4's test configuration of
    ``family``: mixtral-8x7b's layout (4 "L" layers at window 64, 4
    experts, top-2) with capacity factor 0.5, so the full-sequence
    forward drops tokens; llama4's one period (C, C, C, A; MoE on 1 and
    3; 4 experts, top-1, chunk 64) with a prompt past the chunk; rwkv6's
    3 "W" layers with a 150-token prompt (two 64-token chunks and a
    ragged one). d_model 128, fp32. whisper-small's and paligemma-3b's
    are the CPU tests' (d_model 64): 2 encoder and 2 decoder layers, 16
    frames, ``rope_theta`` 0 so the sinusoids run, and a 24-token
    prompt; 2 layers and 8 patches before a 24-token text."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models.model import Model

    if family == "whisper":
        return Model(replace(reduced(get_arch("whisper-small"), d_model=64),
                             rope_theta=0.0)), 24
    if family == "paligemma":
        return Model(reduced(get_arch("paligemma-3b"), d_model=64)), 32

    if family == "mixtral":
        cfg = replace(reduced(get_arch("mixtral-8x7b"), d_model=128,
                              layers=2), num_layers=4, capacity_factor=0.5)
        return Model(cfg), 96
    if family == "llama4":
        return Model(reduced(get_arch("llama4-maverick-400b-a17b"),
                             d_model=128, layers=4)), 96
    return Model(reduced(get_arch("rwkv6-1.6b"), d_model=128, layers=3)), 150


@contextmanager
def recorded_routes(pairs: bool = True):
    """Every ``models.moe.route`` while open, as (device type, sorted
    kept (expert, token) pairs, or None without ``pairs``, routed pairs
    dropped) in call order."""
    from repro_torch.models import moe

    real, seen = moe.route, []

    def spy(combine, cap):
        rt = real(combine, cap)
        kept = (sorted(zip(rt.expert.tolist(), rt.token.tolist()))
                if pairs else None)
        seen.append((combine.device.type, kept,
                     int((combine > 0).sum()) - len(rt.token)))
        return rt
    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = real


def _same_routes(seen, dev, what: str):
    """The card's routes equal the CPU's, call by call; the tokens
    dropped on the card."""
    host = [r[1:] for r in seen if r[0] == "cpu"]
    card = [r[1:] for r in seen if r[0] == dev.type]
    check(len(host) == len(card) and all(
        a[0] == b[0] for a, b in zip(host, card)),
        f"{what}: the kept (expert, token) pairs differ, card vs CPU")
    return [d for _, d in card]


def family_agreement_phase(torch, ops, dev, family: str, chunk: int = 40):
    """Phase 4 for the MoE and RWKV6 families at their test
    configurations (``_family_test_model``), the card against the CPU
    from the same weights: the prefill of two prompts with its cache and
    4 greedy decode steps (``serve_agreement_phase``), ``forward_hidden``
    with its aux loss, and one ``Model.grad_fn`` (loss, aux metric and
    every gradient leaf), all within 1e-4 relative, with an
    encoder-decoder's frames and ``Model.encode``, and a VLM's patches
    and ``serve.make_prefill_step``; the MoE routes (the kept (expert,
    token) pairs of every ``moe.route``) exactly equal; no kernel
    launched."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.decode import make_prefill_step
    from repro_torch.tree import tree_leaves, tree_map

    model, t = _family_test_model(family)
    cfg = model.cfg
    before = ops.launch_counts()
    with recorded_routes() as seen:
        worst = serve_agreement_phase(torch, ops, dev, t=t, max_len=t + 8,
                                      model=model)
        serve_drops = _same_routes(seen, dev, f"{family} serve")
        seen.clear()
        cpu = torch.device("cpu")
        p_cpu = model.init(0, device=cpu)
        batch = model.dummy_batch(0, 2, t)

        def run(d, params):
            b = {k: v.to(d) for k, v in batch.items()}
            h, aux, off = tfm.forward_hidden(params, cfg, b)
            (loss, met), grads = model.grad_fn(chunk)(params, b)
            out = dict(h=h.cpu(), aux=aux.cpu(), loss=loss.cpu(),
                       aux_metric=met["aux_loss"].cpu(),
                       grads=[g.cpu() for g in tree_leaves(grads)])
            check(off == cfg.vis_tokens, f"{family}: offset {off}")
            if cfg.is_encdec:
                out["encode"] = model.encode(params, b["frames"]).cpu()
            if cfg.vis_tokens:
                out["prefill_step"] = make_prefill_step(model)(params,
                                                               b).cpu()
            return out

        host = run(cpu, p_cpu)
        card = run(dev, tree_map(lambda x: x.to(dev, copy=True), p_cpu))
        forward_drops = _same_routes(seen, dev, f"{family} forward")
    check(ops.launch_counts() == before,
          f"{family} agreement: a kernel was launched")
    for key in ("h", "aux", "loss", "aux_metric", "encode",
                "prefill_step"):
        if key in host:
            worst[key] = rel_err(torch, card[key], host[key])
    worst["grads"] = max(rel_err(torch, a, b)
                         for a, b in zip(card["grads"], host["grads"]))
    check(max(v for v in worst.values() if isinstance(v, float)) <= 1e-4,
          f"{family}: card vs CPU drift {worst} > 1e-4")
    worst["aux_value"] = float(host["aux"])
    worst["routes"] = len(serve_drops) + len(forward_drops)
    worst["dropped_prefill_decode"] = sum(serve_drops)
    worst["dropped_forward_and_grad"] = sum(forward_drops)
    if family == "mixtral":
        check(sum(forward_drops) > 0, "mixtral: the forward dropped nothing")
    return worst


@contextmanager
def cut_depth(layers):
    """The serve launcher's ``build_model`` patched to cut the model to
    ``layers`` layers at its published widths (nothing when None)."""
    from dataclasses import replace

    import repro_torch.launch.serve as serve_mod
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model

    real = serve_mod.build_model
    if layers is not None:
        serve_mod.build_model = lambda arch, smoke=False: Model(
            replace(get_arch(arch), num_layers=layers))
    try:
        yield
    finally:
        serve_mod.build_model = real


def check_memory_free(torch, what: str, gib: float = 2.0) -> float:
    """GiB the caching allocator still holds for tensors; raises when
    more than ``gib`` (the weights of the path before must be gone)."""
    held = torch.cuda.memory_allocated() / 2 ** 30
    check(held <= gib, f"{what}: {held:.3f} GiB still allocated")
    return held


def serve_path_phase(torch, ops, dev, path: str = "serve"):
    """``launch.serve.serve`` at full width (``SERVE_PATHS[path]``, the
    launcher's model cut to the path's depth where it gives one), the
    launch counters reset just before and read just after: linear_scan
    once per "R" layer per prefill, every other kernel never (a dense,
    MoE or RWKV6 arch launches none); the weights held as stated; peak
    memory, prefill ms and decode tokens/s. The weights are released
    after it (``empty_cache``), and the memory held before it checked."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import serve

    sv, held, layers = SERVE_PATHS[path]
    cfg = get_arch(sv["arch"])
    torch.cuda.synchronize()
    before_gib = check_memory_free(torch, path)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with cut_depth(layers):
        res = serve(sv["arch"], batch=sv["batch"], requests=sv["requests"],
                    prompt_len=sv["prompt_len"], gen=sv["gen"], device=dev,
                    dtype=sv["dtype"], seed=sv["seed"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    n_r = cfg.layer_types()[:layers or cfg.num_layers].count("R")
    want = {n: 0 for n in counts}
    want["linear_scan"] = sv["requests"] * n_r
    check(counts == want, f"{path}: launches {counts}, expected {want}")
    check(res.n_params == held,
          f"{path}: {res.n_params} weights, expected {held}")
    check(sorted(r.rid for r in res.requests)
          == list(range(sv["requests"])), f"{path}: requests lost")
    for r in res.requests:
        check(r.done and len(r.generated) == sv["gen"]
              and all(0 <= tok < cfg.vocab_size for tok in r.generated),
              f"{path}: request {r.rid} generated {r.generated}")
    check(res.finite, f"{path}: a prefill or decode logit is not finite")
    prefill_ms = [r.prefill_s * 1e3
                  for r in sorted(res.requests, key=lambda r: r.rid)]
    return counts, dict(
        arch=sv["arch"], layers=layers or cfg.num_layers,
        n_params=res.n_params, analytic_param_count=cfg.param_count(),
        allocated_before_gib=before_gib, peak_gib=peak_gib,
        init_s=res.init_s, wall_s=wall_s, prefill_ms=prefill_ms,
        prefill_ms_first=prefill_ms[0],
        prefill_ms_steady=statistics.median(prefill_ms[1:]),
        decode_steps=res.decode_steps, decode_s=res.decode_s,
        decode_tokens_per_s=res.decode_tokens_per_s,
        tokens={r.rid: r.generated for r in res.requests})


def prefix_prefill_phase(torch, ops, dev):
    """``PREFIX_PREFILL``: ``serve.decode.make_prefill_step`` (the full
    forward through ``forward_hidden``, the patches a bidirectional
    prefix) at paligemma-3b's full published widths and depth in bf16 on
    ``batch`` rows of 256 patches and ``seq`` - 256 text tokens from
    ``dummy_batch``; one warm-up call, then ``calls`` timed ones (host
    clock to ``synchronize``), the launch counters reset just before and
    read just after: every kernel never. The logits (batch, vocab)
    finite, the weights held as stated, peak memory; the weights are
    released after."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import make_prefill_step

    pp = PREFIX_PREFILL
    model = Model(get_arch(pp["arch"]))
    cfg = model.cfg
    torch.cuda.synchronize()
    before_gib = check_memory_free(torch, "prefix_prefill")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    params = model.init(pp["seed"], device=dev, dtype=pp["dtype"])
    batch = model.dummy_batch(0, pp["batch"], pp["seq"], device=dev)
    step = make_prefill_step(model)
    ms, finite = [], True
    for _ in range(1 + pp["calls"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(torch.isfinite(logits).all())
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = tfm.param_count(params)
    shape = tuple(logits.shape)
    del params, batch, logits
    torch.cuda.empty_cache()
    check(all(c == 0 for c in counts.values()),
          f"prefix_prefill: launches {counts}, expected none")
    check(n_params == pp["held"],
          f"prefix_prefill: {n_params} weights, expected {pp['held']}")
    check(shape == (pp["batch"], cfg.vocab_size),
          f"prefix_prefill: logits of shape {shape}")
    check(finite, "prefix_prefill: a logit is not finite")
    steady = statistics.median(ms[1:])
    return counts, dict(
        arch=pp["arch"], rows=pp["batch"], patches=cfg.vis_tokens,
        text_tokens=pp["seq"] - cfg.vis_tokens, n_params=n_params,
        allocated_before_gib=before_gib, peak_gib=peak_gib, ms=ms,
        first_ms=ms[0], steady_ms=steady,
        tokens_per_s=pp["batch"] * pp["seq"] / steady * 1e3)


def train_path_phase(torch, ops, dev):
    """``TRAIN``: recurrentgemma-2b at full width (26 layers, fp32
    weights, ``remat``) through ``train.make_plain_step`` with AdamW on a
    cosine schedule after ``clip_by_global_norm``, fed 2 x 2048-token
    windows of ``data.token_batches(make_token_stream(...))``; one
    warm-up step, then ``TRAIN["steps"]`` timed ones. The launch counters
    are reset just before each step and read just after: linear_scan
    twice per "R" layer (the forward and the rematerialized forward in
    the backward), linear_scan_bwd once, every other kernel never. The
    loss finite and lower at the last step than at the first."""
    import math

    import numpy as np
    from repro_torch.data import make_token_stream, token_batches
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule
    from repro_torch.train import make_plain_step

    tr = TRAIN
    model = build_model(tr["arch"])
    cfg = model.cfg
    check(cfg.remat and cfg.num_layers == 26,
          f"train: {cfg.num_layers} layers, remat {cfg.remat}")
    n_r = cfg.layer_types().count("R")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(tr["seed"], device=dev, dtype=torch.float32)
    init, update = adamw(cosine_schedule(tr["lr"], warmup=tr["warmup"],
                                         total=tr["warmup"] + tr["steps"]))

    def clipped_update(grads, state, p):
        return update(clip_by_global_norm(grads, tr["clip"])[0], state, p)
    opt_state = init(params)
    step = make_plain_step(model, None, (init, clipped_update),
                           loss_chunk=tr["loss_chunk"])
    stream = make_token_stream(tr["stream_tokens"], cfg.vocab_size,
                               seed=tr["seed"])
    batches = token_batches(stream, batch=tr["batch"], seq=tr["seq"],
                            seed=tr["seed"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = {n: 0 for n in ops.launch_counts()}
    per_step.update(linear_scan=2 * n_r, linear_scan_bwd=n_r)
    counts = {n: 0 for n in per_step}
    losses, step_s = [], []
    for i in range(tr["warmup"] + tr["steps"]):
        toks = next(batches)
        batch = {"tokens": torch.tensor(toks[:, :-1], device=dev).long(),
                 "labels": torch.tensor(toks[:, 1:], device=dev).long(),
                 "mask": torch.ones(tr["batch"], tr["seq"], device=dev)}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        params, opt_state, met = step(params, opt_state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        got = ops.launch_counts()
        check(got == per_step,
              f"train step {i}: launches {got}, expected {per_step}")
        losses.append(float(met["loss"]))
        check(math.isfinite(losses[-1]), f"train step {i}: loss {losses}")
        counts = {n: counts[n] + got[n] for n in counts}
        if i >= tr["warmup"]:
            step_s.append(dt)
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    check(int(opt_state.step) == tr["warmup"] + tr["steps"],
          f"train: optimizer step {int(opt_state.step)}")
    for k, v in (("embed", params["embed"]),
                 ("final_norm", params["final_norm"])):
        check(bool(torch.isfinite(v).all()), f"train: {k} not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = tr["batch"] * tr["seq"]
    del params, opt_state, step
    torch.cuda.empty_cache()
    return counts, dict(
        arch=tr["arch"], setup_s=setup_s, losses=losses, step_s=step_s,
        step_ms=1e3 * statistics.median(step_s),
        tokens_per_s=tokens / statistics.median(step_s), peak_gib=peak,
        launches_per_step=per_step, loss_drop=losses[0] - losses[-1],
        finite=bool(np.isfinite(losses).all()))


def _fl_counts(metrics, n_clients: int, n_clouds: int) -> int:
    """The two-phase step's gradient evaluations, read off its metrics:
    pass A's N clients and K references, then pass B's clients with a
    weight (trust > 0 in a cloud with β̂ > 0) and clouds falling back on
    their reference (trust summing to 0, β̂ > 0)."""
    trust = metrics["trust"].cpu().tolist()
    beta = metrics["beta"].cpu().tolist()
    cpc = n_clients // n_clouds
    ts_cloud = [sum(trust[c * cpc:(c + 1) * cpc]) for c in range(n_clouds)]
    weighted = sum(ts > 0 and beta[i // cpc] > 0
                   for i, ts in enumerate(trust))
    fallback = sum(ts_cloud[c] <= 1e-12 and beta[c] > 0
                   for c in range(n_clouds))
    return n_clients + n_clouds + weighted + fallback


def fl_scan_launches(strategy: str, cfg, metrics, n_clients: int,
                     n_clouds: int):
    """(linear_scan, linear_scan_bwd) launches of one federated step of a
    model with n_r "R" layers: per gradient evaluation n_r backward and
    n_r forward, twice that with every layer rematerialized (the forward
    and its rerun); the fused step's two forwards without gradients (the
    clients' signatures, the references') n_r each, then one evaluation."""
    n_r = cfg.layer_types().count("R")
    fwd = n_r * (2 if cfg.remat else 1)
    if strategy == "fused":
        return 2 * n_r + fwd, n_r
    evals = _fl_counts(metrics, n_clients, n_clouds)
    return fwd * evals, n_r * evals


def grads_bit_stable(torch, model, params, batch, chunk: int):
    """``Model.grad_fn`` twice on one batch — whether pass B of the
    two-phase step recomputes the gradient pass A measured: the leaves
    equal bit for bit, the leaves, the largest |difference|, and each
    call's ms (host clock between synchronizations: one gradient
    evaluation)."""
    from repro_torch.tree import tree_leaves

    grad = model.grad_fn(chunk)
    grads, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads.append(tree_leaves(grad(params, batch)[1]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    first, second = grads
    return dict(
        equal_leaves=sum(bool(torch.equal(a, b))
                         for a, b in zip(first, second)),
        leaves=len(first), grad_ms=ms,
        max_abs_diff=max(float((a - b).abs().max())
                         for a, b in zip(first, second)))


def fl_train_agreement_phase(torch, ops, dev, seq: int = 96,
                             chunk: int = 40):
    """One two-phase and one fused federated step (4 clients in 2 clouds,
    3 selected, SGD) at recurrentgemma-2b's test configuration and at the
    dense test configuration (``seq`` tokens a row), then the steps of
    ``FL_TRAIN_FAMILIES`` at their family test configurations (mixtral's
    MoE dropping tokens in the fused step, rwkv6, whisper with frames,
    paligemma with patches in both strategies), on one rank holding the
    card's NCCL and the CPU's gloo groups: the card against the CPU from
    the same weights, batches and Ω — the selected mask exact, the cost
    units within 1e-6 relative, the loss, φ, trust, β and reputation
    within 1e-5, the params within 1e-4, the MoE routes (every capacity
    selection's kept pairs) equal; the card's scan launches as
    :func:`fl_scan_launches` predicts, none on the CPU. Then, for each
    configuration, that two gradients of one batch are bit-identical on
    the card."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import sharded
    from repro_torch.optim import sgd
    from repro_torch.train import ClientMesh, draw_omega, make_fl_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cpu = torch.device("cpu")
    fl = FLConfig(n_clouds=2, clients_per_round=3)
    sharded.ensure_group(dev)
    worst, out = {}, {}
    both = ("two_phase", "fused")
    cases = [("rg", _serve_test_model(), seq, both),
             ("dense", _dense_test_model(), seq, both)]
    cases += [(fam, *_family_test_model(fam), strategies)
              for fam, strategies in FL_TRAIN_FAMILIES.items()]
    for cfg_name, model, t, strategies in cases:
        p_cpu = model.init(0, device=cpu)
        omega = draw_omega(1, model.cfg.vocab_size, fl.sketch_dim, cpu)
        batch = model.dummy_batch(1, 4, t)
        ref = {k: v.reshape((2, 1) + tuple(v.shape[1:]))
               for k, v in model.dummy_batch(2, 2, t).items()}
        for strategy in strategies:
            what = f"fl_train agreement {cfg_name} {strategy}"
            runs = {}
            with recorded_routes() as seen:
                for side, d in (("host", cpu), ("card", dev)):
                    params = tree_map(lambda x: x.to(d, copy=True), p_cpu)
                    opt = sgd(0.05)
                    step, topo = make_fl_train_step(
                        model, ClientMesh(4), fl, opt, strategy=strategy,
                        loss_chunk=chunk)
                    rep = torch.tensor([0.3, 0.2, 0.25, 0.25], device=d)
                    key = (omega,) if strategy == "fused" else ()
                    ops.reset_launch_counts()
                    params, _, rep, met = step(
                        params, opt[0](params), rep,
                        {k: v.to(d) for k, v in batch.items()},
                        {k: v.to(d) for k, v in ref.items()}, *key)
                    counts = ops.launch_counts()
                    runs[side] = dict(
                        met={k: v.cpu() for k, v in met.items()},
                        rep=rep.cpu(),
                        params=[p.cpu() for p in tree_leaves(params)],
                        scans=(counts["linear_scan"],
                               counts["linear_scan_bwd"]),
                        others=sum(v for k, v in counts.items()
                                   if not k.startswith("linear_scan")))
            drops = _same_routes(seen, dev, what)
            host, card = runs["host"], runs["card"]
            want = fl_scan_launches(strategy, model.cfg, card["met"], 4, 2)
            check(card["scans"] == want and host["scans"] == (0, 0)
                  and card["others"] == 0 == host["others"],
                  f"{what}: scan launches {card['scans']} on the card "
                  f"(expected {want}), {host['scans']} on the CPU, FL "
                  f"kernels {card['others']}")
            check(np.array_equal(card["met"]["selected"].numpy(),
                                 host["met"]["selected"].numpy()),
                  f"{what}: selected masks differ")
            drift = {k: rel_err(torch, card["met"][k], host["met"][k])
                     for k in ("loss", "phi", "trust", "beta")}
            drift["rep"] = rel_err(torch, card["rep"], host["rep"])
            cost = rel_err(torch, card["met"]["round_cost_units"],
                           host["met"]["round_cost_units"])
            params = max(rel_err(torch, a, b) for a, b in
                         zip(card["params"], host["params"]))
            check(max(drift.values()) <= 1e-5 and cost <= 1e-6
                  and params <= 1e-4,
                  f"{what}: card vs CPU drift {drift}, cost units {cost}, "
                  f"params {params}")
            if cfg_name == "mixtral":
                check(sum(drops) > 0, f"{what}: the MoE layers dropped "
                      f"nothing")
            worst[f"{cfg_name}_{strategy}"] = dict(
                drift, round_cost_units=cost, params=params,
                scan_launches=card["scans"], routes=len(drops),
                dropped=sum(drops))
        p_dev = tree_map(lambda x: x.to(dev), p_cpu)
        b_dev = {k: v[:1].to(dev) for k, v in batch.items()}
        stable = grads_bit_stable(torch, model, p_dev, b_dev, chunk)
        check(stable["equal_leaves"] == stable["leaves"],
              f"fl_train agreement {cfg_name}: two gradients of one batch "
              f"differ on the card: {stable}")
        out[f"{cfg_name}_grads_bit_stable"] = stable
    end_group()
    worst.update(out)
    return worst


def fl_train_path_phase(torch, ops, dev, path: str, spec=None, mesh=None):
    """``FL_TRAIN_PATHS[path]`` (or ``spec``) through
    ``train.make_fl_train_step`` in its strategy: the arch at its full
    published widths (fp32 weights,
    every layer rematerialized; the depth cut where ``layers`` says), AdamW
    as ``TRAIN`` uses it, 4 clients of 1 x ``seq`` positions in 2 clouds,
    3 selected, one reference row a cloud, all on one NCCL rank the step
    starts and ends; text tokens from the token stream, a VLM's patches
    and an encoder-decoder's frames 0.02·N(0, 1) from a seeded generator
    on the card; one warm-up step, then ``steps`` timed ones. Less than 2
    GiB allocated before the path, the weights released after it. The
    launch counters are reset just before each step and read just after:
    linear_scan and linear_scan_bwd as :func:`fl_scan_launches` predicts
    (none without an "R" layer), every FL kernel never. The loss finite,
    the reputation summing to about 1, ``embed`` and ``final_norm``
    finite, the optimizer at the step count. A two-phase path first
    checks that two gradients of one client's batch are bit-identical at
    full width (pass B recomputes pass A's); an MoE path counts the
    routed (token, expert) pairs its layers drop, over the global
    batch. A path with a ``mesh`` shape runs over that live mesh of the
    default group's ranks (``mesh`` when given, which must have that
    shape; one client a data index; a (1, 1) mesh starts and ends a
    one-rank group when none is initialized), its parameters
    stored by ``param_specs`` and AdamW's moments by ``opt_state_specs``,
    each made in place; ``stored_gib`` is what this rank stores of
    them."""
    import math
    from dataclasses import replace

    import torch.distributed as dist
    from repro_torch.configs.base import FLConfig, get_arch
    from repro_torch.data import make_token_stream, token_batches
    from repro_torch.launch.mesh import live_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule
    from repro_torch.sharding import (MeshShape, full_tree, opt_state_specs,
                                      param_specs, shard_tree)
    from repro_torch.train import ClientMesh, make_fl_train_step
    from repro_torch.tree import tree_leaves

    ft = spec or FL_TRAIN_PATHS[path]
    strategy = ft["strategy"]
    check_memory_free(torch, path)
    cfg = get_arch(ft["arch"])
    if ft["layers"] is not None:
        cfg = replace(cfg, num_layers=ft["layers"])
    check(cfg.remat, f"{path}: remat off")
    model = Model(cfg)
    layers = cfg.num_layers
    n, k, per, seq = ft["clients"], ft["clouds"], ft["per"], ft["seq"]
    text = seq - cfg.vis_tokens
    rows_n = n * per + k * ft["ref_rows"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(ft["seed"], device=dev, dtype=torch.float32)
    stream = make_token_stream(ft["stream_tokens"], cfg.vocab_size,
                               seed=ft["seed"])
    windows = token_batches(stream, batch=rows_n, seq=text, seed=ft["seed"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(ft["seed"])
    stubs = {"patches": cfg.vis_tokens,
             "frames": cfg.enc_frames if cfg.is_encdec else 0}

    def batches():
        toks = torch.tensor(next(windows), device=dev).long()
        rows = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": torch.ones(toks.shape[0], text, device=dev)}
        for key, m in stubs.items():
            if m:
                rows[key] = 0.02 * torch.randn(
                    (rows_n, m, cfg.d_model), generator=gen, device=dev)
        batch = {key: v[:n * per] for key, v in rows.items()}
        ref = {key: v[n * per:].reshape((k, ft["ref_rows"])
                                        + tuple(v.shape[1:]))
               for key, v in rows.items()}
        return batch, ref

    stable = None
    if strategy == "two_phase":
        batch, _ = batches()
        stable = grads_bit_stable(
            torch, model, params, {key: v[:per] for key, v in batch.items()},
            ft["loss_chunk"])
        check(stable["equal_leaves"] == stable["leaves"],
              f"{path}: two gradients of one client's batch differ: "
              f"{stable}")
    init, update = adamw(cosine_schedule(ft["lr"], warmup=ft["warmup"],
                                         total=ft["warmup"] + ft["steps"]))

    def clipped_update(grads, state, p):
        return update(clip_by_global_norm(grads, ft["clip"])[0], state, p)
    started = False
    if ft.get("mesh") is None:
        mesh = ClientMesh(n)
        opt_state = init(params)
    else:
        if mesh is None:
            started = not dist.is_initialized()
            mesh = live_mesh(MeshShape(("data", "model"), ft["mesh"]), dev)
        check(tuple(mesh.shape) == tuple(ft["mesh"]),
              f"{path}: mesh {tuple(mesh.shape)}, expected {ft['mesh']}")
        shapes = model.param_shapes()
        params = shard_tree(params, param_specs(shapes, cfg, mesh), mesh)
        moments = opt_state_specs(init(shapes), shapes, cfg, mesh).mu
        opt_state = init(shard_tree(params, moments, mesh))
    fl = FLConfig(n_clouds=k, clients_per_round=ft["selected"])
    step, topo = make_fl_train_step(model, mesh, fl,
                                    (init, clipped_update),
                                    strategy=strategy,
                                    loss_chunk=ft["loss_chunk"])
    check((topo.n_clients, topo.n_clouds) == (n, k),
          f"{path}: topology {topo}")
    rep = torch.full((n,), 1.0 / n, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts = {name: 0 for name in ops.launch_counts()}
    losses, step_s, per_step, evals, dropped = [], [], [], [], []
    with step:
        for i in range(ft["warmup"] + ft["steps"]):
            batch, ref = batches()
            key = (ft["seed"] + i,) if strategy == "fused" else ()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with recorded_routes(pairs=False) as seen:
                t1 = time.perf_counter()
                params, opt_state, rep, met = step(params, opt_state, rep,
                                                   batch, ref, *key)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
            got = ops.launch_counts()
            scan, bwd = fl_scan_launches(strategy, cfg, met, n, k)
            want = {name: 0 for name in got}
            want.update(linear_scan=scan, linear_scan_bwd=bwd)
            check(got == want, f"{path} step {i}: launches {got}, expected "
                  f"{want}")
            per_step.append(got)
            evals.append(_fl_counts(met, n, k) if strategy == "two_phase"
                         else 1)
            dropped.append(sum(r[2] for r in seen))
            counts = {name: counts[name] + got[name] for name in counts}
            losses.append(float(met["loss"]))
            rep_sum = float(rep.sum())
            check(math.isfinite(losses[-1]) and abs(rep_sum - 1.0) < 0.1,
                  f"{path} step {i}: loss {losses[-1]}, reputation sum "
                  f"{rep_sum}")
            if i >= ft["warmup"]:
                step_s.append(dt)
    check(int(opt_state.step) == ft["warmup"] + ft["steps"],
          f"{path}: optimizer step {int(opt_state.step)}")
    ends = full_tree({key_: params[key_] for key_ in ("embed", "final_norm")})
    for key_, v in ends.items():
        check(bool(torch.isfinite(v).all()), f"{path}: {key_} not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x
    stored = sum(local(x).numel() * local(x).element_size() for x in
                 tree_leaves([params, opt_state.mu, opt_state.nu])) / 2 ** 30
    metrics = {key_: v.cpu().tolist() for key_, v in met.items()}
    del params, opt_state, step, ends
    if started:
        end_group()
    torch.cuda.empty_cache()
    tokens = n * per * seq
    return counts, dict(
        arch=ft["arch"], layers=layers, strategy=strategy, seq=seq,
        setup_s=setup_s, losses=losses, step_s=step_s,
        step_ms=1e3 * statistics.median(step_s),
        tokens_per_s=tokens / statistics.median(step_s), peak_gib=peak,
        stored_gib=stored, mesh=ft.get("mesh"),
        launches_per_step=per_step, grad_evals_per_step=evals,
        moe_dropped_per_step=dropped if cfg.n_experts else None,
        grads_bit_stable=stable, rep=rep.cpu().tolist(), metrics=metrics)


def fl_example_phase(torch, ops, dev):
    """``examples/federated_llm_train_torch.py`` as its users run it on
    the card (``FL_EXAMPLE``: 60 steps of the two-phase step, a 4-layer
    gemma2-layout model of d_model 256, 4 cohorts in 2 clouds, cohort 3
    flipping its tokens), the counters reset just before and read just
    after: every kernel never (a dense model); the loss finite and lower
    at the end; the attacker's reputation below the honest mean (the
    reference's example puts it there at this seed on the CPU)."""
    import importlib.util
    import math

    spec = importlib.util.spec_from_file_location(
        "federated_llm_train_torch",
        ROOT / "examples" / "federated_llm_train_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ex = FL_EXAMPLE
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = example.main(["--steps", str(ex["steps"]), "--seq", str(ex["seq"]),
                        "--d-model", str(ex["d_model"]),
                        "--layers", str(ex["layers"]), "--device", str(dev)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"fl_train_example: launches {counts}, expected none")
    losses = res["losses"]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"fl_train_example: losses {losses[0]} -> {losses[-1]}")
    check(res["detected"], f"fl_train_example: attacker reputation "
          f"{res['attacker']} not below the honest mean {res['honest']}")
    return counts, dict(wall_s=wall_s, s_per_step=wall_s / ex["steps"],
                        attacker=res["attacker"], honest=res["honest"],
                        detected=res["detected"], loss_first=losses[0],
                        loss_last=losses[-1], rep=res["rep"].cpu().tolist())


def _load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def _add_counts(a, b):
    return {n: a.get(n, 0) + b[n] for n in b}


def long_layer_check(torch, dev, cfg, slots: int) -> float:
    """One "A" layer's ``attn_decode`` in fp32 at ``cfg``'s widths over a
    cache of ``slots`` slots (keys 3·N(0, 1), so the softmax is peaked
    enough for a relative error to mean something; values N(0, 1);
    positions 0..slots-2 filled), chunked against the whole cache
    (``_DECODE_CHUNK`` patched above ``slots``) from the same state:
    within 1e-5 relative. Both write the same new key and value."""
    from repro_torch.models import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = attention.init_attn(gen, cfg)
    cache = attention.init_attn_cache(cfg, "A", 1, slots, device=dev)
    cache["k"].normal_(generator=gen).mul_(3.0)
    cache["v"].normal_(generator=gen)
    index = slots - 1
    cache["pos"][:index] = torch.arange(index, device=dev,
                                        dtype=torch.int32)
    x = torch.randn(1, 1, cfg.d_model, generator=gen, device=dev)
    real = attention._DECODE_CHUNK
    attention._DECODE_CHUNK = 2 * slots
    try:
        whole, _ = attention.attn_decode(params, x, cache, index, cfg=cfg,
                                         layer_type="A")
    finally:
        attention._DECODE_CHUNK = real
    chunked, _ = attention.attn_decode(params, x, cache, index, cfg=cfg,
                                       layer_type="A")
    err = rel_err(torch, chunked, whole)
    check(err <= 1e-5, f"long_decode: one fp32 layer over {slots} slots, "
          f"chunked vs whole cache {err:.3e} apart")
    return err


def long_attn_record(torch, dev, cfg, slots: int):
    """Device times (eager, between CUDA events) of one bf16 "A" layer's
    one-token attention at ``cfg``'s widths over ``slots`` slots
    (``_decode_attn`` with the config's softcap): chunked, and through
    the whole-cache softmax (``_DECODE_CHUNK`` patched above ``slots``);
    beside them PyTorch's ``scaled_dot_product_attention`` over the same
    keys, values and mask (no softcap; a yardstick the port never calls)
    and the bound: the layer's keys and values read once at the HBM
    rate."""
    from repro_torch.models import attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kvh
    bf16 = dict(device=dev, dtype=torch.bfloat16)
    k = torch.randn(1, slots, kvh, hd, generator=gen, **bf16)
    v = torch.randn(1, slots, kvh, hd, generator=gen, **bf16)
    q = torch.randn(1, 1, kvh, g, hd, generator=gen, **bf16)
    valid = torch.ones(slots, dtype=torch.bool, device=dev)
    valid[-LONG_DECODE["empty"]:] = False
    cap = cfg.attn_softcap
    rec = dict(chunked_ms=call_ms(
        torch, lambda: attention._decode_attn(q, k, v, valid, cap),
        repeats=11, inner=3))
    real = attention._DECODE_CHUNK
    attention._DECODE_CHUNK = 2 * slots
    try:
        rec["whole_cache_ms"] = call_ms(
            torch, lambda: attention._decode_attn(q, k, v, valid, cap),
            repeats=11, inner=3)
    finally:
        attention._DECODE_CHUNK = real
    qs = q.reshape(1, 1, kvh * g, hd).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    rec["sdpa_ms"] = call_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=valid[None, None, None, :],
            enable_gqa=True), repeats=11, inner=3)
    rec["bound_ms"] = 2 * k.numel() * k.element_size() / HBM_BYTES_PER_S * 1e3
    return rec


def long_decode_phase(torch, ops, dev):
    """``LONG_DECODE``: gemma2-2b at its full published widths and depth
    in bf16 through ``serve.decode.make_serve_step`` over caches of
    ``slots`` slots, chunked (``_decode_attn``'s branch past
    ``_DECODE_CHUNK``). First one fp32 layer, chunked against the whole
    cache (:func:`long_layer_check`), and one bf16 layer's attention
    timed (:func:`long_attn_record`); then the cache from
    ``Model.init_cache``, keys and values drawn from a seeded generator on
    the card and the positions of a prefilled prompt of ``slots - empty``
    tokens; then ``steps`` greedy steps, each also run first through the
    whole-cache ``_sdpa`` (``_DECODE_CHUNK`` patched above ``slots``) from
    the same state (both write the same position's key and value; the
    chunked step's stay): logits within 5e-2 relative, finite, every
    kernel never launched. Reports the chunked and whole-cache step ms
    (host clock around a synchronized step), the peak memory and the
    step's bound (every cache key and value and every weight read once
    at the HBM rate)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.tree import tree_leaves

    ld = LONG_DECODE
    cfg, slots = get_arch(ld["arch"]), ld["slots"]
    torch.cuda.synchronize()
    before_gib = check_memory_free(torch, "long_decode_gemma2")
    layer_err = long_layer_check(torch, dev, cfg, slots)
    torch.cuda.empty_cache()
    layer_ms = long_attn_record(torch, dev, cfg, slots)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(ld["seed"], device=dev, dtype=ld["dtype"])
    held = sum(x.numel() for x in tree_leaves(params))
    check(held == ld["held"], f"long_decode: {held} weights held, "
          f"expected {ld['held']}")
    cache = model.init_cache(params, 1, slots)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ld["seed"])
    n_prompt = slots - ld["empty"]
    a_slots = []
    for lc, lt in zip(cache["layers"], cfg.layer_types()):
        c = lc["attn"]
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        n = c["pos"].shape[0]
        p = torch.arange(max(n_prompt - n, 0), n_prompt, device=dev)
        c["pos"].fill_(-1)
        c["pos"][p % n] = p.to(torch.int32)
        if lt == "A":
            a_slots.append(n)
    check(a_slots == [slots] * cfg.layer_types().count("A"),
          f"long_decode: A caches of {a_slots} slots")
    kv_bytes = sum(lc["attn"][n].numel() * lc["attn"][n].element_size()
                   for lc in cache["layers"] for n in ("k", "v"))
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    step, _ = make_serve_step(model)
    token = torch.randint(0, cfg.vocab_size, (1,), generator=gen,
                          device=dev)
    real = attention._DECODE_CHUNK
    ops.reset_launch_counts()
    errs, ms, whole_ms, tokens = [], [], [], []
    for i in range(ld["steps"]):
        index = n_prompt + i
        attention._DECODE_CHUNK = 2 * slots
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole, cache = step(params, cache, token, index)
            torch.cuda.synchronize()
            whole_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            attention._DECODE_CHUNK = real
        t0 = time.perf_counter()
        logits, cache = step(params, cache, token, index)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all()),
              f"long_decode: step {i} logits not finite")
        errs.append(rel_err(torch, logits.float(), whole.float()))
        token = torch.argmax(logits, dim=-1)
        tokens.append(int(token))
    counts = ops.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"long_decode: launches {counts}, expected none")
    check(max(errs) <= 5e-2, f"long_decode: chunked vs whole-cache logits "
          f"{max(errs):.3e} apart")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, cache, logits, whole
    torch.cuda.empty_cache()
    bound_ms = (kv_bytes + w_bytes) / HBM_BYTES_PER_S * 1e3
    return counts, dict(
        arch=ld["arch"], layers=cfg.num_layers, slots=slots,
        a_layers=len(a_slots), chunk=real, steps=ld["steps"],
        first_index=n_prompt, n_params=held, allocated_before_gib=before_gib,
        kv_bytes=kv_bytes, weight_bytes=w_bytes, peak_gib=peak_gib,
        step_ms=statistics.median(ms), step_ms_all=ms,
        whole_cache_step_ms=statistics.median(whole_ms),
        bound_ms=bound_ms, bound_by="bytes",
        logits_rel_err=errs, layer_fp32_rel_err=layer_err,
        attn_layer_bf16=layer_ms, tokens=tokens)


def example_quickstart_phase(torch, ops, dev, work: Path):
    """``examples/quickstart_torch.py`` on the card (``QUICKSTART_RUNS``:
    its defaults, 10 rounds, and ``--trust-features multi --rounds 4``),
    each with ``--telemetry`` into ``work``; every ``run_simulation`` it
    makes is read apart, the counters reset just before it and read just
    after: Cost-TrustFL launches trust_stage and weighted_agg once a
    round, FedAvg nothing (no compressor); the stream passes the report
    CLI's ``--validate-only``; accuracies, $ and reputations finite."""
    import math

    from repro_torch.telemetry import report

    example = _load_example("quickstart_torch")
    real = example.run_simulation
    out = {}
    for path, extra in QUICKSTART_RUNS.items():
        runs = []

        def counted(fl, **kw):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            res = real(fl, **kw)
            torch.cuda.synchronize()
            runs.append((kw["method"], kw["rounds"], ops.launch_counts()))
            return res
        events = work / f"{path}.jsonl"
        example.run_simulation = counted
        t0 = time.perf_counter()
        try:
            res = example.main(extra + ["--device", str(dev),
                                        "--telemetry", str(events)])
        finally:
            example.run_simulation = real
        wall_s = time.perf_counter() - t0
        total = {}
        for method, rounds, c in runs:
            want = {n: 0 for n in c}
            if method == "cost_trustfl":
                want.update(trust_stage=rounds, weighted_agg=rounds)
            check(c == want, f"{path} {method}: launches {c}, "
                  f"expected {want}")
            total = _add_counts(total, c)
        check([m for m, _, _ in runs] == ["cost_trustfl", "fedavg"],
              f"{path}: runs {runs}")
        check(report.main([str(events), "--validate-only"]) == 0,
              f"{path}: the telemetry stream does not validate")
        ours, base = res["ours"], res["base"]
        summary = [ours.final_accuracy, base.final_accuracy,
                   ours.total_cost, base.total_cost, res["honest_rep"],
                   res["malicious_rep"]]
        check(all(math.isfinite(x) for x in summary),
              f"{path}: summary {summary}")
        out[path] = (total, dict(
            wall_s=wall_s, rounds=runs[0][1],
            cost_trustfl_acc=ours.final_accuracy,
            fedavg_acc=base.final_accuracy, cost_trustfl_usd=ours.total_cost,
            fedavg_usd=base.total_cost, honest_rep=res["honest_rep"],
            malicious_rep=res["malicious_rep"],
            events=len(report.load_events(events))))
    return out


def example_byzantine_phase(torch, ops, dev):
    """``examples/byzantine_defense_torch.py --static --rounds 2`` on the
    card: the five methods under the paper's four static attacks through
    ``compare_methods``, every ``run_simulation`` it makes read apart
    (counters reset just before, read just after): Cost-TrustFL launches
    trust_stage and weighted_agg once a round, FLTrust weighted_agg once
    a round, FedAvg, Krum and the trimmed mean nothing; every cell of
    the table finite."""
    import math

    from repro_torch.federated import simulation

    example = _load_example("byzantine_defense_torch")
    real = simulation.run_simulation
    runs = []

    def counted(fl, **kw):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = real(fl, **kw)
        torch.cuda.synchronize()
        runs.append((kw["method"], kw["scenario"].name, ops.launch_counts()))
        return res
    simulation.run_simulation = counted
    t0 = time.perf_counter()
    try:
        res = example.main(["--static", "--rounds", str(BYZANTINE["rounds"]),
                            "--device", str(dev)])
    finally:
        simulation.run_simulation = real
    wall_s = time.perf_counter() - t0
    r = BYZANTINE["rounds"]
    total = {}
    for method, scenario, c in runs:
        want = {n: 0 for n in c}
        if method == "cost_trustfl":
            want.update(trust_stage=r, weighted_agg=r)
        elif method == "fltrust":
            want.update(weighted_agg=r)
        check(c == want, f"example_byzantine_defense {method} / {scenario}: "
              f"launches {c}, expected {want}")
        total = _add_counts(total, c)
    table = res["table"]
    check(len(runs) == len(table) == len(example.METHODS) * 4,
          f"example_byzantine_defense: {len(runs)} runs, {len(table)} cells")
    check(all(math.isfinite(a) for a in table.values()),
          f"example_byzantine_defense: table {table}")
    return total, dict(wall_s=wall_s, rounds=r,
                       table={f"{m}/{n}": a for (m, n), a in table.items()})


def example_serve_batch_phase(torch, ops, dev):
    """``examples/serve_batch_torch.py`` on the card for every arch of
    ``ARCH_IDS`` at its defaults (reduced, batch 4, 16-token prompts, 32
    greedy steps), the counters reset just before each and read just
    after: linear_scan once per "R" layer (the prefill; 2 on
    recurrentgemma-2b's reduced R, R) and never elsewhere, every other
    kernel never; then ``SERVE_BATCH_ON_CPU`` again on the CPU (fp32, the
    same weights, drawn on the CPU, and prompt): the greedy token ids
    equal the card's."""
    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_arch, reduced

    example = _load_example("serve_batch_torch")
    total, out = {}, {}
    for arch in ARCH_IDS:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = example.main(["--arch", arch, "--device", str(dev)])
        torch.cuda.synchronize()
        c = ops.launch_counts()
        want = {n: 0 for n in c}
        want["linear_scan"] = reduced(get_arch(arch)).layer_types().count(
            "R")
        check(c == want, f"example_serve_batch {arch}: launches {c}, "
              f"expected {want}")
        total = _add_counts(total, c)
        out[arch] = dict(prefill_s=res["prefill_s"], decode_s=res["decode_s"],
                         tokens_per_s=res["tokens_per_s"],
                         cache_bytes=res["cache_bytes"],
                         sample=res["tokens"][0][:16].tolist())
        if arch in SERVE_BATCH_ON_CPU:
            cpu = example.main(["--arch", arch, "--device", "cpu"])
            check(np.array_equal(cpu["tokens"], res["tokens"]),
                  f"example_serve_batch {arch}: card tokens "
                  f"{res['tokens'][0].tolist()} vs CPU "
                  f"{cpu['tokens'][0].tolist()}")
            out[arch]["equal_to_cpu"] = True
    return total, out


def main_path_phase(torch, ops, dev, path: str):
    """``ROUNDS`` full-width rounds of ``path`` through ``FLServer``, the
    launch counters reset just before and read just after."""
    import math

    import numpy as np
    from repro_torch.compress.topk import TopKCodec
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.cost import CostModel
    from repro_torch.federated import FLServer, make_data, make_topology
    from repro_torch.scenarios import get_scenario

    knobs, scenario, engine, per_round = PATHS[path]
    fl = FLConfig(**knobs)
    if scenario is not None:
        fl = get_scenario(scenario).apply(fl)
    topo = make_topology(fl)
    t0 = time.perf_counter()
    data = make_data(fl)
    server = FLServer(fl, topo, data, method=fl.aggregator, seed=0,
                      scenario=scenario, device=dev, engine=engine)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(server.engine_resolved == (engine if engine in ("jit", "shard")
                                     else "host"),
          f"{path}: engine={engine!r} resolved to {server.engine_resolved}")
    d = server.d_params
    check(d == 545_098, f"D = {d}, expected the paper CNN's 545,098")
    cm = CostModel(fl.c_intra, fl.c_cross)
    hier = fl.aggregator == "cost_trustfl"
    if fl.compressor == "topk":  # top-k on the cross-cloud links
        topk = float(TopKCodec(fl.compress_ratio).payload_bytes(d))
        same = topo.cloud_of == topo.aggregator_cloud
        client_pl = (np.full(topo.n_clients, 4.0 * d) if hier
                     else np.where(same, 4.0 * d, topk))
        edge_pl = np.full(topo.n_clouds, topk)
        edge_pl[topo.aggregator_cloud] = 4.0 * d
    else:                       # QSGD on every uplink: fp32 scale + 5 bits
        qsgd = 4 + math.ceil(5 * d / 8)
        check(qsgd == 340_691, f"QSGD payload {qsgd} B")
        client_pl = np.full(topo.n_clients, float(qsgd))
        edge_pl = np.full(topo.n_clouds, float(qsgd))

    ops.reset_launch_counts()
    round_s = []
    for t in range(ROUNDS):
        t1 = time.perf_counter()
        met = server.run_round(t)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t1)
        sel = met.selected
        n_sel = int(sel.sum())
        check(1 <= n_sel < fl.clients_per_round if scenario == "dropout"
              else n_sel == fl.clients_per_round,
              f"{path} round {t}: {n_sel} delivered")
        ib, cb = cm.round_bytes(topo, sel, d, hierarchical=hier,
                                client_payload=client_pl,
                                edge_payload=edge_pl)
        cost = cm.round_cost(topo, sel, d, hierarchical=hier,
                             client_payload=client_pl, edge_payload=edge_pl)
        check((met.extra["intra_bytes"], met.extra["cross_bytes"], met.cost)
              == (ib, cb, cost),
              f"{path} round {t}: bytes/$ differ from CostModel")
        if fl.trust_features == "multi":
            fw = met.extra["feat_weights"]
            check(bool(np.all(np.isfinite(fw)))
                  and abs(float(fw.sum()) - 1.0) <= 1e-5,
                  f"{path} round {t}: feature weights {fw}")
    counts = ops.launch_counts()
    want = {n: c * ROUNDS for n, c in per_round.items()}
    check(counts == want, f"{path}: launches {counts}, expected {want}")
    for name, p in server.params.items():
        check(bool(torch.isfinite(p).all()),
              f"{path}: param {name} not finite")
    for name, x in server_tensors(server).items():
        check(bool(torch.isfinite(x).all()), f"{path}: {name} not finite")
    acc = server.evaluate()
    check(0.0 <= acc <= 1.0, f"{path}: accuracy {acc}")
    server.close()
    return counts, dict(engine=server.engine_resolved, setup_s=setup_s,
                        round_s=round_s,
                        rounds_per_s=ROUNDS / sum(round_s),
                        steady_rounds_per_s=(ROUNDS - 1) / sum(round_s[1:])
                        if ROUNDS > 1 else None,
                        final_accuracy=acc, total_cost=server.cum_cost,
                        cross_bytes=server.cum_cross_bytes,
                        intra_bytes=server.cum_intra_bytes)


@contextmanager
def captured_servers():
    """The ``FLServer``s that ``run_simulation`` builds inside the
    ``with`` body, in order (the harness returns no params; the checks
    below read the final ones)."""
    from repro_torch.federated import simulation

    made, make = [], simulation.FLServer

    def build(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]
    simulation.FLServer = build
    try:
        yield made
    finally:
        simulation.FLServer = make


def _round_events(events):
    return [e for e in events if e["event"] == "round"]


# round-event fields the batch driver must reproduce exactly (masks,
# bytes, $), and the float digests held to 1e-5 relative
_EXACT = ("t", "n_selected", "n_delivered", "n_active_malicious",
          "intra_bytes", "cross_bytes", "cost", "cum_cost",
          "cum_intra_bytes", "cum_cross_bytes", "price_mult",
          "compression_ratio")
_FLOATS = ("rep_mean", "rep_min", "rep_max", "rep_honest_mean",
           "rep_malicious_mean")
_COMPARED = ("byte_identical", "first_differing_round", "float_drift",
             "drifted_most")


def compare_round_lines(a, b, what: str, strict: bool = True):
    """Two drivers' round events, round by round: exact fields and the
    delivered-mask digest equal, floats within 1e-5 relative (checked
    when ``strict``). Returns the count of byte-identical lines, the
    first round whose exact fields or mask differ (None), the worst
    float drift before it and the field that drifted most."""
    from repro_torch.telemetry import encode

    check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} round events")
    worst, first, field = 0.0, None, None
    for x, y in zip(a, b):
        same = (all(x[k] == y[k] for k in _EXACT)
                and x["digest"]["delivered_sha"]
                == y["digest"]["delivered_sha"])
        check(same or not strict,
              f"{what} t={y['t']}: masks, bytes or $ differ")
        if not same:
            first = y["t"]
            break
        pairs = [(k, x[k], y[k]) for k in _FLOATS if y[k] is not None]
        pairs += [(k, x["digest"][k], y["digest"][k])
                  for k in ("params_l2", "rep_l2", "rep_sum")]
        pairs += [("feat_weights", u, v) for u, v in
                  zip(x["feat_weights"] or [], y["feat_weights"] or [])]
        for k, u, v in pairs:
            drift = abs(u - v) / max(abs(v), 1e-30)
            if drift > worst:
                worst, field = drift, f"{k} t={y['t']}"
    check(worst <= 1e-5 or not strict,
          f"{what}: float fields {worst:.2e} apart > 1e-5 ({field})")
    identical = sum(encode(x) == encode(y) for x, y in zip(a, b))
    return identical, first, worst, field


def undo_cudnn_contract(torch):
    """cuDNN back on PyTorch's defaults (any algorithm, the autotuner
    on), as a caller may have left it: the entry point run next must set
    the port's deterministic contract itself."""
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True


def check_cudnn_contract(torch, what: str) -> None:
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          f"{what}: the entry point left cuDNN non-deterministic")


def steady_rounds_per_s(torch, server, rounds: int) -> float:
    """Rounds/s of ``rounds`` rounds after one warm-up round, each round
    timed on the host clock up to ``torch.cuda.synchronize()``."""
    server.run_round(0)
    torch.cuda.synchronize()
    times = []
    for t in range(1, 1 + rounds):
        t0 = time.perf_counter()
        server.run_round(t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return rounds / sum(times)


def telemetry_phase(torch, ops, dev, work: Path):
    """``TELEMETRY_PATHS`` through ``run_simulation`` with a JSONL and a
    list sink, ``run_simulation_batch`` (one seed live, two seeds on
    shared data), headline's rounds/s with telemetry off and on, the
    report CLI on a stream of the card, and a checkpoint round trip on
    the card. Work files go to ``work``."""
    import math

    import numpy as np
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import (FLServer, make_data, make_topology,
                                       run_simulation, run_simulation_batch)
    from repro_torch.telemetry import (JsonlSink, ListSink, Telemetry,
                                       encode, validate_events)

    data = make_data(FLConfig(**PATHS["headline"][0]))
    rec, streams = {}, {}
    for path in TELEMETRY_PATHS:
        knobs, scenario, engine, per_round = PATHS[path]
        fl = FLConfig(**knobs)
        sink, jsonl = ListSink(), work / f"{path}.jsonl"
        undo_cudnn_contract(torch)
        ops.reset_launch_counts()
        with captured_servers() as made, \
                Telemetry(JsonlSink(jsonl), sink) as tel:
            res = run_simulation(fl, method=fl.aggregator, scenario=scenario,
                                 rounds=ROUNDS, eval_every=ROUNDS, data=data,
                                 device=dev, engine=engine, telemetry=tel)
        counts = ops.launch_counts()
        check_cudnn_contract(torch, f"run_simulation {path}")
        want = {n: c * ROUNDS for n, c in per_round.items()}
        check(counts == want,
              f"telemetry {path}: launches {counts}, expected {want}")
        events = sink.events
        errors = validate_events(events)
        check(not errors, f"telemetry {path}: invalid events {errors[:3]}")
        check(jsonl.read_text().splitlines() == [encode(e) for e in events],
              f"telemetry {path}: the JSONL file is not the stream")
        check([e["event"] for e in events] == ["run_start"]
              + ["round", "span"] * ROUNDS + ["eval", "run_end"],
              f"telemetry {path}: events {[e['event'] for e in events]}")
        rounds = _round_events(events)
        last = rounds[-1]
        check((last["cum_cost"], last["cum_intra_bytes"],
               last["cum_cross_bytes"])
              == (res.total_cost, res.intra_bytes, res.cross_bytes),
              f"telemetry {path}: totals differ from the SimResult's")
        server = made[0]
        check(server.engine_resolved == ("host" if engine == "host"
                                         else "jit"),
              f"telemetry {path}: engine {server.engine_resolved}")
        l2 = math.sqrt(sum(float(torch.sum(p.double() ** 2))
                           for p in server.params.values()))
        l2_rel = abs(last["digest"]["params_l2"] - l2) / l2
        check(l2_rel <= 1e-5,
              f"telemetry {path}: params_l2 {l2_rel:.2e} from float64")
        if fl.trust_features == "multi":
            check(all(e["feat_weights"] is not None for e in rounds),
                  f"telemetry {path}: feat_weights missing")
        spans_s = [e["seconds"] for e in events if e["event"] == "span"]
        streams[path] = rounds
        rec[path] = dict(launches=counts, params_l2_rel=l2_rel,
                         first_round_s=spans_s[0], round_s=spans_s[1:],
                         cum_cost=last["cum_cost"])
        if path == "headline":
            headline = server

    # the report CLI on the card's headline stream; a broken line fails it
    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry.report", *args],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(SRC)})
    shown = cli(str(work / "headline.jsonl"))
    check(shown.returncode == 0 and "intra MB" in shown.stdout
          and "cum_cost=$" in shown.stdout,
          f"report CLI: rc {shown.returncode} {shown.stderr[-500:]}")
    check(cli(str(work / "defense.jsonl"), "--validate-only").returncode
          == 0, "report CLI --validate-only refused the defense stream")
    broken = work / "broken.jsonl"
    broken.write_text((work / "host_headline.jsonl").read_text()
                      + '{"schema":"nope","event":"round"}\n')
    check(cli(str(broken), "--validate-only").returncode == 1,
          "report CLI --validate-only passed a broken line")
    rec["report"] = shown.stdout

    # run_simulation_batch: one seed live through Engine.run's tap,
    # against the FLServer run's headline lines above (two runs of one
    # seed, held exact: the entry points put cuDNN on its deterministic
    # algorithms, so nothing in the caller does; the contract is undone
    # before each entry point to show that it sets it); two seeds on
    # shared data against single-seed runs
    fl = FLConfig(**PATHS["headline"][0])

    def batch(seeds, tel=None):
        undo_cudnn_contract(torch)
        out = run_simulation_batch(fl, seeds=seeds, rounds=ROUNDS,
                                   data=data, device=dev, telemetry=tel)
        check_cudnn_contract(torch, "run_simulation_batch")
        return out
    live = ListSink()
    ops.reset_launch_counts()
    batch([0], Telemetry(live))
    counts = ops.launch_counts()
    want = {n: c * ROUNDS for n, c in PATHS["headline"][3].items()}
    check(counts == want, f"batch: launches {counts}, expected {want}")
    check(not validate_events(live.events), "batch: invalid events")
    strict = compare_round_lines(_round_events(live.events),
                                 streams["headline"], "batch vs FLServer")
    two, one, one1 = batch([0, 1]), batch([0]), batch([1])
    for single, batched in ((one[0], two[0]), (one1[0], two[1])):
        check((single.total_cost, single.intra_bytes, single.cross_bytes)
              == (batched.total_cost, batched.intra_bytes,
                  batched.cross_bytes)
              and np.array_equal(single.reputation, batched.reputation),
              "batch seeds=[0, 1]: a seed's run differs from its own")
    rec["batch"] = dict(launches=counts, lines=ROUNDS,
                        deterministic=dict(zip(_COMPARED, strict)),
                        totals=[r.total_cost for r in two])

    # rounds/s on headline with telemetry off, on, on, off, off, on
    fl = FLConfig(**PATHS["headline"][0])
    topo = make_topology(fl)
    rates = []
    for i, on in enumerate((False, True, True, False, False, True)):
        tel = Telemetry(JsonlSink(work / f"rate{i}.jsonl")) if on else None
        server = FLServer(fl, topo, data, seed=0, device=dev, engine="jit",
                          telemetry=tel)
        rates.append((on, steady_rounds_per_s(torch, server,
                                              OVERHEAD_ROUNDS)))
        if tel is not None:
            tel.close()
    off = [r for on, r in rates if not on]
    on = [r for on, r in rates if on]
    rec["overhead"] = dict(turns=rates, ratio=statistics.median(on)
                           / statistics.median(off))

    # checkpoint: the headline server's params and reputation, and a bf16
    # leaf, saved and restored on the card bit for bit
    tree = {"params": headline.params, "rep": headline.rep.ema,
            "bf16": headline.params["fc2_w"].to(torch.bfloat16)}
    save_checkpoint(str(work / "ckpt"), tree, step=ROUNDS)
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in tree["params"].items()},
                "rep": torch.zeros_like(tree["rep"]),
                "bf16": torch.zeros_like(tree["bf16"])}
    back, meta = restore_checkpoint(str(work / "ckpt"), template)
    check(meta["step"] == ROUNDS, "checkpoint: metadata lost")
    for name, a, b in (
            [(k, back["params"][k], v) for k, v in tree["params"].items()]
            + [("rep", back["rep"], tree["rep"]),
               ("bf16", back["bf16"], tree["bf16"])]):
        check(a.device == b.device and a.dtype == b.dtype
              and torch.equal(a.view(torch.int16) if a.dtype
                              == torch.bfloat16 else a,
                              b.view(torch.int16) if b.dtype
                              == torch.bfloat16 else b),
              f"checkpoint: {name} not restored bit for bit on the card")
    rec["checkpoint"] = dict(leaves=meta["n_arrays"])
    return rec


# first match wins: cuDNN's implicit-GEMM convolutions also say "gemm"
_GROUPS = (("collectives (NCCL)", ("nccl",)),
           ("port kernels", ("trust_stage_kernel", "weighted_agg_kernel",
                             "topk_mask_kernel", "quantize_kernel",
                             "linear_scan_kernel")),
           ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                            "Wgrad", "winograd", "implicit")),
           ("matmul", ("gemm", "Gemm", "cutlass", "nvjet", "xmma")),
           ("softmax / reduction", ("softmax", "Softmax", "SoftMax", "reduce",
                                    "Reduce")),
           ("top-k / sort / index", ("topk", "TopK", "sort", "Sort", "radix",
                                     "index", "Index", "gather", "scatter")))


def out_dir():
    """The ``--out DIR`` directory (created), or None."""
    args = sys.argv[1:]
    if "--out" not in args:
        return None
    i = args.index("--out")
    if i + 1 >= len(args):
        raise PhaseError("--out needs a directory")
    out = Path(args[i + 1])
    out.mkdir(parents=True, exist_ok=True)
    return out


def _busy_us(intervals) -> float:
    """µs covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _phase_busy_us(labels, kern):
    """Device busy µs by round phase. The profiler copies each
    ``round.*`` label onto the device as a range that opens at the first
    kernel launched inside it; a kernel belongs to the phase whose range
    opened last before it started (work queued in a phase runs after
    the range's first kernel, and before the next phase's), and kernels
    before any range to "unlabelled". Busy time is the union of the
    phase's kernel intervals (kernel intervals overlap: their durations
    sum to about twice the busy time on the FL paths)."""
    import bisect
    from collections import defaultdict

    opens = sorted((e.time_range.start, e.name) for e in labels
                   if e.name in PHASES)
    starts = [a for a, _ in opens]
    by_phase = defaultdict(list)
    for k in kern:
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        by_phase[opens[i][1] if i >= 0 else "unlabelled"].append(
            (k.time_range.start, k.time_range.end))
    return {p: _busy_us(iv) for p, iv in by_phase.items()}


def _trace(torch, out, name: str, run, n: int, unit: str,
           host: bool = True):
    """Run ``run()`` (``n`` units of work) under ``torch.profiler`` and
    report, per unit, the device's busy time by kernel group and by
    round phase, its idle share of the host-clock wall time, its events
    (kernels, copies, fills) and the top kernels; writes the Chrome
    trace to ``out``/trace_<name>.json when ``out`` is given. ``host``
    also records the host's ops, which the round phases' labels need; a
    serve path records the device alone (RWKV6's prefill launches
    ~200,000 kernels, each with several host ops)."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # the device-side copies of the round labels are ranges, not kernels
    labels = [e for e in events if e.device_type == DeviceType.CUDA
              and (e.name in PHASES or getattr(e, "is_user_annotation",
                                               False))]
    label_ids = {id(e) for e in labels}
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and id(e) not in label_ids]
    check(bool(kern), "the profiler recorded no device kernel")
    busy_us = _busy_us((e.time_range.start, e.time_range.end) for e in kern)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kern:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    groups = defaultdict(float)
    for kname, (us, _) in by_name.items():
        group = next((g for g, keys in _GROUPS
                      if any(k in kname for k in keys)), "other")
        groups[group] += us / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    if out is not None:
        prof.export_chrome_trace(str(out / f"trace_{name}.json"))
    phases = _phase_busy_us(labels, kern)
    return dict(unit=unit, n=n, wall_ms=wall_us / n / 1e3,
                busy_ms=busy_us / n / 1e3, idle_share=1.0 - busy_us / wall_us,
                kernels=len(kern) / n,
                group_ms={g: us / 1e3 for g, us in groups.items()},
                phase_busy_ms={p: us / n / 1e3 for p, us in phases.items()},
                device_labels=len(labels) / n,
                top=[dict(name=k[:120], ms=us / n / 1e3, launches=c / n)
                     for k, (us, c) in top])


def profile_phase(torch, dev, out, path: str, rounds: int = 2):
    """``--profile``: ``rounds`` steady rounds of FL ``path`` after 2
    warm-up rounds, traced (figures per round)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import FLServer, make_data, make_topology

    knobs, scenario, engine, _ = PATHS[path]
    fl = FLConfig(**knobs)
    server = FLServer(fl, make_topology(fl), make_data(fl),
                      method=fl.aggregator, seed=0, scenario=scenario,
                      device=dev, engine=engine)
    for t in range(2):
        server.run_round(t)

    def run():
        for t in range(2, 2 + rounds):
            server.run_round(t)
    rec = _trace(torch, out, path, run, rounds, "round")
    server.close()
    return rec


def trace_labels_phase(torch, dev, work: Path):
    """``--profile``: one steady DEFENSE round (every phase runs: the
    attack, the client wire) captured with ``telemetry.trace``; the
    Chrome trace it writes must hold the six round labels."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import FLServer, make_data, make_topology
    from repro_torch.telemetry import trace

    knobs, scenario, engine, _ = PATHS["defense"]
    fl = FLConfig(**knobs)
    server = FLServer(fl, make_topology(fl), make_data(fl), seed=0,
                      device=dev, engine=engine)
    server.run_round(0)
    with trace(str(work / "trace")):
        server.run_round(1)
    doc = json.loads((work / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in doc.get("traceEvents", [])}
    missing = [p for p in PHASES if p not in names]
    check(not missing, f"trace(): labels {missing} not in the capture")
    return dict(labels=list(PHASES), events=len(doc["traceEvents"]))


def profile_serve(torch, dev, out, path: str = "serve"):
    """One steady prefill of ``SERVE_PATHS[path]``'s prompt (after a
    warm-up prefill and 2 decode steps) and then its ``gen`` decode
    steps, traced apart with ``torch.profiler`` (the device alone;
    figures per prefill and per decode step), at the path's arch, depth,
    dtype and seed; the weights are made for it and released after. A
    request's batch is ``dummy_batch`` (an encoder-decoder's frames
    encoded in the prefill) and decoding starts at ``prompt_len``, as in
    the launcher."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model

    sv, _, layers = SERVE_PATHS[path]
    cfg = get_arch(sv["arch"])
    model = Model(replace(cfg, num_layers=layers or cfg.num_layers))
    check_memory_free(torch, f"{path} profile")
    params = model.init(sv["seed"], device=dev, dtype=sv["dtype"])
    t, gen = sv["prompt_len"], sv["gen"]
    max_len = t + gen
    batch = model.dummy_batch(0, 1, t, device=dev)
    logits, cache = model.prefill(params, batch, max_len)
    for i in range(2):
        logits, cache = tfm.decode_step(params, model.cfg, cache,
                                        torch.argmax(logits, -1), t + i)
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(params, batch,
                                                        max_len)

    def decode():
        logits, cache = state["logits"], state["cache"]
        for i in range(gen):
            logits, cache = tfm.decode_step(params, model.cfg, cache,
                                            torch.argmax(logits, -1), t + i)
    rec = {f"{path}_prefill": _trace(torch, out, f"{path}_prefill", prefill,
                                     1, f"prefill of {t} tokens", host=False),
           f"{path}_decode": _trace(torch, out, f"{path}_decode", decode,
                                    gen, "decode step", host=False)}
    del params, cache, state
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the train steps over a device mesh

def _adamw_clipped(torch):
    """AdamW (weight decay 0.1) after ``clip_by_global_norm(0.05)``: the
    clip bites on these steps, so it reads the whole gradient."""
    from repro_torch.optim import adamw, clip_by_global_norm

    init, update = adamw(1e-2, weight_decay=0.1)

    def clipped(grads, state, params):
        return update(clip_by_global_norm(grads, 0.05)[0], state, params)
    return init, clipped


def _mesh_step_run(torch, ops, model, mesh, fl, strategy, p0, batch, ref,
                   chunk, steps: int = 2, opt=None):
    """``steps`` chained federated steps over ``mesh`` (a ``DeviceMesh``
    or a ``ClientMesh``) from a copy of ``p0``, with ``opt`` (default
    AdamW after the clip): (metrics, reputation, the parameters and
    moments gathered whole, the launches)."""
    from repro_torch.sharding import full_tree
    from repro_torch.train import make_fl_train_step
    from repro_torch.tree import tree_leaves, tree_map

    opt = opt or _adamw_clipped(torch)
    params = tree_map(lambda x: x.clone(), p0)
    state = opt[0](params)
    step, topo = make_fl_train_step(model, mesh, fl, opt, strategy=strategy,
                                    loss_chunk=chunk)
    rep = torch.full((topo.n_clients,), 1.0 / topo.n_clients,
                     device=p0["embed"].device)
    counts = {}
    with step:
        for t in range(steps):
            key = (t + 1,) if strategy == "fused" else ()
            ops.reset_launch_counts()
            params, state, rep, met = step(params, state, rep, batch, ref,
                                           *key)
            counts = _add_counts(counts, ops.launch_counts())
    leaves = tree_leaves(full_tree([params, state.mu, state.nu]))
    return dict(met=met, rep=rep, leaves=leaves, step=int(state.step),
                launches=counts)


def _same_bits(torch, a, b, what: str) -> int:
    """Checks two runs of :func:`_mesh_step_run` equal bit for bit;
    returns the leaves compared."""
    check(a["met"].keys() == b["met"].keys() and all(
        torch.equal(a["met"][k], b["met"][k]) for k in a["met"]),
        f"{what}: metrics differ")
    check(torch.equal(a["rep"], b["rep"]), f"{what}: reputation differs")
    check(len(a["leaves"]) == len(b["leaves"]) and all(
        torch.equal(x, y) for x, y in zip(a["leaves"], b["leaves"])),
        f"{what}: parameters or moments differ")
    check(a["step"] == b["step"], f"{what}: optimizer steps differ")
    return len(a["leaves"])


def _mesh_inputs(torch, model, n: int, k: int, seq: int, dev):
    """Weights from seed 0, ``n`` clients of 2 rows and ``k`` clouds of
    one reference row, from ``dummy_batch`` on the card."""
    p0 = model.init(0, device=dev)
    batch = {key: v.to(dev) for key, v in
             model.dummy_batch(1, 2 * n, seq).items()}
    ref = {key: v.reshape((k, 1) + tuple(v.shape[1:])).to(dev) for key, v in
           model.dummy_batch(2, k, seq).items()}
    return p0, batch, ref


def mesh_phase(torch, ops, dev, seq: int = 96, chunk: int = 40):
    """On the (1, 1) mesh of ``launch.mesh.make_debug_mesh(1)`` (a
    one-rank group holding NCCL and gloo, ended after): the two-phase and
    fused steps at recurrentgemma-2b's and the dense test configurations
    (one client, the mesh's data axis; two chained steps, AdamW after the
    clip) give the bits of the same steps over ``ClientMesh(1)``:
    metrics, reputation, parameters, moments, the step and the scan
    launches; and ``make_plain_step`` with the mesh gives the bits of
    ``mesh=None``'s (two AdamW steps)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import ClientMesh, make_plain_step
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_debug_mesh(1, device=dev)
    fl = FLConfig(n_clouds=1, clients_per_round=1)
    out = {}
    try:
        for name, model in (("rg", _serve_test_model()),
                            ("dense", _dense_test_model())):
            p0, batch, ref = _mesh_inputs(torch, model, 1, 1, seq, dev)
            for strategy in ("two_phase", "fused"):
                what = f"mesh (1, 1) {name} {strategy}"
                a, b = (_mesh_step_run(torch, ops, model, m, fl, strategy, p0,
                                       batch, ref, chunk)
                        for m in (mesh, ClientMesh(1)))
                n = _same_bits(torch, a, b, what)
                check(a["launches"] == b["launches"],
                      f"{what}: launches {a['launches']} vs "
                      f"{b['launches']}")
                out[f"{name}_{strategy}"] = dict(
                    leaves=n, scans=a["launches"]["linear_scan"])
        model = _serve_test_model()
        p0, batch, _ = _mesh_inputs(torch, model, 1, 1, seq, dev)
        runs = []
        for m in (mesh, None):
            opt = _adamw_clipped(torch)
            params = tree_map(lambda x: x.clone(), p0)
            state = opt[0](params)
            step = make_plain_step(model, m, opt, loss_chunk=chunk)
            losses = []
            for _ in range(2):
                params, state, met = step(params, state, batch)
                losses.append(met["loss"])
            runs.append((losses, tree_leaves([params, state.mu, state.nu])))
        check(all(torch.equal(x, y) for x, y in zip(runs[0][0], runs[1][0]))
              and all(torch.equal(x, y)
                      for x, y in zip(runs[0][1], runs[1][1])),
              "make_plain_step with a mesh differs from mesh=None")
        out["plain_step"] = dict(leaves=len(runs[0][1]))
    finally:
        end_group()
    return out


def mesh_steps_phase(torch, ops, dev, meshes, seq: int = 96,
                     chunk: int = 40):
    """The four-card mode's step checks, on ``meshes`` (shape -> the
    live (4, 1) and (2, 2) meshes of the 4 ranks): the two-phase and
    fused steps at recurrentgemma-2b's and the dense test
    configurations (two chained steps, AdamW after
    the clip, 2 rows a client, 2 clouds, 3 selected) over the mesh against
    (a) the same steps over ``ClientMesh`` on the ranks of this rank's
    model index (moments whole): bit for bit; (b) with SGD (0.05), the
    same steps with every client on this rank alone (a one-rank group):
    metrics, reputation and every parameter leaf within 1e-5 relative
    (NCCL sums in another order; AdamW's m/√v would magnify those last
    bits in the leaves near 0), the selection exact; (c) every rank's
    gathered parameters and moments, by SHA-1: equal on all 4 ranks."""
    import hashlib

    import torch.distributed as dist
    from repro_torch.configs.base import FLConfig
    from repro_torch.optim import sgd
    from repro_torch.train import ClientMesh
    from repro_torch.sharding import clients_group

    rank = dist.get_rank()
    alone = dist.new_group([rank], use_local_synchronization=True)
    out = {}
    for shape, mesh in meshes.items():
        n = shape[0]
        fl = FLConfig(n_clouds=2, clients_per_round=3)
        whole = ClientMesh(n, group=clients_group(mesh))
        for name, model in (("rg", _serve_test_model()),
                            ("dense", _dense_test_model())):
            p0, batch, ref = _mesh_inputs(torch, model, n, 2, seq, dev)
            for strategy in ("two_phase", "fused"):
                what = f"mesh {shape} {name} {strategy}"
                a, b = (_mesh_step_run(torch, ops, model, m, fl, strategy,
                                       p0, batch, ref, chunk)
                        for m in (mesh, whole))
                _same_bits(torch, a, b, what + " vs whole moments")
                digest = hashlib.sha1()
                for x in a["leaves"]:
                    digest.update(x.cpu().contiguous().numpy().tobytes())
                a, c = (_mesh_step_run(torch, ops, model, m, fl, strategy,
                                       p0, batch, ref, chunk, opt=sgd(0.05))
                        for m in (mesh, ClientMesh(n, group=alone)))
                check(torch.equal(a["met"]["selected"], c["met"]["selected"]),
                      f"{what}: selection differs from one rank's")
                drift = {k: rel_err(torch, a["met"][k], c["met"][k])
                         for k in ("loss", "phi", "trust", "beta")}
                drift["rep"] = rel_err(torch, a["rep"], c["rep"])
                drift["params"] = max(rel_err(torch, x, y) for x, y in
                                      zip(a["leaves"], c["leaves"]))
                check(max(drift.values()) <= 1e-5,
                      f"{what}: vs one rank {drift} > 1e-5")
                digests = [None] * dist.get_world_size()
                dist.all_gather_object(digests, digest.hexdigest())
                check(len(set(digests)) == 1,
                      f"{what}: the ranks' parameters differ")
                out[f"{shape[0]}x{shape[1]}_{name}_{strategy}"] = dict(
                    drift, launches=a["launches"])
    return out


# ---------------------------------------------------------------------------
# serving over a device mesh

def _local_gib(tree) -> float:
    """GiB this rank stores of a tree of DTensors (or tensors)."""
    from repro_torch.models.parallel import local_tree
    from repro_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size()
               for x in tree_leaves(local_tree(tree))) / 2 ** 30


def _outside_gib(torch, dev) -> float:
    """GiB of the card in use outside PyTorch's caching allocator (the
    CUDA context, NCCL's communicators)."""
    free, total = torch.cuda.mem_get_info(dev)
    return (total - free - torch.cuda.memory_reserved(dev)) / 2 ** 30


def _whole(x):
    """A DTensor's whole value (a mesh step's logits), else ``x``."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _rel_max(torch, got, want) -> float:
    """max |got - want| / max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def _greedy(torch, model, params, tokens, step, steps: int, max_len: int):
    """``Model.prefill`` of ``tokens``, then ``steps`` greedy steps of
    ``step`` from the prompt's last token: (prefill logits, [step
    logits], [tokens]), the logits whole."""
    t = tokens.shape[1]
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
    out = [_whole(logits)]
    tok, toks = tokens[:, -1], []
    for i in range(steps):
        lg, cache = step(params, cache, tok, t + i)
        lg = _whole(lg)
        out.append(lg)
        tok = torch.argmax(lg, dim=-1)
        toks.append(tok.tolist())
    return out, toks


def _trace_summary(trace) -> dict:
    """A traced decode's figures a step: the device's idle share, busy and
    wall ms, kernels, device ms by kernel group (NCCL's collectives
    apart: their kernels wait on the device for the other ranks) and the
    top kernels."""
    return dict(decode_idle_share=trace["idle_share"],
                decode_busy_ms=trace["busy_ms"],
                decode_wall_ms=trace["wall_ms"],
                decode_kernels=trace["kernels"],
                decode_group_ms=trace["group_ms"],
                decode_top=trace["top"][:8])


def mesh_parity_phase(torch, dev, mesh, arch: str, batch: int):
    """``arch`` at full width, ``MESH_PARITY["layers"]`` layers, fp32: the
    prefill and greedy steps over ``mesh`` (weights drawn into their
    shards) against one card's ``mesh=None`` steps on this rank (logits
    within 1e-4 of max |logit|, tokens equal), and ``make_prefill_step``
    both ways."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    mp = MESH_PARITY
    model = Model(replace(get_arch(arch), num_layers=mp["layers"]))
    cfg = model.cfg
    check_memory_free(torch, f"{arch} parity")
    whole = model.init(mp["seed"], device=dev, dtype="float32")
    params = model.init(mp["seed"], device=dev, dtype="float32", mesh=mesh)
    gen = torch.Generator().manual_seed(mp["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (batch, mp["prompt"]),
                           generator=gen).to(dev)
    max_len = mp["prompt"] + mp["steps"]
    one, one_toks = _greedy(torch, model, whole, tokens,
                            make_serve_step(model)[0], mp["steps"], max_len)
    got, got_toks = _greedy(
        torch, model, params, tokens,
        make_serve_step(model, mesh, batch=batch, max_len=max_len)[0],
        mp["steps"], max_len)
    errs = [_rel_max(torch, g, w) for g, w in zip(got, one)]
    pre_err = _rel_max(
        torch, _whole(make_prefill_step(model, mesh, batch=batch)(
            params, {"tokens": tokens})),
        make_prefill_step(model)(whole, {"tokens": tokens}))
    check(max(errs + [pre_err]) <= 1e-4,
          f"{arch} over the mesh: logits {max(errs):.3e}, prefill step "
          f"{pre_err:.3e} of max |logit| from one card's")
    check(got_toks == one_toks, f"{arch} over the mesh: tokens {got_toks} "
          f"against one card's {one_toks}")
    del whole, params
    torch.cuda.empty_cache()
    return dict(layers=mp["layers"], prompt=mp["prompt"], batch=batch,
                logits_rel_max=errs, prefill_step_rel_max=pre_err,
                tokens=got_toks)


def mesh_serve_phase(torch, dev, mesh, path: str):
    """``MESH_SERVE_PATHS[path]`` over ``mesh`` (see there): the weights
    held as the config counts them, every logit finite and every token in
    the vocabulary; init s, prefill ms first and steady, decode ms a step
    and tokens/s, ``make_prefill_step`` ms, peak and stored GiB a card,
    the memory outside the allocator, the collectives a decode step and
    the device's idle share of two traced decode steps."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import parallel
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves

    sv = MESH_SERVE_PATHS[path]
    cfg = get_arch(sv["arch"])
    model = Model(cfg)
    torch.cuda.synchronize()
    before_gib = check_memory_free(torch, path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(sv["seed"], device=dev, dtype=sv["dtype"], mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(x.numel() for x in tree_leaves(params))
    check(held == cfg.param_count() + cfg.d_model,
          f"{path}: {held} weights, expected "
          f"{cfg.param_count() + cfg.d_model}")
    stored_gib = _local_gib(params)
    b, t, gen = sv["batch"], sv["prompt"], sv["gen"]
    max_len = t + gen
    g = torch.Generator().manual_seed(sv["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g).to(dev)
    prefill_ms, cache = [], None
    for _ in range(2):
        cache = None                  # the first's cache goes first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
        logits = _whole(logits)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(logits).all()), f"{path}: prefill logits")
    cache_gib = _local_gib(cache)
    step, _ = make_serve_step(model, mesh, batch=b, max_len=max_len)
    tok = torch.argmax(logits, dim=-1)
    ms, host_ms, toks, coll = [], [], [], []
    for i in range(gen):
        parallel.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tok, t + i)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        lg = _whole(lg)
        tok = torch.argmax(lg, dim=-1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append(parallel.collective_counts())
        check(bool(torch.isfinite(lg).all()), f"{path}: step {i} logits")
        toks.append(tok.tolist())
    check(all(0 <= x < cfg.vocab_size for row in toks for x in row),
          f"{path}: tokens {toks}")
    state = {"tok": tok, "cache": cache}

    def decode():
        for i in range(2):
            lg, state["cache"] = step(params, state["cache"], state["tok"],
                                      t + gen - 2 + i)
            state["tok"] = torch.argmax(_whole(lg), dim=-1)
    trace = _trace(torch, None, f"{path}_decode", decode, 2, "decode step",
                   host=False)
    del cache, state
    pre = make_prefill_step(model, mesh, batch=sv["prefill_rows"])
    rows = {"tokens": tokens[:sv["prefill_rows"]]}
    pre_ms = []
    for _ in range(1 + sv["calls"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _whole(pre(params, rows))
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    check(bool(torch.isfinite(out).all())
          and tuple(out.shape) == (sv["prefill_rows"], cfg.vocab_size),
          f"{path}: make_prefill_step logits {tuple(out.shape)}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    outside_gib = _outside_gib(torch, dev)
    del params, out
    torch.cuda.empty_cache()
    return dict(
        arch=sv["arch"], mesh=sv["mesh"], layers=cfg.num_layers,
        dtype=sv["dtype"], n_params=held, allocated_before_gib=before_gib,
        init_s=init_s, stored_gib=stored_gib, cache_gib=cache_gib,
        prefill_batch=b, prompt=t, prefill_ms_first=prefill_ms[0],
        prefill_ms_steady=prefill_ms[1], decode_steps=gen,
        step_ms=statistics.median(ms), step_ms_all=ms,
        step_host_ms=statistics.median(host_ms),
        decode_tokens_per_s=b * gen / (sum(ms) / 1e3),
        collectives_per_step=coll[-1],
        prefill_step_rows=sv["prefill_rows"],
        prefill_step_ms_first=pre_ms[0],
        prefill_step_ms_steady=statistics.median(pre_ms[1:]),
        peak_gib=peak_gib, outside_gib=outside_gib,
        **_trace_summary(trace), tokens=toks)


def _long_cache(torch, model, params, slots: int, gen, n_prompt: int):
    """``model.init_cache`` of ``slots`` slots at batch 1, its keys and
    values drawn from ``gen`` into this rank's storage and its positions
    those of a prefilled prompt of ``n_prompt`` tokens."""
    from repro_torch.models.parallel import local_tree

    cache = model.init_cache(params, 1, slots)
    for lc in local_tree(cache)["layers"]:
        c = lc["attn"]
        c["k"].normal_(generator=gen)
        c["v"].normal_(generator=gen)
        n = c["pos"].shape[0]
        p = torch.arange(max(n_prompt - n, 0), n_prompt,
                         device=c["pos"].device)
        c["pos"].fill_(-1)
        c["pos"][p % n] = p.to(torch.int32)
    return cache


def mesh_long_parity(torch, dev, mesh):
    """``MESH_LONG``'s arch at 2 layers ("L", "A"), full width, fp32: one
    cache of ``slots`` slots drawn whole on the card (the same on every
    rank), then cut to each rank's sequence range; ``long_steps`` greedy
    steps over the mesh against one card's chunked decode of the whole
    cache, ``_DECODE_CHUNK`` at ``MESH_PARITY["chunk"]`` on both sides:
    logits within 1e-5 of max |logit|, tokens equal."""
    from dataclasses import replace

    from repro_torch.configs.base import get_arch
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.sharding import cache_specs, shard_tree

    ld, mp = MESH_LONG, MESH_PARITY
    model = Model(replace(get_arch(ld["arch"]), num_layers=2))
    check_memory_free(torch, "long parity")
    whole = model.init(mp["seed"], device=dev, dtype="float32")
    params = model.init(mp["seed"], device=dev, dtype="float32", mesh=mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(mp["seed"])
    n_prompt = ld["slots"] - ld["empty"]
    cache1 = _long_cache(torch, model, whole, ld["slots"], gen, n_prompt)
    cachem = shard_tree(cache1, cache_specs(cache1, model.cfg, mesh, 1), mesh)
    step1 = make_serve_step(model)[0]
    stepm = make_serve_step(model, mesh, batch=1, max_len=ld["slots"])[0]
    tok1 = tokm = torch.zeros((1,), dtype=torch.long, device=dev)
    real = attention._DECODE_CHUNK
    attention._DECODE_CHUNK = mp["chunk"]
    errs, toks = [], []
    try:
        for i in range(mp["long_steps"]):
            lg1, cache1 = step1(whole, cache1, tok1, n_prompt + i)
            lgm, cachem = stepm(params, cachem, tokm, n_prompt + i)
            lgm = _whole(lgm)
            errs.append(_rel_max(torch, lgm, lg1))
            tok1, tokm = torch.argmax(lg1, -1), torch.argmax(lgm, -1)
            toks.append((int(tok1), int(tokm)))
    finally:
        attention._DECODE_CHUNK = real
    check(max(errs) <= 1e-5, f"long parity: logits {max(errs):.3e} of max "
          f"|logit| from one card's chunked decode")
    check(all(a == b for a, b in toks), f"long parity: tokens {toks}")
    del whole, params, cache1, cachem
    torch.cuda.empty_cache()
    return dict(layers=2, slots=ld["slots"], chunk=mp["chunk"],
                logits_rel_max=errs, tokens=[a for a, _ in toks])


def mesh_long_phase(torch, dev, mesh):
    """``MESH_LONG`` over ``mesh`` (see there): every logit finite, every
    token in the vocabulary; step ms and tokens/s, peak and stored GiB a
    card (weights, the cache's shard), the memory outside the allocator,
    the collectives a step and the idle share of two traced steps."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.models import parallel
    from repro_torch.models.model import Model
    from repro_torch.serve.decode import make_serve_step

    ld = MESH_LONG
    cfg = get_arch(ld["arch"])
    model = Model(cfg)
    torch.cuda.synchronize()
    before_gib = check_memory_free(torch, "long_decode_gemma2_mesh4")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(ld["seed"], device=dev, dtype=ld["dtype"], mesh=mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(ld["seed"] * 1000 + dist.get_rank())
    n_prompt = ld["slots"] - ld["empty"]
    cache = _long_cache(torch, model, params, ld["slots"], gen, n_prompt)
    step, _ = make_serve_step(model, mesh, batch=1, max_len=ld["slots"])
    tok = torch.zeros((1,), dtype=torch.long, device=dev)
    ms, host_ms, toks, coll = [], [], [], []
    for i in range(ld["steps"]):
        parallel.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tok, n_prompt + i)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        lg = _whole(lg)
        tok = torch.argmax(lg, dim=-1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append(parallel.collective_counts())
        check(bool(torch.isfinite(lg).all()), f"long mesh: step {i} logits")
        toks.append(int(tok))
    check(all(0 <= x < cfg.vocab_size for x in toks), f"long mesh: {toks}")
    state = {"tok": tok, "cache": cache}

    def decode():
        for i in range(2):
            lg, state["cache"] = step(params, state["cache"], state["tok"],
                                      n_prompt + i)
            state["tok"] = torch.argmax(_whole(lg), dim=-1)
    trace = _trace(torch, None, "long_decode_gemma2_mesh4", decode, 2,
                   "decode step", host=False)
    rec = dict(arch=ld["arch"], mesh=ld["mesh"], layers=cfg.num_layers,
               slots=ld["slots"], slots_a_card=ld["slots"] // ld["mesh"][0],
               allocated_before_gib=before_gib,
               stored_gib=_local_gib(params), cache_gib=_local_gib(cache),
               step_ms=statistics.median(ms), step_ms_all=ms,
               step_host_ms=statistics.median(host_ms),
               decode_tokens_per_s=len(ms) / (sum(ms) / 1e3),
               collectives_per_step=coll[-1],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               outside_gib=_outside_gib(torch, dev),
               **_trace_summary(trace), tokens=toks)
    del params, cache, state
    torch.cuda.empty_cache()
    return rec


def mesh_serve_paths(torch, ops, dev, meshes, record) -> None:
    """The serve paths over a mesh, each after its 2-layer fp32 parity
    check, every kernel never launched, recorded as they end."""
    for path, sv in MESH_SERVE_PATHS.items():
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        mesh = meshes[sv["mesh"]]
        got = {"parity": mesh_parity_phase(torch, dev, mesh, sv["arch"],
                                           sv["batch"])}
        got.update(mesh_serve_phase(torch, dev, mesh, path))
        counts = ops.launch_counts()
        check(all(v == 0 for v in counts.values()),
              f"{path}: launches {counts}")
        record(path, got, t0)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    mesh = meshes[MESH_LONG["mesh"]]
    got = {"parity": mesh_long_parity(torch, dev, mesh)}
    got.update(mesh_long_phase(torch, dev, mesh))
    counts = ops.launch_counts()
    check(all(v == 0 for v in counts.values()),
          f"long_decode_gemma2_mesh4: launches {counts}")
    record("long_decode_gemma2_mesh4", got, t0)


def mesh_main() -> int:
    """``torchrun --nproc-per-node 4 chip_smoke.py --mesh``: the four-card
    checks alone, one card a rank, NCCL (and gloo for host tensors):
    :func:`mesh_serve_paths`; :func:`mesh_steps_phase`; the shard paths at world 4 (their knobs with
    32 clients a cloud, so 96 clients tile 4 ranks) and at world 3 on
    ranks 0–2 (the paper's 90), each against ``Engine.step`` on every
    rank, with each rank's kernel launches; ``MESH4_TRAIN`` at 2 and 3
    layers, then at the deepest depth the two peaks say fits. Rank 0
    writes ``chiprun_out/chip_smoke_mesh.json`` after each phase. A rank
    that fails exits non-zero, and torchrun ends the others."""
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if "LOCAL_RANK" not in os.environ:
        print("chip_smoke --mesh: run it under torchrun --nproc-per-node 4",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    from repro_torch.launch.mesh import live_mesh
    from repro_torch.sharding import MeshShape

    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("cpu:gloo,cuda:nccl")
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        check(world == 4, f"--mesh wants 4 ranks, got {world}")
        dev = resolve_device(f"cuda:{local}")
        lead = rank == 0
        out = ROOT / "chiprun_out"
        res = {"card": card_line(), "world": world,
               "devices": torch.cuda.device_count(), "phase_s": {}}
        for turn in (0, 1):              # rank 0 builds, the others load
            if (rank == 0) == (turn == 0):
                _build.build_all()
            dist.barrier()

        def record(key, value, t0):
            every = [None] * world
            dist.all_gather_object(every, value)
            res[key] = every
            res["phase_s"][key] = time.perf_counter() - t0
            if lead:
                out.mkdir(exist_ok=True)
                (out / "chip_smoke_mesh.json").write_text(json.dumps(
                    res, indent=1, default=float))
                print(f"mesh {key} ({res['phase_s'][key]:.1f} s): "
                      f"{json.dumps(value, default=float)}", flush=True)

        # one live mesh a shape for the whole run: each mesh's groups,
        # and their NCCL communicators, are made once
        meshes = {shape: live_mesh(MeshShape(("data", "model"), shape), dev)
                  for shape in ((4, 1), (2, 2), (1, 4))}
        # serving first: mistral-large's quarter a card leaves the least
        # room beside the communicators of the phases after it
        mesh_serve_paths(torch, ops, dev, meshes, record)
        t0 = time.perf_counter()
        record("steps", mesh_steps_phase(
            torch, ops, dev, {s: meshes[s] for s in ((4, 1), (2, 2))}), t0)
        for path in SHARD_PATHS:
            t0 = time.perf_counter()
            record(f"{path}_world4", shard_engine_phase(
                torch, dev, path, fl_over=dict(clients_per_cloud=32)), t0)
        peaks = {}
        cap = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
        depths = [2, 3]
        while depths:
            layers = depths.pop(0)
            t0 = time.perf_counter()
            counts, got = fl_train_path_phase(
                torch, ops, dev, f"fl_train_mixtral_mesh4_{layers}",
                dict(MESH4_TRAIN, layers=layers),
                mesh=meshes[MESH4_TRAIN["mesh"]])
            check(all(v == 0 for v in counts.values()),
                  f"mesh4 mixtral {layers} layers: launches {counts}")
            # the card's memory outside PyTorch's allocator (the NCCL
            # communicators' buffers, the CUDA context) counts too
            free, total = torch.cuda.mem_get_info(dev)
            got["outside_gib"] = (total - free
                                  - torch.cuda.memory_reserved(dev)) / 2 ** 30
            most = torch.tensor([got["peak_gib"], got["outside_gib"]],
                                device=dev)
            dist.all_reduce(most, op=dist.ReduceOp.MAX)
            peaks[layers], outside = most.tolist()
            record(f"fl_train_mixtral_mesh4_{layers}", got, t0)
            if layers == 3:
                per_layer = peaks[3] - peaks[2]
                deepest = 3 + int((cap - MESH4_HEADROOM_GIB - outside
                                   - peaks[3]) // per_layer)
                res["deepest"] = dict(layers=deepest, per_layer_gib=per_layer,
                                      card_gib=cap, outside_gib=outside,
                                      peaks=peaks)
                if deepest > 3:
                    depths.append(deepest)
        # last: rank 3 makes none of the world-3 groups, so the ranks'
        # counts of groups (which name the locally synchronized ones)
        # part here
        three = dist.new_group([0, 1, 2])
        for path in SHARD_PATHS:
            t0 = time.perf_counter()
            got = (shard_engine_phase(torch, dev, path, group=three)
                   if rank < 3 else None)
            record(f"{path}_world3", got, t0)
    finally:
        dist.destroy_process_group()
    if lead:
        print(res["card"])
        print(json.dumps({"ok": True, "mesh": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops

    dev = resolve_device("cuda")
    check_cudnn_contract(torch, "resolve_device")
    out = out_dir()
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} nvcc runs in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for stem, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    if "--profile" in sys.argv[1:]:
        prof = {path: profile_phase(torch, dev, out, path) for path in PATHS}
        prof.update(profile_serve(torch, dev, out))
        with tempfile.TemporaryDirectory() as work:
            prof["trace_labels"] = trace_labels_phase(torch, dev, Path(work))
        if out is not None:
            (out / "profile.json").write_text(json.dumps(prof, indent=1))
        print(json.dumps(prof, indent=1))
        print(card)
        return 0

    rec = kernel_phase(torch, ops, dev)
    for name, r in rec.items():
        print(f"kernel {name}: {r}", flush=True)
    worst = {path: agreement_phase(torch, dev, path) for path in PATHS}
    print(f"agreement card vs CPU over 2 small rounds: {worst}", flush=True)
    shard_vs_engine = {path: shard_engine_phase(torch, dev, path)
                       for path in SHARD_PATHS}
    print(f"shard vs round engine on the card, full width, {ROUNDS} rounds "
          f"each from the engine's state: {shard_vs_engine}", flush=True)
    worst["serve"] = serve_agreement_phase(torch, ops, dev)
    print(f"agreement card vs CPU, serve prefill + 4 decode steps (fp32, "
          f"test configuration): {worst['serve']}", flush=True)
    phase_s = {}
    t0 = time.perf_counter()
    worst["serve_dense"] = serve_agreement_phase(torch, ops, dev,
                                                 model=_dense_test_model())
    phase_s["agreement_serve_dense"] = time.perf_counter() - t0
    print(f"agreement card vs CPU, dense serve prefill + 4 decode steps "
          f"(fp32, gemma2-2b layout, softcaps on): {worst['serve_dense']} "
          f"({phase_s['agreement_serve_dense']:.1f} s)", flush=True)
    t0 = time.perf_counter()
    worst["train"] = train_agreement_phase(torch, ops, dev)
    phase_s["agreement_train"] = time.perf_counter() - t0
    print(f"agreement card vs CPU, one AdamW train step (fp32, test "
          f"configuration): {worst['train']} "
          f"({phase_s['agreement_train']:.1f} s)", flush=True)
    t0 = time.perf_counter()
    worst["fl_train"] = fl_train_agreement_phase(torch, ops, dev)
    phase_s["agreement_fl_train"] = time.perf_counter() - t0
    print(f"agreement card vs CPU, one two-phase and one fused federated "
          f"step (4 clients, 2 clouds, SGD, fp32, test configurations: "
          f"recurrentgemma, dense; then mixtral fused, rwkv6, whisper, "
          f"paligemma two-phase, paligemma fused), and two gradients of one "
          f"batch on the card leaf for leaf: "
          f"{worst['fl_train']} "
          f"({phase_s['agreement_fl_train']:.1f} s)", flush=True)
    t0 = time.perf_counter()
    worst["mesh"] = mesh_phase(torch, ops, dev)
    phase_s["agreement_mesh"] = time.perf_counter() - t0
    print(f"mesh (1, 1) of make_debug_mesh(1): the two-phase and fused "
          f"steps (rg and dense test configurations, AdamW after the clip) "
          f"equal ClientMesh(1)'s bit for bit, and make_plain_step with the "
          f"mesh equals mesh=None's: {worst['mesh']} "
          f"({phase_s['agreement_mesh']:.1f} s)", flush=True)
    for fam in FAMILY_TESTS:
        t0 = time.perf_counter()
        worst[f"family_{fam}"] = family_agreement_phase(torch, ops, dev, fam)
        phase_s[f"agreement_{fam}"] = time.perf_counter() - t0
        print(f"agreement card vs CPU, {fam} test configuration (fp32): "
              f"prefill + 4 decode steps, forward_hidden, one grad_fn, MoE "
              f"routes, encode / make_prefill_step: "
              f"{worst[f'family_{fam}']} "
              f"({phase_s[f'agreement_{fam}']:.1f} s)", flush=True)
    counts, main = {}, {}
    for path in PATHS:
        counts[path], main[path] = main_path_phase(torch, ops, dev, path)
        print(f"main path {path}: launches {counts[path]}; {main[path]}",
              flush=True)
        print(f"main path {path}: {main[path]['rounds_per_s']:.3f} rounds/s "
              f"over {ROUNDS} rounds, "
              f"{main[path]['steady_rounds_per_s']:.3f} after the first",
              flush=True)
    with tempfile.TemporaryDirectory() as work:
        tel = telemetry_phase(torch, ops, dev, Path(work))
    for path in TELEMETRY_PATHS:
        print(f"telemetry {path}: {tel[path]}", flush=True)
        counts[f"telemetry_{path}"] = tel[path]["launches"]
    counts["batch_headline"] = tel["batch"]["launches"]
    print(f"telemetry report CLI on the headline stream:\n"
          f"{tel['report'].rstrip()}", flush=True)
    b, o = tel["batch"], tel["overhead"]
    m = b["deterministic"]
    print(f"telemetry run_simulation_batch seeds=[0] vs FLServer, cuDNN as "
          f"the entry points set it (undone before each): "
          f"{m['byte_identical']} of {b['lines']} round lines "
          f"byte-identical, first differing round "
          f"{m['first_differing_round']}, floats {m['float_drift']:.3e} "
          f"apart ({m['drifted_most']})", flush=True)
    print(f"telemetry run_simulation_batch seeds=[0, 1]: totals "
          f"{b['totals']}, each seed's run equal to its own", flush=True)
    print(f"telemetry overhead ({card}): headline steady rounds/s "
          f"off/on/on/off/off/on {[round(r, 3) for _, r in o['turns']]}, "
          f"median on / median off {o['ratio']:.4f}", flush=True)
    print(f"telemetry checkpoint: {tel['checkpoint']['leaves']} leaves "
          f"restored bit for bit on the card", flush=True)
    for path, (spec, _, _) in SERVE_PATHS.items():
        t0 = time.perf_counter()
        counts[path], main[path] = serve_path_phase(torch, ops, dev, path)
        phase_s[path] = time.perf_counter() - t0
        sv = main[path]
        print(f"main path {path}: launches {counts[path]}; {sv}", flush=True)
        print(f"main path {path} ({spec['arch']}, {sv['layers']} layers, "
              f"{card}): {sv['n_params']} weights held, peak "
              f"{sv['peak_gib']:.3f} GiB, prefill of "
              f"{spec['prompt_len']} tokens {sv['prefill_ms_first']:.3f} ms "
              f"first, {sv['prefill_ms_steady']:.3f} ms steady (median of "
              f"the other {spec['requests'] - 1}), decode "
              f"{sv['decode_tokens_per_s']:.3f} tokens/s at batch 1 per "
              f"slot ({phase_s[path]:.1f} s)", flush=True)
        if path in FAMILY_SERVE:
            t0 = time.perf_counter()
            prof = main[path]["profile"] = profile_serve(torch, dev, None,
                                                         path)
            phase_s[f"{path}_profile"] = time.perf_counter() - t0
            print(f"main path {path} profile ({card}): {prof} "
                  f"({phase_s[f'{path}_profile']:.1f} s)", flush=True)
    t0 = time.perf_counter()
    path = "prefix_prefill_paligemma"
    counts[path], main[path] = prefix_prefill_phase(torch, ops, dev)
    phase_s[path] = time.perf_counter() - t0
    pf = main[path]
    print(f"main path {path}: launches {counts[path]}; {pf}", flush=True)
    print(f"main path {path} ({pf['arch']}, bf16, {card}): "
          f"make_prefill_step on {pf['rows']} x ({pf['patches']} patches + "
          f"{pf['text_tokens']} text tokens) {pf['first_ms']:.3f} ms first, "
          f"{pf['steady_ms']:.3f} ms steady (median of "
          f"{PREFIX_PREFILL['calls']}), peak {pf['peak_gib']:.3f} GiB "
          f"({phase_s[path]:.1f} s)", flush=True)
    t0 = time.perf_counter()
    counts["train"], main["train"] = train_path_phase(torch, ops, dev)
    phase_s["train"] = time.perf_counter() - t0
    tr = main["train"]
    print(f"main path train: launches {counts['train']}; {tr}", flush=True)
    print(f"main path train ({TRAIN['arch']}, fp32, {card}): losses "
          f"{[round(x, 4) for x in tr['losses']]}, step "
          f"{tr['step_ms']:.1f} ms (median of {TRAIN['steps']}), "
          f"{tr['tokens_per_s']:.1f} tokens/s, peak {tr['peak_gib']:.3f} "
          f"GiB; launches per step {tr['launches_per_step']} "
          f"({phase_s['train']:.1f} s)", flush=True)

    for path, spec in FL_TRAIN_PATHS.items():
        t0 = time.perf_counter()
        counts[path], main[path] = fl_train_path_phase(torch, ops, dev, path)
        phase_s[path] = time.perf_counter() - t0
        ft = main[path]
        print(f"main path {path}: launches {counts[path]}; {ft}", flush=True)
        print(f"main path {path} ({spec['arch']}, {ft['layers']} layers, "
              f"{spec['strategy']}, fp32, {spec['clients']} clients x "
              f"{spec['seq']} positions, {card}): losses "
              f"{[round(x, 4) for x in ft['losses']]}, step "
              f"{ft['step_ms']:.1f} ms (median of {spec['steps']}), "
              f"{ft['tokens_per_s']:.1f} client tokens/s, peak "
              f"{ft['peak_gib']:.3f} GiB; gradient evaluations per step "
              f"{ft['grad_evals_per_step']}; MoE pairs dropped per step "
              f"{ft['moe_dropped_per_step']}; gradients bit-stable "
              f"{ft['grads_bit_stable']} ({phase_s[path]:.1f} s)", flush=True)
    t0 = time.perf_counter()
    counts["fl_train_example"], main["fl_train_example"] = \
        fl_example_phase(torch, ops, dev)
    phase_s["fl_train_example"] = time.perf_counter() - t0
    ex = main["fl_train_example"]
    print(f"main path fl_train_example ({FL_EXAMPLE['steps']} steps, {card}):"
          f" {ex} ({phase_s['fl_train_example']:.1f} s)", flush=True)
    t0 = time.perf_counter()
    path = "long_decode_gemma2"
    counts[path], main[path] = long_decode_phase(torch, ops, dev)
    phase_s[path] = time.perf_counter() - t0
    ld = main[path]
    print(f"main path {path}: launches {counts[path]}; {ld}", flush=True)
    print(f"main path {path} ({ld['arch']}, {ld['layers']} layers, bf16, "
          f"{ld['a_layers']} A caches of {ld['slots']} slots, chunk "
          f"{ld['chunk']}, {card}): decode step {ld['step_ms']:.3f} ms "
          f"(median of {ld['steps']}; the whole-cache softmax "
          f"{ld['whole_cache_step_ms']:.3f} ms) against a bound of "
          f"{ld['bound_ms']:.3f} ms; peak {ld['peak_gib']:.3f} GiB; logits "
          f"vs the whole cache {max(ld['logits_rel_err']):.3e}, one fp32 "
          f"layer {ld['layer_fp32_rel_err']:.3e} "
          f"({phase_s[path]:.1f} s)", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        quick = example_quickstart_phase(torch, ops, dev, Path(work))
    phase_s["example_quickstart"] = time.perf_counter() - t0
    for path, (c, q) in quick.items():
        counts[path], main[path] = c, q
        print(f"main path {path} ({card}): launches {c}; {q}", flush=True)
    print(f"examples/quickstart_torch.py: "
          f"{phase_s['example_quickstart']:.1f} s", flush=True)
    t0 = time.perf_counter()
    path = "example_byzantine_defense"
    counts[path], main[path] = example_byzantine_phase(torch, ops, dev)
    phase_s[path] = time.perf_counter() - t0
    print(f"main path {path} ({card}): launches {counts[path]}; "
          f"{main[path]} ({phase_s[path]:.1f} s)", flush=True)
    t0 = time.perf_counter()
    path = "example_serve_batch"
    counts[path], main[path] = example_serve_batch_phase(torch, ops, dev)
    phase_s[path] = time.perf_counter() - t0
    print(f"main path {path} ({card}): launches {counts[path]}; "
          f"{main[path]} ({phase_s[path]:.1f} s)", flush=True)

    # launches: the sum over the paths' runs (each read right after its
    # path, counters reset right before); per path beside it. The fused
    # trust_stage launch computes trust_score's function on both FL paths
    # and trust_features's on the defense path: those entries take the
    # stage's numbers (scalar, multi), their standalone modes' beside them
    def launched(n, path, c):
        fused = path in FUSED_INTO_STAGE.get(n, ())
        return c[n] + (c["trust_stage"] if fused else 0)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = []
    for n in REPLACES:
        by_path = {p: launched(n, p, c) for p, c in counts.items()}
        entry = dict(
            name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
            launches=sum(by_path.values()), launches_by_path=by_path,
            **{key: rec[n][key] for key in keys},
            library_ms=rec[n]["library_ms"])
        if n in FUSED_INTO_STAGE:
            # the standalone mode's own launches (the shard paths) apart
            # from the fused stage's
            entry["launches_standalone"] = sum(c[n] for c in counts.values())
            entry["launches_fused"] = entry["launches"] - entry[
                "launches_standalone"]
            tag = "_multi" if n == "trust_features" else ""
            entry.update({f"standalone_{key}": entry[key] for key in keys})
            entry.update({key: rec["trust_stage"][key + tag] for key in keys})
        kernels.append(entry)
    for k in kernels:       # the cold-L2 time, the flat path's shape
        for extra in ("ms_cold", "flat", "row_threshold_ms", "shard", "bwd"):
            if extra in rec[k["name"]]:
                k[extra] = rec[k["name"]][extra]
        if k["name"] == "linear_scan":   # the backward's own counter
            k["launches_bwd_by_path"] = {p: c["linear_scan_bwd"]
                                         for p, c in counts.items()}
            k["launches_bwd"] = sum(k["launches_bwd_by_path"].values())
    if out is not None:
        (out / "chip_smoke.json").write_text(json.dumps(
            dict(card=card, kernels=rec, launches=counts, agreement=worst,
                 shard_vs_engine=shard_vs_engine, main_paths=main,
                 telemetry=tel, phase_s=phase_s), indent=1, default=float))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(mesh_main() if "--mesh" in sys.argv[1:] else main())
