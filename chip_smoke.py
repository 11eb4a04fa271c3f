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
   relative, then one ``make_plain_step`` with AdamW and its loss;
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
   * TRAIN: recurrentgemma-2b at full width (26 layers, fp32 weights,
     every layer rematerialized) through ``train.make_plain_step``,
     AdamW on a cosine schedule after ``clip_by_global_norm(1.0)``,
     batches of 2 x 2048 tokens from ``token_batches``; one warm-up step
     and 3 timed ones, each exactly 36 linear_scan launches (18 "R"
     layers, forward and rematerialized forward) and 18 linear_scan_bwd,
     every FL kernel never; the loss finite and lower at the last step
     than at the first; step ms, tokens/s and peak memory;
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
                                    "batch_headline"),
                    "trust_features": ("defense", "host_defense",
                                       "telemetry_defense")}
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
# (launcher arguments, weights held). recurrentgemma-2b holds w_a, w_i and
# final_norm beyond ModelConfig.param_count(); the dense archs hold
# param_count() + d_model (final_norm)
SERVE = dict(arch="recurrentgemma-2b", batch=4, requests=8, prompt_len=4096,
             gen=16, dtype="bfloat16", seed=0)
DENSE_SERVE = dict(SERVE, batch=2, requests=4)   # half the traffic
SERVE_PATHS = {
    "serve": (SERVE, 2_894_435_840),
    "serve_gemma2": (dict(DENSE_SERVE, arch="gemma2-2b"),
                     2_614_219_776 + 2304),
    "serve_danube": (dict(DENSE_SERVE, arch="h2o-danube-3-4b"),
                     3_838_955_520 + 3840),
    "serve_granite": (dict(DENSE_SERVE, arch="granite-3-8b"),
                      8_170_844_160 + 4096),
}
# the train path: recurrentgemma-2b at full width in fp32, every layer
# rematerialized, AdamW on a cosine schedule after global-norm clipping,
# batches of 2 x 2048 tokens from the token stream; one warm-up step,
# then STEPS timed ones
TRAIN = dict(arch="recurrentgemma-2b", batch=2, seq=2048, warmup=1, steps=3,
             lr=3e-4, clip=1.0, loss_chunk=512, stream_tokens=50_000, seed=0)


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


def shard_engine_phase(torch, dev, path: str):
    """The sharded engine (``path``'s, world size 1 on NCCL) against the
    round engine's ``Engine.step`` on the card at full width, ``ROUNDS``
    rounds, each from the round engine's state of the round before and on
    one set of own-mode draws (the wire noise materialized), with cuDNN
    on its deterministic algorithms as ``resolve_device`` sets them:
    masks and float64 bytes and $ exact; reputation, params and
    separability within 1e-4 relative.
    Returns the worst drifts (the residuals' too, unchecked)."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import engine as engine_mod
    from repro_torch.federated import sharded
    from repro_torch.federated.simulation import make_data, make_topology

    knobs, _, engine, _ = PATHS[path]
    check(engine == "shard", f"{path} is not a shard path")
    fl = FLConfig(**knobs)
    topo = make_topology(fl)
    data = make_data(fl)
    sharded.ensure_group(dev)
    eng = engine_mod.Engine(engine_mod.static_from(
        fl, topo, fl.aggregator, input_shape=tuple(data.client_x.shape[2:]),
        n_classes=data.n_classes), dev)
    shard = sharded.engine_for(fl, topo, data, fl.aggregator, device=dev)
    full = engine_mod.make_client_data(fl, topo, data, 0, device=dev)
    cd = shard.stage_data(full)
    worst = {k: 0.0 for k in ("rep", "params", "feat_sep", "res_client",
                              "res_edge")}
    state = eng.init_state(0)
    for t in range(ROUNDS):
        draws = eng.draws(0, t, full, full_noise=True)
        # the shard first: Engine.step updates res_client in place
        b, ob = shard.step(state, cd, t, draws)
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
                ("res_client", b.res_client, state.res_client),
                ("res_edge", b.res_edge, state.res_edge)):
            if y.numel():
                worst[name] = max(worst[name], rel_err(torch, x, y))
    end_group()
    checked = {k: worst[k] for k in ("rep", "params", "feat_sep")}
    check(max(checked.values()) <= 1e-4, f"{path}: shard vs round engine "
          f"drift {checked} > 1e-4")
    return worst


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
    version), from the same weights and prompts; ``model`` defaults to
    recurrentgemma-2b's test configuration."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map

    model = model or _serve_test_model()
    cfg = model.cfg
    cpu = torch.device("cpu")
    p_cpu = model.init(0, device=cpu)
    tokens = model.dummy_batch(0, 2, t)["tokens"]

    def run(d, params):
        before = ops.linear_scan.launches
        logits, cache = model.prefill(params, {"tokens": tokens.to(d)},
                                      max_len)
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


def serve_path_phase(torch, ops, dev, path: str = "serve"):
    """``launch.serve.serve`` at full width (``SERVE_PATHS[path]``), the
    launch counters reset just before and read just after: linear_scan
    once per "R" layer per prefill, every other kernel never (a dense arch
    launches none); the weights held as stated; peak memory, prefill ms
    and decode tokens/s."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import serve

    sv, held = SERVE_PATHS[path]
    cfg = get_arch(sv["arch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve(sv["arch"], batch=sv["batch"], requests=sv["requests"],
                prompt_len=sv["prompt_len"], gen=sv["gen"], device=dev,
                dtype=sv["dtype"], seed=sv["seed"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = {n: 0 for n in counts}
    want["linear_scan"] = sv["requests"] * cfg.layer_types().count("R")
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
        arch=sv["arch"], n_params=res.n_params,
        analytic_param_count=cfg.param_count(),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        init_s=res.init_s, wall_s=wall_s, prefill_ms=prefill_ms,
        prefill_ms_first=prefill_ms[0],
        prefill_ms_steady=statistics.median(prefill_ms[1:]),
        decode_steps=res.decode_steps, decode_s=res.decode_s,
        decode_tokens_per_s=res.decode_tokens_per_s,
        tokens={r.rid: r.generated for r in res.requests})


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
_GROUPS = (("port kernels", ("trust_stage_kernel", "weighted_agg_kernel",
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


def _trace(torch, out, name: str, run, n: int, unit: str):
    """Run ``run()`` (``n`` units of work) under ``torch.profiler`` and
    report, per unit, the device's busy time by kernel group and by
    round phase, its idle share of the host-clock wall time and the top
    kernels; writes the Chrome trace to ``out``/trace_<name>.json when
    ``out`` is given."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def profile_serve(torch, dev, out):
    """``--profile``: the serve path at full width — one steady prefill
    of a 4096-token prompt (after a warm-up prefill and 2 decode steps)
    and then ``SERVE["gen"]`` decode steps, traced apart (figures per
    prefill and per decode step)."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm

    model = build_model(SERVE["arch"])
    params = model.init(SERVE["seed"], device=dev, dtype=SERVE["dtype"])
    t, gen = SERVE["prompt_len"], SERVE["gen"]
    max_len = t + gen
    tokens = model.dummy_batch(0, 1, t, device=dev)["tokens"]
    logits, cache = model.prefill(params, {"tokens": tokens}, max_len)
    for i in range(2):
        logits, cache = tfm.decode_step(params, model.cfg, cache,
                                        torch.argmax(logits, -1), t + i)
    state = {}

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, {"tokens": tokens}, max_len)

    def decode():
        logits, cache = state["logits"], state["cache"]
        for i in range(gen):
            logits, cache = tfm.decode_step(params, model.cfg, cache,
                                            torch.argmax(logits, -1), t + i)
    return {"serve_prefill": _trace(torch, out, "serve_prefill", prefill, 1,
                                    f"prefill of {t} tokens"),
            "serve_decode": _trace(torch, out, "serve_decode", decode, gen,
                                   "decode step")}


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
    for path, (spec, _) in SERVE_PATHS.items():
        t0 = time.perf_counter()
        counts[path], main[path] = serve_path_phase(torch, ops, dev, path)
        phase_s[path] = time.perf_counter() - t0
        sv = main[path]
        print(f"main path {path}: launches {counts[path]}; {sv}", flush=True)
        print(f"main path {path} ({spec['arch']}, {card}): {sv['n_params']} "
              f"weights held, peak {sv['peak_gib']:.3f} GiB, prefill of "
              f"{spec['prompt_len']} tokens {sv['prefill_ms_first']:.3f} ms "
              f"first, {sv['prefill_ms_steady']:.3f} ms steady (median of "
              f"the other {spec['requests'] - 1}), decode "
              f"{sv['decode_tokens_per_s']:.3f} tokens/s at batch 1 per "
              f"slot ({phase_s[path]:.1f} s)", flush=True)
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
    sys.exit(main())
