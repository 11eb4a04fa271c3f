#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises on failure (the script then exits non-zero):

1. card: print the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (timed; registers and spills from ptxas);
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes (exact for topk_mask and stochastic_quantize,
   1e-5 in fp32 and 5e-2 in bf16 for the others), then device times
   (CUDA graph replays between CUDA events, median of repeats) of the
   kernel's wrapper, the plain version and, where one PyTorch call
   computes the same function, that call (a yardstick the port never
   calls), and the wrapper's eager time from Python (``call_ms``, launch
   overhead included);
4. agreement: two rounds of each path at a small configuration on the
   card against the same rounds on the CPU (plain versions), from one
   initial state and one set of draws — masks and bytes exact,
   reputation and params (and, on the defense path, the feature
   separability) within 1e-4 relative;
5. main paths, each five rounds of ``FLServer.run_round`` (the loop
   ``run_simulation`` runs) at full width — 3 clouds x 30 clients, 30
   selected, the paper's CNN (D = 545,098) — with every launch counter
   reset just before the path and read just after it:
   * HEADLINE (README): label_flip, top-k 0.1 on cross-cloud links;
     trust_score, weighted_agg and topk_mask once per round, the QSGD
     and feature kernels never;
   * DEFENSE (README "Multi-feature Byzantine defense"): alie_norm,
     the multi-feature gate, QSGD (15 levels) on every client and edge
     uplink; trust_score, weighted_agg and trust_features once per
     round, stochastic_quantize twice (client wire, edge wire), topk_mask
     never; feature weights finite and summing to 1, residuals finite;
   params finite; bytes and $ equal the cost model's for each delivered
   mask; then the test accuracy and rounds/s of each path.

Prints one ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
"device": ...}`` line. Exits non-zero without a CUDA device, and when
``src/repro_torch`` is not beside this script.

    python3 chip_smoke.py --profile  # build, then trace 2 steady rounds

traces two rounds of each path with ``torch.profiler`` and prints where
the device time goes (kernel groups, top kernels, idle share of the wall
time) instead of running the checks. ``--out DIR``
also writes the details (``chip_smoke.json``; with ``--profile``,
``profile.json`` and the Chrome trace ``round_trace.json``) into DIR.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ROUNDS = 5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12               # H100 SXM fp32, outside the tensor cores
REPLACES = {
    "trust_score": "src/repro/kernels/trust_score.py:76",
    "weighted_agg": "src/repro/kernels/weighted_agg.py:40",
    "topk_mask": "src/repro/kernels/topk_mask.py:48",
    "stochastic_quantize": "src/repro/kernels/quantize.py:58",
    "trust_features": "src/repro/kernels/trust_features.py:92",
}
# the test suite's small topology at the same headline knobs
SMALL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
             local_epochs=1, local_batch=8, ref_samples=16)
HEADLINE = dict(attack="label_flip", malicious_frac=0.3, compressor="topk",
                compress_ratio=0.1, link_policy="cross_only")
DEFENSE = dict(attack="alie_norm", malicious_frac=0.3, trust_features="multi",
               compressor="qsgd", qsgd_levels=15, link_policy="all")
# launches per round of each kernel on each path (0: never)
PATHS = {
    "headline": (HEADLINE, dict(trust_score=1, weighted_agg=1, topk_mask=1,
                                stochastic_quantize=0, trust_features=0)),
    "defense": (DEFENSE, dict(trust_score=1, weighted_agg=1, topk_mask=0,
                              stochastic_quantize=2, trust_features=1)),
}


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
        shape=f"G ({k}, {D}) f32, fp16 round trip fused")

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
    return rec


def state_to(state, dev):
    """A RoundState with every tensor moved to ``dev``."""
    return state._replace(
        params={k: v.to(dev) for k, v in state.params.items()},
        **{f: getattr(state, f).to(dev) for f in state._fields
           if f not in ("params", "seed")})


def agreement_phase(torch, dev, path: str):
    """Two small rounds of ``path`` on the card (kernels) against the CPU
    (plain versions) from one state and one set of draws (the CPU's,
    wire noise included)."""
    import numpy as np
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import engine as engine_mod
    from repro_torch.federated.simulation import make_data, make_topology

    fl = FLConfig(**SMALL, **PATHS[path][0])
    topo = make_topology(fl)
    data = make_data(fl, n_samples=600, samples_per_client=16)
    static = engine_mod.static_from(fl, topo)
    cpu = torch.device("cpu")
    engs = {d: engine_mod.Engine(static, d) for d in (cpu, dev)}
    cds = {d: engine_mod.make_client_data(fl, topo, data, 0, device=d)
           for d in engs}
    s_cpu = engs[cpu].init_state(0)
    states = {cpu: s_cpu, dev: state_to(s_cpu, dev)}

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b).clamp(min=1e-30))

    worst = {"rep": 0.0, "params": 0.0, "feat_sep": 0.0}
    for t in range(2):
        draws = engs[cpu].draws(0, t, cds[cpu], full_noise=True)
        outs = {}
        for d, eng in engs.items():
            states[d], outs[d] = eng.step(states[d], cds[d], t, draws)
        mask_c = outs[cpu].delivered.numpy()
        mask_g = outs[dev].delivered.cpu().numpy()
        check(np.array_equal(mask_c, mask_g),
              f"{path} round {t}: masks differ")
        check(np.array_equal(engs[cpu].host_round_accounting(mask_c[None]),
                             engs[dev].host_round_accounting(mask_g[None])),
              f"{path} round {t}: bytes/$ differ")
        worst["rep"] = max(worst["rep"], rel(states[dev].rep_ema,
                                             states[cpu].rep_ema))
        worst["feat_sep"] = max(worst["feat_sep"], rel(
            states[dev].feat_sep, states[cpu].feat_sep))
        flat = [torch.cat([s.params[k].reshape(-1).cpu()
                           for k in sorted(s.params)])
                for s in (states[dev], states[cpu])]
        worst["params"] = max(worst["params"], rel(*flat))
    check(max(worst.values()) <= 1e-4,
          f"{path}: card vs CPU drift {worst} > 1e-4")
    return worst


def main_path_phase(torch, ops, dev, path: str):
    """``ROUNDS`` full-width rounds of ``path`` through ``FLServer``, the
    launch counters reset just before and read just after."""
    import math

    import numpy as np
    from repro_torch.compress.topk import TopKCodec
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.cost import CostModel
    from repro_torch.federated import FLServer, make_data, make_topology

    knobs, per_round = PATHS[path]
    fl = FLConfig(**knobs)
    topo = make_topology(fl)
    t0 = time.perf_counter()
    data = make_data(fl)
    server = FLServer(fl, topo, data, seed=0, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    d = server.d_params
    check(d == 545_098, f"D = {d}, expected the paper CNN's 545,098")
    cm = CostModel(fl.c_intra, fl.c_cross)
    if path == "headline":      # top-k on the cross-cloud edge uplinks
        client_pl = np.full(topo.n_clients, 4.0 * d)
        edge_pl = np.full(topo.n_clouds,
                          float(TopKCodec(fl.compress_ratio).payload_bytes(d)))
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
        check(int(sel.sum()) == fl.clients_per_round,
              f"{path} round {t}: {int(sel.sum())} selected")
        ib, cb = cm.round_bytes(topo, sel, d, client_payload=client_pl,
                                edge_payload=edge_pl)
        cost = cm.round_cost(topo, sel, d, client_payload=client_pl,
                             edge_payload=edge_pl)
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
    state = server.round_state
    for name in ("rep_ema", "res_client", "res_edge", "feat_sep"):
        check(bool(torch.isfinite(getattr(state, name)).all()),
              f"{path}: {name} not finite")
    acc = server.evaluate()
    check(0.0 <= acc <= 1.0, f"{path}: accuracy {acc}")
    return counts, dict(setup_s=setup_s, round_s=round_s,
                        rounds_per_s=ROUNDS / sum(round_s),
                        steady_rounds_per_s=(ROUNDS - 1) / sum(round_s[1:])
                        if ROUNDS > 1 else None,
                        final_accuracy=acc, total_cost=server.cum_cost,
                        cross_bytes=server.cum_cross_bytes,
                        intra_bytes=server.cum_intra_bytes)


# first match wins: cuDNN's implicit-GEMM convolutions also say "gemm"
_GROUPS = (("port kernels", ("trust_score_kernel", "weighted_agg_kernel",
                             "topk_mask_kernel", "quantize_kernel",
                             "trust_features_kernel")),
           ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                            "Wgrad", "winograd", "implicit")),
           ("matmul", ("gemm", "Gemm", "cutlass")),
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


def profile_phase(torch, dev, out, path: str, rounds: int = 2):
    """``--profile``: trace ``rounds`` steady rounds of ``path`` with
    ``torch.profiler`` (after 2 warm-up rounds) and report the device's
    busy time by kernel group, its idle share of the host-clock wall
    time, and the top kernels; writes the Chrome trace to
    ``out``/round_trace_<path>.json when ``out`` is given."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import FLServer, make_data, make_topology

    fl = FLConfig(**PATHS[path][0])
    server = FLServer(fl, make_topology(fl), make_data(fl), seed=0,
                      device=dev)
    for t in range(2):
        server.run_round(t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2, 2 + rounds):
            server.run_round(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(kern), "the profiler recorded no device kernel")
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kern:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    groups = defaultdict(float)
    for name, (us, _) in by_name.items():
        group = next((g for g, keys in _GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] += us / rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    if out is not None:
        prof.export_chrome_trace(str(out / f"round_trace_{path}.json"))
    return dict(rounds=rounds, wall_ms_per_round=wall_us / rounds / 1e3,
                busy_ms_per_round=busy_us / rounds / 1e3,
                idle_share=1.0 - busy_us / wall_us,
                kernels_per_round=len(kern) / rounds,
                group_ms_per_round={g: us / 1e3 for g, us in groups.items()},
                top=[dict(name=n[:120], ms_per_round=us / rounds / 1e3,
                          launches_per_round=c / rounds)
                     for n, (us, c) in top])


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
    counts, main = {}, {}
    for path in PATHS:
        counts[path], main[path] = main_path_phase(torch, ops, dev, path)
        print(f"main path {path}: launches {counts[path]}; {main[path]}",
              flush=True)
        print(f"main path {path}: {main[path]['rounds_per_s']:.3f} rounds/s "
              f"over {ROUNDS} rounds, "
              f"{main[path]['steady_rounds_per_s']:.3f} after the first",
              flush=True)

    # launches: the sum over the paths' runs (each read right after its
    # path, counters reset right before); per path beside it
    kernels = [dict(name=n, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{n}.cu",
                    replaces=REPLACES[n],
                    launches=sum(c[n] for c in counts.values()),
                    launches_by_path={p: c[n] for p, c in counts.items()},
                    max_abs_err=rec[n]["max_abs_err"], ms=rec[n]["ms"],
                    plain_ms=rec[n]["plain_ms"], bound_ms=rec[n]["bound_ms"],
                    bound_by=rec[n]["bound_by"],
                    library_ms=rec[n]["library_ms"])
               for n in REPLACES]
    if out is not None:
        (out / "chip_smoke.json").write_text(json.dumps(
            dict(card=card, kernels=rec, launches=counts, agreement=worst,
                 main_paths=main), indent=1, default=float))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
