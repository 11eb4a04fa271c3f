"""The port's four user-facing examples (``examples/*_torch.py``) against
the reference's (``examples/*.py``, loaded by path):

* ``cost_report``: the FL wire table byte for byte, and ``main`` on two
  dry-run records written here and on a recorded ``--events`` stream
  printing the reference's output;
* ``quickstart`` and ``byzantine_defense``: the ``FLConfig``, methods,
  scenarios, rounds and ``eval_every`` each passes to ``run_simulation``
  / ``compare_methods``, captured in both packages by replacing those in
  the example's namespace (no engine runs), field by field, and the
  table each prints from the same accuracies; then the port's example
  for real on the CPU, 1 round on images cropped to 8 x 8 (the paper's
  CNN at a narrow width, as the telemetry tests crop);
* ``serve_batch``: reduced gemma2-2b at batch 2, an 8-token prompt and 8
  greedy steps, the reference's weights carried to the port with
  ``convert.model_params_from_numpy`` and one seeded numpy prompt given
  to both: the sample token ids line is the reference's.
"""
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.model import Model as JModel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.federated import simulation
from repro_torch.models.model import Model
from repro_torch.telemetry import report

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_ref(mod, argv, monkeypatch, capsys) -> str:
    """The reference example's ``main`` on ``argv`` (it parses
    ``sys.argv``); its standard output."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    mod.main()
    return capsys.readouterr().out


def _run_port(mod, argv, capsys):
    capsys.readouterr()
    res = mod.main(list(argv))
    return res, capsys.readouterr().out


# ---------------------------------------------------------------------------
# cost_report

def _dryrun_records(d: Path) -> None:
    """Two ``*pod2*`` records the reference's dry run would write, one
    that failed, and one of another mesh (skipped by the glob)."""
    recs = {
        "gemma2-2b_train_4k_pod2.json": dict(
            status="ok", arch="gemma2-2b", shape="train_4k", chips=512,
            cross_pod_bytes_per_device=123_456_789,
            collective_bytes_per_device=9_876_543_210),
        "mixtral-8x7b_decode_32k_pod2.json": dict(
            status="ok", arch="mixtral-8x7b", shape="decode_32k", chips=256,
            cross_pod_bytes_per_device=55_555_555,
            collective_bytes_per_device=777_777_777),
        "granite-3-8b_prefill_32k_pod2.json": dict(
            status="error", arch="granite-3-8b", shape="prefill_32k"),
        "gemma2-2b_train_4k_pod1.json": dict(
            status="ok", arch="gemma2-2b", shape="train_4k", chips=256,
            cross_pod_bytes_per_device=1, collective_bytes_per_device=2),
    }
    for name, r in recs.items():
        (d / name).write_text(json.dumps(r))


def test_cost_report_matches_reference(tmp_path, monkeypatch, capsys):
    ref, port = _load("cost_report"), _load("cost_report_torch")
    assert port.fl_breakdown() == ref.fl_breakdown()
    assert port.fl_breakdown(4, 5, 1234) == ref.fl_breakdown(4, 5, 1234)
    _dryrun_records(tmp_path)
    for argv, n_rows in ((["--dir", str(tmp_path)], 2),
                         (["--dir", str(tmp_path), "--steps-per-round",
                           "3"], 2),
                         (["--dir", str(tmp_path / "none")], 0)):
        want = _run_ref(ref, argv, monkeypatch, capsys)
        rows, got = _run_port(port, argv, capsys)
        assert got == want, argv
        assert len(rows) == n_rows
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps(e) + "\n"
                              for e in port.fl_policy_events(3, 4, 10_000)))
    want = _run_ref(ref, ["--events", str(events)], monkeypatch, capsys)
    rows, got = _run_port(port, ["--events", str(events)], capsys)
    assert got == want and len(rows) == len(port.POLICIES)


# ---------------------------------------------------------------------------
# quickstart and byzantine_defense: what they pass, and their tables

def _fake_result(fl, method, scenario=None):
    """A run's result, a deterministic function of what was asked."""
    n = fl.n_clouds * fl.clients_per_cloud
    malicious = np.arange(n) % 3 == 0
    acc = (len(method) + len(getattr(scenario, "name", "") or "")) / 40.0
    return SimpleNamespace(final_accuracy=acc, total_cost=0.25 + acc,
                           reputation=np.linspace(0.01, 0.1, n),
                           malicious=malicious)


def _capture_run_simulation(mod, monkeypatch):
    calls = []

    def fake(fl, **kw):
        calls.append((dataclasses.asdict(fl), kw))
        return _fake_result(fl, kw["method"])
    monkeypatch.setattr(mod, "run_simulation", fake)
    return calls


@pytest.mark.parametrize("argv", [[], ["--trust-features", "multi",
                                       "--rounds", "4", "--attack",
                                       "gaussian", "--malicious", "0.2"]])
def test_quickstart_passes_what_the_reference_passes(argv, monkeypatch,
                                                     capsys):
    ref, port = _load("quickstart"), _load("quickstart_torch")
    ref_calls = _capture_run_simulation(ref, monkeypatch)
    port_calls = _capture_run_simulation(port, monkeypatch)
    want = _run_ref(ref, argv, monkeypatch, capsys)
    _, got = _run_port(port, argv + ["--device", "cpu"], capsys)
    assert len(port_calls) == len(ref_calls) == 2
    for (pfl, pkw), (rfl, rkw) in zip(port_calls, ref_calls):
        assert pfl == rfl
        assert pkw.pop("device") == torch.device("cpu")
        assert pkw == rkw
    # the summary lines are the reference's (the header names the device)
    assert got.splitlines()[1:] == want.splitlines()[1:]


def _capture_compare_methods(mod, monkeypatch):
    calls = []

    def fake(fl, methods, *, scenario=None, rounds=30, **kw):
        calls.append((dataclasses.asdict(fl), list(methods), scenario.name,
                      scenario.level, rounds, kw))
        return {m: _fake_result(fl, m, scenario) for m in methods}
    monkeypatch.setattr(mod, "compare_methods", fake)
    return calls


@pytest.mark.parametrize("argv", [["--static", "--rounds", "2"], []])
def test_byzantine_defense_passes_what_the_reference_passes(
        argv, monkeypatch, capsys):
    ref, port = _load("byzantine_defense"), _load("byzantine_defense_torch")
    assert port.METHODS == ref.METHODS
    ref_calls = _capture_compare_methods(ref, monkeypatch)
    port_calls = _capture_compare_methods(port, monkeypatch)
    want = _run_ref(ref, argv, monkeypatch, capsys)
    res, got = _run_port(port, argv + ["--device", "cpu"], capsys)
    assert len(port_calls) == len(ref_calls) == (4 if argv else 13)
    for p, r in zip(port_calls, ref_calls):
        assert p[:5] == r[:5]
        assert p[5] == {"device": torch.device("cpu")} and r[5] == {}
    assert got == want
    assert res["scenarios"] == [c[2] for c in ref_calls]


def _narrow_data(monkeypatch):
    """``make_data`` as the simulation calls it, every image cropped to
    its top-left 8 x 8 pixels."""
    real = simulation.make_data

    def narrow(*a, **kw):
        data = real(*a, **kw)
        crop = lambda x: np.ascontiguousarray(x[..., :8, :8, :])
        return dataclasses.replace(data, client_x=crop(data.client_x),
                                   ref_x=crop(data.ref_x),
                                   test_x=crop(data.test_x))
    monkeypatch.setattr(simulation, "make_data", narrow)


def test_quickstart_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    _narrow_data(monkeypatch)
    events = tmp_path / "events.jsonl"
    res, out = _run_port(_load("quickstart_torch"),
                         ["--rounds", "1", "--device", "cpu",
                          "--telemetry", str(events)], capsys)
    for r in (res["ours"], res["base"]):
        assert r.rounds == [1] and math.isfinite(r.final_accuracy)
        assert math.isfinite(r.total_cost) and r.total_cost > 0
    assert res["ours"].method == "cost_trustfl"
    assert res["base"].method == "fedavg"
    assert math.isfinite(res["honest_rep"] + res["malicious_rep"])
    assert "cost reduction" in out and f"telemetry: {events}" in out
    assert report.main([str(events), "--validate-only"]) == 0
    rounds = [e for e in report.load_events(events) if e["event"] == "round"]
    assert [e["method"] for e in rounds] == ["cost_trustfl", "fedavg"]


def test_byzantine_defense_runs_on_the_cpu(monkeypatch, capsys):
    _narrow_data(monkeypatch)
    res, out = _run_port(_load("byzantine_defense_torch"),
                         ["--static", "--rounds", "1", "--device", "cpu"],
                         capsys)
    table = res["table"]
    assert len(table) == 5 * 4
    assert all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in table.values())
    assert "Test accuracy" in out and "cost_trustfl" in out


# ---------------------------------------------------------------------------
# serve_batch

def test_serve_batch_tokens_match_reference(monkeypatch, capsys):
    arch, batch, prompt_len, gen = "gemma2-2b", 2, 8, 8
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    monkeypatch.setattr(JModel, "init", lambda self, key, **kw: jparams)
    monkeypatch.setattr(JModel, "dummy_batch",
                        lambda self, key, batch, seq:
                        {"tokens": jnp.asarray(prompt)})
    monkeypatch.setattr(Model, "init", lambda self, seed=0, **kw: tparams)
    monkeypatch.setattr(
        Model, "dummy_batch", lambda self, seed, batch, seq, device="cpu":
        {"tokens": torch.tensor(prompt).long().to(device)})
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len",
            str(prompt_len), "--gen", str(gen)]
    want = _run_ref(_load("serve_batch"), argv, monkeypatch, capsys)
    res, got = _run_port(_load("serve_batch_torch"),
                         argv + ["--device", "cpu"], capsys)

    def ids(out: str) -> str:
        return next(line for line in out.splitlines()
                    if line.startswith("sample token ids:"))
    assert ids(got) == ids(want)
    assert res["tokens"].shape == (batch, gen + 1)
    assert "(KV)" in got
