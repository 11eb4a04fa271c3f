"""The port's public names that the reference's users and examples call,
each against the reference's (``repro``) on the same inputs:

* ``configs``: ``ARCH_IDS`` (in order), ``ALL_ARCH_MODULES``,
  ``list_arches()``, ``LONG_CONTEXT_SKIP`` and ``shape_applicable`` for
  every (arch, shape);
* ``CloudTopology.clients_in`` and ``CostModel.client_unit_costs``,
  ``bytes_per_round`` and ``collective_egress_dollars`` on random
  topologies and payloads, exactly (both float64 numpy);
* ``core.attacks``: ``ATTACKS``, an attack registered by a user run by
  ``apply_update_attack`` (with and without ``valid``), ``flip_labels``'
  semantics;
* ``compress``: top-k ``encode`` (values and indices equal to
  ``lax.top_k``'s, on random rows and on exact ties), QSGD ``encode`` on
  the reference's per-sender noise (``q`` and ``scale`` exactly),
  ``decode(encode(x))`` against ``roundtrip(x)``, ``nbytes_per_row``,
  ``register_codec``/``make_codec`` and ``policy_from_flcfg``;
* ``models.common.act_fn`` and ``models.transformer.layer_signature``;
* the serve launcher's default arch against the reference's (read from
  ``src/repro/launch/serve.py`` with ``ast``: the reference's ``main``
  parses ``sys.argv`` and imports JAX inside).
"""
import ast
import inspect
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.compress import make_codec as jmake_codec
from repro.compress import policy_from_flcfg as jpolicy_from_flcfg
from repro.configs.base import FLConfig as JFLConfig
from repro.core import attacks as jattacks
from repro.core.cost import CostModel as JCostModel
from repro.core.fl_types import CloudTopology as JTopology
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import repro_torch.configs as configs
from repro_torch.compress import (Codec, CompressedUpdate, QSGDCodec,
                                  TopKCodec, make_codec, policy_from_flcfg,
                                  register_codec)
from repro_torch.compress import base as cbase
from repro_torch.compress import policy as cpolicy
from repro_torch.configs.base import FLConfig
from repro_torch.core import attacks
from repro_torch.core.cost import CostModel
from repro_torch.core.fl_types import CloudTopology
from repro_torch.launch import serve as serve_mod
from repro_torch.models import common
from repro_torch.models import transformer as tfm

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# configs

def test_arch_registry_names_match_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert [m.CONFIG.name for m in configs.ALL_ARCH_MODULES] == \
        list(jconfigs.ARCH_IDS)
    assert configs.list_arches() == jconfigs.list_arches()
    assert configs.base.list_arches() == jconfigs.base.list_arches()
    assert configs.LONG_CONTEXT_SKIP == jconfigs.LONG_CONTEXT_SKIP
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for arch in configs.ARCH_IDS:
        for shape in list(configs.SHAPES) + ["no_such_shape"]:
            assert (configs.shape_applicable(arch, shape)
                    == jconfigs.shape_applicable(arch, shape)), (arch, shape)


# ---------------------------------------------------------------------------
# topology and cost

def _topologies():
    rng = np.random.default_rng(0)
    out = [(CloudTopology.even(3, 4), JTopology.even(3, 4)),
           (CloudTopology.even(4, 2, aggregator_cloud=2),
            JTopology.even(4, 2, aggregator_cloud=2))]
    for _ in range(4):
        k = int(rng.integers(2, 6))
        cloud_of = rng.integers(0, k, int(rng.integers(5, 30)))
        agg = int(rng.integers(0, k))
        out.append((CloudTopology(cloud_of, k, agg),
                    JTopology(cloud_of, k, agg)))
    return out


def test_clients_in_matches_reference():
    for topo, jtopo in _topologies():
        for k in range(topo.n_clouds + 1):
            got, want = topo.clients_in(k), jtopo.clients_in(k)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_cost_model_methods_match_reference_exactly():
    rng = np.random.default_rng(1)
    for i, (topo, jtopo) in enumerate(_topologies()):
        cm = CostModel(c_intra=0.01 * (i + 1), c_cross=0.09,
                       bytes_per_param=4)
        jcm = JCostModel(c_intra=0.01 * (i + 1), c_cross=0.09,
                         bytes_per_param=4)
        got, want = cm.client_unit_costs(topo), jcm.client_unit_costs(jtopo)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        sel = rng.random(topo.n_clients) < 0.6
        d = int(rng.integers(1, 10**6))
        payloads = [dict(),
                    dict(client_payload=float(rng.integers(1, 10**5))),
                    dict(client_payload=rng.integers(1, 10**5,
                                                     topo.n_clients),
                         edge_payload=rng.integers(1, 10**5,
                                                   topo.n_clouds))]
        for kw in payloads:
            for hier in (True, False):
                assert (cm.bytes_per_round(topo, sel, d, hierarchical=hier,
                                           **kw)
                        == jcm.bytes_per_round(jtopo, sel, d,
                                               hierarchical=hier, **kw))
        for b in (0, 1, 12_345_678, int(rng.integers(1, 2**40))):
            assert (cm.collective_egress_dollars(b)
                    == jcm.collective_egress_dollars(b))


# ---------------------------------------------------------------------------
# attacks

def test_attack_names_match_reference():
    assert attacks.ATTACKS == jattacks.ATTACKS
    assert set(attacks.UPDATE_ATTACKS) >= set(attacks.ATTACKS)


def test_registered_attack_runs_through_apply_update_attack(monkeypatch):
    """One attack registered in both packages (the malicious rows set to
    −scale·(mean + z), the mean over the malicious rows that delivered),
    with the reference's adapter signature; ``apply_update_attack`` runs
    it in both, with and without ``valid``."""
    def port_fn(u, m, noise, *, sigma, scale, z, valid=None):
        w = (m if valid is None else m & valid).to(u.dtype)
        mean = (w @ u) / torch.clamp(w.sum(), min=1.0)
        return torch.where(m[:, None], -scale * (mean + z), u)

    def ref_fn(u, m, key, *, sigma, scale, z, valid=None):
        w = (m if valid is None else m & valid).astype(u.dtype)
        mean = (w @ u) / jnp.maximum(w.sum(), 1.0)
        return jnp.where(m[:, None], -scale * (mean + z), u)

    monkeypatch.setitem(attacks.UPDATE_ATTACKS, "pull_back", None)
    monkeypatch.setitem(jattacks.UPDATE_ATTACKS, "pull_back", None)
    attacks.register_update_attack("pull_back", port_fn)
    jattacks.register_update_attack("pull_back", ref_fn)
    assert attacks.UPDATE_ATTACKS["pull_back"] is port_fn
    rng = np.random.default_rng(2)
    u = rng.standard_normal((7, 33)).astype(np.float32)
    m = np.array([1, 0, 1, 0, 0, 1, 0], bool)
    valid = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    for v in (None, valid):
        got = attacks.apply_update_attack(
            "pull_back", torch.tensor(u), torch.tensor(m), None, scale=3.0,
            z=0.5, valid=None if v is None else torch.tensor(v))
        want = jattacks.apply_update_attack(
            "pull_back", jnp.asarray(u), jnp.asarray(m),
            jax.random.PRNGKey(0), scale=3.0, z=0.5,
            valid=None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(got.numpy()[m], u[m])

    def old_style(u, m, noise, *, sigma, scale, z):    # no ``valid``
        return torch.where(m[:, None], torch.zeros_like(u), u)
    attacks.register_update_attack("pull_back", old_style)
    got = attacks.apply_update_attack("pull_back", torch.tensor(u),
                                      torch.tensor(m))
    assert np.array_equal(got.numpy()[m], np.zeros_like(u[m]))
    assert np.array_equal(got.numpy()[~m], u[~m])
    with pytest.raises(ValueError, match="unknown attack 'nope'"):
        attacks.apply_update_attack("nope", torch.tensor(u), torch.tensor(m))


def test_flip_labels_semantics_match_reference():
    """Masked labels move by an offset in [1, n_classes) mod n_classes,
    the others stay, in both packages; the offsets cover the whole range
    and a seeded generator repeats them."""
    n, c = 4000, 10
    rng = np.random.default_rng(3)
    labels = rng.integers(0, c, n)
    mask = rng.random(n) < 0.5
    gen = torch.Generator().manual_seed(0)
    got = attacks.flip_labels(torch.tensor(labels), c, torch.tensor(mask),
                              gen).numpy()
    again = attacks.flip_labels(torch.tensor(labels), c, torch.tensor(mask),
                                torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jattacks.flip_labels(
        jnp.asarray(labels), c, jnp.asarray(mask), jax.random.PRNGKey(0)))
    assert np.array_equal(got, again)
    for out in (got, want):
        assert out.dtype.kind == "i" and out.shape == labels.shape
        assert np.array_equal(out[~mask], labels[~mask])
        offset = (out[mask] - labels[mask]) % c
        assert offset.min() == 1 and offset.max() == c - 1
        assert set(np.unique(offset)) == set(range(1, c))


# ---------------------------------------------------------------------------
# compression wire form

def _tied_rows():
    """Rows whose |x| ties across the top-k boundary (and inside it)."""
    x = np.zeros((4, 20), np.float32)
    x[0, [3, 7, 11, 15]] = [2.0, -2.0, 2.0, -2.0]
    x[1] = 1.0
    x[2, ::2] = -0.5
    x[2, 5] = 3.0
    x[3] = np.tile([1.0, -1.0, 0.25, -0.25], 5)
    return x


@pytest.mark.parametrize("ratio", [0.1, 0.25])
def test_topk_encode_matches_lax_top_k(ratio):
    rng = np.random.default_rng(4)
    cases = [rng.standard_normal((6, 101)).astype(np.float32), _tied_rows()]
    codec, jcodec = TopKCodec(ratio=ratio), jmake_codec("topk", ratio=ratio)
    for x in cases:
        c = codec.encode(torch.tensor(x))
        jc = jcodec.encode(jnp.asarray(x), jax.random.PRNGKey(0))
        assert isinstance(c, CompressedUpdate)
        assert (c.kind, c.shape, c.nbytes_per_row) == \
            (jc.kind, jc.shape, jc.nbytes_per_row)
        assert c.data["indices"].dtype == torch.int32
        assert c.data["values"].dtype == torch.float16
        assert np.array_equal(c.data["indices"].numpy(),
                              np.asarray(jc.data["indices"]))
        assert np.array_equal(c.data["values"].numpy(),
                              np.asarray(jc.data["values"]))
        got = codec.decode(c)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(jcodec.decode(jc)))
    # no ties: decode(encode(x)) is the round trip
    x = torch.tensor(cases[0])
    assert torch.equal(codec.decode(codec.encode(x)), codec.roundtrip(x))


def _reference_noise(key, n: int, d: int) -> np.ndarray:
    """The reference QSGD's per-sender uniforms (``fold_in`` of the row's
    sender id, ``repro/compress/qsgd.py:56-58``)."""
    return np.asarray(jax.vmap(
        lambda r: jax.random.uniform(jax.random.fold_in(key, r), (d,)))(
            jnp.arange(n)))


@pytest.mark.parametrize("levels", [15, 3])
def test_qsgd_encode_matches_reference_exactly(levels):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 257)).astype(np.float32)
    x[2] = 0.0                                 # a zero row (scale 0)
    key = jax.random.PRNGKey(7)
    noise = _reference_noise(key, *x.shape)
    codec, jcodec = QSGDCodec(levels=levels), jmake_codec("qsgd",
                                                          levels=levels)
    c = codec.encode(torch.tensor(x), torch.tensor(noise))
    jc = jcodec.encode(jnp.asarray(x), key)
    assert (c.kind, c.shape, c.nbytes_per_row) == \
        (jc.kind, jc.shape, jc.nbytes_per_row)
    assert c.data["q"].dtype == torch.int32
    assert np.array_equal(c.data["q"].numpy(), np.asarray(jc.data["q"]))
    assert np.array_equal(c.data["scale"].numpy(),
                          np.asarray(jc.data["scale"]))
    got = codec.decode(c)
    assert np.array_equal(got.numpy(), np.asarray(jcodec.decode(jc)))
    assert torch.equal(got, codec.roundtrip(torch.tensor(x),
                                            torch.tensor(noise)))
    with pytest.raises(ValueError, match="uniform noise"):
        codec.encode(torch.tensor(x))


def test_identity_codec_wire_form_and_byte_counts():
    x = torch.randn(3, 10, generator=torch.Generator().manual_seed(0))
    c = Codec().encode(x)
    assert c.kind == "none" and c.shape == (3, 10) and c.nbytes_per_row == 40
    assert Codec().decode(c) is x
    for name, kw in (("none", {}), ("topk", dict(ratio=0.1)),
                     ("topk", dict(ratio=1.0)), ("qsgd", dict(levels=15)),
                     ("qsgd", dict(levels=1))):
        codec, jcodec = make_codec(name, **kw), jmake_codec(name, **kw)
        for d in (1, 10, 545_098):
            assert codec.payload_bytes(d) == jcodec.payload_bytes(d)


def test_codec_registry_and_make_codec(monkeypatch):
    assert cpolicy.make_codec is make_codec is cbase.make_codec
    monkeypatch.setattr(cbase, "_REGISTRY", dict(cbase._REGISTRY))

    @register_codec("halve")
    @dataclass(frozen=True)
    class Halve(Codec):
        levels: int = 15
        name = "halve"

        @property
        def is_identity(self):
            return False

        def roundtrip(self, x, noise=None):
            return 0.5 * x
    codec = make_codec("halve", levels=4)
    assert isinstance(codec, Halve) and codec.levels == 4
    with pytest.raises(ValueError) as port_err:
        make_codec("nope")
    with pytest.raises(ValueError) as ref_err:
        jmake_codec("nope")
    assert "unknown compressor 'nope'" in str(port_err.value)
    assert str(ref_err.value).split(";")[0] == \
        str(port_err.value).split(";")[0]


@pytest.mark.parametrize("over", [
    dict(), dict(compressor="topk"), dict(compressor="topk",
                                          compress_ratio=0.25,
                                          link_policy="all"),
    dict(compressor="qsgd", qsgd_levels=7, link_policy="intra_only"),
    dict(compressor="qsgd", link_policy="none")])
def test_policy_from_flcfg_matches_reference(over):
    lp, jlp = policy_from_flcfg(FLConfig(**over)), \
        jpolicy_from_flcfg(JFLConfig(**over))
    topo, jtopo = CloudTopology.even(3, 4), JTopology.even(3, 4)
    for cls in ("intra", "cross"):
        a, b = getattr(lp, cls), getattr(jlp, cls)
        assert (a.name, a.is_identity) == (b.name, b.is_identity)
        assert a.payload_bytes(1000) == b.payload_bytes(1000)
    assert lp.any_active == jlp.any_active
    for hier in (True, False):
        for got, want in zip(lp.payload_vectors(topo, 545_098,
                                                hierarchical=hier),
                             jlp.payload_vectors(jtopo, 545_098,
                                                 hierarchical=hier)):
            assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# models

@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "relu2"])
def test_act_fn_matches_reference(name):
    x = np.linspace(-4.0, 4.0, 101, dtype=np.float32)
    got = common.act_fn(name)(torch.tensor(x)).numpy()
    want = np.asarray(jcommon.act_fn(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_layer_signature_matches_reference():
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_arch(arch), jconfigs.get_arch(arch)
        for c, jc in ((cfg, jcfg), (configs.reduced(cfg, layers=4),
                                    jconfigs.reduced(jcfg, layers=4))):
            assert [tfm.layer_signature(c, i) for i in range(c.num_layers)] \
                == [jtfm.layer_signature(jc, i)
                    for i in range(jc.num_layers)], arch


# ---------------------------------------------------------------------------
# the serve launcher's default

def _reference_serve_default() -> str:
    tree = ast.parse((ROOT / "src/repro/launch/serve.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--arch"):
            return next(kw.value.value for kw in node.keywords
                        if kw.arg == "default")
    raise AssertionError("no --arch argument in the reference's launcher")


def test_serve_launcher_defaults_to_the_reference_arch(monkeypatch):
    want = _reference_serve_default()
    assert want == "gemma2-2b"
    assert inspect.signature(serve_mod.serve).parameters["arch"].default \
        == want
    seen = {}

    def fake_serve(arch, **kw):
        seen["arch"] = arch
        raise SystemExit(0)
    monkeypatch.setattr(serve_mod, "serve", fake_serve)
    with pytest.raises(SystemExit):
        serve_mod.main([])
    assert seen["arch"] == want
    assert f"--arch {want}" in serve_mod.__doc__
