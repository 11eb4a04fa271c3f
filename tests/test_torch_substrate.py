"""The port's host-side substrate against the reference on identical
inputs: config, data, adversary draw, cost model, Eq. 10 selection,
payload vectors and the small Eq. 6/7 helpers. Everything here is exact
(numpy copies, or the same float32 operations in the same order) except
the two float helpers at the end (1e-5, fp32 sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import build_link_policy as jbuild_link_policy
from repro.configs.base import FLConfig as JFLConfig
from repro.core import CostModel as JCostModel
from repro.core import ReputationState as JReputationState
from repro.core.cost import hierarchical_unit_costs_jax, round_bytes_jax
from repro.core.selection import exploration_quota as jquota
from repro.core.selection import select_clients_jax, selected_count as jcount
from repro.core.shapley import gradient_contribution as jcontribution
from repro.core.trust import cloud_trust as jcloud_trust
from repro.federated import engine as jengine
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.compress import build_link_policy
from repro_torch.configs.base import FLConfig
from repro_torch.core import (CloudTopology, CostModel, ReputationState,
                              cloud_trust, exploration_quota,
                              gradient_contribution,
                              hierarchical_unit_costs_torch,
                              round_bytes_torch, select_clients,
                              selected_count)
from repro_torch.federated import engine as tengine
from repro_torch.federated.simulation import make_data, make_topology

CPU = torch.device("cpu")
_SMALL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
              ref_samples=16, attack="label_flip")


def _defaults(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_flconfig_fields_and_defaults_match():
    assert _defaults(FLConfig) == _defaults(JFLConfig)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_data_arrays_equal(seed):
    kw = dict(n_samples=600, samples_per_client=16)
    a = make_data(FLConfig(**_SMALL), seed=seed, **kw)
    b = jmake_data(JFLConfig(**_SMALL), seed=seed, **kw)
    for f in dataclasses.fields(b):
        assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert np.array_equal(make_topology(FLConfig()).cloud_of,
                          jmake_topology(JFLConfig()).cloud_of)


@pytest.mark.parametrize("seed", [0, 5])
def test_adversary_draw_and_label_flip_exact(seed):
    fl, jfl = FLConfig(**_SMALL), JFLConfig(**_SMALL)
    data = make_data(fl, seed=seed, n_samples=600, samples_per_client=16)
    mal = tengine.draw_malicious(fl, 12, seed)
    assert np.array_equal(mal, jengine.draw_malicious(jfl, 12, seed))
    assert np.array_equal(tengine.poison_labels(fl, data, mal, seed),
                          jengine.poison_labels(jfl, data, mal, seed))


@pytest.mark.parametrize("hierarchical", [True, False])
def test_cost_model_exact_over_random_masks(hierarchical):
    rng = np.random.default_rng(1)
    topo = CloudTopology.even(3, 5, aggregator_cloud=1)
    jtopo = jmake_topology(JFLConfig(n_clouds=3, clients_per_cloud=5))
    jtopo = dataclasses.replace(jtopo, aggregator_cloud=1)
    cm, jcm = CostModel(0.01, 0.09), JCostModel(0.01, 0.09)
    d = 545_098
    cp = rng.integers(1_000, 5_000, topo.n_clients).astype(np.float64)
    ep = rng.integers(1_000, 5_000, topo.n_clouds).astype(np.float64)
    for _ in range(20):
        mask = rng.random(topo.n_clients) < rng.random()
        for kw in (dict(), dict(client_payload=cp, edge_payload=ep)):
            assert (cm.round_bytes(topo, mask, d, hierarchical=hierarchical,
                                   **kw)
                    == jcm.round_bytes(jtopo, mask, d,
                                       hierarchical=hierarchical, **kw))
            assert (cm.round_cost(topo, mask, d, hierarchical, **kw)
                    == jcm.round_cost(jtopo, mask, d, hierarchical, **kw))
        # float32 mirrors, same operations: equal bit for bit
        got = round_bytes_torch(torch.as_tensor(mask),
                                torch.as_tensor(topo.cloud_of), 1,
                                torch.as_tensor(cp, dtype=torch.float32),
                                torch.as_tensor(ep, dtype=torch.float32),
                                hierarchical=hierarchical)
        want = round_bytes_jax(jnp.asarray(mask), topo.cloud_of, 1, cp, ep,
                               hierarchical=hierarchical)
        assert [float(x) for x in got] == [float(x) for x in want]
    assert np.array_equal(cm.hierarchical_unit_costs(topo),
                          jcm.hierarchical_unit_costs(jtopo))
    assert cm.full_participation_cost(topo, d) == \
        jcm.full_participation_cost(jtopo, d)


@pytest.mark.parametrize("lam,per_cloud", [(0.3, True), (0.3, False),
                                           (1.0, False)])
def test_selection_with_injected_noise_matches(lam, per_cloud):
    """Eq. 10 with the reference's tie-break noise fed to both: the same
    mask, exactly (also on round 0's all-equal reputations)."""
    topo = CloudTopology.even(3, 30)
    sizes = np.bincount(topo.cloud_of, minlength=3)
    quota = exploration_quota(lam) if per_cloud else 0
    assert exploration_quota(lam) == jquota(lam)
    assert selected_count(90, 30, quota, topo.cloud_of) == \
        jcount(90, 30, quota, topo.cloud_of)
    uc = hierarchical_unit_costs_torch(torch.as_tensor(topo.cloud_of),
                                       sizes, 0, 0.01, 0.09)
    juc = hierarchical_unit_costs_jax(topo.cloud_of, sizes, 0, 0.01,
                                      jnp.float32(0.09))
    assert np.array_equal(uc.numpy(), np.asarray(juc))
    rng = np.random.default_rng(2)
    for trial in range(6):
        rep = (np.full(90, 1 / 90, np.float32) if trial == 0
               else rng.dirichlet(np.ones(90)).astype(np.float32))
        key = jax.random.PRNGKey(trial)
        noise = np.asarray(jax.random.normal(key, (90,), jnp.float32))
        want = select_clients_jax(jnp.asarray(rep), juc, 30, lam,
                                  per_cloud_min=quota,
                                  cloud_of=topo.cloud_of, key=key)
        got = select_clients(torch.as_tensor(rep), uc, 30, lam,
                             per_cloud_min=quota, cloud_of=topo.cloud_of,
                             noise=torch.tensor(noise))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("compressor,policy", [
    ("none", "cross_only"), ("topk", "cross_only"), ("topk", "all"),
    ("topk", "intra_only"), ("topk", "none")])
def test_payload_vectors_exact(compressor, policy):
    topo = CloudTopology.even(3, 4, aggregator_cloud=2)
    jtopo = dataclasses.replace(
        jmake_topology(JFLConfig(n_clouds=3, clients_per_cloud=4)),
        aggregator_cloud=2)
    for hier in (True, False):
        for d in (1, 7, 545_098):
            got = build_link_policy(compressor, ratio=0.1,
                                    link_policy=policy).payload_vectors(
                topo, d, hierarchical=hier)
            want = jbuild_link_policy(compressor, ratio=0.1,
                                      link_policy=policy).payload_vectors(
                jtopo, d, hierarchical=hier)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_reputation_init_and_eq6_eq7_helpers():
    assert np.array_equal(ReputationState.init(90, device=CPU).ema.numpy(),
                          np.asarray(JReputationState.init(90).ema))
    rng = np.random.default_rng(4)
    g = rng.standard_normal((12, 50)).astype(np.float32)
    ref = rng.standard_normal(50).astype(np.float32)
    np.testing.assert_allclose(
        gradient_contribution(torch.as_tensor(g)).numpy(),
        np.asarray(jcontribution(jnp.asarray(g))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        cloud_trust(torch.as_tensor(g[:3]), torch.as_tensor(ref)).numpy(),
        np.asarray(jcloud_trust(jnp.asarray(g[:3]), jnp.asarray(ref))),
        rtol=1e-5, atol=1e-5)
    # all-negative cosines: uniform β
    np.testing.assert_allclose(
        cloud_trust(torch.as_tensor(-np.abs(g[:3])),
                    torch.as_tensor(np.abs(ref))).numpy(),
        np.full(3, 1 / 3, np.float32))
