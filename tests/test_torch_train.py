"""The port's one-device training path against the JAX reference on
identical inputs: the differentiable ``linear_scan`` (its backward, the
reverse scan), ``chunked_cross_entropy``, ``Model.grad_fn``, the
optimizers, ``make_plain_step``, the token data, and the card's
numerics contract that ``resolve_device`` sets.

The reference trains the RG-LRU through ``jax.lax.associative_scan``
(``repro/models/rglru.py:rglru_scan``, ``use_kernel=False``), so the
port's gradients, which go through ``LinearScan``'s backward (the plain
scan here; the same CUDA kernel on the card), are held against
``jax.grad`` of that.

Tolerances, fp32 on the CPU, with their reasons:
* the token data and the optimizer's step: exact;
* the optimizers on identical gradients: 1e-6 (the same formulas,
  elementwise);
* ``linear_scan``'s backward against autograd through
  ``linear_scan_plain`` and against ``jax.grad``: 1e-5 in fp32 (another
  scan order), 5e-2 in bf16 (g is rounded to bf16 once per reverse scan,
  then ∂a once more);
* ``chunked_cross_entropy`` and its gradients: 1e-5;
* the model's loss within 1e-5 relative, every gradient leaf within 1e-4
  relative (norm of the difference over the norm of the reference), and
  the parameters after three AdamW steps within 1e-4 relative.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.data import iid_partition as jiid_partition
from repro.data import make_token_stream as jmake_token_stream
from repro.data import token_batches as jtoken_batches
from repro.models import common as jcommon
from repro.models import rglru as jrglru
from repro.models.model import Model as JModel
from repro.optim import OptState as JOptState
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import sgd as jsgd
from repro.train.steps import make_plain_step as jmake_plain_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.data import iid_partition, make_token_stream, token_batches
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common, rglru
from repro_torch.models.model import Model
from repro_torch.optim import (OptState, adamw, clip_by_global_norm,
                               cosine_schedule, sgd)
from repro_torch.train import make_plain_step
from repro_torch.tree import tree_map

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a, **kw):
    return torch.tensor(np.asarray(a), **kw)


def _np(tree):
    return tree_map(lambda x: x.detach().float().numpy(), tree)


def _assert_leaves(got, want, tol):
    """Each leaf of the numpy tree ``got`` within ``tol`` relative of the
    matching leaf of ``want`` (a reference tree)."""
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_leaves) == len(want_leaves)
    worst = 0.0
    for path, w in want_leaves:
        err = _rel(got_leaves[path], w)
        assert err <= tol, (jax.tree_util.keystr(path), err)
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# linear_scan's backward

def _scan_inputs(seed, shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.99, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    return [_t(x).to(_TDT[dtype]) for x in (a, b, dh)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 17, 5), (3, 70, 8), (1, 1, 3),
                                   (2, 2, 4)])
def test_linear_scan_backward_matches_plain_autograd(shape, dtype):
    """``LinearScan``'s adjoint (one reverse scan) against autograd
    through ``linear_scan_plain``'s log-depth scan. T = 1: the plain scan
    never reads a, so ∂a is 0."""
    a, b, dh = _scan_inputs(sum(shape), shape, dtype)
    tol = 1e-5 if dtype == "float32" else 5e-2
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = ops.linear_scan(a1, b1)
    assert h.grad_fn is not None and h.dtype == a.dtype
    da, db = torch.autograd.grad(h, (a1, b1), dh)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    h2 = ops.linear_scan_plain(a2, b2)
    da2, db2 = torch.autograd.grad(h2, (a2, b2), dh, allow_unused=True,
                                   materialize_grads=True)
    assert da.dtype == db.dtype == a.dtype
    _close(h.detach().float(), h2.detach().float(), 0.0)
    _close(db.float(), db2.float(), tol)
    _close(da.float(), da2.float(), tol)
    # the adjoint itself: ∂b_t = ∂h_t + a_{t+1}·∂b_{t+1}, ∂a_t = ∂b_t·h_{t-1}
    da3, db3 = ops.linear_scan_bwd(a, h.detach(), dh)
    assert torch.equal(da3, da) and torch.equal(db3, db)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_gradients_match_jax_grad_of_associative_scan(with_h0):
    """∂a, ∂b (and ∂h0) of Σ w·rglru_scan(a, b, h0) against ``jax.grad``
    of the reference's ``associative_scan`` at a ragged (2, 45, 6)."""
    rng = np.random.default_rng(11)
    a = rng.uniform(0.3, 0.99, (2, 45, 6)).astype(np.float32)
    b = rng.standard_normal((2, 45, 6)).astype(np.float32)
    w = rng.standard_normal((2, 45, 6)).astype(np.float32)
    h0 = rng.standard_normal((2, 6)).astype(np.float32)

    def jloss(a, b, h0):
        return jnp.sum(jnp.asarray(w) * jrglru.rglru_scan(
            a, b, h0 if with_h0 else None))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    xs = [_t(x).requires_grad_() for x in (a, b, h0)]
    h = rglru.rglru_scan(xs[0], xs[1], xs[2] if with_h0 else None)
    got = torch.autograd.grad(torch.sum(_t(w) * h), xs, allow_unused=True,
                              materialize_grads=True)
    for g, wg in zip(got, want):
        _close(g, wg, 1e-5)


# ---------------------------------------------------------------------------
# the loss

@pytest.mark.parametrize("cap", [0.0, 2.0])
def test_chunked_cross_entropy_and_grads_match_reference(cap):
    """S = 50 in chunks of 16: three chunks and a remainder of 2; a mask
    with zeros; with and without a binding logit softcap. The loss and
    its gradients in the hidden states and the head."""
    rng = np.random.default_rng(12)
    hid = rng.standard_normal((2, 50, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 50)).astype(np.int32)
    mask = (rng.random((2, 50)) > 0.2).astype(np.float32)

    def jloss(h, w):
        return jcommon.chunked_cross_entropy(
            lambda hc: hc @ w, h, jnp.asarray(labels), jnp.asarray(mask),
            chunk=16, logit_softcap_val=cap)
    l_j, g_j = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(hid), jnp.asarray(head))
    h, w = _t(hid).requires_grad_(), _t(head).requires_grad_()
    l_t = common.chunked_cross_entropy(
        lambda hc: hc @ w, h, _t(labels).long(), _t(mask), chunk=16,
        logit_softcap_val=cap)
    g_t = torch.autograd.grad(l_t, (h, w))
    assert abs(l_t.item() - float(l_j)) <= 1e-5 * abs(float(l_j))
    for g, wg in zip(g_t, g_j):
        _close(g, wg, 1e-5)
    # no chunk: one remainder chunk of the whole sequence
    l_one = common.chunked_cross_entropy(
        lambda hc: hc @ w, h, _t(labels).long(), _t(mask), chunk=64,
        logit_softcap_val=cap)
    assert abs(l_one.item() - float(l_j)) <= 1e-5 * abs(float(l_j))


def _rg_test_cfgs():
    """recurrentgemma-2b's layout at the serve tests' width: two stacked
    R, R, L cycles and a tail of two R layers, d_model 128, window 64."""
    return (replace(jreduced(jget_arch("recurrentgemma-2b"), d_model=128,
                             layers=3), num_layers=8),
            replace(reduced(get_arch("recurrentgemma-2b"), d_model=128,
                            layers=3), num_layers=8))


def _gemma2_cfgs():
    return (jreduced(jget_arch("gemma2-2b"), d_model=64, layers=3),
            reduced(get_arch("gemma2-2b"), d_model=64, layers=3))


def _batch(seed, vocab, b=2, s=72):
    """A training batch from the token data (labels the next tokens,
    every position counted)."""
    stream = make_token_stream(4000, vocab, seed=seed)
    toks = next(token_batches(stream, batch=b, seq=s, seed=seed))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((b, s), np.float32)}


def _weights(cfg, seed):
    """The port's seeded weights and a copy of them in the reference's
    tree (the port's init spares the reference's, which runs op by op)."""
    tp = Model(cfg).init(seed, device="cpu")
    return tp, jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                            convert.model_params_to_numpy(tp, cfg))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: _t(v).long() if k != "mask" else _t(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma2-2b"])
def test_grad_fn_matches_jax_value_and_grad(arch):
    """``Model.grad_fn`` against ``jax.value_and_grad`` of the reference
    loss on the same weights and batch, chunk 32 over S = 72 (two chunks
    and a remainder): the loss, its metrics and every gradient leaf.
    recurrentgemma's 6 R layers train through ``LinearScan``'s backward;
    gemma2 holds both softcaps in the backward. Then the same gradients
    with every layer rematerialized (``cfg.remat``): equal."""
    jcfg, cfg = _rg_test_cfgs() if arch == "recurrentgemma-2b" \
        else _gemma2_cfgs()
    tp, jp = _weights(cfg, 3)
    batch = _batch(3, cfg.vocab_size)
    (l_j, m_j), g_j = jax.jit(JModel(jcfg).grad_fn(32))(jp, _jbatch(batch))
    (l_t, m_t), g_t = Model(cfg).grad_fn(32)(tp, _tbatch(batch))
    assert abs(float(l_t) - float(l_j)) <= 1e-5 * abs(float(l_j))
    assert float(m_t["aux_loss"]) == float(m_j["aux_loss"]) == 0.0
    assert abs(float(m_t["lm_loss"]) - float(m_j["lm_loss"])) \
        <= 1e-5 * abs(float(m_j["lm_loss"]))
    worst = _assert_leaves(convert.model_params_to_numpy(g_t, cfg),
                           jax.tree.map(np.asarray, g_j), 1e-4)
    print(f"{arch}: loss {float(l_t):.6f} vs {float(l_j):.6f}, worst grad "
          f"leaf {worst:.2e} relative")
    assert all(not x.requires_grad for x in jax.tree.leaves(tp))
    (l_r, _), g_r = Model(replace(cfg, remat=True)).grad_fn(32)(
        tp, _tbatch(batch))
    assert float(l_r) == float(l_t)
    for x, y in zip(jax.tree.leaves(g_r), jax.tree.leaves(g_t)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the optimizers

def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 4)).astype(np.float32),
            "layers": [rng.standard_normal(7).astype(np.float32),
                       rng.standard_normal((2, 3)).astype(np.float32)]}


def _port_tree(tree):
    return tree_map(lambda x: _t(x), tree)


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum", "adamw",
                                 "adamw_cosine"])
def test_optimizers_match_reference(opt):
    """Four updates on identical gradients from identical params: the
    params, the moments and the step within 1e-6 (the step exact)."""
    lr = 0.05
    if opt == "sgd":
        pair = (sgd(lr), jsgd(lr))
    elif opt == "sgd_momentum":
        pair = (sgd(lr, momentum=0.9), jsgd(lr, momentum=0.9))
    elif opt == "adamw":
        pair = (adamw(lr, weight_decay=0.1), jadamw(lr, weight_decay=0.1))
    else:
        pair = (adamw(cosine_schedule(lr, warmup=2, total=6), eps=1e-6),
                jadamw(jcosine(lr, warmup=2, total=6), eps=1e-6))
    (init, update), (jinit, jupdate) = pair
    params, jparams = _port_tree(_grad_tree(0)), _grad_tree(0)
    state, jstate = init(params), jinit(jparams)
    for i in range(4):
        g = _grad_tree(10 + i)
        params, state = update(_port_tree(g), state, params)
        jparams, jstate = jupdate(g, jstate, jparams)
    assert int(state.step) == int(jstate.step) == 4
    for got, want in ((params, jparams), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        if want is None:
            assert got is None
            continue
        for x, y in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(want)):
            _close(x, y, 1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grad_tree(1)
    got, norm = clip_by_global_norm(_port_tree(g), max_norm)
    want, jnorm = jclip(g, max_norm)
    _close(norm, jnorm, 1e-6)
    for x, y in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(want)):
        _close(x, y, 1e-6)


def test_cosine_schedule_matches_reference():
    s, js = cosine_schedule(0.3, warmup=5, total=40, min_frac=0.2), \
        jcosine(0.3, warmup=5, total=40, min_frac=0.2)
    for step in (0, 1, 4, 5, 6, 22, 40, 55):
        _close(s(torch.tensor(step, dtype=torch.int32)),
               js(jnp.asarray(step, jnp.int32)), 1e-6)


# ---------------------------------------------------------------------------
# the train step

def _rg_small_cfgs():
    return (jreduced(jget_arch("recurrentgemma-2b"), d_model=64, layers=3),
            reduced(get_arch("recurrentgemma-2b"), d_model=64, layers=3))


def _opt_state(params_np, seed):
    """A reference AdamW state mid-run: step 5, random first moments and
    positive second moments (so no update divides a rounding by ~0)."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda x: (1e-3 * rng.standard_normal(x.shape))
                      .astype(np.float32), params_np)
    nu = jax.tree.map(lambda x: (1e-5 + 1e-5 * rng.random(x.shape))
                      .astype(np.float32), params_np)
    return JOptState(np.asarray(5, np.int32), mu, nu)


def test_opt_state_converts_both_ways():
    cfg = _rg_small_cfgs()[1]
    pnp = convert.model_params_to_numpy(Model(cfg).init(4, device="cpu"),
                                        cfg)
    js = _opt_state(pnp, 4)
    ts = convert.opt_state_from_numpy(js, cfg, device="cpu")
    assert isinstance(ts, OptState) and ts.step.dtype == torch.int32
    assert int(ts.step) == 5 and len(ts.mu["layers"]) == 3
    back = JOptState(*convert.opt_state_to_numpy(ts, cfg))
    assert int(back.step) == 5
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.array_equal(x, y)
    none = convert.opt_state_from_numpy((0, None, None), cfg, device="cpu")
    assert none.mu is None and none.nu is None


def test_three_plain_steps_match_reference():
    """Three ``make_plain_step`` steps with AdamW (cosine schedule, weight
    decay) from one mid-run optimizer state, on recurrentgemma-2b's R, R,
    L layout at d_model 64, batches from ``token_batches``: the loss of
    each step within 1e-5 relative, then every param and moment leaf
    within 1e-4 relative, the step exact."""
    jcfg, cfg = _rg_small_cfgs()
    pnp = convert.model_params_to_numpy(Model(cfg).init(5, device="cpu"),
                                        cfg)
    tp = convert.model_params_from_numpy(pnp, cfg, device="cpu")
    jp = jax.tree.map(lambda x: jnp.asarray(np.array(x)), pnp)
    js = _opt_state(pnp, 5)
    ts = convert.opt_state_from_numpy(js, cfg, device="cpu")
    js = jax.tree.map(jnp.asarray, js)
    opt, jopt = (adamw(cosine_schedule(1e-2, 2, 20), weight_decay=0.01),
                 jadamw(jcosine(1e-2, 2, 20), weight_decay=0.01))
    step = make_plain_step(Model(cfg), None, opt, loss_chunk=32)
    jstep = jmake_plain_step(JModel(jcfg), None, jopt, loss_chunk=32)
    stream = make_token_stream(6000, cfg.vocab_size, seed=5)
    assert np.array_equal(stream, jmake_token_stream(6000, cfg.vocab_size,
                                                     seed=5))
    it = token_batches(stream, batch=2, seq=48, seed=5)
    for i in range(3):
        toks = next(it)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "mask": np.ones((2, 48), np.float32)}
        tp, ts, met = step(tp, ts, _tbatch(batch))
        jp, js, jmet = jstep(jp, js, _jbatch(batch))
        assert set(met) == {"loss", "lm_loss", "aux_loss"}
        assert abs(float(met["loss"]) - float(jmet["loss"])) \
            <= 1e-5 * abs(float(jmet["loss"])), i
    assert int(ts.step) == int(js.step) == 8
    back = convert.opt_state_to_numpy(ts, cfg)
    worst = _assert_leaves(convert.model_params_to_numpy(tp, cfg),
                           jax.tree.map(np.asarray, jp), 1e-4)
    for got, want in ((back.mu, js.mu), (back.nu, js.nu)):
        worst = max(worst, _assert_leaves(got, jax.tree.map(np.asarray,
                                                            want), 1e-4))
    print(f"three AdamW steps: worst leaf {worst:.2e} relative")


def test_plain_step_with_a_mesh_equals_the_step_without():
    """``make_plain_step(model, mesh, opt)`` takes a mesh and leaves it
    unused, as the reference's: over the live (1, 1) mesh of
    ``launch.mesh.make_debug_mesh`` (a one-rank gloo group) and over the
    production mesh's shape, two AdamW steps give the bits of
    ``mesh=None``'s: loss, every parameter and moment, the step."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.tree import tree_leaves

    cfg = _rg_small_cfgs()[1]
    model = Model(cfg)
    stream = make_token_stream(3000, cfg.vocab_size, seed=3)
    batches = []
    for toks in [next(token_batches(stream, batch=2, seq=32, seed=s))
                 for s in (3, 4)]:
        batches.append(_tbatch({"tokens": toks[:, :-1],
                                "labels": toks[:, 1:],
                                "mask": np.ones((2, 32), np.float32)}))

    def two_steps(mesh):
        opt = adamw(1e-2, weight_decay=0.01)
        params = model.init(2, device="cpu")
        state = opt[0](params)
        step = make_plain_step(model, mesh, opt, loss_chunk=16)
        losses = []
        for b in batches:
            params, state, met = step(params, state, b)
            losses.append(met["loss"])
        return losses, tree_leaves([params, state.mu, state.nu]), state.step

    want = two_steps(None)
    mesh = make_debug_mesh(device="cpu")
    try:
        runs = [two_steps(mesh), two_steps(make_production_mesh())]
    finally:
        dist.destroy_process_group()
    for losses, leaves, count in runs:
        assert all(torch.equal(a, b) for a, b in zip(losses, want[0]))
        assert len(leaves) == len(want[1])
        assert all(torch.equal(a, b) for a, b in zip(leaves, want[1]))
        assert int(count) == int(want[2]) == 2


# ---------------------------------------------------------------------------
# the token data

def test_token_data_matches_reference():
    for n, vocab, seed in ((3000, 512, 0), (2500, 100, 7)):
        got = make_token_stream(n, vocab, seed=seed)
        want = jmake_token_stream(n, vocab, seed=seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        it, jit_ = (token_batches(got, batch=3, seq=16, seed=seed),
                    jtoken_batches(want, batch=3, seq=16, seed=seed))
        for _ in range(4):
            a, b = next(it), next(jit_)
            assert a.shape == (3, 17) and np.array_equal(a, b)
    for n, k, seed in ((103, 7, 2), (40, 40, 0), (5, 2, 9)):
        got, want = iid_partition(n, k, seed), jiid_partition(n, k, seed)
        assert len(got) == len(want) == k
        assert all(np.array_equal(x, y) for x, y in zip(got, want))


# ---------------------------------------------------------------------------
# the card's numerics contract

def test_resolve_device_sets_deterministic_cudnn(monkeypatch):
    """Every entry point resolves its device through ``resolve_device``;
    on the card it restricts cuDNN to deterministic algorithms with the
    autotuner off (two LocalTrains of one seed give the same bits), next
    to fp32 matmuls and convolutions. The CPU leaves the flags alone."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        resolve_device("cpu")
        assert not torch.backends.cudnn.deterministic
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert resolve_device("cuda").type == "cuda"
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags[:4]
        torch.set_float32_matmul_precision(flags[4])
