"""PyTorch port vs JAX package: an MoE model routed whole across
``(pod, data)`` groups, on the CPU.

qwen2-moe-a2.7b and phi3.5-moe at their smoke configs on ``(data,
model)`` CPU meshes of (2, 1), (2, 2) and (4, 1) slots. The groups run
in lockstep (``models/parallel.py``): one routing over the whole batch,
each group dispatching its own rows. Held against the reference's
unsharded ``Model`` at the same ``tp`` on the reference's weights
(``models/convert.py``):

- the forward's logits and aux loss;
- at every MoE layer, the kept (token, expert, rank) triples of the
  routing, exactly: the reference's from its own ops (``moe_block``'s
  router, ``top_k``, capacity and cumsum ranks, repeated below on the
  layer input it is called with, its layers unrolled so that the input
  is a value), the port's from its ``dispatch``;
- the same with ``capacity_factor`` lowered to 0.5 in both copies of the
  config, where the smoke config's 4.0 drops no choice: here choices are
  dropped, and the triples stay exact;
- one 2-microbatch ZeRO-1 train step on a global batch of 8 rows against
  the reference's ``make_train_step(..., microbatches=2)``: microbatch k
  is rows 4k .. 4k+3 of the whole batch in both, spread over the groups
  in the port. The loss, ce, aux and grad norm; the first moments, which
  after one step are (1 - b1) x the clipped gradient (so they hold the
  gradients); the master weights.

Tolerances, float32: logits, aux, losses and grad norm within 1e-4 of
the largest value (the slots' partial sums add in another order), each
first moment within 1e-4 of its leaf's largest (these hold the
gradients); the master weights each within 2 x lr and their median
within 0.05 x lr (``test_torch_parallel.py``'s MEDIAN_TOL): Adam's first
step moves an element by lr x g / (|g| + 1e-8), so a gradient within a
few 1e-8 of 0, which the two libraries round differently, may move it by
up to lr either way; the triples exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import get_config as ref_get_config
from repro.models.params import init_params as ref_init_params
from repro.models.transformer import build as ref_build
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.trainer import make_train_step as ref_train_step
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as port_moe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import build
from repro_torch.sharding import unshard
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.parallel import gather_train_state, place_train_state
from repro_torch.train.trainer import make_train_step

TOL = 1e-4
FLIP_TOL = 2.0           # x lr
MEDIAN_TOL = 0.05        # x lr
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]
MESHES = [(2, 1), (2, 2), (4, 1)]


def live_params(specs, seed):
    params = ref_init_params(specs, jax.random.key(seed), jnp.float32)
    rng = np.random.default_rng(seed)

    def liven(a):
        arr = np.asarray(a, np.float32)
        if arr.size and np.all(arr == arr.flat[0]):
            arr = arr + rng.normal(size=arr.shape).astype(np.float32) * 0.1
        return jnp.asarray(arr)
    return jax.tree.map(liven, params)


def close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1.0), err


def ref_triples(p, x, moe, e):
    """The kept (token, expert, rank) of the reference's ``moe_block`` on
    x, by its own ops (``src/repro/models/moe.py``, the router to
    ``keep``), and how many choices it drops."""
    xt = x.reshape(-1, x.shape[-1])
    logits = (xt @ p["router"]).astype(jnp.float32)
    if e != moe.n_experts:
        logits = jnp.where(jnp.arange(e) < moe.n_experts, logits, -1e30)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), moe.top_k)
    capacity = max(int(moe.capacity_factor * xt.shape[0] * moe.top_k / e),
                   1)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    rank = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    keep = np.asarray(rank < capacity)
    tok = np.arange(flat_e.shape[0]) // moe.top_k
    return ({(int(t), int(x_), int(r)) for t, x_, r, k in zip(
        tok, np.asarray(flat_e), np.asarray(rank), keep) if k},
        int((~keep).sum()))


def port_triples(plan, k):
    keep = plan.keep.numpy()
    flat_e = plan.top_e.reshape(-1).numpy()
    tok = np.arange(flat_e.shape[0]) // k
    return {(int(t), int(x_), int(r)) for t, x_, r, kk in zip(
        tok, flat_e, plan.rank.numpy(), keep) if kk}


def setup(name, data, m, **over):
    ref_cfg = dataclasses.replace(ref_get_config(name, smoke=True), **over)
    ref = ref_build(ref_cfg, m)
    rp = live_params(ref.param_specs(), 7)
    cfg = dataclasses.replace(get_config(name, smoke=True), **{
        k: v for k, v in over.items() if k != "scan_layers"})
    par = build(cfg, m, mesh=make_host_mesh(data, device="cpu", model=m))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    return ref_cfg, ref, rp, cfg, par, pp


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("data,m", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_moe_routed_whole_across_groups(name, data, m, cf, monkeypatch):
    over = {"scan_layers": False}
    if cf is not None:
        base = get_config(name, smoke=True).moe
        over["moe"] = dataclasses.replace(base, capacity_factor=cf)
    ref_cfg, ref, rp, cfg, par, pp = setup(name, data, m, **over)
    assert len(par.plan.groups) == data
    toks = np.random.default_rng(data * 10 + m).integers(
        0, ref_cfg.vocab_size, (8, 12)).astype(np.int32)

    want_triples, dropped = [], []
    orig = ref_moe.moe_block

    def record(p, x, moe, e):
        t, n = ref_triples(p, x, moe, e)
        want_triples.append(t)
        dropped.append(n)
        return orig(p, x, moe, e)
    monkeypatch.setattr(ref_moe, "moe_block", record)
    want, want_aux = ref.forward(rp, jnp.asarray(toks))

    plans = []
    dispatch = port_moe.dispatch

    def keep_plan(routing, moe, e):
        plans.append(dispatch(routing, moe, e))
        return plans[-1]
    monkeypatch.setattr(port_moe, "dispatch", keep_plan)
    got, aux = par.forward(par.place(pp), torch.from_numpy(toks))
    vocab = ref_cfg.vocab_size
    close(unshard(got).detach()[..., :vocab], np.asarray(want)[..., :vocab])
    close(aux.detach(), want_aux)
    # one routing a layer over the whole batch, the reference's
    assert len(plans) == len(want_triples) == cfg.n_layers
    for plan, t in zip(plans, want_triples):
        assert port_triples(plan, cfg.moe.top_k) == t
    if cf is None:
        assert sum(dropped) == 0
    else:
        assert sum(dropped) > 0      # the capacity drops choices


@pytest.mark.parametrize("data,m", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_moe_zero1_step_matches_reference(name, data, m):
    ref_cfg, ref, rp, cfg, par, pp = setup(name, data, m)
    rng = np.random.default_rng(3)
    t = rng.integers(0, ref_cfg.vocab_size, (8, 13)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    rstep = jax.jit(ref_train_step(ref, RefAdamW(**OPT), microbatches=2))
    rstate, rmet = rstep({"params": rp, "opt": ref_adamw_init(rp)},
                         {k: jnp.asarray(v) for k, v in batch.items()})
    state = place_train_state(par, {"params": pp, "opt": adamw_init(pp)})
    step = make_train_step(par, AdamWConfig(**OPT), microbatches=2)
    state, met = step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    for key in ("loss", "ce", "aux", "grad_norm"):
        close(met[key], rmet[key])
    got = gather_train_state(state)
    for g, w in zip(tree_leaves(got["opt"]["m"]),
                    jax.tree.leaves(rstate["opt"]["m"])):
        close(g, w)
    d = np.concatenate([np.abs(np.asarray(g, np.float64)
                               - np.asarray(w, np.float64)).ravel()
                        for g, w in zip(tree_leaves(got["opt"]["master"]),
                                        jax.tree.leaves(
                                            rstate["opt"]["master"]))])
    lr = float(rmet["lr"])
    assert d.max() <= FLIP_TOL * lr, d.max()
    assert np.median(d) <= MEDIAN_TOL * lr, np.median(d)
