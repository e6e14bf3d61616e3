"""The port's sharded execution against its single-slot runs, on the CPU.

A model built on a mesh (``build(cfg, tp, mesh=)``: Megatron tensor
parallelism over ``model`` slots, expert parallelism, data parallelism
over ``data`` slots; ``models/parallel.py``) is held against the same
build on one device (``build(cfg, tp)``, itself held against the JAX
package at that ``tp`` by ``test_torch_tp.py``), on the same weights,
placed by ``Model.place``:

- ``forward``, ``prefill`` and 3 ``decode_step``s of every attention
  family on ``(data, model)`` meshes, K7's plain version and the chunked
  path; the MoE archs on one data slot, and on two, where the groups run
  in lockstep and route the whole batch at once, as the reference does
  (``models/parallel.py``); recurrentgemma and xLSTM data-parallel;
- the loss over vocab-split logits and every param's gradient, FSDP
  included; the engine's greedy tokens, and the argmax's ties;
- 3 ZeRO-1 train steps on ``(2, 2)`` against the single-slot step at
  ``microbatches = data x mb`` (FSDP included; MoE on ``(1, 2)``), each
  slot holding only its pieces, and the sum of a replicated weight's
  partial gradients;
- a checkpoint saved at ``(2, 2)`` and restored at ``(1, 2)``, and
  ``ElasticRun`` from 4 to 2 data slots.

Tolerances, and why. Float32, one step: the slots' partial sums add in
another order than one product's: logits, states and losses within 2e-5
of the largest value (observed <= 4e-6), gradients within 1e-4 of each
leaf's largest (observed <= 2e-5). The train steps follow
``test_torch_train_loop.py``'s lr-counted bounds: step 1 runs float32
weights (master weights within 0.1 x lr), later steps bf16 ones, where
each step may move an element by up to 2 x lr the other way (a gradient
near 0 changes sign under another rounding), and the median difference
within 0.05 x the last step's lr (``MEDIAN_TOL``); each loss within 1 %,
and step 1's grad norm within 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.frontend import make_frontend_stub
from repro_torch.models.parallel import greedy_tokens, leafify
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import Placement, Sharded, shard, unshard
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import ElasticRun
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.parallel import (gather_train_state,
                                        place_train_state,
                                        train_state_placements)
from repro_torch.train.trainer import (Trainer, abstract_train_state,
                                       make_grad_fn, make_loss_fn,
                                       make_train_step)
from repro_torch.models.transformer import build

TOL = 2e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEP1_TOL = 0.1
LATER_FLIPS = 2.0
MEDIAN_TOL = 0.05        # x lr of the last step
LOSS_TOL = 1e-2

# (arch, tp, data): every attention family, tp dividing its heads
CASES = [("qwen2-1.5b", 2, 2), ("starcoder2-3b", 2, 2), ("granite-3-8b", 4, 1),
         ("minitron-8b", 2, 2), ("musicgen-large", 2, 2),
         ("llava-next-34b", 7, 1), ("qwen2-moe-a2.7b", 4, 1),
         ("phi3.5-moe-42b-a6.6b", 2, 1), ("qwen2-moe-a2.7b", 2, 1)]


def close(got, want, tol=TOL, vocab=None):
    got = np.asarray(got.detach(), np.float64)
    want = np.asarray(want.detach(), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if vocab is not None:
        assert np.array_equal(got[..., vocab:], want[..., vocab:])
        got, want = got[..., :vocab], want[..., :vocab]
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.abs(want).max(initial=0.0), 1.0), err


def pair(name, tp, data, impl="jnp", seed=0, **over):
    cfg = dataclasses.replace(get_config(name, smoke=True), attn_impl=impl,
                              **over)
    one = build(cfg, tp)
    mesh = make_host_mesh(data, device="cpu", model=tp)
    par = build(cfg, tp, mesh=mesh)
    params = init_params(one.param_specs(),
                         torch.Generator().manual_seed(seed), torch.float32,
                         "cpu")
    return cfg, one, par, params, par.place(params)


def inputs(cfg, b=4, l=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l)))
    stub = make_frontend_stub(cfg, b, rng, device="cpu").get("extra_embeds")
    return toks, None if stub is None else stub.float()


# ---------------------------------------------------------------------- #
# forward, prefill, decode
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("name,tp,data", CASES)
def test_sharded_matches_one_slot(name, tp, data, impl):
    cfg, one, par, params, placed = pair(name, tp, data, impl)
    toks, stub = inputs(cfg)
    vocab = cfg.vocab_size
    got, aux = par.forward(placed, toks, stub)
    assert isinstance(got, Sharded) and got.spec == ("data", None, "model")
    # each model slot holds its vocabulary piece only
    assert got.shards[0].shape[-1] == one.vocab_p // tp
    want, want_aux = one.forward(params, toks, stub)
    close(unshard(got), want, vocab=vocab)
    close(aux, want_aux)
    cache = 32 + (0 if stub is None else stub.shape[1])
    want, ws = one.prefill(params, toks, cache, stub, dtype=torch.float32)
    got, gs = par.prefill(placed, toks, cache, stub, dtype=torch.float32)
    close(unshard(got), want, vocab=vocab)
    pos = toks.shape[1] + (0 if stub is None else stub.shape[1])
    for step in range(3):
        tok = want[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        assert torch.equal(greedy_tokens(got), tok[:, 0])
        want, ws = one.decode_step(params, tok, pos + step, ws)
        got, gs = par.decode_step(placed, tok, pos + step, gs)
        close(unshard(got), want, vocab=vocab)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-350m"])
def test_state_families_run_data_parallel(name):
    cfg, one, par, params, placed = pair(name, 1, 2)
    toks, _ = inputs(cfg, l=16)
    got, _ = par.forward(placed, toks)
    close(unshard(got), one.forward(params, toks)[0])
    want, ws = one.prefill(params, toks, 32, dtype=torch.float32)
    got, gs = par.prefill(placed, toks, 32, dtype=torch.float32)
    close(unshard(got), want)
    tok = want[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    close(unshard(par.decode_step(placed, tok, 16, gs)[0]),
          one.decode_step(params, tok, 16, ws)[0])


@pytest.mark.parametrize("name,tp", [("qwen2-moe-a2.7b", 2),
                                     ("phi3.5-moe-42b-a6.6b", 1)])
def test_moe_runs_on_more_than_one_data_group(name, tp):
    """MoE on a mesh of two data groups routes the whole batch at once,
    as the reference does (capacity, ranks and the aux loss from every
    row; the groups run in lockstep): forward, aux, prefill and 3 decode
    steps equal one slot's, which routes the same whole batch."""
    cfg, one, par, params, placed = pair(name, tp, 2)
    assert len(par.plan.groups) == 2
    assert par.layout.experts_split == (tp > 1)
    toks, _ = inputs(cfg)
    got, aux = par.forward(placed, toks)
    want, want_aux = one.forward(params, toks)
    close(unshard(got), want, vocab=cfg.vocab_size)
    close(aux, want_aux)
    want, ws = one.prefill(params, toks, 32, dtype=torch.float32)
    got, gs = par.prefill(placed, toks, 32, dtype=torch.float32)
    close(unshard(got), want, vocab=cfg.vocab_size)
    for step in range(3):
        tok = want[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        assert torch.equal(greedy_tokens(got), tok[:, 0])
        want, ws = one.decode_step(params, tok, toks.shape[1] + step, ws)
        got, gs = par.decode_step(placed, tok, toks.shape[1] + step, gs)
        close(unshard(got), want, vocab=cfg.vocab_size)


def test_greedy_breaks_ties_to_the_lower_index():
    mesh = make_host_mesh(2, device="cpu", model=2)
    x = torch.zeros(4, 1, 8)
    x[0, 0, [1, 5]] = 3.0      # a tie across the two vocab pieces
    x[1, 0, [6, 7]] = 2.0      # a tie within one piece
    x[2, 0, 4] = 1.0
    x[3, 0, :] = -1.0          # all equal
    sx = shard(x, Placement(mesh, ("data", None, "model")))
    assert greedy_tokens(sx).tolist() == [1, 6, 4, 0]
    assert greedy_tokens(sx).tolist() == x[:, -1].argmax(-1).tolist()


def test_engine_tokens_match_one_slot():
    """``ServeEngine`` on a (2, 2) mesh, float32 weights and caches: the
    same greedy tokens as on one slot."""
    cfg, one, par, params, placed = pair("qwen2-1.5b", 2, 2, "flash")

    class F32:
        def __init__(self, m):
            self.m, self.cfg = m, m.cfg

        def prefill(self, p, t, n):
            return self.m.prefill(p, t, n, dtype=torch.float32)

        def decode_step(self, *a):
            return self.m.decode_step(*a)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 10))
    want = ServeEngine(F32(one), params, 32).generate(prompts, 8)
    got = ServeEngine(F32(par), placed, 32).generate(prompts, 8)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------- #
# loss and gradients
# ---------------------------------------------------------------------- #
def sharded_grads(model, placed, batch):
    (lt,), leaves = leafify([placed])
    loss, met = make_loss_fn(model)(lt, batch)
    grads = torch.autograd.grad(loss, leaves)
    by = {id(a): g for a, g in zip(leaves, grads)}
    return loss, met, tree_map(lambda x: unshard(Sharded(
        x.placement, x.shape, tuple(by[id(p)] for p in x.shards))), lt)


@pytest.mark.parametrize("name,tp,data,over", [
    ("qwen2-1.5b", 2, 2, {}), ("starcoder2-3b", 2, 2, {}),
    ("qwen2-1.5b", 2, 2, {"fsdp": True}), ("llava-next-34b", 7, 1, {}),
    ("qwen2-moe-a2.7b", 4, 1, {}), ("musicgen-large", 1, 2, {})])
def test_loss_and_gradients_match_one_slot(name, tp, data, over):
    cfg, one, par, params, placed = pair(name, tp, data, **over)
    toks, stub = inputs(cfg, l=13, seed=4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, :3] = -1          # masked labels
    if stub is not None:
        batch["extra_embeds"] = stub
    if over.get("fsdp"):
        assert par.plan.placements["blocks"]["attn"]["mlp"]["wg"].spec == (
            None, "data", "model")
    loss, met, grads = sharded_grads(par, placed, batch)
    want_loss, want_met, want = make_grad_fn(one)(params, batch)
    close(loss, want_loss)
    close(met["ce"], want_met["ce"])
    for g, w in zip(tree_leaves(grads), want):
        close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------- #
# the ZeRO-1 train step
# ---------------------------------------------------------------------- #
def conditioned(params, model):
    """Attention projections rescaled to 1/sqrt of the width they
    contract (``test_torch_train_loop.condition``'s rule)."""
    dims, d = model.dims, model.cfg.d_model
    a = params["blocks"]["attn"]["attn"]
    for name, s in {"wq": (dims.n_heads_p / d) ** 0.5,
                    "wk": (dims.n_kv / d) ** 0.5,
                    "wv": (dims.n_kv / d) ** 0.5,
                    "wo": (1 / dims.n_heads_p) ** 0.5}.items():
        a[name] = a[name] * s
    return params


def batches(cfg, n, b=8, l=16, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, l + 1)))
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def assert_master_close(got, want, lrs):
    d = np.concatenate([(g - w).abs().double().ravel().numpy() for g, w in
                        zip(tree_leaves(got["opt"]["master"]),
                            tree_leaves(want["opt"]["master"]))])
    bound = STEP1_TOL * lrs[0] + LATER_FLIPS * sum(lrs[1:])
    assert d.max() <= bound, (d.max(), bound)
    assert np.median(d) <= MEDIAN_TOL * lrs[-1], np.median(d)


@pytest.mark.parametrize("name,tp,data,mb,over", [
    ("qwen2-1.5b", 2, 2, 2, {}), ("qwen2-moe-a2.7b", 2, 1, 2, {}),
    ("recurrentgemma-2b", 1, 2, 2, {}), ("qwen2-1.5b", 2, 2, 1,
                                         {"fsdp": True})])
def test_zero1_steps_match_one_slot(name, tp, data, mb, over):
    cfg, one, par, params, _ = pair(name, tp, data, remat="dots", **over)
    if "attn" in cfg.layer_kinds():
        params = conditioned(params, one)
    st1 = {"params": tree_map(torch.clone, params), "opt": adamw_init(params)}
    st2 = place_train_state(par, {"params": tree_map(torch.clone, params),
                                  "opt": adamw_init(params)})
    # each slot holds only its pieces: ZeRO-1 halves the optimizer state
    # over the 2 data slots where a dimension divides
    w = st2["opt"]["master"]["blocks"][next(iter(params["blocks"]))]
    first = tree_leaves(w)[0]
    assert "data" in str(first.spec)
    assert first.shards[0].numel() * data * (tp if "model" in str(
        first.spec) else 1) == np.prod(first.shape)
    s1 = make_train_step(one, AdamWConfig(**OPT), microbatches=data * mb)
    s2 = make_train_step(par, AdamWConfig(**OPT), microbatches=mb)
    lrs = []
    for k, batch in enumerate(batches(cfg, 3)):
        st1, m1 = s1(st1, batch)
        st2, m2 = s2(st2, batch)
        lrs.append(float(m1["lr"]))
        assert float(m2["lr"]) == lrs[-1]
        assert abs(float(m2["loss"]) - float(m1["loss"])) <= LOSS_TOL * abs(
            float(m1["loss"]))
        if k == 0:
            close(m2["loss"], m1["loss"])
            close(m2["grad_norm"], m1["grad_norm"], 1e-4)
            assert_master_close(gather_train_state(st2), st1, lrs)
    got = gather_train_state(st2)
    assert_master_close(got, st1, lrs)
    assert int(got["opt"]["step"]) == 3
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(got["params"]))


def test_zero1_state_init_on_the_mesh():
    """``init_train_state`` of a model on a mesh: params placed by the
    rules, master pieces cut from them (no whole optimizer state), zero
    moments; gathered, it equals the single-slot init."""
    from repro_torch.train.trainer import init_train_state
    cfg = get_config("qwen2-1.5b", smoke=True)
    one = build(cfg, 2)
    par = build(cfg, 2, mesh=make_host_mesh(2, device="cpu", model=2))
    want = init_train_state(one, torch.Generator().manual_seed(5),
                            device="cpu")
    got = init_train_state(par, torch.Generator().manual_seed(5))
    whole = gather_train_state(got)
    for a, b in zip(tree_leaves(whole), tree_leaves(want)):
        assert torch.equal(a, b)
    pl = train_state_placements(par)
    assert tree_leaves(got["opt"]["master"])[0].placement == tree_leaves(
        pl["opt"]["master"])[0]


# ---------------------------------------------------------------------- #
# checkpoints and elastic resume
# ---------------------------------------------------------------------- #
def test_checkpoint_saved_at_2x2_restores_at_1x2(tmp_path):
    cfg, one, par, params, _ = pair("qwen2-1.5b", 2, 2)
    state = place_train_state(par, {"params": params,
                                    "opt": adamw_init(params)})
    state, _ = make_train_step(par, AdamWConfig(**OPT))(
        state, batches(cfg, 1)[0])
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    small = build(cfg, 2, mesh=make_host_mesh(1, device="cpu", model=2))
    back = mgr.restore(1, abstract_train_state(small),
                       train_state_placements(small))
    leaf = back["opt"]["master"]["blocks"]["attn"]["attn"]["wq"]
    assert leaf.mesh.shape == {"data": 1, "model": 2}
    for a, b in zip(tree_leaves(gather_train_state(back)),
                    tree_leaves(gather_train_state(state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # and it trains on: one more step on each mesh agrees
    step_small = make_train_step(small, AdamWConfig(**OPT), microbatches=2)
    step_big = make_train_step(par, AdamWConfig(**OPT))
    batch = batches(cfg, 2)[1]
    a, ma = step_small(back, batch)
    b, mb = step_big(state, batch)
    assert abs(float(ma["loss"]) - float(mb["loss"])) <= LOSS_TOL * abs(
        float(mb["loss"]))


def test_elastic_run_from_4_to_2_data_slots(tmp_path):
    """``ElasticRun`` with the data-parallel step: 4 data slots, a node
    failure at step 5, resumed on 2 from the step-4 checkpoint, each
    slot count taking ``4 / slots`` microbatches so that every step
    averages the same 4 microbatches; held to the uninterrupted
    single-slot run at 4 microbatches by the lr-counted bound."""
    cfg = get_config("granite-3-8b", smoke=True)
    one = build(cfg, 1)
    params = conditioned(init_params(
        one.param_specs(), torch.Generator().manual_seed(7), torch.float32,
        "cpu"), one)
    data = batches(cfg, 8, seed=11)
    ref_state = {"params": tree_map(torch.clone, params),
                 "opt": adamw_init(params)}
    step1 = make_train_step(one, AdamWConfig(**OPT), microbatches=4)
    lrs = []
    for b in data:
        ref_state, met = step1(ref_state, b)
        lrs.append(float(met["lr"]))
    mgr = CheckpointManager(str(tmp_path / "el"), keep=2)
    built = []

    def build_for(slots):
        model = build(cfg, 1, mesh=make_host_mesh(slots, device="cpu"))
        built.append(slots)
        return (make_train_step(model, AdamWConfig(**OPT),
                                microbatches=4 // slots),
                abstract_train_state(model), train_state_placements(model))

    first = build(cfg, 1, mesh=make_host_mesh(4, device="cpu"))
    run = ElasticRun(mgr, build_for, lambda: place_train_state(
        first, {"params": tree_map(torch.clone, params),
                "opt": adamw_init(params)}))

    def factory(step_fn):
        return Trainer(step_fn, lambda i: data[i], mgr, checkpoint_every=2)
    state, step = run.run_with_failures(
        factory, len(data), failure_schedule={0: 5},
        device_schedule={0: 4, 5: 2})
    assert step == len(data) and built == [4, 2]
    leaf = state["params"]["embed"]
    assert leaf.mesh.shape == {"data": 2}
    assert_master_close(gather_train_state(state), ref_state, lrs)


def test_model_partials_of_a_replicated_weight_are_summed():
    """A weight replicated over ``model`` whose slots held distinct
    copies (one per card) gets the sum of their partial gradients in
    every slot of the group; slots that shared one copy keep its
    gradient, which autograd already summed."""
    from repro_torch.train.parallel import _sum_model_partials
    mesh = make_host_mesh(2, device="cpu", model=3)
    groups = [[0, 1, 2], [3, 4, 5]]
    a, b, c = (torch.full((2,), v) for v in (1.0, 2.0, 4.0))
    shared = torch.full((2,), 8.0)
    out = _sum_model_partials([a, b, c, shared, shared, shared], groups,
                              mesh.devices)
    assert all(torch.equal(x, torch.full((2,), 7.0)) for x in out[:3])
    assert all(x is shared for x in out[3:])
    d = torch.full((2,), 16.0)
    out = _sum_model_partials([a, a, d, shared, shared, shared], groups,
                              mesh.devices)
    assert all(torch.equal(x, torch.full((2,), 17.0)) for x in out[:3])
