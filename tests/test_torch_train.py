"""PyTorch port vs JAX package: the training path's pieces on the CPU.

Inputs are made from a seed with numpy, or drawn by the reference's
``init_params`` and carried across bit for bit (``params_from_reference``,
``train_state_from_reference``). Held here:

- ``TokenStream.batch_at``: int32 tokens and labels bit-equal;
- ``quantize``/``dequantize``: codes, scales and values bit-equal (both
  round half to even);
- ``make_loss_fn``: loss, ce, aux and every gradient leaf for all 10
  archs' smoke configs (llava through its vision stub, the stub's prefix
  positions dropped), float32 weights;
- ``adamw_update``: the float32 state after two updates on identical
  float32 grads (``param_dtype=float32`` passed to both), ``cosine_lr``
  and the clip scale bit-equal;
- remat ``none``/``dots``/``full`` and the xLSTM cells' training
  checkpoints: equal numbers, the blocks recomputed in the backward, and
  the products ``"dots"`` saves;
- K7 refuses autograd (``NoBackwardError``) on the CPU too, and runs as
  before under ``no_grad``.

Tolerances: float32 gradients within 1e-4 of each leaf's largest |g|
(observed <= 6e-5: XLA's and torch's summation orders through the
layers, the softmax and the loss's reductions); losses within 1e-5
relative; the AdamW state within 1e-6 of each leaf's largest magnitude
(the elementwise update rounds alike; the clip scale's global norm sums
the leaves in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES
from repro.configs import get_config as ref_get_config
from repro.data.synth import TokenStream as RefTokenStream
from repro.models import ssm as ref_ssm
from repro.models.frontend import make_frontend_stub as ref_stub
from repro.models.params import init_params as ref_init_params
from repro.models.transformer import build as ref_build
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro.train.trainer import make_loss_fn as ref_loss_fn
from repro_torch.configs import get_config
from repro_torch.data.synth import TokenStream
from repro_torch.errors import NoBackwardError
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import ssm as port_ssm
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.models.frontend import make_frontend_stub
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.models.transformer import build
from repro_torch.train import compression, optimizer
from repro_torch.train.trainer import make_loss_fn

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
OPT_TOL = 1e-6


def to_torch(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def close_leaf(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, (what, err, scale)


def close_trees(got, want, tol):
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    ported = tree_leaves(got)
    assert len(paths) == len(ported)
    for path, g, w in zip(paths, ported, jax.tree.leaves(want)):
        close_leaf(g, w, tol, path)


def port_grads(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss, metrics = loss_fn(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,vocab,batch,seq", [(0, 151, 4, 16),
                                                  (17, 151936, 2, 33),
                                                  (3, 2, 1, 1)])
def test_token_stream_bit_equal(seed, vocab, batch, seq):
    ref = RefTokenStream(vocab, batch, seq, seed=seed)
    port = TokenStream(vocab, batch, seq, seed=seed, device="cpu")
    for step in (0, 1, 7, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32, key
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    assert torch.equal(port.batch_at(5)["tokens"],
                       port.batch_at(5)["tokens"])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dequantize_bit_equal(bits):
    rng = np.random.default_rng(bits)
    scale = 2.0 ** (bits - 1) - 1
    cases = [rng.normal(size=(64, 33)).astype(np.float32),
             np.zeros((5,), np.float32),
             # exact halves of a code: round half to even in both
             (np.arange(-9, 10, dtype=np.float32) + 0.5) / scale,
             np.array([3.0, -3.0, 1.5, 0.75], np.float32)]
    for x in cases:
        codes, sc = ref_comp.quantize(jnp.asarray(x), bits)
        pc, ps = compression.quantize(torch.from_numpy(x), bits)
        assert pc.dtype == torch.int8 and ps.dtype == torch.float32
        np.testing.assert_array_equal(pc.numpy(), np.asarray(codes))
        assert ps.item() == float(sc)
        np.testing.assert_array_equal(
            compression.dequantize(pc, ps).numpy(),
            np.asarray(ref_comp.dequantize(codes, sc)))


# ---------------------------------------------------------------------- #
def loss_setup(name):
    cfg = ref_get_config(name, smoke=True)
    rm, pm = ref_build(cfg), build(get_config(name, smoke=True))
    rp = ref_init_params(rm.param_specs(), jax.random.key(0), jnp.float32)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    pb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "labels": torch.from_numpy(toks[:, 1:].copy())}
    rb.update(ref_stub(cfg, 2, np.random.default_rng(1)))
    pb.update(make_frontend_stub(cfg, 2, np.random.default_rng(1),
                                 device="cpu"))
    return rm, pm, rp, to_torch(rp), rb, pb


def port_setup(name):
    """The port's own float32 weights (seeded) and a batch, for checks
    that hold the port against itself."""
    model = build(get_config(name, smoke=True))
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 17)).astype(np.int32))
    return params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", list(ALIASES))
def test_loss_and_grads_match_reference(name):
    """Every arch's loss, ce, aux and gradient tree, float32."""
    rm, pm, rp, pp, rb, pb = loss_setup(name)
    (want, wmet), wg = jax.jit(jax.value_and_grad(
        ref_loss_fn(rm), has_aux=True))(rp, rb)
    loss, met, grads = port_grads(make_loss_fn(pm), pp, pb)
    assert loss.dtype == torch.float32
    for got, ref in ((loss, want), (met["ce"], wmet["ce"]),
                     (met["aux"], wmet["aux"])):
        assert abs(float(got) - float(ref)) <= LOSS_TOL * max(
            abs(float(ref)), 1.0)
    if name in ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"):
        assert float(met["aux"]) > 0
    close_trees(grads, wg, GRAD_TOL)


def test_loss_masks_negative_labels_and_prefix():
    """labels < 0 drop out of the mean as in the reference (one row fully
    masked), and the vision stub's prefix positions carry no label."""
    rm, pm, rp, pp, rb, pb = loss_setup("llava-next-34b")
    labels = np.asarray(rb["labels"]).copy()
    labels[0, ::3] = -1
    labels[1] = -100
    rb["labels"] = jnp.asarray(labels)
    pb["labels"] = torch.from_numpy(labels)
    (want, _), wg = jax.jit(jax.value_and_grad(ref_loss_fn(rm),
                                               has_aux=True))(rp, rb)
    loss, _, grads = port_grads(make_loss_fn(pm), pp, pb)
    assert abs(float(loss) - float(want)) <= LOSS_TOL * abs(float(want))
    close_trees(grads, wg, GRAD_TOL)


# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_steps=2, total_steps=100),
    dict(lr=3e-4, warmup_steps=1, total_steps=6, clip_norm=0.05),
    dict()])
def test_adamw_update_matches_reference(cfg):
    """Two updates on identical float32 grads from a float32 state: lr,
    grad norm, and the whole state; ``param_dtype=float32`` passed to
    both, so params stay float32."""
    specs = ref_build(ref_get_config("qwen2-1.5b", smoke=True)).param_specs()
    params = ref_init_params(specs, jax.random.key(3), jnp.float32)
    rstate = ref_opt.adamw_init(params)
    pstate = train_state_from_reference(
        jax.tree.map(np.asarray, {"params": params, "opt": rstate}),
        device="cpu")["opt"]
    rc, pc = ref_opt.AdamWConfig(**cfg), optimizer.AdamWConfig(**cfg)
    ref_update = jax.jit(ref_opt.adamw_update, static_argnums=(0, 3))
    for k in range(2):
        grads = ref_init_params(specs, jax.random.key(10 + k), jnp.float32)
        rp, rstate, rmet = ref_update(rc, grads, rstate, jnp.float32)
        pp, pstate, pmet = optimizer.adamw_update(
            pc, to_torch(grads), pstate, param_dtype=torch.float32)
        assert pstate["step"].dtype == torch.int32
        assert int(pstate["step"]) == int(rstate["step"]) == k + 1
        assert float(pmet["lr"]) == float(rmet["lr"])      # bit-equal
        assert abs(float(pmet["grad_norm"]) - float(rmet["grad_norm"])) \
            <= OPT_TOL * float(rmet["grad_norm"])
        assert all(p.dtype == torch.float32 for p in tree_leaves(pp))
        for key in ("master", "m", "v"):
            close_trees(pstate[key], rstate[key], OPT_TOL)
        close_trees(pp, rp, OPT_TOL)


def test_adamw_keeps_the_bf16_default_and_inplace():
    """The reference's quirk: the default param_dtype is bf16, so float32
    params come back bf16; ``inplace=True`` writes the new state into the
    given tensors, ``inplace=False`` leaves them untouched, and both give
    the same numbers."""
    params = {"a": torch.linspace(-1, 1, 7), "b": {"c": torch.ones(2, 3)}}
    grads = tree_map(lambda p: torch.full_like(p, 0.5), params)
    state = optimizer.adamw_init(params)
    assert state["master"]["a"].data_ptr() != params["a"].data_ptr()
    cfg = optimizer.AdamWConfig(warmup_steps=1)
    before = tree_map(torch.clone, state)
    p1, s1, _ = optimizer.adamw_update(cfg, grads, state)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(before), tree_leaves(state)))
    p2, s2, _ = optimizer.adamw_update(cfg, grads, state, inplace=True)
    assert s2["m"]["a"] is state["m"]["a"]
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(p1))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves({"p": p1, "s": s1}),
                   tree_leaves({"p": p2, "s": s2})))


@pytest.mark.parametrize("step", [0, 1, 2, 3, 50, 99, 100, 5000, 10000,
                                  20000])
def test_cosine_lr_bit_equal(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = ref_opt.cosine_lr(ref_opt.AdamWConfig(**cfg),
                             jnp.asarray(step, jnp.int32))
    got = optimizer.cosine_lr(optimizer.AdamWConfig(**cfg),
                              torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(want)


# ---------------------------------------------------------------------- #
class Calls:
    """Counts the calls of ``owner.name`` (a module function or a method)
    while installed with ``monkeypatch``."""

    def __init__(self, monkeypatch, owner, name):
        self.n, fn = 0, getattr(owner, name)

        def counted(*args, **kw):
            self.n += 1
            return fn(*args, **kw)
        monkeypatch.setattr(owner, name, counted)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-2b"])
def test_remat_modes_equal(name, monkeypatch):
    """remat none / dots / full: the same loss and gradients bit for bit
    on the CPU. Under dots and full each layer runs again in the backward
    pass (two calls a layer), under none once. (remat "none" is held
    against the reference by the loss test above.)"""
    pp, pb = port_setup(name)
    out = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(get_config(name, smoke=True), remat=mode)
        model = build(cfg)
        calls = Calls(monkeypatch, model, "_apply_block")
        out[mode] = port_grads(make_loss_fn(model), pp, pb)
        assert calls.n == cfg.n_layers * (1 if mode == "none" else 2), mode
    for mode in ("dots", "full"):
        assert torch.equal(out[mode][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(out[mode][2]),
                       tree_leaves(out["none"][2])))


def test_remat_nests_the_xlstm_checkpoints(monkeypatch):
    """xlstm at L = 512 with remat "dots": the sLSTM's 256-token chunks and
    the mLSTM's groups of 4 chunks run their own checkpoints inside each
    layer's selective one. Loss equal; gradients within 1e-6 of each
    leaf's largest |g| of the remat-free run (the nesting reorders the
    sums of a leaf's gradient contributions: observed 7.6e-8)."""
    cfg = get_config("xlstm-350m", smoke=True)
    params = init_params(build(cfg).param_specs(),
                         torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 513)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for mode in ("none", "dots"):
        model = build(dataclasses.replace(cfg, remat=mode))
        calls = Calls(monkeypatch, port_ssm, "_slstm_steps")
        out[mode] = port_grads(make_loss_fn(model), params, batch)
        # two chunks a sLSTM layer, run again by its checkpoint, and once
        # more inside the layer's recompute under "dots"
        n = cfg.layer_kinds().count("slstm") * 2
        assert calls.n == (2 * n if mode == "none" else 3 * n), mode
        monkeypatch.undo()
    assert torch.equal(out["dots"][0], out["none"][0])
    for got, want in zip(tree_leaves(out["dots"][2]),
                         tree_leaves(out["none"][2])):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def test_dots_policy_saves_the_weight_products(monkeypatch):
    """``"dots"``'s policy, as the forward pass asks it: qwen2's seven
    weight products a layer (q, k, v and o as einsums over a batch of one,
    the three MLP matmuls) are saved; attention's score and value products
    (batched over batch and heads) and everything else are recomputed."""
    from repro_torch.models import transformer
    decisions = []
    policy = transformer._dots_policy

    def record(ctx, op, *args, **kw):
        out = policy(ctx, op, *args, **kw)
        if not ctx.is_recompute:
            decisions.append((op, out, tuple(args[0].shape)
                              if args and hasattr(args[0], "shape") else ()))
        return out
    monkeypatch.setattr(transformer, "_dots_policy", record)
    pp, pb = port_setup("qwen2-1.5b")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              remat="dots")
    port_grads(make_loss_fn(build(cfg)), pp, pb)
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    saved = [(str(op), shape) for op, how, shape in decisions if how == save]
    assert len(saved) == 7 * cfg.n_layers, saved
    assert {op for op, _ in saved} == {"aten.mm.default", "aten.bmm.default"}
    assert all(shape[0] == 1 for op, shape in saved if "bmm" in op)
    batched = [shape for op, how, shape in decisions
               if str(op) == "aten.bmm.default" and shape[0] > 1]
    assert batched and all(how != save for op, how, shape in decisions
                           if str(op) == "aten.bmm.default"
                           and shape[0] > 1)


def test_remat_is_off_without_grad():
    """Under no_grad (and for the prefill and decode paths) nothing is
    checkpointed; the forward's logits equal the remat-free build's."""
    pp, pb = port_setup("qwen2-1.5b")
    cfg = get_config("qwen2-1.5b", smoke=True)
    with torch.no_grad():
        a = build(dataclasses.replace(cfg, remat="dots")).forward(
            pp, pb["tokens"])[0]
        b = build(cfg).forward(pp, pb["tokens"])[0]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        build(dataclasses.replace(cfg, remat="offload"))


def test_layers_slice_each_stack_once():
    """``Model.layers`` unbinds each stacked leaf once: every layer's
    leaves are views of the stack, and ``Model.layer`` is its entry i."""
    pp, _ = port_setup("qwen2-1.5b")
    pm = build(get_config("qwen2-1.5b", smoke=True))
    layers = pm.layers(pp, "attn")
    assert len(layers) == pm.cfg.n_layers
    for i, layer in enumerate(layers):
        for got, stack in zip(tree_leaves(layer),
                              tree_leaves(pp["blocks"]["attn"])):
            assert got._base is stack or got._base is stack._base
            assert torch.equal(got, stack[i])
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(pm.layer(pp, i)), tree_leaves(layer)))


def mlstm_arrays(l, seed=0):
    rng = np.random.default_rng(seed)
    b, h, d = 2, 2, 8
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32)
               for _ in range(3))
    it, ft = (rng.normal(size=(b, l, h)).astype(np.float32) * 2
              for _ in range(2))
    return [q, k, v, it, ft]


def test_mlstm_ckpt_group_grads_match_reference(monkeypatch):
    """L = 64 in chunks of 4: 16 chunks, 4 checkpointed groups of 4 in
    both packages. The gradients of a scalar of the output and the final
    state with respect to every input against ``jax.grad``; the grouped
    path recomputes each chunk once in the backward (32 chunk calls, 16
    without the checkpoint) and gives the same numbers."""
    arrs = mlstm_arrays(64)
    b, _, h, d = arrs[0].shape

    def ref_obj(*xs):
        out, st = ref_ssm.mlstm_cell(*xs, ref_ssm.init_mlstm_state(b, h, d, d),
                                     4)
        return out.sum() + st["C"].sum() * 0.1
    wg = jax.grad(ref_obj, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    grads = {}
    for group in (4, 64):
        calls = Calls(monkeypatch, port_ssm, "_mlstm_chunk")
        out, st = port_ssm.mlstm_cell(
            *xs, port_ssm.init_mlstm_state(b, h, d, d, device="cpu"), 4,
            ckpt_group=group)
        grads[group] = torch.autograd.grad(out.sum() + st["C"].sum() * 0.1,
                                           xs)
        assert calls.n == (32 if group == 4 else 16), group
        monkeypatch.undo()
    for g, w in zip(grads[4], wg):
        close_leaf(g, w, GRAD_TOL)
    assert all(torch.equal(a, b) for a, b in zip(grads[4], grads[64]))


def test_slstm_time_chunk_grads_match_reference(monkeypatch):
    """L = 512: two checkpointed chunks of 256 tokens in both packages;
    gradients of the block's output with respect to x and every weight."""
    d, heads = 16, 2
    specs = ref_ssm.slstm_specs(1, d, heads)
    p = jax.tree.map(lambda a: a[0], ref_init_params(
        specs, jax.random.key(5), jnp.float32))
    x = np.random.default_rng(6).normal(size=(1, 512, d)).astype(np.float32)

    def ref_obj(p, x):
        out, st = ref_ssm.slstm_block(p, x, heads, 1e-5)
        return (out ** 2).mean() + st["c"].mean()
    wp, wx = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(p, jnp.asarray(x))
    pp = tree_map(lambda a: a.requires_grad_(), to_torch(p))
    xt = torch.from_numpy(x).requires_grad_()
    calls = Calls(monkeypatch, port_ssm, "_slstm_steps")
    out, st = port_ssm.slstm_block(pp, xt, heads, 1e-5)
    obj = (out ** 2).mean() + st["c"].mean()
    leaves = tree_leaves(pp)
    grads = torch.autograd.grad(obj, leaves + [xt])
    assert calls.n == 4     # two chunks, each run again in the backward
    close_leaf(grads[-1], wx, GRAD_TOL, "x")
    for path, g, w in zip(sorted(pp), grads[:-1], jax.tree.leaves(wp)):
        close_leaf(g, w, GRAD_TOL, path)


# ---------------------------------------------------------------------- #
def k7_operands(requires_grad):
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 20, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 20, 2, 16))
                             .astype(np.float32)) for _ in range(2))
    if requires_grad:
        k.requires_grad_()
    return q, k, v


def test_k7_refuses_autograd_on_the_cpu():
    """Grad mode on and an operand that requires grad: both entry points
    raise NoBackwardError before the plain version runs (the reference's
    kernel has no backward either); under no_grad, inference_mode, or
    with no operand requiring grad, the output is as before."""
    q, k, v = k7_operands(True)
    with pytest.raises(NoBackwardError, match='attn_impl="jnp"'):
        fa.flash_attention_blhd(q, k, v, scale=0.25)
    merged = [x.detach()[0, :, :2].transpose(0, 1).contiguous()
              for x in (q, q, q)]
    merged[2].requires_grad_()
    with pytest.raises(NoBackwardError):
        fa.flash_attention_bhld(*merged, scale=0.25)
    with pytest.raises(NoBackwardError):
        ops.flash_attention(q, k, v)
    want = fa.flash_attention_blhd_ref(q.detach(), k.detach(), v.detach(),
                                       scale=0.25)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention_blhd(q, k, v, scale=0.25),
                           want)
    with torch.inference_mode():
        assert torch.equal(fa.flash_attention_blhd(q, k, v, scale=0.25),
                           want)
    assert torch.equal(fa.flash_attention_blhd(*k7_operands(False),
                                               scale=0.25), want)


def test_flash_model_refuses_training():
    """A model built with attn_impl="flash" refuses a training loss (its
    weights require grad) and still serves under no_grad."""
    pp, pb = port_setup("qwen2-1.5b")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              attn_impl="flash")
    model = build(cfg)
    with pytest.raises(NoBackwardError):
        port_grads(make_loss_fn(model), pp, pb)
    with torch.no_grad():
        got = model.forward(pp, pb["tokens"])[0]
        want = build(dataclasses.replace(cfg, attn_impl="jnp")).forward(
            pp, pb["tokens"])[0]
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
