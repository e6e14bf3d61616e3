"""PyTorch port vs JAX package: the sharding layer on the CPU.

Held against the reference (``repro.sharding.rules``,
``repro.models.params.abstract_params``, ``repro.train.optimizer.
zero1_shardings``, ``repro.models.frontend.frontend_input_specs``,
``repro.models.attention.attention(unroll=True)``), exactly:

- every param spec of the 10 archs (full configs, built at ``tp`` = the
  mesh's ``model`` size, the rules with each config's ``fsdp``) resolved
  to spec tuples on ``(pod, data, model) = (2, 2, 4)`` and
  ``(data, model) = (16, 16)`` meshes, strict and not, and their ZeRO-1
  widening; the reference reads only ``mesh.shape``, so it runs on a
  ``jax.sharding.AbstractMesh`` of the same shape, and the port on a mesh
  of ``meta`` slots (``make_production_mesh(device="meta")``);
- ``logical_to_spec``'s fallback, ``strict`` and used-axis cases.

And the port's own pieces, against numpy or a hand count: the N-axis
``Mesh`` (coordinates, groups, the join on a two-axis mesh equal to the
one-axis join), ``shard``/``unshard`` (each slot holds only its piece;
slots that share a device share a replicated one), the collectives
(values, gradients, the counter's bytes against a hand count for one
layer), ``with_sharding_constraint_logical`` and the named errors. Exact
comparisons are exact; the float32 ones state their tolerance beside
them.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro_torch
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models.frontend import frontend_input_specs as ref_inputs
from repro.models.params import abstract_params as ref_abstract
from repro.models.params import init_params as ref_init_params
from repro.models.transformer import build as ref_build
from repro.sharding import rules as ref_rules
from repro.train.optimizer import zero1_shardings as ref_zero1
from repro_torch.configs import get_config
from repro_torch.data.synth import make_join_dataset
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import attention as port_attn
from repro_torch.models.convert import params_from_reference
from repro_torch.models.frontend import frontend_input_specs
from repro_torch.models.layers import with_sharding_constraint_logical
from repro_torch.models.parallel import SlotLayout
from repro_torch.models.params import (abstract_params, gather_params,
                                       init_params, param_placements,
                                       place_params, tree_leaves)
from repro_torch.models.transformer import build
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules as port_rules
from repro_torch.sharding.placed import Sharded, shard, unshard
from repro_torch.train.optimizer import zero1_shardings

MESHES = {"pod2x2x4": ((2, 2, 4), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model"))}


def meta_mesh(sizes, names) -> Mesh:
    return Mesh(("meta",) * math.prod(sizes), names, sizes)


def ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes"))


# ---------------------------------------------------------------------- #
# rules, placements and ZeRO-1 against the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", REF_ARCHS)
def test_specs_and_zero1_match_reference(name, mesh_name):
    sizes, names = MESHES[mesh_name]
    tp = sizes[-1]
    ref_cfg = ref_get_config(name)
    rmodel = ref_build(ref_cfg, tp)
    pmodel = build(get_config(name), tp)
    rmesh = AbstractMesh(sizes, names)
    pmesh = (make_production_mesh(device="meta") if mesh_name == "16x16"
             else meta_mesh(sizes, names))
    rr = ref_rules.Rules.default(fsdp=ref_cfg.fsdp)
    pr = port_rules.Rules.default(fsdp=ref_cfg.fsdp)
    assert pr == port_rules.Rules(rr.table)
    rspecs = ref_leaves(rmodel.param_specs())
    pspecs = tree_leaves(pmodel.param_specs())
    for rs, ps in zip(rspecs, pspecs):
        assert (rs.shape, rs.axes) == (ps.shape, ps.axes)
        for strict in (False, True):
            try:
                want = tuple(ref_rules.logical_to_spec(
                    rmesh, rr, rs.axes, rs.shape, strict=strict))
            except ValueError as e:
                with pytest.raises(ValueError, match="not divisible"):
                    port_rules.logical_to_spec(pmesh, pr, ps.axes, ps.shape,
                                               strict=strict)
                assert "not divisible" in str(e)
                continue
            assert port_rules.logical_to_spec(
                pmesh, pr, ps.axes, ps.shape, strict=strict) == want
    rabs = ref_abstract(rmodel.param_specs(), rmesh, rr)
    pabs = abstract_params(pmodel.param_specs(), pmesh, pr)
    for ra, pa in zip(jax.tree.leaves(rabs), tree_leaves(pabs)):
        assert tuple(ra.sharding.spec) == pa.spec
        assert pa.shards[0].is_meta and pa.dtype == torch.bfloat16
        assert tuple(pa.shards[-1].shape) == pa.placement.local_shape(
            ra.shape)
    rz = ref_zero1(rabs, rmesh)
    pz = zero1_shardings(pabs, pmesh)
    assert tuple(rz["step"].spec) == pz["step"].spec == ()
    for key in ("master", "m", "v"):
        assert [tuple(s.spec) for s in jax.tree.leaves(rz[key])] == [
            p.spec for p in tree_leaves(pz[key])]


def test_production_mesh_and_zero1_without_data():
    for multi, shape in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        assert mesh.shape == shape and mesh.size == math.prod(shape.values())
        assert list(mesh.shape) == list(shape)     # ordered
    cpu = make_production_mesh(device="cpu")
    assert cpu.devices == (torch.device("cpu"),) * 256
    only_model = Mesh(("meta",) * 4, ("model",))
    assert zero1_shardings({}, only_model) is None
    assert ref_zero1({}, AbstractMesh((4,), ("model",))) is None


@pytest.mark.parametrize("axes,sizes,strict", [
    (("batch", "seq", "embed"), (8, 16, 32), False),
    (("batch", None, "vocab"), (6, 4, 151), False),     # 6 % 4, 151 % 4
    (("batch", None, "vocab"), (6, 4, 151), True),
    (("heads", "kv_heads"), (8, 8), False),              # model used once
    (("embed_fsdp", "mlp"), (64, 96), False),
    (("experts", "expert_mlp"), (6, 12), False),
    (("seq_sharded", "batch"), (16, 8), False),          # data used once
    (("state", "layers"), (12, 3), False),
    (("capacity", "head_dim"), (5, 7), False),
])
def test_logical_to_spec_cases(axes, sizes, strict):
    rmesh = AbstractMesh((2, 2, 4), ("pod", "data", "model"))
    pmesh = meta_mesh((2, 2, 4), ("pod", "data", "model"))
    for fsdp in (False, True):
        rr = ref_rules.Rules.default(fsdp=fsdp)
        pr = port_rules.Rules.default(fsdp=fsdp)
        try:
            want = tuple(ref_rules.logical_to_spec(rmesh, rr, axes, sizes,
                                                   strict=strict))
        except ValueError:
            with pytest.raises(ValueError, match="not divisible"):
                port_rules.logical_to_spec(pmesh, pr, axes, sizes,
                                           strict=strict)
            continue
        assert port_rules.logical_to_spec(pmesh, pr, axes, sizes,
                                          strict=strict) == want
        assert port_rules.logical_to_spec(pmesh, pr, axes) == tuple(
            ref_rules.logical_to_spec(rmesh, rr, axes))
    assert port_rules.axis_size(pmesh, ("pod", "data", "x")) == 4
    assert port_rules.pad_to_multiple(151, 4) == ref_rules.pad_to_multiple(
        151, 4) == 152
    with pytest.raises(KeyError, match="unknown logical axis"):
        port_rules.Rules.default().lookup("nope")


# ---------------------------------------------------------------------- #
# the mesh
# ---------------------------------------------------------------------- #
def test_mesh_grid_coords_and_groups():
    mesh = make_host_mesh(2, device="cpu", model=3)
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert [mesh.coords(s) for s in (0, 4)] == [
        {"data": 0, "model": 0}, {"data": 1, "model": 1}]
    assert mesh.groups(("model",)) == [[0, 1, 2], [3, 4, 5]]
    assert mesh.groups(("data",)) == [[0, 3], [1, 4], [2, 5]]
    assert mesh.groups(("pod",)) == [[s] for s in range(6)]
    assert make_host_mesh(3, device="cpu").axis_names == ("data",)
    with pytest.raises(ValueError, match="do not hold"):
        Mesh(("cpu",) * 3, ("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="distinct axis names"):
        Mesh(("cpu",) * 2, ("data", "data"), (1, 2))


def test_join_on_a_two_axis_mesh_runs_along_data():
    """The reference's join reads the ``data`` axis of a many-axis mesh
    (``global_config.mesh_axis``); so does the port, each shard on its
    data slot: the pairs and stats equal the one-axis mesh's."""
    R, S = make_join_dataset("dblp", 0.02, 0)
    one = repro_torch.join(R, S, 0.3, method="lfvt",
                           mesh=make_host_mesh(2, device="cpu"))
    two = repro_torch.join(R, S, 0.3, method="lfvt",
                           mesh=make_host_mesh(2, device="cpu", model=2))
    assert one.pairs == two.pairs and len(one.pairs) > 0
    assert one.stats["walk_steps"] == two.stats["walk_steps"]
    no_data = Mesh(("cpu",) * 2, ("pod", "model"), (1, 2))
    with pytest.raises(ValueError, match="'data' axis"):
        repro_torch.join(R, S, 0.3, method="lfvt", mesh=no_data)


# ---------------------------------------------------------------------- #
# placed tensors
# ---------------------------------------------------------------------- #
def test_shard_unshard_and_storage():
    mesh = make_host_mesh(2, device="cpu", model=2)
    x = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
    for spec in [(), ("data",), (None, "model"), ("model", None, "data"),
                 ((None), ("data", "model")), (None, None, ("model",
                                                            "data"))]:
        p = port_rules.Placement(mesh, spec)
        sx = shard(x, p)
        assert torch.equal(unshard(sx), x)
        local = p.local_shape(tuple(x.shape))
        for s, piece in enumerate(sx.shards):
            assert tuple(piece.shape) == local
            assert torch.equal(piece, x[p.slices(tuple(x.shape), s)])
            if local != tuple(x.shape):   # only its piece, its own storage
                assert piece.untyped_storage().nbytes() == (
                    piece.numel() * 4)
        # slots holding one piece on one device share it
        distinct = len({id(piece) for piece in sx.shards})
        assert distinct == math.prod(p.pieces(i) for i in range(3))
        assert len(sx.owned()) == distinct
    rep = shard(x, port_rules.Placement(mesh, ()))
    assert all(piece is x for piece in rep.shards)
    with pytest.raises(ValueError, match="lacks"):
        port_rules.Placement(mesh, ("pod",))
    with pytest.raises(ValueError, match="does not divide"):
        shard(torch.zeros(3), port_rules.Placement(mesh, ("data",)))


def test_with_sharding_constraint_logical():
    x = torch.randn(4, 6)
    rules = port_rules.Rules.default()
    assert with_sharding_constraint_logical(x, None, rules,
                                            ("batch", "vocab")) is x
    mesh = make_host_mesh(2, device="cpu", model=3)
    sx = with_sharding_constraint_logical(x, mesh, rules, ("batch", "vocab"))
    assert sx.spec == ("data", "model") and torch.equal(unshard(sx), x)
    assert with_sharding_constraint_logical(sx, mesh, rules,
                                            ("batch", "vocab")) is sx
    moved = with_sharding_constraint_logical(sx, mesh, rules,
                                             ("vocab", "batch"))
    assert moved.spec == (None, "data") and torch.equal(unshard(moved), x)


def test_frontend_input_specs_match_reference():
    for name in REF_ARCHS:
        cfg = ref_get_config(name)
        want = ref_inputs(cfg, 3)
        got = frontend_input_specs(get_config(name), 3)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].is_meta and got[k].dtype == torch.bfloat16
            assert str(want[k].dtype) == "bfloat16"


def test_attention_unroll_changes_no_number():
    """``attention(unroll=True)`` is the reference's Python loop over the
    chunks; the port's loop is one already. Both flags against the
    reference's, float32, 1e-5 of the largest value (summation orders)."""
    cfg = ref_get_config("starcoder2-3b", smoke=True)   # window 8
    dims = ref_attn.make_dims(cfg)
    specs = ref_attn.attn_specs(1, cfg.d_model, dims, False)
    rp = jax.tree.map(lambda a: a[0], ref_init_params(
        specs, jax.random.key(0), jnp.float32))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(32, dtype=np.int32)
    want = np.asarray(ref_attn.attention(rp, jnp.asarray(x), jnp.asarray(pos),
                                         dims, 1e4, chunk=8, unroll=True))
    pdims = port_attn.make_dims(get_config("starcoder2-3b", smoke=True))
    for unroll in (False, True):
        got = port_attn.attention(pp, torch.from_numpy(x),
                                  torch.from_numpy(pos), pdims, 1e4,
                                  chunk=8, unroll=unroll).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------- #
# collectives
# ---------------------------------------------------------------------- #
def test_collectives_values_and_counter():
    rng = np.random.default_rng(0)
    xs_np = [rng.normal(size=(4, 6)).astype(np.float32) for _ in range(3)]
    xs = [torch.from_numpy(a) for a in xs_np]
    coll.counter.reset()
    s = coll.all_reduce(xs)
    assert all(o is s[0] for o in s)          # one device: one result
    np.testing.assert_allclose(s[0].numpy(), sum(xs_np), rtol=1e-6)
    mx = coll.all_reduce(xs, op="max")
    np.testing.assert_array_equal(mx[0].numpy(), np.maximum.reduce(xs_np))
    g = coll.all_gather(xs, 1)
    np.testing.assert_array_equal(g[0].numpy(), np.concatenate(xs_np, 1))
    ys = [torch.from_numpy(rng.normal(size=(6, 3)).astype(np.float32))
          for _ in range(3)]
    rs = coll.reduce_scatter(ys, 0)
    for k, piece in enumerate(rs):
        np.testing.assert_allclose(
            piece.numpy(), sum(y.numpy() for y in ys)[2 * k:2 * k + 2],
            rtol=1e-6)
    a2a = coll.all_to_all(ys, 0, 1)
    for j, out in enumerate(a2a):
        np.testing.assert_array_equal(out.numpy(), np.concatenate(
            [y.numpy()[2 * j:2 * j + 2] for y in ys], axis=1))
    snap = coll.counter.snapshot()
    b, by = 4 * 6 * 4, 6 * 3 * 4        # bytes of one x, one y
    assert snap["calls"] == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 1}
    assert snap["bytes"] == {"all-reduce": 2 * 3 * b, "all-gather": 3 * b,
                             "reduce-scatter": 3 * by, "all-to-all": 3 * by}
    assert snap["total"] == sum(snap["bytes"].values())
    one = coll.all_reduce(xs[:1])            # one slot: nothing moves
    assert one[0] is xs[0] and coll.counter.calls["all-reduce"] == 2
    with pytest.raises(ValueError, match="does not divide"):
        coll.reduce_scatter(xs, 0)
    with pytest.raises(ValueError, match="op must be"):
        coll.all_reduce(xs, op="min")


def test_collectives_are_differentiable_adjoints():
    """An all_gather's backward is a reduce_scatter of the output
    gradients, an all_reduce's an all_reduce: float32, 1e-6."""
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
          .requires_grad_() for _ in range(2)]
    ws = [torch.from_numpy(rng.normal(size=(2, 6)).astype(np.float32))
          for _ in range(2)]
    outs = [coll.all_gather(xs, 1, ["cpu", "cpu"])[k] for k in range(2)]
    # two slots on one device share one gathered tensor: give each its
    # own use
    loss = sum((o * w).sum() for o, w in zip(outs, ws))
    grads = torch.autograd.grad(loss, xs)
    want = coll.reduce_scatter(ws, 1)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    red = coll.all_reduce(xs)
    loss = sum((r * w[:, :3]).sum() for r, w in zip(red, ws))
    grads = torch.autograd.grad(loss, xs)
    for g in grads:
        torch.testing.assert_close(g, ws[0][:, :3] + ws[1][:, :3])


def test_counter_hand_count_for_one_layer():
    """A one-layer qwen2 smoke forward on a (data=1, model=2) mesh moves:
    the vocab-split embedding's all_reduce, the attention's and the MLP's
    (each a (B, L, d) float32 partial from each of the 2 slots); the
    logits stay split, so nothing else."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              n_layers=1)
    b, l, d = 2, 5, cfg.d_model
    model = build(cfg, 2, mesh=make_host_mesh(1, device="cpu", model=2))
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    placed = model.place(params)
    coll.counter.reset()
    model.forward(placed, torch.zeros((b, l), dtype=torch.long))
    snap = coll.counter.snapshot()
    assert snap["calls"] == {"all-reduce": 3, "all-gather": 0,
                             "reduce-scatter": 0, "all-to-all": 0}
    assert snap["bytes"]["all-reduce"] == 3 * 2 * (b * l * d * 4)
    # with the loss: max, sum of exponentials and label logit over the
    # model slots, then the sum and count over the one data group
    from repro_torch.train.trainer import make_loss_fn
    coll.counter.reset()
    toks = torch.zeros((b, l), dtype=torch.long)
    make_loss_fn(model)(placed, {"tokens": toks, "labels": toks})
    snap = coll.counter.snapshot()
    assert snap["calls"]["all-reduce"] == 3 + 3
    assert snap["bytes"]["all-reduce"] == (3 * 2 * b * l * d * 4
                                           + 3 * 2 * b * l * 4)


# ---------------------------------------------------------------------- #
# named errors
# ---------------------------------------------------------------------- #
def test_mesh_builds_split_state_layers_and_refuse_bad_meshes():
    mesh = make_host_mesh(1, device="cpu", model=2)
    with pytest.raises(ValueError, match="tp must equal"):
        build(get_config("qwen2-1.5b", smoke=True), 4, mesh=mesh)
    for name, splits in (("recurrentgemma-2b", ("rec_split", "mlp_split")),
                         ("xlstm-350m", ("mlstm_split", "mlstm_cell_split",
                                         "slstm_split", "slstm_state_split"))):
        # two model slots: the 'state' weights and decode state split
        lay = build(get_config(name, smoke=True), 2, mesh=mesh).layout
        assert lay.m == 2 and all(getattr(lay, k) for k in splits), lay
        # one model slot: they run whole, data-parallel
        one = build(get_config(name, smoke=True), 1,
                    mesh=make_host_mesh(2, device="cpu"))
        assert one.layout == SlotLayout.whole(one)
    bad = Mesh(("cpu",) * 2, ("data", "x"), (1, 2))
    with pytest.raises(ValueError, match="'x'"):
        build(get_config("qwen2-1.5b", smoke=True), 1, mesh=bad)
    with pytest.raises(repro_torch.MeshTypeError):
        build(get_config("qwen2-1.5b", smoke=True), 1, mesh=object())


def test_place_and_gather_params_round_trip():
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    model = build(cfg, 4)
    mesh = make_host_mesh(2, device="cpu", model=4)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(2),
                         torch.float32, "cpu")
    placed = place_params(params, param_placements(model.param_specs(), mesh,
                                                   model.rules))
    back = gather_params(placed)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(params)))
    we = placed["blocks"]["attn"]["moe"]["we_g"]
    assert we.spec[1] == "model" and we.shards[0].shape[1] == 2  # 8 / 4
    assert isinstance(we, Sharded) and len({id(p) for p in we.shards}) == 4
