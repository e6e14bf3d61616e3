"""PyTorch port vs JAX package: the ``state``-axis layers split over
``model`` slots, on the CPU.

recurrentgemma-2b (RG-LRU and local attention) and xlstm-350m (mLSTM and
sLSTM) at their smoke configs, built at ``tp = m`` on ``(data, model)``
CPU meshes of (1, 2), (1, 4) and (2, 2) slots, their weights split as
``logical_to_spec`` resolves the reference's specs
(``models/parallel.py`` says how each layer computes on its pieces), and
at (1, 3), where ``state`` does not divide and every ``state`` weight is
whole on every slot (the reference's divisibility fallback). Each is
held against the reference's unsharded ``Model`` at the same ``tp``
(``repro.models.transformer.build``), on the reference's weights carried
across with ``models/convert.py``: ``forward``, ``prefill`` and 8
``decode_step``s, the logits and every leaf of the decode state, the
slots' pieces put together. Each slot's piece of each decode-state leaf
has the shape of the reference's ``logical_to_spec`` of the logical axes
its dry run gives that leaf (``repro/launch/dryrun.py``,
``abstract_decode_state``; the table below is that function's, read on
an ``AbstractMesh``).

Tolerance, float32: 1e-4 of the largest logit or state value, as
``test_torch_tp.py`` (the slots' partial sums add in another order than
one product's, compounded through the layers and decode steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.models.params import init_params as ref_init_params
from repro.models.transformer import build as ref_build
from repro.sharding import rules as ref_rules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import build
from repro_torch.sharding import unshard

TOL = 1e-4
PROMPT = 12
CACHE = 24
DECODE_STEPS = 8

# (data, model): 2 and 4 model slots, 2 x 2, and tp = 3, where no state
# weight divides
MESHES = [(1, 2), (1, 4), (2, 2), (1, 3)]


def ref_state_axes(kind, ndim):
    """The reference dry run's logical axes of a decode-state leaf
    (``abstract_decode_state``'s ``assign``)."""
    if kind == "attn":
        return (None, "batch", None, "kv_heads", None)
    if kind == "rec":
        return ((None, "batch", "state") if ndim == 3
                else (None, "batch", None, "state"))
    if kind == "mlstm":
        return {5: (None, "batch", None, None, "state"),
                4: (None, "batch", None, "state"),
                3: (None, "batch", None)}[ndim]
    return (None, "batch", "state")


def live_params(specs, seed):
    params = ref_init_params(specs, jax.random.key(seed), jnp.float32)
    rng = np.random.default_rng(seed)

    def liven(a):
        arr = np.asarray(a, np.float32)
        if arr.size and np.all(arr == arr.flat[0]):
            arr = arr + rng.normal(size=arr.shape).astype(np.float32) * 0.1
        return jnp.asarray(arr)
    return jax.tree.map(liven, params)


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), err


def close_logits(got, want, vocab):
    got = np.asarray(unshard(got).detach(), np.float64)
    close(got[..., :vocab], np.asarray(want)[..., :vocab])


def whole_state(state, ref_state, data, m):
    """The port's per-slot decode-state pieces put together, each slot's
    piece shape checked against the reference's spec of its leaf."""
    rmesh = AbstractMesh((data, m), ("data", "model"))
    rules = ref_rules.Rules.default()
    out = {}
    for kind, leaves in ref_state.items():
        out[kind] = {}
        for key, ref_leaf in leaves.items():
            shape = tuple(ref_leaf.shape)
            spec = tuple(ref_rules.logical_to_spec(
                rmesh, rules, ref_state_axes(kind, len(shape)), shape))
            local = [n // (m if e == "model" else data if e == "data"
                           else 1) for n, e in zip(shape, spec + (None,) * (
                               len(shape) - len(spec)))]
            rows = []
            for grp in state["groups"]:
                pieces = [slot[kind][key] for slot in grp]
                for p in pieces:
                    want = list(local)
                    want[1] = p.shape[1]      # this group's rows
                    assert list(p.shape) == want, (kind, key, p.shape, spec)
                dim = spec.index("model") if "model" in spec else None
                rows.append(pieces[0] if dim is None
                            else torch.cat(pieces, dim=dim))
            out[kind][key] = (torch.cat(rows, dim=1) if "data" in spec
                              else rows[0])
    return out


def close_state(got, want):
    for kind in want:
        for key in want[kind]:
            close(got[kind][key], want[kind][key])


@pytest.mark.parametrize("data,m", MESHES)
@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-350m"])
def test_state_layers_split_match_reference(name, data, m):
    ref_cfg = ref_get_config(name, smoke=True)
    cfg = get_config(name, smoke=True)
    ref = ref_build(ref_cfg, m)
    rp = live_params(ref.param_specs(), m)
    mesh = make_host_mesh(data, device="cpu", model=m)
    port = build(cfg, m, mesh=mesh)
    lay = port.layout
    splits = {"rec": lay.rec_split, "mlstm": lay.mlstm_split,
              "slstm": lay.slstm_split}
    kinds = set(cfg.layer_kinds()) - {"attn"}
    assert all(splits[k] == (m != 3) for k in kinds), splits
    placed = port.place(params_from_reference(jax.tree.map(np.asarray, rp),
                                              device="cpu"))
    toks = np.random.default_rng(m).integers(
        0, ref_cfg.vocab_size, (4, PROMPT)).astype(np.int32)
    ttoks = torch.from_numpy(toks)

    want, want_aux = ref.forward(rp, jnp.asarray(toks))
    got, aux = port.forward(placed, ttoks)
    close_logits(got, want, ref_cfg.vocab_size)
    close(aux, want_aux)

    want, rstate = jax.jit(lambda p, x: ref.prefill(
        p, x, CACHE, dtype=jnp.float32))(rp, jnp.asarray(toks))
    got, pstate = port.prefill(placed, ttoks, CACHE, dtype=torch.float32)
    close_logits(got, want, ref_cfg.vocab_size)
    close_state(whole_state(pstate, rstate, data, m), rstate)
    decode = jax.jit(ref.decode_step)
    for step in range(DECODE_STEPS):
        tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want, rstate = decode(rp, tok, jnp.int32(PROMPT + step), rstate)
        got, pstate = port.decode_step(
            placed, torch.from_numpy(np.array(tok)), PROMPT + step, pstate)
        close_logits(got, want, ref_cfg.vocab_size)
    close_state(whole_state(pstate, rstate, data, m), rstate)


def test_state_layers_train_on_split_slots():
    """The split layers are differentiable: the loss and every gradient
    of xlstm and recurrentgemma on (1, 2) slots against one slot at
    tp = 2 (each gradient within 1e-4 of its leaf's largest), the
    collectives' adjoints carrying them across the slots."""
    from repro_torch.models.params import init_params
    from repro_torch.models.parallel import leafify
    from repro_torch.sharding import Sharded
    from repro_torch.train.trainer import make_grad_fn, make_loss_fn
    for name in ("xlstm-350m", "recurrentgemma-2b"):
        cfg = get_config(name, smoke=True)
        one = build(cfg, 2)
        par = build(cfg, 2, mesh=make_host_mesh(1, device="cpu", model=2))
        params = init_params(one.param_specs(),
                             torch.Generator().manual_seed(1), torch.float32,
                             "cpu")
        t = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 17)))
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        (lt,), leaves = leafify([par.place(params)])
        loss, _ = make_loss_fn(par)(lt, batch)
        grads = torch.autograd.grad(loss, leaves)
        by = {id(a): g for a, g in zip(leaves, grads)}
        got = tree_map(lambda x: unshard(Sharded(
            x.placement, x.shape, tuple(by[id(p)] for p in x.shards))), lt)
        want_loss, _, want = make_grad_fn(one)(params, batch)
        close(loss.detach(), want_loss)
        for g, w in zip(tree_leaves(got), want):
            close(g, w)
