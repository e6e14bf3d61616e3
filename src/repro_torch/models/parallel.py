"""Tensor, expert and data parallelism of the LM stack over a mesh.

A ``Model`` runs its layers over the ``model`` slots of one *group*
(``Model.run_group``); off a mesh the group is one slot holding the
whole model. This module says what each slot of a group holds
(``SlotLayout``) and cuts a batch over a mesh's groups (``MeshPlan``).
The batch is cut over the ``(pod, data)`` slots (each cut a group, run
one after another); within a group the ``model`` slots split every
layer Megatron-style, each slot on its own weights' pieces:

  * attention: ``wq``/``wk``/``wv`` column-split on ``heads``/``kv_heads``
    (each slot runs its own query heads on the KV heads they read,
    ``attention.slot_dims``; K7 once per slot per layer), ``wo``
    row-split, then an ``all_reduce`` of the partial out-projections;
  * the MLP: ``wg``/``wu`` column-split on ``mlp``, ``wd`` row-split,
    then an ``all_reduce``; the experts split on ``experts`` (each slot
    dispatches only its experts' buffer rows, under one routing made
    from the router logits ``all_gather``ed over the slots), then an
    ``all_reduce``;
  * the embedding split on ``vocab`` (a look-up within the slot's rows,
    zero outside, then an ``all_reduce``), the ``lm_head`` too, with the
    logits left split (a ``Sharded``).

A weight whose logical axis does not divide its mesh axes is replicated,
exactly as ``logical_to_spec`` resolves it, and then its product is
whole on every slot and is not reduced. FSDP (``embed_fsdp`` on
``data``) ``all_gather``s a weight over the data slots before use.

Only attention stacks (dense, MoE, vision, audio) split over ``model``;
the ``state``-axis layers (RG-LRU, xLSTM) run on meshes with one
``model`` slot, and raise ``NotPortedError`` on more. MoE runs on one
group only: the reference's forward over a data-sharded batch routes
the whole batch at once (capacity, ranks and the aux loss from every
row), which groups run one after another cannot do, so an MoE model on
a mesh with more than one ``(pod, data)`` group raises
``NotPortedError``.

Slots that share a device share what is the same for them (a replicated
weight's product, a reduced activation): ``collectives.per_device``.
"""
from __future__ import annotations

import collections
import dataclasses

import torch

from ..errors import NotPortedError
from ..sharding import collectives as coll
from ..sharding.placed import Sharded
from ..sharding.rules import Placement, logical_to_spec
from . import attention as attn
from .params import param_placements, tree_leaves, tree_map

__all__ = ["MeshPlan", "SlotLayout", "Group", "greedy_tokens",
           "slot_trees", "leafify", "group_mean"]

# one group of slots running a batch's rows: the slots' indices in the
# mesh, their weight trees and devices, and the rows of the batch
Group = collections.namedtuple("Group", "slots trees devs rows")


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """What each ``model`` slot of a group holds, in slot order: its
    attention dims and ``kv_select`` (``attention.slot_dims``), its
    vocabulary range and its experts' range ((first, count); None: all),
    and which products are split (their partials ``all_reduce``d)."""

    attn: tuple
    vocab: tuple
    experts: tuple
    vocab_split: bool = False
    heads_split: bool = False
    mlp_split: bool = False
    experts_split: bool = False
    shared_split: bool = False

    @classmethod
    def whole(cls, model) -> "SlotLayout":
        """One slot holding the whole model: the model off a mesh, or on
        a mesh with one ``model`` slot."""
        return cls(((model.dims, None),), ((0, model.vocab_p),), (None,))


def _data_dim(placement: Placement):
    """The dimension a placement splits over ``data`` (FSDP), or None."""
    for i, e in enumerate(placement.spec):
        axes = e if isinstance(e, tuple) else (e,)
        if "data" in axes:
            if axes != ("data",):
                raise NotPortedError(f"a weight split over {axes} (with "
                                     "'data') is not ported")
            return i
    return None


def slot_trees(placed) -> list:
    """Each slot's weights as a plain nested dict of its pieces, with
    every FSDP-split weight ``all_gather``ed over the data slots first
    (one collective per weight and group of data slots; groups that hold
    the same pieces on the same devices, a weight replicated over
    ``model``, share one gather)."""
    leaves = tree_leaves(placed)
    mesh = leaves[0].mesh
    per_leaf = []
    for x in leaves:
        dim = _data_dim(x.placement)
        if dim is None:
            per_leaf.append(list(x.shards))
            continue
        got = coll.over_groups(coll.all_gather, list(x.shards),
                               mesh.groups(("data",)), mesh.devices, dim)
        per_leaf.append(got)
    trees = []
    for s in range(mesh.size):
        it = iter(p[s] for p in per_leaf)
        trees.append(tree_map(lambda _: next(it), placed))
    return trees


def leafify(trees) -> tuple[list, list]:
    """Trees (per-slot weight trees, or placed trees of ``Sharded``) with
    each distinct tensor replaced by one detached leaf that requires
    grad (slots sharing a tensor share its leaf, whose gradient then
    sums their uses) -> (trees, distinct leaves in order)."""
    made: dict = {}

    def leaf(x):
        if id(x) not in made:
            made[id(x)] = x.detach().requires_grad_()
        return made[id(x)]

    def one(x):
        if isinstance(x, Sharded):
            return Sharded(x.placement, x.shape,
                           tuple(leaf(p) for p in x.shards))
        return leaf(x)
    out = [tree_map(one, t) for t in trees]
    return out, list(made.values())


def group_mean(xs) -> torch.Tensor:
    """The mean of the groups' 0-dim values, on the first's device."""
    if len(xs) == 1:
        return xs[0]
    dev = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(dev)
    return total / torch.tensor(float(len(xs)), device=dev)


def greedy_tokens(logits: Sharded) -> torch.Tensor:
    """Greedy tokens from last-position logits split over the vocab:
    (B, 1 or L, V) ``Sharded`` -> (B,) int32 on the first slot's device.
    Each model slot takes its own argmax; the (value, index) pairs are
    ``all_gather``ed and the largest value wins, ties to the lower index,
    which is what one ``argmax`` over the whole vocabulary returns."""
    mesh, p = logits.mesh, logits.placement
    vdim = len(logits.shape) - 1
    per_group = []
    for grp in mesh.groups(("model",)):
        devs = [mesh.devices[s] for s in grp]
        vals, idxs = [], []
        for s in grp:
            x = logits.shards[s][:, -1]
            i = x.argmax(dim=-1)
            vals.append(x.gather(-1, i[:, None]))
            off = p.piece_index(vdim, s) * x.shape[-1]
            idxs.append((i + off)[:, None])
        v = coll.all_gather(vals, 1, devs)[0]
        ix = coll.all_gather(idxs, 1, devs)[0]
        best = v.max(dim=-1, keepdim=True).values
        big = torch.iinfo(ix.dtype).max
        per_group.append(torch.where(v == best, ix, big).min(dim=-1).values)
    dev = mesh.devices[0]
    if p.pieces(0) == 1:   # batch replicated: every group has every row
        return per_group[0].to(dev, torch.int32)
    return torch.cat([t.to(dev) for t in per_group]).to(torch.int32)


class MeshPlan:
    """How a model runs on its mesh: the groups, the placements, and each
    ``model`` slot's share of the layers (``layout``)."""

    def __init__(self, model):
        mesh, cfg = model.mesh, model.cfg
        extra = set(mesh.axis_names) - {"pod", "data", "model"}
        if extra:
            raise ValueError(f"a model runs on (pod, data, model) meshes; "
                             f"this one has {sorted(extra)}")
        m = mesh.shape.get("model", 1)
        if m != model.tp:
            raise ValueError(f"build(cfg, tp={model.tp}) on a mesh of "
                             f"{m} 'model' slots: tp must equal them")
        kinds = set(cfg.layer_kinds())
        if m > 1 and kinds - {"attn"}:
            raise NotPortedError(
                f"{cfg.name}: sharded execution of its "
                f"{sorted(kinds - {'attn'})} layers (the 'state' axis) over "
                f"{m} model slots is not ported; ROADMAP queue 1 names it "
                "next. It runs on meshes with one model slot.")
        self.model, self.mesh = model, mesh
        self.groups = mesh.groups(("model",))
        if cfg.moe is not None and len(self.groups) > 1:
            raise NotPortedError(
                f"{cfg.name}: MoE over {len(self.groups)} (pod, data) "
                "groups is not ported: the reference routes the whole batch "
                "at once, and the groups run one after another; ROADMAP "
                "queue 1 names it. It runs on meshes with one data slot.")
        self.placements = param_placements(model.param_specs(), mesh,
                                           model.rules)
        self.layout = (SlotLayout.whole(model) if m == 1
                       else self._layout(model))

    def _layout(self, model) -> SlotLayout:
        pl, specs = self.placements, model.param_specs()
        slot0 = self.groups[0]

        def rng(name_path, dim, s):
            p, sp = pl, specs
            for k in name_path:
                p, sp = p[k], sp[k]
            sl = p.slices(sp.shape, s)[dim]
            return sl.start, sl.stop - sl.start

        def split(name_path, dim):
            p = pl
            for k in name_path:
                p = p[k]
            return p.spec[dim] is not None
        a = ("blocks", "attn", "attn")
        heads = [attn.slot_dims(model.dims, *rng(a + ("wq",), 2, s),
                                *rng(a + ("wk",), 2, s)) for s in slot0]
        kw = {"mlp_split": False, "experts_split": False,
              "shared_split": False}
        experts = [None] * len(slot0)
        if model.cfg.moe is not None:
            e = ("blocks", "attn", "moe")
            kw["experts_split"] = split(e + ("we_g",), 1)
            kw["shared_split"] = ("ws_d" in pl["blocks"]["attn"]["moe"]
                                  and split(e + ("ws_d",), 1))
            if kw["experts_split"]:
                experts = [rng(e + ("we_g",), 1, s) for s in slot0]
        elif model.cfg.d_ff:
            kw["mlp_split"] = split(("blocks", "attn", "mlp", "wd"), 1)
        return SlotLayout(
            tuple(heads), tuple(rng(("embed",), 0, s) for s in slot0),
            tuple(experts), vocab_split=split(("embed",), 0),
            heads_split=split(a + ("wo",), 1), **kw)

    def groups_of(self, placed, b: int) -> list:
        """The ``Group``s that run a batch of ``b`` rows on ``placed``
        params: each group's rows are an equal cut, or every row for
        every group when the groups do not divide ``b``."""
        trees = slot_trees(placed)
        spec = logical_to_spec(self.mesh, self.model.rules, ("batch",), (b,))
        g = len(self.groups)
        per = b // g
        return [Group(grp, [trees[s] for s in grp],
                      [self.mesh.devices[s] for s in grp],
                      slice(None) if spec[0] is None
                      else slice(k * per, (k + 1) * per))
                for k, grp in enumerate(self.groups)]

    def sharded(self, per_group: list, shape: tuple, logical) -> Sharded:
        """Per-group lists of per-slot pieces as one ``Sharded``."""
        shards = [None] * self.mesh.size
        for grp, pieces in zip(self.groups, per_group):
            for s, x in zip(grp, pieces):
                shards[s] = x
        spec = logical_to_spec(self.mesh, self.model.rules, logical, shape)
        return Sharded(Placement(self.mesh, spec), tuple(shape),
                       tuple(shards))
