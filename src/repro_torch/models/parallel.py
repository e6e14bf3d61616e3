"""Tensor, expert and data parallelism of the LM stack over a mesh.

A ``Model`` runs its layers over the ``model`` slots of its *groups*
(``Model.run_groups``); off a mesh there is one group of one slot
holding the whole model. This module says what each slot of a group
holds (``SlotLayout``) and cuts a batch over a mesh's groups
(``MeshPlan``). The batch is cut over the ``(pod, data)`` slots, one cut
per group; within a group the ``model`` slots split every layer, each
slot on its own weights' pieces:

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
    logits left split (a ``Sharded``);
  * RG-LRU (``state`` = its recurrence width): ``w_gate``/``w_x``, the
    depthwise conv, ``b_a``, ``b_i`` and ``lam`` on the slot's channels,
    so they stay local; ``w_a``/``w_i`` are ``(state, state)``, whose
    second ``state`` finds ``model`` taken, so only their rows split:
    ``xc @ w_a`` is a partial sum on each slot, and one
    ``reduce_scatter`` onto the slot's channels gives exactly what the
    local scan needs; ``w_down`` row-split, then an ``all_reduce``. The
    decode state's ``h`` and ``conv`` hold the slot's channels;
  * mLSTM (``state`` = its up-projected width ``du``): ``w_up`` and
    ``w_gate`` column-split, ``wq``/``wk``/``wv``/``w_if`` row-split, so
    q, k, v and the gates are partial sums: q, k and the gates are
    ``all_reduce``d (every slot needs them whole), v is
    ``reduce_scatter``ed onto the slot's piece of ``dv``, and the cell
    runs split over ``dv`` (its matrix state ``C`` on ``dv``, as the
    reference's decode state places it; ``n`` is stored on ``dk`` and
    ``all_gather``ed whole at each call, the cell's normaliser needing
    all of it). The cell's output is then head-major split over ``dv``,
    not the contiguous ``du / m`` columns that ``norm_h`` and
    ``w_down``'s rows hold on the slot (xlstm-350m's 4 heads cannot be
    split 16 ways), so ``collectives.all_to_all_heads`` turns one into
    the other; ``norm_h``, an RMS norm over all of ``du``, reduces its
    sum of squares; ``w_down`` row-split, then an ``all_reduce``;
  * sLSTM (``state`` = its gate width ``4d``): ``w_gates``/``b_gates``
    column-split, but the cell cuts its ``4d`` into (z, i, f, o) after a
    head-major reshape of the recurrent term, so a slot's contiguous
    columns mix gates and heads, and the token scan is sequential: the
    gate pre-activations are ``all_gather``ed once before the scan
    (never a collective a token), every slot runs the scan whole on the
    replicated ``r_gates``, and keeps its piece of ``d`` of the state
    (``c``/``n``/``h``/``m``), gathered whole at the next call;
    ``w_out`` and ``norm_h`` are replicated.

A weight whose logical axis does not divide its mesh axes is replicated,
exactly as ``logical_to_spec`` resolves it, and then its product is
whole on every slot and is not reduced (a decode state likewise). FSDP
(``embed_fsdp`` on ``data``) ``all_gather``s a weight over the data
slots before use.

Groups run one after another, except an MoE model's: the reference
routes a data-sharded batch whole (capacity, ranks and the aux loss from
every token), so its groups run in lockstep, layer by layer
(``lockstep``): at each MoE layer the router logits of every
group's rows are ``all_gather``ed over ``(pod, data)``, one routing is
made over the whole batch, and each group dispatches its own rows.

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
from .ssm import UP
from .params import param_placements, tree_leaves, tree_map

__all__ = ["MeshPlan", "SlotLayout", "Group", "greedy_tokens",
           "slot_trees", "leafify", "group_mean", "decode_state_axes",
           "lockstep"]

# one group of slots running a batch's rows: the slots' indices in the
# mesh, their weight trees and devices, and the rows of the batch
Group = collections.namedtuple("Group", "slots trees devs rows")


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """What each ``model`` slot of a group holds, in slot order: its
    attention dims and ``kv_select`` (``attention.slot_dims``), its
    vocabulary range and its experts' range ((first, count); None: all),
    and which products are split (their partials reduced): for the
    recurrent kinds their ``state`` weights (``rec``, ``mlstm``,
    ``slstm``) and their decode state's ``state`` axis
    (``mlstm_cell``: ``C`` on ``dv`` and ``n`` on ``dk``;
    ``slstm_state``; RG-LRU's state splits with its weights)."""

    attn: tuple
    vocab: tuple
    experts: tuple
    vocab_split: bool = False
    heads_split: bool = False
    mlp_split: bool = False
    experts_split: bool = False
    shared_split: bool = False
    rec_split: bool = False
    mlstm_split: bool = False
    mlstm_cell_split: bool = False
    slstm_split: bool = False
    slstm_state_split: bool = False

    @property
    def m(self) -> int:
        """The group's ``model`` slots."""
        return len(self.attn)

    @classmethod
    def whole(cls, model) -> "SlotLayout":
        """One slot holding the whole model: the model off a mesh, or on
        a mesh with one ``model`` slot."""
        return cls(((model.dims, None),), ((0, model.vocab_p),), (None,))


def decode_state_axes(kind: str, ndim: int) -> tuple:
    """The logical axes of a decode-state leaf of ``kind`` with ``ndim``
    dimensions (layer stack first), as the reference's dry run places
    them (``launch/dryrun.abstract_decode_state``): the KV caches on
    ``kv_heads``; RG-LRU's ``h`` and ``conv`` on ``state``; the mLSTM's
    ``C`` on ``dv`` and ``n`` on ``dk`` (``m`` replicated); the sLSTM's
    ``c``/``n``/``h``/``m`` on ``d``."""
    if kind == "attn":
        return (None, "batch", None, "kv_heads", None)
    if kind == "rec":
        return ((None, "batch", "state") if ndim == 3
                else (None, "batch", None, "state"))
    if kind == "mlstm":
        return {5: (None, "batch", None, None, "state"),
                4: (None, "batch", None, "state"),
                3: (None, "batch", None)}[ndim]
    if kind == "slstm":
        return (None, "batch", "state")
    return (None,) * ndim


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
        self.model, self.mesh = model, mesh
        self.groups = mesh.groups(("model",))
        self.placements = param_placements(model.param_specs(), mesh,
                                           model.rules)
        self.layout = (SlotLayout.whole(model) if m == 1
                       else self._layout(model))

    def _layout(self, model) -> SlotLayout:
        pl, specs, cfg = self.placements, model.param_specs(), model.cfg
        slot0 = self.groups[0]
        blocks = pl["blocks"]

        def leaf(tree, name_path):
            for k in name_path:
                tree = tree[k]
            return tree

        def rng(name_path, dim, s):
            sl = leaf(pl, name_path).slices(leaf(specs, name_path).shape,
                                            s)[dim]
            return sl.start, sl.stop - sl.start

        def split(name_path, dim):
            return leaf(pl, name_path).pieces(dim) > 1

        def state_split(kind, shape):
            spec = logical_to_spec(self.mesh, model.rules,
                                   decode_state_axes(kind, len(shape)),
                                   shape)
            return Placement(self.mesh, spec).pieces(len(shape) - 1) > 1
        kw = {}
        if "attn" in blocks:
            a = ("blocks", "attn", "attn")
            heads = [attn.slot_dims(model.dims, *rng(a + ("wq",), 2, s),
                                    *rng(a + ("wk",), 2, s)) for s in slot0]
            kw["heads_split"] = split(a + ("wo",), 1)
        else:
            heads = [(model.dims, None)] * len(slot0)
        experts = [None] * len(slot0)
        if cfg.moe is not None:
            e = ("blocks", "attn", "moe")
            kw["experts_split"] = split(e + ("we_g",), 1)
            kw["shared_split"] = ("ws_d" in blocks["attn"]["moe"]
                                  and split(e + ("ws_d",), 1))
            if kw["experts_split"]:
                experts = [rng(e + ("we_g",), 1, s) for s in slot0]
        for kind in ("attn", "rec"):
            if "mlp" in blocks.get(kind, {}):
                kw["mlp_split"] = split(("blocks", kind, "mlp", "wd"), 1)
        d, heads_n = cfg.d_model, cfg.n_heads
        if "rec" in blocks:
            kw["rec_split"] = split(("blocks", "rec", "rec", "w_x"), 2)
        if "mlstm" in blocks:
            hd = UP * d // heads_n
            kw["mlstm_split"] = split(("blocks", "mlstm", "cell", "w_up"), 2)
            kw["mlstm_cell_split"] = state_split("mlstm",
                                                 (1, 0, heads_n, hd, hd))
        if "slstm" in blocks:
            kw["slstm_split"] = split(("blocks", "slstm", "cell",
                                       "w_gates"), 2)
            kw["slstm_state_split"] = state_split("slstm", (1, 0, d))
        return SlotLayout(
            tuple(heads), tuple(rng(("embed",), 0, s) for s in slot0),
            tuple(experts), vocab_split=split(("embed",), 0), **kw)

    def rows_of(self, b: int) -> list:
        """Each group's rows of a batch of ``b``: an equal cut, or every
        row for every group when the groups do not divide ``b``."""
        spec = logical_to_spec(self.mesh, self.model.rules, ("batch",), (b,))
        per = b // len(self.groups)
        return [slice(None) if spec[0] is None
                else slice(k * per, (k + 1) * per)
                for k in range(len(self.groups))]

    def groups_of(self, placed, b: int) -> list:
        """The ``Group``s that run a batch of ``b`` rows on ``placed``
        params (``rows_of``)."""
        trees = slot_trees(placed)
        return [Group(grp, [trees[s] for s in grp],
                      [self.mesh.devices[s] for s in grp], rows)
                for grp, rows in zip(self.groups, self.rows_of(b))]

    def sharded(self, per_group: list, shape: tuple, logical) -> Sharded:
        """Per-group lists of per-slot pieces as one ``Sharded``."""
        shards = [None] * self.mesh.size
        for grp, pieces in zip(self.groups, per_group):
            for s, x in zip(grp, pieces):
                shards[s] = x
        spec = logical_to_spec(self.mesh, self.model.rules, logical, shape)
        return Sharded(Placement(self.mesh, spec), tuple(shape),
                       tuple(shards))


def lockstep(cfg, groups: list) -> list:
    """The groups as runs: each run a list of groups that go through the
    layers together. An MoE model's groups holding distinct rows run as
    one (its routing spans the whole batch); every other model's, and an
    MoE model's that all hold every row, one after another."""
    if (cfg.moe is not None and len(groups) > 1
            and groups[0].rows != slice(None)):
        return [groups]
    return [[g] for g in groups]
