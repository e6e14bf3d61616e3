"""PyTorch port vs JAX package: ``build(cfg, tp)`` for tp > 1 on the CPU.

A build at ``tp`` pads the query heads, the vocabulary and the experts to
multiples of ``tp`` and repeats the decode cache to ``n_kv_cache`` heads;
padding changes the function, not only the shapes (query head ``j``
reads KV head ``j // (n_heads_p / n_kv)``), so each ``tp`` is held
against the reference's build at the same ``tp``, never against
``tp=1``. For tp in {2, 3, 4, 16} on all 10 smoke configs: the dims, the
padded counts and the spec tree; then, on the reference's weights (its
``init_params`` from a seed, numpy noise on the constant leaves, carried
across bit for bit), ``forward`` with its aux loss, ``prefill`` and two
``decode_step``s with every leaf of the decode state, in float32
(``dtype=float32`` passed to both prefills), through K7's plain version
at tp 2 and 16 and the chunked path at 3 and 4. llava-next's smoke
config (7 heads on 7 KV heads) pads to a head count that does not group
on its KV heads at every such ``tp``, and so do qwen2-moe's and
musicgen's (4 heads on 4 KV heads) at ``tp=3``: there the reference's
``_expand_kv`` asserts when it first runs attention, and the port raises
a named ``ValueError`` at ``build`` (xLSTM, with no attention layer,
builds at every ``tp`` in both).

Tolerances, float32: 1e-4 of the largest real logit or state value (as
``test_torch_families.py``: matmul summation orders, exp and log1p in
the last bits, compounded through the layers and decode steps); padded
vocabulary columns must be the dtype's most negative value in both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.frontend import make_frontend_stub as ref_stub
from repro.models.params import init_params as ref_init_params
from repro.models.transformer import build as ref_build
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_reference
from repro_torch.models.frontend import make_frontend_stub
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import build

TOL = 1e-4
PROMPT = 16
CACHE = 32
TPS = (2, 3, 4, 16)


def live_params(specs, seed):
    params = ref_init_params(specs, jax.random.key(seed), jnp.float32)
    rng = np.random.default_rng(seed)

    def liven(a):
        arr = np.asarray(a, np.float32)
        if arr.size and np.all(arr == arr.flat[0]):
            arr = arr + rng.normal(size=arr.shape).astype(np.float32) * 0.1
        return jnp.asarray(arr)
    return jax.tree.map(liven, params)


def close_logits(got, want, vocab):
    """Real columns within TOL of the largest; padded ones the dtype's
    minimum in both."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach(), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    real_g, real_w = got[..., :vocab], want[..., :vocab]
    err = np.abs(real_g - real_w).max()
    assert err <= TOL * max(np.abs(real_w).max(), 1.0), err
    lo = np.finfo(np.float32).min
    assert (got[..., vocab:] == lo).all() and (want[..., vocab:] == lo).all()


def close_tree(got, want):
    leaves = []
    tree_map(leaves.append, got)
    wants = jax.tree.leaves(want)
    assert len(leaves) == len(wants)
    for g, w in zip(leaves, wants):
        w = np.asarray(w, np.float64)
        g = np.asarray(g, np.float64)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1.0)


def spec_list(specs, is_ref):
    if is_ref:
        return [(s.shape, s.axes, s.init, s.scale) for s in jax.tree.leaves(
            specs, is_leaf=lambda x: hasattr(x, "axes"))]
    out = []
    tree_map(lambda s: out.append((s.shape, s.axes, s.init, s.scale)), specs)
    return out


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", REF_ARCHS)
def test_tp_build_matches_reference(name, tp):
    impl = "flash" if tp in (2, 16) else "jnp"
    ref_cfg = dataclasses.replace(ref_get_config(name, smoke=True),
                                  attn_impl=impl)
    cfg = dataclasses.replace(get_config(name, smoke=True), attn_impl=impl)
    ref = ref_build(ref_cfg, tp)
    rp = live_params(ref.param_specs(), tp)
    toks = np.random.default_rng(tp).integers(
        0, ref_cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    re = ref_stub(ref_cfg, 2, np.random.default_rng(0)).get("extra_embeds")
    pe = make_frontend_stub(cfg, 2, np.random.default_rng(0),
                            device="cpu").get("extra_embeds")
    groups = ref.dims.n_heads_p % ref.dims.n_kv == 0 and (
        ref.dims.n_kv_cache % ref.dims.n_kv == 0)
    if not groups and "attn" in ref_cfg.layer_kinds():
        # llava: 7 heads padded to 8, 9 or 16 on 7 replicated KV heads;
        # qwen2-moe and musicgen at tp=3: 4 heads padded to 6 on 4
        assert name in ("llava_next_34b", "qwen2_moe_a2_7b",
                        "musicgen_large")
        with pytest.raises(ValueError, match="do not group"):
            build(cfg, tp)
        with pytest.raises(AssertionError):
            ref.forward(rp, jnp.asarray(toks), extra_embeds=re)
        return
    assert name != "llava_next_34b"
    port = build(cfg, tp)
    assert dataclasses.asdict(port.dims) == dataclasses.asdict(ref.dims)
    assert (port.vocab_p, port.n_experts_p) == (ref.vocab_p, ref.n_experts_p)
    assert spec_list(port.param_specs(), False) == spec_list(
        ref.param_specs(), True)
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")

    want, want_aux = ref.forward(rp, jnp.asarray(toks), extra_embeds=re)
    got, aux = port.forward(pp, torch.from_numpy(toks), extra_embeds=pe)
    close_logits(got, want, ref_cfg.vocab_size)
    assert abs(float(aux) - float(want_aux)) <= TOL * max(
        abs(float(want_aux)), 1.0)

    want, rstate = jax.jit(lambda p, x, e: ref.prefill(
        p, x, CACHE + (0 if re is None else re.shape[1]), extra_embeds=e,
        dtype=jnp.float32))(rp, jnp.asarray(toks), re)
    got, pstate = port.prefill(pp, torch.from_numpy(toks),
                               CACHE + (0 if pe is None else pe.shape[1]),
                               extra_embeds=pe, dtype=torch.float32)
    close_logits(got, want, ref_cfg.vocab_size)
    close_tree(pstate, rstate)
    decode = jax.jit(ref.decode_step)
    pos = PROMPT + (0 if re is None else re.shape[1])
    tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for step in range(2):
        want, rstate = decode(rp, tok, jnp.int32(pos + step), rstate)
        got, pstate = port.decode_step(pp, torch.from_numpy(np.array(tok)),
                                       pos + step, pstate)
        close_logits(got, want, ref_cfg.vocab_size)
        close_tree(pstate, rstate)
        tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
