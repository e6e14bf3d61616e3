"""PyTorch port vs JAX package: the dense transformer stack on the CPU.

The same weights (made by the reference's ``init_params`` from a seed,
with numpy noise on the zero/one-initialized biases and norms so that
every weight is live, and carried across by ``params_from_reference``)
and the same numpy-made inputs go through ``repro.models`` and
``repro_torch.models``: the layers, the attention functions, and then
``prefill`` and a run of ``decode_step``s of the qwen2 (3 heads on 1 KV
head, QKV bias), starcoder2 (window 8, prompts longer than the window
so the ring cache wraps), granite and minitron smoke configs, under both
``attn_impl``s, in float32 (``dtype=float32`` passed to both prefills:
the reference's bf16 default cache cannot take float32 weights).

Tolerances, float32: 1e-5 relative to the largest magnitude for single
layers (observed <= 1e-6: XLA's and torch's sin/cos, rsqrt and matmul
summation orders differ in the last bits); 1e-4 for whole models (the
same rounding compounds through 2 layers, the softmax and 12 cached
decode steps: observed <= 3e-5). Weights carried across must be
bit-exact, bfloat16 included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.params import init_params as ref_init_params
from repro.models.params import spec_tree_bytes as ref_spec_tree_bytes
from repro.models.transformer import build as ref_build
from repro_torch.configs import get_config
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import (Spec, init_params, spec_tree_bytes,
                                       tree_leaves, tree_map)
from repro_torch.models.transformer import build

DENSE = ("qwen2-1.5b", "starcoder2-3b", "granite-3-8b", "minitron-8b")
OTHERS = {"phi3.5-moe-42b-a6.6b": "moe", "qwen2-moe-a2.7b": "moe",
          "musicgen-large": "audio", "llava-next-34b": "vlm",
          "xlstm-350m": "ssm", "recurrentgemma-2b": "hybrid"}
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def close(got, want, tol):
    """max |got - want| <= tol x max |want|."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (err, tol)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).copy())


def live_params(specs, seed, dtype=jnp.float32):
    """The reference's init, plus numpy noise on the zero/one leaves."""
    params = ref_init_params(specs, jax.random.key(seed), dtype)
    rng = np.random.default_rng(seed)

    def liven(a):
        arr = np.asarray(a, np.float32)
        if np.all(arr == arr.flat[0]):
            arr = arr + rng.normal(size=arr.shape).astype(np.float32) * 0.1
        return jnp.asarray(arr, dtype)
    return jax.tree.map(liven, params)


# ---------------------------------------------------------------------- #
# configs, specs, params
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_configs_match_reference(name, smoke):
    assert (dataclasses.asdict(get_config(name, smoke=smoke))
            == dataclasses.asdict(ref_get_config(name, smoke=smoke)))


def same_build(port, ref):
    """A port build and a reference build agree in their padded counts
    and their spec trees."""
    assert port.dims.n_heads_p == ref.dims.n_heads_p
    assert port.dims.n_kv_cache == ref.dims.n_kv_cache
    assert (port.vocab_p, port.n_experts_p) == (ref.vocab_p, ref.n_experts_p)
    ref_leaves = jax.tree.leaves_with_path(
        ref.param_specs(),
        is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "axes"))
    port_leaves = []
    tree_map(port_leaves.append, port.param_specs())
    assert [(s.shape, s.axes, s.init) for _, s in ref_leaves] == [
        (s.shape, s.axes, s.init) for s in port_leaves]


@pytest.mark.parametrize("name,family", sorted(OTHERS.items()))
def test_other_families_match_reference_at_tp2(name, family):
    """The other families' configs equal the reference's and build at
    ``tp=1``; at ``tp=2`` (which raised ``NotPortedError`` before the
    sharding slice) the padded build equals the reference's: head,
    cache, vocab and expert counts and the spec tree."""
    cfg = get_config(name)
    assert cfg.family == family
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_get_config(name))
    assert build(ref_get_config(name, smoke=True)).cfg.family == family
    same_build(build(cfg, tp=2), ref_build(ref_get_config(name), tp=2))


def test_build_pads_for_tensor_parallelism_and_rejects_unknown_archs():
    cfg = get_config("qwen2-1.5b", smoke=True)
    same_build(build(cfg, tp=2), ref_build(ref_get_config(
        "qwen2-1.5b", smoke=True), tp=2))
    assert build(cfg, tp=2).vocab_p == 152          # 151 padded to 2
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-7")
    assert repro_torch.get_config is get_config
    assert repro_torch.build_model is build


@pytest.mark.parametrize("name", DENSE)
def test_param_specs_match_reference(name):
    cfg = get_config(name)
    ref = ref_build(ref_get_config(name)).param_specs()
    port = build(cfg).param_specs()
    ref_leaves = jax.tree.leaves_with_path(
        ref, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "axes"))
    port_leaves = []
    tree_map(port_leaves.append, port)
    assert [(s.shape, s.axes, s.init) for _, s in ref_leaves] == [
        (s.shape, s.axes, s.init) for s in port_leaves]
    assert spec_tree_bytes(port) == ref_spec_tree_bytes(ref)


def test_init_params_rules_and_seed():
    specs = {"w": Spec((64, 256), ("a", "b")), "b": Spec((256,), ("b",),
                                                         init="zeros"),
             "n": Spec((3, 256), ("l", "b"), init="ones"),
             "s": Spec((128, 4, 8), ("a", "h", "d"), scale=0.5)}
    p1 = init_params(specs, torch.Generator().manual_seed(3), torch.float32,
                     device="cpu")
    p2 = init_params(specs, torch.Generator().manual_seed(3), torch.float32,
                     device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                 tree_leaves(p2)))
    assert torch.equal(p1["b"], torch.zeros(256))
    assert torch.equal(p1["n"], torch.ones(3, 256))
    assert abs(p1["w"].std().item() - 1 / 8) < 0.01    # fan_in 64
    assert abs(p1["s"].std().item() - 0.5) < 0.05      # explicit scale
    bf = init_params(specs, torch.Generator().manual_seed(3), device="cpu")
    assert bf["w"].dtype == torch.bfloat16
    torch.testing.assert_close(bf["w"], p1["w"].to(torch.bfloat16))


def test_params_from_reference_is_bit_exact_in_bfloat16():
    cfg = ref_get_config("qwen2-1.5b", smoke=True)
    ref = live_params(ref_build(cfg).param_specs(), 1, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, ref)
    port = params_from_reference(tree, device="cpu")
    flat_ref = jax.tree.leaves(tree)
    flat_port = tree_leaves(port)
    assert len(flat_ref) == len(flat_port)
    for a, b in zip(flat_ref, flat_port):
        assert b.dtype == torch.bfloat16 and tuple(b.shape) == a.shape
        assert np.array_equal(a.view(np.uint16),
                              b.view(torch.int16).numpy().view(np.uint16))
    assert port["blocks"]["attn"]["attn"]["wq"].shape == (2, 48, 3, 16)


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 48)).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    close(port_layers.rms_norm(t(x), t(w), 1e-5),
          ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
          LAYER_TOL)
    xh = rng.normal(size=(2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) * 3
    for theta in (1e4, 1e6):
        close(port_layers.rope(t(xh), t(pos), theta),
              ref_layers.rope(jnp.asarray(xh), jnp.asarray(pos), theta),
              LAYER_TOL)
    wg, wu = (rng.normal(size=(48, 128)).astype(np.float32) / 7
              for _ in range(2))
    wd = rng.normal(size=(128, 48)).astype(np.float32) / 11
    close(port_layers.swiglu(t(x), t(wg), t(wu), t(wd)),
          ref_layers.swiglu(*map(jnp.asarray, (x, wg, wu, wd))), LAYER_TOL)
    head = rng.normal(size=(48, 64)).astype(np.float32)
    for vocab in (64, 51):   # 51: padded columns masked to finfo.min
        got = port_layers.unembed(t(x), t(head), vocab)
        want = ref_layers.unembed(jnp.asarray(x), jnp.asarray(head), vocab)
        assert np.array_equal(got[..., vocab:].numpy(),
                              np.asarray(want)[..., vocab:])
        close(got[..., :vocab], np.asarray(want)[..., :vocab], LAYER_TOL)
    table = rng.normal(size=(30, 8)).astype(np.float32)
    tok = rng.integers(0, 30, (2, 5)).astype(np.int32)
    assert np.array_equal(port_layers.embed_tokens(t(tok), t(table)).numpy(),
                          np.asarray(ref_layers.embed_tokens(
                              jnp.asarray(tok), jnp.asarray(table))))


def test_layers_keep_reference_bfloat16_steps():
    """rms_norm casts back before the weight multiplies, rope computes in
    float32 and casts once: in bfloat16 both agree with the reference's
    to one bfloat16 rounding."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 24, 32)).astype(np.float32),
                    jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=32).astype(np.float32), jnp.bfloat16)
    got = port_layers.rms_norm(params_from_reference(np.asarray(x), "cpu"),
                               params_from_reference(np.asarray(w), "cpu"),
                               1e-5)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(ref_layers.rms_norm(x, w, 1e-5),
                                  np.float32), 2 ** -8)
    xh = x.reshape(2, 24, 2, 16)
    got = port_layers.rope(params_from_reference(np.asarray(xh), "cpu"),
                           torch.arange(24), 1e6)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(ref_layers.rope(xh, jnp.arange(24), 1e6),
                                  np.float32), 2 ** -8)


@pytest.mark.parametrize("kv,n_out", [(1, 3), (2, 4), (2, 2)])
def test_expand_kv_matches_reference(kv, n_out):
    x = np.random.default_rng(kv).normal(size=(2, 5, kv, 4)).astype(
        np.float32)
    assert np.array_equal(port_attn._expand_kv(t(x), n_out).numpy(),
                          np.asarray(ref_attn._expand_kv(jnp.asarray(x),
                                                         n_out)))


# ---------------------------------------------------------------------- #
# attention functions
# ---------------------------------------------------------------------- #
def attn_case(h, kv, d, window, d_model=32, seed=0):
    dims = ref_attn.AttnDims(h, h, kv, kv, d, window)
    pdims = port_attn.AttnDims(h, h, kv, kv, d, window)
    p = jax.tree.map(lambda a: a[0], live_params(
        ref_attn.attn_specs(1, d_model, dims, qkv_bias=True), seed))
    pp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    return dims, pdims, p, pp


@pytest.mark.parametrize("window,chunk", [(None, 16), (8, 16), (None, 64),
                                          (24, 16)])
def test_attention_matches_reference(window, chunk):
    dims, pdims, p, pp = attn_case(3, 1, 16, window)
    x = (np.random.default_rng(2).normal(size=(2, 64, 32)) * 0.5).astype(
        np.float32)
    pos = np.arange(64, dtype=np.int32)
    want = ref_attn.attention(p, jnp.asarray(x), jnp.asarray(pos), dims,
                              1e4, chunk=chunk)
    close(port_attn.attention(pp, t(x), t(pos), pdims, 1e4, chunk=chunk),
          want, LAYER_TOL)
    want = ref_attn.flash_attention_block(p, jnp.asarray(x),
                                          jnp.asarray(pos), dims, 1e4,
                                          blocks=(16, 16))
    close(port_attn.flash_attention_block(pp, t(x), t(pos), pdims, 1e4),
          want, LAYER_TOL)


@pytest.mark.parametrize("window,l,lc", [(None, 12, 20), (8, 12, 8),
                                         (8, 8, 8), (8, 5, 8)])
def test_prefill_kv_into_cache_matches_reference(window, l, lc):
    """Linear cache, ring cache wrapped (l > lc), exactly full and not
    yet full."""
    dims, pdims, p, pp = attn_case(4, 2, 16, window)
    x = np.random.default_rng(3).normal(size=(2, l, 32)).astype(np.float32)
    pos = np.arange(l, dtype=np.int32)
    zeros = jnp.zeros((2, lc, 2, 16), jnp.float32)
    wk, wv = ref_attn.prefill_kv_into_cache(p, jnp.asarray(x),
                                            jnp.asarray(pos), dims, 1e4,
                                            zeros, zeros)
    ck, cv = torch.zeros(2, lc, 2, 16), torch.zeros(2, lc, 2, 16)
    gk, gv = port_attn.prefill_kv_into_cache(pp, t(x), t(pos), pdims, 1e4,
                                             ck, cv)
    assert gk is ck and gv is cv  # written in place
    close(gk, wk, LAYER_TOL)
    close(gv, wv, LAYER_TOL)
    with pytest.raises(TypeError, match="dtype="):
        port_attn.prefill_kv_into_cache(
            pp, t(x), t(pos), pdims, 1e4,
            torch.zeros(2, lc, 2, 16, dtype=torch.bfloat16),
            torch.zeros(2, lc, 2, 16, dtype=torch.bfloat16))


@pytest.mark.parametrize("window,lc,positions", [
    (None, 16, (0, 5, 15)), (8, 8, (3, 8, 13, 21))])
def test_decode_attention_matches_reference(window, lc, positions):
    """One-token steps against a linear cache and a ring that wraps."""
    dims, pdims, p, pp = attn_case(4, 2, 16, window)
    rng = np.random.default_rng(4)
    ck = rng.normal(size=(2, lc, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(2, lc, 2, 16)).astype(np.float32)
    rk, rv = jnp.asarray(ck), jnp.asarray(cv)
    pk, pv = t(ck), t(cv)
    for pos in positions:
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        want, rk, rv = ref_attn.decode_attention(p, jnp.asarray(x), rk, rv,
                                                 jnp.int32(pos), dims, 1e4)
        got, pk, pv = port_attn.decode_attention(pp, t(x), pk, pv, pos,
                                                 pdims, 1e4)
        close(got, want, LAYER_TOL)
        close(pk, rk, LAYER_TOL)
        close(pv, rv, LAYER_TOL)


# ---------------------------------------------------------------------- #
# whole models
# ---------------------------------------------------------------------- #
def model_pair(name, impl, seed=0):
    cfg = dataclasses.replace(ref_get_config(name, smoke=True),
                              attn_impl=impl)
    ref = ref_build(cfg)
    params = live_params(ref.param_specs(), seed)
    port = build(dataclasses.replace(get_config(name, smoke=True),
                                     attn_impl=impl))
    return ref, params, port, params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_prefill_and_decode_match_reference(name, impl):
    ref, rp, port, pp = model_pair(name, impl)
    prompt = 20   # > starcoder2's window 8: its ring cache wraps
    toks = np.random.default_rng(5).integers(
        0, ref.cfg.vocab_size, (2, prompt)).astype(np.int32)
    ref_prefill = jax.jit(lambda p, x: ref.prefill(p, x, 32,
                                                   dtype=jnp.float32))
    ref_decode = jax.jit(ref.decode_step)
    want, rstate = ref_prefill(rp, jnp.asarray(toks))
    got, pstate = port.prefill(pp, t(toks), 32, dtype=torch.float32)
    close(got, want, MODEL_TOL)
    close(pstate["attn"]["k"], rstate["attn"]["k"], MODEL_TOL)
    close(pstate["attn"]["v"], rstate["attn"]["v"], MODEL_TOL)
    tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for step in range(12):
        pos = prompt + step
        want, rstate = ref_decode(rp, tok, jnp.int32(pos), rstate)
        got, pstate = port.decode_step(pp, t(tok), pos, pstate)
        close(got, want, MODEL_TOL)
        tok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)[:, None]
    close(pstate["attn"]["k"], rstate["attn"]["k"], MODEL_TOL)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "starcoder2-3b"])
def test_forward_matches_reference(name):
    ref, rp, port, pp = model_pair(name, "flash", seed=1)
    toks = np.random.default_rng(6).integers(
        0, ref.cfg.vocab_size, (2, 24)).astype(np.int32)
    want, want_aux = ref.forward(rp, jnp.asarray(toks))
    got, aux = port.forward(pp, t(toks))
    close(got, want, MODEL_TOL)
    assert float(aux) == float(want_aux) == 0.0


def test_prefill_of_float32_weights_needs_a_float32_cache():
    """As in the reference, the default bfloat16 cache does not take
    float32 keys: a named TypeError, not a silent downcast."""
    _, _, port, pp = model_pair("qwen2-1.5b", "jnp")
    with pytest.raises(TypeError, match="dtype=torch.float32"):
        port.prefill(pp, torch.zeros(1, 4, dtype=torch.int32), 8)
