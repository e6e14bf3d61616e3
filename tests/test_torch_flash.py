"""PyTorch port vs JAX package: the flash-attention kernel K7 on the CPU.

The port's ``kernels.ops.flash_attention`` on CPU tensors runs K7's plain
version (the full float32 softmax with K7's masks). It is held against
the reference's ``repro.kernels.ops.flash_attention``, whose Pallas
kernel runs in interpret mode here as ``tests/test_flash_attention.py``
runs it, and against the port's own ``flash_attention_ref``, on the
reference's cases: causal at L = 64 and 96 and the ragged L = 70, in
float32 and bfloat16, windows 8 and 24, and the model-attention
equivalence. Grouped-query attention is read in place by the port: its
``ops.flash_attention`` takes the unexpanded (B, L, KV, D) keys and
values and is held against the reference's kernel on KV expanded by the
reference's own ``_expand_kv``, at H:KV of 12:2, 4:1 and 2:2, and its
``flash_attention_block`` against the reference's at smoke widths. Inputs
are made with numpy from a seed; bfloat16 inputs are rounded once by JAX
and carried across bit for bit.

Tolerances are the reference's own (``tests/test_flash_attention.py``):
2e-5 in float32, where only the summation order differs (online against
full softmax); 2e-2 in bfloat16, where the reference's kernel rounds p
to bfloat16 before P.V and the plain version keeps it in float32; 3e-5
for the windowed float32 cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attn
from repro.models.params import init_params as ref_init_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as port_attn
from repro_torch.models.convert import params_from_reference

TOLS = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def to_torch(x):
    """A JAX array as a CPU tensor, bit for bit."""
    return params_from_reference(np.asarray(x), device="cpu")


def qkv(seed, b, l, h, d, dtype):
    rng = np.random.default_rng(seed)
    return [jnp.asarray((rng.normal(size=(b, l, h, d)) * 0.3)
                        .astype(np.float32), dtype) for _ in range(3)]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("l,blocks", [(64, (16, 16)), (96, (32, 16)),
                                      (70, (16, 32))])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_matches_reference_kernel_causal(l, blocks, dtype):
    q, k, v = qkv(l, 2, l, 2, 32, dtype)
    want = ref_ops.flash_attention(q, k, v, blocks=blocks)
    before = fa.flash_attention_bhld.launches
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    assert fa.flash_attention_bhld.launches == before  # CPU: no kernel
    assert got.dtype == to_torch(q).dtype and got.shape == (2, l, 2, 32)
    close(got.float(), want, TOLS[dtype])
    # and the port's (B, L, H, D) oracle against the reference's
    close(ops.flash_attention_ref(to_torch(q), to_torch(k),
                                  to_torch(v)).float(),
          ref_ops.flash_attention_ref(q, k, v), TOLS[dtype])


@pytest.mark.parametrize("window", [8, 24])
def test_flash_matches_reference_kernel_windowed(window):
    q, k, v = qkv(window, 1, 64, 2, 16, jnp.float32)
    want = ref_ops.flash_attention(q, k, v, window=window, blocks=(16, 16))
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              window=window)
    close(got, want, 3e-5)
    close(ops.flash_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                  window=window),
          ref_ops.flash_attention_ref(q, k, v, window=window), 3e-5)


def test_flash_bhld_plain_matches_oracle_on_real_rows():
    """The merged-layout plain version, given l_real < Lpad, agrees with
    the (B, L, H, D) oracle on the real rows (the padding rows are
    zeros and lie past every real row's causal mask)."""
    q, k, v = (to_torch(x) for x in qkv(7, 1, 50, 3, 16, jnp.float32))
    merged = [torch.nn.functional.pad(x.transpose(1, 2).reshape(3, 50, 16),
                                      (0, 0, 0, 14)) for x in (q, k, v)]
    got = fa.flash_attention_bhld(*merged, scale=0.25, l_real=50)
    want = ops.flash_attention_ref(q, k, v).transpose(1, 2).reshape(3, 50, 16)
    assert got.shape == (3, 64, 16)
    torch.testing.assert_close(got[:, :50], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("h,kv", [(12, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_gqa_matches_reference_kernel(h, kv, window, dtype):
    """GQA read in place, at the ragged L = 70: the port's plain K7 path
    on the unexpanded KV heads against the reference's Pallas kernel
    (interpret mode) on KV expanded by the reference's ``_expand_kv``."""
    rng = np.random.default_rng(10 * h + kv)
    l, d = 70, 16

    def draw(heads):
        return jnp.asarray((rng.normal(size=(1, l, heads, d)) * 0.3)
                           .astype(np.float32), dtype)
    q, k, v = draw(h), draw(kv), draw(kv)
    want = ref_ops.flash_attention(q, ref_attn._expand_kv(k, h),
                                   ref_attn._expand_kv(v, h), window=window,
                                   blocks=(32, 32), interpret=True)
    before = fa.flash_attention_bhld.launches
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              window=window)
    assert fa.flash_attention_bhld.launches == before  # CPU: no kernel
    assert got.dtype == to_torch(q).dtype and got.shape == (1, l, h, d)
    close(got.float(), want, TOLS[dtype])
    close(ops.flash_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                  window=window).float(), want, TOLS[dtype])


def test_flash_rejects_kv_heads_that_do_not_divide():
    q, k = torch.zeros(1, 8, 6, 16), torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(q, k, k)


def test_flash_rejects_a_window_below_one():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bhld(q, q, q, scale=0.25, window=0)


def _attn_params(dims, d_model, seed):
    specs = ref_attn.attn_specs(1, d_model, dims, qkv_bias=True)
    p = jax.tree.map(lambda s: s[0], ref_init_params(
        specs, jax.random.key(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):  # the zero-initialized biases, made live
        p[b] = jnp.asarray(rng.normal(size=p[b].shape).astype(np.float32)
                           * 0.1)
    return p


@pytest.mark.parametrize("window,heads", [
    pytest.param(None, (4, 2), id="None"), pytest.param(24, (4, 2), id="24"),
    pytest.param(None, (3, 1), id="qwen2-smoke-heads"),
    pytest.param(24, (12, 2), id="12:2-24")])
def test_flash_block_matches_model_attention(window, heads):
    """End to end: the flash block equals the chunked attention path of
    the port, and both equal the reference's chunked attention and its
    flash block (the Pallas kernel in interpret mode on expanded KV); the
    port's flash block reads the KV heads in place."""
    h, kv = heads
    dims = ref_attn.AttnDims(h, h, kv, kv, 16, window)
    pdims = port_attn.AttnDims(h, h, kv, kv, 16, window)
    p = _attn_params(dims, 32, 0)
    pp = params_from_reference(jax.tree.map(np.asarray, p), device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 64, 32)) * 0.3).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    want = ref_attn.attention(p, jnp.asarray(x), jnp.asarray(pos), dims,
                              1e4, chunk=16)
    ref_flash = ref_attn.flash_attention_block(
        p, jnp.asarray(x), jnp.asarray(pos), dims, 1e4, blocks=(16, 16))
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    flash = port_attn.flash_attention_block(pp, xt, pt, pdims, 1e4)
    chunked = port_attn.attention(pp, xt, pt, pdims, 1e4, chunk=16)
    # the reference's own model-equivalence tolerance
    close(flash, want, 2e-4)
    close(chunked, want, 2e-4)
    close(flash, chunked, 2e-4)
    close(flash, ref_flash, 2e-4)
