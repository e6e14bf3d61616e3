"""PyTorch port vs JAX package: the LLM serving engine on the CPU.

``repro_torch.ServeEngine`` and the reference's ``repro.serve.engine.
ServeEngine`` serve the same numpy-made prompts with the same bfloat16
weights (the reference's ``init_params`` from a seed, carried across bit
for bit) on the qwen2 and starcoder2 smoke configs, under both
``attn_impl``s. Also the EOS pin of the reference's scripted-model
regression, greedy == argmax of ``forward``, and where the engine runs.

bfloat16 tolerance: along the reference's own greedy tokens, every
logit of the port is within ``LOGIT_TOL`` = 0.25 of the reference's
(16 bfloat16 ulps at the logits' magnitude of 2-4; observed <= 0.21).
The two round at different places: XLA keeps float32 inside a fused
computation where torch rounds each op to bfloat16, and on the CPU the
port's flash path is K7's plain version (p kept in float32) while the
reference's interpreted kernel rounds p to bfloat16. Greedy tokens can
then differ only where the top-2 gap is at most twice that, so each
stream's tokens must be equal for as long as the reference's top-2 gap
exceeds ``2 * LOGIT_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.models.params import init_params as ref_init_params
from repro.models.transformer import build as ref_build
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import ServeEngine
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import init_params

LOGIT_TOL = 0.25
PROMPT, NEW, STREAMS = 14, 12, 16


def engines(name, impl, seed=0):
    cfg = dataclasses.replace(ref_get_config(name, smoke=True),
                              attn_impl=impl)
    ref = ref_build(cfg)
    rp = ref_init_params(ref.param_specs(), jax.random.key(seed),
                         jnp.bfloat16)
    port = repro_torch.build_model(dataclasses.replace(
        repro_torch.get_config(name, smoke=True), attn_impl=impl))
    pp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    return ref, rp, port, pp


def ref_gaps_and_port_errors(ref, rp, port, pp, prompts, tokens):
    """Along the reference's greedy ``tokens``: the reference's top-2
    gap per stream and step, and the port's largest logit error."""
    lr, rstate = jax.jit(lambda p, x: ref.prefill(p, x, 48))(
        rp, jnp.asarray(prompts))
    lp, pstate = port.prefill(pp, torch.from_numpy(prompts), 48)
    decode = jax.jit(ref.decode_step)
    gaps, err = [], 0.0
    for step in range(tokens.shape[1]):
        want = np.asarray(lr[:, -1], np.float32)
        err = max(err, float(np.abs(want - lp[:, -1].float().numpy()).max()))
        top2 = np.sort(want, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        if step + 1 < tokens.shape[1]:
            tok = tokens[:, step:step + 1]
            lr, rstate = decode(rp, jnp.asarray(tok),
                                jnp.int32(prompts.shape[1] + step), rstate)
            lp, pstate = port.decode_step(pp, torch.from_numpy(tok),
                                          prompts.shape[1] + step, pstate)
    return np.stack(gaps, axis=1), err


def tokens_agree_while_gap_clear(want, got, gaps, margin):
    """Per stream, tokens equal up to the first step whose reference
    top-2 gap is <= ``margin`` -> steps compared in all."""
    compared = 0
    for i in range(want.shape[0]):
        k = 0
        while k < want.shape[1] and gaps[i, k] > margin:
            k += 1
        np.testing.assert_array_equal(got[i, :k], want[i, :k],
                                      err_msg=f"stream {i}")
        compared += k
    return compared


@pytest.mark.parametrize("name", ["qwen2-1.5b", "starcoder2-3b"])
@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_engine_matches_reference_in_bfloat16(name, impl):
    ref, rp, port, pp = engines(name, impl)
    prompts = np.random.default_rng(0).integers(
        0, ref.cfg.vocab_size, (STREAMS, PROMPT)).astype(np.int32)
    want = RefEngine(ref, rp, max_seq_len=48).generate(prompts, NEW)
    got = ServeEngine(port, pp, max_seq_len=48).generate(prompts, NEW)
    assert got.shape == want.shape == (STREAMS, NEW)
    assert got.dtype == np.int32
    gaps, err = ref_gaps_and_port_errors(ref, rp, port, pp, prompts, want)
    assert err <= LOGIT_TOL, err
    compared = tokens_agree_while_gap_clear(want, got, gaps, 2 * LOGIT_TOL)
    assert compared > 0   # the comparison is not vacuous


class _ScriptedModel:
    """Serves a fixed per-step token script (ignores its inputs): the
    crafted-batch harness for the EOS-masking regression."""

    def __init__(self, script, vocab):
        self.script = torch.tensor(script)  # (steps, B)
        self.vocab = vocab

    def prefill(self, params, prompts, max_len):
        logits = torch.nn.functional.one_hot(self.script[0], self.vocab)
        return logits[:, None, :].float(), 0

    def decode_step(self, params, tok, pos, state):
        step = state + 1
        logits = torch.nn.functional.one_hot(self.script[step], self.vocab)
        return logits[:, None, :].float(), step


def test_engine_eos_pins_finished_streams():
    """A stream that hits eos_id emits eos_id (pad) from then on."""
    eos = 7
    # stream 0 finishes at step 1 and its script keeps "generating";
    # stream 1 never finishes
    model = _ScriptedModel([[1, 1], [eos, 2], [3, 3], [4, 4]], vocab=9)
    out = ServeEngine(model, params=None, eos_id=eos).generate(
        np.zeros((2, 4), np.int32), max_new_tokens=4)
    np.testing.assert_array_equal(out, [[1, eos, eos, eos], [1, 2, 3, 4]])
    # eos as the very first (prefill) token freezes the stream too
    model = _ScriptedModel([[eos, 1], [2, 2], [3, 3], [4, 4]], vocab=9)
    out = ServeEngine(model, params=None, eos_id=eos).generate(
        np.zeros((2, 4), np.int32), max_new_tokens=4)
    np.testing.assert_array_equal(out, [[eos, eos, eos, eos], [1, 2, 3, 4]])
    # every stream done: decoding stops early
    model = _ScriptedModel([[eos, eos], [2, 2]], vocab=9)
    out = ServeEngine(model, params=None, eos_id=eos).generate(
        np.zeros((2, 4), np.int32), max_new_tokens=4)
    np.testing.assert_array_equal(out, [[eos], [eos]])


@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_greedy_matches_forward(impl):
    """The first greedy token is the argmax of the full forward pass."""
    cfg = dataclasses.replace(repro_torch.get_config("granite-3-8b",
                                                     smoke=True),
                              attn_impl=impl)
    model = repro_torch.build_model(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(3), device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    out = ServeEngine(model, params, max_seq_len=32).generate(
        prompts, max_new_tokens=1)
    full, _ = model.forward(params, torch.from_numpy(prompts))
    np.testing.assert_array_equal(out[:, 0],
                                  full[:, -1].argmax(dim=-1).numpy())


def test_engine_runs_where_the_weights_are():
    """The engine serves on its weights' device; a build never holds
    weights, and a decode state without ``device=`` wants the card."""
    cfg = repro_torch.get_config("starcoder2-3b", smoke=True)
    model = repro_torch.build_model(cfg)
    assert not list(model.parameters())
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(model, params, max_seq_len=48)
    assert eng.device == torch.device("cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    out = eng.generate(prompts, max_new_tokens=8)
    assert out.shape == (3, 8)
    assert (out >= 0).all() and (out < cfg.vocab_size).all()
    if not torch.cuda.is_available():
        with pytest.raises(repro_torch.DeviceUnavailableError):
            model.init_decode_state(1, 8)
