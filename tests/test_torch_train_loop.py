"""PyTorch port vs JAX package: the training loop on the CPU.

Each comparison starts both packages from one state, the reference's
``init_train_state`` carried across bit for bit by
``train_state_from_reference``, and feeds both the same
``TokenStream`` batches (bit-equal, ``test_torch_train.py``). Held:

- 3 steps of ``make_train_step`` at ``microbatches`` 1 and 2 for qwen2
  and qwen2-moe (the attention projections conditioned as the card's
  smoke conditions them, ``condition``), the params bf16 after step 1 as
  in the reference;
- ``microbatches`` 2 and 4 against 1 on one batch, float32 state;
- checkpoints written by each package restored by the other (exact),
  keep-k, async save, restore onto meta targets;
- restart after an injected failure, bit-identical to the uninterrupted
  run, and the straggler watchdog;
- ``ElasticRun`` killed and resumed on 4 then 2 slots, bit-identical to
  the port's uninterrupted run and close to the reference's;
- ``python -m repro_torch.launch.train --smoke --device cpu`` run twice
  on one checkpoint directory, the second resuming; with no ``--device``
  and no card it raises ``DeviceUnavailableError``;
- ``compressed_psum`` over 8 CPU slots against the reference's own
  8-device run (``tests/test_fault_tolerance.py``'s check), with its
  error-feedback convergence (tolerances in the test);
- ``make_serve_step`` greedy tokens equal to the reference's.

Tolerances, and why. Step 1 runs the float32 weights the state starts
from: the master weights agree within 0.1 x lr of step 1 (observed
<= 2.5e-2 x lr: float32 summation orders). From step 2 on the params are
bf16, and bf16 arithmetic rounds otherwise in the two packages (XLA keeps
float32 intermediates inside its fusions; torch rounds every op to
bf16): gradients differ by ~1-2 % of their scale, and an element whose
gradient is near 0 can take the other sign, so Adam moves it by lr the
other way. Each later step may so add 2 x lr: the master weights must
agree within 0.1 x lr_1 + 2 x (lr_2 + lr_3), and their median within
0.05 x lr_3 (observed <= 0.018 x lr_3); each step's loss within 1 %
(observed <= 0.2 %). The raw reference init takes fan_in from the head
axis for wq, wk and wv (ROADMAP §3): scores are then ~10x too large, one
bf16 rounding flips a softmax, and the two trajectories part within two
steps (grad norms 50 % apart), which says nothing about the port; so
these states are conditioned first, as the card's smoke does.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as ref_get_config
from repro.data.synth import TokenStream as RefTokenStream
from repro.models.transformer import build as ref_build
from repro.train.checkpoint import CheckpointManager as RefManager
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.trainer import init_train_state as ref_init_state
from repro.train.trainer import make_serve_step as ref_serve_step
from repro.train.trainer import make_train_step as ref_train_step
from repro_torch.configs import get_config
from repro_torch.data.synth import TokenStream
from repro_torch.errors import DeviceUnavailableError
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import train_state_from_reference
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import build
from repro_torch.train import compression
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import ElasticRun, resume
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import (Trainer, abstract_train_state,
                                       init_train_state, make_serve_step,
                                       make_train_step)

ROOT = Path(__file__).resolve().parent.parent
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEP1_TOL = 0.1          # x lr of step 1
LATER_FLIPS = 2.0        # x lr of each later (bf16) step
MEDIAN_TOL = 0.05        # x lr of the last step
LOSS_REL = 1e-2
F32_TOL = 2e-5           # relative, float32 microbatch sums


def condition(state, model):
    """Rescale the reference state's attention projections to 1/sqrt of
    the width they contract (chip_smoke.condition_attention's rule), in
    params and master alike."""
    dims, d = model.dims, model.cfg.d_model
    scales = {"wq": (dims.n_heads_p / d) ** 0.5, "wk": (dims.n_kv / d) ** 0.5,
              "wv": (dims.n_kv / d) ** 0.5, "wo": (1 / dims.n_heads_p) ** 0.5}

    def fix(tree):
        a = dict(tree["blocks"]["attn"]["attn"])
        for name, s in scales.items():
            a[name] = (a[name].astype(jnp.float32) * s).astype(a[name].dtype)
        blocks = dict(tree["blocks"])
        blocks["attn"] = dict(blocks["attn"], attn=a)
        return dict(tree, blocks=blocks)
    params = fix(state["params"])
    return {"params": params,
            "opt": dict(state["opt"], master=jax.tree.map(
                lambda p: p.astype(jnp.float32), params))}


def pair(name, seed=0, cond=True, dtype=jnp.float32):
    """(ref model, port model, ref state, port state) from one state."""
    rm = ref_build(ref_get_config(name, smoke=True))
    pm = build(get_config(name, smoke=True))
    rs = ref_init_state(rm, jax.random.key(seed), dtype)
    if cond:
        rs = condition(rs, rm)
    return rm, pm, rs, train_state_from_reference(
        jax.tree.map(np.asarray, rs), device="cpu")


def streams(vocab, batch=4, seq=16, seed=3):
    return (RefTokenStream(vocab, batch, seq, seed=seed),
            TokenStream(vocab, batch, seq, seed=seed, device="cpu"))


def diffs(got, want):
    return np.concatenate([
        np.ravel(b.detach().double().numpy()
                 - np.asarray(a, np.float64))
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got))])


def assert_master_close(got, want, lrs):
    d = np.abs(diffs(got["opt"]["master"], want["opt"]["master"]))
    bound = STEP1_TOL * lrs[0] + LATER_FLIPS * sum(lrs[1:])
    assert d.max() <= bound, (d.max(), bound)
    assert np.median(d) <= MEDIAN_TOL * lrs[-1], np.median(d)


def equal_states(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("mb", [1, 2])
def test_three_train_steps_match_reference(name, mb):
    rm, pm, rs, ps = pair(name)
    rstep = jax.jit(ref_train_step(rm, RefAdamW(**OPT), microbatches=mb))
    pstep = make_train_step(pm, AdamWConfig(**OPT), microbatches=mb)
    rstream, pstream = streams(rm.cfg.vocab_size)
    lrs = []
    for s in range(3):
        rs, rmet = rstep(rs, rstream.batch_at(s))
        ps, pmet = pstep(ps, pstream.batch_at(s))
        lrs.append(float(rmet["lr"]))
        assert float(pmet["lr"]) == lrs[-1]
        assert sorted(pmet) == sorted(rmet)
        assert abs(float(pmet["loss"]) - float(rmet["loss"])) <= (
            LOSS_REL * abs(float(rmet["loss"])))
        assert int(ps["opt"]["step"]) == s + 1
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(ps["params"]))
        assert all(torch.equal(p, w.to(torch.bfloat16)) for p, w in zip(
            tree_leaves(ps["params"]), tree_leaves(ps["opt"]["master"])))
        if s == 0:
            assert_master_close(ps, rs, lrs)
    assert_master_close(ps, rs, lrs)
    if name == "qwen2-moe-a2.7b":
        assert float(pmet["aux"]) > 0


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatches_match_one_batch(mb):
    """One step on one batch of 4 rows: accumulated over mb microbatches
    against the whole batch, float32 state, in the port alone (the split
    is the reference's reshape: rows k*B/mb onward)."""
    _, pm, _, ps = pair("qwen2-1.5b")
    _, pstream = streams(pm.cfg.vocab_size)
    batch = pstream.batch_at(0)
    opt = AdamWConfig(**OPT)
    one, m1 = make_train_step(pm, opt)(tree_map(torch.clone, ps), batch)
    acc, m2 = make_train_step(pm, opt, microbatches=mb)(
        tree_map(torch.clone, ps), batch)
    for key in ("loss", "ce", "grad_norm"):
        assert abs(float(m2[key]) - float(m1[key])) <= F32_TOL * abs(
            float(m1[key])), key
    d = np.abs(diffs(acc["opt"]["master"], jax.tree.map(
        lambda t: t.numpy(), one["opt"]["master"])))
    assert d.max() <= STEP1_TOL * float(m1["lr"])
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(pm, opt, microbatches=3)(ps, batch)


# ---------------------------------------------------------------------- #
def stepped_pair(tmp_path):
    """Both packages' states after one bf16 step (bf16 params, float32
    opt state), equal bit for bit, and the reference's train step."""
    rm, pm, rs, _ = pair("qwen2-1.5b", cond=False, dtype=jnp.bfloat16)
    rs, _ = jax.jit(ref_train_step(rm, RefAdamW(**OPT)))(
        rs, streams(rm.cfg.vocab_size)[0].batch_at(0))
    return rm, pm, rs, train_state_from_reference(
        jax.tree.map(np.asarray, rs), device="cpu")


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by the reference restores in the port bit for
    bit (onto meta targets and onto the CPU), and one written by the port
    restores in the reference bit for bit; the files hold the same keys
    (bf16 leaves under ``::bf16``)."""
    rm, pm, rs, ps = stepped_pair(tmp_path)
    RefManager(str(tmp_path / "ref")).save(1, rs)
    got = CheckpointManager(str(tmp_path / "ref")).restore(
        1, abstract_train_state(pm), placement="cpu")
    assert equal_states(got, ps)
    CheckpointManager(str(tmp_path / "port")).save(1, ps)
    back = RefManager(str(tmp_path / "port")).restore(1, rs)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    metas = [json.loads((tmp_path / d / "step_00000001" / "meta.json")
                        .read_text()) for d in ("ref", "port")]
    assert metas[0] == metas[1]
    assert any(k.endswith("::bf16") for k in metas[0]["keys"])
    assert "opt//step" in metas[0]["keys"]


def test_checkpoint_keep_k_async_and_targets(tmp_path):
    """keep=2 keeps the newest two; async save publishes after ``wait``,
    its host copy taken at ``save``, a copy even of CPU tensors (a later
    in-place change, as the train step makes, is not in the file); restore places leaves on the target's device, a wrong
    shape raises; ``resume`` cold-starts on an empty directory."""
    _, pm, _, ps = stepped_pair(tmp_path)
    from repro_torch.train.checkpoint import _flatten
    host = _flatten(ps)     # what save hands its writer thread
    ps["opt"]["v"]["embed"].add_(1.0)
    assert not np.array_equal(host["opt//v//embed"],
                              ps["opt"]["v"]["embed"].numpy())
    mgr = CheckpointManager(str(tmp_path / "k"), keep=2, async_save=True)
    assert resume(mgr, abstract_train_state(pm)) == (None, 0)
    for s in (10, 20, 30, 40):
        mgr.save(s, ps)
    saved = tree_map(torch.clone, ps)
    ps["opt"]["m"]["embed"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [30, 40] and mgr.latest_step() == 40
    got = mgr.restore(40, saved)
    assert equal_states(got, saved)
    state, step = resume(mgr, abstract_train_state(pm), "cpu")
    assert step == 40 and equal_states(state, saved)
    bad = abstract_train_state(build(get_config("granite-3-8b", smoke=True)))
    with pytest.raises((ValueError, KeyError)):
        mgr.restore(40, bad)


# ---------------------------------------------------------------------- #
GRANITE_STEPS = 10


@pytest.fixture(scope="module")
def granite():
    """granite-3-8b's smoke model, both packages, from one float32 state
    (the reference's key 1, conditioned); the reference's uninterrupted
    10 steps."""
    rm, pm, rs, ps = pair("granite-3-8b", seed=1)
    rstream, pstream = streams(rm.cfg.vocab_size, batch=2, seed=7)
    rstep = jax.jit(ref_train_step(rm, RefAdamW(**OPT)))
    ref, lrs = rs, []
    for s in range(GRANITE_STEPS):
        ref, met = rstep(ref, rstream.batch_at(s))
        lrs.append(float(met["lr"]))
    return pm, ps, pstream, ref, lrs


def port_uninterrupted(pm, ps, pstream):
    state = tree_map(torch.clone, ps)
    step = make_train_step(pm, AdamWConfig(**OPT))
    for s in range(GRANITE_STEPS):
        state, _ = step(state, pstream.batch_at(s))
    return state


def test_restart_resumes_bit_identical(tmp_path, granite):
    """Killed at step 7, resumed from the step-5 checkpoint: the same
    state as the uninterrupted run, bit for bit, and that state close to
    the reference's uninterrupted run."""
    pm, ps, pstream, ref, lrs = granite
    want = port_uninterrupted(pm, ps, pstream)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    step_fn = make_train_step(pm, AdamWConfig(**OPT))
    trainer = Trainer(step_fn, pstream.batch_at, mgr, checkpoint_every=5)
    with pytest.raises(RuntimeError, match="injected"):
        trainer.run(tree_map(torch.clone, ps), 0, 10, inject_failure_at=7)
    last = mgr.latest_step()
    assert last == 5
    state = mgr.restore(last, abstract_train_state(pm), "cpu")
    state, _, step = trainer.run(state, last, GRANITE_STEPS - last)
    assert step == GRANITE_STEPS
    assert equal_states(state, want)
    assert_master_close(state, ref, lrs)


def test_straggler_watchdog_fires():
    import time
    events = []
    slow = {"n": 0}

    def fake_step(state, batch):
        slow["n"] += 1
        time.sleep(0.25 if slow["n"] == 9 else 0.005)
        return state, {}

    tr = Trainer(fake_step, lambda s: None, None, straggler_factor=3.0,
                 on_straggler=lambda s, dt, med: events.append(s))
    tr.run({}, 0, 10)
    assert 8 in events, events


def test_elastic_kill_shrink_resume(tmp_path, granite):
    """``ElasticRun`` on 4 slots, a node failure at step 6, resumed on 2
    slots from the step-4 checkpoint: the port's uninterrupted state bit
    for bit, close to the reference's uninterrupted run (whose own
    elastic test is red on jax 0.9.0, ROADMAP §3)."""
    pm, ps, pstream, ref, lrs = granite
    want = port_uninterrupted(pm, ps, pstream)
    mgr = CheckpointManager(str(tmp_path / "el"), keep=2)
    built = []

    def build_for(slots):
        mesh = make_host_mesh(slots, device="cpu")
        built.append(len(mesh.devices))
        return (make_train_step(pm, AdamWConfig(**OPT)),
                abstract_train_state(pm), mesh.devices[0])

    def factory(step_fn):
        return Trainer(step_fn, pstream.batch_at, mgr, checkpoint_every=2)
    run = ElasticRun(mgr, build_for, lambda: tree_map(torch.clone, ps))
    state, step = run.run_with_failures(
        factory, GRANITE_STEPS, failure_schedule={0: 5},
        device_schedule={0: 4, 5: 2})
    assert step == GRANITE_STEPS and built == [4, 2]
    assert equal_states(state, want)
    assert_master_close(state, ref, lrs)


# ---------------------------------------------------------------------- #
def run_cli(args, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], capture_output=True, text=True, env=env,
                         cwd=tmp, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_launch_train_resumes_from_its_checkpoint(tmp_path):
    """Two runs of the entry point on one --ckpt-dir: the first trains 4
    steps and checkpoints, the second resumes at step 4 and trains to 6,
    leaving the newest three checkpoints; both print the reference's
    lines. A third run at --steps 6 resumes with nothing left to run."""
    ck = str(tmp_path / "run")
    common = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--ckpt-dir", ck,
              "--ckpt-every", "2"]
    first = run_cli(common + ["--steps", "4"], tmp_path)
    assert not any(line.startswith("resumed") for line in first)
    assert first[-1].startswith("step=4 loss=") and "s/step)" in first[-1]
    loss = float(first[-1].split("loss=")[1].split()[0])
    assert 0 < loss < 2 * np.log(151)
    second = run_cli(common + ["--steps", "6"], tmp_path)
    assert second[0] == "resumed from checkpoint at step 4"
    assert second[-1].startswith("step=6 loss=")
    assert CheckpointManager(ck).all_steps() == [2, 4, 6]
    third = run_cli(common + ["--steps", "6"], tmp_path)
    assert third[0] == "resumed from checkpoint at step 6"
    assert third[-1].startswith("step=6 loss=nan")


def test_launch_train_needs_a_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(DeviceUnavailableError):
        launch_train.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1"])
    with pytest.raises(DeviceUnavailableError):
        TokenStream(151, 1, 4).batch_at(0)


def test_training_never_loads_jax_or_repro(tmp_path):
    """The training path in a fresh interpreter (the entry point with
    checkpoints, a resumed run, compression) leaves jax, repro and
    ml_dtypes unloaded."""
    code = ("import sys, torch\n"
            "from repro_torch.launch.train import main\n"
            "from repro_torch.train import compression\n"
            f"args = ['--arch', 'xlstm-350m', '--smoke', '--device', 'cpu', "
            f"'--batch', '2', '--seq', '8', '--ckpt-dir', {str(tmp_path)!r}, "
            "'--ckpt-every', '1']\n"
            "main(args + ['--steps', '2']); main(args + ['--steps', '3'])\n"
            "compression.compressed_psum([torch.ones(3), torch.zeros(3)])\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'ml_dtypes')\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resumed from checkpoint at step 2" in out.stdout
    assert "LOADED []" in out.stdout
    for path in (ROOT / "src" / "repro_torch" / "train").glob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from repro." not in text, path


# ---------------------------------------------------------------------- #
_REF_COMPRESSION = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.train.compression import compressed_psum
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

mesh = jax.make_mesh((8,), ("data",))
x = jnp.asarray(np.load(sys.argv[1]))

def body(xs, err):
    out, new_err = compressed_psum(xs[0], "data", err[0])
    return out[None], new_err[None]

f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data"))))
err = jnp.zeros_like(x)
outs, errs = [], []
for i in range(64):
    out, err = f(x, err)
    outs.append(np.asarray(out))
    errs.append(np.asarray(err))
np.savez(sys.argv[2], outs=np.stack(outs), errs=np.stack(errs))
print("REF_OK")
"""


def test_compressed_psum_matches_reference_8_slots(tmp_path):
    """8 CPU slots against the reference's 8 forced host devices, 64
    error-feedback rounds on one (8, 256) gradient: each slot's error
    buffer within (round + 1) x 2^-22 x max|x| (XLA fuses ``xf - codes *
    scale`` into one rounding, torch rounds the product first: observed
    1.2e-7 after one round, 5.6e-6 after 49, the codes equal), the mean
    within 1e-6 of max|x| every round (the sum over slots may be ordered
    otherwise; observed equal); the reference's own bounds: one shot
    within max|x| / 127 of the exact mean, the 64-round average within a
    1/8 of that."""
    x = np.random.default_rng(0).normal(size=(8, 256)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _REF_COMPRESSION,
                          str(tmp_path / "x.npy"), str(tmp_path / "ref.npz")],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    mesh = make_host_mesh(8, device="cpu")
    xs = [torch.from_numpy(x[k]).to(d) for k, d in enumerate(mesh.devices)]
    errs = None
    exact = x.mean(0)
    tol = np.abs(x).max() / 127.0
    acc = np.zeros_like(exact)
    for i in range(64):
        res = compression.compressed_psum(xs, errs)
        errs = [e for _, e in res]
        for k, (mean, err) in enumerate(res):
            assert np.abs(err.numpy() - ref["errs"][i][k]).max() <= (
                (i + 1) * 2.0 ** -22 * np.abs(x).max())
            assert np.abs(mean.numpy() - ref["outs"][i][k]).max() <= (
                1e-6 * np.abs(x).max())
            assert torch.equal(mean, res[0][0])
        if i == 0:
            assert np.abs(res[0][0].numpy() - exact).max() <= tol + 1e-6
        acc += res[0][0].numpy()
    assert np.abs(acc / 64 - exact).max() < tol / 8


def test_compressed_psum_tree_per_slot():
    trees = [{"a": torch.full((3,), float(k)), "b": {"c": torch.ones(2)}}
             for k in range(4)]
    out = compression.compressed_psum_tree(trees)
    assert len(out) == 4
    for mean, err in out:
        torch.testing.assert_close(mean["a"], torch.full((3,), 1.5),
                                   atol=3 / 127, rtol=0)
        assert torch.equal(mean["b"]["c"], torch.ones(2))
        assert sorted(err) == ["a", "b"]
    with pytest.raises(ValueError, match="slots"):
        compression.compressed_psum([torch.ones(2)] * 2, [None])


def test_serve_step_matches_reference():
    """``make_serve_step``: three greedy steps from one token against the
    reference's, float32 weights carried across."""
    rm, pm, rs, ps = pair("qwen2-1.5b")
    rcache = rm.init_decode_state(2, 8, jnp.float32)
    pcache = pm.init_decode_state(2, 8, torch.float32, device="cpu")
    rtok = jnp.asarray([[3], [7]], jnp.int32)
    ptok = torch.tensor([[3], [7]], dtype=torch.int32)
    rstep, pstep = jax.jit(ref_serve_step(rm)), make_serve_step(pm)
    with torch.no_grad():
        for pos in range(3):
            rtok, rcache = rstep(rs["params"], rtok, pos, rcache)
            ptok, pcache = pstep(ps["params"], ptok, pos, pcache)
            assert ptok.dtype == torch.int32
            np.testing.assert_array_equal(ptok.numpy(), np.asarray(rtok))


def test_public_names():
    for name in ("TokenStream", "Trainer", "make_train_step",
                 "init_train_state", "CheckpointManager", "AdamWConfig",
                 "NoBackwardError"):
        assert name in repro_torch.__all__
        assert getattr(repro_torch, name) is not None
    gen = torch.Generator().manual_seed(0)
    model = repro_torch.build_model(get_config("qwen2-1.5b", smoke=True))
    state = repro_torch.init_train_state(model, gen, device="cpu")
    assert int(state["opt"]["step"]) == 0
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(state["params"]))
    assert all(m.dtype == torch.float32 and not m.any()
               for m in tree_leaves(state["opt"]["m"]))
    meta = abstract_train_state(model)
    assert [tuple(a.shape) for a in tree_leaves(meta)] == [
        tuple(a.shape) for a in tree_leaves(state)]
