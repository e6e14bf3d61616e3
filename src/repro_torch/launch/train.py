"""Training entry point: ``python -m repro_torch.launch.train``.

The port of the JAX package's ``launch/train.py``, with the same flags
and printed lines, on the first CUDA device unless ``--device`` says
otherwise (with no card it raises ``DeviceUnavailableError``; it never
moves to the CPU on its own). ``--smoke`` takes the arch's reduced
config (with ``remat="none"``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --device cpu --steps 20 --ckpt-dir /tmp/run1

Restarts resume automatically from the newest checkpoint (kill it
mid-run and re-invoke). The weights are drawn from ``torch.Generator``
seeded 17, so they differ from the reference's ``jax.random.key(17)``
draw; ``models.convert.train_state_from_reference`` carries a reference
state across instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config
from ..core.device import resolve_device
from ..data.synth import TokenStream
from ..models.transformer import build
from ..train.checkpoint import CheckpointManager
from ..train.elastic import resume
from ..train.optimizer import AdamWConfig
from ..train.trainer import (Trainer, abstract_train_state, init_train_state,
                             make_train_step)

__all__ = ["main"]

SEED = 17


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, remat="none")
    model = build(cfg, tp=1)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=SEED,
                         device=dev)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    mgr = CheckpointManager(args.ckpt_dir, keep=3,
                            async_save=True) if args.ckpt_dir else None

    state, start = (None, 0)
    if mgr is not None:
        state, start = resume(mgr, abstract_train_state(model), dev)
        if state is not None:
            print(f"resumed from checkpoint at step {start}", flush=True)
    if state is None:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = init_train_state(model, gen, device=dev)

    def log_straggler(step, dt, med):
        print(f"[straggler] step {step}: {dt:.2f}s vs median {med:.2f}s",
              flush=True)

    trainer = Trainer(step_fn, stream.batch_at, mgr,
                      checkpoint_every=args.ckpt_every,
                      on_straggler=log_straggler)
    t0 = time.time()
    state, metrics, step = trainer.run(state, start, args.steps - start)
    if mgr:
        mgr.wait()
    dt = time.time() - t0
    # a run resumed at --steps has no step left and no loss to print
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"step={step} loss={loss:.4f} "
          f"({dt / max(step - start, 1):.2f}s/step)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
