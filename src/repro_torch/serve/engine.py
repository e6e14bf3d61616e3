"""Batched serving engine: prefill + greedy decode with a shared KV state.

The port of the JAX package's ``serve/engine.py``. Requests are padded
to a common prompt length by the caller, prefilled in one shot, then
decoded step by step. Per-request EOS masking freezes finished streams
(their cache slots keep ticking; slot reuse is an orchestration concern
above this engine). The model is duck-typed (``prefill`` and
``decode_step`` as ``models.transformer.Model`` has them), and the engine
runs where the weights are: the first tensor of ``params`` sets the
device its tokens go to, the card for a model built by default.

A model on a mesh takes placed params and returns logits split over the
vocabulary (``sharding.Sharded``); its greedy token is each ``model``
slot's argmax, then the largest of the slots' (value, index) pairs, ties
to the lower index (``models.parallel.greedy_tokens``): what one argmax
over the whole vocabulary returns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.parallel import greedy_tokens
from ..models.params import tree_leaves
from ..sharding.placed import Sharded

__all__ = ["ServeEngine"]


@dataclasses.dataclass
class ServeEngine:
    model: object
    params: object
    max_seq_len: int = 512
    eos_id: int = -1  # -1: never stops early

    def __post_init__(self):
        tensors = [x.shards[0] if isinstance(x, Sharded) else x
                   for x in tree_leaves(self.params)
                   if isinstance(x, (torch.Tensor, Sharded))]
        # a model with no tensor weights (a scripted one) places its own
        # inputs: its tokens stay on the host
        self.device = tensors[0].device if tensors else torch.device("cpu")

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32):
        """prompts (B, Lp) int32 -> (B, <=max_new_tokens) greedy tokens."""
        B, Lp = prompts.shape
        toks = torch.as_tensor(np.asarray(prompts, np.int32),
                               device=self.device)
        logits, state = self.model.prefill(self.params, toks,
                                           self.max_seq_len)
        tok = _greedy(logits)[:, None]
        first = tok.cpu().numpy()
        done = first[:, 0] == self.eos_id
        out = [first]
        pos = Lp
        for _ in range(max_new_tokens - 1):
            if done.all():
                break
            logits, state = self.model.decode_step(self.params, tok, pos,
                                                   state)
            tok = _greedy(logits)[:, None]
            # per-request EOS masking: a finished stream's slot keeps
            # ticking, but its output is pinned to eos_id (pad): the live
            # argmax of a dead stream must never reach `out`
            step = np.where(done[:, None], np.int32(self.eos_id),
                            tok.cpu().numpy())
            done |= (step[:, 0] == self.eos_id)
            out.append(step)
            tok = torch.as_tensor(step, device=self.device)
            pos += 1
        return np.concatenate(out, axis=1)


def _greedy(logits) -> torch.Tensor:
    """(B,) int32 greedy tokens of the last position's logits."""
    if isinstance(logits, Sharded):
        return greedy_tokens(logits)
    return logits[:, -1].argmax(dim=-1).to(torch.int32)
