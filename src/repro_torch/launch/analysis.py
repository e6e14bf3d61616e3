"""Roofline terms of a step on the H100, and the model's FLOP and byte
floors.

The port of the JAX package's ``launch/analysis.py``: ``Roofline`` and
``roofline()`` field for field, ``_param_count``, ``model_flops`` and
``model_bytes`` line for line, on the peaks of one NVIDIA H100 SXM (the
data sheet, dense, at its 700 W limit):

  peak bf16 compute  989 TFLOP/s
  HBM bandwidth      3.35 TB/s
  NVLink             450 GB/s each way

  compute    = FLOPs (per device) / peak
  memory     = bytes accessed (per device) / HBM bandwidth
  collective = collective operand bytes (per device) / NVLink bandwidth

There is no compiled program to parse: the dry run (``launch/dryrun.py``)
counts a step's FLOPs and bytes as it runs on ``meta`` tensors, and its
collective bytes with ``sharding/collectives.counter``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "Roofline", "roofline",
           "model_flops", "model_bytes"]

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: float
    model_bytes: float = 0.0  # information-theoretic byte floor (decode)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """ideal/bound, where ideal = the better of the two fundamental
        limits: model FLOPs at peak compute, or model bytes at HBM
        bandwidth (the floor for decode). 1.0 = at roofline."""
        ideal = max(self.model_flops / PEAK_FLOPS, self.model_bytes / HBM_BW)
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "model_bytes": self.model_bytes,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float, model_flops_per_dev: float,
             model_bytes_per_dev: float = 0.0) -> Roofline:
    return Roofline(
        compute_s=flops_per_dev / PEAK_FLOPS,
        memory_s=bytes_per_dev / HBM_BW,
        collective_s=coll_bytes_per_dev / LINK_BW,
        flops=flops_per_dev,
        bytes_accessed=bytes_per_dev,
        collective_bytes=coll_bytes_per_dev,
        model_flops=model_flops_per_dev,
        model_bytes=model_bytes_per_dev,
    )


# ---------------------------------------------------------------------- #
def _param_count(cfg, active_only: bool) -> float:
    """Parameters (embedding included once), MoE optionally active-only."""
    d = cfg.d_model
    kinds = cfg.layer_kinds()
    hd = cfg.resolved_head_dim
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    for kind in kinds:
        if kind == "attn":
            attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + \
                cfg.n_heads * hd * d
            total += attn
            if cfg.moe is not None:
                e_active = cfg.moe.top_k if active_only else cfg.moe.n_experts
                total += 3 * d * cfg.moe.d_ff_expert * e_active
                total += 3 * d * cfg.moe.d_ff_shared
                total += d * cfg.moe.n_experts  # router
            else:
                total += 3 * d * cfg.d_ff
        elif kind == "rec":
            dr = cfg.rg_lru_dim or d
            total += 2 * d * dr + 2 * dr * dr + dr * d + 3 * d * cfg.d_ff
        elif kind == "mlstm":
            du = 2 * d
            total += 2 * d * du + 3 * du * du + du * d
        elif kind == "slstm":
            total += d * 4 * d + d * d + d * d  # gates + rec + out
    return float(total)


def model_flops(cfg, shape, per_device_chips: int = 1) -> float:
    """MODEL_FLOPS: 6·N·D (dense) / 6·N_active·D (MoE) for training;
    2·N·tokens for a decode/prefill forward. Global, then /chips."""
    n_active = _param_count(cfg, active_only=True)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        fl = 6.0 * n_active * toks
    elif shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        fl = 2.0 * n_active * toks
    else:  # decode: one token per stream
        toks = shape.global_batch
        fl = 2.0 * n_active * toks
    return fl / per_device_chips


def model_bytes(cfg, shape, model=None, per_device_chips: int = 1) -> float:
    """Information-theoretic HBM byte floor per step (global, then /chips).

    decode: every live parameter is read once (with >=128 concurrent
    streams, MoE experts are all touched) + the KV cache / recurrent state
    is read once and the new slice written. train/prefill: params + one
    read/write of the residual stream (compute-dominated; the floor only
    matters when it exceeds the FLOP term).
    """
    n_params = _param_count(cfg, active_only=False)
    p_bytes = 2.0 * n_params  # bf16
    d = cfg.d_model
    kinds = cfg.layer_kinds()
    hd = cfg.resolved_head_dim
    kvc = model.dims.n_kv_cache if model is not None else cfg.n_kv_heads
    state_bytes = 0.0
    if shape.kind == "decode":
        lc = min(cfg.window, shape.seq_len) if cfg.window else shape.seq_len
        for kind in kinds:
            if kind == "attn":
                state_bytes += shape.global_batch * lc * kvc * hd * 2 * 2
            elif kind == "rec":
                dr = cfg.rg_lru_dim or d
                state_bytes += shape.global_batch * dr * 4 * 2
            elif kind == "mlstm":
                du = 2 * d
                state_bytes += (shape.global_batch * du * du // cfg.n_heads
                                * 4 * 2)
            elif kind == "slstm":
                state_bytes += shape.global_batch * d * 4 * 4 * 2
        total = p_bytes + state_bytes
    else:
        toks = shape.global_batch * shape.seq_len
        total = p_bytes + 2.0 * toks * d * 2
    return total / per_device_chips
