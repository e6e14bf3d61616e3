"""Causal, optionally sliding-window, flash attention forward (K7).

The port of the JAX package's ``kernels/flash_attention.py``: per
merged batch x head row ``q < l_real``, the softmax of ``q k^T * scale``
over the keys ``k <= q`` (and ``k > q - window`` with a window), times
``v``, with KV pre-expanded to the query heads. The hand-written kernel
(``csrc/flash_attention.cu``) keeps the score tile on chip with an online
softmax, so device-memory traffic is Q + K + V + O; the plain PyTorch
version takes the full float32 softmax with the same masks.

``flash_attention_bhld`` runs the plain version on CPU tensors only and
launches the kernel on CUDA tensors, counting each launch in
``flash_attention_bhld.launches``; there is no fallback: a failed build or
launch raises. Inference only, as in the reference (no backward).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["HEAD_DIMS", "NEG", "flash_attention_bhld",
           "flash_attention_bhld_ref"]

#: head dims the kernel takes (the smoke configs' 16, the full configs' 128)
HEAD_DIMS = (16, 32, 64, 128)
#: masked score, the reference's: finite, so no row meets inf - inf
NEG = -1e30
_MAX_Q_BLOCKS = 65535          # the kernel's grid y: 64-row q blocks


def flash_attention_bhld_ref(q, k, v, *, scale: float, window=None,
                             l_real: int | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention_bhld``: the full float32 softmax
    with the same masks (the reference's ``ops.flash_attention_ref`` on
    the merged layout). Rows >= ``l_real`` are computed as if they were
    real; the kernel leaves them unwritten."""
    lpad = q.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qp = torch.arange(lpad, device=q.device)[:, None]
    kp = torch.arange(lpad, device=q.device)[None, :]
    keep = kp <= qp
    if window is not None:
        keep &= kp > (qp - window)
    s.masked_fill_(~keep, NEG)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


@functools.cache
def _launcher():
    """The C entry point of ``csrc/flash_attention.cu``, built at first
    use (``kernels/_build.py``)."""
    fn = _build.load("flash_attention").flash_attention_bhld_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # q, k, v, o, bh, lpad, d, l_real, window, scale, is_bf16, stream
    fn.argtypes = [ptr] * 4 + [i32] * 5 + [ctypes.c_float, i32, ptr]
    fn.restype = i32
    return fn


def flash_attention_bhld(q, k, v, *, scale: float, window=None,
                         l_real: int | None = None) -> torch.Tensor:
    """q, k, v (BH, Lpad, D), batch and heads merged, KV expanded to the
    query heads; float32 or bfloat16, all three alike. Returns (BH, Lpad,
    D) in q's dtype; rows >= ``l_real`` (default Lpad) are unspecified.

    CPU tensors run the plain version. CUDA tensors launch K7 on the
    current stream without synchronising; it takes D in ``HEAD_DIMS``,
    contiguous 16-byte-aligned operands and ``l_real`` up to
    64 x 65 535, and raises ``ValueError`` on anything else."""
    who = "flash_attention_bhld"
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {q.device}")
    if window is not None and int(window) < 1:
        raise ValueError(f"{who}: window must be None or >= 1, got {window}")
    if q.device.type == "cpu":
        return flash_attention_bhld_ref(q, k, v, scale=scale, window=window,
                                        l_real=l_real)
    if q.dim() != 3:
        raise ValueError(f"{who}: q must be (BH, Lpad, D), got "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: the kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    bh, lpad, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{who}: the kernel takes head dim D in "
                         f"{HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(who, name, x, (bh, lpad, d), q.device, q.dtype)
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    l_real = lpad if l_real is None else int(l_real)
    if not 0 <= l_real <= min(lpad, 64 * _MAX_Q_BLOCKS):
        raise ValueError(f"{who}: l_real={l_real} outside [0, "
                         f"{min(lpad, 64 * _MAX_Q_BLOCKS)}]")
    out = torch.empty_like(q)
    if bh == 0 or l_real == 0:
        return out
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, lpad,
        d, l_real, int(window or 0), scale, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(who, err)
    flash_attention_bhld.launches += 1
    return out


flash_attention_bhld.launches = 0
