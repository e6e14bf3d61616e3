"""Causal, optionally sliding-window, flash attention forward (K7).

The port of the JAX package's ``kernels/flash_attention.py``: per batch,
query head and row ``q < l_real``, the softmax of ``q k^T * scale`` over
the keys ``k <= q`` (and ``k > q - window`` with a window), times ``v``.
The hand-written kernel (``csrc/flash_attention.cu``) keeps the scores,
P and the accumulator on chip, so device-memory traffic is Q + K + V + O;
the plain PyTorch versions take the full float32 softmax with the same
masks. D = 256 (RecurrentGemma's local attention) runs a tiling of its
own inside the same kernel file: one consumer warpgroup, 64-key blocks.

Two entry points run the same kernel:

- ``flash_attention_blhd``: the model's layout, q (B, L, H, D) and k, v
  (B, L, KV, D) with KV dividing H, as the projections make them; query
  head h reads KV head h // (H // KV) in place (grouped-query attention
  with no expanded copy of K and V).
- ``flash_attention_bhld``: the reference's merged (B*H, Lpad, D) layout,
  KV already expanded, with rows >= ``l_real`` as padding.

Both run the plain version on CPU tensors only and launch the kernel on
CUDA tensors; there is no fallback: a failed build, a refused tensor map
or a refused launch raises. Every launch of K7, through either entry
point, adds one to ``flash_attention_bhld.launches``. Inference only, as
in the reference (no backward): with grad mode on and an operand that
requires grad, both entry points raise :class:`NoBackwardError` on every
device, the CPU's plain version included, before anything runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..errors import NoBackwardError
from . import _build

__all__ = ["HEAD_DIMS", "NEG", "flash_attention_bhld",
           "flash_attention_bhld_ref", "flash_attention_blhd",
           "flash_attention_blhd_ref"]

#: head dims the kernel takes (the smoke configs' 16, the full configs' 64
#: and 128, RecurrentGemma's 256)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: masked score, the reference's: finite, so no row meets inf - inf
NEG = -1e30


def _max_l(d: int) -> int:
    """The longest L the kernel takes: the float32 kernel's grid y of
    65 535 q tiles of 64 rows (32 at D = 256)."""
    return (64 if d <= 128 else 32) * 65535


def _causal_softmax_v(s, v, window):
    """softmax(s masked causally, and by the window) @ v in float32; s
    (..., Lq, Lk) already scaled, v (..., Lk, D)."""
    lq, lk = s.shape[-2:]
    qp = torch.arange(lq, device=s.device)[:, None]
    kp = torch.arange(lk, device=s.device)[None, :]
    keep = kp <= qp
    if window is not None:
        keep &= kp > (qp - window)
    s.masked_fill_(~keep, NEG)
    p = torch.softmax(s, dim=-1)
    del s
    return p @ v.float()


def flash_attention_bhld_ref(q, k, v, *, scale: float, window=None,
                             l_real: int | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention_bhld``: the full float32 softmax
    with the same masks (the reference's ``ops.flash_attention_ref`` on
    the merged layout). Rows >= ``l_real`` are computed as if they were
    real; the kernel leaves them unwritten."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return _causal_softmax_v(s, v, window).to(q.dtype)


def flash_attention_blhd_ref(q, k, v, *, scale: float,
                             window=None) -> torch.Tensor:
    """Plain version of ``flash_attention_blhd``: the full float32 softmax
    with the same masks, query head h against KV head h // (H // KV)."""
    group = q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    o = _causal_softmax_v(s, v.transpose(1, 2), window)
    return o.transpose(1, 2).to(q.dtype)


@functools.cache
def _launcher():
    """The C entry point of ``csrc/flash_attention.cu``, built at first
    use (``kernels/_build.py``)."""
    fn = _build.load("flash_attention").flash_attention_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # q, k, v, o, strides[12], batch, l_real, heads, kv, d, window, scale,
    # is_bf16, stream
    fn.argtypes = ([ptr] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [i32] * 6 + [ctypes.c_float, i32, ptr])
    fn.restype = i32
    return fn


def _refuse_grad(who, q, k, v) -> None:
    """Raise :class:`NoBackwardError` when autograd would record the call:
    the kernel writes a fresh tensor that carries no ``grad_fn``, so
    training through it would silently get no gradient for q, k or v."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, k, v)):
        raise NoBackwardError(
            f"{who}: the flash attention kernel (K7) has no backward, as "
            "the reference's Pallas kernel has none; it serves inference "
            "only (run it under torch.no_grad() or torch.inference_mode())"
            ". Train with attn_impl=\"jnp\"")


def _check(who, q, window):
    """The checks both entry points share -> True for a CPU tensor (run
    the plain version)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {q.device}")
    if window is not None and int(window) < 1:
        raise ValueError(f"{who}: window must be None or >= 1, got {window}")
    if q.device.type == "cpu":
        return True
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: the kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{who}: the kernel takes head dim D in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    return False


def _launch(who, q, k, v, out, strides, batch, l_real, heads, kv, window,
            scale):
    """Launch K7 on the current stream and count it."""
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 12)(*strides), batch, l_real, heads, kv,
        q.shape[-1], int(window or 0), scale,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(who, err)
    flash_attention_bhld.launches += 1


def flash_attention_bhld(q, k, v, *, scale: float, window=None,
                         l_real: int | None = None) -> torch.Tensor:
    """q, k, v (BH, Lpad, D), batch and heads merged, KV expanded to the
    query heads; float32 or bfloat16, all three alike. Returns (BH, Lpad,
    D) in q's dtype; rows >= ``l_real`` (default Lpad) are unspecified.

    CPU tensors run the plain version. CUDA tensors launch K7 on the
    current stream without synchronising (each of the BH rows a batch of
    one head); it takes D in ``HEAD_DIMS``, contiguous 16-byte-aligned
    operands and ``l_real`` up to 64 x 65 535 (32 x 65 535 at D = 256),
    and raises ``ValueError`` on anything else."""
    who = "flash_attention_bhld"
    _refuse_grad(who, q, k, v)
    if _check(who, q, window):
        return flash_attention_bhld_ref(q, k, v, scale=scale, window=window,
                                        l_real=l_real)
    if q.dim() != 3:
        raise ValueError(f"{who}: q must be (BH, Lpad, D), got "
                         f"{tuple(q.shape)}")
    bh, lpad, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(who, name, x, (bh, lpad, d), q.device, q.dtype)
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    l_real = lpad if l_real is None else int(l_real)
    if not 0 <= l_real <= min(lpad, _max_l(d)):
        raise ValueError(f"{who}: l_real={l_real} outside [0, "
                         f"{min(lpad, _max_l(d))}]")
    out = torch.empty_like(q)
    if bh == 0 or l_real == 0:
        return out
    # (batch, row, head) strides: one head per batch
    strides = (lpad * d, d, lpad * d) * 4
    _launch(who, q, k, v, out, strides, bh, l_real, 1, 1, window, scale)
    return out


def flash_attention_blhd(q, k, v, *, scale: float,
                         window=None) -> torch.Tensor:
    """q (B, L, H, D), k and v (B, L, KV, D) with KV dividing H; float32
    or bfloat16, all three alike. Returns o (B, L, H, D) in q's dtype,
    contiguous: query head h attends with KV head h // (H // KV).

    CPU tensors run the plain version. CUDA tensors launch K7 on the
    current stream without synchronising, reading each operand through
    its own strides (the last dimension contiguous, every other stride
    and the pointer 16-byte aligned); it takes D in ``HEAD_DIMS`` and L up
    to 64 x 65 535 (32 x 65 535 at D = 256), and raises ``ValueError`` on
    anything else."""
    who = "flash_attention_blhd"
    _refuse_grad(who, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{who}: q, k, v must be (B, L, heads, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, l, h, d = q.shape
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{who}: {kv} KV heads do not divide {h} query "
                         "heads")
    for name, x in (("k", k), ("v", v)):
        if tuple(x.shape) != (b, l, kv, d):
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                             f"expected {(b, l, kv, d)}")
    if _check(who, q, window):
        return flash_attention_blhd_ref(q, k, v, scale=scale, window=window)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{who}: {name} is on {x.device}, expected "
                             f"{q.device}")
        if x.dtype != q.dtype:
            want = str(q.dtype).removeprefix("torch.")
            raise ValueError(f"{who}: {name} must be {want}, got {x.dtype}")
        if x.stride(3) != 1 or any(
                x.stride(i) * x.element_size() % 16 for i in range(3)):
            raise ValueError(f"{who}: {name} needs a contiguous last "
                             "dimension and 16-byte strides, got strides "
                             f"{x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    if l > _max_l(d):
        raise ValueError(f"{who}: L={l} above {_max_l(d)}")
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1),
                                                  x.stride(2))]
    _launch(who, q, k, v, out, strides, b, l, h, kv, window, scale)
    return out


flash_attention_bhld.launches = 0
