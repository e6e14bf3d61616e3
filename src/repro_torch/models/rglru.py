"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of the JAX package's ``models/rglru.py``. The recurrence is
diagonal with input-dependent decay:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
inside the Griffin layout: a GeLU gate branch beside x (linear -> causal
conv1d -> RG-LRU), then a down-projection. The gates and the recurrence
run in float32, as in the reference.

The reference's ``jax.lax.associative_scan`` over time becomes a
log-depth doubling scan (``_rglru_scan``): ceil(log2 L) elementwise steps
over the whole (B, L, C) block, so a 4 096-token prefill is 12 steps, not
4 096. It groups the products differently from the reference's scan, so
the two agree to float32 rounding, not bit for bit.

The block is two halves, so that a mesh's ``model`` slots can run it on
their channels (``models/parallel.py``): ``rglru_in`` (the gate and conv
branches, and the gates' products, on a slot a partial sum over its rows
of ``w_a``/``w_i``, reduce-scattered onto its channels) and
``rglru_mix`` (the gates, the scan and the slot's partial
down-projection, then all-reduced). ``rglru_block`` is both on one slot.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .layers import rms_norm
from .params import Spec

__all__ = ["rglru_specs", "rglru_block", "rglru_in", "rglru_mix",
           "rglru_decode_step", "init_rglru_state", "C_SCALE"]

C_SCALE = 8.0


def rglru_specs(layers: int, d: int, d_rnn: int, conv_w: int) -> dict:
    return {
        "w_gate": Spec((layers, d, d_rnn), ("layers", "embed", "state")),
        "w_x": Spec((layers, d, d_rnn), ("layers", "embed", "state")),
        "conv_k": Spec((layers, conv_w, d_rnn), ("layers", None, "state"),
                       init="normal", scale=0.5),
        "conv_b": Spec((layers, d_rnn), ("layers", "state"), init="zeros"),
        "w_a": Spec((layers, d_rnn, d_rnn), ("layers", "state", "state")),
        "b_a": Spec((layers, d_rnn), ("layers", "state"), init="zeros"),
        "w_i": Spec((layers, d_rnn, d_rnn), ("layers", "state", "state")),
        "b_i": Spec((layers, d_rnn), ("layers", "state"), init="zeros"),
        "lam": Spec((layers, d_rnn), ("layers", "state"), init="ones"),
        "w_down": Spec((layers, d_rnn, d), ("layers", "state", "embed")),
        "norm_in": Spec((layers, d), ("layers", "embed"), init="ones"),
    }


def init_rglru_state(batch: int, d_rnn: int, conv_w: int,
                     device=None) -> dict:
    """Zero state, float32, on ``device`` (default: the first CUDA
    device)."""
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, conv_w - 1, d_rnn), dtype=torch.float32,
                            device=dev),
    }


def _causal_conv(x, kernel, bias, history=None):
    """Depthwise causal conv1d. x (B, L, C); kernel (W, C) ->
    (out (B, L, C), the last W - 1 inputs as the next call's history)."""
    w = kernel.shape[0]
    if history is None:
        pad = x.new_zeros((x.shape[0], w - 1, x.shape[2]))
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, L+W-1, C)
    out = sum(xp[:, i:i + x.shape[1], :] * kernel[i] for i in range(w))
    new_hist = xp[:, -(w - 1):, :] if w > 1 else pad[:, :0]
    return out + bias, new_hist


def _rglru_scan(xc, a_log):
    """Scan of h_t = a_t h_{t-1} + b_t over axis 1 from h_{-1} = 0 ->
    (h, the running products of a). Doubling: after the step of offset
    s, element t holds the combination of elements t - 2s + 1 .. t."""
    a = torch.exp(a_log)                                 # (B, L, C)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * a_log), min=1e-12)) * xc
    s = 1
    while s < a.shape[1]:
        # (a1, b1) earlier, (a2, b2) later: (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                               b[:, :-s])], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b, a


def rglru_in(p, xn, state=None):
    """The normed input xn (B, L, d) -> (gate (B, L, c), conv output
    float32 (B, L, c), the conv history for the next call, and the
    gates' products ``xc @ w_a`` and ``xc @ w_i``, float32 (B, L, dr)),
    c the channels of ``p``'s columns (a slot's piece, or all dr)."""
    # jax.nn.gelu's default is the tanh approximation, not torch's erf
    gate = F.gelu(xn @ p["w_gate"], approximate="tanh")   # (B, L, c)
    xr = xn @ p["w_x"]
    hist = state["conv"] if state is not None else None
    xc, new_hist = _causal_conv(xr, p["conv_k"], p["conv_b"], hist)
    xcf = xc.float()
    return (gate, xcf, new_hist, xcf @ p["w_a"].float(),
            xcf @ p["w_i"].float())


def rglru_mix(p, x, gate, xcf, ra, ri, state=None):
    """The gates from their products ``ra``, ``ri`` (B, L, c), the scan
    from ``state``'s h (else zeros), and the down-projection of the
    gated output -> (out (B, L, d) in x's dtype, the last h float32)."""
    B, L = x.shape[:2]
    r = torch.sigmoid(ra + p["b_a"].float())
    i = torch.sigmoid(ri + p["b_i"].float())
    a_log = -C_SCALE * F.softplus(p["lam"].float()) * r
    xin = i * xcf
    if state is not None and L == 1:
        # one token: the reference's direct step, no scan
        a = torch.exp(a_log[:, 0])
        h = a * state["h"] + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)
                                        ) * xin[:, 0]
        hs = h[:, None, :]
        new_h = h
    else:
        h0 = (state["h"] if state is not None else
              xcf.new_zeros((B, xcf.shape[-1])))
        # the initial state folds in through the running products of a
        hs, aa = _rglru_scan(xin, a_log)
        hs = hs + aa * h0[:, None, :]
        new_h = hs[:, -1]
    return (gate * hs.to(x.dtype)) @ p["w_down"], new_h


def rglru_block(p, x, conv_w: int, eps: float, state=None):
    """x (B, L, d) -> (x + out, state {h, conv} in float32)."""
    gate, xcf, hist, ra, ri = rglru_in(p, rms_norm(x, p["norm_in"], eps),
                                       state)
    out, new_h = rglru_mix(p, x, gate, xcf, ra, ri, state)
    return x + out, {"h": new_h, "conv": hist.float()}


def rglru_decode_step(p, x, conv_w: int, eps: float, state):
    return rglru_block(p, x, conv_w, eps, state)
