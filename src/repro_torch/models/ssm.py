"""xLSTM blocks: chunkwise-parallel mLSTM + sequential sLSTM (arXiv:2405.04517).

The port of the JAX package's ``models/ssm.py``. mLSTM (matrix memory,
no hidden-state feedback into the gates) runs chunkwise: within a chunk
every position is computed with dense products (the intra-chunk decay
matrix), and a loop over the chunks carries the (C, n, m) state.
Exponential gating is stabilised in log space; the running max ``m``
starts at -1e30 (never -inf) and keeps everything finite.

sLSTM has recurrent gate connections (the gates read h_{t-1}), so it
runs token by token. Under grad mode both loops keep the reference's
training checkpoints, which change what the backward pass keeps and not
the numbers: ``mlstm_cell`` checkpoints groups of ``ckpt_group`` chunks
(only the group boundaries' matrix states are kept), ``slstm_block``
chunks of ``time_chunk`` tokens.

Each block is also given in the parts a mesh's ``model`` slots run on
their pieces, with collectives between them (``models/parallel.py``):
``mlstm_proj`` (partial sums of q, k, v and the gates on a slot),
``mlstm_run`` (the cell; split over ``dv`` it needs only the slot's v
and ``C``) and ``mlstm_out``; ``slstm_scan`` (the token scan over the
gathered gate pre-activations). ``mlstm_block`` and ``slstm_block`` are
the parts on one slot.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from .layers import rms_norm
from .params import Spec

__all__ = ["mlstm_specs", "slstm_specs", "mlstm_block", "slstm_block",
           "mlstm_cell", "mlstm_cell_ref", "mlstm_decode_step",
           "slstm_decode_step", "init_mlstm_state", "init_slstm_state", "UP",
           "mlstm_proj", "mlstm_run", "mlstm_out", "slstm_scan"]

UP = 2  # mLSTM up-projection factor
NEG = -1e30


# ---------------------------------------------------------------------- #
# parameter specs
# ---------------------------------------------------------------------- #
def mlstm_specs(layers: int, d: int, heads: int) -> dict:
    du = UP * d
    return {
        "w_up": Spec((layers, d, du), ("layers", "embed", "state")),
        "w_gate": Spec((layers, d, du), ("layers", "embed", "state")),
        "wq": Spec((layers, du, du), ("layers", "state", "state")),
        "wk": Spec((layers, du, du), ("layers", "state", "state")),
        "wv": Spec((layers, du, du), ("layers", "state", "state")),
        "w_if": Spec((layers, du, 2 * heads), ("layers", "state", None)),
        "b_if": Spec((layers, 2 * heads), ("layers", None), init="zeros"),
        "w_down": Spec((layers, du, d), ("layers", "state", "embed")),
        "norm_in": Spec((layers, d), ("layers", "embed"), init="ones"),
        "norm_h": Spec((layers, du), ("layers", "state"), init="ones"),
    }


def slstm_specs(layers: int, d: int, heads: int) -> dict:
    hd = d // heads
    return {
        "w_gates": Spec((layers, d, 4 * d), ("layers", "embed", "state")),
        "r_gates": Spec((layers, heads, hd, 4 * hd),
                        ("layers", None, None, None)),
        "b_gates": Spec((layers, 4 * d), ("layers", "state"), init="zeros"),
        "w_out": Spec((layers, d, d), ("layers", "embed", "embed")),
        "norm_in": Spec((layers, d), ("layers", "embed"), init="ones"),
        "norm_h": Spec((layers, d), ("layers", "embed"), init="ones"),
    }


# ---------------------------------------------------------------------- #
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------- #
def init_mlstm_state(batch: int, heads: int, dk: int, dv: int,
                     device=None) -> dict:
    """Fresh state, float32, on ``device`` (default: the first CUDA
    device); the stabiliser ``m`` at -1e30."""
    dev = resolve_device(device)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, heads, dk, dv), dtype=f32, device=dev),
        "n": torch.zeros((batch, heads, dk), dtype=f32, device=dev),
        "m": torch.full((batch, heads), NEG, dtype=f32, device=dev),
    }


def _mlstm_chunk(state, q, k, v, it, ft):
    """One chunk. q, k, v (B, K, H, d*); it, ft (B, K, H) raw gate
    pre-activations -> (state, h (B, K, H, dv))."""
    B, K, H, dk = q.shape
    lf = F.logsigmoid(ft.float())                         # (B, K, H)
    Fc = torch.cumsum(lf, dim=1)                          # inclusive
    itf = it.float()
    a = itf - Fc                                          # i_t - F_t
    m_in, C_in, n_in = state["m"], state["C"], state["n"]
    run_max = torch.cummax(a, dim=1).values
    m = Fc + torch.maximum(m_in[:, None], run_max)        # stabiliser
    # intra-chunk decay matrix W[j, tau] = exp(F_j - F_tau + i_tau - m_j)
    expo = (Fc[:, :, None] - Fc[:, None, :] + itf[:, None, :]
            - m[:, :, None])                              # (B, K, K, H)
    causal = torch.ones((K, K), dtype=torch.bool, device=q.device).tril()
    W = torch.where(causal[None, :, :, None], torch.exp(expo), 0.0)
    qf = q.float() * (dk ** -0.5)
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bjhd,bthd->bjth", qf, kf) * W  # (B, K, K, H)
    num_intra = torch.einsum("bjth,bthv->bjhv", scores, vf)
    # inter-chunk (state) contribution
    inter_w = torch.exp(Fc + m_in[:, None] - m)           # (B, K, H)
    num_inter = torch.einsum("bjhd,bhdv->bjhv", qf, C_in) * inter_w[..., None]
    den_inter = torch.einsum("bjhd,bhd->bjh", qf, n_in) * inter_w
    num = num_intra + num_inter                           # (B, K, H, dv)
    den = torch.einsum("bjth,bthd->bjhd", W, kf)
    den_dot = torch.einsum("bjhd,bjhd->bjh", qf, den) + den_inter
    h = num / torch.maximum(den_dot.abs(), torch.exp(-m))[..., None]
    # carry update (exponents relative to m_out = m at the last position)
    F_tot = Fc[:, -1][:, None]                            # (B, 1, H)
    m_out = m[:, -1]
    w_state = torch.exp(F_tot - Fc + itf - m_out[:, None])
    decay = torch.exp(F_tot[:, 0] + m_in - m_out)
    C_out = decay[..., None, None] * C_in + torch.einsum(
        "bth,bthd,bthv->bhdv", w_state, kf, vf)
    n_out = decay[..., None] * n_in + torch.einsum("bth,bthd->bhd",
                                                   w_state, kf)
    return {"C": C_out, "n": n_out, "m": m_out}, h


def _mlstm_chunks(state, q, k, v, it, ft, chunk: int):
    """Consecutive chunks of ``chunk`` tokens -> (state, h)."""
    hs = []
    for c in range(0, q.shape[1], chunk):
        sl = slice(c, c + chunk)
        state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                it[:, sl], ft[:, sl])
        hs.append(h)
    return state, torch.cat(hs, dim=1)


def mlstm_cell(q, k, v, it, ft, state, chunk: int, ckpt_group: int = 4):
    """q, k, v (B, L, H, d*); it/ft (B, L, H) -> (h (B, L, H, dv), state).

    Chunks of ``chunk`` tokens in turn; when ``chunk`` does not divide L
    the whole length is one chunk (the reference's rule), whose decay
    matrix is then (B, L, L, H). Under grad mode, when ``ckpt_group``
    divides the chunk count and is below it, each group of ``ckpt_group``
    chunks runs under a checkpoint, as in the reference."""
    L = q.shape[1]
    chunk = min(chunk, L)
    if L % chunk:
        chunk = L
    n_chunks = L // chunk
    if not (torch.is_grad_enabled() and n_chunks % ckpt_group == 0
            and n_chunks > ckpt_group):
        state, h = _mlstm_chunks(state, q, k, v, it, ft, chunk)
        return h, state
    span = chunk * ckpt_group
    hs = []
    for g in range(0, L, span):
        sl = slice(g, g + span)
        state, h = checkpoint(_mlstm_chunks, state, q[:, sl], k[:, sl],
                              v[:, sl], it[:, sl], ft[:, sl], chunk,
                              use_reentrant=False)
        hs.append(h)
    return torch.cat(hs, dim=1), state


def _mlstm_token(st, qt, kt, vt, i_t, f_t):
    """One token: q, k, v (B, H, d*), gates (B, H) -> (state, h)."""
    dk = qt.shape[-1]
    lf = F.logsigmoid(f_t.float())
    m_new = torch.maximum(lf + st["m"], i_t.float())
    fh = torch.exp(lf + st["m"] - m_new)
    ih = torch.exp(i_t.float() - m_new)
    kf, vf = kt.float(), vt.float()
    C = fh[..., None, None] * st["C"] + ih[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = fh[..., None] * st["n"] + ih[..., None] * kf
    qf = qt.float() * (dk ** -0.5)
    num = torch.einsum("bhd,bhdv->bhv", qf, C)
    den = torch.einsum("bhd,bhd->bh", qf, n).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return {"C": C, "n": n, "m": m_new}, h


def mlstm_cell_ref(q, k, v, it, ft, state):
    """Per-token sequential oracle (float32) -> (h (B, L, H, dv), state)."""
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_token(state, q[:, t], k[:, t], v[:, t], it[:, t],
                                ft[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_decode_step(q, k, v, it, ft, state):
    """Single-token step: q, k, v (B, 1, H, d). Returns (state, h (B, 1, H,
    dv)): the opposite order to the other cells, as in the reference."""
    h, st = mlstm_cell_ref(q, k, v, it, ft, state)
    return st, h


# ---------------------------------------------------------------------- #
# blocks
# ---------------------------------------------------------------------- #
def mlstm_proj(p, xn):
    """xn (B, L, d) -> (xu (B, L, c), q, k, v (B, L, du), the gates
    (B, L, 2H) before ``b_if``), c the columns of ``p``'s ``w_up``; on a
    slot holding c of du rows of ``wq``/``wk``/``wv``/``w_if``, q, k, v
    and the gates are its partial sums."""
    xu = xn @ p["w_up"]                                   # (B, L, c)
    return xu, xu @ p["wq"], xu @ p["wk"], xu @ p["wv"], xu @ p["w_if"]


def mlstm_run(q, k, v, it, ft, state, chunk: int):
    """The cell over q, k (B, L, H, dk), v (B, L, H, dv) and the gates
    from ``state``: one token as the decode step, else chunkwise ->
    (h (B, L, H, dv), state). Each dv column reads only its own columns
    of v and ``C``, so a slot may run it on its piece of dv."""
    if q.shape[1] == 1:
        state, h = mlstm_decode_step(q, k, v, it, ft, state)
        return h, state
    return mlstm_cell(q, k, v, it, ft, state, chunk)


def mlstm_out(p, xn, h):
    """The normed cell output h (B, L, c) gated and projected down: the
    whole output, or a slot's partial over its c rows of ``w_down``."""
    return (h * F.silu(xn @ p["w_gate"])) @ p["w_down"]


def mlstm_block(p, x, heads: int, eps: float, chunk: int, state=None):
    xn = rms_norm(x, p["norm_in"], eps)
    xu, q, k, v, gif = mlstm_proj(p, xn)
    B, L, du = xu.shape
    hd = du // heads
    q, k, v = (t.reshape(B, L, heads, hd) for t in (q, k, v))
    gif = gif + p["b_if"]                                 # (B, L, 2H)
    if state is None:
        state = init_mlstm_state(B, heads, hd, hd, device=x.device)
    h, state = mlstm_run(q, k, v, gif[..., :heads], gif[..., heads:],
                         state, chunk)
    h = rms_norm(h.reshape(B, L, du).to(x.dtype), p["norm_h"], eps)
    return x + mlstm_out(p, xn, h), state


def init_slstm_state(batch: int, d: int, device=None) -> dict:
    """Fresh state, float32, on ``device`` (default: the first CUDA
    device); the stabiliser ``m`` at -1e30."""
    dev = resolve_device(device)
    zeros = [torch.zeros((batch, d), dtype=torch.float32, device=dev)
             for _ in range(3)]
    return {"c": zeros[0], "n": zeros[1], "h": zeros[2],
            "m": torch.full((batch, d), NEG, dtype=torch.float32,
                            device=dev)}


def _slstm_step(p, heads, st, gx_t):
    """gx_t (B, 4d) input gate pre-activations; the recurrent term (the
    float32 h against the weights, promoted as jnp promotes) is added
    here."""
    B, d4 = gx_t.shape
    d = d4 // 4
    hd = d // heads
    hprev = st["h"].reshape(B, heads, hd)
    rec = torch.einsum("bhd,hdk->bhk", hprev,
                       p["r_gates"].float()).reshape(B, 4 * d)
    g = (gx_t + rec).float()
    zt, it, ft, ot = g.chunk(4, dim=-1)
    z = torch.tanh(zt)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + st["m"], it)
    fh = torch.exp(lf + st["m"] - m_new)
    ih = torch.exp(it - m_new)
    c = fh * st["c"] + ih * z
    n = fh * st["n"] + ih
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_steps(p, heads, state, gx):
    """The tokens of ``gx`` (B, T, 4d) in turn -> (state, h (B, T, d))."""
    hs = []
    for t in range(gx.shape[1]):
        state = _slstm_step(p, heads, state, gx[:, t])
        hs.append(state["h"])
    return state, torch.stack(hs, dim=1)


def slstm_scan(p, heads: int, gx, state, time_chunk: int = 256):
    """The token scan over the gate pre-activations gx (B, L, 4d) from
    ``state`` -> (state, h (B, L, d) float32). Under grad mode, when
    ``time_chunk`` divides L and is below it, each chunk of
    ``time_chunk`` tokens runs under a checkpoint (only the chunk
    boundaries' states are kept), as in the reference."""
    L = gx.shape[1]
    if torch.is_grad_enabled() and L % time_chunk == 0 and L > time_chunk:
        hs = []
        for c in range(0, L, time_chunk):
            state, h = checkpoint(_slstm_steps, p, heads, state,
                                  gx[:, c:c + time_chunk],
                                  use_reentrant=False)
            hs.append(h)
        return state, torch.cat(hs, dim=1)
    return _slstm_steps(p, heads, state, gx)


def slstm_block(p, x, heads: int, eps: float, state=None,
                time_chunk: int = 256):
    """sLSTM layer: x (B, L, d) -> (x + out, state), token by token
    (``slstm_scan``)."""
    B, L, d = x.shape
    xn = rms_norm(x, p["norm_in"], eps)
    gx = xn @ p["w_gates"] + p["b_gates"]                 # (B, L, 4d)
    if state is None:
        state = init_slstm_state(B, d, device=x.device)
    state, h = slstm_scan(p, heads, gx, state, time_chunk)
    h = rms_norm(h.to(x.dtype), p["norm_h"], eps)         # (B, L, d)
    return x + h @ p["w_out"], state


def slstm_decode_step(p, x, heads: int, eps: float, state):
    return slstm_block(p, x, heads, eps, state)
