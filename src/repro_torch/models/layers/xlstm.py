"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) — the
port of ``repro.models.layers.xlstm``.

Both follow the Unfolded decomposition: every input-side projection
(q/k/v/z and the gate pre-activations from x) is computed for the whole
sequence as one GEMM outside the scan; the scan body carries only the
state recurrences.  For sLSTM the per-head recurrent product R h_{t-1}
stays inside (the true serial MVM, the paper's ``U·h`` half).

Stabilized exponential gating per the xLSTM paper (m_t running max; the
mLSTM state starts at m = -inf, as the reference's).

Which products run the ``mvm`` kernel on a decode step (``decode=True``,
``common.project``): mLSTM's w_up_v, w_up_g, w_q, w_k, w_v and w_down,
sLSTM's W and w_out — 6 and 2 launches a layer.  What stays
``torch.matmul``: mLSTM's fp32 gate pre-activations ``xv @ w_i + b_i``
and ``xv @ w_f + b_f``, and the sLSTM bias, which the reference adds
after ``x @ W`` is rounded to the model dtype (not mvm's fp32 bias
epilogue).  sLSTM's recurrent product is ``common.matmul_f32`` (fp32
result).  The reference has no Pallas kernel here; neither has the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree as tr
from repro_torch.models.layers.common import (matmul_f32, chunked_scan,
                                              cummax, dense_init,
                                              log_sigmoid,
                                              on_mesh, project, shard_act,
                                              split_last)

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, d: int, n_heads: int, dtype,
               device="cpu"):
    di = 2 * d
    f32 = torch.float32
    return {
        "w_up_v": dense_init(gen, (d, di), dtype, device=device),
        "w_up_g": dense_init(gen, (d, di), dtype, device=device),
        "w_q": dense_init(gen, (di, di), dtype, device=device),
        "w_k": dense_init(gen, (di, di), dtype, device=device),
        "w_v": dense_init(gen, (di, di), dtype, device=device),
        "w_i": dense_init(gen, (di, n_heads), f32, device=device),
        "w_f": dense_init(gen, (di, n_heads), f32, device=device),
        "b_i": torch.zeros((n_heads,), dtype=f32, device=device),
        "b_f": torch.full((n_heads,), 3.0, dtype=f32, device=device),
        "w_down": dense_init(gen, (di, d), dtype, device=device),
    }


def mlstm_inputs(params, x, n_heads: int, *, decode: bool = False):
    """Sequence-parallel half: all projections + gate pre-activations."""
    B, T, d = x.shape
    di = params["w_up_v"].shape[1]
    dh = di // n_heads
    xv = project(x, params["w_up_v"], decode=decode)
    xg = project(x, params["w_up_g"], decode=decode)
    q = split_last(project(xv, params["w_q"], decode=decode), n_heads, dh)
    # the reference divides by sqrt(dh) rounded to x's dtype
    scale = float(torch.tensor(float(dh)).sqrt().to(x.dtype))
    k = split_last(project(xv, params["w_k"], decode=decode), n_heads,
                   dh) / scale
    v = split_last(project(xv, params["w_v"], decode=decode), n_heads, dh)
    i_pre = torch.matmul(xv.float(), params["w_i"]) + params["b_i"]
    f_pre = torch.matmul(xv.float(), params["w_f"]) + params["b_f"]
    return q, k, v, i_pre, f_pre, xg


def mlstm_state_init(B: int, n_heads: int, dh: int, device="cpu"):
    f32 = torch.float32
    return {
        "C": torch.zeros((B, n_heads, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((B, n_heads, dh), dtype=f32, device=device),
        "m": torch.full((B, n_heads), float("-inf"), dtype=f32,
                        device=device),
    }


def mlstm_cell(state, q_t, k_t, v_t, i_pre, f_pre):
    """One recurrent step.  q/k/v_t (B,H,dh); i/f_pre (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    log_f = log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    f_sc = torch.exp(log_f + m - m_new)[..., None, None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    kf = k_t.float()
    vf = v_t.float()
    C = f_sc * C + (i_sc[..., None] * kf[..., :, None]) * vf[..., None, :]
    n = f_sc[..., 0] * n + i_sc * kf
    qf = q_t.float()
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, qf))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return {"C": C, "n": n, "m": m_new}, h


def _mlstm_out(params, hs, xg, x, *, decode: bool):
    """(hs * silu(xg)) @ w_down, hs (B, T, di) in x's dtype."""
    gate = F.silu(xg.float()).to(x.dtype)
    return project(hs * gate, params["w_down"], decode=decode)


def apply_mlstm(params, x, n_heads: int, state=None, *,
                decode: bool = False):
    """x (B,T,d) -> (y (B,T,d), state)."""
    B, T, d = x.shape
    di = params["w_up_v"].shape[1]
    dh = di // n_heads
    q, k, v, i_pre, f_pre, xg = mlstm_inputs(params, x, n_heads,
                                             decode=decode)
    if state is None:
        state = tr.tree_map(on_mesh, mlstm_state_init(B, n_heads, dh,
                                                      device=x.device))

    def step(st, inp):
        qt, kt, vt, it, ft = inp
        return mlstm_cell(st, qt, kt, vt, it, ft)

    xs = (q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
          i_pre.transpose(0, 1), f_pre.transpose(0, 1))
    state, hs = chunked_scan(step, state, xs)
    hs = hs.transpose(0, 1).reshape(B, T, di).to(x.dtype)  # (B,T,di)
    return _mlstm_out(params, hs, xg, x, decode=decode), state


def apply_mlstm_chunked(params, x, n_heads: int, state=None,
                        chunk: int = 128):
    """Exact chunkwise-parallel mLSTM (the Unfolded split at chunk level).

    Chunkwise, the (B,H,dk,dv) state is read and written once per chunk
    and the intra-chunk part becomes decay-masked attention:

      F_t   = cumsum(log f) within the chunk;  a_s = i_s - F_s
      M_t   = max(m0, cummax_s<=t a_s);        m_t = F_t + M_t
      D_ts  = exp(a_s - M_t) * [s <= t]
      num_t = e^{m0 - M_t} (q_t C0) + sum_s D_ts (q_t k_s) v_s
      n_t   = e^{m0 - M_t} n0      + sum_s D_ts k_s
      h_t   = num_t / max(|n_t q_t|, e^{-m_t})

    The same values as ``apply_mlstm`` up to fp32 summation order: the
    stabilizer recursion m_t = max(log f_t + m_{t-1}, i_t) unrolls to
    F_t + M_t.  Falls back to the recurrent scan when T % chunk != 0 or
    T <= chunk.  (A prefill: never a decode step, so no mvm here.)
    """
    B, T, d = x.shape
    di = params["w_up_v"].shape[1]
    dh = di // n_heads
    if T % chunk or T <= chunk:
        return apply_mlstm(params, x, n_heads, state)
    q, k, v, i_pre, f_pre, xg = mlstm_inputs(params, x, n_heads)
    if state is None:
        state = tr.tree_map(on_mesh, mlstm_state_init(B, n_heads, dh,
                                                      device=x.device))
    n_chunks = T // chunk

    def to_chunks(a):  # (B, T, H, ...) -> (n, B, H, L, ...)
        a = a.reshape((B, n_chunks, chunk) + tuple(a.shape[2:]))
        return a.movedim(3, 1).movedim(2, 0)

    xs = tuple(to_chunks(a) for a in (q, k, v, i_pre, f_pre))
    tri = on_mesh(torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                        device=x.device)))

    def chunk_step(st, inp):
        qt, kt, vt, it, ft = inp  # (B,H,L,dh) / (B,H,L)
        C0, n0, m0 = st["C"], st["n"], st["m"]
        qf = qt.float()
        kf = kt.float()
        vf = vt.float()
        log_f = log_sigmoid(ft)                             # (B,H,L)
        Fc = torch.cumsum(log_f, dim=-1)
        a = it - Fc                                         # (B,H,L)
        M = torch.maximum(m0[..., None],
                          cummax(a, 2))                     # (B,H,L)
        m_t = Fc + M
        inter = torch.exp(m0[..., None] - M)                # (B,H,L)
        D = torch.exp(a[:, :, None, :] - M[..., None]) * tri  # [t, s]
        s_qk = torch.einsum("bhtd,bhsd->bhts", qf, kf)
        num = (inter[..., None] * torch.einsum("bhtk,bhkv->bhtv", qf, C0)
               + torch.einsum("bhts,bhsv->bhtv", D * s_qk, vf))
        n_t = (inter[..., None] * n0[:, :, None, :]
               + torch.einsum("bhts,bhsk->bhtk", D, kf))
        den = torch.maximum(
            torch.abs(torch.einsum("bhtk,bhtk->bht", n_t, qf)),
            torch.exp(-m_t))
        h = num / den[..., None]                            # (B,H,L,dv)
        # chunk-end state
        w_end = torch.exp(a - M[..., -1:])                  # (B,H,L)
        C1 = (inter[..., -1, None, None] * C0
              + torch.einsum("bhs,bhsk,bhsv->bhkv", w_end, kf, vf))
        n1 = (inter[..., -1, None] * n0
              + torch.einsum("bhs,bhsk->bhk", w_end, kf))
        m1 = m_t[..., -1]
        return {"C": C1, "n": n1, "m": m1}, h

    state, hs = chunked_scan(chunk_step, state, xs)
    # hs (n, B, H, L, dv) -> (B, T, di)
    hs = hs.movedim(0, 2).reshape(B, n_heads, T, dh)
    hs = hs.movedim(1, 2).reshape(B, T, di).to(x.dtype)
    return _mlstm_out(params, hs, xg, x, decode=False), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, d: int, n_heads: int, dtype,
               device="cpu"):
    dh = d // n_heads
    return {
        "W": dense_init(gen, (d, 4 * d), dtype, device=device),
        # recurrent half; fan-in from shape[0] (n_heads), as the reference
        "R": dense_init(gen, (n_heads, dh, 4 * dh), dtype, device=device),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "w_out": dense_init(gen, (d, d), dtype, device=device),
    }


def slstm_state_init(B: int, d: int, device="cpu"):
    f32 = torch.float32
    return {
        "h": torch.zeros((B, d), dtype=f32, device=device),
        "c": torch.zeros((B, d), dtype=f32, device=device),
        "n": torch.ones((B, d), dtype=f32, device=device),
        "m": torch.zeros((B, d), dtype=f32, device=device),
    }


def slstm_cell(state, x_pre, R, n_heads: int):
    """x_pre (B, 4d) = x_t W + b (input half, precomputed).  R (H,dh,4dh)."""
    B = x_pre.shape[0]
    d = x_pre.shape[1] // 4
    dh = d // n_heads
    h_prev = split_last(state["h"], n_heads, dh)
    # einsum("bhd,hdk->bhk") with an fp32 result, one product per head
    rec = matmul_f32(h_prev.to(R.dtype).transpose(0, 1), R).transpose(0, 1)
    pre = split_last(x_pre.float(), n_heads, 4 * dh) + rec
    # the gate axis over 'model', as R's
    pre = shard_act(pre, "batch", None, "ff")
    # gate layout per head-block: (z, i, f, o), each dh wide
    pre4 = split_last(pre, 4, dh)
    z = torch.tanh(pre4[:, :, 0]).reshape(B, d)
    i_pre = pre4[:, :, 1].reshape(B, d)
    f_pre = pre4[:, :, 2].reshape(B, d)
    o = torch.sigmoid(pre4[:, :, 3]).reshape(B, d)
    log_f = log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    c = f_sc * state["c"] + i_sc * z
    n = f_sc * state["n"] + i_sc
    h = o * (c / torch.clamp_min(n, 1e-6))
    return {"h": h, "c": c, "n": n, "m": m_new}


def apply_slstm(params, x, n_heads: int, state=None, *,
                decode: bool = False):
    """x (B,T,d) -> (y (B,T,d), state)."""
    B, T, d = x.shape
    if state is None:
        state = tr.tree_map(on_mesh, slstm_state_init(B, d, device=x.device))
    # Unfolded: input half hoisted out of the scan (one GEMM for all t)
    x_pre = (project(x, params["W"], decode=decode)
             + params["b"].to(x.dtype))  # (B,T,4d)

    def step(st, xp):
        st = slstm_cell(st, xp, params["R"], n_heads)
        return st, st["h"]

    state, hs = chunked_scan(step, state, x_pre.transpose(0, 1))
    y = project(hs.transpose(0, 1).to(x.dtype), params["w_out"],
                decode=decode)
    return y, state


__all__ = ["init_mlstm", "mlstm_inputs", "mlstm_state_init", "mlstm_cell",
           "apply_mlstm", "apply_mlstm_chunked", "init_slstm",
           "slstm_state_init", "slstm_cell", "apply_slstm"]
