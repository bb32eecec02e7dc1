"""Plain PyTorch oracles for the fused LSTM kernels (single step +
sequence): the reference rung of the guarded execution ladder, which
exists for CPU tensors only.  Unlike the
kernels, the sequence oracle carries h in its own dtype between steps (as
``repro.kernels.lstm_cell.ref`` does)."""
from __future__ import annotations

import torch


def lstm_cell_ref(U4, xw_t, h_prev, c_prev):
    """U4 (H, 4, H); xw_t (B, 4, H) precomputed input half (+bias);
    h_prev (B, H); c_prev (B, H) fp32.  Returns (h, c)."""
    H = U4.shape[0]
    gates = xw_t.float() + (h_prev.float() @ U4.reshape(H, 4 * H).float()
                            ).reshape(-1, 4, H)
    i = torch.sigmoid(gates[:, 0])
    f = torch.sigmoid(gates[:, 1])
    g = torch.tanh(gates[:, 2])
    o = torch.sigmoid(gates[:, 3])
    c = f * c_prev.float() + i * g
    h = o * torch.tanh(c)
    return h.to(h_prev.dtype), c


def lstm_seq_ref(U4, xw, h0, c0):
    """Loop-over-T oracle for the sequence-fused kernel.

    U4 (H,4,H) or (G,H,4,H); xw (B,T,4,H) or (G,B,T,4,H); h0/c0 (…B,H).
    Returns (hs (…B,T,H), h_T (…B,H), c_T (…B,H))."""
    if xw.ndim == 5:
        outs = [lstm_seq_ref(U4[g], xw[g], h0[g], c0[g])
                for g in range(xw.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    B, T, _, H = xw.shape
    h, c = h0, c0.float()
    hs = []
    for t in range(T):
        h, c = lstm_cell_ref(U4, xw[:, t], h, c)
        hs.append(h)
    hs = torch.stack(hs, dim=1) if hs else h0.new_zeros((B, 0, H))
    return hs, h, c
