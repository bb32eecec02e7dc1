"""Plain PyTorch oracles for the fused GRU kernels (single step +
sequence): the reference rung of the guarded execution ladder, which
exists for CPU tensors only.  Unlike the kernels, the sequence oracle
carries h in its own dtype between steps (as ``repro.kernels.gru_cell.ref``
does).  Gate order along the 3-axis: (z, r, n)."""
from __future__ import annotations

import torch


def gru_step_ref(U3, xw_t, h_prev):
    """U3 (H, 3, H); xw_t (B, 3, H) precomputed input half (+bias);
    h_prev (B, H).  Returns h in h_prev's dtype."""
    H = U3.shape[0]
    hu = (h_prev.float() @ U3.reshape(H, 3 * H).float()).reshape(-1, 3, H)
    xw32 = xw_t.float()
    z = torch.sigmoid(xw32[:, 0] + hu[:, 0])
    r = torch.sigmoid(xw32[:, 1] + hu[:, 1])
    n = torch.tanh(xw32[:, 2] + r * hu[:, 2])
    h = (1 - z) * n + z * h_prev.float()
    return h.to(h_prev.dtype)


def gru_seq_ref(U3, xw, h0):
    """Loop-over-T oracle for the sequence-fused GRU kernel.

    U3 (H,3,H) or (G,H,3,H); xw (B,T,3,H) or (G,B,T,3,H); h0 (…B,H).
    Returns (hs (…B,T,H), h_T (…B,H))."""
    if xw.ndim == 5:
        outs = [gru_seq_ref(U3[g], xw[g], h0[g]) for g in range(xw.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    B, T, _, H = xw.shape
    h = h0
    hs = []
    for t in range(T):
        h = gru_step_ref(U3, xw[:, t], h)
        hs.append(h)
    hs = torch.stack(hs, dim=1) if hs else h0.new_zeros((B, 0, H))
    return hs, h
