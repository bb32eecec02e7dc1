"""Public entry point of the Mamba-2 state-update kernel: ``ssm_update``
(one decode step of the selective state-space recurrence for every batch
row and head, the state written in place, ONE launch).

The device of the tensors decides how it runs: on the CPU the plain
PyTorch version (``ssm_update_plain``); on a CUDA device the hand-written
kernel (``csrc/ssm_update.cu``) or an error.  There is no fallback from
one to the other.  Like every kernel entry point it carries the ``calls``
and ``kernel_launches`` counters and its cost (``kernels.common.counted``,
``ssm_update_cost``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import (Cost, check_operands, check_shape,
                                        count_launch, counted, launched,
                                        nbytes, on_cuda, operand, tracing)
from repro_torch.kernels.ssm import kernel

#: the state widths the kernel takes (a lane holds d_state / 32 values)
D_STATES = (32, 64, 128, 256)


def _split(xbc, heads: int, head_dim: int, groups: int, d_state: int):
    """x (B, H, P), and B and C (B, H, N), each head its group's, of the
    conv's output rows xbc (B, H P + 2 G N), in fp32."""
    Bsz = xbc.shape[0]
    H, P, G, N = heads, head_dim, groups, d_state
    xbc = xbc.float()
    x = xbc[:, :H * P].reshape(Bsz, H, P)
    bm = xbc[:, H * P:H * P + G * N].reshape(Bsz, G, N)
    cm = xbc[:, H * P + G * N:H * P + 2 * G * N].reshape(Bsz, G, N)
    rep = H // G
    return (x, bm.repeat_interleave(rep, dim=1),
            cm.repeat_interleave(rep, dim=1))


def ssm_update_plain(state, xbc, dt, dt_bias, A, D, *, heads: int,
                     head_dim: int, groups: int, d_state: int):
    """What the kernel computes, in plain PyTorch, all in fp32: for every
    row b and head h (group g = h // (heads // groups)),
    delta = softplus(dt + dt_bias), S = S exp(delta A) + (delta x) ⊗ B,
    y = S C + D x.  ``state`` (B, H, P, N) fp32 is overwritten with the new
    state; returns y (B, H, P) fp32."""
    x, bm, cm = _split(xbc, heads, head_dim, groups, d_state)
    delta = F.softplus(dt.float() + dt_bias.float())           # (B, H)
    dA = torch.exp(delta * A.float())
    dx = delta[..., None] * x                                   # (B, H, P)
    new = (state * dA[..., None, None]
           + dx[..., None] * bm[:, :, None, :])
    y = (new * cm[:, :, None, :]).sum(-1) + D.float()[:, None] * x
    state.copy_(new)
    return y


def ssm_update_cost(state, xbc, dt, dt_bias, A, D, *, heads: int,
                    head_dim: int, groups: int, d_state: int) -> Cost:
    """One step at (B, H, P, N): y = S C, 2 B H P N FLOPs; the state read
    and written once, xbc, dt and the head parameters read and y (fp32)
    written once; softplus (an exp and a log1p) and exp(delta A) a head;
    the decay and the outer product, 3 operations a state, and delta x and
    D x, 3 a channel."""
    B = state.shape[0]
    n = state.numel()
    chans = B * heads * head_dim
    return Cost(flops=2 * n,
                bytes=2 * nbytes(state) + nbytes(xbc, dt, dt_bias, A, D)
                + 4 * chans,
                transcendentals=3 * B * heads,
                pointwise=3 * n + 3 * chans + 4 * B * heads)


def _out(state):
    """y, as ``ssm_update_cuda`` allocates it."""
    B, H, P, _ = state.shape
    return torch.empty((B, H, P), dtype=torch.float32, device=state.device)


def ssm_update_cuda(state, xbc, dt, dt_bias, A, D, *, heads: int,
                    head_dim: int, groups: int, d_state: int):
    """Launch ``csrc/ssm_update.cu`` on the current stream; shapes as
    ``ssm_update_plain``, xbc, dt and the head parameters fp32.  The state
    is written where it lies, so it must already be contiguous and
    16-byte aligned (no copy is taken of it)."""
    B = state.shape[0]
    H, P, G, N = heads, head_dim, groups, d_state
    dev = state.device
    check_operands("ssm_update", dev, state=state, xbc=xbc, dt=dt,
                   dt_bias=dt_bias, A=A, D=D)
    check_shape("ssm_update", "state", state, (B, H, P, N))
    check_shape("ssm_update", "dt", dt, (B, H))
    for arg, t in (("dt_bias", dt_bias), ("A", A), ("D", D)):
        check_shape("ssm_update", arg, t, (H,))
    if xbc.dim() != 2 or xbc.shape[0] != B or xbc.shape[1] < H * P + 2 * G * N:
        raise ValueError(f"ssm_update: xbc has shape {tuple(xbc.shape)}, "
                         f"expected ({B}, >= {H * P + 2 * G * N})")
    for arg, t in (("xbc", xbc), ("dt", dt), ("dt_bias", dt_bias), ("A", A),
                   ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_update: {arg} must be float32, got "
                            f"{t.dtype}")
    if state.dtype != torch.float32:
        raise TypeError(f"ssm_update: state must be float32, got "
                        f"{state.dtype}")
    if N not in D_STATES or H % G:
        raise ValueError(f"ssm_update: d_state {N} (allowed: "
                         f"{', '.join(map(str, D_STATES))}) with {H} heads "
                         f"in {G} groups")
    y = _out(state)
    launch = kernel.entry("ssm_update")
    with torch.cuda.device(dev):
        rc = launch(state.data_ptr(), xbc.data_ptr(), dt.data_ptr(),
                    dt_bias.data_ptr(), A.data_ptr(), D.data_ptr(),
                    y.data_ptr(), B, H, P, N, G, xbc.shape[1],
                    torch.cuda.current_stream(dev).cuda_stream)
    launched("ssm_update", rc)
    count_launch(ssm_update)
    return y


@counted(cost=ssm_update_cost)
def ssm_update(state, xbc, dt, dt_bias, A, D, *, heads: int, head_dim: int,
               groups: int, d_state: int):
    """One decode step of the Mamba-2 recurrence, the state updated in
    place: state (B, H, P, N) fp32; xbc (B, H P + 2 G N), the
    conv's output rows (x, then B and C of each group); dt (B, H) before
    its bias and softplus; dt_bias, A (= -exp(A_log)) and D (H,).  Returns
    y (B, H, P) fp32 (without the z gate).  The math:
    ``ssm_update_plain``."""
    ssm_update.calls += 1
    dims = dict(heads=heads, head_dim=head_dim, groups=groups,
                d_state=d_state)
    if tracing():
        return _out(state)
    if on_cuda("ssm_update", state.device):
        return ssm_update_cuda(state, operand(xbc.float()),
                               operand(dt.float()), operand(dt_bias.float()),
                               operand(A.float()), operand(D.float()), **dims)
    return ssm_update_plain(state, xbc, dt, dt_bias, A, D, **dims)


__all__ = ["ssm_update", "ssm_update_plain", "ssm_update_cuda",
           "ssm_update_cost", "D_STATES"]
