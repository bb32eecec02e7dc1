"""Plain PyTorch oracle for the RG-LRU recurrence scan (the port of
``repro.kernels.rglru.ref``).

The recurrence h = a·h + sqrt(max(1 − a², 0))·g with a = exp(log_a) is
ill-conditioned near a = 1: there 1 − a² cancels, and one ulp of a moves
sqrt(1 − a²) by many.  Two correct fp32 exps (PyTorch's and XLA's differ
by an ulp on about a tenth of inputs) put two scans up to 6e-6 apart at
the reference's test shapes.  So the port evaluates the step with the
floating-point operations XLA emits for the reference's compiled scan:

* ``xla_exp``: XLA's fp32 exp on the CPU — the Cephes polynomial, its
  range reduction and Horner steps as fused multiply-adds;
* a² as exp(2·la): XLA's algebraic simplifier rewrites exp(x)·exp(x) into
  exp(x + x) (2·la is exact);
* h = fma(a, h, s·g): XLA fuses the last multiply-add.

With them the port's scan stays within 2.4e-7 of the reference's, and
``csrc/rglru_scan.cu`` computes the same operations with ``fmaf``.

``rglru_scan_bwd_plain`` is the plain version of the scan's backward
(``csrc/rglru_scan_bwd.cu``): the derivative of the forward as the port
evaluates it, a² = exp(2·la) included (module doc of ``rglru_scan_bwd_plain``).
"""
from __future__ import annotations

import torch


def _f32(v: float) -> float:
    """``v`` rounded to fp32 (held as the Python float of that value)."""
    return torch.tensor(v, dtype=torch.float32).item()


# the Cephes exp constants, as fp32 (XLA's polynomial approximation)
_EXP_HI = _f32(88.3762626647950)
_EXP_LO = _f32(-88.3762626647949)
_LOG2E = _f32(1.44269504088896341)
_C1 = _f32(0.693359375)
_C2 = _f32(-2.12194440e-4)
_P = tuple(_f32(p) for p in (1.9875691500e-4, 1.3981999507e-3,
                             8.3334519073e-3, 4.1665795894e-2,
                             1.6666665459e-1, 5.0000001201e-1))


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else v


def fma(a, b, c):
    """a·b + c of fp32 tensors or fp32-valued floats, rounded once to fp32
    (the product of two fp32 values is exact in fp64, and the fp64 sum is
    rounded to fp32)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def xla_exp(x):
    """fp32 exp as XLA evaluates it on the CPU: n = floor(x·log2(e) + ½),
    r = x − n·C1 − n·C2, exp(r) by a degree-7 polynomial, times 2^n built
    from its exponent bits.  Bit-equal to XLA's wherever the result is a
    normal float (XLA flushes results below 2^-126 to zero)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma(x, _LOG2E, 0.5))
    r = fma(n, -_C1, x)
    r = fma(n, -_C2, r)
    z = r * r
    y = torch.full_like(r, _P[0])
    for p in _P[1:]:
        y = fma(y, r, p)
    y = fma(y, z, r) + 1.0
    return y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def rglru_step(la, g, h):
    """One step of the scan in fp32: a = exp(la), s = sqrt(max(1 − a², 0))
    with a² = exp(2·la), h = fma(a, h, s·g) — the reference's compiled scan
    (module doc)."""
    a = xla_exp(la)
    s = torch.sqrt(torch.clamp_min(1.0 - xla_exp(la + la), 0.0))
    return fma(a, h, s * g)


def rglru_scan_ref(log_a, gx, h0):
    """log_a, gx (B, T, W) fp32; h0 (B, W) fp32 -> (hs (B,T,W), h_T).

    A Python loop over T of ``rglru_step``."""
    h = h0
    hs = []
    for t in range(log_a.shape[1]):
        h = rglru_step(log_a[:, t], gx[:, t], h)
        hs.append(h)
    if not hs:
        return log_a.new_zeros(log_a.shape), h0
    return torch.stack(hs, dim=1), h


def rglru_coefficients_bwd(la, g):
    """The h-independent part of a backward step, each operation rounded
    on its own in fp32: a = exp(la) and a2 = exp(2·la) as the forward
    evaluates them (``xla_exp``, so the a_t here are bitwise the
    forward's), s = sqrt(max(1 − a2, 0)) and

        u = g · ds/dla,   ds/dla = −(a2 · sel) / s,

    the derivative of s = sqrt(max(1 − exp(2·la), 0)), where ``sel`` is
    ``maximum``'s selector as ``jax.grad`` takes it: 1 where 1 − a2 > 0,
    ½ where it is 0 and 0 below.  Returns (a, s, u)."""
    a = xla_exp(la)
    a2 = xla_exp(la + la)
    d = 1.0 - a2
    s = torch.sqrt(torch.clamp_min(d, 0.0))
    sel = torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0))
    return a, s, g * (-(a2 * sel) / s)


def rglru_scan_bwd_plain(log_a, gx, h0, hs, dhs, dhT):
    """The backward of ``rglru_scan_ref``: (dlog_a, dgx, dh0) from the
    forward's inputs, its hs and the cotangents dhs (B, T, W) of hs and
    dhT (B, W) of h_T; all fp32.

    With a_t, s_t and u_t = g_t · ds_t/dla_t (``rglru_coefficients_bwd``),
    h_{−1} = h0 and δ the cotangent of h_t:

        δ_{T−1} = dhs_{T−1} + dhT,  δ_t = fma(a_{t+1}, δ_{t+1}, dhs_t)
        dgx_t    = s_t · δ_t
        dlog_a_t = δ_t · fma(a_t, h_{t−1}, u_t)
        dh0      = a_0 · δ_0

    Everything but the chain over δ is parallel over T; the chain is one
    fma a step, walked here as a Python loop from T − 1 down.

    Where a rounds to 1 (1 − a2 = 0, so s = 0) ds/dla is −inf, and dlog_a
    is ±inf, or nan where g_t · δ_t = 0; below it (a > 1) nan.  ``jax.grad``
    of the reference's step gives inf and nan at the same places (the
    cotangent of sqrt at 0 is inf, and ``maximum``'s selector multiplies
    it).  The RG-LRU's la = 8·r·log σ(Λ) < 0 reaches a = 1 only where r
    underflows."""
    B, T, W = log_a.shape
    a, s, u = rglru_coefficients_bwd(log_a, gx)
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
    q = fma(a, h_prev, u)
    delta = torch.empty_like(dhs)
    d = fma(1.0, dhT, dhs[:, T - 1])  # dhs + dhT, rounded once
    delta[:, T - 1] = d
    for t in range(T - 2, -1, -1):
        d = fma(a[:, t + 1], d, dhs[:, t])
        delta[:, t] = d
    return delta * q, s * delta, a[:, 0] * delta[:, 0]
