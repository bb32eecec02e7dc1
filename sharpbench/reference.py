"""The plain reference: an LSTM stack in plain PyTorch, in fp32 by
default, with TF32 off.  It imports nothing of the program.

Equations (SHARP, Fig. 2; gates stacked (i, f, g, o) along the 4H axis
of W (X, 4H), U (H, 4H) and b (4H,)):

    z = x W + h U + b,   i, f, o = sigmoid(z_i, z_f, z_o),  g = tanh(z_g)
    c' = f c + i g,      h' = o tanh(c')

A bidirectional layer runs a second set of weights over each sequence
reversed within its own length and concatenates the two outputs, forward
first, on the feature axis; the next layer reads both (2H).

The reference is handed the weights the benchmark drew (bf16 values) and
computes in ``dtype`` from them.  Sequences are padded on the right: a
step past a row's length never feeds an earlier one, so padding changes
nothing that is compared.
"""
from __future__ import annotations

import torch


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _layer(half, xs, dtype, state=None):
    """One direction of one layer over xs (B, T, X); ``state`` (h, c) or
    zeros.  Returns (ys (B, T, H), (h, c) after the last step)."""
    W, U, b = (half[k].to(dtype) for k in ("W", "U", "b"))
    B, T, _ = xs.shape
    H = U.shape[0]
    xw = (xs.reshape(B * T, -1).to(dtype) @ W + b).reshape(B, T, 4, H)
    if state is None:
        h = xs.new_zeros((B, H), dtype=dtype)
        c = xs.new_zeros((B, H), dtype=dtype)
    else:
        h, c = (s.to(dtype) for s in state)
    ys = xs.new_empty((B, T, H), dtype=dtype)
    for t in range(T):
        z = xw[:, t] + (h @ U).reshape(B, 4, H)
        i, f, o = torch.sigmoid(z[:, (0, 1, 3)]).unbind(1)
        c = f * c + i * torch.tanh(z[:, 2])
        h = o * torch.tanh(c)
        ys[:, t] = h
    return ys, (h, c)


def _reverse(xs, lengths):
    """Each row of xs (B, T, ...) reversed within its first lengths[b]
    steps; the padding stays where it is."""
    T = xs.shape[1]
    idx = torch.arange(T, device=xs.device)[None, :].expand(xs.shape[0], T)
    lens = torch.as_tensor(lengths, device=xs.device)[:, None]
    src = torch.where(idx < lens, lens - 1 - idx, idx)
    return torch.gather(xs, 1, src[..., None].expand_as(xs))


def _cast(layers, dtype):
    """Every weight in ``dtype``, once."""
    return [{k: (_cast([v], dtype)[0] if isinstance(v, dict)
                 else v.to(dtype)) for k, v in layer.items()}
            for layer in layers]


@torch.no_grad()
def stack(layers, xs, lengths=None, dtype=torch.float32):
    """The stack's top-layer outputs over padded xs (B, T, X):
    (B, T, H * directions)."""
    _no_tf32()
    layers = _cast(layers, dtype)
    if lengths is None:
        lengths = [xs.shape[1]] * xs.shape[0]
    y = xs.to(dtype)
    for layer in layers:
        if "fwd" in layer:
            f, _ = _layer(layer["fwd"], y, dtype)
            r, _ = _layer(layer["bwd"], _reverse(y, lengths), dtype)
            y = torch.cat([f, _reverse(r, lengths)], dim=-1)
        else:
            y, _ = _layer(layer, y, dtype)
    return y


@torch.no_grad()
def feedback(layers, prompt, n_new: int, dtype=torch.float32):
    """Free-running decode of a unidirectional stack whose input and
    hidden widths agree: the prompt (B, T, X), then ``n_new`` steps, each
    fed the previous step's top-layer output.  Returns (prompt outputs
    (B, T, H), generated (B, n_new, H))."""
    _no_tf32()
    layers = _cast(layers, dtype)
    states, y = [], prompt.to(dtype)
    for layer in layers:
        y, st = _layer(layer, y, dtype)
        states.append(st)
    out, x, gen = y, y[:, -1:], []
    for _ in range(n_new):
        for k, layer in enumerate(layers):
            x, states[k] = _layer(layer, x, dtype, states[k])
        gen.append(x)
    return out, torch.cat(gen, dim=1)
