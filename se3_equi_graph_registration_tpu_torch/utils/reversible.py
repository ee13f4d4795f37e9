"""Reversible (RevNet-style) residual sequences (counterpart of
`utils/reversible.py`).

Each block couples two streams additively,

    y1 = x1 + f(x2);  y2 = x2 + g(y1),   inverse: x2 = y2 − g(y1);  x1 = y1 − f(x2),

and is one `torch.autograd.Function` that saves only its outputs: f and g
run without a graph in the forward, and the backward rebuilds the block's
input x2 from its outputs, then takes the vector-Jacobian products of g at
y1 and of f at x2. None of f's and g's inner activations is kept between
the forward and the backward (the vendored library's ReversibleBlock and
`_ReversibleFunction`; a memory-scaling tool for deep stacks that neither
package's train path uses).

f and g are `nn.Module`s. A Function sees only the tensors passed to it, so
their parameters are explicit inputs of each block: otherwise their
gradients would come back as None and nothing would say so.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class _ReversibleBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f: nn.Module, g: nn.Module, n_f: int, x1: torch.Tensor,
                x2: torch.Tensor, *params: torch.Tensor):
        y1 = x1 + f(x2)
        y2 = x2 + g(y1)
        ctx.f, ctx.g, ctx.n_f = f, g, n_f
        ctx.save_for_backward(y1, y2)        # the outputs only
        return y1, y2

    @staticmethod
    def backward(ctx, dy1: torch.Tensor, dy2: torch.Tensor):
        y1, y2 = ctx.saved_tensors
        params = ctx.needs_input_grad[5:]
        pf = list(ctx.f.parameters())
        pg = list(ctx.g.parameters())
        with torch.enable_grad():
            y1_ = y1.detach().requires_grad_(True)
            gy = ctx.g(y1_)
            live_g = [p for p, need in zip(pg, params[ctx.n_f:]) if need]
            grads_g = torch.autograd.grad(gy, [y1_] + live_g, dy2, allow_unused=True)
            dy1 = dy1 + grads_g[0]
            x2 = (y2 - gy).detach().requires_grad_(True)     # the coupling's inverse
            fx = ctx.f(x2)
            live_f = [p for p, need in zip(pf, params[:ctx.n_f]) if need]
            grads_f = torch.autograd.grad(fx, [x2] + live_f, dy1, allow_unused=True)
        dx2 = dy2 + grads_f[0]
        it_f, it_g = iter(grads_f[1:]), iter(grads_g[1:])
        dpf = [next(it_f) if need else None for need in params[:ctx.n_f]]
        dpg = [next(it_g) if need else None for need in params[ctx.n_f:]]
        return (None, None, None, dy1, dx2, *dpf, *dpg)


def reversible_sequence(fs: Sequence[nn.Module], gs: Sequence[nn.Module],
                        x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run len(fs) reversible blocks (f_i, g_i) over the streams (x1, x2);
    each block keeps only its outputs for the backward, which rebuilds its
    inputs from them."""
    if len(fs) != len(gs):
        raise ValueError(f"{len(fs)} f blocks against {len(gs)} g blocks")
    for f, g in zip(fs, gs):
        pf, pg = list(f.parameters()), list(g.parameters())
        x1, x2 = _ReversibleBlock.apply(f, g, len(pf), x1, x2, *pf, *pg)
    return x1, x2


@torch.no_grad()
def invert_sequence(fs: Sequence[nn.Module], gs: Sequence[nn.Module],
                    y1: torch.Tensor, y2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact inverse of `reversible_sequence`: the streams' inputs from
    its outputs."""
    for f, g in zip(reversed(fs), reversed(gs)):
        y2 = y2 - g(y1)
        y1 = y1 - f(y2)
    return y1, y2
