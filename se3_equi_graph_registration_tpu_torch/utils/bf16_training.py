"""bf16 parameter training with stochastic rounding (counterpart of
`utils/bf16_training.py`).

The live parameters are bf16. The optimizer wrapper keeps an fp32 master
copy of each, runs the inner optimizer (Adam in the engine) on the masters
with the fp32 value of each live gradient, and writes the stochastically
rounded master back into the live parameter. Stochastic rounding (SR) is
unbiased: an update far below half a bf16 ulp still moves the master
exactly and the live weight in expectation, where round-to-nearest would
freeze it.

The contract, as the JAX package states it:
- the masters are fp32 and do not depend on the SR draws;
- live is within one bf16 ulp of its master after every step. The JAX
  wrapper returns bf16 deltas against the old live values (its optax
  contract), so its live values may sit one ulp from SR(master); here
  live = SR(master) exactly, which is inside that contract;
- the draws come from an explicit `torch.Generator` on the masters'
  device. They are not `jax.random`'s draws, so two runs of the two
  packages agree in the masters, not in the live bits.

The forward of a bf16 model computes in fp32 from the bf16 values
(`fp32_parameters`), as flax's Dense promotes bf16 weights with fp32
inputs; autograd rounds each parameter's gradient to bf16 through the cast,
as `jax.grad` of a bf16 parameter does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, Optional

import torch


def stochastic_round_to_bf16(x: torch.Tensor,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """SR of `x` to bfloat16: P(round up) is x's fractional position between
    its two neighbouring bf16 values, so E[SR(x)] = x. The fp32 bits, as
    int32, get a uniform 16-bit draw added and their low 16 bits cleared;
    the result is exactly a bf16 value, so the final cast is exact (a cast
    of the unmasked value would round to nearest: a bias). A carry into the
    exponent is SR's right answer at a binade edge, and the largest finite
    magnitudes carry into ±inf; no finite input overflows int32. NaN and
    ±inf take no draw and cast as they are."""
    x = x.to(torch.float32)
    bits = x.view(torch.int32)
    noise = torch.randint(0, 65536, x.shape, generator=generator, device=x.device,
                          dtype=torch.int32)
    rounded = torch.where(torch.isfinite(x), (bits + noise) & -65536, bits)
    return rounded.view(torch.float32).to(torch.bfloat16)


def tree_stochastic_round(tree: Any, generator: Optional[torch.Generator] = None) -> Any:
    """SR of every floating tensor in a nest of dicts, lists and tuples;
    integer tensors and other leaves come back as they are."""
    if isinstance(tree, torch.Tensor):
        return stochastic_round_to_bf16(tree, generator) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: tree_stochastic_round(v, generator) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_stochastic_round(v, generator) for v in tree)
    return tree


@contextlib.contextmanager
def fp32_parameters(module: torch.nn.Module):
    """Inside the block, each bf16 parameter of `module` reads as its fp32
    cast (made once, on entry, and recorded by autograd when it is on), so
    the forward computes in fp32 from the bf16 values and its gradients
    reach the bf16 leaves through the casts. A backward that recomputes
    (`torch.utils.checkpoint`) must run inside the block too. The
    parameters come back on exit; with no bf16 parameter (an fp32 model, or
    a nested block) nothing changes."""
    swapped = []
    for mod in module.modules():
        for name, p in mod._parameters.items():
            if p is not None and p.dtype == torch.bfloat16:
                swapped.append((mod, name, p))
    for mod, name, p in swapped:
        mod._parameters[name] = p.to(torch.float32)
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


class Bf16SROptimizer:
    """fp32 masters and SR-to-bf16 live parameters around an inner torch
    optimizer.

    Construction copies the masters from `params` as they are (the fp32
    initialization) and then casts the live parameters to bf16, rounding
    to nearest, as the JAX engine's `init_state` initializes the optimizer
    before its cast. `make_inner(masters)` builds the inner optimizer over
    the masters; schedules attach to `inner`.

    After a backward, `accumulate()` moves each live gradient, in fp32,
    into its master's `.grad` (summing micro-batches) and clears the live
    one; `step()` accumulates, steps the inner optimizer and writes
    SR(master) into every live parameter. A micro-step that only
    accumulates leaves live parameters and masters untouched."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 make_inner: Callable[[list], torch.optim.Optimizer],
                 generator: Optional[torch.Generator] = None):
        self.live = list(params)
        self.master = [p.detach().to(torch.float32).clone() for p in self.live]
        self.inner = make_inner(self.master)
        dev = self.master[0].device
        self.generator = (generator if generator is not None
                          else torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            for p in self.live:
                p.data = p.data.to(torch.bfloat16)

    def accumulate(self) -> None:
        for p, m in zip(self.live, self.master):
            if p.grad is not None:
                g = p.grad.to(torch.float32)
                m.grad = g if m.grad is None else m.grad.add_(g)
                p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.accumulate()
        self.inner.step()
        for p, m in zip(self.live, self.master):
            p.copy_(stochastic_round_to_bf16(m, self.generator))

    def zero_grad(self) -> None:
        for p in self.live:
            p.grad = None
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The inner optimizer's state, the masters and the SR generator's
        state: what a restored run needs to continue bit for bit."""
        return {"inner": self.inner.state_dict(),
                "master": [m.detach().clone() for m in self.master],
                "generator": self.generator.get_state()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        for m, v in zip(self.master, state["master"], strict=True):
            m.copy_(v)
        self.generator.set_state(state["generator"].cpu())
