"""The entry of a training cell: the program's `engine.make_train_step` with
Adam, fed closed loop from a pool of batches in pinned host memory, each
step copying its batch to the device as a loader with pinned memory does.

Set-up builds one training state from the seed, drives it through its
first `check_steps` steps by the window's own call on distinct batches
(recording each loss, the first gradient from Adam's first moment, the
parameters after the first and after the last), warms up, and hands the same state to the
window. The check replays those steps in the plain reference.
"""
from __future__ import annotations

import torch

from benchmark import check
from benchmark.entries.common import draw_weights, engine_config, param_shapes
from benchmark.reference import model as ref
from benchmark.traffic import generator

ADAM_BETA1 = 0.9


class Entry:
    span = "step"

    def __init__(self, ctx):
        self.ctx = ctx
        self.pairs_per_call = ctx.mix["batch"]

    def setup(self) -> None:
        from se3_equi_graph_registration_tpu_torch.train import engine

        ctx = self.ctx
        self.ecfg = engine_config(ctx.config, ctx.cell["engine"])
        model = engine.build_model(self.ecfg, head_mode="train", device=ctx.device)
        self.p0 = draw_weights(param_shapes(model), ctx.seed, ctx.device)
        model.load_state_dict(self.p0)
        ctx.mark("model and weights")
        self.opt = engine.build_optimizer(model, self.ecfg, ctx.mix["steps_per_epoch"])
        self.state = engine.TrainState(model, self.opt)
        self.step = engine.make_train_step(model, self.opt, self.ecfg)
        pool = generator.make_pool(ctx.mix, ctx.config["in_node_nf"], ctx.seed + 1, ctx.device)
        # the pool in one pinned host buffer: one allocation, each batch a view of it
        flat = torch.empty(sum(v.numel() for b in pool for v in b.values()),
                           pin_memory=ctx.device.type == "cuda")
        self.pool, at = [], 0
        for b in pool:
            views = {}
            for k, v in b.items():
                views[k] = flat[at:at + v.numel()].view(v.shape)
                views[k].copy_(v)
                at += v.numel()
            self.pool.append(views)
        del pool
        ctx.mark("pool")
        self.model = model
        self.losses = []
        for i in range(ctx.cell["check_steps"]):
            losses = self.call(i)
            self.losses.append({k: float(v) for k, v in losses.items()})
            if i == 0:   # the gradient Adam took: its first moment is (1 − β1)·g
                self.grad = {n: self.opt.adam.state[p]["exp_avg"] / (1.0 - ADAM_BETA1)
                             for n, p in model.named_parameters() if p in self.opt.adam.state}
                self.p_first = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.p_after = {n: p.detach().clone() for n, p in model.named_parameters()}
        ctx.mark("first steps")
        self.next = ctx.cell["check_steps"]
        for _ in range(ctx.cell["warmup_calls"]):
            self.call(self.next)
            self.next += 1

    def call(self, i: int) -> dict:
        """One step on the pool's batch i: copy it to the device, step."""
        with torch.profiler.record_function("copy_batch"):
            batch = {k: v.to(self.ctx.device, non_blocking=True)
                     for k, v in self.pool[i % len(self.pool)].items()}
        with torch.profiler.record_function("step"):
            self.state, losses = self.step(self.state, batch)
        return losses

    def counters(self) -> dict:
        from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, egcl_backward, knn
        return {"knn": dict(knn.knn_window.launches_by_source),
                "egcl": dict(egcl.egcl_layer.launches_by_variant),
                "egcl_backward": dict(egcl_backward.egcl_backward.launches_by_variant)}

    def free(self) -> None:
        """Drop the program's state; keep what the check needs."""
        self.program = {"losses": self.losses, "grad": self.grad, "params1": self.p_first,
                        "params": self.p_after}
        del self.state, self.step, self.opt, self.model

    def _batches(self) -> list:
        return [{k: v.to(self.ctx.device) for k, v in self.pool[i].items()}
                for i in range(self.ctx.cell["check_steps"])]

    def reference(self, variant: str = "reference") -> dict:
        """The plain reference over the first steps' batches from the same
        weights: 'reference' (float32, TF32 off), 'tf32' (the control),
        'half' (the reference leaving out the second half of each batch),
        'float64' (the reference in float64: what float32's rounding costs
        either side)."""
        c = self.ctx.config
        m = ref.Model(c["n_layers"], c["top_k"], c["k"], c["loss_weights"])
        rows = list(range(self.ctx.mix["batch"] // 2)) if variant == "half" else None
        p0, batches = self.p0, self._batches()
        if variant == "float64":
            p0 = {k: v.double() for k, v in p0.items()}
            batches = [{k: v.double() for k, v in b.items()} for b in batches]
        with ref.matmul_precision(variant == "tf32"):
            return ref.train_steps(p0, m, batches, c["lr"], rows=rows)

    def numbers(self, program: dict, reference: dict, detail: bool = False) -> dict:
        return check.train_numbers(program, reference, self.p0, detail)
