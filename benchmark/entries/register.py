"""The entry of a serving cell: closed-loop `serving.Registrar.register` calls,
numpy in and numpy out, on a pool of requests; call i takes request
i mod pool with the sampling seed `seed + i`. Every call's answers are
kept; the check draws a sample of the finished calls from the seed and
works each out again in the plain reference."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import check
from benchmark.entries.common import draw_weights, engine_config, param_shapes
from benchmark.reference import model as ref
from benchmark.traffic import generator

_KEYS = ("src_pts", "src_feat", "tgt_pts", "tgt_feat")


class Entry:
    span = "register"

    def __init__(self, ctx):
        self.ctx = ctx
        self.pairs_per_call = ctx.mix["batch"]

    def setup(self) -> None:
        from se3_equi_graph_registration_tpu_torch import serving
        from se3_equi_graph_registration_tpu_torch.train import engine

        ctx = self.ctx
        self.ecfg = engine_config(ctx.config, ctx.cell["engine"])
        shapes = param_shapes(engine.build_model(self.ecfg, head_mode="eval_fusion",
                                                 device="cpu"))
        self.p0 = draw_weights(shapes, ctx.seed, ctx.device)
        self.reg = serving.Registrar(self.p0, self.ecfg, head_mode="eval_fusion",
                                     device=ctx.device)
        ctx.mark("Registrar and weights")
        pool = generator.make_pool(ctx.mix, ctx.config["in_node_nf"], ctx.seed + 1, ctx.device)
        self.pool = [tuple(req[k].cpu().numpy() for k in _KEYS) for req in pool]
        del pool
        ctx.mark("pool")
        self.answers = {}
        for i in range(ctx.cell["warmup_calls"]):
            self.call(i)
        self.answers.clear()
        self.next = ctx.cell["warmup_calls"]

    def call_seed(self, i: int) -> int:
        return self.ctx.seed + i

    def call(self, i: int) -> None:
        with torch.profiler.record_function("register"):
            R, t, info = self.reg.register(*self.pool[i % len(self.pool)], seed=self.call_seed(i))
        self.answers[i] = (R, t, info["pose_covariance"], info["similarity_mean"])

    def counters(self) -> dict:
        from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
        return {"knn": dict(knn.knn_window.launches_by_source),
                "egcl": dict(egcl.egcl_layer.launches_by_variant)}

    def free(self) -> None:
        rng = np.random.default_rng(self.ctx.seed)
        done = sorted(self.answers)
        take = min(self.ctx.cell["check_calls"], len(done))
        self.sample = sorted(int(i) for i in rng.choice(done, take, replace=False))
        self.program = {i: self.answers[i] for i in self.sample}
        del self.reg, self.answers

    def reference(self, variant: str = "reference") -> dict:
        """{call: (R, t, cov, similarity mean)} of the sampled calls in the
        plain reference: 'reference' at the path's stated precision (bf16
        EGNN operands with float32 accumulation, a float32 head, a float64
        covariance), 'fp8' its control, every stage a step down (e4m3 EGNN
        operands, TF32 head operands, a float32 covariance)."""
        c = self.ctx.config
        m = ref.Model(c["n_layers"], c["top_k"], c["k"], c["loss_weights"])
        rnd = ref.rounder({"reference": "bf16", "fp8": "fp8"}[variant])
        out = {}
        with ref.matmul_precision(False):
            for i in self.sample:
                req = ref.sample_request(*self.pool[i % len(self.pool)], n=c["num_nodes"],
                                         seed=self.call_seed(i))
                batch = {k: torch.as_tensor(v, device=self.ctx.device) for k, v in req.items()}
                r = ref.register_forward(self.p0, m, batch, rnd, c["egnn_tile"], c["egnn_window"],
                                         control=variant == "fp8")
                out[i] = (r["R"].cpu().numpy(), r["t"].cpu().numpy(), r["cov"].cpu().numpy(),
                          float(r["similarity_mean"].mean()))
        return out

    def numbers(self, program: dict, reference: dict, detail: bool = False) -> dict:
        return check.register_numbers(program, reference)
