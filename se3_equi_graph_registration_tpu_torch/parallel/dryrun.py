"""Multi-rank dry run (counterpart of `__graft_entry__.dryrun_multichip`): the
sharded paths of `parallel/` against their unsharded twins, at the JAX dry
run's sizes and tolerances.

    python -m se3_equi_graph_registration_tpu_torch.parallel.dryrun --ranks 4
    python -m se3_equi_graph_registration_tpu_torch.parallel.dryrun --ranks 4 --device cpu

spawns N ranks on 127.0.0.1: NCCL, one card each (it raises when there are
fewer cards, it never falls back to the CPU), or gloo on the CPU with
`--device cpu`. Every rank runs `checks`, which holds

- one data-parallel train step over {data: N} against the unsharded step
  on the whole batch: loss < 1e-4, the gradients Adam applies (summed over
  the mesh) within 1e-5 of each tensor's largest, parameters after the step
  < 5e-4 (above 2·lr, since Adam's first step is ~lr·sign(m) and a sign
  flip of a cancelling gradient moves a weight by up to 2·lr; only the
  gradients see a wrong scale or a lost share);
- at even N >= 4, the 2-axis step over {data: 2, point: N/2} in both
  regimes: the all-gather regime against the unsharded step, the halo
  regime (W = min(8, L)) against its twin (sort → the same halo graph →
  plain EGNN → un-sort → head → loss → Adam), same tolerances;
- the point-sharded and the halo EGNN forwards over {point: N} against the
  unsharded EGNN on the same graph (< 5e-4);
- a Registrar and `register_fpfh_batch` over {data: N} against the calls
  without a mesh (< 5e-4);

and rank 0 prints one line of the measured deltas.
"""
from __future__ import annotations

import argparse
import os
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import registration, serving
from ..data.synthetic import make_pair_batch
from ..models.egnn import EGNN
from ..ops import morton
from ..train import checkpoints, engine
from ..train import losses as losses_lib
from .distributed import init_distributed
from .mesh import (all_gather_rows, all_reduce_sum, gather_pairs, make_mesh, shard_pair_batch,
                   shard_points_batch)
from .point_sharding import (halo_sharded_egnn_forward, halo_sharded_knn,
                             halo_sharded_knn_batched, make_point_sharded_train_step,
                             sharded_egnn_forward, sharded_knn)

LOSS_TOL, PARAM_TOL, FORWARD_TOL, GRAD_TOL = 1e-4, 5e-4, 5e-4, 1e-5


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun: {what}")


def _max_param_delta(a: torch.nn.Module, b: torch.nn.Module) -> float:
    sa, sb = a.state_dict(), b.state_dict()
    return max(float((sa[k].double() - sb[k].double()).abs().max()) for k in sa)


def update_grads(state) -> dict:
    """A dict that the next Adam step of `state` fills, just before it
    updates, with the gradients it applies by parameter name (summed over
    the mesh and averaged over the micro-steps by then; zeros for a
    parameter with none)."""
    names = {id(p): name for name, p in state.model.named_parameters()}
    got = {}

    def hook(opt, args, kwargs):
        handle.remove()
        for group in opt.param_groups:
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                got[names[id(p)]] = g.detach().double().cpu()

    handle = state.optimizer.adam.register_step_pre_hook(hook)
    return got


def grad_gap(got: dict, want: dict) -> float:
    """The largest, over the parameters, of max|got - want| / max|want|
    (inf unless both hold every parameter)."""
    if not want or got.keys() != want.keys():
        return float("inf")
    return max(float((got[k] - want[k]).abs().max() / max(float(want[k].abs().max()), 1e-30))
               for k in want)


def _max_delta(*pairs) -> float:
    return max(float((torch.as_tensor(p).double() - torch.as_tensor(q).double()).abs().max())
               for p, q in pairs)


def checks(device: torch.device) -> str:
    """Every check, on each rank of the initialized process group (its
    world is N); returns the line of deltas (the same on every rank)."""
    n_ranks = dist.get_world_size()
    cfg = engine.EngineConfig(num_nodes=64, k=8, in_node_nf=16, hidden_nf=32, top_k=16)
    pb = make_pair_batch(np.random.default_rng(0), batch=2 * n_ranks, n=cfg.num_nodes,
                         feat_dim=cfg.in_node_nf)
    batch = engine.batch_to_device(tuple(pb), device)

    def fresh():
        return engine.init_state(cfg, torch.Generator().manual_seed(0), device=device)

    def held(name, loss, want_loss, grads, want_grads, model, want_model):
        """Gate one step against its twin; its part of the deltas line."""
        loss_d, grad_d = abs(loss - want_loss), grad_gap(grads, want_grads)
        param_d = _max_param_delta(want_model, model)
        _require(loss_d < LOSS_TOL and grad_d < GRAD_TOL and param_d < PARAM_TOL,
                 f"{name} loss, gradient, parameter delta {loss_d} {grad_d} {param_d}")
        return f"{name} loss|grad|param delta {loss_d:.2e}|{grad_d:.2e}|{param_d:.2e}"

    # --- data-parallel train step over the 'data' axis ---
    mesh = make_mesh({"data": n_ranks}, device)
    state = fresh()
    grads = update_grads(state)
    _, metrics = engine.make_train_step(state.model, state.optimizer, cfg, mesh)(
        state, shard_pair_batch(batch, mesh))
    total = float(all_reduce_sum(metrics["total"], mesh))
    _require(np.isfinite(total), f"DP loss {total}")
    ref = fresh()
    ref_grads = update_grads(ref)
    _, m_ref = engine.make_train_step(ref.model, ref.optimizer, cfg)(ref, batch)
    deltas = [held("DP", total, float(m_ref["total"]), grads, ref_grads, state.model,
                   ref.model)]

    # --- 2-axis (data x point) train step, all-gather and halo regimes ---
    if n_ranks % 2 == 0 and n_ranks >= 4:
        mesh2 = make_mesh({"data": 2, "point": n_ranks // 2}, device)
        slab = cfg.num_nodes // (n_ranks // 2)
        for halo in [None] + ([min(8, slab)] if slab >= 2 else []):
            st2 = fresh()
            grads2 = update_grads(st2)
            step2 = make_point_sharded_train_step(st2.model, st2.optimizer, cfg, mesh2, halo=halo)
            _, m2 = step2(st2, shard_points_batch(batch, mesh2))
            loss2 = float(all_reduce_sum(m2["total"], mesh2))
            _require(np.isfinite(loss2), f"2-axis loss {loss2} (halo {halo})")
            if halo is None:
                deltas.append(held("2-axis", loss2, float(m_ref["total"]), grads2, ref_grads,
                                   st2.model, ref.model))
            else:
                st_t = fresh()
                twin_grads = update_grads(st_t)
                twin = halo_twin(st_t, cfg, batch, mesh2, halo)
                deltas.append(held("halo-train", loss2, twin["total"], grads2, twin_grads,
                                   st2.model, st_t.model))

    # --- point-sharded EGNN forward, all-gather and halo exchange ---
    pmesh = make_mesh({"point": n_ranks}, device)
    n_pts, k, c = 32 * n_ranks, 8, 16
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((n_pts, 3)), dtype=torch.float32).to(device)
    h = torch.as_tensor(rng.standard_normal((n_pts, c)), dtype=torch.float32).to(device)
    egnn = EGNN(in_node_nf=c).to(device)
    checkpoints.init_weights(egnn, torch.Generator().manual_seed(0))
    L, i = n_pts // n_ranks, pmesh.axis_index("point")
    rows = slice(i * L, (i + 1) * L)

    def whole(a):
        return all_gather_rows(a, pmesh, "point")

    def plain(h, x, nbr):
        return [a[0] for a in egnn(h[None], x[None], nbr[None])]

    with torch.no_grad():
        nbr = sharded_knn(x, k, pmesh)
        h2, x2 = sharded_egnn_forward(egnn, h[rows], x[rows], nbr, pmesh)
        h_ref, x_ref = plain(h, x, whole(nbr))
        sp_delta = _max_delta((whole(h2), h_ref), (whole(x2), x_ref))
        W = 16
        perm = morton.morton_perm(x)
        xs, hs = x[perm], h[perm]
        nbr_h = halo_sharded_knn(xs[rows], k, pmesh, W)
        h3, x3 = halo_sharded_egnn_forward(egnn, hs[rows], xs[rows], nbr_h, pmesh, W)
        h3_ref, x3_ref = plain(hs, xs, whole(nbr_h))
        halo_delta = _max_delta((whole(h3), h3_ref), (whole(x3), x3_ref))
    _require(sp_delta < FORWARD_TOL, f"point-forward delta {sp_delta}")
    _require(halo_delta < FORWARD_TOL, f"halo-forward delta {halo_delta}")
    deltas += [f"point-forward delta {sp_delta:.2e}", f"halo-forward delta {halo_delta:.2e}"]

    # --- data-parallel serving and register_fpfh_batch over the same mesh ---
    params = fresh().model.state_dict()
    rng_s = np.random.default_rng(2)
    sp = rng_s.standard_normal((3, cfg.num_nodes, 3)).astype(np.float32)
    sf = rng_s.standard_normal((3, cfg.num_nodes, cfg.in_node_nf)).astype(np.float32)
    R1, t1, _ = serving.Registrar(params, cfg, head_mode="train", device=device).register(
        sp, sf, sp + 0.05, sf)
    RN, tN, _ = serving.Registrar(params, cfg, head_mode="train", device=device,
                                  mesh=mesh).register(sp, sf, sp + 0.05, sf)
    serve_delta = _max_delta((RN, R1), (tN, t1))
    _require(serve_delta < FORWARD_TOL, f"mesh-serving delta {serve_delta}")
    g_src = rng_s.uniform(-1, 1, (n_ranks, 128, 3)).astype(np.float32)
    g_src[..., 2] = 0.3 * np.sin(2 * g_src[..., 0]) * np.cos(2 * g_src[..., 1])
    shift = np.float32([0.05, 0.02, -0.03])
    g_tgt = g_src + shift
    g_kw = dict(icp_iters=3, hypotheses=64, top_m=64, k_normals=12, k_fpfh=20, device=device)
    Rg1, tg1, _ = registration.register_fpfh_batch(g_src, g_tgt, **g_kw)
    RgN, tgN, _ = registration.register_fpfh_batch(g_src, g_tgt, mesh=mesh, **g_kw)
    greg_delta = _max_delta((RgN, Rg1), (tgN, tg1))
    _require(greg_delta < FORWARD_TOL, f"mesh-global-reg delta {greg_delta}")
    _require(float(np.abs(tg1 - shift).max()) < 5e-3, f"global-reg translation {tg1}")
    deltas += [f"mesh-serving delta {serve_delta:.2e}", f"mesh-global-reg delta {greg_delta:.2e}"]
    return (f"dryrun({n_ranks}): DP train step total={total:.4f}; 2-axis (data x point) "
            f"train step + point-sharded EGNN (all-gather AND halo-exchange) ok; measured "
            f"agreement vs unsharded twins: {'; '.join(deltas)}")


def halo_twin(state, cfg, batch, mesh2, halo):
    """One unsharded step that replicates the halo regime's computation:
    each cloud sorted along the curve, the halo graph the sharded builder
    gives (gathered whole), the plain EGNN, un-sorted, the head, the loss,
    Adam, on `state`. Returns {loss name: float}."""
    model = state.model

    def graph(x):
        _, xs, _ = morton.sort_by_curve(x[..., :1], x, cfg.curve)
        block = shard_points_batch({"x": xs}, mesh2)["x"]
        with torch.no_grad():
            nbr = halo_sharded_knn_batched(block, cfg.k, mesh2, halo)
            nbr = all_gather_rows(nbr, mesh2, "point")
            return gather_pairs(nbr, mesh2)

    graphs = {side: graph(batch[f"{side}_pts"]) for side in ("src", "tgt")}

    def embed(side):
        hs, xs, perm = morton.sort_by_curve(batch[f"{side}_feat"], batch[f"{side}_pts"],
                                            cfg.curve)
        return morton.unsort_rows(model.egnn(hs, xs, graphs[side]), perm)

    def loss(b):
        h_s, x_s = embed("src")
        h_t, x_t = embed("tgt")
        out = model.head_from_embeddings(b["src_feat"], b["tgt_feat"], b["src_pts"],
                                         b["tgt_pts"], h_s, x_s, h_t, x_t, b["labels"])
        lb = losses_lib.total_loss(out, b["gt_pose"], b["labels"], cfg.loss_weights)
        return lb.total, lb

    _, m = engine.train_step_from_loss(model, state.optimizer, cfg, loss)(state, batch)
    return {key: float(v) for key, v in m.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n_ranks: int, port: int, device_type: str) -> None:
    """One rank (a torch.multiprocessing target)."""
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(f"127.0.0.1:{port}", n_ranks, rank, device=device_type, timeout_s=300.0)
    try:
        device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
                  else torch.device("cpu"))
        line = checks(device)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True, help="processes to spawn")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, one card a rank (default); cpu: gloo")
    args = ap.parse_args(argv)
    if args.ranks < 1:
        raise SystemExit("--ranks must be >= 1")
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"--ranks {args.ranks} needs {args.ranks} CUDA cards, have "
                           f"{torch.cuda.device_count()}; pass --device cpu for gloo ranks")
    import torch.multiprocessing as tmp

    t0 = time.perf_counter()
    tmp.spawn(_rank_main, args=(args.ranks, _free_port(), args.device), nprocs=args.ranks,
              join=True)
    print(f"dryrun: {args.ranks} ranks ({'nccl' if args.device == 'cuda' else 'gloo'}) in "
          f"{time.perf_counter() - t0:.1f} s (host clock, start-up included)", flush=True)


if __name__ == "__main__":
    main()
