"""Serving API (counterpart of `serving.py`): a warm registration callable
and a micro-batching front end.

    reg = Registrar.from_checkpoint("checkpoint-3dmatch.pth", robust=True)
    R, t, info = reg.register(src_pts, src_feat, tgt_pts, tgt_feat)

- numpy in, numpy out; single pairs [N, ·] or batches [B, N, ·];
- inputs are sampled down or padded to `cfg.num_nodes` (`fit_to_count`);
- the robust stages after the head, each where its count is > 0: spectral
  reweighting, IRLS, ICP (single-scale, or over `cfg.icp_voxels`);
- `info` carries the per-request similarity mean and a 6x6 Gauss-Newton pose
  covariance (ops/kabsch.py), after ICP against each posed source point's
  nearest target point;
- `clique_prefilter=True` labels the correspondences of the exact maximum
  clique of their rigid-consistency graph as the inliers (native/max_clique.py,
  on the host) before the model runs;
- `register_raw` takes two raw clouds: FPFH-33 on the device, nearest-
  descriptor matches, then `register()` (a 33-feature model, the kitti
  preset's);
- `export_compiled` writes the forward as a `torch.export` artifact with the
  weights as an input; `load_exported` loads it;
- `from_checkpoint` loads a reference `.pth` or a `TrainCheckpointer`
  directory; a reference `.pth` computes what the reference computed with
  it in `direction='cluster'` (its torch_cluster edge orientation);
- every model variant of the engine serves: 'cluster', 'invariant' (on the
  plain EGNN over the k-NN kernel's graph), the PointNet encoder, and the
  weights of a `bf16_params` run (held in fp32, where bf16 values are
  exact, so the Registrar computes what the bf16 model computes);
- `BatchingServer` coalesces concurrent register() calls into one dispatch;
- `mesh` (parallel/mesh.py) spreads the pairs of a call over the mesh's
  'data' axis: every rank calls with the same requests, runs its data
  rows, and gets the whole batch's results; the ranks of a 'point' axis
  run their row's pairs alike (the JAX package's P('data') on a 2-axis
  mesh).

Runs on the CUDA card unless `device="cpu"` is passed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping, Optional, Union

import numpy as np
import torch

from .data.sampling import fit_to_count
from .ops import fpfh as fpfh_lib
from .ops.kabsch import pose_covariance
from .ops.kernels import load_program
from .ops.kernels.egcl import kernel_params
from .ops.kernels.knn import knn_window
from .ops.numerics import fp32_matmuls
from .parallel.mesh import (all_reduce_min, broadcast_, check_mesh, gather_pairs, pad_pairs,
                            shard_pair_batch)
from .registration import _export_device, _save_export, match_features
from .train import engine
from .train.checkpoints import TrainCheckpointer, convert_reference_checkpoint
from .utils.timer import span

# register() calls and the bytes they copied host to device, over the process
counters = {"calls": 0, "bytes_in": 0}


class Registrar:
    def __init__(self, params: Mapping[str, torch.Tensor], cfg: engine.EngineConfig,
                 head_mode: str = "eval_fusion",
                 device: Union[str, torch.device, None] = None,
                 refine_iters: Optional[int] = None, refine_kernel: Optional[str] = None,
                 spectral_topm: Optional[int] = None, icp_iters: Optional[int] = None,
                 mesh=None):
        """`params`: the model's state_dict (e.g. `params_from_jax(...)` or
        `convert_reference_checkpoint(...)`). The four robust knobs default
        to the config's fields; a value given here overrides the config's
        (`self.stages` is the config with the overrides applied). `mesh`: a
        data-parallel `parallel.mesh.Mesh`; the weights are rank 0's on
        every rank (broadcast here)."""
        given = dict(refine_iters=refine_iters, refine_kernel=refine_kernel,
                     spectral_topm=spectral_topm, icp_iters=icp_iters)
        self.stages = dataclasses.replace(
            cfg, **{k: v for k, v in given.items() if v is not None})
        if self.stages.icp_iters > 0 and cfg.icp_voxels and cfg.icp_voxels[-1]:
            raise ValueError(
                "cfg.icp_voxels must end at 0.0 (raw clouds): the final ICP weights pair "
                f"with the raw source points for the pose covariance; got {cfg.icp_voxels}")
        self.cfg = cfg
        self.model = engine.build_model(cfg, head_mode=head_mode, device=device)
        self.model.load_state_dict(params)
        self.device = next(self.model.parameters()).device
        self.mesh = mesh
        if mesh is not None:
            check_mesh(mesh, self.device)
            broadcast_(list(self.model.state_dict().values()), mesh)
        self._kp = None                              # the plain EGNN needs none
        if engine._fused_egnn(cfg):
            with torch.no_grad():                    # the weights never change
                self._kp = kernel_params(self.model.egnn)

    @classmethod
    def from_checkpoint(cls, path: str, fast: bool = True, num_nodes: int = 2048,
                        head_mode: str = "eval_fusion", robust: bool = False,
                        device: Union[str, torch.device, None] = None,
                        **cfg_overrides) -> "Registrar":
        """A Registrar on `device` (the CUDA card unless told otherwise) with
        the weights at `path`: a reference `.pth` (`convert_reference_checkpoint`)
        or a `TrainCheckpointer` directory (its latest step). The config is
        `robust_eval_config` when `robust`, else `fast_tpu_config` or, with
        fast=False, `EngineConfig`, at `num_nodes` and `cfg_overrides`.
        Loading is strict: a missing or unexpected weight raises."""
        if robust:
            base = engine.robust_eval_config
        else:
            base = engine.fast_tpu_config if fast else engine.EngineConfig
        cfg = base(num_nodes=num_nodes, **cfg_overrides)
        if path.endswith(".pth"):
            params = convert_reference_checkpoint(path, n_layers=cfg.n_layers,
                                                  num_heads=cfg.num_heads, hidden=cfg.hidden_nf)
        else:
            template = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
            restored = TrainCheckpointer(path).restore_latest(template)
            if restored is None:
                raise FileNotFoundError(f"no checkpoint under {path}")
            params = restored[0].model.state_dict()
        return cls(params, cfg, head_mode, device=device)

    def _forward(self, batch: dict, kp) -> tuple[torch.Tensor, ...]:
        """(R [B,3,3], t [B,3], similarity mean [B], covariance [B,6,6]): the
        head, the robust stages and the covariance, with the kernels' weight
        layout `kp` (None: built from the model's weights where the path
        needs it)."""
        out = engine._apply_with_graphs(self.model, self.cfg, batch, kp)
        src = batch["src_pts"]
        R, t, w, cov_tgt = engine.robust_pose(self.stages, src, batch["tgt_pts"], out.R,
                                              out.t, out.weights, icp_prior=True)
        with span("forward.covariance"), fp32_matmuls():
            cov = pose_covariance(src, cov_tgt, R, t, w)
        return R, t, out.similarity.mean(-1), cov

    @torch.no_grad()
    def _apply(self, batch: dict) -> torch.Tensor:
        """[B, 49] = R (9) | t (3) | similarity mean (1) | covariance (36),
        for one device-to-host copy per request."""
        R, t, sim, cov = self._forward(batch, self._kp)
        b = R.shape[0]
        return torch.cat([R.reshape(b, 9), t, sim[:, None], cov.reshape(b, 36)], dim=-1)

    def export_compiled(self, path: str, batch: int = 1,
                        platforms: Optional[tuple] = None) -> int:
        """Export the forward (graphs, EGNN, head, robust stages as
        `self.stages` sets them, covariance) as a `torch.export` artifact at
        static shapes, written with `torch.export.save` to `path`; returns
        its size in bytes.

        The program is ``fn(params, batch) -> (R [B,3,3], t [B,3],
        similarity_mean [B], pose_covariance [B,6,6])``: `params` is the
        model's state_dict and `batch` the dict of `register()` (src_pts,
        src_feat, tgt_pts, tgt_feat [B, N, ·], labels [B, N]) at
        B = `batch`, N = `cfg.num_nodes`. The weights stay outside the
        artifact (the kernels' weight layout is built from them inside the
        program), so one artifact serves every fine-tune of the
        architecture. The card's kernels appear in it as the custom ops
        `se3gspr_torch::*`.

        `platforms=None` exports for the Registrar's device; ("cuda",) or
        ("cpu",) must name it. Unlike a JAX export, a `torch.export`
        artifact holds one device's graph, so any other value raises
        ValueError."""
        dev = _export_device(platforms, self.device)
        n, c = self.cfg.num_nodes, self.cfg.in_node_nf
        params = {k: v.detach() for k, v in self.model.state_dict().items()}
        specs = {"src_pts": (batch, n, 3), "src_feat": (batch, n, c),
                 "tgt_pts": (batch, n, 3), "tgt_feat": (batch, n, c), "labels": (batch, n)}
        example = {k: torch.zeros(shape, device=dev) for k, shape in specs.items()}
        return _save_export(_ExportedForward(self), (params, example), path)

    @staticmethod
    def load_exported(path: str):
        """Load an `export_compiled` artifact; returns
        ``fn(params, batch) -> (R, t, similarity_mean, pose_covariance)``.
        The call runs under `torch.no_grad()` and in full float32 matrix
        products (`fp32_matmuls`): TF32 is process state, not part of the
        graph, so the artifact cannot carry it. The deployment site needs
        torch and the port's kernel op library (`ops/kernels`, which
        registers the `se3gspr_torch::*` ops), not the model or config
        code; a JAX export needs only jax."""
        return load_program(path)

    def _clique_labels(self, src_pts: np.ndarray, tgt_pts: np.ndarray,
                       tau: float) -> np.ndarray:
        """The exact max-clique inlier mask [N] over the rigid-consistency
        graph (native/max_clique.py); all ones when the clique has fewer
        than 3 members."""
        from .native.max_clique import consistency_graph, max_clique
        ei, ej = consistency_graph(src_pts, tgt_pts, tau=tau)
        lbl = np.zeros(len(src_pts), np.float32)
        if len(ei):
            lbl[max_clique(ei, ej, len(src_pts))] = 1.0
        if lbl.sum() < 3:   # a degenerate clique: every correspondence an inlier
            lbl[:] = 1.0
        return lbl

    def raw_correspondences(self, src_pts, tgt_pts, voxel: float = 0.0,
                            k_normals: int = 30, k_fpfh: int = 60,
                            orient: str = "local", seed: int = 0) -> dict:
        """`register_raw`'s inputs to `register()`, batched [B, ...] tensors
        on the Registrar's device:
        {'src_pts', 'src_feat', 'tgt_pts', 'tgt_feat'} with the targets
        gathered by 'matches' (each source row's nearest target descriptor),
        and 'nbr_src', 'nbr_tgt', the k-NN tables of the fitted clouds.

        Host side, pair by pair (source, then target, from one
        `np.random.default_rng(seed)`, the JAX order): voxel downsampling
        when `voxel > 0`, then `fit_to_count` to `cfg.num_nodes`. Device
        side, all pairs at once: one whole-cloud k-NN table of
        max(k_normals, k_fpfh) neighbors a cloud (B1), whose first
        k_normals columns feed the normals and first k_fpfh the FPFH (the
        exact keys order by (d², index), so the top 30 are the first 30 of
        the top 60: the sets JAX's two `knn_graph` calls give), the gather
        FPFH, L2 row normalization (+1e-6) and mutual-nearest matching."""
        if np.asarray(src_pts).ndim == 2:
            src_pts, tgt_pts = [src_pts], [tgt_pts]
        rng = np.random.default_rng(seed)
        n = self.cfg.num_nodes

        def fit(cloud):
            p = np.asarray(cloud, np.float32)
            if voxel > 0:
                p = fpfh_lib.voxel_downsample(p, voxel)
            return fit_to_count(p, n, rng)[0]

        sp, tp = [], []
        for i in range(len(src_pts)):
            sp.append(fit(src_pts[i]))
            tp.append(fit(tgt_pts[i]))
        x = torch.from_numpy(np.stack(sp + tp)).to(self.device)
        kk = min(max(k_normals, k_fpfh), n)
        tile = max(d for d in range(1, 129) if n % d == 0)
        with torch.no_grad(), fp32_matmuls():
            nbr = knn_window(x, kk, tile, None)
            normals = fpfh_lib.estimate_normals(x, orient=orient, nbr=nbr[..., :k_normals])
            f = fpfh_lib.fpfh(x, normals, nbr=nbr[..., :k_fpfh])
            f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-6)
            b = len(sp)
            j, _, _ = match_features(f[:b], f[b:])
            tgt_x, tgt_f = (torch.take_along_dim(a[b:], j[..., None], dim=1) for a in (x, f))
        return {"src_pts": x[:b], "src_feat": f[:b], "tgt_pts": tgt_x, "tgt_feat": tgt_f,
                "matches": j, "nbr_src": nbr[:b], "nbr_tgt": nbr[b:]}

    def register_raw(self, src_pts, tgt_pts, voxel: float = 0.0, k_normals: int = 30,
                     k_fpfh: int = 60, orient: str = "local", seed: int = 0, **kw):
        """Register raw clouds [N, 3] (or lists/batches of them) through the
        learned model: FPFH-33 descriptors on the device at the model's point
        count, nearest-descriptor correspondences, then `register(...,
        seed=seed, **kw)` (`raw_correspondences` says how). Only a
        33-feature model (in_node_nf=33, the kitti preset) takes FPFH-33;
        others raise ValueError. `orient` 'local' is pose-equivariant;
        'viewpoint' reproduces the open3d convention the KITTI archives
        were built with. For registration with no model see
        `registration.register_fpfh`."""
        if self.cfg.in_node_nf != 33:
            raise ValueError(
                "register_raw computes FPFH-33 features; this Registrar's "
                f"model takes in_node_nf={self.cfg.in_node_nf}. Load a "
                "33-feature (KITTI-style) checkpoint, or call register() "
                "with your own descriptors.")
        squeeze = np.asarray(src_pts).ndim == 2
        c = self.raw_correspondences(src_pts, tgt_pts, voxel, k_normals, k_fpfh, orient, seed)
        R, t, info = self.register(*(c[k].cpu().numpy() for k in
                                     ("src_pts", "src_feat", "tgt_pts", "tgt_feat")),
                                   seed=seed, **kw)
        if squeeze:
            def one(v):
                a = np.asarray(v)
                return a[0] if a.ndim > 0 else a.item()
            return R[0], t[0], {k: one(v) for k, v in info.items()}
        return R, t, info

    def register(self, src_pts, src_feat, tgt_pts, tgt_feat,
                 labels: Optional[np.ndarray] = None, seed: int = 0,
                 clique_prefilter: bool = False, clique_tau: float = 0.10):
        """Returns (R [B,3,3], t [B,3], info); unbatched inputs accepted.
        info: similarity_mean (over the batch), pose_covariance [B,6,6] and,
        with `clique_prefilter`, clique_inliers (a list of ints: each pair's
        clique size after fitting to the model's point count). The clique
        labels, computed on the raw input, replace `labels`. With a mesh,
        every rank calls with the same requests and gets every pair's
        results.

        Under `torch.profiler` the call's host stages are named spans, in
        order: `register.clique` (with `clique_prefilter`), `register.sample`
        (fitting each pair to N, stacking), `register.copy_in` (the mesh's
        padding and sharding, the copy to the device), `register.forward`
        (`forward.curve_sort`, `.knn`, `.egnn`, `.head`, `.robust`,
        `.covariance` inside it), `register.copy_out` (the mesh's gather, the
        copy back, which waits for the device, and unpacking). Every call adds
        1 to `counters["calls"]` and the bytes it copies to the device to
        `counters["bytes_in"]`."""
        squeeze = (not isinstance(src_pts, (list, tuple))
                   and np.asarray(src_pts).ndim == 2)
        if squeeze:
            src_pts, src_feat = src_pts[None], src_feat[None]
            tgt_pts, tgt_feat = tgt_pts[None], tgt_feat[None]
            if labels is not None:
                labels = labels[None]
        if clique_prefilter:
            with span("register.clique"):
                labels = [self._clique_labels(np.asarray(src_pts[i], np.float32),
                                              np.asarray(tgt_pts[i], np.float32), clique_tau)
                          for i in range(len(src_pts))]
        n = self.cfg.num_nodes
        b = len(src_pts)
        with span("register.sample"):
            rng = np.random.default_rng(seed)
            cols: dict[str, list] = {k: [] for k in
                                     ("src_pts", "src_feat", "tgt_pts", "tgt_feat", "labels")}
            for i in range(b):
                sp_i = np.asarray(src_pts[i], np.float32)
                tp_i = np.asarray(tgt_pts[i], np.float32)
                sp, idx = fit_to_count(sp_i, n, rng)
                tp = tp_i[idx] if len(tp_i) == len(sp_i) else fit_to_count(tp_i, n, rng)[0]
                sf_i = np.asarray(src_feat[i], np.float32)
                tf_i = np.asarray(tgt_feat[i], np.float32)
                cols["src_pts"].append(sp)
                cols["src_feat"].append(sf_i[idx])
                cols["tgt_pts"].append(tp)
                cols["tgt_feat"].append(tf_i[idx] if len(tf_i) == len(sf_i)
                                        else fit_to_count(tf_i, n, rng)[0])
                cols["labels"].append(np.asarray(labels[i], np.float32)[idx]
                                      if labels is not None else np.ones(n, np.float32))
            batch = {k: torch.from_numpy(np.stack(v)) for k, v in cols.items()}
        with span("register.copy_in"):
            if self.mesh is not None:
                # pad the pair axis to a multiple of the data axis (the last
                # pair repeats; the padded rows are sliced off), run this rank's rows
                batch = shard_pair_batch(pad_pairs(batch, self.mesh.axis_size("data")),
                                         self.mesh)
            counters["calls"] += 1
            counters["bytes_in"] += sum(v.numel() * v.element_size() for v in batch.values())
            batch = {k: v.to(self.device) for k, v in batch.items()}
        with span("register.forward"):
            res = self._apply(batch)
        with span("register.copy_out"):
            if self.mesh is not None:
                res = gather_pairs(res, self.mesh)[:b]
            res = res.cpu().numpy()
            R, t = res[:, :9].reshape(b, 3, 3), res[:, 9:12]
            info = {"similarity_mean": float(np.mean(res[:, 12])),
                    "pose_covariance": res[:, 13:].reshape(b, 6, 6)}
        if clique_prefilter:
            info["clique_inliers"] = [int(lbl.sum()) for lbl in cols["labels"]]
        if squeeze:
            info["pose_covariance"] = info["pose_covariance"][0]
            return R[0], t[0], info
        return R, t, info


class _WithWeights(torch.nn.Module):
    """The Registrar's model as the one submodule, for `functional_call` to
    swap its weights; the kernels' layout (on the fused path) is built from
    the swapped ones."""

    def __init__(self, reg: Registrar):
        super().__init__()
        self.model = reg.model
        self._reg = (reg,)

    def forward(self, batch: dict):
        return self._reg[0]._forward(batch, None)


class _ExportedForward(torch.nn.Module):
    """`Registrar._forward` with the weights as an input. The model sits in
    a tuple, outside the module tree, so the program holds no weight."""

    def __init__(self, reg: Registrar):
        super().__init__()
        self._inner = (_WithWeights(reg),)

    def forward(self, params: dict, batch: dict):
        return torch.func.functional_call(
            self._inner[0], {f"model.{k}": v for k, v in params.items()}, (batch,))


class BatchingServer:
    """Micro-batching front end: submit() returns a Future resolving to
    (R, t, info); requests queue until `max_batch` pairs accumulate or
    `max_wait_ms` passes since the first, then run as ONE register() call.
    Only kwarg-free requests coalesce; a request with options (a seed,
    labels, the clique prefilter) runs alone, and its future gets its own
    clique_inliers. Over a Registrar with a mesh, every rank runs a server
    and submits the same requests in the same order; the ranks agree on
    each batch before they run it."""

    def __init__(self, registrar: Registrar, max_batch: int = 16,
                 max_wait_ms: float = 5.0):
        self.reg = registrar
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def submit(self, src_pts, src_feat, tgt_pts, tgt_feat, **kw) -> Future:
        fut: Future = Future()
        self._q.put((fut, (src_pts, src_feat, tgt_pts, tgt_feat), kw))
        return fut

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _next(self, backlog: list, timeout: float):
        """The oldest request put back into `backlog`, else the queue's next."""
        return backlog.pop(0) if backlog else self._q.get(timeout=timeout)

    def _serve(self):
        backlog = []  # dequeued requests that did not join the last batch, oldest first
        mesh = getattr(self.reg, "mesh", None)
        while not self._stop.is_set():
            try:
                first = self._next(backlog, 0.05)
            except queue.Empty:
                continue
            pending = [first]
            t0 = time.monotonic()
            while (len(pending) < self.max_batch and not first[2]
                   and time.monotonic() - t0 < self.max_wait):
                try:
                    nxt = self._next(backlog, self.max_wait / 4)
                except queue.Empty:
                    continue
                if not nxt[2]:
                    pending.append(nxt)
                else:
                    backlog.insert(0, nxt)
                    break
            if mesh is not None and mesh.distributed:
                # every rank receives the same requests in the same order, but
                # not at the same times: the ranks agree on the batch (the
                # fewest pending anywhere) and put the rest back
                n = all_reduce_min(len(pending), mesh)
                backlog[:0] = pending[n:]
                pending = pending[:n]
            futs = [p[0] for p in pending]
            try:
                stack = lambda i: [np.asarray(p[1][i]) for p in pending]
                R, t, info = self.reg.register(stack(0), stack(1), stack(2),
                                               stack(3), **first[2])
                for j, fut in enumerate(futs):
                    per = {"similarity_mean": info["similarity_mean"],
                           "pose_covariance": info["pose_covariance"][j]}
                    if "clique_inliers" in info:
                        per["clique_inliers"] = info["clique_inliers"][j]
                    fut.set_result((R[j], t[j], per))
            except BaseException as e:  # incl. SystemExit: keep serving, tell the callers
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
