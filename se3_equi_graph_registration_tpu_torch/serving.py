"""Serving API (counterpart of `serving.py`): a warm registration callable
and a micro-batching front end.

    reg = Registrar(state_dict, engine.fast_tpu_config())
    R, t, info = reg.register(src_pts, src_feat, tgt_pts, tgt_feat)

- numpy in, numpy out; single pairs [N, ·] or batches [B, N, ·];
- inputs are sampled down or padded to `cfg.num_nodes` (`fit_to_count`);
- `info` carries the per-request similarity mean and a 6x6 Gauss-Newton pose
  covariance (ops/kabsch.py);
- `BatchingServer` coalesces concurrent register() calls into one dispatch.

Runs on the CUDA card unless `device="cpu"` is passed.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping, Optional, Union

import numpy as np
import torch

from .data.sampling import fit_to_count
from .ops.kabsch import pose_covariance
from .ops.kernels.egcl import kernel_params
from .train import engine


class Registrar:
    def __init__(self, params: Mapping[str, torch.Tensor], cfg: engine.EngineConfig,
                 head_mode: str = "eval_fusion",
                 device: Union[str, torch.device, None] = None):
        """`params`: the model's state_dict (e.g. `params_from_jax(...)`)."""
        self.cfg = cfg
        self.model = engine.build_model(cfg, head_mode=head_mode, device=device)
        self.model.load_state_dict(params)
        self.device = next(self.model.parameters()).device
        with torch.no_grad():                        # the weights never change
            self._kp = kernel_params(self.model.egnn)

    @torch.no_grad()
    def _apply(self, batch: dict) -> torch.Tensor:
        """[B, 49] = R (9) | t (3) | similarity mean (1) | covariance (36):
        one device-to-host copy per request."""
        out = engine._apply_with_graphs(self.model, self.cfg, batch, self._kp)
        cov = pose_covariance(batch["src_pts"], batch["tgt_pts"], out.R, out.t,
                              out.weights)
        b = out.R.shape[0]
        return torch.cat([out.R.reshape(b, 9), out.t,
                          out.similarity.mean(-1, keepdim=True),
                          cov.reshape(b, 36)], dim=-1)

    def register(self, src_pts, src_feat, tgt_pts, tgt_feat,
                 labels: Optional[np.ndarray] = None, seed: int = 0):
        """Returns (R [B,3,3], t [B,3], info); unbatched inputs accepted.
        info: similarity_mean (over the batch) and pose_covariance [B,6,6]."""
        squeeze = (not isinstance(src_pts, (list, tuple))
                   and np.asarray(src_pts).ndim == 2)
        if squeeze:
            src_pts, src_feat = src_pts[None], src_feat[None]
            tgt_pts, tgt_feat = tgt_pts[None], tgt_feat[None]
            if labels is not None:
                labels = labels[None]
        n = self.cfg.num_nodes
        rng = np.random.default_rng(seed)
        b = len(src_pts)
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
        batch = {k: torch.from_numpy(np.stack(v)).to(self.device)
                 for k, v in cols.items()}
        res = self._apply(batch).cpu().numpy()
        R, t = res[:, :9].reshape(b, 3, 3), res[:, 9:12]
        info = {"similarity_mean": float(np.mean(res[:, 12])),
                "pose_covariance": res[:, 13:].reshape(b, 6, 6)}
        if squeeze:
            info["pose_covariance"] = info["pose_covariance"][0]
            return R[0], t[0], info
        return R, t, info


class BatchingServer:
    """Micro-batching front end: submit() returns a Future resolving to
    (R, t, info); requests queue until `max_batch` pairs accumulate or
    `max_wait_ms` passes since the first, then run as ONE register() call.
    Only kwarg-free requests coalesce; a request with options runs alone."""

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

    def _serve(self):
        carry = None  # a dequeued request that did not match the batch's kwargs
        while not self._stop.is_set():
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
            pending = [first]
            t0 = time.monotonic()
            while (len(pending) < self.max_batch and not first[2]
                   and time.monotonic() - t0 < self.max_wait):
                try:
                    nxt = self._q.get(timeout=self.max_wait / 4)
                except queue.Empty:
                    continue
                if not nxt[2]:
                    pending.append(nxt)
                else:
                    carry = nxt
                    break
            futs = [p[0] for p in pending]
            try:
                stack = lambda i: [np.asarray(p[1][i]) for p in pending]
                R, t, info = self.reg.register(stack(0), stack(1), stack(2),
                                               stack(3), **first[2])
                for j, fut in enumerate(futs):
                    fut.set_result((R[j], t[j], {
                        "similarity_mean": info["similarity_mean"],
                        "pose_covariance": info["pose_covariance"][j]}))
            except BaseException as e:  # incl. SystemExit: keep serving, tell the callers
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
