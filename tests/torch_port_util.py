"""Shared helpers of the port's parity tests (tests/test_torch_*.py): inputs
made with numpy from a seed, weights drawn by the JAX package and carried
into the port with `params_from_jax`."""
from __future__ import annotations

import jax
import numpy as np

NEAR_TIE_REL = 2.0 ** -12


def sorted_cloud(rng: np.random.Generator, b: int, n: int, c: int):
    """(h, x) [b, n, c] / [b, n, 3], x uniform in a 3 m cube, both permuted
    into Hilbert order by the JAX package's own sort."""
    import jax.numpy as jnp

    from se3_equi_graph_registration_tpu.ops import morton

    x = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    h = rng.standard_normal((b, n, c)).astype(np.float32)
    perm = np.asarray(morton.morton_perm(jnp.asarray(x)))
    return (np.take_along_axis(h, perm[..., None], 1),
            np.take_along_axis(x, perm[..., None], 1))


def jax_model_params(cfg, head_mode: str = "train", seed: int = 0):
    """Random flax params of the JAX RegistrationModel for `cfg` (numpy
    leaves), from `jax.jit(model.init)`."""
    from se3_equi_graph_registration_tpu.train import engine

    model = engine.build_model(cfg, head_mode=head_mode)
    n, c = cfg.num_nodes, cfg.in_node_nf
    f = np.zeros((1, n, c), np.float32)
    p = np.zeros((1, n, 3), np.float32)
    nbr = np.zeros((1, n, cfg.k), np.int32)
    lbl = np.ones((1, n), np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), f, p, nbr, f, p, nbr, lbl)
    return model, jax.tree_util.tree_map(np.asarray, params)


def neighbor_set_mismatches(x: np.ndarray, ref: np.ndarray, got: np.ndarray,
                            rel: float = NEAR_TIE_REL) -> int:
    """Rows whose neighbor sets differ, after checking that every swapped
    neighbor is a near-tie: its d² within `rel` (relative) of the row's
    k-th d² under the reference. Raises on any other difference."""
    mismatches = 0
    for b in range(ref.shape[0]):
        xb = x[b].astype(np.float64)
        for r in range(ref.shape[1]):
            se, sg = set(ref[b, r].tolist()), set(got[b, r].tolist())
            if se == sg:
                continue
            mismatches += 1
            d2 = ((xb[list(se ^ sg)] - xb[r]) ** 2).sum(-1)
            kth = ((xb[ref[b, r]] - xb[r]) ** 2).sum(-1).max()
            assert np.all(np.abs(d2 - kth) <= rel * max(kth, 1e-30)), (b, r, d2, kth)
    return mismatches


def pair_batches(seed: int, count: int = 1, b: int = 2, n: int = 256, c: int = 16):
    """`count` synthetic pair batches from one numpy seed (the JAX package's
    `make_pair_batch`, which the port copies)."""
    from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch

    rng = np.random.default_rng(seed)
    return [make_pair_batch(rng, batch=b, n=n, feat_dim=c) for _ in range(count)]


def jax_train_batch(pb):
    from se3_equi_graph_registration_tpu.train import engine as jengine

    return jengine.batch_to_device((pb.corr, pb.labels, pb.src_pts, pb.tgt_pts,
                                    pb.src_feat, pb.tgt_feat, pb.gt_pose))


def port_train_batch(pb):
    from se3_equi_graph_registration_tpu_torch.train import engine as tengine

    return tengine.batch_to_device((pb.corr, pb.labels, pb.src_pts, pb.tgt_pts,
                                    pb.src_feat, pb.tgt_feat, pb.gt_pose), "cpu")


def port_model(cfg_kw: dict, params):
    """(the port's fast_tpu_config(**cfg_kw), its train-head model on the CPU
    holding the JAX `params`)."""
    from se3_equi_graph_registration_tpu_torch.train import engine as tengine
    from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

    cfg = tengine.fast_tpu_config(**cfg_kw)
    model = tengine.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return cfg, model


def jax_grads(jmodel, jcfg, params, batch):
    """(loss breakdown, {port name: gradient}) of the JAX engine's loss:
    `jax.grad` over `_apply_with_graphs` + `total_loss`."""
    from se3_equi_graph_registration_tpu.train import engine as jengine
    from se3_equi_graph_registration_tpu.train import losses as jlosses
    from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

    def loss_fn(p):
        out = jengine._apply_with_graphs(jmodel, jcfg, p, batch)
        lb = jlosses.total_loss(out, batch["gt_pose"], batch["labels"], jcfg.loss_weights)
        return lb.total, lb
    (_, lb), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return lb, {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, g)).items()}


def port_grads(model, cfg, batch):
    """(loss breakdown, {name: gradient}) of the port's training loss."""
    from se3_equi_graph_registration_tpu_torch.train import engine as tengine

    model.zero_grad(set_to_none=True)
    lb = tengine.train_loss(model, cfg, batch)
    lb.total.backward()
    return lb, {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def write_pair_root(root, dataset: str = "3dmatch", n_pairs=(4, 2, 4), n_pts: int = 300,
                    feat_dim: int = 32, seed: int = 0, torch_train: bool = True,
                    inlier_ratio: float = 0.5) -> str:
    """A dataset root in the reference's on-disk format, written by the test:
    `{train,val,test}_files.txt` and pair pickles under `train_<dataset>/`
    (train and val) and `test_<dataset>/`, `n_pairs` = (train, val, test).
    Each pair: `n_pts` source keypoints, the target cloud a posed copy with
    2 cm noise in another order (`corr[:, 1]` a permutation), a share
    `1 - inlier_ratio` of its rows moved elsewhere (label 0), descriptors
    as make_pair_batch draws them. 3DMatch train/val pickles hold torch
    tensors with a leading batch axis, written by torch.save (`torch_train`),
    else numpy dicts."""
    import os
    import pickle

    import torch

    from se3_equi_graph_registration_tpu.data.synthetic import random_rotation

    rng = np.random.default_rng(seed)
    sub = {"train": f"train_{dataset}", "val": f"train_{dataset}", "test": f"test_{dataset}"}
    for split, count in zip(("train", "val", "test"), n_pairs):
        os.makedirs(os.path.join(root, sub[split]), exist_ok=True)
        names = []
        for i in range(count):
            src = rng.uniform(-1.5, 1.5, (n_pts, 3)).astype(np.float32)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = random_rotation(rng)
            pose[:3, 3] = rng.standard_normal(3) * 0.5
            inl = rng.uniform(size=n_pts) < inlier_ratio
            moved = src @ pose[:3, :3].T + pose[:3, 3] + rng.standard_normal((n_pts, 3)) * 0.02
            moved = np.where(inl[:, None], moved, rng.uniform(-1.5, 1.5, (n_pts, 3)))
            perm = rng.permutation(n_pts)
            tgt = np.empty_like(src)
            tgt[perm] = moved
            f = rng.standard_normal((n_pts, feat_dim)).astype(np.float32)
            f /= np.linalg.norm(f, axis=1, keepdims=True) + 1e-6
            ft = np.where(inl[:, None], f + rng.standard_normal(f.shape) * 0.1,
                          rng.standard_normal(f.shape)).astype(np.float32)
            tgt_feat = np.empty_like(ft)
            tgt_feat[perm] = ft
            corr = np.stack([np.arange(n_pts), perm], 1)
            d = {"xyz_0": src, "xyz_1": tgt.astype(np.float32), "feat_0": f,
                 "feat_1": tgt_feat, "corr": corr, "labels": inl.astype(np.float32),
                 "gt_pose": pose}
            if dataset == "3dmatch" and split != "test" and torch_train:
                keys = dict(xyz_0="src_keypts", xyz_1="tgt_keypts", feat_0="src_features",
                            feat_1="tgt_features", corr="corr", labels="gt_labels",
                            gt_pose="gt_pose")
                d = {keys[k]: torch.from_numpy(np.asarray(v)[None]) for k, v in d.items()}
            name = f"{split}_{i:03d}.pkl"
            path = os.path.join(root, sub[split], name)
            if isinstance(d["corr"], torch.Tensor):
                torch.save(d, path)             # the reference's files: torch.save zips
            else:
                with open(path, "wb") as fh:
                    pickle.dump(d, fh)
            names.append(name)
        with open(os.path.join(root, f"{split}_files.txt"), "w") as fh:
            fh.write("\n".join(names) + "\n")
    return str(root)
