"""Train / eval / export command-line entry points (a port of the JAX
package's `train/cli.py`: the same commands, arguments and results).

  python -m se3_equi_graph_registration_tpu_torch.train.cli train --preset 3dmatch
  python -m se3_equi_graph_registration_tpu_torch.train.cli eval --preset 3dmatch \
      --checkpoint /path/checkpoint-3dmatch.pth
  python -m se3_equi_graph_registration_tpu_torch.train.cli export --preset 3dmatch \
      --checkpoint ./checkpoints_tpu --out model.pth

Every command runs on the current CUDA card and raises when there is none;
`--device cpu` runs the kernels' plain versions on the CPU instead. Under
torchrun `train` runs data-parallel over the processes (one a card, NCCL;
gloo with `--device cpu`), each loading its slice of every global batch;
with `run.point_parallel=Dp` over a 2-axis mesh {data: world/Dp, point: Dp},
each cloud's points split over Dp processes (`run.halo=W` for the
halo-exchange regime) and the Dp processes of one data row load the same
slice:

  torchrun --nproc_per_node=<cards> -m se3_equi_graph_registration_tpu_torch.train.cli \
      train --preset 3dmatch [--set run.point_parallel=2 run.halo=64]

`.pth` checkpoints convert on the fly (`train/checkpoints.py`); a directory is read
as the port's `TrainCheckpointer` (`step_<n>.pt` files). An orbax directory
written by the JAX package is refused: export it to `.pth` with the JAX
CLI first. The 'synthetic' preset needs no data on disk.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Iterable

import numpy as np
import torch

from ..data.pipeline import PairLoader
from ..data.synthetic import make_pair_batch
from ..device import resolve_device
from ..parallel.distributed import global_mesh, init_distributed, process_shard_info
from ..parallel.mesh import barrier, shard_pair_batch
from ..parallel.point_sharding import make_point_sharded_train_step
from . import engine
from .checkpoints import (TrainCheckpointer, convert_reference_checkpoint,
                          export_reference_checkpoint)
from .config import ExperimentConfig, parse_cli, to_flat_dict


def _build_dataset(cfg: ExperimentConfig, split: str):
    d = cfg.data
    if d.dataset == "3dmatch":
        from ..data.threedmatch import ThreeDMatchPairDataset
        return ThreeDMatchPairDataset(root=d.root, split=split,
                                      descriptor=d.descriptor,
                                      num_node=d.num_node, seed=d.seed,
                                      legacy_sampling_rng=d.legacy_sampling_rng)
    if d.dataset == "kitti":
        from ..data.kitti import KITTIPairDataset
        return KITTIPairDataset(root=d.root, split=split,
                                descriptor=d.descriptor,
                                num_node=d.num_node, seed=d.seed,
                                legacy_sampling_rng=d.legacy_sampling_rng)
    if d.dataset == "synthetic":
        return None
    raise ValueError(f"unknown dataset {d.dataset!r}")


def _synthetic_batches(cfg: ExperimentConfig, n_batches: int = 4, mesh=None) -> Iterable:
    """The synthetic global batches; with a mesh, this rank's rows of each."""
    rng = np.random.default_rng(cfg.data.seed)
    feat_dim = cfg.engine.in_node_nf
    for _ in range(n_batches):
        pb = make_pair_batch(rng, batch=cfg.data.batch_size,
                             n=cfg.engine.num_nodes, feat_dim=feat_dim)
        batch = (pb.corr, pb.labels, pb.src_pts, pb.tgt_pts, pb.src_feat,
                 pb.tgt_feat, pb.gt_pose)
        yield batch if mesh is None else shard_pair_batch(batch, mesh)


def _loader(cfg: ExperimentConfig, split: str, shuffle: bool, dataset=None, mesh=None):
    """A callable giving one epoch of numpy batches. `dataset`: a pre-built
    dataset, to avoid building it twice (None builds it here; the synthetic
    preset has none). With a mesh each process loads its data row's slice
    of every global batch (`PairLoader(process_shard=...)` by the data index
    and the data axis's size, the synthetic preset its rows); one process
    loads the whole batch. The
    loader's threads touch no CUDA state, `engine.fit`/`evaluate` move each
    batch to the device in the calling thread."""
    ds = dataset if dataset is not None else _build_dataset(cfg, split)
    if ds is None:
        return lambda: _synthetic_batches(cfg, mesh=mesh)
    rank, world = ((mesh.axis_index("data"), mesh.axis_size("data")) if mesh is not None
                   else (0, 1))
    return lambda: PairLoader(ds, cfg.data.batch_size // world, shuffle=shuffle,
                              seed=cfg.data.seed, num_workers=cfg.data.num_workers,
                              process_shard=(rank, world) if world > 1 else None)


def _jsonl_logger(path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(epoch: int, metrics: dict):
        rec = {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        pretty = ", ".join(f"{k}={v:.4f}" for k, v in rec.items() if k != "epoch")
        print(f"[epoch {epoch}] {pretty}", flush=True)

    return log


def _is_orbax_dir(path: str) -> bool:
    """An orbax CheckpointManager directory (the JAX package's checkpoints)
    holds one sub-directory per step, named by the step number."""
    return any(e.isdigit() and os.path.isdir(os.path.join(path, e)) for e in os.listdir(path))


def _load_params(path: str, cfg: ExperimentConfig) -> dict[str, torch.Tensor]:
    """The model's state_dict (CPU tensors) from a reference `.pth` or the
    newest step of a `TrainCheckpointer` directory."""
    ecfg = cfg.engine
    if path.endswith(".pth"):
        return convert_reference_checkpoint(path, n_layers=ecfg.n_layers,
                                            num_heads=ecfg.num_heads, hidden=ecfg.hidden_nf)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if _is_orbax_dir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory of the JAX package, which the port "
            f"does not read: convert it first with `python -m "
            f"se3_equi_graph_registration_tpu.train.cli export --checkpoint {path} "
            f"--out <file.pth>` and pass the .pth")
    # only the parameters' shapes matter; any schedule works
    template = engine.init_state(ecfg, torch.Generator().manual_seed(0), device="cpu",
                                 steps_per_epoch=1)
    restored = TrainCheckpointer(path).restore_latest(template)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return restored[0].model.state_dict()


def _train_mesh(cfg: ExperimentConfig, device: torch.device):
    """The mesh over every process of the run: with run.point_parallel = Dp
    > 1 the 2-axis {data: world / Dp, point: Dp}, else one 'data' axis over
    a multi-process run and None on one process. Several processes that do
    not split the batch would each train alone and write one checkpoint
    directory, so that raises."""
    _, world = process_shard_info()
    dp = cfg.run.point_parallel
    if dp > 1:
        if world % dp:
            raise ValueError(f"run.point_parallel={dp} needs a multiple of {dp} processes "
                             f"(one a point slab), have {world}")
        axes = {"data": world // dp, "point": dp}
    elif world == 1:
        return None
    elif not cfg.run.data_parallel:
        raise ValueError(f"{world} processes train one model only data-parallel; set "
                         f"run.data_parallel=true or run one process")
    else:
        axes = {"data": world}
    if cfg.data.batch_size % axes["data"]:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} does not split over "
                         f"{axes['data']} processes")
    return global_mesh(axes, device)


def cmd_train(cfg: ExperimentConfig, args, device: torch.device) -> engine.TrainState:
    ecfg = cfg.engine
    mesh = _train_mesh(cfg, device)
    lead = mesh is None or mesh.rank == 0
    # micro-batches per epoch for epoch-unit LR boundaries (engine.lr_schedule);
    # 4 = _synthetic_batches' per-epoch count. Dataset built ONCE, reused below.
    train_ds = _build_dataset(cfg, "train")
    steps_per_epoch = (4 if train_ds is None
                       else max(1, len(train_ds) // cfg.data.batch_size))
    state = engine.init_state(ecfg, torch.Generator().manual_seed(cfg.data.seed),
                              device=device, steps_per_epoch=steps_per_epoch)
    train_batches = _loader(cfg, "train", shuffle=True, dataset=train_ds, mesh=mesh)
    val_batches = _loader(cfg, "val", shuffle=False, mesh=mesh) \
        if cfg.data.dataset != "synthetic" else None

    ckpt = TrainCheckpointer(cfg.run.checkpoint_dir)
    if cfg.run.resume:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state, step = restored
            print(f"resumed from step {step}")

    train_step = None
    if mesh is not None and "point" in mesh.axes:
        train_step = make_point_sharded_train_step(state.model, state.optimizer, ecfg, mesh,
                                                   halo=cfg.run.halo or None)
        if lead:
            print(f"2-axis mesh: data={mesh.axis_size('data')} x point="
                  f"{mesh.axis_size('point')}" + (f", halo={cfg.run.halo}" if cfg.run.halo
                                                  else ""))
    elif mesh is not None and lead:
        print(f"data-parallel over {mesh.size} processes ({mesh.backend}), "
              f"{cfg.data.batch_size // mesh.size} pairs each a step")
    if lead:
        print(json.dumps(to_flat_dict(cfg), indent=2, default=str))
    state = engine.fit(
        state.model, state.optimizer, ecfg, state, train_batches=train_batches,
        epochs=cfg.run.epochs, val_batches=val_batches, checkpointer=ckpt,
        checkpoint_every=cfg.run.checkpoint_every,
        logger=_jsonl_logger(cfg.run.log_path) if lead else None, mesh=mesh,
        train_step=train_step)
    if lead:
        ckpt.save(state.step, state)
        print(f"done; final checkpoint at step {state.step}")
    barrier(mesh)
    return state


def cmd_eval(cfg: ExperimentConfig, args, device: torch.device) -> dict:
    if args.checkpoint is None:
        raise SystemExit("--checkpoint required for eval")
    ecfg = cfg.engine
    model = engine.build_model(ecfg, head_mode="eval_fusion", device=device)
    model.load_state_dict(_load_params(args.checkpoint, cfg))
    batches_fn = _loader(cfg, "test", shuffle=False)
    os.makedirs(os.path.dirname(cfg.run.eval_output) or ".", exist_ok=True)
    summary = engine.evaluate(model, ecfg, batches_fn(), save_path=cfg.run.eval_output)
    print(json.dumps(summary, indent=2))
    return summary


def cmd_export(cfg: ExperimentConfig, args, device: torch.device) -> str:
    """Convert a checkpoint to the reference's `.pth` schema, which the
    upstream scripts load strict (`checkpoints.export_reference_checkpoint`):
    a `TrainCheckpointer` directory or a reference `.pth` in. Runs on the
    host; no kernel."""
    if args.checkpoint is None or args.out is None:
        raise SystemExit("export requires --checkpoint <checkpoint-dir|.pth> "
                         "--out <file.pth>")
    ecfg = cfg.engine
    export_reference_checkpoint(
        _load_params(args.checkpoint, cfg), args.out, epoch=args.epoch,
        n_layers=ecfg.n_layers, num_heads=ecfg.num_heads, hidden=ecfg.hidden_nf)
    print(f"wrote reference-schema checkpoint to {args.out}")
    return args.out


def main(argv=None):
    """Run one command; returns what it returns (the final TrainState, the
    eval summary, the exported path)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("train", "eval", "export"):
        raise SystemExit("usage: cli.py {train|eval|export} [--preset ...] ...")
    command, rest = argv[0], argv[1:]
    cfg, args = parse_cli(rest, description=f"{command} entry point")
    if cfg.run.compile_cache:
        print(f"run.compile_cache={cfg.run.compile_cache!r} maps to nothing here: the "
              f"kernels build once into ops/kernels/build.py's _build/ cache")
    # a multi-process run (torchrun) joins its group first: under NCCL that
    # also picks this process's card; one process is a no-op
    init_distributed(device=args.device)
    if command != "train" and process_shard_info()[1] > 1:
        raise ValueError(f"`{command}` runs on one process; only `train` runs data-parallel")
    device = resolve_device(args.device)
    commands = {"train": cmd_train, "eval": cmd_eval, "export": cmd_export}
    return commands[command](cfg, args, device)


if __name__ == "__main__":
    main()
