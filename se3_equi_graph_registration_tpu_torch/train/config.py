"""Config system: dataclass configs with JSON file + CLI overrides (a port of
the JAX package's `train/config.py`: the same fields, presets, override
rules and command line, so a config file written for one package runs the
other).

The reference has argparse blocks per script with author-machine absolute
paths, partially overridden by hardcoded values (SURVEY.md §5.6). Here one
`ExperimentConfig` drives train/eval for every dataset family; any field is
settable from a JSON file (--config) and/or --key=value CLI overrides.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Optional

from . import losses as losses_lib
from .engine import EngineConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "3dmatch"          # '3dmatch' | 'kitti' | 'synthetic'
    root: str = "./data/3dmatch"
    descriptor: str = "fcgf"          # 'fcgf' | 'fpfh'
    num_node: int = 2048
    batch_size: int = 8               # reference default (argparse :1541)
    num_workers: int = 4
    seed: int = 0
    legacy_sampling_rng: bool = False  # reference-stream per-item sampling
                                       # (pipeline-parity harness; 3dmatch)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    epochs: int = 500                 # reference default; KITTI uses 200
    checkpoint_dir: str = "./checkpoints_tpu"
    checkpoint_every: int = 20        # reference :1435
    log_path: str = "./runs/train_log.jsonl"
    eval_output: str = "./output/evaluation_results.txt"
    resume: bool = False
    point_parallel: int = 0           # >1: shard the point axis; not ported
                                      # yet (ROADMAP Queue A item 9)
    compile_cache: str = ""           # the JAX package's persistent XLA cache
                                      # directory: kept so configs carry
                                      # across, maps to nothing (the kernels'
                                      # build cache is ops/kernels/build.py's
                                      # _build/)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    engine: EngineConfig = EngineConfig()
    data: DataConfig = DataConfig()
    run: RunConfig = RunConfig()


def preset(name: str) -> ExperimentConfig:
    """Named presets mirroring the reference's three training and evaluation
    scripts."""
    if name == "3dmatch":
        # lr_step_unit='epoch': the reference's StepLR(200, 0.5) counts
        # EPOCHS (:1412-1413) — the CLI converts via the dataset size
        return ExperimentConfig(
            engine=EngineConfig(in_node_nf=32, top_k=128,
                                lr_step_unit="epoch"),
            data=DataConfig(dataset="3dmatch", descriptor="fcgf"),
            run=RunConfig(epochs=500))
    if name == "kitti":
        # FPFH 33-d end to end (in/hidden/out all 33, :1515-1518), head
        # top_k=2048 (:661). The KITTI EGNN never forwards num_heads, so its
        # E_GCL runs the 1-head default (:311 vs :186). Its head returns the
        # BCE corr loss WITHOUT the 3DMatch sim term (:752-766), and the
        # train loss is corr + equi only (:1089) — sim/rot/trans all zero.
        # The JAX package's tests pin this preset end to end against the
        # reference's KITTI script.
        return ExperimentConfig(
            engine=EngineConfig(
                in_node_nf=33, hidden_nf=33, num_heads=1, top_k=2048,
                lr_step_unit="epoch",
                loss_weights=losses_lib.LossWeights(corr=1.0, sim=0.0,
                                                    rot=0.0, trans=0.0, equi=1.0)),
            data=DataConfig(dataset="kitti", descriptor="fpfh"),
            run=RunConfig(epochs=200))
    if name == "synthetic":
        return ExperimentConfig(
            engine=EngineConfig(in_node_nf=32, top_k=128),
            data=DataConfig(dataset="synthetic"),
            run=RunConfig(epochs=3, checkpoint_every=1))
    raise ValueError(f"unknown preset {name!r}")


# numeric fields that ALSO accept string sentinel modes (the consumer
# validates the string and raises its own, clearer error): only these may
# keep a non-convertible string override instead of failing at the CLI
_STRING_SENTINEL_FIELDS = frozenset({"icp_trim"})

# the JAX package's fields that nothing here reads, with their JAX defaults.
# A config that sets one loads: the value is checked as the JAX package
# takes it, then dropped. The k-NN and the head's top-k are always exact
# (knn_recall, topk_method), one-hot permutes are a TPU workaround
# (onehot_h_permute), one card holds the whole batch (data_parallel), and
# halo exchange needs point_parallel (ROADMAP "Dropped on purpose")
_JAX_ONLY_FIELDS = {"engine.knn_recall": 0.85, "engine.onehot_h_permute": False,
                    "engine.topk_method": "exact", "run.data_parallel": True, "run.halo": 0}
_TOPK_METHODS = ("exact", "approx")


def _check_jax_only(key: str, value: Any) -> None:
    kind = type(_JAX_ONLY_FIELDS[key])
    try:
        value = kind(value)
    except (TypeError, ValueError):
        raise ValueError(f"config override {key}={value!r} is not a valid "
                         f"{kind.__name__}") from None
    if key == "engine.topk_method" and value not in _TOPK_METHODS:
        raise ValueError(f"config override {key}={value!r}: expected one of {_TOPK_METHODS}")


def _replace_nested(cfg: Any, dotted: str, value: Any):
    head, _, rest = dotted.partition(".")
    if rest and isinstance(getattr(cfg, head), losses_lib.LossWeights):
        # the loss weights are a NamedTuple that to_flat_dict writes flat
        # ('engine.loss_weights.equi'). Two differences from the JAX package:
        # its from_file raises a TypeError on such a key, so its own
        # to_flat_dict files do not load, and its parse_cli keeps the value
        # as given where this coerces it to float
        try:
            value = float(value)
        except (TypeError, ValueError):
            raise ValueError(f"config override {dotted}={value!r} is not a valid "
                             f"float") from None
        return dataclasses.replace(cfg, **{head: getattr(cfg, head)._replace(**{rest: value})})
    if rest:
        return dataclasses.replace(
            cfg, **{head: _replace_nested(getattr(cfg, head), rest, value)})
    current = getattr(cfg, head)
    if isinstance(current, tuple):
        if isinstance(value, str):
            # comma-separated numeric tuples (engine.icp_voxels=0.4,0.15,0)
            try:
                value = tuple(float(v) for v in value.split(",") if v != "")
            except (TypeError, ValueError):
                raise ValueError(
                    f"config override {head}={value!r} is not a valid "
                    f"tuple of floats") from None
        elif isinstance(value, (list, tuple)):
            value = tuple(value)
        elif isinstance(value, (int, float)):
            value = (value,)            # a bare scalar is a 1-entry tuple
    elif current is not None and not isinstance(current, (dict, losses_lib.LossWeights)):
        if (head in _STRING_SENTINEL_FIELDS and isinstance(current, str)
                and isinstance(value, (int, float))
                and not isinstance(value, bool)):
            # sentinel field currently holding a string mode (e.g.
            # icp_trim='auto' from a JSON config): a numeric override takes
            # effect as-is instead of being str()-coerced into '0.4'
            pass
        elif not isinstance(value, type(current)):
            try:
                value = type(current)(value)
            except (TypeError, ValueError):
                if not (head in _STRING_SENTINEL_FIELDS
                        and isinstance(value, str)):
                    raise ValueError(
                        f"config override {head}={value!r} is not a valid "
                        f"{type(current).__name__}") from None
    return dataclasses.replace(cfg, **{head: value})


def apply_overrides(cfg: ExperimentConfig, overrides: dict[str, Any]) -> ExperimentConfig:
    """Apply {'engine.lr': 3e-4, 'data.batch_size': 16, ...} overrides."""
    for key, value in overrides.items():
        if key in _JAX_ONLY_FIELDS:
            _check_jax_only(key, value)
        else:
            cfg = _replace_nested(cfg, key, value)
    return cfg


def from_file(path: str, base: Optional[ExperimentConfig] = None) -> ExperimentConfig:
    with open(path) as f:
        flat = json.load(f)
    return apply_overrides(base or ExperimentConfig(), flat)


def to_flat_dict(cfg: ExperimentConfig) -> dict[str, Any]:
    out = {}

    def rec(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v) and not isinstance(v, losses_lib.LossWeights):
                rec(f"{prefix}{f.name}.", v)
            elif isinstance(v, losses_lib.LossWeights):
                for lf, lv in v._asdict().items():
                    out[f"{prefix}{f.name}.{lf}"] = lv
            else:
                out[f"{prefix}{f.name}"] = v

    rec("", cfg)
    return out


def parse_cli(argv: Optional[list[str]] = None,
              description: str = "") -> tuple[ExperimentConfig, argparse.Namespace]:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--preset", default="3dmatch",
                    choices=["3dmatch", "kitti", "synthetic"])
    ap.add_argument("--config", default=None, help="JSON config file")
    ap.add_argument("--set", nargs="*", action="extend", default=[],
                    metavar="KEY=VALUE",
                    help="dotted overrides, e.g. engine.lr=3e-4; repeatable "
                         "(values accumulate across --set occurrences)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint to evaluate / resume from (.pth converts)")
    ap.add_argument("--out", default=None,
                    help="output path for the `export` command (.pth)")
    ap.add_argument("--epoch", type=int, default=0,
                    help="epoch stamp written by the `export` command")
    ap.add_argument("--robust", action="store_true",
                    help="eval/serving robustness stack: sharp fusion "
                         "weighting + spectral reweighting + IRLS "
                         "(= engine.fusion_weighting=sharp "
                         "engine.spectral_topm=256 engine.refine_iters=5; "
                         "BASELINE.md low-inlier tables)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on, e.g. cpu or cuda:0 (default: "
                         "the current CUDA card; raises when there is none)")
    args = ap.parse_args(argv)

    cfg = preset(args.preset)
    if args.robust:
        cfg = dataclasses.replace(
            cfg, engine=dataclasses.replace(
                cfg.engine, fusion_weighting="sharp", spectral_topm=256,
                refine_iters=5))
    if args.config:
        cfg = from_file(args.config, cfg)
    overrides = {}
    for item in args.set:
        key, _, val = item.partition("=")
        try:
            val = json.loads(val)
        except json.JSONDecodeError:
            pass
        overrides[key] = val
    return apply_overrides(cfg, overrides), args
