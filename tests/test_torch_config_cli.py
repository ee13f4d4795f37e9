"""The port's config system and command line against the JAX package's
(`tests/test_config_cli.py`'s twin): presets, overrides, files and
`parse_cli` field for field, the synthetic batches array for array, and
`cli train`, `eval` and `export` on the CPU at small size (N = 256, 2
layers, the presets' widths: C = 32 with 4 heads for 3dmatch, C = 33 with 1
head and top_k = N for kitti; C = 16 with 2 heads for synthetic).

Tolerances: configs, batches and exported tensors are exact (`==`,
`np.array_equal`, `torch.equal`); a resumed run equals the uninterrupted
one exactly. `cli eval` on one `.pth` and one dataset root, port against
JAX (the same fp32 math in another order): the summary's translation error
within 1e-3 cm (measured 4e-6), recall, precision and F1 within 1e-6
(measured 3e-8), and the rotation error within 2e-2 deg (measured 3e-3):
it is arccos((tr - 1) / 2) in float32, whose spacing near the 0.1 deg these
poses reach is ~4e-3 deg an ulp of the trace. The eval roots sample with
`legacy_sampling_rng`: with the shared generator, the JAX CLI draws a
template batch first (and its loader thread prefetches more), so its
evaluation samples other correspondences than the port's.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_util import jax_model_params, write_pair_root

from se3_equi_graph_registration_tpu.train import checkpoints as jckpt
from se3_equi_graph_registration_tpu.train import cli as jcli
from se3_equi_graph_registration_tpu.train import config as jconfig
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu.train import losses as jlosses
from se3_equi_graph_registration_tpu_torch.train import checkpoints as tckpt
from se3_equi_graph_registration_tpu_torch.train import cli as tcli
from se3_equi_graph_registration_tpu_torch.train import config as tconfig
from se3_equi_graph_registration_tpu_torch.train import engine as tengine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LAYERS = 256, 2
SMALL = [f"engine.num_nodes={N}", f"data.num_node={N}", f"engine.n_layers={LAYERS}",
         "data.batch_size=2", "data.num_workers=2"]
SYNTH = ["--preset", "synthetic", "--set", *SMALL, "engine.in_node_nf=16",
         "engine.hidden_nf=16", "engine.num_heads=2", "engine.top_k=32", "engine.k=8"]


def _ported(flat):
    """A flat config without the JAX package's fields that the port drops."""
    return {k: v for k, v in flat.items() if k not in tconfig._JAX_ONLY_FIELDS}


def _flat(cfg):
    """A config of either package as its flat dict, tuples as JSON lists,
    without the fields that the port drops."""
    lib = tconfig if isinstance(cfg, tconfig.ExperimentConfig) else jconfig
    return _ported(json.loads(json.dumps(lib.to_flat_dict(cfg))))


@pytest.mark.parametrize("name", ["3dmatch", "kitti", "synthetic"])
def test_presets_match_field_for_field(name):
    want = _ported(jconfig.to_flat_dict(jconfig.preset(name)))
    got = tconfig.to_flat_dict(tconfig.preset(name))
    assert list(got) == list(want) and got == want
    assert tconfig.preset(name).engine == tengine.EngineConfig(**dataclasses.asdict(
        tconfig.preset(name).engine))


def test_default_and_fast_configs_match():
    assert _flat(tconfig.ExperimentConfig()) == _flat(jconfig.ExperimentConfig())
    want = _ported({f"engine.{k}": v for k, v in
                    dataclasses.asdict(jengine.fast_tpu_config()).items()})
    assert {f"engine.{k}": v for k, v in
            dataclasses.asdict(tengine.fast_tpu_config()).items()} == want
    # the dropped fields keep the JAX package's defaults
    for key, default in tconfig._JAX_ONLY_FIELDS.items():
        assert jconfig.to_flat_dict(jconfig.ExperimentConfig())[key] == default


def test_jax_only_fields_load_and_are_checked():
    """The fields the port drops load at every value the JAX package takes
    (its own fast config's among them) and leave the config as it was; a
    value the JAX package could not take raises."""
    base = tconfig.preset("3dmatch")
    ok = {"engine.knn_recall": "0.95", "engine.onehot_h_permute": True,
          "engine.topk_method": "approx", "run.data_parallel": False, "run.halo": 768}
    assert tconfig.apply_overrides(base, ok) == base
    for key, bad in (("engine.knn_recall", "high"), ("engine.topk_method", "sorted"),
                     ("run.halo", "wide")):
        with pytest.raises(ValueError, match=key):
            tconfig.apply_overrides(base, {key: bad})


def test_overrides_and_files_match(tmp_path):
    over = {"engine.lr": 3e-4, "data.batch_size": 16, "run.resume": True,
            "engine.icp_voxels": "0.4,0.15,0", "engine.icp_trim": "auto",
            "data.descriptor": "fpfh", "engine.remat": "1"}
    for name in ("3dmatch", "kitti"):
        assert _flat(tconfig.apply_overrides(tconfig.preset(name), over)) == _flat(
            jconfig.apply_overrides(jconfig.preset(name), over))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"engine.hidden_nf": 64, "data.descriptor": "fpfh",
                                "engine.icp_voxels": [0.3, 0.0], "run.epochs": 7}))
    for base in (None, "kitti"):
        got = tconfig.from_file(str(path), base and tconfig.preset(base))
        want = jconfig.from_file(str(path), base and jconfig.preset(base))
        assert _flat(got) == _flat(want)


@pytest.mark.parametrize("name", ["3dmatch", "kitti", "synthetic"])
def test_a_jax_written_config_loads_in_the_port(name, tmp_path):
    """The JAX package's to_flat_dict of a preset, as a JSON file, loads in
    the port to the same preset. (The JAX package's own from_file raises a
    TypeError on the flat loss-weight keys this file holds.)"""
    path = tmp_path / "jax.json"
    path.write_text(json.dumps(jconfig.to_flat_dict(jconfig.preset(name))))
    got = tconfig.from_file(str(path))
    assert got == tconfig.preset(name)
    with pytest.raises(TypeError):
        jconfig.from_file(str(path))


ARGV = {
    "default": [],
    "kitti": ["--preset", "kitti"],
    "robust": ["--preset", "synthetic", "--robust"],
    "robust-then-set": ["--preset", "synthetic", "--robust", "--set", "engine.spectral_topm=128"],
    "sets": ["--set", "engine.lr=3e-4", "data.batch_size=16", "--set", "run.resume=true"],
    "repeated-sets": ["--preset", "synthetic", "--set", "run.epochs=1", "--set",
                      "run.compile_cache=/tmp/cc", "--set", "engine.lr=0.002"],
    "loss-weights": ["--preset", "kitti", "--set", "engine.loss_weights.equi=2.0",
                     "engine.loss_weights.rot=0.5"],
    "sentinel": ["--set", "engine.icp_trim=auto"],
    "sentinel-number": ["--set", "engine.icp_trim=auto", "--set", "engine.icp_trim=0.4"],
    "tuple": ["--set", "engine.icp_voxels=0.4,0.15,0"],
    "tuple-scalar": ["--set", "engine.icp_voxels=0.4"],
    "command-args": ["--checkpoint", "x.pth", "--out", "y.pth", "--epoch", "7"],
    "remat": ["--preset", "kitti", "--set", "engine.remat=true", "run.point_parallel=2"],
    "bad-scalar": ["--set", "engine.icp_iters=abc"],
    "bad-float": ["--set", "engine.lr=3e-4x"],
    "bad-tuple": ["--set", "engine.icp_voxels=0.4,abc"],
    "bad-field": ["--set", "engine.nonsense=1"],
    "bad-preset": ["--preset", "nope"],
}


@pytest.mark.parametrize("argv", list(ARGV.values()), ids=list(ARGV))
def test_parse_cli_matches(argv, tmp_path):
    try:
        want, wargs = jconfig.parse_cli(argv)
    except (Exception, SystemExit) as e:
        with pytest.raises(type(e)):
            tconfig.parse_cli(argv)
        return
    got, gargs = tconfig.parse_cli(argv)
    assert _flat(got) == _flat(want)
    assert vars(gargs) == dict(vars(wargs), device=None)


def test_parse_cli_config_file_and_device(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"engine.k": 12, "run.epochs": 3}))
    argv = ["--preset", "kitti", "--config", str(path), "--set", "engine.k=20"]
    got, _ = tconfig.parse_cli(argv + ["--device", "cpu"])
    assert _flat(got) == _flat(jconfig.parse_cli(argv)[0]) and got.engine.k == 20


def test_synthetic_batches_match():
    cfg = tconfig.parse_cli(SYNTH)[0]
    got = list(tcli._synthetic_batches(cfg))
    want = list(jcli._synthetic_batches(jconfig.parse_cli(SYNTH)[0]))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _train(tmp_path, tag, epochs, resume=False):
    d = tmp_path / tag
    return tcli.main(["train", "--device", "cpu", *SYNTH, f"run.epochs={epochs}",
                      f"run.checkpoint_dir={d}/ckpt", f"run.log_path={d}/log.jsonl",
                      f"run.resume={str(resume).lower()}"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs in one run, and one epoch then a resumed second."""
    tmp = tmp_path_factory.mktemp("train")
    whole = _train(tmp, "whole", 2)
    _train(tmp, "split", 1)
    resumed = _train(tmp, "split", 1, resume=True)
    return tmp, whole, resumed


def test_cli_train_logs_and_resumes(trained):
    tmp, whole, resumed = trained
    rows = [json.loads(line) for line in open(tmp / "whole" / "log.jsonl")]
    # the JAX CLI's keys: the epoch, LossBreakdown's fields, the epoch's seconds
    want = {"epoch", "epoch_seconds", *jlosses.LossBreakdown._fields}
    assert [r["epoch"] for r in rows] == [0, 1] and all(set(r) == want for r in rows)
    assert all(np.isfinite(r["total"]) for r in rows)
    assert tckpt.TrainCheckpointer(str(tmp / "whole" / "ckpt")).steps() == [4, 8]
    assert whole.step == resumed.step == 8
    sd, sr = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(sd[k], sr[k]) for k in sd)


def test_cli_export_loads_in_jax_to_equal_arrays(trained, tmp_path):
    """The port's `cli export` of a port-trained TrainCheckpointer directory,
    read by the JAX package's converter: the port's state_dict exactly."""
    tmp, whole, _ = trained
    out = str(tmp_path / "exported.pth")
    tcli.main(["export", "--device", "cpu", *SYNTH, "--checkpoint", str(tmp / "whole" / "ckpt"),
               "--out", out, "--epoch", "7"])
    ck = torch.load(out, map_location="cpu", weights_only=False)
    assert ck["epoch"] == 7
    assert set(ck) >= {"egnn_state_dict", "cross_attention_state_dict", "optimizer_state_dict"}
    flax = jckpt.convert_reference_checkpoint(out, n_layers=LAYERS, num_heads=2, hidden=16)
    got, want = tckpt.params_from_jax(flax), whole.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


EVAL_CASES = {
    "3dmatch": (["--preset", "3dmatch", "--set", "engine.top_k=64"], dict(
        in_node_nf=32, hidden_nf=32, num_heads=4)),
    "3dmatch-robust": (["--preset", "3dmatch", "--robust", "--set", "engine.top_k=64"], dict(
        in_node_nf=32, hidden_nf=32, num_heads=4)),
    "kitti": (["--preset", "kitti", "--set", f"engine.top_k={N}"], dict(
        in_node_nf=33, hidden_nf=33, num_heads=1)),
}


@functools.lru_cache(maxsize=None)
def _eval_params(**width):
    """Seeded flax eval params at one width (the two 3dmatch cases share
    them; a JAX init compiles for seconds)."""
    jcfg = jengine.EngineConfig(num_nodes=N, n_layers=LAYERS, **width)
    return jax_model_params(jcfg, "eval_fusion", seed=1)[1]


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_cli_eval_matches_jax_on_a_jax_exported_pth(case, tmp_path, monkeypatch):
    """The JAX exporter writes a `.pth` from seeded flax params; `cli eval`
    of the port (`--device cpu`) and of the JAX package on that file, over
    one dataset root in the reference's format, give the same summary."""
    argv, width = EVAL_CASES[case]
    dataset = "kitti" if case == "kitti" else "3dmatch"
    root = write_pair_root(str(tmp_path / "root"), dataset, n_pairs=(0, 0, 4), n_pts=400,
                           feat_dim=33 if dataset == "kitti" else 64, seed=3, inlier_ratio=0.6)
    params = _eval_params(**width)
    pth = str(tmp_path / "model.pth")
    jckpt.export_reference_checkpoint(params, pth, n_layers=LAYERS,
                                      num_heads=width["num_heads"], hidden=width["hidden_nf"])
    args = [*argv, *SMALL, "data.legacy_sampling_rng=true", f"data.root={root}",
            "--checkpoint", pth]
    summaries = []
    real = jengine.evaluate
    monkeypatch.setattr(jengine, "evaluate", lambda *a, **k: summaries.append(real(*a, **k)))
    jcli.main(["eval", *args, "--set", f"run.eval_output={tmp_path}/jax/eval.txt"])
    got = tcli.main(["eval", "--device", "cpu", *args,
                     "--set", f"run.eval_output={tmp_path}/port/eval.txt"])
    (want,) = summaries
    assert list(got) == list(want) and got["num_pairs"] == want["num_pairs"] == 4
    for key, tol in (("avg_rotation_error_deg", 2e-2), ("avg_translation_error_cm", 1e-3),
                     ("avg_registration_recall", 1e-6), ("avg_precision", 1e-6),
                     ("avg_f1", 1e-6)):
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])
    assert open(f"{tmp_path}/port/eval.txt").read().startswith("Average Rotation Error:")


def test_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    # an orbax directory of the JAX package: named, not guessed at
    orbax = str(tmp_path / "orbax")
    jckpt.TrainCheckpointer(orbax).save(3, {"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="orbax"):
        tcli.main(["export", "--device", "cpu", *SYNTH, "--checkpoint", orbax,
                   "--out", str(tmp_path / "x.pth")])
    with pytest.raises(FileNotFoundError):
        tcli.main(["eval", "--device", "cpu", *SYNTH, "--checkpoint", str(tmp_path / "none")])
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tcli.main(["train", "--device", "cpu", *SYNTH, "run.point_parallel=2"])
    # a model variant runs on the whole-cloud graph; the curve window refuses it
    for extra in ("engine.direction=cluster", "engine.use_pointnet=true"):
        with pytest.raises(ValueError, match="knn_method='exact'"):
            tcli.main(["train", "--device", "cpu", *SYNTH, extra, "engine.knn_method=morton",
                       f"run.checkpoint_dir={tmp_path}/ck"])
    with pytest.raises(SystemExit):
        tcli.main(["eval", "--device", "cpu", *SYNTH])
    with pytest.raises(SystemExit):
        tcli.main(["serve"])
    # no device asked and no card: the command raises before it runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["train", *SYNTH, f"run.checkpoint_dir={tmp_path}/ck2"])


@pytest.mark.parametrize("extra", ["engine.direction=cluster", "engine.bf16_params=true"])
def test_cli_trains_evaluates_and_exports_a_model_variant(extra, tmp_path):
    """`cli train` one epoch on the synthetic preset with a model variant,
    then `cli eval` of its checkpoint directory, which reads the trained
    weights back (the summary equals `engine.evaluate` of the trained model
    on the same batches, exactly), and `cli export` (fp32 tensors)."""
    d = str(tmp_path)
    state = tcli.main(["train", "--device", "cpu", *SYNTH, extra, "run.epochs=1",
                       f"run.checkpoint_dir={d}/ck", f"run.log_path={d}/log.jsonl"])
    assert state.step == 4
    bf16 = extra == "engine.bf16_params=true"
    assert {p.dtype for p in state.model.parameters()} == {
        torch.bfloat16 if bf16 else torch.float32}
    assert (state.optimizer.sr is not None) == bf16
    if bf16:
        assert all(m.dtype == torch.float32 for m in state.optimizer.sr.master)
    got = tcli.main(["eval", "--device", "cpu", "--checkpoint", f"{d}/ck", *SYNTH, extra,
                     f"run.eval_output={d}/eval.txt"])
    cfg = tconfig.parse_cli(SYNTH + [extra])[0]
    model = tengine.build_model(cfg.engine, head_mode="eval_fusion", device="cpu")
    model.load_state_dict(state.model.state_dict())
    want = tengine.evaluate(model, cfg.engine, tcli._synthetic_batches(cfg))
    assert got == want and got["num_pairs"] == 8
    assert all(np.isfinite(v) for v in got.values())
    tcli.main(["export", "--device", "cpu", "--checkpoint", f"{d}/ck", "--out", f"{d}/x.pth",
               *SYNTH, extra])
    ca = torch.load(f"{d}/x.pth", weights_only=False)["cross_attention_state_dict"]
    assert {v.dtype for k, v in ca.items() if "num_batches" not in k} == {torch.float32}


def test_cli_imports_no_jax(tmp_path):
    """`cli train` and `eval` in a process where importing jax fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from se3_equi_graph_registration_tpu_torch.train import cli\n"
            f"argv = {SYNTH!r} + ['run.epochs=1', 'run.checkpoint_dir=ck', "
            "'run.log_path=log.jsonl', 'run.eval_output=eval.txt']\n"
            "cli.main(['train', '--device', 'cpu'] + argv)\n"
            "cli.main(['eval', '--device', 'cpu', '--checkpoint', 'ck'] + argv)\n"
            "bad = [m for m, v in sys.modules.items() if v is not None and (m.startswith('jax') "
            "or m.split('.')[0] == 'se3_equi_graph_registration_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert os.path.exists(tmp_path / "eval.txt")
