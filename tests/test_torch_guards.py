"""Guards of the port: it imports no jax and nothing of the JAX package, and
its entry points never carry on quietly on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu_torch.ops.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "se3_equi_graph_registration_tpu_torch",
    "se3_equi_graph_registration_tpu_torch.serving",
    "se3_equi_graph_registration_tpu_torch.train.engine",
    "se3_equi_graph_registration_tpu_torch.train.checkpoints",
    "se3_equi_graph_registration_tpu_torch.train.losses",
    "se3_equi_graph_registration_tpu_torch.ops.kernels.egcl_backward",
    "se3_equi_graph_registration_tpu_torch.core.se3",
    "se3_equi_graph_registration_tpu_torch.data.synthetic",
    "se3_equi_graph_registration_tpu_torch.data.pipeline",
    "se3_equi_graph_registration_tpu_torch.registration",
    "se3_equi_graph_registration_tpu_torch.ops.kernels.spfh",
    "se3_equi_graph_registration_tpu_torch.ops.fpfh",
    "se3_equi_graph_registration_tpu_torch.ops.icp",
    "se3_equi_graph_registration_tpu_torch.ops.voxel",
    "se3_equi_graph_registration_tpu_torch.core.quaternions",
    "se3_equi_graph_registration_tpu_torch.core.se3_np",
    "se3_equi_graph_registration_tpu_torch.train.config",
    "se3_equi_graph_registration_tpu_torch.train.cli",
    "se3_equi_graph_registration_tpu_torch.data.threedmatch",
    "se3_equi_graph_registration_tpu_torch.data.kitti",
    "se3_equi_graph_registration_tpu_torch.data.redwood",
    "se3_equi_graph_registration_tpu_torch.utils.trajectory",
    "se3_equi_graph_registration_tpu_torch.utils.timer",
    "se3_equi_graph_registration_tpu_torch.utils.logging",
    "se3_equi_graph_registration_tpu_torch.utils.debugging",
    "se3_equi_graph_registration_tpu_torch.native.max_clique",
    "se3_equi_graph_registration_tpu_torch.models.pointnet",
    "se3_equi_graph_registration_tpu_torch.utils.bf16_training",
    "se3_equi_graph_registration_tpu_torch.data.preprocess.pairs",
    "se3_equi_graph_registration_tpu_torch.data.preprocess.split",
    "se3_equi_graph_registration_tpu_torch.data.preprocess.threedmatch_cli",
    "se3_equi_graph_registration_tpu_torch.data.preprocess.kitti_cli",
    "se3_equi_graph_registration_tpu_torch.tools",
    "se3_equi_graph_registration_tpu_torch.tools.eval_files",
    "se3_equi_graph_registration_tpu_torch.tools.multiway",
    "se3_equi_graph_registration_tpu_torch.ops.pose_graph",
    "se3_equi_graph_registration_tpu_torch.tools.stats",
    "se3_equi_graph_registration_tpu_torch.tools.grad_budget",
    "se3_equi_graph_registration_tpu_torch.tools.scenario_table",
    "se3_equi_graph_registration_tpu_torch.parallel",
    "se3_equi_graph_registration_tpu_torch.parallel.mesh",
    "se3_equi_graph_registration_tpu_torch.parallel.distributed",
    "se3_equi_graph_registration_tpu_torch.parallel.point_sharding",
    "se3_equi_graph_registration_tpu_torch.parallel.dryrun",
    "se3_equi_graph_registration_tpu_torch.models.egnn",
    "se3_equi_graph_registration_tpu_torch.ops.morton",
    "se3_equi_graph_registration_tpu_torch.ops.knn",
    "se3_equi_graph_registration_tpu_torch.ops.kernels.knn",
    "se3_equi_graph_registration_tpu_torch.ops.kernels.build",
    "se3_equi_graph_registration_tpu_torch.ops.kabsch",
    "se3_equi_graph_registration_tpu_torch.utils.nn_extras",
    "se3_equi_graph_registration_tpu_torch.utils.reversible",
    "se3_equi_graph_registration_tpu_torch.core.so3_basis",
    "se3_equi_graph_registration_tpu_torch.core.so3_basis.basis",
    "se3_equi_graph_registration_tpu_torch.core.so3_basis.spherical_harmonics",
    "se3_equi_graph_registration_tpu_torch.core.so3_basis.wigner",
    "se3_equi_graph_registration_tpu_torch.models.variants",
    "se3_equi_graph_registration_tpu_torch.tools.viz",
    "se3_equi_graph_registration_tpu_torch.examples",
    "se3_equi_graph_registration_tpu_torch.examples.register_pair",
    "se3_equi_graph_registration_tpu_torch.examples.global_registration",
    "se3_equi_graph_registration_tpu_torch.examples.denoise",
    "se3_equi_graph_registration_tpu_torch.examples.multihost_train",
]


@pytest.fixture(scope="module")
def imported_jax():
    """{module: the jax and JAX-package modules loaded once it is imported},
    from one fresh interpreter that imports PORT_MODULES in order: a module
    that pulls one in shows it, and so does every module after it."""
    code = ("import importlib, json, sys\n"
            "out = {}\n"
            f"for name in {PORT_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "    out[name] = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or "
            "m == 'se3_equi_graph_registration_tpu' or "
            "m.startswith('se3_equi_graph_registration_tpu.')]\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", PORT_MODULES)
def test_import_pulls_in_no_jax(module, imported_jax):
    assert imported_jax[module] == [], imported_jax[module]


@pytest.mark.parametrize("script", ["chip_smoke.py", "spfh_sweep.py", "egcl_f32_sweep.py",
                                    "egcl_f32_numerics.py", "egcl_tile_sweep.py"])
def test_card_scripts_import_no_jax(script):
    """The scripts run on the card machine, which has no jax: no import
    statement in them, at any depth, names jax or the JAX package."""
    import ast

    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "se3_equi_graph_registration_tpu")]
    assert names and not bad, bad


TOOLKIT_HEADERS = ("cuda_runtime.h", "math_constants.h", "cuda_bf16.h", "climits", "cstdint",
                   "stdint.h")


@pytest.mark.parametrize("source", build.SOURCES)
def test_kernel_sources_build_from_the_checkout_and_the_cuda_toolkit_alone(source):
    """Every kernel the card builds (`build.SOURCES`, the large-k k-NN
    `knn_exact_large` among them) is a source under csrc/ that includes only
    the CUDA toolkit's and the C++ library's headers and csrc/'s own, and
    names nothing of jax."""
    import re

    assert "knn_exact_large" in build.SOURCES
    seen, todo = set(), [f"{source}.cu"]
    while todo:
        name = todo.pop()
        seen.add(name)
        with open(os.path.join(build.CSRC, name)) as f:
            text = f.read()
        assert "jax" not in text.lower(), name
        for quote, header in re.findall(r'#include\s*([<"])([^>"]+)[>"]', text):
            if quote == "<":
                assert header in TOOLKIT_HEADERS, (name, header)
            elif header not in seen:
                assert os.path.exists(os.path.join(build.CSRC, header)), (name, header)
                todo.append(header)


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.train import engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = engine.fast_tpu_config(num_nodes=128, k=8, in_node_nf=8, hidden_nf=8,
                                 n_layers=1, num_heads=2, top_k=16)
    sd = engine.build_model(cfg, "eval_fusion", device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Registrar(sd, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.Registrar(sd, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.init_state(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.batch_to_device((None,) + (np.zeros((1, 4)),) * 6)
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops import fpfh

    pts = np.random.default_rng(0).uniform(-1, 1, (256, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        registration.register_fpfh(pts, pts, n_points=256)
    with pytest.raises(RuntimeError, match="CUDA"):
        registration.register_fpfh_batch(pts[None], pts[None])
    with pytest.raises(RuntimeError, match="CUDA"):
        fpfh.extract_fpfh_native(pts, voxel_size=0.1)
    R, _, _ = registration.register_fpfh(pts, pts, n_points=256, window=256, device="cpu",
                                         knn_method="fused", knn_packed="chunked")
    assert np.all(np.isfinite(R)) and abs(np.linalg.det(R) - 1) < 1e-4
    reg = serving.Registrar(sd, cfg, device="cpu")
    rng = np.random.default_rng(0)
    R, t, info = reg.register(rng.uniform(-1, 1, (128, 3)), rng.standard_normal((128, 8)),
                              rng.uniform(-1, 1, (128, 3)), rng.standard_normal((128, 8)))
    assert np.all(np.isfinite(R)) and abs(np.linalg.det(R) - 1) < 1e-4

    # the offline data path and the pose graph
    from se3_equi_graph_registration_tpu_torch.data.preprocess import kitti_cli, pairs
    from se3_equi_graph_registration_tpu_torch.ops import pose_graph
    from se3_equi_graph_registration_tpu_torch.tools import multiway

    eye = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    edges = np.array([(0, 1), (1, 2)], np.int32)
    graph = (eye[:, :3, :3], eye[:, :3, 3], edges, eye[:2, :3, :3], eye[:2, :3, 3])
    logs = [{"0_1": np.eye(4), "1_2": np.eye(4)}]
    with pytest.raises(RuntimeError, match="CUDA"):
        pose_graph.optimize_pose_graph(*graph)
    with pytest.raises(RuntimeError, match="CUDA"):
        pose_graph.optimize_trajectory(eye, edges, eye[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        multiway.optimize_logs(logs)
    with pytest.raises(RuntimeError, match="CUDA"):
        pairs.extract_fpfh(pts, voxel_size=0.1, backend="native")
    (tmp_path / "velodyne").mkdir()
    for i in range(2):
        np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).tofile(
            tmp_path / "velodyne" / f"{i:06d}.bin")
    np.savetxt(tmp_path / "poses.txt", np.tile(np.eye(4)[:3].reshape(1, -1), (2, 1)))
    seq = (str(tmp_path / "velodyne"), str(tmp_path / "poses.txt"), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA"):
        kitti_cli.make_sequence_pairs(*seq, frame_step=1, voxel_size=0.2)
    R, t = pose_graph.optimize_pose_graph(*graph, device="cpu")
    assert R.device.type == "cpu" and torch.isfinite(R).all() and torch.isfinite(t).all()
    assert pose_graph.optimize_trajectory(eye, edges, eye[:2], device="cpu").shape == (3, 4, 4)
    assert set(multiway.optimize_logs(logs, device="cpu")) == {"0_0", "0_1", "0_2"}
    assert pairs.extract_fpfh(pts, voxel_size=0.1, backend="native", device="cpu")[1].shape[1] \
        == 33
    assert kitti_cli.make_sequence_pairs(*seq, frame_step=1, voxel_size=0.2, device="cpu") == 1


def test_knn_wrappers_reject_a_kernel_variant_as_they_reject_a_bad_geometry():
    """`variant` names a CUDA kernel (to compare the warp and thread kernels
    on the card): on a CPU tensor, or where that kernel does not exist, the
    wrappers raise ValueError before any work, as for a bad geometry."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn

    x = torch.zeros(1, 512, 3)
    with pytest.raises(ValueError):
        knn.knn_window(x, 8, 100, 200, packed=True)                 # bad geometry
    for variant in ("thread", "warp"):
        with pytest.raises(ValueError, match="CPU tensor"):
            knn.knn_window(x, 8, 128, 384, packed=True, variant=variant)
        with pytest.raises(ValueError, match="CPU tensor"):
            knn.knn_chunked(x, 8, 128, 256, variant=variant)
    for window in (384, None):           # exact keys: the warp kernel exists, not on the CPU
        assert knn.knn_variant(False, window, 8) == "warp"
        with pytest.raises(ValueError, match="CPU tensor"):
            knn.knn_window(x, 8, 128, window, packed=False, variant="warp")
    with pytest.raises(ValueError, match="CPU tensor"):               # exact, k > 128: the
        knn.knn_window(x, 200, 128, 384, packed=False, variant="warp")  # large-k warp kernel
    with pytest.raises(ValueError, match="no 'warp'"):
        knn.knn_window(x, 8, 128, None, packed=True, variant="warp")    # packed, whole cloud
    with pytest.raises(ValueError, match="no 'simt'"):
        knn.knn_chunked(x, 8, 128, 256, variant="simt")
    assert knn.knn_window(x, 8, 128, 384, packed=True).shape == (1, 512, 8)


def test_spfh_wrapper_rejects_a_kernel_variant_on_a_cpu_tensor():
    """`variant` names a CUDA kernel of B5 ('redux', the packed-count kernel
    every launch takes by default, or 'ballot', the kernel kept to compare):
    a CPU tensor takes the plain version and raises on any variant, an
    unknown variant raises, and the plain path counts no launch."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import spfh

    assert spfh.VARIANTS == ("redux", "ballot")
    assert set(spfh.spfh.launches_by_variant) == set(spfh.VARIANTS)
    x = torch.rand(1, 256, 3)
    nrm = torch.nn.functional.normalize(torch.rand(1, 256, 3), dim=-1)
    nbr = torch.randint(0, 256, (1, 256, 16), dtype=torch.int32)
    for variant in spfh.VARIANTS:
        with pytest.raises(ValueError, match="CPU tensor"):
            spfh.spfh(x, nrm, nbr, 128, 256, variant=variant)
    with pytest.raises(ValueError, match="no 'warp' SPFH kernel"):
        spfh.spfh(x, nrm, nbr, 128, 256, variant="warp")
    before = (spfh.spfh.launches, dict(spfh.spfh.launches_by_variant))
    out, dist = spfh.spfh(x, nrm, nbr, 128, 256)
    assert out.shape == (1, 256, 33) and dist.shape == (1, 256, 16)
    assert (spfh.spfh.launches, spfh.spfh.launches_by_variant) == before


def test_engine_rejects_unported_modes():
    from se3_equi_graph_registration_tpu_torch.train import engine

    for bad in (dict(knn_method="kd-tree"), dict(egnn_impl="triton")):
        with pytest.raises(ValueError):
            engine.build_model(engine.EngineConfig(**bad), device="cpu")
    # the model variants build on the whole-cloud graph; the curve window is
    # the fused kernel's path and refuses them, naming the graph that runs them
    variants = (dict(direction="cluster"), dict(so3_mode="invariant"), dict(use_pointnet=True))
    for variant in variants + (dict(bf16_params=True),):
        engine.build_model(engine.EngineConfig(**variant), device="cpu")
    for variant in variants:
        with pytest.raises(ValueError, match="knn_method='exact'"):
            engine.build_model(engine.fast_tpu_config(**variant), device="cpu")
    engine.build_model(engine.fast_tpu_config(bf16_params=True), device="cpu")
    for bad in (dict(direction="sideways"), dict(so3_mode="euler")):
        with pytest.raises(ValueError):
            engine.build_model(engine.EngineConfig(**bad), device="cpu")
    engine.build_model(engine.fast_tpu_config(num_nodes=128, remat=True), device="cpu")
    # a field neither package has, and the JAX package's fields that the port
    # reads nowhere (train/config.py drops them from a config file)
    for absent in (dict(nonsense=True), dict(onehot_h_permute=True), dict(knn_recall=0.95),
                   dict(topk_method="approx")):
        with pytest.raises(TypeError):
            engine.fast_tpu_config(**absent)


def test_seeded_init_is_reproducible():
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine

    cfg = engine.EngineConfig(num_nodes=128, k=8, in_node_nf=8, hidden_nf=8,
                              n_layers=1, num_heads=2, top_k=16)
    sds = []
    for _ in range(2):
        m = engine.build_model(cfg, device="cpu")
        checkpoints.init_weights(m, torch.Generator().manual_seed(7))
        sds.append(m.state_dict())
    for k in sds[0]:
        assert torch.equal(sds[0][k], sds[1][k]), k
    assert sds[0]["egnn.gcl_0.coord_mlp_out.weight"].abs().max() < 1e-3


@pytest.mark.parametrize("overrides", [
    dict(knn_method="exact"), dict(knn_method="approx", egnn_impl="pallas"),
    dict(knn_method="pallas", egnn_impl="pallas"),
    dict(knn_method="morton", knn_packed=True, egnn_accurate=False),
    dict(knn_method="morton", knn_packed=False, curve="morton"),
], ids=["exact", "approx", "pallas", "morton-packed-fast", "morton-exact-window"])
def test_every_engine_config_goes_through_both_kernel_wrappers(monkeypatch, overrides):
    """No configuration picks a plain path by itself: each register() calls
    the k-NN wrapper once per cloud and the EGCL wrapper once per layer and
    cloud, so on the card each configuration launches both kernels."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.train import engine

    calls = {"knn": 0, "egcl": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(engine, "knn_window", spy("knn", engine.knn_window))
    monkeypatch.setattr(egcl, "egcl_layer", spy("egcl", egcl.egcl_layer))
    cfg = engine.EngineConfig(num_nodes=256, k=8, in_node_nf=8, hidden_nf=8, n_layers=2,
                              num_heads=2, top_k=16, **overrides)
    sd = engine.build_model(cfg, "eval_fusion", device="cpu").state_dict()
    reg = serving.Registrar(sd, cfg, device="cpu")
    rng = np.random.default_rng(1)
    R, _, _ = reg.register(rng.uniform(-1, 1, (2, 256, 3)), rng.standard_normal((2, 256, 8)),
                           rng.uniform(-1, 1, (2, 256, 3)), rng.standard_normal((2, 256, 8)))
    assert calls == {"knn": 2, "egcl": 2 * cfg.n_layers}
    assert np.all(np.isfinite(R))


@pytest.mark.parametrize("accurate", [True, False], ids=["accurate", "fast"])
def test_train_step_goes_through_all_three_kernel_wrappers(monkeypatch, accurate):
    """One train step calls the k-NN wrapper once per cloud, the EGCL forward
    wrapper and the EGCL backward wrapper once per layer and cloud, so on the
    card the step launches all three kernels."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, egcl_backward
    from se3_equi_graph_registration_tpu_torch.train import engine

    calls = {"knn": 0, "egcl": 0, "egcl_backward": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(engine, "knn_window", spy("knn", engine.knn_window))
    monkeypatch.setattr(egcl, "egcl_layer", spy("egcl", egcl.egcl_layer))
    monkeypatch.setattr(egcl_backward, "egcl_backward",
                        spy("egcl_backward", egcl_backward.egcl_backward))
    cfg = engine.fast_tpu_config(num_nodes=256, k=8, in_node_nf=8, hidden_nf=8, n_layers=2,
                                 num_heads=2, top_k=16, egnn_accurate=accurate)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = engine.make_train_step(state.model, state.optimizer, cfg)
    pb = make_pair_batch(np.random.default_rng(2), batch=2, n=256, feat_dim=8)
    before = [p.detach().clone() for p in state.model.parameters()]
    state, m = step(state, engine.batch_to_device(tuple(pb), "cpu"))
    assert calls == {"knn": 2, "egcl": 2 * cfg.n_layers, "egcl_backward": 2 * cfg.n_layers}
    assert np.isfinite(float(m["total"])) and state.step == 1
    assert all(not torch.equal(a, b) for a, b in zip(before, state.model.parameters()))


@pytest.mark.parametrize("knobs,want", [
    (dict(knn_method="fused", knn_packed="chunked"), dict(chunked=2, window=0, spfh=2)),
    (dict(knn_method="fused", knn_packed=True), dict(chunked=0, window=2, spfh=2)),
    (dict(knn_method="fused", knn_packed=False, coarse="spectral"),
     dict(chunked=0, window=2, spfh=2)),
    (dict(knn_method="window"), dict(chunked=0, window=2, spfh=0)),
    (dict(knn_method="exact", coarse="fgr"), dict(chunked=0, window=2, spfh=0)),
    (dict(knn_method="approx", icp_mode="gicp"), dict(chunked=0, window=2, spfh=0)),
], ids=["fused-chunked", "fused-packed", "fused-exact", "window", "exact", "approx"])
@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batch3"])
def test_register_fpfh_goes_through_the_kernel_wrappers(monkeypatch, knobs, want, batch):
    """One call, single or batched, calls each k-NN wrapper once per cloud
    side and (fused) the SPFH wrapper once per cloud side: fused/chunked
    runs B4 and B5 twice each and B1 never, so on the card every mode
    launches its kernels."""
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn, spfh

    calls = dict(chunked=0, window=0, spfh=0)

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(knn, "knn_chunked", spy("chunked", knn.knn_chunked))
    monkeypatch.setattr(knn, "knn_window", spy("window", knn.knn_window))
    monkeypatch.setattr(spfh, "spfh", spy("spfh", spfh.spfh))
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    pts[..., 2] *= 0.2
    kw = dict(window=256, device="cpu", top_m=128, hypotheses=64, **knobs)
    if batch is None:
        R, _, _ = registration.register_fpfh(pts[0], pts[1], n_points=256, **kw)
    else:
        R, _, _ = registration.register_fpfh_batch(np.repeat(pts[:1], batch, 0),
                                                   np.repeat(pts[1:], batch, 0), **kw)
    assert calls == want
    assert np.all(np.isfinite(R))


def test_register_fpfh_rejects_unported_options(monkeypatch):
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.parallel.mesh import Mesh, make_mesh

    pts = np.zeros((256, 3), np.float32)
    with pytest.raises(ValueError, match="must end at 0.0"):
        registration.register_fpfh(pts, pts, n_points=256, icp_voxels=(0.05, 0.02),
                                   device="cpu")
    # a mesh is a parallel.mesh.Mesh; one with a point axis splits the pairs
    # over its 'data' axis only (the JAX P('data')): each point rank of a
    # data row runs the row's pairs whole
    with pytest.raises(TypeError, match="mesh must be"):
        registration.register_fpfh_batch(pts[None], pts[None], mesh=object(), device="cpu")
    seen = []

    def core(src, tgt, noise, **kw):
        seen.append(src)
        b, n = src.shape[:2]
        return (torch.eye(3).expand(b, 3, 3), src[:, 0], torch.zeros(b, n),
                torch.zeros(b, 6, 6))

    monkeypatch.setattr(registration, "_register_core", core)
    src = np.arange(3, dtype=np.float32)[:, None, None] * np.ones((3, 256, 3), np.float32)
    mesh = Mesh({"data": 1, "point": 2}, 1, None, None)
    assert mesh.axis_index("point") == 1
    for m in (make_mesh({"data": 1, "point": 1}), mesh):
        _, t, _ = registration.register_fpfh_batch(src, src, device="cpu", mesh=m)
        assert torch.equal(seen.pop(), torch.from_numpy(src))
        np.testing.assert_array_equal(t[:, 0], [0, 1, 2])
    assert callable(registration.export_compiled) and callable(registration.load_exported)


@pytest.mark.parametrize("c,head_width,accurate,want", [
    (32, 8, True, "tile_f32"), (32, 8, False, "tile"), (32, 1, True, "tile_f32"),
    (32, 32, True, "tile_f32"), (33, 33, True, "tile_f32"), (33, 1, False, "tile"),
    (32, 12, True, "simt"), (32, 12, False, "simt"), (64, 8, True, "simt"),
    (37, 37, True, "simt"), (37, 37, False, "simt"), (33, 2, False, "simt"),
], ids=["c32-accurate", "c32-fast", "c32-32heads-accurate", "c32-1head-accurate",
        "c33-accurate", "c33-fast", "heads-not-dividing-32-accurate",
        "heads-not-dividing-32-fast", "c64-accurate", "c37-accurate", "c37-fast",
        "heads-not-dividing-33-fast"])
def test_egcl_variant_names_one_kernel_per_shape_and_mode(c, head_width, accurate, want):
    """Accurate mode at C=32 and at 32 < C <= 36 with whole heads runs the
    fp32 tile kernels (padded to 36 channels above 32), fast mode at the
    same widths the bf16 tile kernels (padded to 48 channels above 32),
    every other shape the SIMT kernels; `check_variant` returns that choice
    when asked for none."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    assert egcl.egcl_variant(c, 16, head_width, accurate) == want
    assert egcl.check_variant(None, c, 16, head_width, accurate) == want
    assert egcl.check_variant("simt", c, 16, head_width, accurate) == "simt"


@pytest.mark.parametrize("variant,c,head_width,accurate", [
    ("tile_f32", 32, 8, False), ("tile", 32, 8, True), ("tile_f32", 33, 33, False),
    ("tile", 33, 1, True), ("tile_f32", 32, 12, True), ("wgmma", 32, 8, True),
    ("tile_f32", 37, 37, True), ("tile", 37, 37, False), ("tile", 33, 2, False),
], ids=["f32-in-fast-mode", "bf16-in-accurate-mode", "f32-at-c33", "bf16-at-c33",
        "f32-heads-not-dividing-32", "unknown", "f32-above-the-padded-width",
        "bf16-above-the-padded-width", "bf16-heads-not-dividing-33"])
def test_a_kernel_variant_the_shape_lacks_raises(variant, c, head_width, accurate):
    """Asked for a kernel that the shape and mode do not have, both EGCL
    wrappers raise before any launch, on any device."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN

    with pytest.raises(ValueError, match=variant):
        egcl.check_variant(variant, c, 16, head_width, accurate)
    p = egcl.params_from_layer(EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=1,
                                    num_heads=1).gcl_0)._replace(head_width=head_width)
    h, x = torch.zeros(1, 32, c), torch.zeros(1, 32, 3)
    nbr = torch.zeros(1, 32, 16, dtype=torch.int32)
    why = f"{variant}|whole heads"          # heads that do not tile C fail the input check
    with pytest.raises(ValueError, match=why):
        egcl.launch_layer(h, x, nbr, p, accurate, variant=variant)
    with pytest.raises(ValueError, match=why):
        eb.launch_backward(h, x, nbr, p, torch.zeros(1, 32, c), torch.zeros(1, 32, 3),
                           accurate, variant=variant)


@pytest.mark.parametrize("heads", [1, 4, 32])
def test_fp32_weight_packing_round_trips(heads):
    """`pack_params_f32` holds every weight unrounded, the forward's blocks
    [in][out] (`unpack_params_f32` returns the layer) and the backward's
    the torch [out][in] weights, w1_geo padded with 4 zero inputs."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    egnn = EGNN(in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1, num_heads=heads)
    with torch.no_grad():
        for q in egnn.parameters():
            q.copy_(torch.randn(q.shape, generator=torch.Generator().manual_seed(q.numel())))
    p = egcl.params_from_layer(egnn.gcl_0)
    buf = egcl.pack_params_f32(p)
    assert buf.dtype == torch.float32 and buf.numel() == 12416 and buf.is_contiguous()
    back = egcl.unpack_params_f32(buf, p.head_width)
    for name in egcl.EGCLParams._fields[:-1]:
        assert torch.equal(getattr(back, name).reshape(getattr(p, name).shape),
                           getattr(p, name)), name
    assert back.head_width == p.head_width
    blocks, o = {}, 0
    for name, shape in egcl.F32_LAYOUT:
        blocks[name] = buf[o:o + int(torch.Size(shape).numel())].reshape(shape)
        o += blocks[name].numel()
    for name, w in (("wc0_t", p.wc0), ("w2_t", p.w2), ("w1hc_t", p.w1_hcol),
                    ("w1hr_t", p.w1_hrow)):
        assert torch.equal(blocks[name], w), name
    assert torch.equal(blocks["w1g_t"][:, :12], p.w1_geo)
    assert torch.count_nonzero(blocks["w1g_t"][:, 12:]) == 0
    assert o % 4 == 0 and all(s[-1] % 4 == 0 for _, s in egcl.F32_LAYOUT)  # float4 rows


def _kernel_sides(monkeypatch) -> list:
    """Run the EGCL wrappers' kernel side on CPU tensors: `launch_layer`,
    with the custom op's CUDA side `run_layer` in place of the op, and
    `launch_backward`, the launchers stubbed by the plain versions. Each
    launch appends (wrapper, variant) to the returned list and counts in the
    wrappers' `launches` / `launches_by_variant` (fresh, at 0)."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    launched = []

    def fake_fwd(variant):
        def run(h, x, nbr, buf, head_width, agg_m, accurate):
            launched.append(("egcl", variant))
            assert buf.numel() == 12416                # the fp32 tile layout
            p = egcl.unpack_params_f32(buf, head_width)
            out = egcl.egcl_layer_plain(h, x, nbr, p, accurate, return_aggm=True)
            if agg_m is not None:
                agg_m.copy_(out[2])
            return out[0], out[1]
        return run

    def fake_bwd(h, x, nbr, p, packed, dagg_m, dagg_x, variant, accurate):
        launched.append(("egcl_backward", variant))
        dh, dx, g = eb.egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate)
        flat = torch.cat([(g[n].T if g[n].ndim == 2 else g[n]).reshape(-1)
                          for n in eb.EDGE_PARAMS])
        return dh, dx, flat

    def kernel_side(launch, counters_of):
        def wrapped(*a, **kw):
            return launch(*a, **kw)
        wrapped.launches = 0
        wrapped.launches_by_variant = dict.fromkeys(counters_of, 0)
        return wrapped

    monkeypatch.setattr(egcl, "LAUNCHERS", {v: fake_fwd(v) for v in egcl.VARIANTS})
    monkeypatch.setattr(egcl, "layer_op", egcl.run_layer)   # the op's CUDA side, on CPU tensors
    monkeypatch.setattr(egcl, "egcl_layer", kernel_side(egcl.launch_layer, egcl.VARIANTS))
    monkeypatch.setattr(eb, "LAUNCH", fake_bwd)
    monkeypatch.setattr(eb, "egcl_backward", kernel_side(eb.launch_backward, egcl.VARIANTS))
    return launched


@pytest.mark.parametrize("path", ["register", "train_step"])
def test_default_config_entry_points_launch_only_the_fp32_tile_kernels(monkeypatch, path):
    """At `EngineConfig()` (accurate mode, C=32, 4 heads) every EGCL launch of
    `register()` and of a train step goes to the fp32 tile kernels: the
    wrappers' kernel side (`launch_layer`, with the custom op's CUDA side
    `run_layer` in place of the op, and `launch_backward`) runs on CPU
    tensors with the launchers stubbed by the plain versions, and records
    which kernel each launch would start."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import engine

    launched = _kernel_sides(monkeypatch)
    cfg = engine.EngineConfig(num_nodes=256)
    assert cfg.egnn_accurate and cfg.hidden_nf == 32 and cfg.num_heads == 4 and cfg.k == 16
    rng = np.random.default_rng(3)
    pb = make_pair_batch(rng, batch=1, n=256, feat_dim=cfg.in_node_nf)
    L = cfg.n_layers
    if path == "register":
        sd = engine.build_model(cfg, "eval_fusion", device="cpu").state_dict()
        R, _, _ = serving.Registrar(sd, cfg, device="cpu").register(
            pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
        assert np.all(np.isfinite(R))
        assert launched == [("egcl", "tile_f32")] * (2 * L)
        assert egcl.egcl_layer.launches_by_variant == {"tile": 0, "tile_f32": 2 * L, "simt": 0}
    else:
        state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = engine.make_train_step(state.model, state.optimizer, cfg)
        state, m = step(state, engine.batch_to_device(tuple(pb), "cpu"))
        assert np.isfinite(float(m["total"]))
        assert sorted(launched) == sorted([("egcl", "tile_f32")] * (2 * L)
                                          + [("egcl_backward", "tile_f32")] * (2 * L))
        assert eb.egcl_backward.launches_by_variant == {"tile": 0, "tile_f32": 2 * L,
                                                        "simt": 0}


@pytest.mark.parametrize("variant,path,want", [
    (dict(), "register", (2, 6, 0)),
    (dict(direction="cluster"), "register", (2, 0, 0)),
    (dict(so3_mode="invariant"), "register", (2, 0, 0)),
    (dict(bf16_params=True), "train_step", (2, 6, 6)),
    (dict(use_pointnet=True), "train_step", (2, 6, 6)),
], ids=["canonical", "cluster", "invariant", "bf16", "pointnet"])
def test_model_variants_route_as_the_jax_package_does(monkeypatch, variant, path, want):
    """The routing of the variants, counted at full depth (3 layers, C=32, 4
    heads, N=256): a `register()` at the canonical config launches B2 per
    layer and cloud; 'cluster' and 'invariant' run the plain EGNN (the JAX
    package sends them to its XLA EGNN) and launch no B2, but still the two
    whole-cloud k-NN graphs (B1); a train step with bf16 parameters or the
    PointNet encoder launches B1, B2 and B3. B2 and B3 count in the
    wrappers' launch counters through their kernel side (`_kernel_sides`),
    B1 by a spy on the engine's k-NN wrapper."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import engine

    _kernel_sides(monkeypatch)
    knn_calls = []
    knn = engine.knn_window
    monkeypatch.setattr(engine, "knn_window", lambda x, k, **kw: (
        knn_calls.append(kw.get("window")), knn(x, k, **kw))[1])
    cfg = engine.EngineConfig(num_nodes=256, **variant)
    pb = make_pair_batch(np.random.default_rng(3), batch=1, n=256, feat_dim=cfg.in_node_nf)
    if path == "register":
        sd = engine.build_model(cfg, "eval_fusion", device="cpu").state_dict()
        R, _, _ = serving.Registrar(sd, cfg, device="cpu").register(
            pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
        assert np.all(np.isfinite(R))
    else:
        state = engine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = engine.make_train_step(state.model, state.optimizer, cfg)
        state, m = step(state, engine.batch_to_device(tuple(pb), "cpu"))
        assert np.isfinite(float(m["total"]))
    assert (len(knn_calls), egcl.egcl_layer.launches, eb.egcl_backward.launches) == want
    assert knn_calls == [None, None]                 # whole-cloud graphs


# --- completeness: every module and public name of the JAX package and of
# examples/ has a counterpart in the port ---------------------------------

JAX_PKG = os.path.join(ROOT, "se3_equi_graph_registration_tpu")
PORT_PKG = os.path.join(ROOT, "se3_equi_graph_registration_tpu_torch")

# JAX module or "module::name" → the port's. Modules are paths inside the
# JAX package, or "examples/<script>.py" (whose twins live in the port's
# `examples/`); a module that is not listed keeps its path, a name its name.
RENAMED = {
    "ops/pallas/__init__.py": "ops/kernels/__init__.py",
    "ops/pallas/knn_kernel.py": "ops/kernels/knn.py",
    "ops/pallas/knn_kernel.py::knn_pallas": "ops/kernels/knn.py::knn_window",
    "ops/pallas/egcl_kernel.py": "ops/kernels/egcl.py",
    "ops/pallas/egcl_kernel.py::egcl_layer_pallas": "ops/kernels/egcl.py::egcl_layer",
    "ops/pallas/egcl_kernel.py::egnn_forward_pallas": "ops/kernels/egcl.py::egnn_forward",
    "ops/pallas/egcl_kernel.py::params_from_tree": "ops/kernels/egcl.py::params_from_layer",
    "ops/pallas/egcl_backward.py": "ops/kernels/egcl_backward.py",
    "ops/pallas/egcl_backward.py::egcl_backward_pallas":
        "ops/kernels/egcl_backward.py::egcl_backward",
    "ops/pallas/egcl_backward.py::egcl_fused_diff": "ops/kernels/egcl_backward.py::EGCLFunction",
    "ops/pallas/spfh_kernel.py": "ops/kernels/spfh.py",
    "ops/pallas/spfh_kernel.py::spfh_pallas": "ops/kernels/spfh.py::spfh",
    "native/max_clique.py::max_clique_heuristic_jax": "native/max_clique.py::max_clique_heuristic",
    "utils/bf16_training.py::bf16_sr_optimizer": "utils/bf16_training.py::Bf16SROptimizer",
    "utils/bf16_training.py::Bf16SRState": "utils/bf16_training.py::Bf16SROptimizer",
    "utils/compile_cache.py": "ops/kernels/build.py",
    "examples/scenario_table.py": "tools/scenario_table.py",
    "examples/multiway_registration.py": "tools/multiway.py",
}

# names dropped on purpose → why (ROADMAP.md, "Dropped on purpose")
DROPPED = {
    "Array": "the JAX package's alias of jax.Array for annotations; the port annotates "
             "torch.Tensor",
    "permute_rows_matmul": "a TPU workaround: a bf16 one-hot MXU gather that rounds h; the "
                           "port gathers exactly",
    "enable_compilation_cache": "JAX's XLA compile cache; ops/kernels/build.py names each "
                                "library by a hash of its sources and flags",
    "local_mesh_for_testing": "JAX's virtual-CPU mesh for tests; the port's tests build gloo "
                              "worlds of processes",
}


def _jax_modules():
    import glob

    found = sorted(os.path.relpath(p, JAX_PKG)
                   for p in glob.glob(os.path.join(JAX_PKG, "**", "*.py"), recursive=True))
    return found + sorted("examples/" + os.path.basename(p)
                          for p in glob.glob(os.path.join(ROOT, "examples", "*.py")))


def _top_level_names(path, with_imports=False):
    """The module's top-level def, class and assignment names (and, with
    `with_imports`, the names its imports bind)."""
    import ast

    with open(path) as f:
        body = ast.parse(f.read()).body
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(e.id for t in targets for e in ast.walk(t) if isinstance(e, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _jax_path(module):
    return os.path.join(ROOT, module) if module.startswith("examples/") else \
        os.path.join(JAX_PKG, module)


@pytest.mark.parametrize("module", _jax_modules())
def test_every_jax_module_and_public_name_has_a_counterpart(module):
    """The module's counterpart exists in the port, and so does each public
    top-level name: under its own name there, under its `RENAMED` name, or
    it is in `DROPPED`."""
    target = RENAMED.get(module, module)
    port_path = os.path.join(PORT_PKG, target)
    assert os.path.exists(port_path), f"{module}: no counterpart at {target}"
    have = _top_level_names(port_path, with_imports=True)
    missing = []
    for name in sorted(_top_level_names(_jax_path(module))):
        if name.startswith("_") or name in DROPPED:
            continue
        want = RENAMED.get(f"{module}::{name}", f"{target}::{name}")
        path, want_name = want.split("::")
        names = have if path == target else _top_level_names(os.path.join(PORT_PKG, path), True)
        if want_name not in names:
            missing.append(f"{name} (wanted {want})")
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_renamed_and_dropped_entries_name_real_jax_names():
    """No stale entry: each RENAMED key is a JAX module or one of its
    top-level names, and each DROPPED name is defined somewhere in the JAX
    package."""
    modules = set(_jax_modules())
    every = set()
    for m in modules:
        every |= _top_level_names(_jax_path(m))
    for key in RENAMED:
        module, _, name = key.partition("::")
        assert module in modules, key
        assert not name or name in _top_level_names(_jax_path(module)), key
    assert set(DROPPED) <= every, set(DROPPED) - every
