"""Guards of the port: it imports no jax and nothing of the JAX package, and
its entry points never carry on quietly on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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
]


@pytest.mark.parametrize("module", PORT_MODULES)
def test_import_pulls_in_no_jax(module):
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == "
            "'se3_equi_graph_registration_tpu' or m.startswith('se3_equi_graph_registration_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
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
    reg = serving.Registrar(sd, cfg, device="cpu")
    rng = np.random.default_rng(0)
    R, t, info = reg.register(rng.uniform(-1, 1, (128, 3)), rng.standard_normal((128, 8)),
                              rng.uniform(-1, 1, (128, 3)), rng.standard_normal((128, 8)))
    assert np.all(np.isfinite(R)) and abs(np.linalg.det(R) - 1) < 1e-4


def test_engine_rejects_unported_modes():
    from se3_equi_graph_registration_tpu_torch.train import engine

    for bad in (dict(knn_method="kd-tree"), dict(egnn_impl="triton")):
        with pytest.raises(ValueError):
            engine.build_model(engine.EngineConfig(**bad), device="cpu")
    for unported in (dict(refine_iters=5), dict(direction="cluster"),
                     dict(onehot_h_permute=True), dict(bf16_params=True),
                     dict(remat=True), dict(use_pointnet=True)):
        with pytest.raises(TypeError):
            engine.fast_tpu_config(**unported)


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
