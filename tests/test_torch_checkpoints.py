"""Weights in and out of the port: the reference `.pth` schema against the
JAX package's converter and exporter, `Registrar.from_checkpoint`, and
`TrainCheckpointer` under `fit`. Small model: C_in = C = 16, 2 layers, 2
heads, N = 512 for serving, 256 for training.

Tolerances: conversion, export and the round trip are exact (the same
float32 values, `torch.equal`); served poses at the accurate tolerances
of tests/test_torch_serving.py::_compare (R and t within 1e-4,
covariance 1e-3 relative, similarity mean 1e-4 relative); a resumed run
equals the uninterrupted one exactly (the same operations on the same
values in one process).
"""
import os

import numpy as np
import pytest
import torch
from test_torch_serving import _compare
from torch_port_util import jax_model_params, pair_batches

from se3_equi_graph_registration_tpu import serving as jserving
from se3_equi_graph_registration_tpu.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu.train import checkpoints as jckpt
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.train import checkpoints as tckpt
from se3_equi_graph_registration_tpu_torch.train import engine as tengine

N, C, LAYERS, HEADS = 512, 16, 2, 2
WIDTH = dict(in_node_nf=C, hidden_nf=C, n_layers=LAYERS, num_heads=HEADS)
SERVE = dict(k=16, top_k=32, **WIDTH)
SCHEMA = dict(n_layers=LAYERS, num_heads=HEADS, hidden=C)


@pytest.fixture(scope="module")
def jax_params():
    return jax_model_params(jengine.fast_tpu_config(num_nodes=N, **SERVE), "eval_fusion")[1]


@pytest.fixture(scope="module")
def jax_pth(jax_params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pth") / "jax.pth")
    jckpt.export_reference_checkpoint(jax_params, path, epoch=3, lr=2e-4, seed=5, **SCHEMA)
    return path


def _requests():
    pb = make_pair_batch(np.random.default_rng(11), batch=2, n=N, feat_dim=C)
    return pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat


def test_a_jax_exported_pth_loads_into_the_port(jax_params, jax_pth):
    """The port reads the file into the weights params_from_jax gives, and
    serves the pose JAX serves from the same weights."""
    sd = tckpt.convert_reference_checkpoint(jax_pth, **SCHEMA)
    ref = tckpt.params_from_jax(jax_params)
    assert set(sd) == set(ref)
    for k in ref:
        assert torch.equal(sd[k], ref[k]), k
    egnn = tckpt.convert_reference_egnn(jax_pth, **SCHEMA)
    EGNN(out_node_nf=C, **WIDTH).load_state_dict(egnn)                    # strict
    assert all(torch.equal(v, ref['egnn.' + k]) for k, v in egnn.items())
    cfg = dict(num_nodes=N, egnn_accurate=True, **SERVE)
    got = tserving.Registrar(sd, tengine.fast_tpu_config(**cfg), device="cpu")
    jreg = jserving.Registrar(jax_params, jengine.fast_tpu_config(**cfg))
    _compare(jreg.register(*_requests()), got.register(*_requests()), 1e-4, 1e-4, 1e-3, 1e-4)


def test_the_port_exporter_writes_what_the_jax_exporter_writes(jax_params, jax_pth, tmp_path):
    path = str(tmp_path / "port.pth")
    tckpt.export_reference_checkpoint(tckpt.params_from_jax(jax_params), path, epoch=3,
                                      lr=2e-4, seed=5, **SCHEMA)
    want = torch.load(jax_pth, weights_only=False)
    got = torch.load(path, weights_only=False)
    assert list(got) == list(want) and got["epoch"] == want["epoch"] == 3
    for part in ("egnn_state_dict", "cross_attention_state_dict"):
        assert list(got[part]) == list(want[part]), part
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and torch.equal(got[part][k], v), (part, k)
    assert got["optimizer_state_dict"] == want["optimizer_state_dict"]
    assert "shared_mlp_decoder.0.weight" in got["cross_attention_state_dict"]


def test_the_round_trip_is_exact(tmp_path):
    model = tengine.build_model(tengine.EngineConfig(num_nodes=256, **SERVE), device="cpu")
    tckpt.init_weights(model, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    path = str(tmp_path / "rt.pth")
    tckpt.export_reference_checkpoint(sd, path, **SCHEMA)
    back = tckpt.convert_reference_checkpoint(path, **SCHEMA)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    model.load_state_dict(back)                                     # strict


@pytest.mark.parametrize("extra", [{}, dict(icp_iters=5, icp_voxels=(0.3, 0.0))],
                         ids=["spectral+irls", "icp-pyramid"])
def test_from_checkpoint_robust_matches_jax_on_the_same_file(jax_pth, extra):
    kw = dict(SERVE, egnn_accurate=True, **extra)
    ref = jserving.Registrar.from_checkpoint(jax_pth, num_nodes=N, robust=True, **kw)
    got = tserving.Registrar.from_checkpoint(jax_pth, num_nodes=N, robust=True, device="cpu",
                                             **kw)
    assert got.cfg == tengine.robust_eval_config(num_nodes=N, **kw)
    assert got.device == torch.device("cpu")
    _compare(ref.register(*_requests()), got.register(*_requests()), 1e-4, 1e-4, 1e-3, 1e-4)


def test_pth_loading_is_strict(jax_pth, tmp_path):
    ck = torch.load(jax_pth, weights_only=False)
    del ck["cross_attention_state_dict"]["egnn.gcl_1.node_mlp.0.bias"]
    bad = str(tmp_path / "missing.pth")
    torch.save(ck, bad)
    with pytest.raises(KeyError):
        tserving.Registrar.from_checkpoint(bad, num_nodes=N, device="cpu", **SERVE)
    with pytest.raises(KeyError):         # a third layer the file lacks
        tserving.Registrar.from_checkpoint(jax_pth, num_nodes=N, device="cpu",
                                           **dict(SERVE, n_layers=3))
    with pytest.raises(RuntimeError, match="size mismatch"):   # 32 input channels, not 16
        tserving.Registrar.from_checkpoint(jax_pth, num_nodes=N, device="cpu",
                                           **dict(SERVE, in_node_nf=32))


TRAIN = dict(num_nodes=256, k=16, top_k=32, egnn_window=128, lr=3e-3, lr_step=3, **WIDTH)
TRAIN_OVERRIDES = {k: v for k, v in TRAIN.items() if k != "num_nodes"}


def _fit(state, cfg, batches, epochs, checkpointer=None):
    return tengine.fit(state.model, state.optimizer, cfg, state, lambda: batches,
                       epochs=epochs, val_batches=lambda: batches[:1],
                       checkpointer=checkpointer, checkpoint_every=1)


def _batches():
    return [(pb.corr, pb.labels, pb.src_pts, pb.tgt_pts, pb.src_feat, pb.tgt_feat, pb.gt_pose)
            for pb in pair_batches(5, 2)]


def test_fit_saves_and_resumes_through_train_checkpointer(tmp_path):
    """fit with a TrainCheckpointer writes step files; a fresh state restores
    the newest to the same parameters, Adam state, schedule and step, and one
    more epoch from there equals one more epoch of the run that never
    stopped."""
    cfg = tengine.fast_tpu_config(**TRAIN)
    batches = _batches()
    ckpt = tckpt.TrainCheckpointer(str(tmp_path / "run"), keep=2)
    state = _fit(tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu"),
                 cfg, batches, 3, ckpt)
    assert ckpt.steps() == [4, 6] and state.step == 6
    assert sorted(os.listdir(ckpt.directory)) == ["step_4.pt", "step_6.pt"]
    fresh = tengine.init_state(cfg, torch.Generator().manual_seed(9), device="cpu")
    restored, step = tckpt.TrainCheckpointer(ckpt.directory).restore_latest(fresh)
    assert step == 6 and restored.step == 6
    want = state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in restored.model.state_dict().items())
    assert restored.optimizer.schedule.state_dict() == state.optimizer.schedule.state_dict()
    assert restored.optimizer.adam.param_groups[0]["lr"] == state.optimizer.adam.param_groups[0]["lr"]
    _fit(state, cfg, batches, 1)
    _fit(restored, cfg, batches, 1)
    assert restored.step == state.step == 8
    want = state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in restored.model.state_dict().items())


def test_train_checkpointer_keeps_the_newest_and_saves_a_step_once(tmp_path):
    cfg = tengine.fast_tpu_config(**TRAIN)
    state = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    ckpt = tckpt.TrainCheckpointer(str(tmp_path), keep=2)
    assert ckpt.restore_latest(state) is None
    for step in (1, 2, 3):
        state.step = step
        assert ckpt.save(step, state, metrics={"val_loss": 1.0 / step})
    assert not ckpt.save(3, state) and not ckpt.save(2, state)
    assert ckpt.steps() == [2, 3]
    assert torch.load(ckpt._path(3), weights_only=True)["metrics"] == {"val_loss": 1.0 / 3}
    with pytest.raises(ValueError, match="keep"):
        tckpt.TrainCheckpointer(str(tmp_path), keep=0)


def test_from_checkpoint_reads_a_train_checkpointer_directory(tmp_path):
    cfg = tengine.fast_tpu_config(**TRAIN)
    state = tengine.init_state(cfg, torch.Generator().manual_seed(2), device="cpu")
    with pytest.raises(FileNotFoundError):
        tserving.Registrar.from_checkpoint(str(tmp_path / "empty"), num_nodes=256,
                                           device="cpu", **TRAIN_OVERRIDES)
    tckpt.TrainCheckpointer(str(tmp_path / "run")).save(1, state)
    got = tserving.Registrar.from_checkpoint(str(tmp_path / "run"), num_nodes=256,
                                             device="cpu", **TRAIN_OVERRIDES)
    want = tserving.Registrar(state.model.state_dict(), cfg, device="cpu")
    assert all(torch.equal(v, want.model.state_dict()[k])
               for k, v in got.model.state_dict().items())
    pb = make_pair_batch(np.random.default_rng(3), batch=1, n=256, feat_dim=C)
    args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
    (Rw, tw, iw), (Rg, tg, ig) = want.register(*args), got.register(*args)
    np.testing.assert_array_equal(Rg, Rw)
    np.testing.assert_array_equal(tg, tw)
    np.testing.assert_array_equal(ig["pose_covariance"], iw["pose_covariance"])


def test_reference_egnn_config_is_the_jax_packages():
    assert tckpt.REFERENCE_EGNN_CONFIG == jckpt.REFERENCE_EGNN_CONFIG
    model = EGNN(**tckpt.REFERENCE_EGNN_CONFIG)
    assert model.gcl_0.edge_mlp.fused_in.weight.shape == (32, 77)
