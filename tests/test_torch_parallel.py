"""Data parallelism over pairs in the port (`parallel/mesh.py`,
`parallel/distributed.py` and the `mesh` of `register_fpfh_batch`,
`Registrar`, `BatchingServer`, `fit` and `cli train`), on the CPU.

Single-process semantics first: `init_distributed` is a no-op, the mesh
helpers are the identity, a mesh's sizes must multiply to the world size,
a 'point' axis builds (its collectives are tests/test_torch_point_sharding.py's),
a store that cannot be reached raises.

Then one world of 2 ranks over gloo, spawned with torch.multiprocessing
once for the module (`_world`): each rank runs `cli train` at the synthetic
preset, a mesh Registrar at an odd batch (padding) and a BatchingServer
over it, `register_fpfh_batch` on a mesh at an odd batch, and 2 `fit` steps
on its half of the `tests/test_parallel.py` data-parallel setting
(EngineConfig(num_nodes=64, k=8, in_node_nf=16, hidden_nf=32, top_k=16),
B=8). The tests hold each rank's results against the same calls in this
process without a mesh.

Tolerances: the mesh Registrar and `register_fpfh_batch` run the same
per-pair math in batches of another size: R, t, the covariance and the
weights within 1e-5 (measured: equal bit for bit). `fit` on 2 ranks: the
ranks' parameters equal to each other exactly (one all-reduce gives both
the same sum), to the 1-process full-batch fit within 1e-5 (the gradients
are summed in another order; measured 1.2e-7) and to JAX's unsharded steps
within 1e-4 (measured 2.4e-7). The 2-rank `cli train` writes one
checkpoint, whose weights equal a 1-process run's within 1e-5.
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from se3_equi_graph_registration_tpu_torch import registration as treg
from se3_equi_graph_registration_tpu_torch import serving as tserving
from se3_equi_graph_registration_tpu_torch.data.pipeline import PairLoader
from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu_torch.parallel import (
    Mesh, data_sharding, gather_pairs, global_mesh, host_local_to_global, init_distributed,
    make_mesh, process_shard_info, replicated, shard_pair_batch)
from se3_equi_graph_registration_tpu_torch.parallel.mesh import check_mesh
from se3_equi_graph_registration_tpu_torch.train import checkpoints as tckpt
from se3_equi_graph_registration_tpu_torch.train import cli as tcli
from se3_equi_graph_registration_tpu_torch.train import engine as tengine

WORLD = 2
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# a small fast_tpu_config for the Registrar (curve window, packed keys)
REG_CFG = dict(num_nodes=256, k=8, in_node_nf=16, hidden_nf=16, n_layers=2, num_heads=2,
               top_k=32, egnn_window=128)
REG_B = 3                     # odd: the mesh pads it to 4
FPFH_B, FPFH_N = 3, 256
FPFH_KW = dict(window=256, top_m=128, hypotheses=64, ransac_branches=2, icp_iters=5)
FIT_CFG = dict(num_nodes=64, k=8, in_node_nf=16, hidden_nf=32, top_k=16)   # test_parallel.py
FIT_B = 8
CLI_ARGS = ["--device", "cpu", "--preset", "synthetic", "--set", "engine.num_nodes=128",
            "engine.n_layers=2", "engine.in_node_nf=16", "engine.hidden_nf=16",
            "engine.num_heads=2", "engine.top_k=32", "engine.k=8", "data.batch_size=2",
            "run.epochs=1"]


@pytest.fixture
def no_dist_env(monkeypatch):
    for key in DIST_ENV:
        monkeypatch.delenv(key, raising=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_process_is_a_no_op(no_dist_env):
    assert init_distributed() is False
    assert init_distributed(device="cpu") is False          # repeat calls too
    assert process_shard_info() == (0, 1)
    mesh = global_mesh()
    assert mesh.shape == {"data": 1} and mesh.rank == 0 and not mesh.distributed
    batch = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
             "b": torch.ones(3, 2, 2)}
    glob = host_local_to_global(batch, mesh)
    np.testing.assert_array_equal(glob["a"], batch["a"])
    assert torch.equal(glob["b"], batch["b"])
    local = shard_pair_batch(batch, mesh)
    np.testing.assert_array_equal(local["a"], batch["a"])
    assert data_sharding(mesh).rows(3) == slice(0, 3) == replicated(mesh).rows(3)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(gather_pairs(x, mesh), x)


def test_mesh_axes_are_checked(no_dist_env):
    with pytest.raises(ValueError, match="need 3 devices, have 1"):
        make_mesh({"data": 3})
    two = make_mesh({"data": 1, "point": 1})      # the 2-axis mesh of point sharding
    assert two.shape == {"data": 1, "point": 1} and two.axis_size("data") == 1
    assert data_sharding(two).rows(3) == slice(0, 3)
    with pytest.raises(ValueError, match="axes"):
        make_mesh({"model": 1})
    with pytest.raises(TypeError, match="mesh must be"):
        check_mesh(object(), torch.device("cpu"))
    # a gloo group carries CPU tensors here, NCCL CUDA tensors: no quiet mix
    gloo = Mesh({"data": 1}, 0, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="gloo"):
        check_mesh(gloo, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="NCCL"):
        check_mesh(Mesh({"data": 1}, 0, "nccl", None), torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        data_sharding(Mesh({"data": 2}, 1, "gloo", None)).rows(3)
    assert data_sharding(Mesh({"data": 2}, 1, "gloo", None)).rows(8) == slice(4, 8)


def test_a_store_that_cannot_be_reached_raises(no_dist_env, monkeypatch):
    """WORLD_SIZE > 1 with no store to join: the process raises, it never
    carries on as one process."""
    with pytest.raises(ValueError, match="rank"):
        init_distributed("127.0.0.1:1", 2, None, device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(Exception) as err:
        init_distributed(device="cpu", timeout_s=2.0)
    assert not isinstance(err.value, AssertionError)
    assert not torch.distributed.is_initialized()


def test_loader_shards_one_shuffle_over_processes():
    """Two ranks with one seed see disjoint slices that cover the dataset."""
    class DS:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return (np.full((4, 2), i, np.float32),) * 7

    seen = []
    for rank in range(2):
        loader = PairLoader(DS(), batch_size=4, shuffle=True, seed=3, num_workers=1,
                            process_shard=(rank, 2))
        assert len(loader) == 4
        for b in loader:
            seen.extend(int(v) for v in b[0][:, 0, 0])
    assert sorted(seen) == list(range(32))


def _surface_pairs(b, n, seed=0):
    from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation
    from se3_equi_graph_registration_tpu_torch.tools.scenario_table import make_bumpy_surface

    surf, rng = make_bumpy_surface(), np.random.default_rng(seed)
    src, tgt = [], []
    for _ in range(b):
        s = surf(rng, n, -1.0, 1.0)
        R = random_rotation(rng).astype(np.float32)
        src.append(s)
        tgt.append(surf(rng, n, -1.0, 1.0) @ R.T + rng.standard_normal(3).astype(np.float32) * 0.3)
    return np.stack(src), np.stack(tgt).astype(np.float32)


def _inputs():
    """Everything both ranks and this process start from."""
    reg_cfg = tengine.fast_tpu_config(**REG_CFG)
    reg_params = tengine.init_state(reg_cfg, torch.Generator().manual_seed(0),
                                    device="cpu").model.state_dict()
    pb = make_pair_batch(np.random.default_rng(5), batch=REG_B, n=REG_CFG["num_nodes"],
                         feat_dim=REG_CFG["in_node_nf"])
    src, tgt = _surface_pairs(FPFH_B, FPFH_N)
    fit_pb = make_pair_batch(np.random.default_rng(0), batch=FIT_B, n=FIT_CFG["num_nodes"],
                             feat_dim=FIT_CFG["in_node_nf"])
    return dict(reg_params=reg_params, reg_args=(pb.src_pts, pb.src_feat, pb.tgt_pts,
                                                 pb.tgt_feat),
                fpfh=(src, tgt), fit_batch=tuple(fit_pb))


def _fit(params, batch, mesh=None):
    """2 fit steps (one epoch of the batch twice) from `params`; the model's
    state_dict after them."""
    cfg = tengine.EngineConfig(**FIT_CFG)
    state = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state.model.load_state_dict(params)
    state = tengine.fit(state.model, state.optimizer, cfg, state,
                        train_batches=lambda: [batch, batch], epochs=1, mesh=mesh)
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _worker(rank, port, out_dir, inputs):
    """One rank of the gloo world (torch.multiprocessing target)."""
    torch.set_num_threads(2)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    assert init_distributed(device="cpu", timeout_s=120.0) is True
    assert process_shard_info() == (rank, WORLD)
    out = {}
    # cli train, which joins the same group again (a repeat call)
    tcli.main(["train", *CLI_ARGS, "--set", f"run.checkpoint_dir={out_dir}/ck",
               f"run.log_path={out_dir}/log.jsonl"])

    mesh = make_mesh()
    assert mesh.shape == {"data": WORLD} and mesh.backend == "gloo" and mesh.rank == rank
    # a rank's own weights are overwritten by rank 0's at construction
    params = inputs["reg_params"] if rank == 0 else {
        k: v + 1.0 for k, v in inputs["reg_params"].items()}
    reg = tserving.Registrar(params, tengine.fast_tpu_config(**REG_CFG), device="cpu",
                             mesh=mesh)
    out["register"] = reg.register(*inputs["reg_args"])
    server = tserving.BatchingServer(reg, max_batch=4, max_wait_ms=50)
    try:
        args = inputs["reg_args"]
        futs = [server.submit(*(a[i] for a in args)) for i in range(REG_B)]
        out["served"] = [f.result(timeout=300)[:2] for f in futs]
    finally:
        server.close()

    src, tgt = inputs["fpfh"]
    out["fpfh"] = treg.register_fpfh_batch(src, tgt, seed=7, mesh=mesh, device="cpu",
                                           **FPFH_KW)
    local = shard_pair_batch(inputs["fit_batch"], mesh)
    out["fit"] = _fit(inputs["fit_params"], local, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jax_fit():
    """(the initial flax params as the port's state_dict, the parameters
    after 2 JAX steps on the whole batch)."""
    import jax
    from torch_port_util import jax_model_params

    from se3_equi_graph_registration_tpu.train import engine as jengine

    cfg = jengine.EngineConfig(**FIT_CFG)
    model, params = jax_model_params(cfg)
    opt = jengine.build_optimizer(cfg)
    batch = jengine.batch_to_device(_inputs()["fit_batch"])
    state = jengine.TrainState(params=params, opt_state=opt.init(params),
                               step=jax.numpy.zeros((), jax.numpy.int32))
    step = jengine.make_train_step(model, opt, cfg)
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    init = tckpt.params_from_jax(params)
    return init, tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_fit):
    """The 2-rank gloo world's results, one dict a rank, and its directory."""
    out_dir = str(tmp_path_factory.mktemp("world"))
    inputs = dict(_inputs(), fit_params=jax_fit[0])
    saved = {k: os.environ.pop(k) for k in DIST_ENV if k in os.environ}
    try:
        tmp.spawn(_worker, args=(_free_port(), out_dir, inputs), nprocs=WORLD, join=True)
    finally:
        os.environ.update(saved)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ranks, out_dir, inputs


def _close(a, b, tol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=tol)


def test_mesh_registrar_equals_the_call_without_a_mesh(world):
    ranks, _, inputs = world
    reg = tserving.Registrar(inputs["reg_params"], tengine.fast_tpu_config(**REG_CFG),
                             device="cpu")
    R, t, info = reg.register(*inputs["reg_args"])
    for got in ranks:
        Rm, tm_, im = got["register"]
        assert Rm.shape == (REG_B, 3, 3) and im["pose_covariance"].shape == (REG_B, 6, 6)
        _close((Rm, tm_, im["pose_covariance"]), (R, t, info["pose_covariance"]), 1e-5)
        assert abs(im["similarity_mean"] - info["similarity_mean"]) <= 1e-6
        for i, (Rs, ts) in enumerate(got["served"]):     # the BatchingServer's answers
            _close((Rs, ts), (R[i], t[i]), 1e-5)


def test_mesh_register_fpfh_batch_takes_its_rows_of_the_global_noise(world):
    ranks, _, inputs = world
    src, tgt = inputs["fpfh"]
    R, t, info = treg.register_fpfh_batch(src, tgt, seed=7, device="cpu", **FPFH_KW)
    for got in ranks:
        Rm, tm_, im = got["fpfh"]
        assert Rm.shape == (FPFH_B, 3, 3)
        _close((Rm, tm_, im["pose_covariance"], im["weights"]),
               (R, t, info["pose_covariance"], info["weights"]), 1e-5)


def test_two_rank_fit_equals_the_full_batch_step_and_jax(world, jax_fit):
    ranks, _, inputs = world
    init, jax_after = jax_fit
    one = _fit(init, inputs["fit_batch"])
    assert any(not torch.equal(one[k], init[k]) for k in one)
    for name, want in one.items():
        a, b = ranks[0]["fit"][name], ranks[1]["fit"][name]
        assert torch.equal(a, b), name
        np.testing.assert_allclose(a.numpy(), want.numpy(), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), jax_after[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_two_rank_cli_train_writes_one_checkpoint(world, tmp_path, monkeypatch):
    _, out_dir, _ = world
    assert sorted(os.listdir(f"{out_dir}/ck")) == ["step_4.pt"]
    logged = open(f"{out_dir}/log.jsonl").read().splitlines()
    assert len(logged) == 1                      # rank 0 logs, once an epoch
    for key in DIST_ENV:
        monkeypatch.delenv(key, raising=False)
    tcli.main(["train", *CLI_ARGS, "--set", f"run.checkpoint_dir={tmp_path}/ck",
               f"run.log_path={tmp_path}/log.jsonl"])
    got = torch.load(f"{out_dir}/ck/step_4.pt", weights_only=True)["model"]
    want = torch.load(f"{tmp_path}/ck/step_4.pt", weights_only=True)["model"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
