"""Point-axis sharding in the port (`parallel/point_sharding.py`, the 'point'
axis of `parallel/mesh.py`, the slab mode of `models/egnn.py`, the 2-axis
`fit`/`cli train` and `parallel/dryrun.py`), on the CPU.

One-process cases first: the mesh's row-major layout, the halo exchange on
a ring of one, and the ValueErrors where the JAX package asserts.

Then one world of 4 ranks over gloo, spawned with torch.multiprocessing
once for the module (`world`; the worker imports no jax). Each rank runs,
on meshes {data: 2, point: 2} and {point: 4}: the sharded and the halo
k-NN, the sharded and the halo EGNN forward, the halo forward's parameter
gradients, the 2-axis train step in both regimes (one Adam step, and the
gradients of one micro-step summed over the world), the dry run, and `cli
train` at run.point_parallel=2 with run.halo. The JAX side runs in this
process on the virtual CPU devices of tests/conftest.py, from the same
numpy inputs and the same weights (`params_from_jax`).

Tolerances: neighbour sets equal; forwards within 1e-5 of JAX and of the
port's unsharded EGNN on the same graph; the train step's loss within 1e-4
and its post-Adam parameters within 5e-4 of JAX's (the JAX dry run's:
above 2·lr, since Adam's first step moves a weight by ~lr·sign(g)). The
gradient checks are the ones that see a factor (a double-counted axis
scales the gradient, which Adam's first step does not show): the halo
forward's within 1e-4 of each tensor's largest (measured 4e-7); the
step's summed over the world within 1e-5 of each tensor's largest of the
port's unsharded twin on the same graph (measured 9e-7), and within 2e-2
of JAX's (measured 6.8e-3: the coordinate path's gradients sit 4e-3 to
1e-2 from their float64 values in both packages, the rest within 2e-5).
"""
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops import morton
from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph
from se3_equi_graph_registration_tpu_torch.parallel import dryrun
from se3_equi_graph_registration_tpu_torch.parallel.distributed import init_distributed
from se3_equi_graph_registration_tpu_torch.parallel.mesh import (
    Mesh, Sharding, all_gather_rows, all_reduce_sum, all_reduce_sum_, gather_pairs, halo_extend,
    make_mesh, shard_points_batch)
from se3_equi_graph_registration_tpu_torch.parallel.point_sharding import (
    halo_sharded_egnn_forward, halo_sharded_knn, halo_sharded_knn_batched,
    make_point_sharded_train_step, sharded_egnn_forward, sharded_knn, sharded_knn_batched)
from se3_equi_graph_registration_tpu_torch.train import cli as tcli
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.train import losses as tlosses
from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

WORLD = 4
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
K = 8
# 'cosine': at a seeded init the 'dot' head's softmax is one-hot (similarities
# in the thousands), so its Kabsch solve sees one point and the pose terms
# are set by rounding (3e-3 of rot between the port and JAX on one and the
# same halo graph here); the 'cosine' head is live from the first step.
# The dry run holds the default 'dot' step against the port's own twins.
STEP_CFG = dict(num_nodes=64, k=K, in_node_nf=16, hidden_nf=32, n_layers=2, top_k=16,
                weight_mode="cosine")
STEP_B, STEP_HALO = 4, 8          # data 2 x point 2: 2 pairs, 32 points a rank
KNN_B, KNN_N = 4, 128
FWD_N, FWD_C, FWD_HALO = 128, 16, 16
GRAD_N, GRAD_C, GRAD_HALO = 256, 8, 64     # tests/test_parallel.py's halo gradients
CLI_ARGS = ["--device", "cpu", "--preset", "synthetic", "--set", "engine.num_nodes=128",
            "engine.n_layers=2", "engine.in_node_nf=16", "engine.hidden_nf=16",
            "engine.num_heads=2", "engine.top_k=32", "engine.k=8", "data.batch_size=2",
            "run.epochs=1", "run.point_parallel=2", "run.halo=16"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    """The numpy inputs every side starts from."""
    rng = np.random.default_rng(11)
    pb = make_pair_batch(rng, batch=STEP_B, n=STEP_CFG["num_nodes"],
                         feat_dim=STEP_CFG["in_node_nf"])
    return dict(
        batch=tuple(pb),
        knn_x=rng.standard_normal((KNN_B, KNN_N, 3)).astype(np.float32),
        fwd_h=rng.standard_normal((FWD_N, FWD_C)).astype(np.float32),
        fwd_x=rng.standard_normal((FWD_N, 3)).astype(np.float32),
        grad_h=rng.standard_normal((GRAD_N, GRAD_C)).astype(np.float32),
        grad_x=rng.standard_normal((GRAD_N, 3)).astype(np.float32))


def _egnn_sd(tree):
    """A JAX EGNN's flax params → the port EGNN's state_dict."""
    sd = params_from_jax({"egnn": tree["params"], "mlp": {}})
    return {k[len("egnn."):]: v for k, v in sd.items()}


def _egnn(c, sd):
    model = EGNN(in_node_nf=c, n_layers=2)
    model.load_state_dict(sd)
    return model


def _cfg(**kw):
    return tengine.EngineConfig(**STEP_CFG, **kw)


def _step_state(params, cfg):
    state = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    state.model.load_state_dict(params)
    return state


def _slab(a, mesh):
    """This rank's point slab of a [N, ·] or [B, N, ·] array (torch)."""
    d, i = mesh.axis_size("point"), mesh.axis_index("point")
    L = a.shape[-2] // d
    return a[..., i * L:(i + 1) * L, :]


def _sharded_step(params, batch, mesh, halo, accum):
    """The 2-axis step from `params`: (the loss summed over the data axis,
    the post-Adam state_dict) or with `accum` (a first micro-step of two,
    no Adam yet) the parameter gradients summed over the world."""
    cfg = _cfg(grad_accum_steps=2 if accum else 1)
    state = _step_state(params, cfg)
    step = make_point_sharded_train_step(state.model, state.optimizer, cfg, mesh, halo=halo)
    _, m = step(state, shard_points_batch(batch, mesh))
    if accum:
        grads = [p.grad for p in state.model.parameters()]
        all_reduce_sum_(grads, mesh)
        return {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return (float(all_reduce_sum(m["total"], mesh)),
            {k: v.clone() for k, v in state.model.state_dict().items()})


def _worker(rank, port, out_dir, inputs):
    """One rank of the gloo world (torch.multiprocessing target)."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    assert init_distributed(device="cpu", timeout_s=120.0) is True
    m22, m4 = make_mesh({"data": 2, "point": 2}), make_mesh({"point": 4})
    assert (m22.axis_index("data"), m22.axis_index("point")) == divmod(rank, 2)
    out = {}

    def whole(a, mesh):
        return gather_pairs(all_gather_rows(a, mesh, "point"), mesh)

    with torch.no_grad():
        x = torch.from_numpy(inputs["knn_x"])
        blk = shard_points_batch({"x": x}, m22)["x"]
        out["knn"] = whole(sharded_knn_batched(blk, K, m22), m22)
        xs = torch.from_numpy(inputs["knn_x_sorted"])
        out["halo_knn"] = whole(halo_sharded_knn_batched(_slab(xs, m4), K, m4, FWD_HALO), m4)

        egnn = _egnn(FWD_C, inputs["fwd_params"])
        h, x = torch.from_numpy(inputs["fwd_h"]), torch.from_numpy(inputs["fwd_x"])
        nbr = sharded_knn(x, K, m4)
        h2, x2 = sharded_egnn_forward(egnn, _slab(h, m4), _slab(x, m4), nbr, m4)
        out["fwd"] = [all_gather_rows(a, m4, "point") for a in (h2, x2, nbr)]
        hs, xs = torch.from_numpy(inputs["fwd_h_sorted"]), torch.from_numpy(inputs["fwd_x_sorted"])
        nbr = halo_sharded_knn(_slab(xs, m4), K, m4, FWD_HALO)
        h3, x3 = halo_sharded_egnn_forward(egnn, _slab(hs, m4), _slab(xs, m4), nbr, m4, FWD_HALO)
        out["halo_fwd"] = [all_gather_rows(a, m4, "point") for a in (h3, x3, nbr)]

    egnn = _egnn(GRAD_C, inputs["grad_params"])
    hs, xs = torch.from_numpy(inputs["grad_h_sorted"]), torch.from_numpy(inputs["grad_x_sorted"])
    nbr = halo_sharded_knn(_slab(xs, m4), K, m4, GRAD_HALO)
    h2, x2 = halo_sharded_egnn_forward(egnn, _slab(hs, m4), _slab(xs, m4), nbr, m4, GRAD_HALO)
    (torch.sum(h2 ** 2) + torch.sum(x2 ** 2)).backward()       # this slab's share
    all_reduce_sum_([p.grad for p in egnn.parameters()], m4)
    out["halo_grads"] = {k: p.grad.clone() for k, p in egnn.named_parameters()}

    batch = tengine.batch_to_device(inputs["batch"], "cpu")
    for halo in (None, STEP_HALO):
        out[("step", halo)] = _sharded_step(inputs["step_params"], batch, m22, halo, False)
        out[("grads", halo)] = _sharded_step(inputs["step_params"], batch, m22, halo, True)
    with torch.no_grad():                # the halo graphs, for the unsharded twin
        for side in ("src", "tgt"):
            xs = morton.sort_by_curve(batch[f"{side}_feat"], batch[f"{side}_pts"])[1]
            blk = shard_points_batch({"x": xs}, m22)["x"]
            out[("halo_graph", side)] = whole(halo_sharded_knn_batched(blk, K, m22, STEP_HALO),
                                              m22)

    out["dryrun"] = dryrun.checks(torch.device("cpu"))
    tcli.main(["train", *CLI_ARGS, "--set", f"run.checkpoint_dir={out_dir}/ck",
               f"run.log_path={out_dir}/log.jsonl"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _jax_inputs():
    """The inputs the world gets: the numpy inputs, the clouds sorted by the
    JAX package's curve, the weights drawn by it (as port state_dicts)."""
    import jax
    import jax.numpy as jnp
    from torch_port_util import jax_model_params

    from se3_equi_graph_registration_tpu.models import EGNN as JEGNN
    from se3_equi_graph_registration_tpu.ops import knn as jknn
    from se3_equi_graph_registration_tpu.ops import morton as jmorton
    from se3_equi_graph_registration_tpu.train import engine as jengine

    inputs, flax = _inputs(), {}

    def sort(h, x):
        perm = np.asarray(jmorton.morton_perm(jnp.asarray(x)))
        return (np.take_along_axis(h, perm[..., None], -2),
                np.take_along_axis(x, perm[..., None], -2))

    _, inputs["knn_x_sorted"] = sort(inputs["knn_x"][:2, :, :1], inputs["knn_x"][:2])
    inputs["fwd_h_sorted"], inputs["fwd_x_sorted"] = sort(inputs["fwd_h"], inputs["fwd_x"])
    inputs["grad_h_sorted"], inputs["grad_x_sorted"] = sort(inputs["grad_h"], inputs["grad_x"])
    # jitted, arrays as arguments: eager shard_map dispatches op by op, and
    # closed-over arrays make XLA constant-fold the k-NN sorts
    for name, c, x in (("fwd", FWD_C, inputs["fwd_x"]), ("grad", GRAD_C, inputs["grad_x_sorted"])):
        x = jnp.asarray(x[:32])
        flax[name] = jax.jit(JEGNN(in_node_nf=c, n_layers=2).init)(
            jax.random.PRNGKey(0), jnp.zeros((32, c)), x, jknn.knn_graph(x, K))
        inputs[f"{name}_params"] = _egnn_sd(flax[name])
    flax["model"], flax["step"] = jax_model_params(jengine.EngineConfig(**STEP_CFG))
    inputs["step_params"] = params_from_jax(flax["step"])
    return inputs, flax


def _jax_results(inputs, flax):
    """The JAX package's results on the virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from se3_equi_graph_registration_tpu.models import EGNN as JEGNN
    from se3_equi_graph_registration_tpu.ops import morton as jmorton
    from se3_equi_graph_registration_tpu.parallel import point_sharding as jps
    from se3_equi_graph_registration_tpu.parallel.mesh import make_mesh as jmake_mesh
    from se3_equi_graph_registration_tpu.train import engine as jengine
    from se3_equi_graph_registration_tpu.train import losses as jlosses

    devs = jax.devices()[:4]
    m22, m4 = jmake_mesh({"data": 2, "point": 2}, devs), jmake_mesh({"point": 4}, devs)
    got = {}
    got["knn"] = np.asarray(jps.sharded_knn_batched(jnp.asarray(inputs["knn_x"]), K, m22))
    got["halo_knn"] = np.asarray(jps.halo_sharded_knn_batched(
        jnp.asarray(inputs["knn_x_sorted"]), K, m4, FWD_HALO, data_axis=None))

    h, x = jnp.asarray(inputs["fwd_h"]), jnp.asarray(inputs["fwd_x"])
    params = flax["fwd"]
    slab = JEGNN(in_node_nf=FWD_C, n_layers=2, axis_name="point")
    fwd = jax.jit(lambda p, h, x: jps.sharded_egnn_forward(
        slab, p, h, x, jps.sharded_knn(x, K, m4), m4))
    got["fwd"] = [np.asarray(a) for a in fwd(params, h, x)]
    hs, xs = jnp.asarray(inputs["fwd_h_sorted"]), jnp.asarray(inputs["fwd_x_sorted"])
    halo = JEGNN(in_node_nf=FWD_C, n_layers=2, axis_name="point", halo=FWD_HALO)
    fwd = jax.jit(lambda p, h, x: jps.halo_sharded_egnn_forward(
        halo, p, h, x, jps.halo_sharded_knn(x, K, m4, halo=FWD_HALO), m4))
    got["halo_fwd"] = [np.asarray(a) for a in fwd(params, hs, xs)]

    hs, xs = jnp.asarray(inputs["grad_h_sorted"]), jnp.asarray(inputs["grad_x_sorted"])
    params = flax["grad"]
    halo = JEGNN(in_node_nf=GRAD_C, n_layers=2, axis_name="point", halo=GRAD_HALO)

    def loss_halo(p, h, x):
        nbr = jps.halo_sharded_knn(x, K, m4, halo=GRAD_HALO)
        h2, x2 = jps.halo_sharded_egnn_forward(halo, p, h, x, nbr, m4)
        return jnp.sum(h2 ** 2) + jnp.sum(x2 ** 2)
    got["halo_grads"] = _egnn_sd(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_halo))(params, hs, xs)))

    jcfg = jengine.EngineConfig(**STEP_CFG)
    jmodel, params = flax["model"], flax["step"]
    opt = jengine.build_optimizer(jcfg)
    batch = jengine.batch_to_device(inputs["batch"])
    for h_ in (None, STEP_HALO):
        state = jengine.TrainState(params=params, opt_state=opt.init(params),
                                   step=jnp.zeros((), jnp.int32))
        step = jps.make_point_sharded_train_step(jmodel, opt, jcfg, m22, halo=h_)
        state, m = step(state, jps.shard_points_batch(batch, m22))
        got[("step", h_)] = (float(m["total"]), params_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params)))

    def loss(p, b):                      # the unsharded engine's loss
        out = jengine._apply_with_graphs(jmodel, jcfg, p, b)
        return jlosses.total_loss(out, b["gt_pose"], b["labels"], jcfg.loss_weights).total

    def twin_embed(p, hh, xx):           # tests/test_parallel.py's halo twin
        hs_, xs_, perm = jmorton.sort_by_curve(hh, xx, jcfg.curve)
        nb = jps.halo_sharded_knn_batched(xs_, K, m22, STEP_HALO)
        base = JEGNN(in_node_nf=jcfg.in_node_nf, hidden_nf=jcfg.hidden_nf,
                     out_node_nf=jcfg.hidden_nf, n_layers=jcfg.n_layers,
                     num_heads=jcfg.num_heads)
        return jmorton.unsort_rows(base.apply(p, hs_, xs_, nb), perm)

    def twin_loss(p, batch):
        ep = {"params": p["params"]["egnn"]}
        h_s, x_s = twin_embed(ep, batch["src_feat"], batch["src_pts"])
        h_t, x_t = twin_embed(ep, batch["tgt_feat"], batch["tgt_pts"])
        out = jmodel.apply(p, batch["src_feat"], batch["tgt_feat"], batch["src_pts"],
                           batch["tgt_pts"], h_s, x_s, h_t, x_t, batch["labels"],
                           method="head_from_embeddings")
        return jlosses.total_loss(out, batch["gt_pose"], batch["labels"],
                                  jcfg.loss_weights).total
    for h_, fn in ((None, loss), (STEP_HALO, twin_loss)):
        grads = jax.jit(jax.grad(fn))(params, batch)
        got[("grads", h_)] = {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, grads)).items()}
    return got


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the inputs, the JAX results, the 4-rank gloo world's results (one
    dict a rank), its directory). The JAX side runs here while the world
    runs."""
    inputs, flax = _jax_inputs()
    out_dir = str(tmp_path_factory.mktemp("point_world"))
    saved = {k: os.environ.pop(k) for k in DIST_ENV if k in os.environ}
    try:
        ctx = tmp.spawn(_worker, args=(_free_port(), out_dir, inputs), nprocs=WORLD,
                        join=False)
        got = _jax_results(inputs, flax)
        while not ctx.join():
            pass
    finally:
        os.environ.update(saved)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return inputs, got, ranks, out_dir


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0], sides[1]


@pytest.fixture(scope="module")
def world(sides):
    return sides[2], sides[3]


def _twin_grads(params, batch_np, graphs=None):
    """The parameter gradients of one unsharded step on the plain EGNN: the
    exact k-NN graph, or with `graphs` ({side: [B, N, K]} over the
    curve-sorted clouds) the halo regime's computation (sort, that graph,
    EGNN, un-sort)."""
    cfg = _cfg()
    model = _step_state(params, cfg).model
    b = tengine.batch_to_device(batch_np, "cpu")

    def embed(side):
        h, x = b[f"{side}_feat"], b[f"{side}_pts"]
        if graphs is None:
            return model.egnn(h, x, knn_graph(x, K))
        hs, xs, perm = morton.sort_by_curve(h, x, cfg.curve)
        return morton.unsort_rows(model.egnn(hs, xs, graphs[side]), perm)

    (h_s, x_s), (h_t, x_t) = embed("src"), embed("tgt")
    out = model.head_from_embeddings(b["src_feat"], b["tgt_feat"], b["src_pts"], b["tgt_pts"],
                                     h_s, x_s, h_t, x_t, b["labels"])
    tlosses.total_loss(out, b["gt_pose"], b["labels"], cfg.loss_weights).total.backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _grads_close(got, want, rel):
    for name, w in want.items():
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[name]) - w).max())
        assert err <= rel * scale, (name, err, scale)


# --- one process ---

def test_mesh_lays_ranks_row_major():
    """rank = d·Dp + p, as the JAX package's reshape of its device list;
    an axis the mesh lacks has size 1 and index 0."""
    for rank in range(6):
        mesh = Mesh({"data": 2, "point": 3}, rank, None, None)
        assert (mesh.axis_index("data"), mesh.axis_index("point")) == divmod(rank, 3)
        d, p = divmod(rank, 3)
        assert mesh.shifted_rank("point", 1) == d * 3 + (p + 1) % 3
        assert mesh.shifted_rank("point", -1) == d * 3 + (p - 1) % 3
        assert mesh.shifted_rank("data", 1) == ((d + 1) % 2) * 3 + p
    mesh = Mesh({"point": 4}, 2, None, None)
    assert (mesh.axis_size("data"), mesh.axis_index("data"), mesh.axis_size("point")) == (1, 0, 4)
    assert mesh.group("point") is None                      # no process group: identity
    one = make_mesh({"data": 1, "point": 1})
    assert one.shape == {"data": 1, "point": 1} and not one.distributed
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_mesh({"data": 2, "point": 2})
    rows = shard_points_batch({"labels": np.arange(24).reshape(4, 6),
                               "gt_pose": np.zeros((4, 4, 4))},
                              Mesh({"data": 2, "point": 3}, 5, None, None))
    np.testing.assert_array_equal(rows["labels"], [[16, 17], [22, 23]])
    assert rows["gt_pose"].shape == (2, 4, 4)


def test_halo_extend_on_a_ring_of_one_wraps_locally():
    """At D_point = 1 the rank is its own neighbour: the wrap-around is a
    local copy, and the backward adds each block's gradient back to the
    rows it came from."""
    mesh = make_mesh({"data": 1, "point": 1})
    a = torch.randn(2, 10, 3, requires_grad=True)
    ext = halo_extend(a, mesh, "point", 4)
    assert torch.equal(ext, torch.cat([a[:, -4:], a, a[:, :4]], 1))
    g = torch.randn_like(ext)
    ext.backward(g)
    want = g[:, 4:14].clone()
    want[:, :4] += g[:, -4:]
    want[:, -4:] += g[:, :4]
    assert torch.equal(a.grad, want)
    with pytest.raises(ValueError, match="halo=11"):
        halo_extend(a, mesh, "point", 11)
    # the halo k-NN over a ring of one masks every wrapped id: the exact graph
    x = torch.randn(2, 64, 3)
    assert torch.equal(halo_sharded_knn_batched(x, K, mesh, 16), knn_graph(x, K))


def test_point_sharding_refuses_what_jax_asserts():
    cfg = _cfg()
    state = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    model, opt = state.model, state.optimizer
    mesh = Mesh({"data": 1, "point": 2}, 0, None, None)

    def build(mesh=mesh, halo=None, **kw):
        return make_point_sharded_train_step(model, opt, _cfg(**kw), mesh, halo=halo)

    with pytest.raises(ValueError, match="'center' only"):
        build(direction="cluster")
    with pytest.raises(ValueError, match="PointNet"):
        build(use_pointnet=True)
    with pytest.raises(ValueError, match="does not split over the 3 ranks"):
        build(Mesh({"data": 1, "point": 3}, 0, None, None))
    with pytest.raises(ValueError, match=r"halo=33 must lie in \[1, 32\]"):
        build(halo=33)
    with pytest.raises(ValueError, match="no 'point' axis"):
        build(Mesh({"data": 2}, 0, None, None))
    batch = tengine.batch_to_device(tuple(make_pair_batch(np.random.default_rng(0), batch=3,
                                                          n=64, feat_dim=16)), "cpu")
    with pytest.raises(ValueError, match="does not split over the mesh's 'data' axis of 2"):
        shard_points_batch(batch, Mesh({"data": 2, "point": 2}, 0, None, None))
    with pytest.raises(ValueError, match="points do not split"):
        shard_points_batch(batch, Mesh({"data": 1, "point": 5}, 0, None, None))
    # the data-parallel step and fit refuse a mesh that shards points
    with pytest.raises(ValueError, match="shards points"):
        tengine.make_train_step(model, opt, cfg, mesh)
    with pytest.raises(ValueError, match="train_step=make_point_sharded_train_step"):
        tengine.fit(model, opt, cfg, state, lambda: [], 1, mesh=mesh)
    # slab mode aggregates onto the local centers only
    x, h = torch.randn(1, 8, 3), torch.randn(1, 8, 16)
    nbr = torch.zeros(1, 8, 2, dtype=torch.int32)
    one = Sharding(make_mesh({"point": 1}), "point")
    with pytest.raises(ValueError, match="'center' only"):
        EGNN(in_node_nf=16, direction="cluster")(h, x, nbr, one)
    with pytest.raises(ValueError, match="needs a point sharding"):
        EGNN(in_node_nf=16)(h, x, nbr, None, 4)


def test_dryrun_never_falls_back_to_the_cpu(monkeypatch):
    """Without the cards it asks for, the dry run raises before it spawns;
    only --device cpu runs it over gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards, have 1"):
        dryrun.main(["--ranks", "2"])
    with pytest.raises(SystemExit):
        dryrun.main(["--ranks", "0", "--device", "cpu"])


def test_dryrun_gradient_helpers_see_a_scale():
    """`update_grads` records the gradients the next Adam step applies (the
    mean over the micro-steps), once; `grad_gap` is max|Δ| over each
    tensor's largest: 1 for a doubled or a zero gradient, inf for a
    missing one."""
    cfg = _cfg(grad_accum_steps=2)
    state = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = dryrun.update_grads(state)
    step = tengine.make_train_step(state.model, state.optimizer, cfg)
    batch = tengine.batch_to_device(tuple(make_pair_batch(np.random.default_rng(0), batch=2,
                                                          n=64, feat_dim=16)), "cpu")
    step(state, batch)
    assert got == {}                                  # a micro-step: no Adam yet
    want = {k: p.grad.double().clone() for k, p in state.model.named_parameters()
            if p.grad is not None}
    step(state, batch)
    assert got.keys() == dict(state.model.named_parameters()).keys()
    assert dryrun.grad_gap(got, {k: got[k] for k in got}) == 0.0
    assert dryrun.grad_gap({k: got[k] for k in want}, want) < 1e-6   # the mean of 2 equal
    assert dryrun.grad_gap({k: 2 * v for k, v in want.items()}, want) == pytest.approx(1.0)
    assert dryrun.grad_gap({k: 0 * v for k, v in want.items()}, want) == pytest.approx(1.0)
    assert dryrun.grad_gap({}, want) == float("inf")
    recorded = {k: v.clone() for k, v in got.items()}
    step(state, batch)
    step(state, batch)
    assert all(torch.equal(got[k], recorded[k]) for k in got)   # the hook removed itself


# --- the 4-rank world against JAX ---

def test_sharded_knn_matches_jax(world, jax_side):
    """data 2 x point 2: the neighbour sets (and their order) equal JAX's."""
    ranks, _ = world
    _, got = jax_side
    for r in ranks:
        np.testing.assert_array_equal(r["knn"].numpy(), got["knn"])


def test_halo_knn_matches_jax_and_stays_within_the_halo(world, jax_side):
    ranks, _ = world
    _, got = jax_side
    L = KNN_N // WORLD
    for r in ranks:
        nbr = r["halo_knn"].numpy()
        np.testing.assert_array_equal(nbr, got["halo_knn"])
        for p in range(WORLD):
            ids = nbr[:, p * L:(p + 1) * L]
            assert ids.min() >= max(0, p * L - FWD_HALO)
            assert ids.max() < min(KNN_N, (p + 1) * L + FWD_HALO)


@pytest.mark.parametrize("regime", ["fwd", "halo_fwd"])
def test_sharded_egnn_forward_matches_jax_and_the_unsharded_egnn(world, jax_side, regime):
    """point 4, all-gather and halo regimes: (h, x) within 1e-5 of JAX's and
    of the port's unsharded EGNN on the same graph."""
    ranks, _ = world
    inputs, got = jax_side
    sorted_ = regime == "halo_fwd"
    h = inputs["fwd_h_sorted" if sorted_ else "fwd_h"]
    x = inputs["fwd_x_sorted" if sorted_ else "fwd_x"]
    for r in ranks:
        h2, x2, nbr = r[regime]
        _close(h2, got[regime][0], 1e-5)
        _close(x2, got[regime][1], 1e-5)
        with torch.no_grad():
            hr, xr = _egnn(FWD_C, inputs["fwd_params"])(
                torch.from_numpy(h)[None], torch.from_numpy(x)[None], nbr[None])
        _close(h2, hr[0], 1e-5)
        _close(x2, xr[0], 1e-5)


def test_halo_forward_gradients_match_jax_grad(world, jax_side):
    """The twin of tests/test_parallel.py::test_halo_sharded_gradients_flow:
    each rank's slab share, summed over the world, is JAX's gradient."""
    ranks, _ = world
    _, got = jax_side
    for r in ranks:
        _grads_close(r["halo_grads"], got["halo_grads"], 1e-4)


@pytest.mark.parametrize("halo", [None, STEP_HALO], ids=["all-gather", "halo"])
def test_two_axis_train_step_matches_jax(world, jax_side, halo):
    """data 2 x point 2: one step's loss and post-Adam parameters against the
    JAX point-sharded step's, and one micro-step's gradients summed over the
    world against the port's unsharded twin and JAX's gradient (unsharded
    in the all-gather regime, the halo twin's in the halo regime)."""
    ranks, _ = world
    inputs, got = jax_side
    want_loss, want_params = got[("step", halo)]
    graphs = None if halo is None else {s: ranks[0][("halo_graph", s)] for s in ("src", "tgt")}
    twin = _twin_grads(inputs["step_params"], inputs["batch"], graphs)
    for r in ranks:
        loss, params = r[("step", halo)]
        assert abs(loss - want_loss) <= 1e-4, (loss, want_loss)
        for name, w in want_params.items():
            _close(params[name], w, 5e-4)
        _grads_close(r[("grads", halo)], twin, 1e-5)
        _grads_close(r[("grads", halo)], got[("grads", halo)], 2e-2)
        # every rank takes the same step
        for name, w in ranks[0][("step", halo)][1].items():
            assert torch.equal(params[name], w), name


def test_all_gather_regime_matches_the_ports_unsharded_step(world, jax_side):
    ranks, _ = world
    inputs, _ = jax_side
    cfg = _cfg()
    state = _step_state(inputs["step_params"], cfg)
    _, m = tengine.make_train_step(state.model, state.optimizer, cfg)(
        state, tengine.batch_to_device(inputs["batch"], "cpu"))
    for r in ranks:
        loss, params = r[("step", None)]
        assert abs(loss - float(m["total"])) <= 1e-4
        for name, w in state.model.state_dict().items():
            _close(params[name], w, 5e-4)


def test_dryrun_passes_in_the_world(world):
    ranks, _ = world
    line = ranks[0]["dryrun"]
    assert line.startswith("dryrun(4): ") and "halo-train loss|grad|param delta" in line, line
    assert all(r["dryrun"] == line for r in ranks)


def test_point_parallel_cli_train_writes_one_checkpoint(world):
    """`cli train` at run.point_parallel=2, run.halo=16 on 4 ranks: a
    {data: 2, point: 2} mesh, one checkpoint (rank 0's) of finite weights."""
    _, out_dir = world
    assert sorted(os.listdir(f"{out_dir}/ck")) == ["step_4.pt"]
    assert len(open(f"{out_dir}/log.jsonl").read().splitlines()) == 1
    sd = torch.load(f"{out_dir}/ck/step_4.pt", weights_only=True)["model"]
    assert all(torch.isfinite(v).all() for v in sd.values())
