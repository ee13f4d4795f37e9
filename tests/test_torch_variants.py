"""The model variants, port against the JAX package on the CPU: the
'cluster' direction, the 'invariant' so3 mode and the PointNet encoder, at
small size (N = 128 to 256, k = 8, C = 16, 2 layers, 2 heads; C = 32 with 4
heads for the reference checkpoint). Weights come from `jax.jit(model.init)`
and load into the port strict.

Tolerances, and the worst errors measured on this machine:
- edge geometry, every (direction, so3_mode): 1e-6 absolute plus 1e-5
  relative (only the order of fp32 operations differs; measured 2.4e-7 on
  the so3 features, 6e-8 on dist, the rest bit for bit);
- `_aggregate` in 'cluster', sum and masked mean: 1e-5 absolute (measured
  0, bit for bit);
- EGNN, every (direction, so3_mode), against the JAX EGNN run op by op:
  h within 1e-4 of its scale, x within 1e-5 of its scale, the coordinate
  update x' - x within 1e-4 of its scale (measured 4.2e-7, 8e-8, 2.5e-5);
- PointNet: 1e-5 of the scale (measured 2.0e-7);
- the engine's forward with PointNet, train and eval_fusion heads: R and t
  within 1e-4, similarities, embeddings and scores within 1e-4 of their
  scale (measured R 1.3e-5 and t 1.3e-5 with the train head, 1.9e-7 with
  eval_fusion; the others at most 9.7e-7);
- one train step in 'cluster' and with PointNet, against JAX's
  value_and_grad of the same loss: the loss breakdown within 1e-5
  relative, each gradient at cosine >= 0.9999 and relative L2 <= 1e-3
  (measured loss 4.1e-6, cosine 1 - 3.5e-8, relative L2 5.2e-4);
- rotation equivariance in 'invariant' (port alone, as the JAX package's
  own tests hold it): h invariant and x' = R x'(x) within 2e-4;
- reference semantics: a `.pth` written by the JAX exporter from random
  weights, served by `Registrar.from_checkpoint(direction='cluster')`,
  against `tests/torch_oracle.py`'s reference forward on the same edges:
  embeddings within 2e-4 + 1e-4 relative, R and t within 1e-4 (measured
  h 1.5e-5, x 1.2e-7, R 2.8e-7, t 3.0e-8).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_oracle
from torch_port_util import (cosine, jax_model_params, jax_train_batch, pair_batches,
                             port_grads, port_train_batch)

from se3_equi_graph_registration_tpu.models.egnn import EGNN as JEGNN
from se3_equi_graph_registration_tpu.models.egnn import _aggregate as jaggregate
from se3_equi_graph_registration_tpu.ops import edge_geometry as jgeo
from se3_equi_graph_registration_tpu.ops import knn as jknn
from se3_equi_graph_registration_tpu.train import checkpoints as jckpt
from se3_equi_graph_registration_tpu.train import engine as jengine
from se3_equi_graph_registration_tpu.train import losses as jlosses
from se3_equi_graph_registration_tpu_torch import serving
from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN, _aggregate
from se3_equi_graph_registration_tpu_torch.ops import edge_geometry as tgeo
from se3_equi_graph_registration_tpu_torch.train import engine as tengine
from se3_equi_graph_registration_tpu_torch.ops.kernels.knn import knn_window
from se3_equi_graph_registration_tpu_torch.train.checkpoints import (
    export_reference_checkpoint, init_weights, params_from_jax)

MODES = [("center", "frame"), ("center", "invariant"), ("cluster", "frame"),
         ("cluster", "invariant")]
MODE_IDS = [f"{d}-{m}" for d, m in MODES]
SMALL = dict(num_nodes=256, k=8, in_node_nf=16, hidden_nf=16, n_layers=2, num_heads=2,
             top_k=32)


def _cloud(seed, b=2, n=128, k=8, c=16):
    """(h, x, nbr): features, points in a 3 m cube and each point's k
    nearest points (itself first, so every row has its self-loop)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    h = rng.standard_normal((b, n, c)).astype(np.float32)
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    nbr = np.argsort(d2, axis=-1, kind="stable")[..., :k].astype(np.int32)
    nbr[..., 0] = np.arange(n)
    return h, x, nbr


def _scaled_err(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / max(np.abs(np.asarray(ref)).max(), 1e-30))


@pytest.mark.parametrize("direction,so3_mode", MODES, ids=MODE_IDS)
def test_edge_geometry_matches_jax(direction, so3_mode):
    _, x, nbr = _cloud(0)
    ref = jgeo.edge_geometry(jnp.asarray(x), jnp.asarray(nbr), direction, so3_mode)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tgeo.edge_geometry(xt, torch.from_numpy(nbr), direction, so3_mode)
    for name in ("rel", "radial", "dist", "dot", "so3"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the self-loop edges (rel = 0) keep values and gradients finite; the
    # invariant ratio feature is √1e-20 / 1e-8 there
    if so3_mode == "invariant":
        np.testing.assert_allclose(got.so3[..., 0, 7].detach().numpy(), 1e-2, rtol=1e-6)
    loss = sum(t.sum() for t in got)
    loss.backward()
    assert torch.isfinite(loss) and bool(torch.all(torch.isfinite(xt.grad)))


@pytest.mark.parametrize("reduce,masked", [("sum", False), ("mean", True)])
def test_cluster_aggregate_matches_jax(reduce, masked):
    rng = np.random.default_rng(1)
    b, n, k, c = 2, 16, 4, 5
    msgs = rng.standard_normal((b, n, k, c)).astype(np.float32)
    nbr = rng.integers(0, n, (b, n, k)).astype(np.int32)
    mask = rng.integers(0, 2, (b, n, k)).astype(np.float32) if masked else None
    ref = jaggregate(jnp.asarray(msgs), jnp.asarray(nbr), "cluster", n,
                     None if mask is None else jnp.asarray(mask), reduce=reduce)
    got = _aggregate(torch.from_numpy(msgs), torch.from_numpy(nbr), "cluster", n,
                     None if mask is None else torch.from_numpy(mask), reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_segment_reductions_match_jax():
    from se3_equi_graph_registration_tpu.ops import segment as jseg
    from se3_equi_graph_registration_tpu_torch.ops import segment as tseg

    rng = np.random.default_rng(7)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)      # some of the 10 buckets stay empty
    for name in ("segment_sum", "segment_mean"):
        ref = getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 10)
        got = getattr(tseg, name)(torch.from_numpy(data), torch.from_numpy(ids), 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, err_msg=name)


def _port_egnn(direction, so3_mode, params, c=16, layers=2, heads=2):
    model = EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=layers,
                 num_heads=heads, direction=direction, so3_mode=so3_mode)
    sd = params_from_jax({"egnn": params["params"], "mlp": {}})
    model.load_state_dict({k[len("egnn."):]: v for k, v in sd.items()})
    return model


@pytest.mark.parametrize("direction,so3_mode", MODES, ids=MODE_IDS)
def test_egnn_matches_jax(direction, so3_mode):
    h, x, nbr = _cloud(2)
    jm = JEGNN(in_node_nf=16, hidden_nf=16, out_node_nf=16, n_layers=2, num_heads=2,
               direction=direction, so3_mode=so3_mode)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), h, x, nbr)
    # op by op: under jit, XLA contracts ‖x_row‖²‖x_col‖² − dot² into an FMA,
    # so a self-loop's cross2 is a rounding residue, not 0, and the
    # invariant ratio feature √cross2 / max(‖rel‖², 1e-8) reads ~1e5 there
    # instead of 1e-2 (ROADMAP Queue C); the port computes what the
    # unfused function computes
    h_ref, x_ref = jm.apply(params, h, x, nbr)
    with torch.no_grad():
        h_got, x_got = _port_egnn(direction, so3_mode, params)(
            torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(nbr))
    assert _scaled_err(h_got, h_ref) <= 1e-4
    assert _scaled_err(x_got, x_ref) <= 1e-5
    assert _scaled_err(x_got.numpy() - x, np.asarray(x_ref) - x) <= 1e-4


@pytest.mark.parametrize("direction", ["center", "cluster"])
def test_invariant_mode_is_rotation_equivariant(direction):
    """h(Rx) = h(x) and x'(Rx) = R x'(x); the k-NN graph is rotation-invariant,
    so the same neighbour lists serve both."""
    from scipy.spatial.transform import Rotation

    h, x, nbr = _cloud(4, b=1)
    model = EGNN(in_node_nf=16, hidden_nf=16, out_node_nf=16, n_layers=2, num_heads=2,
                 direction=direction, so3_mode="invariant")
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():               # a coordinate update well above fp32 noise
        for layer in model.layers():
            layer.coord_mlp_out.weight.mul_(1e3)
    R = torch.from_numpy(Rotation.from_euler("xyz", [0.7, -0.3, 1.1]).as_matrix()).float()
    ht, xt, nt = torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(nbr)
    with torch.no_grad():
        h1, x1 = model(ht, xt, nt)
        h2, x2 = model(ht, xt @ R.T, nt)
    assert float((x1 - xt).abs().max()) > 1e-2
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=2e-4)
    np.testing.assert_allclose(x2.numpy(), (x1 @ R.T).numpy(), atol=2e-4)


def test_pointnet_matches_jax():
    _, x, nbr = _cloud(5)
    jcfg = jengine.EngineConfig(**SMALL, use_pointnet=True)
    jmodel, params = jax_model_params(jcfg)
    ref = jax.jit(lambda p, xx, nn: jmodel.apply(p, xx, nn, method=lambda m, a, b: m.pointnet(
        a, b)))(params, x, nbr)
    model = tengine.build_model(tengine.EngineConfig(**SMALL, use_pointnet=True), device="cpu")
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model.pointnet(torch.from_numpy(x), torch.from_numpy(nbr))
    assert got.shape == (2, 128, 16) and _scaled_err(got, ref) <= 1e-5


def test_seeded_init_covers_the_pointnet_encoder(tmp_path):
    """`init_weights` draws the encoder's Linear layers as flax does
    (LeCun-normal kernels, zero biases), and the reference exporter writes
    no `pointnet.*` key, as the JAX exporter does not."""
    cfg = tengine.EngineConfig(**SMALL, use_pointnet=True)
    state = tengine.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    enc = {n: p.detach() for n, p in state.model.pointnet.named_parameters()}
    assert set(enc) == {f"{m}.{p}" for m in ("conv1.dense_0", "conv1.dense_1", "conv2.dense_0",
                                             "conv2.dense_1", "classifier")
                        for p in ("weight", "bias")}
    for name, p in enc.items():
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            fan_in = p.shape[1]
            assert abs(float(p.std()) * fan_in ** 0.5 - 1.0) < 0.25, name
    path = str(tmp_path / "p.pth")
    export_reference_checkpoint(state.model.state_dict(), path, n_layers=2, num_heads=2,
                                hidden=16)
    ck = torch.load(path, weights_only=False)
    assert not any("pointnet" in k for part in ("egnn_state_dict", "cross_attention_state_dict")
                   for k in ck[part])


def _graphs_agree(pb, k):
    """The premise of the engine comparisons: the JAX exact k-NN and the
    port's whole-cloud k-NN give the same neighbour sets."""
    for pts in (pb.src_pts, pb.tgt_pts):
        ref = np.asarray(jax.vmap(lambda p: jknn.knn_graph(p, k))(jnp.asarray(pts)))
        got = knn_window(torch.from_numpy(pts), k, tile=128, window=None).numpy()
        np.testing.assert_array_equal(np.sort(got, -1), np.sort(ref, -1))


@pytest.mark.parametrize("head_mode", ["train", "eval_fusion"])
def test_pointnet_model_forward_matches_jax(head_mode):
    kw = dict(SMALL, use_pointnet=True)
    jcfg = jengine.EngineConfig(**kw)
    jmodel, params = jax_model_params(jcfg, head_mode=head_mode)
    (pb,) = pair_batches(2)
    _graphs_agree(pb, jcfg.k)
    ref = jax.jit(lambda p, b: jengine._apply_with_graphs(jmodel, jcfg, p, b))(
        params, jax_train_batch(pb))
    tcfg = tengine.EngineConfig(**kw)
    model = tengine.build_model(tcfg, head_mode=head_mode, device="cpu")
    model.load_state_dict(params_from_jax(params))
    got = tengine._apply_with_graphs(model, tcfg, port_train_batch(pb))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    for name in ("raw_similarity", "similarity", "h_src", "h_tgt", "scores"):
        assert _scaled_err(getattr(got, name), getattr(ref, name)) <= 1e-4, name
    # the head's raw features are the encoder's: the eval head's top-k follows them
    assert not np.allclose(got.raw_similarity.numpy(), (pb.src_feat * pb.tgt_feat).sum(-1))
    np.testing.assert_array_equal(np.sort(got.top_indices.numpy(), -1),
                                  np.sort(np.asarray(ref.top_indices), -1))


def jax_grads(jmodel, jcfg, params, batch):
    """(loss breakdown, {port name: gradient}) of the JAX engine's loss, the
    batch an argument of the jitted function (a closed-over batch would be
    constant-folded, its k-NN sorts taking ~20 s to compile)."""
    def loss_fn(p, b):
        out = jengine._apply_with_graphs(jmodel, jcfg, p, b)
        lb = jlosses.total_loss(out, b["gt_pose"], b["labels"], jcfg.loss_weights)
        return lb.total, lb
    (_, lb), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    return lb, {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, g)).items()}


@pytest.mark.parametrize("variant", [dict(direction="cluster"), dict(use_pointnet=True)],
                         ids=["cluster", "pointnet"])
def test_train_step_matches_jax(variant):
    kw = dict(SMALL, **variant)
    jcfg = jengine.EngineConfig(**kw)
    jmodel, params = jax_model_params(jcfg)
    (pb,) = pair_batches(2)
    _graphs_agree(pb, jcfg.k)
    jlb, jg = jax_grads(jmodel, jcfg, params, jax_train_batch(pb))
    tcfg = tengine.EngineConfig(**kw)
    model = tengine.build_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    tlb, tg = port_grads(model, tcfg, port_train_batch(pb))
    for name in jlosses.LossBreakdown._fields:
        ref = float(getattr(jlb, name))
        assert abs(float(getattr(tlb, name).detach()) - ref) <= 1e-5 * max(abs(ref), 1e-6), name
    assert set(tg) == set(jg)
    for name, ref in jg.items():
        assert cosine(tg[name], ref) >= 0.9999, (name, cosine(tg[name], ref))
        assert np.linalg.norm(tg[name] - ref) <= 1e-3 * np.linalg.norm(ref), name
    # and the step itself runs: Adam moves every parameter
    state = tengine.TrainState(model, tengine.build_optimizer(model, tcfg))
    before = [p.detach().clone() for p in model.parameters()]
    state, m = tengine.make_train_step(model, state.optimizer, tcfg)(state, port_train_batch(pb))
    assert abs(float(m["total"]) - float(jlb.total)) <= 1e-5 * abs(float(jlb.total))
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_reference_checkpoint_runs_with_reference_semantics(tmp_path):
    """A reference `.pth` (the JAX exporter, random weights) served in the
    'cluster' direction computes what the reference computes with it: the
    plain-torch oracle of the reference's forward, over its own k-NN edges,
    on the same pair, eval_fusion head."""
    n, k, top_k, layers = 256, 16, 64, 2
    cfg = dict(num_nodes=n, k=k, in_node_nf=32, hidden_nf=32, n_layers=layers, num_heads=4,
               top_k=top_k)
    _, params = jax_model_params(jengine.EngineConfig(**cfg, direction="cluster"),
                                 head_mode="eval_fusion", seed=5)
    path = os.path.join(tmp_path, "ref.pth")
    jckpt.export_reference_checkpoint(params, path, n_layers=layers)
    rng = np.random.default_rng(6)
    src, tgt = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(2))
    f_src, f_tgt = (rng.standard_normal((n, 32)).astype(np.float32) for _ in range(2))

    sd = torch_oracle.load_state_dict(path)
    edges = [torch_oracle.knn_edges(torch.from_numpy(p), k) for p in (src, tgt)]
    ref = torch_oracle.eval_head_forward(sd, torch.from_numpy(f_src), torch.from_numpy(src),
                                         edges[0], torch.from_numpy(f_tgt),
                                         torch.from_numpy(tgt), edges[1], n_layers=layers,
                                         top_k=top_k)
    reg = serving.Registrar.from_checkpoint(path, fast=False, direction="cluster",
                                            device="cpu", **cfg)
    assert reg.cfg.direction == "cluster" and reg._kp is None     # the plain EGNN
    batch = {k_: torch.from_numpy(v[None]) for k_, v in (
        ("src_pts", src), ("tgt_pts", tgt), ("src_feat", f_src), ("tgt_feat", f_tgt))}
    batch["labels"] = torch.ones(1, n)
    for p, (row, _) in zip((src, tgt), edges):     # the premise: the same edges
        got = knn_window(torch.from_numpy(p[None]), k, tile=128, window=None)[0].numpy()
        np.testing.assert_array_equal(np.sort(got, -1), np.sort(row.numpy().reshape(n, k), -1))
    out = tengine._apply_with_graphs(reg.model, reg.cfg, batch)
    np.testing.assert_allclose(out.h_src[0].numpy(), ref["h_src"].numpy(), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out.x_src[0].numpy(), ref["x_src"].numpy(), atol=2e-4, rtol=1e-4)
    R, t, _ = reg.register(src, f_src, tgt, f_tgt)
    np.testing.assert_allclose(R, ref["R"].numpy(), atol=1e-4)
    np.testing.assert_allclose(t, ref["t"].numpy(), atol=1e-4)
