"""The accurate-mode fp32 tile kernels' own sources on the CPU:
`csrc/egcl_tile_f32.cu` (B2) and `csrc/egcl_backward_tile_f32.cu` (B3), on
`csrc/egcl_tile_f32.cuh` and `csrc/egcl_edge.cuh`, compiled with g++ against
the host emulation in `tests/torch_cuda_emulation` (fibers for lanes,
barriers for shuffles, `std::atomic_ref`-free atomics on one OS thread, a
per-block buffer for the dynamic shared memory), run at small shapes and held
against the plain accurate versions (`egcl_layer_plain`,
`egcl_backward_plain`, `accurate=True`), and one forward case at each width
against the JAX Pallas kernel in interpret mode. Both compiled widths run:
CP=32 at C=32, and CP=36 at KITTI's C=33 with one head (zero pads in the
channels 33..35; lanes cg < 4 own the tail channels 32..35). This reaches the staging (at C=33 from rows of the true
stride), the row masks, the register-blocked products and their lane layout
(the tail channels at CP=36), the LayerNorm and coordinate reductions with
the pads masked out, the node MLP, the backward's chain, the scatters and
the parameter gradients' tile products and flush at the true width; what
only nvcc and the card can say (that it builds, launches and how fast) is
`chip_smoke.py`'s. Skipped where there is no g++.

The sources are rewritten in two places only: `extern __shared__` becomes a
pointer to the emulated block's buffer, and each `<<<...>>>` launch a call
of its launcher.

Tolerances, relative to each tensor's max-abs scale: 1e-5 for h′, the
coordinate update x′ − x and agg_m; 1e-4 for dh, dx and the 11 parameter
gradients. Both sides are fp32 and only the order of the sums differs.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops.kernels import build
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl as tk
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph

EMULATION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_cuda_emulation")
FWD_TOL, BWD_TOL = 1e-5, 1e-4
# Words, tokens and headers of bf16, TF32 and the tensor cores: none may
# appear in the accurate kernels' sources.
NOT_FP32 = ("mma", "wgmma", "bf16", "bfloat16", "tf32", "half", "fp16", "__nv_",
            "egcl_tile.cuh", "cuda_bf16", "cuda_fp16", "asm")
F32_SOURCES = ("egcl_edge.cuh", "egcl_tile_f32.cuh", "egcl_tile_f32.cu",
               "egcl_backward_tile_f32.cu")


def _compile(out, name, symbol, argtypes):
    with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
        source, n = re.subn(r"(\w+)<<<(\w+), ([\w *]+), (\w+), (\w+)>>>\((.*?)\);",
                            r"emulated_launch(\2, \3, \4, [&] { \1(\6); });", f.read(), flags=re.S)
    assert n == 1
    source, n = re.subn(r"extern __shared__ __align__\(16\) float smem\[\];",
                        "float* smem = static_cast<float*>(emulated_dynamic_shared);", source)
    assert n == 1
    (out / f"{name}.cpp").write_text(source)
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                          "-I", EMULATION, "-I", build.CSRC, "-o", str(out / f"lib{name}.so"),
                          str(out / f"{name}.cpp")], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def fwd(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the tile kernels needs g++")
    return _compile(tmp_path_factory.mktemp("egcl_tile_f32"), "egcl_tile_f32",
                    "egcl_tile_f32_launch",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@pytest.fixture(scope="module")
def bwd(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the tile kernels needs g++")
    return _compile(tmp_path_factory.mktemp("egcl_backward_tile_f32"), "egcl_backward_tile_f32",
                    "egcl_backward_tile_f32_launch",
                    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _layer(heads: int, seed: int, c: int = 32) -> tk.EGCLParams:
    """O(1/√fan-in) weights everywhere, the coord output too, so that the
    coordinate update and the coordinate MLP's backward carry weight."""
    rng = np.random.default_rng(seed)
    egnn = EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=1, num_heads=heads)
    with torch.no_grad():
        for q in egnn.parameters():
            scale = 0.1 if q.ndim == 1 else 1.0 / np.sqrt(q.shape[-1])
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)) * scale)
        egnn.gcl_0.layer_norm.weight.add_(1.0)
    return tk.params_from_layer(egnn.gcl_0)


def _inputs(b, n, k, points, seed, c=32):
    """h [b,n,c], x [b,n,3], nbr [b,n,k]: k > 16 repeats neighbors from a
    second list; 'repeated' puts every point twice (coincident points:
    degenerate frames), 'collinear' every point on one line through the
    origin, exactly (x = t·(1, −1, 1), so x_i × x_j = 0 in fp32: the identity
    frame on every edge)."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32))
    if points == "repeated":
        x[:, 1::2] = x[:, ::2]
    elif points == "collinear":
        x = torch.from_numpy(rng.uniform(-1, 1, (b, n, 1)).astype(np.float32)) * torch.tensor(
            [1.0, -1.0, 1.0])
    nbr = knn_graph(x, min(k, 16)).to(torch.int32)
    if k > 16:
        nbr = torch.cat([nbr, nbr.flip(1)[..., :k - 16]], dim=-1)
    return h, x, nbr.contiguous()


def _rel(got, ref):
    scale = float(ref.abs().max())
    assert scale > 0
    return float((got - ref).abs().max()) / scale


def _forward(fn, h, x, nbr, p, aggm=True):
    b, n, k = nbr.shape
    h_out, x_out = torch.empty_like(h), torch.empty_like(x)
    agg_m = torch.empty_like(h) if aggm else None
    buf = tk.pack_params_f32(p)
    assert fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), buf.data_ptr(), h_out.data_ptr(),
              x_out.data_ptr(), None if agg_m is None else agg_m.data_ptr(), b, n, k,
              h.shape[-1], p.head_width, None) == 0
    return h_out, x_out, agg_m


CASES = [(1, 48, 16, 4, "uniform"), (1, 40, 7, 4, "uniform"), (1, 48, 20, 4, "uniform"),
         (1, 48, 16, 4, "repeated"), (1, 32, 16, 1, "collinear"), (2, 32, 12, 32, "uniform")]
CASE_IDS = ["K16-4heads", "K7-masked-rows", "K20-two-row-tiles", "repeated-points",
            "collinear-points-1head", "B2-K12-32heads"]


@pytest.mark.parametrize("b,n,k,heads,points", CASES, ids=CASE_IDS)
def test_emulated_f32_forward_matches_the_plain_accurate_layer(fwd, b, n, k, heads, points):
    p = _layer(heads, seed=k)
    h, x, nbr = _inputs(b, n, k, points, seed=k)
    gh, gx, gm = _forward(fwd, h, x, nbr, p)
    rh, rx, rm = tk.egcl_layer_plain(h, x, nbr, p, accurate=True, return_aggm=True)
    assert all(bool(torch.isfinite(t).all()) for t in (gh, gx, gm))
    errs = dict(h=_rel(gh, rh), u=_rel(gx - x, rx - x), agg_m=_rel(gm, rm))
    assert max(errs.values()) <= FWD_TOL, errs
    # without agg_m the kernel writes the same h′ and x′
    gh2, gx2, _ = _forward(fwd, h, x, nbr, p, aggm=False)
    assert torch.equal(gh2, gh) and torch.equal(gx2, gx)


# KITTI's width, one head, on the padded instantiation (CP=36)
CASES33 = [(1, 48, 16, "uniform"), (1, 40, 7, "uniform"), (1, 48, 20, "uniform"),
           (1, 48, 16, "repeated")]
CASE33_IDS = ["C33-K16", "C33-K7-masked-rows", "C33-K20-two-row-tiles", "C33-repeated-points"]


@pytest.mark.parametrize("b,n,k,points", CASES33, ids=CASE33_IDS)
def test_emulated_f32_forward_at_c33_matches_the_plain_accurate_layer(fwd, b, n, k, points):
    p = _layer(1, seed=33 + k, c=33)
    h, x, nbr = _inputs(b, n, k, points, seed=33 + k, c=33)
    gh, gx, gm = _forward(fwd, h, x, nbr, p)
    rh, rx, rm = tk.egcl_layer_plain(h, x, nbr, p, accurate=True, return_aggm=True)
    assert all(bool(torch.isfinite(t).all()) for t in (gh, gx, gm))
    errs = dict(h=_rel(gh, rh), u=_rel(gx - x, rx - x), agg_m=_rel(gm, rm))
    assert max(errs.values()) <= FWD_TOL, errs
    gh2, gx2, _ = _forward(fwd, h, x, nbr, p, aggm=False)
    assert torch.equal(gh2, gh) and torch.equal(gx2, gx)


def _jax_forward_case(fwd, c, heads):
    """One layer at B=1, N=128, K=16, width c with `heads` heads: the
    kernel's (h′, x′) and `egcl_layer_pallas(accurate=True)`'s in interpret
    mode, the weights drawn by the JAX EGNN and carried across with
    `params_from_jax`; returns (x, kernel h′, kernel x′, JAX h′, JAX x′)."""
    import jax
    import jax.numpy as jnp

    from se3_equi_graph_registration_tpu.models.egnn import EGNN as JaxEGNN
    from se3_equi_graph_registration_tpu.ops.pallas.egcl_kernel import (
        egcl_layer_pallas, params_from_tree)
    from se3_equi_graph_registration_tpu_torch.train.checkpoints import params_from_jax

    h, x, nbr = _inputs(1, 128, 16, "uniform", seed=9, c=c)
    jmod = JaxEGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=1, num_heads=heads)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.init)(
        jax.random.PRNGKey(0), h.numpy(), x.numpy(), nbr.numpy()))
    jh, jx = egcl_layer_pallas(jnp.asarray(h.numpy()).swapaxes(1, 2),
                               jnp.asarray(x.numpy()).swapaxes(1, 2), jnp.asarray(nbr.numpy()),
                               params_from_tree(params["params"]["gcl_0"]), tile_t=128,
                               chunk=512, interpret=True, accurate=True)
    egnn = EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=1, num_heads=heads)
    sd = params_from_jax({"egnn": params["params"], "mlp": {}})
    egnn.load_state_dict({k[len("egnn."):]: v for k, v in sd.items()})
    gh, gx, _ = _forward(fwd, h, x, nbr, tk.params_from_layer(egnn.gcl_0))
    jh = torch.from_numpy(np.asarray(jh).swapaxes(1, 2).copy())
    jx = torch.from_numpy(np.asarray(jx).swapaxes(1, 2).copy())
    return x, gh, gx, jh, jx


def test_emulated_f32_forward_matches_the_jax_pallas_kernel(fwd):
    """One layer at B=1, N=128, K=16, C=32, 4 heads against
    `egcl_layer_pallas(accurate=True)` in interpret mode, the weights drawn
    by the JAX EGNN and carried across with `params_from_jax`."""
    x, gh, gx, jh, jx = _jax_forward_case(fwd, 32, 4)
    assert _rel(gh, jh) <= FWD_TOL
    assert _rel(gx - x, jx - x) <= 1e-4      # the Pallas update's own fp32 budget (test_torch_egcl)


def test_emulated_f32_forward_at_c33_matches_the_jax_pallas_kernel(fwd):
    """The same at C=33 with one head, on the padded build (CP=36)."""
    x, gh, gx, jh, jx = _jax_forward_case(fwd, 33, 1)
    assert _rel(gh, jh) <= FWD_TOL
    assert _rel(gx - x, jx - x) <= 1e-4      # the Pallas update's own fp32 budget (test_torch_egcl)


def test_f32_sources_issue_no_bf16_tf32_or_tensor_core_instruction():
    for name in F32_SOURCES:
        with open(os.path.join(build.CSRC, name)) as f:
            text = re.sub(r"//[^\n]*", "", f.read()).lower()   # code only, not comments
        found = [w for w in NOT_FP32 if w in text]
        assert not found, (name, found)


def _backward(fn, h, x, nbr, p, dagg_m, dagg_x):
    b, n, k = nbr.shape
    dh, dx = torch.empty_like(h), torch.empty_like(x)
    dh_nbr, dx_nbr = torch.zeros_like(h), torch.zeros_like(x)
    c = h.shape[-1]
    grads = torch.zeros(5 * c * c + 18 * c)
    buf = tk.pack_params_f32(p)
    assert fn(h.data_ptr(), x.data_ptr(), nbr.data_ptr(), buf.data_ptr(), dagg_m.data_ptr(),
              dagg_x.data_ptr(), dh.data_ptr(), dx.data_ptr(), dh_nbr.data_ptr(),
              dx_nbr.data_ptr(), grads.data_ptr(), b, n, k, c, p.head_width, None) == 0
    return dh + dh_nbr, dx + dx_nbr, eb._unpack_grads(grads, c)


@pytest.mark.parametrize("b,n,k,heads,points", CASES + [(1, 48, 16, 4, "coordinate-path")],
                         ids=CASE_IDS + ["coordinate-path"])
def test_emulated_f32_backward_matches_the_plain_accurate_backward(bwd, b, n, k, heads, points):
    """dh, dx and the 11 parameter gradients; 'coordinate-path' has dagg_m = 0,
    so every cotangent reaches the edge MLP through dm = dcm · Wc0 and drel's
    dax · scale term carries its full weight."""
    rng = np.random.default_rng(100 + k)
    p = _layer(heads, seed=k)
    h, x, nbr = _inputs(b, n, k, "uniform" if points == "coordinate-path" else points, seed=k)
    dagg_m = torch.from_numpy(rng.standard_normal((b, n, 32)).astype(np.float32))
    if points == "coordinate-path":
        dagg_m.zero_()
    dagg_x = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    dh, dx, grads = _backward(bwd, h, x, nbr, p, dagg_m, dagg_x)
    rh, rx, rg = eb.egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate=True)
    pairs = dict(dh=(dh, rh), dx=(dx, rx), **{q: (grads[q], rg[q]) for q in rg})
    for name, (got, _) in pairs.items():
        assert bool(torch.isfinite(got).all()), name
    errs = {name: _rel(got, ref) for name, (got, ref) in pairs.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BWD_TOL, (worst, errs)


@pytest.mark.parametrize("b,n,k,points", CASES33 + [(1, 48, 16, "coordinate-path")],
                         ids=CASE33_IDS + ["C33-coordinate-path"])
def test_emulated_f32_backward_at_c33_matches_the_plain_accurate_backward(bwd, b, n, k, points):
    """dh, dx and the 11 parameter gradients at C=33 with one head, at their
    true shapes; 'coordinate-path' as at C=32."""
    rng = np.random.default_rng(133 + k)
    p = _layer(1, seed=33 + k, c=33)
    h, x, nbr = _inputs(b, n, k, "uniform" if points == "coordinate-path" else points,
                        seed=33 + k, c=33)
    dagg_m = torch.from_numpy(rng.standard_normal((b, n, 33)).astype(np.float32))
    if points == "coordinate-path":
        dagg_m.zero_()
    dagg_x = torch.from_numpy(rng.standard_normal((b, n, 3)).astype(np.float32))
    dh, dx, grads = _backward(bwd, h, x, nbr, p, dagg_m, dagg_x)
    rh, rx, rg = eb.egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate=True)
    pairs = dict(dh=(dh, rh), dx=(dx, rx), **{q: (grads[q], rg[q]) for q in rg})
    for name, (got, ref) in pairs.items():
        assert bool(torch.isfinite(got).all()) and got.shape == ref.shape, name
    errs = {name: _rel(got, ref) for name, (got, ref) in pairs.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BWD_TOL, (worst, errs)
