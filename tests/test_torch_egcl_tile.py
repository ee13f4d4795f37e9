"""The tile kernel's host side, on the CPU: the buffer `pack_params_tile`
builds for `csrc/egcl_tile.cu`, read back by a plain-torch reader that knows
only the buffer's layout; the routing between the two EGCL forward kernels;
the build's library names.

Tolerances: the reader against `egcl_layer_plain(accurate=False)` at the card
check's fast tolerances (chip_smoke.py): 2e-2 of the scale on h′ and agg_m,
1e-2 on the update u = x′ − x. Both round the same operands to bf16 and
accumulate in fp32; the reader sums the first layer as one [80 → 32] product
and the head layer as a dense 32 x 32 one, so a sum can differ in its last
bit and round to the next bf16 value downstream.
"""
import shutil

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
from se3_equi_graph_registration_tpu_torch.ops.kernels import build
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl as tk
from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph
from se3_equi_graph_registration_tpu_torch.train import engine

B, N, C = 2, 256, 32


def _layer(head_width: int, seed: int) -> tk.EGCLParams:
    """A layer with weights of O(1/√fan-in) everywhere (the seeded init's
    coord output is 1e-3: too small to see a fault in the coord path)."""
    rng = np.random.default_rng(seed)
    egnn = EGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=1,
                num_heads=C // head_width)
    with torch.no_grad():
        for q in egnn.parameters():
            scale = 0.1 if q.ndim == 1 else 1.0 / np.sqrt(q.shape[-1])
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)) * scale)
        egnn.gcl_0.layer_norm.weight.add_(1.0)
    return tk.params_from_layer(egnn.gcl_0)


def _inputs(k: int, seed: int):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1, 1, (B, N, 3)).astype(np.float32))
    return h, x, knn_graph(x, k).to(torch.int32)


def read_tile_buffer(buf: torch.Tensor) -> dict:
    """The buffer's layout alone: per matrix its k-steps of 16, B fragments
    in (k-step, n-tile, lane = 4g + t, (b0.lo, b0.hi, b1.lo, b1.hi)) order
    with B[16j + 2t + {0, 1, 8, 9}][8n + g], two bf16 to a word; then eight
    fp32 vectors of 32. Returns B = wᵀ [in, 32] per matrix and the vectors."""
    out, o = {}, 0
    for name, ksteps in (("w1", 5), ("w2", 2), ("wc0", 2), ("wn0", 4), ("wn1", 2)):
        words = ksteps * 4 * 64
        f = buf[o:o + words].view(torch.bfloat16).reshape(ksteps, 4, 8, 4, 2, 2)  # j n g t half lo
        out[name] = f.permute(0, 4, 3, 5, 1, 2).reshape(16 * ksteps, 32).to(torch.float32)
        o += words
    for name in ("b1", "b2", "ln_scale", "ln_bias", "bc0", "wc1", "bn0", "bn1"):
        out[name] = buf[o:o + 32]
        o += 32
    assert o == buf.numel() == 4096
    return out


def layer_from_tile_buffer(buf, h, x, nbr, return_stages=False):
    """The layer as the tile kernel computes it, from the buffer alone: one
    [80 → 32] first-layer product on [h_col | geo | 0000 | h_row], the dense
    w2, bf16 operands with fp32 accumulation."""
    w = read_tile_buffer(buf)
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    b, n, k = nbr.shape
    flat = nbr.reshape(b, n * k).long()[..., None]
    x_col = torch.take_along_dim(x, flat, dim=1).reshape(b, n, k, 3)
    h_col = torch.take_along_dim(h, flat, dim=1).reshape(b, n, k, -1)
    rel, geo = tk.edge_features(x[:, :, None, :], x_col)
    a = torch.cat([h_col, geo, torch.zeros_like(geo[..., :4]),
                   h[:, :, None, :].expand_as(h_col)], dim=-1)               # [B,N,K,80]
    s1 = F.silu(bf(a) @ w["w1"] + w["b1"])
    m = bf(s1) @ w["w2"] + w["b2"]
    mu = m.mean(-1, keepdim=True)
    m = (m - mu) * torch.rsqrt(((m - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    m = m * w["ln_scale"] + w["ln_bias"]
    s = bf(F.silu(bf(m) @ w["wc0"] + w["bc0"])) @ w["wc1"][:, None]
    agg_m, agg_x = m.sum(2), (rel * s).sum(2)
    o = F.silu(bf(torch.cat([h, agg_m], -1)) @ w["wn0"] + w["bn0"])
    return h + (bf(o) @ w["wn1"] + w["bn1"]), x + agg_x, agg_m


@pytest.mark.parametrize("k", [16, 12])
@pytest.mark.parametrize("head_width", [8, 32])
def test_reader_of_the_tile_buffer_reproduces_the_plain_fast_layer(k, head_width):
    p = _layer(head_width, seed=head_width)
    h, x, nbr = _inputs(k, seed=k)
    gh, gx, gm = layer_from_tile_buffer(tk.pack_params_tile(p), h, x, nbr)
    rh, rx, rm = tk.egcl_layer_plain(h, x, nbr, p, accurate=False, return_aggm=True)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert (rx - x).abs().max() > 1e-2                      # the coord path carries weight
    assert rel(gh, rh) <= 2e-2 and rel(gm, rm) <= 2e-2
    assert rel(gx - x, rx - x) <= 1e-2


@pytest.mark.parametrize("head_width", [1, 8, 16, 32])
def test_tile_buffer_zeros_and_values(head_width):
    p = _layer(head_width, seed=3)
    w = read_tile_buffer(tk.pack_params_tile(p))
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(w["w1"][:32], bf(p.w1_hcol.T))
    assert torch.equal(w["w1"][32:44], bf(p.w1_geo.T))
    assert torch.count_nonzero(w["w1"][44:48]) == 0          # the padded geometry rows
    assert torch.equal(w["w1"][48:], bf(p.w1_hrow.T))
    assert torch.equal(w["w2"], bf(p.w2.T))
    off_block = torch.ones(C, C, dtype=torch.bool)
    for s in range(0, C, head_width):
        off_block[s:s + head_width, s:s + head_width] = False
    assert torch.count_nonzero(w["w2"][off_block]) == 0      # exact zeros off the heads
    assert torch.count_nonzero(w["w2"][~off_block]) > 0
    assert torch.equal(w["wn0"], bf(p.wn0.T)) and torch.equal(w["wn1"], bf(p.wn1.T))
    assert torch.equal(w["wc0"], bf(p.wc0.T))
    assert torch.equal(w["wc1"], bf(p.wc1.reshape(-1)))      # an operand: rounded
    for name, ref in (("b1", p.b1), ("b2", p.b2), ("ln_scale", p.ln_scale),
                      ("ln_bias", p.ln_bias), ("bc0", p.bc0), ("bn0", p.bn0), ("bn1", p.bn1)):
        assert torch.equal(w[name], ref), name               # fp32, not rounded


def test_b_fragments_follow_the_mma_layout():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32))
    f = tk.b_fragments(w)
    bm = w.T.to(torch.bfloat16)
    back = f.reshape(3, 4, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2).reshape(48, 32)
    assert torch.equal(back, bm)
    for j, n, lane in ((0, 0, 0), (1, 2, 13), (2, 3, 31)):
        g, t = lane // 4, lane % 4
        got = f[((j * 4 + n) * 32 + lane) * 4:][:4]
        want = torch.stack([bm[16 * j + 2 * t + d, 8 * n + g] for d in (0, 1, 8, 9)])
        assert torch.equal(got, want)


def test_pack_params_tile_rejects_other_widths():
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    p33 = tk.params_from_layer(egnn.gcl_0)
    with pytest.raises(ValueError, match="C=32"):
        tk.pack_params_tile(p33)
    assert tk.pack_for_kernels(p33).tile is None
    assert tk.pack_for_kernels(_layer(8, 0)).tile.numel() == 4096


def test_egcl_variant_routes_by_shape_and_mode():
    cfg = engine.fast_tpu_config()
    wh = cfg.hidden_nf // cfg.num_heads
    assert not cfg.egnn_accurate
    assert tk.egcl_variant(cfg.hidden_nf, cfg.k, wh, cfg.egnn_accurate) == "tile"
    for k in (1, 12, 16, 20, 60):
        for w in (1, 2, 4, 8, 16, 32):
            assert tk.egcl_variant(32, k, w, False) == "tile"
            assert tk.egcl_variant(32, k, w, True) == "simt"
    assert tk.egcl_variant(33, 16, 33, False) == "simt"
    assert tk.egcl_variant(33, 16, 33, True) == "simt"
    assert tk.egcl_variant(64, 16, 8, False) == "simt"
    assert tk.egcl_variant(16, 16, 8, False) == "simt"
    assert tk.egcl_variant(32, 16, 12, False) == "simt"      # heads must tile 32


def test_kernel_params_keeps_both_buffers_and_counters_start_at_zero():
    egnn = EGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=2, num_heads=4)
    kp = tk.kernel_params(egnn)
    assert len(kp.packed) == 2
    for packed, p in zip(kp.packed, kp.layers):
        assert torch.equal(packed.simt, tk.pack_params(p))
        assert torch.equal(packed.tile, tk.pack_params_tile(p))
    h, x, nbr = _inputs(16, seed=1)
    before = dict(tk.egcl_layer.launches_by_variant)
    with torch.no_grad():
        tk.egnn_forward(kp, h, x, nbr, accurate=False)      # CPU: the plain version
    assert tk.egcl_layer.launches_by_variant == before       # counts launches only
    assert set(before) == {"tile", "simt"}


def test_library_name_follows_the_source_and_every_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    assert "egcl_tile" in build.SOURCES
    names = {n: build._lib_path(n) for n in build.SOURCES}
    assert len(set(names.values())) == len(build.SOURCES)
    with open(csrc / "egcl_tile.cuh", "a") as f:
        f.write("// edited\n")
    after_header = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(after_header[n] != names[n] for n in build.SOURCES)
    with open(csrc / "knn.cu", "a") as f:
        f.write("// edited\n")
    after_source = {n: build._lib_path(n) for n in build.SOURCES}
    assert after_source["knn"] != after_header["knn"]
    assert all(after_source[n] == after_header[n] for n in build.SOURCES if n != "knn")
