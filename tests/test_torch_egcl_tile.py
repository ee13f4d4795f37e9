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
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
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


def read_tile_buffer(buf: torch.Tensor, cp: int = 32) -> dict:
    """The buffer's layout alone at the compiled width cp: per matrix its
    k-steps of 16, B fragments in (k-step, n-tile, lane = 4g + t, (b0.lo,
    b0.hi, b1.lo, b1.hi)) order with B[16j + 2t + {0, 1, 8, 9}][8n + g], two
    bf16 to a word; then eight fp32 vectors of cp. Returns B = wᵀ [in, cp]
    per matrix and the vectors."""
    out, o, ks, nt = {}, 0, cp // 16, cp // 8
    for name, ksteps in (("w1", 2 * ks + 1), ("w2", ks), ("wc0", ks), ("wn0", 2 * ks),
                         ("wn1", ks)):
        words = ksteps * nt * 64
        f = buf[o:o + words].view(torch.bfloat16).reshape(ksteps, nt, 8, 4, 2, 2)  # j n g t half lo
        out[name] = f.permute(0, 4, 3, 5, 1, 2).reshape(16 * ksteps, cp).to(torch.float32)
        o += words
    for name in ("b1", "b2", "ln_scale", "ln_bias", "bc0", "wc1", "bn0", "bn1"):
        out[name] = buf[o:o + cp]
        o += cp
    assert o == buf.numel() == {32: 4096, 48: 8832}[cp]
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


def read_tile_bwd_buffer(buf: torch.Tensor, cp: int = 32) -> dict:
    """The backward buffer's layout alone at the compiled width cp: per
    matrix cp / 16 k-steps of 16 (the cp channels a cotangent has) and its
    n-tiles, B fragments in the order of `read_tile_buffer`. Returns
    B [cp, 8 · n-tiles] per matrix."""
    out, o, ks = {}, 0, cp // 16
    for name, nt in (("wc0", cp // 8), ("w2", cp // 8), ("w1_h", cp // 4), ("w1_geo", 2)):
        words = ks * nt * 64
        f = buf[o:o + words].view(torch.bfloat16).reshape(ks, nt, 8, 4, 2, 2)  # j n g t half lo
        out[name] = f.permute(0, 4, 3, 5, 1, 2).reshape(cp, 8 * nt).to(torch.float32)
        o += words
    assert o == buf.numel() == {32: 2304, 48: 4992}[cp]
    return out


@pytest.mark.parametrize("head_width", [1, 8, 32])
def test_tile_bwd_buffer_holds_the_weights_a_cotangent_goes_back_through(head_width):
    p = _layer(head_width, seed=4)
    w = read_tile_bwd_buffer(tk.pack_params_tile_bwd(p))
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(w["wc0"], bf(p.wc0))                  # dm = dcm_in · Wc0
    assert torch.equal(w["w2"], bf(p.w2))                    # ds1 = dv · W2, dense
    assert torch.equal(w["w1_h"][:, :32], bf(p.w1_hcol))     # dh_col = du · W1hc
    assert torch.equal(w["w1_h"][:, 32:], bf(p.w1_hrow))     # dh_row = du · W1hr
    assert torch.equal(w["w1_geo"][:, :12], bf(p.w1_geo))    # dgeo = du · W1g
    assert torch.count_nonzero(w["w1_geo"][:, 12:]) == 0     # the 4 padded outputs
    heads = torch.arange(C) // head_width
    assert torch.count_nonzero(w["w2"][heads[:, None] != heads[None, :]]) == 0
    assert tk.pack_for_kernels(p).tile_bwd.numel() == 2304


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
    """The bf16 tile buffers exist at C=32 and, padded to CP=48, at
    32 < C <= 36: at KITTI's C=33 (one head) both the bf16 buffers (CP=48)
    and the fp32 one (CP=36) are the padded ones, and widths above 36 or
    heads that do not divide C have none."""
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    p33 = tk.params_from_layer(egnn.gcl_0)
    packed = tk.pack_for_kernels(p33)
    assert torch.equal(packed.tile, tk.pack_params_tile(p33))
    assert torch.equal(packed.tile_bwd, tk.pack_params_tile_bwd(p33))
    assert packed.tile.numel() == 8832 and packed.tile_bwd.numel() == 4992   # at CP=48
    assert torch.equal(packed.f32, tk.pack_params_f32(p33))
    assert tk.pack_params_f32(p33).numel() == 15552              # Layout<36>::total
    for c, heads in ((37, 1), (16, 1), (36, 1)):
        egnn = EGNN(in_node_nf=c, hidden_nf=c, out_node_nf=c, n_layers=1, num_heads=heads)
        p = tk.params_from_layer(egnn.gcl_0)
        if c == 36:
            p = p._replace(head_width=8)                     # 8 does not divide 36
        for pack in (tk.pack_params_f32, tk.pack_params_tile, tk.pack_params_tile_bwd):
            with pytest.raises(ValueError, match="C=32"):
                pack(p)
        assert tk.pack_for_kernels(p).f32 is None and tk.pack_for_kernels(p).tile is None
    assert tk.pack_for_kernels(_layer(8, 0)).tile.numel() == 4096


@pytest.mark.parametrize("heads", [1, 3])
def test_pack_params_tile_pads_c33_to_48_with_zeros_and_round_trips(heads):
    """At C=33 the bf16 tile buffers are built at CP=48: every matrix holds
    the layer's bf16-rounded weights in its leading corner (w1's geometry
    block at input 48, wn0's agg_m half at input 48) and zeros in every pad
    row and column of the channels 33..47; the vectors (ln_scale, ln_bias
    and wc1 included) are zero past channel 33; the layer reads back from
    the buffers alone."""
    rng = np.random.default_rng(48 + heads)
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=heads)
    with torch.no_grad():
        for q in egnn.parameters():
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)))
    p = tk.params_from_layer(egnn.gcl_0)
    c, cp = 33, 48
    assert tk.tile_width(c) == cp
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    w = read_tile_buffer(tk.pack_params_tile(p), cp)
    real = lambda rows, cols: (slice(0, rows), slice(0, cols))
    blocks = dict(w1=[(real(c, c), p.w1_hcol.T), ((slice(cp, cp + 12), slice(0, c)), p.w1_geo.T),
                      ((slice(cp + 16, cp + 16 + c), slice(0, c)), p.w1_hrow.T)],
                  w2=[(real(c, c), p.w2.T)], wc0=[(real(c, c), p.wc0.T)],
                  wn0=[(real(c, c), p.wn0[:, :c].T),
                       ((slice(cp, cp + c), slice(0, c)), p.wn0[:, c:].T)],
                  wn1=[(real(c, c), p.wn1.T)])
    for name, parts in blocks.items():
        mask = torch.zeros_like(w[name], dtype=torch.bool)
        for (rows, cols), ref in parts:
            assert torch.equal(w[name][rows, cols], bf(ref)), name
            mask[rows, cols] = True
        assert torch.count_nonzero(w[name][~mask]) == 0, name      # every pad exactly 0
    for name, ref in (("b1", p.b1), ("b2", p.b2), ("ln_scale", p.ln_scale),
                      ("ln_bias", p.ln_bias), ("bc0", p.bc0), ("bn0", p.bn0), ("bn1", p.bn1),
                      ("wc1", bf(p.wc1.reshape(-1)))):
        assert torch.equal(w[name][:c], ref) and torch.count_nonzero(w[name][c:]) == 0, name
    wb = read_tile_bwd_buffer(tk.pack_params_tile_bwd(p), cp)
    for name, cols, ref in (("wc0", slice(0, c), p.wc0), ("w2", slice(0, c), p.w2),
                            ("w1_h", slice(0, c), p.w1_hcol),
                            ("w1_h", slice(cp, cp + c), p.w1_hrow),
                            ("w1_geo", slice(0, 12), p.w1_geo)):
        assert torch.equal(wb[name][:c, cols], bf(ref)), name
    for name, live in (("wc0", [(0, c)]), ("w2", [(0, c)]), ("w1_h", [(0, c), (cp, cp + c)]),
                       ("w1_geo", [(0, 12)])):
        mask = torch.zeros_like(wb[name], dtype=torch.bool)
        for a, b in live:
            mask[:c, a:b] = True
        assert torch.count_nonzero(wb[name][~mask]) == 0, name


def test_pack_params_f32_pads_c33_with_zeros_and_round_trips():
    """At C=33 with one head every block of the padded buffer (CP=36) holds
    the layer's weights in its leading corner and zeros in every pad row and
    column (channels 33..35), ln_scale, ln_bias and wc1 included; the agg_m
    half of wn0 starts at row 36; `unpack_params_f32` at the true C returns
    the layer exactly."""
    rng = np.random.default_rng(33)
    egnn = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    with torch.no_grad():
        for q in egnn.parameters():
            q.copy_(torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)))
    p = tk.params_from_layer(egnn.gcl_0)
    buf = tk.pack_params_f32(p)
    assert tk.f32_width(33) == 36 and buf.dtype == torch.float32 and buf.is_contiguous()
    blocks, o = {}, 0
    for name, shape in tk.f32_layout(36):
        blocks[name] = buf[o:o + int(torch.Size(shape).numel())].reshape(shape)
        o += blocks[name].numel()
    assert o == buf.numel() == 15552
    c, cp = 33, 36
    real = {name: torch.zeros(shape, dtype=torch.bool) for name, shape in tk.f32_layout(cp)}
    for name, shape in tk.f32_layout(cp):
        if len(shape) == 1:
            real[name][:c] = True
        elif name == "w1":
            real[name][:c, :c] = real[name][cp:, :c] = True
        elif name == "wn0":
            real[name][:c, :c] = real[name][cp:cp + c, :c] = True
        elif name == "w1g_t":
            real[name][:c, :12] = True
        else:
            real[name][:c, :c] = True
    for name, block in blocks.items():
        assert torch.count_nonzero(block[~real[name]]) == 0, name
        assert torch.count_nonzero(block[real[name]]) == int(real[name].sum()), name
    for name in ("ln_scale", "ln_bias", "wc1"):
        assert torch.count_nonzero(blocks[name][c:]) == 0, name
    assert torch.equal(blocks["w1g_t"][:c, :12], p.w1_geo)
    for name, w in (("wc0_t", p.wc0), ("w2_t", p.w2), ("w1hc_t", p.w1_hcol),
                    ("w1hr_t", p.w1_hrow)):
        assert torch.equal(blocks[name][:c, :c], w), name
    back = tk.unpack_params_f32(buf, p.head_width, c=33)
    for name in tk.EGCLParams._fields[:-1]:
        assert getattr(back, name).shape == getattr(p, name).shape, name
        assert torch.equal(getattr(back, name), getattr(p, name)), name
    assert back.head_width == 33
    with pytest.raises(ValueError, match="holds"):
        tk.unpack_params_f32(buf, p.head_width)                 # read at C=32: the wrong size


def test_egcl_variant_routes_by_shape_and_mode():
    cfg = engine.fast_tpu_config()
    wh = cfg.hidden_nf // cfg.num_heads
    assert not cfg.egnn_accurate
    assert tk.egcl_variant(cfg.hidden_nf, cfg.k, wh, cfg.egnn_accurate) == "tile"
    for k in (1, 12, 16, 20, 60):
        for w in (1, 2, 4, 8, 16, 32):
            assert tk.egcl_variant(32, k, w, False) == "tile"
            assert tk.egcl_variant(32, k, w, True) == "tile_f32"
    assert tk.egcl_variant(33, 16, 33, False) == "tile"           # padded to CP=48
    assert tk.egcl_variant(33, 16, 33, True) == "tile_f32"        # padded to CP=36
    assert tk.egcl_variant(33, 16, 11, True) == "tile_f32"
    assert tk.egcl_variant(33, 16, 11, False) == "tile"
    assert tk.egcl_variant(36, 16, 12, True) == "tile_f32"
    assert tk.egcl_variant(36, 16, 12, False) == "tile"
    for c in (33, 34, 35, 36):                                    # every whole head width
        for w in (w for w in range(1, c + 1) if c % w == 0):
            assert tk.egcl_variant(c, 16, w, False) == "tile"
    assert tk.egcl_variant(37, 16, 37, True) == "simt"            # above the padded width
    assert tk.egcl_variant(37, 16, 37, False) == "simt"
    assert tk.egcl_variant(33, 16, 2, False) == "simt"            # 2 does not divide 33
    assert tk.egcl_variant(40, 16, 8, True) == "simt"
    assert tk.egcl_variant(36, 16, 8, True) == "simt"             # heads must tile C
    assert tk.egcl_variant(64, 16, 8, False) == "simt"
    assert tk.egcl_variant(16, 16, 8, False) == "simt"
    assert tk.egcl_variant(32, 16, 12, False) == "simt"      # heads must tile 32
    assert tk.egcl_variant(32, 16, 12, True) == "simt"


@pytest.mark.parametrize("k", [1, 3, 12, 16, 20])
@pytest.mark.parametrize("head_width", [1, 8, 32])
def test_the_backward_routes_fast_c32_to_the_tile_kernel(k, head_width):
    """`egcl_backward` picks its kernel with the forward's `egcl_variant`:
    at C=32 and at 32 < C <= 36 with whole heads fast mode is 'tile' and
    accurate mode 'tile_f32' at any K, the rest 'simt'."""
    assert tk.egcl_variant(32, k, head_width, False) == "tile"
    assert tk.egcl_variant(32, k, head_width, True) == "tile_f32"
    assert tk.egcl_variant(33, k, 33 if head_width == 32 else 1, False) == "tile"
    assert tk.egcl_variant(37, k, 37 if head_width == 32 else 1, False) == "simt"
    assert tk.egcl_variant(64, k, head_width, False) == "simt"


def test_backward_stages_plain_are_the_cotangents_of_the_plain_backward():
    p = _layer(8, seed=6)
    h, x, nbr = _inputs(16, seed=6)
    rng = np.random.default_rng(6)
    dagg_m = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32))
    dagg_x = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32))
    dcm, dv, du = eb.backward_stages_plain(h, x, nbr, p, dagg_m, dagg_x, accurate=False)
    _, _, grads = eb.egcl_backward_plain(h, x, nbr, p, dagg_m, dagg_x, accurate=False)
    total = lambda t: t.reshape(-1, C).sum(0)
    assert torch.equal(grads["bc0"], total(dcm))
    assert torch.equal(grads["b2"], total(dv))
    assert torch.equal(grads["b1"], total(du))
    bf = lambda t: t.to(torch.bfloat16).to(torch.float32)
    h_col = torch.take_along_dim(h, nbr.reshape(B, -1).long()[..., None], 1).reshape(B, N, 16, C)
    ref = torch.einsum("bnko,bnki->oi", bf(du), bf(h_col))
    assert torch.allclose(grads["w1_hcol"], ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    assert all(t.shape == (B, N, 16, C) for t in (dcm, dv, du))


def test_kernel_params_keeps_both_buffers_and_counters_start_at_zero():
    egnn = EGNN(in_node_nf=C, hidden_nf=C, out_node_nf=C, n_layers=2, num_heads=4)
    kp = tk.kernel_params(egnn)
    assert len(kp.packed) == 2
    for packed, p in zip(kp.packed, kp.layers):
        assert torch.equal(packed.simt, tk.pack_params(p))
        assert torch.equal(packed.tile, tk.pack_params_tile(p))
        assert torch.equal(packed.tile_bwd, tk.pack_params_tile_bwd(p))
        assert torch.equal(packed.f32, tk.pack_params_f32(p))
    h, x, nbr = _inputs(16, seed=1)
    before = dict(tk.egcl_layer.launches_by_variant)
    before_bwd = dict(eb.egcl_backward.launches_by_variant)
    with torch.no_grad():
        tk.egnn_forward(kp, h, x, nbr, accurate=False)      # CPU: the plain version
    assert tk.egcl_layer.launches_by_variant == before       # counts launches only
    assert set(before) == {"tile", "tile_f32", "simt"}
    p = kp.layers[0]
    eb.egcl_backward(h, x, nbr, p, torch.ones(B, N, C), torch.ones(B, N, 3), False, kp.packed[0])
    assert eb.egcl_backward.launches_by_variant == before_bwd
    assert set(before_bwd) == {"tile", "tile_f32", "simt"}


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
