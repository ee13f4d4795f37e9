"""The plain reference of the benchmark: Equi-GSPR's registration model,
its training step and its serving call, written from the model's equations
in plain PyTorch and NumPy, with no kernel, cache or batching of the
program under test. It imports nothing of the program and nothing of JAX.

Weights are a dict {flax-style name: tensor} (the names of the program's
`state_dict`, which the benchmark draws from the seed and hands to both
sides). Precision is a parameter so that the same code gives the reference
and its control:

- `rnd` rounds the operands of every EGNN matrix product: `None` is plain
  float32 (the accurate path), 'bf16' is the fast path's stated precision
  (bf16 operands, float32 accumulation), 'fp8' its control (float8 e4m3
  operands, saturated at ±448);
- the serving head's products (score MLP, Kabsch cross-covariance, the
  quaternion power steps) are float32 and the pose covariance float64; the
  fast path's control takes each a step down too: operands rounded to TF32
  ('tf32', 10 mantissa bits) and the covariance in float32;
- `matmul_precision(True)` is the accurate path's control (TF32 products);
  the reference itself runs with TF32 off.

The k-NN computes d² = (‖q‖² − 2 q·c) + ‖c‖² elementwise in that order and
breaks ties by the lower index (exact keys) or by the window lane (packed
keys, d²'s bits with the low 10 cleared), the graph's defined semantics.
The EGCL layer folds the all-ones edge attribute into the first bias, as
the fused layer's definition does, so its weight column is not rounded.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.nn import functional as F

# ---------------------------------------------------------------- precision


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matrix products in full float32 (tf32=False) or in TF32,
    restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at TF32's 10 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def rounder(kind: Optional[str]):
    """The operand rounding of a matrix product: identity, tf32, bf16 or
    fp8."""
    if kind is None:
        return lambda t: t
    if kind == "tf32":
        return _tf32
    if kind == "bf16":
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        return lambda t: torch.clamp(t, -448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown rounding {kind!r}")


# ---------------------------------------------------------------- sampling


def fit_to_count(arr: np.ndarray, n: int, rng: np.random.Generator
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Sample the leading axis down without replacement (or pad it by
    repeats drawn with replacement) to exactly n rows: (rows, indices)."""
    cur = arr.shape[0]
    if cur == n:
        return arr, np.arange(n)
    if cur > n:
        idx = rng.choice(cur, n, replace=False)
    else:
        idx = np.concatenate([np.arange(cur), rng.choice(cur, n - cur, replace=True)])
    return arr[idx], idx


def sample_request(src_pts, src_feat, tgt_pts, tgt_feat, n: int, seed: int) -> dict:
    """A serving request of B pairs of M ≥ n correspondences cut to n rows a
    pair, pair after pair from one generator of `seed`; every label 1."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("src_pts", "src_feat", "tgt_pts", "tgt_feat")}
    for i in range(len(src_pts)):
        sp, idx = fit_to_count(np.asarray(src_pts[i], np.float32), n, rng)
        cols["src_pts"].append(sp)
        cols["tgt_pts"].append(np.asarray(tgt_pts[i], np.float32)[idx])
        cols["src_feat"].append(np.asarray(src_feat[i], np.float32)[idx])
        cols["tgt_feat"].append(np.asarray(tgt_feat[i], np.float32)[idx])
    out = {k: np.stack(v) for k, v in cols.items()}
    out["labels"] = np.ones(out["src_pts"].shape[:2], np.float32)
    return out


# ---------------------------------------------------------------- k-NN graphs


def _sq_norms(x):
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def _cross_dots(q, c):
    qe, ce = q[..., :, None, :], c[..., None, :, :]
    return (qe[..., 0] * ce[..., 0] + qe[..., 1] * ce[..., 1]) + qe[..., 2] * ce[..., 2]


def _sq_dists(q, c):
    return (_sq_norms(q)[..., :, None] - 2.0 * _cross_dots(q, c)) + _sq_norms(c)[..., None, :]


def knn_whole_cloud(x: torch.Tensor, k: int, rows: int = 256) -> torch.Tensor:
    """Exact k-NN over the whole cloud, self included: [B, N, 3] → [B, N, k]
    int64, ties by the lower index; `rows` queries at a time."""
    out = []
    for s in range(0, x.shape[1], rows):
        d2 = _sq_dists(x[:, s:s + rows], x)
        out.append(torch.sort(d2, dim=-1, stable=True).indices[..., :k])
    return torch.cat(out, dim=1)


def _expand_bits_10(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def hilbert_codes(x: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """3-D Hilbert codes (Skilling's transpose) of x [B, N, 3] min-max
    quantized to `bits` a coordinate, int32 [B, N]."""
    lo = torch.amin(x, dim=-2, keepdim=True)
    hi = torch.amax(x, dim=-2, keepdim=True)
    top = float(2 ** bits - 1)
    span = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((x - lo) * (torch.full_like(span, top) / span), 0.0, top).to(torch.int32)
    X = [q[..., 0], q[..., 1], q[..., 2]]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        P = Q - 1
        for i in range(3):
            cond = (X[i] & Q) != 0
            t = (X[0] ^ X[i]) & P
            x0 = torch.where(cond, X[0] ^ P, X[0] ^ t)
            X[i] = torch.where(cond, X[i], X[i] ^ t)
            X[0] = x0
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = torch.where((X[2] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    X = [xi ^ t for xi in X]
    return ((_expand_bits_10(X[0]) << 2) | (_expand_bits_10(X[1]) << 1)
            | _expand_bits_10(X[2]))


def knn_window_packed(xs: torch.Tensor, k: int, tile: int, window: int) -> torch.Tensor:
    """k-NN of curve-sorted points xs [B, N, 3] over each tile's window of
    candidates, S(i) = clip(i − pad, 0, (N − W)/T)·T with pad =
    ((W − T)/2)/T, by packed int32 keys (d²'s bits & ~0x3FF | lane):
    [B, N, k] int64 in sorted space."""
    b, n, _ = xs.shape
    pad = (window - tile) // 2 // tile if window > tile else 0
    starts = torch.clamp(torch.arange(n // tile, device=xs.device) - pad, 0,
                         (n - window) // tile) * tile
    cols = starts[:, None] + torch.arange(window, device=xs.device)
    d2 = _sq_dists(xs.reshape(b, n // tile, tile, 3), xs[:, cols, :])
    lane = torch.arange(window, device=xs.device, dtype=torch.int32)
    key = (d2.contiguous().view(torch.int32) & ~0x3FF) | lane
    idx = (torch.sort(key, dim=-1).values[..., :k] & 0x3FF).to(torch.int64)
    return (idx + starts[:, None, None]).reshape(b, n, k)


# ---------------------------------------------------------------- the EGNN


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-20)


def _unit(v):
    return v / (torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-20) + 1e-8)


def _gather(values: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    b, n, k = nbr.shape
    flat = nbr.reshape(b, n * k)[..., None]
    return torch.take_along_dim(values, flat, dim=1).reshape(b, n, k, values.shape[-1])


def edge_geometry(x: torch.Tensor, x_col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rel [B,N,K,3], geo [B,N,K,12] = radial, dist, dot, the local frame
    [a|b|c] flattened, identity where degenerate) of the edges center → col."""
    x_row = x[:, :, None, :]
    rel = x_row - x_col
    radial = torch.sum(rel * rel, dim=-1, keepdim=True)
    dist = torch.sqrt(radial + 1e-20)
    dot = torch.sum(x_row * x_col, dim=-1, keepdim=True)
    a = _unit(rel)
    bb = _unit(torch.linalg.cross(x_row.expand_as(x_col), x_col, dim=-1))
    c = torch.linalg.cross(a, bb, dim=-1)
    degen = (_norm(a) < 1e-6) | (_norm(bb) < 1e-6) | (_norm(c) < 1e-6)
    so3 = torch.stack([a, bb, c], dim=-1).reshape(rel.shape[:-1] + (9,))
    eye = torch.eye(3, dtype=so3.dtype, device=so3.device).reshape(9)
    so3 = torch.where(degen[..., None], eye, so3)
    return rel, torch.cat([radial, dist, dot, so3], dim=-1)


def egcl(P: dict, pre: str, h, x, nbr, rnd):
    """One equivariant graph convolution, 'center' direction, sum
    aggregation: (h′, x′)."""
    mm = lambda a, w: torch.matmul(rnd(a), rnd(w).T)
    c = h.shape[-1]
    w1 = P[pre + "edge_mlp.fused_in.weight"]
    b1 = P[pre + "edge_mlp.fused_in.bias"] + w1[:, 2 * c + 12]      # edge_attr = 1
    x_col, h_col = _gather(x, nbr), _gather(h, nbr)
    rel, geo = edge_geometry(x, x_col)
    s1 = F.silu((mm(h, w1[:, :c])[:, :, None, :] + mm(h_col, w1[:, c:2 * c]))
                + mm(geo, w1[:, 2 * c:2 * c + 12]) + b1)
    hk, hb = P[pre + "edge_mlp.head_kernels"], P[pre + "edge_mlp.head_biases"]
    heads, w = hk.shape[0], hk.shape[1]
    y = torch.einsum("...hw,hwv->...hv", rnd(s1.reshape(s1.shape[:-1] + (heads, w))), rnd(hk))
    m = (y + hb).reshape(s1.shape)
    mu = torch.mean(m, dim=-1, keepdim=True)
    var = torch.mean((m - mu) ** 2, dim=-1, keepdim=True)
    m = ((m - mu) * torch.rsqrt(var + 1e-5) * P[pre + "layer_norm.weight"]
         + P[pre + "layer_norm.bias"])
    s = mm(F.silu(mm(m, P[pre + "coord_mlp_0.weight"]) + P[pre + "coord_mlp_0.bias"]),
           P[pre + "coord_mlp_out.weight"])
    x_new = x + torch.sum(rel * s, dim=2)
    agg = torch.sum(m, dim=2)
    out = F.silu(mm(torch.cat([h, agg], dim=-1), P[pre + "node_mlp_0.weight"])
                 + P[pre + "node_mlp_0.bias"])
    return h + (mm(out, P[pre + "node_mlp_1.weight"]) + P[pre + "node_mlp_1.bias"]), x_new


def egnn(P: dict, n_layers: int, h, x, nbr, rnd):
    """Embedding → n_layers × EGCL → output embedding."""
    mm = lambda a, w: torch.matmul(rnd(a), rnd(w).T)
    h = mm(h, P["egnn.embedding_in.weight"]) + P["egnn.embedding_in.bias"]
    for i in range(n_layers):
        h, x = egcl(P, f"egnn.gcl_{i}.", h, x, nbr, rnd)
    return mm(h, P["egnn.embedding_out.weight"]) + P["egnn.embedding_out.bias"], x


# ---------------------------------------------------------------- the head


def score_mlp(P: dict, feats, rnd=lambda t: t):
    lin = lambda a, i: torch.matmul(rnd(a), rnd(P[f"mlp.dense_{i}.weight"]).T) + P[
        f"mlp.dense_{i}.bias"]
    y = F.relu(lin(F.relu(lin(feats, 0)), 1))
    return lin(y, 2)[..., 0]


def _take(values, idx):
    if values.dim() == 2:
        return torch.take_along_dim(values, idx, dim=1)
    return torch.take_along_dim(values, idx[..., None], dim=1)


def top_indices(scores, top_k: int):
    if top_k == scores.shape[-1]:                # every correspondence, in order
        return torch.arange(top_k, device=scores.device).expand_as(scores)
    return torch.topk(scores, top_k, dim=-1).indices


def masked_softmax(scores, mask):
    mask = mask.to(scores.dtype)
    masked = torch.where(mask > 0, scores, torch.full_like(scores, torch.finfo(scores.dtype).min))
    m = torch.amax(masked, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(masked - m) * mask
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


class _SVD3(torch.autograd.Function):
    """3x3 SVD whose backward damps 1/(σj² − σi²) to x/(x² + 1e-12·σmax⁴):
    finite where the weights collapse onto a point and H ≈ εI."""

    @staticmethod
    def forward(ctx, H):
        U, S, Vh = torch.linalg.svd(H, full_matrices=False)
        ctx.save_for_backward(U, S, Vh)
        return U, S, Vh

    @staticmethod
    def backward(ctx, dU, dS, dVh):
        U, S, Vh = ctx.saved_tensors
        V, dV = Vh.mT, dVh.mT
        s2 = S * S
        smax = torch.clamp(torch.amax(S, dim=-1), min=1e-20)
        diff = s2[..., None, :] - s2[..., :, None]
        eps = 1e-12 * smax[..., None, None] ** 4 + 1e-30
        eye = torch.eye(3, dtype=S.dtype, device=S.device)
        Fm = diff / (diff * diff + eps) * (1.0 - eye)
        UtdU, VtdV = U.mT @ dU, V.mT @ dV
        inner = ((Fm * (UtdU - UtdU.mT)) * S[..., None, :]
                 + S[..., :, None] * (Fm * (VtdV - VtdV.mT)) + dS[..., :, None] * eye)
        return U @ inner @ Vh


def _rotation_svd(H):
    U, _, Vh = _SVD3.apply(H)
    V, Ut = Vh.mT, U.mT
    flip = torch.where(torch.linalg.det(V @ Ut) < 0, -1.0, 1.0).to(H.dtype)
    V = torch.cat([V[..., :, :2], V[..., :, 2:] * flip[..., None, None]], dim=-1)
    return V @ Ut


def _rotation_quaternion(H, iters: int = 60, rnd=lambda t: t):
    """Horn's method: the rotation of the dominant eigenvector of K(H), by
    `iters` power steps on K shifted by 2‖H‖_F + 1e-6."""
    s = lambda i, j: H[..., i, j]
    t = s(0, 0) + s(1, 1) + s(2, 2)
    K = torch.stack([
        torch.stack([t, s(1, 2) - s(2, 1), s(2, 0) - s(0, 2), s(0, 1) - s(1, 0)], -1),
        torch.stack([s(1, 2) - s(2, 1), 2 * s(0, 0) - t, s(0, 1) + s(1, 0), s(0, 2) + s(2, 0)], -1),
        torch.stack([s(2, 0) - s(0, 2), s(0, 1) + s(1, 0), 2 * s(1, 1) - t, s(1, 2) + s(2, 1)], -1),
        torch.stack([s(0, 1) - s(1, 0), s(0, 2) + s(2, 0), s(1, 2) + s(2, 1), 2 * s(2, 2) - t], -1),
    ], -2)
    shift = torch.linalg.norm(H, dim=(-2, -1))[..., None, None] * 2.0 + 1e-6
    Ks = K + shift * torch.eye(4, dtype=K.dtype, device=K.device)
    q = torch.full(K.shape[:-1], 0.5, dtype=K.dtype, device=K.device)
    for _ in range(iters):
        q = (rnd(Ks) @ rnd(q)[..., None])[..., 0]
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-30)
    w, a, b, c = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (b**2 + c**2), 2 * (a*b - c*w), 2 * (a*c + b*w)], -1),
        torch.stack([2 * (a*b + c*w), 1 - 2 * (a**2 + c**2), 2 * (b*c - a*w)], -1),
        torch.stack([2 * (a*c - b*w), 2 * (b*c + a*w), 1 - 2 * (a**2 + b**2)], -1),
    ], -2)


def kabsch(src, tgt, weights, solver: str, rnd=None):
    """(R, t) minimizing Σ wᵢ‖R srcᵢ + t − tgtᵢ‖², weights renormalized
    (+1e-6 on the sum), H + 1e-6·I; all-zero weights give (I, 0). `rnd`
    rounds the operands of the cross-covariance and the power steps."""
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    empty = wsum <= 0.0
    w = weights / (wsum + 1e-6)
    sc = torch.sum(w[..., None] * src, dim=-2, keepdim=True)
    tc = torch.sum(w[..., None] * tgt, dim=-2, keepdim=True)
    if rnd is None:
        H = torch.einsum("...n,...ni,...nj->...ij", w, src - sc, tgt - tc)
    else:
        H = torch.einsum("...ni,...nj->...ij", rnd(w[..., None] * (src - sc)), rnd(tgt - tc))
    H = H + 1e-6 * torch.eye(3, dtype=H.dtype, device=H.device)
    R = _rotation_svd(H) if solver == "svd" else _rotation_quaternion(H, rnd=rnd or rounder(None))
    t = tc[..., 0, :] - (R @ sc[..., 0, :, None])[..., 0]
    R = torch.where(empty[..., None], torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R), R)
    return R, torch.where(empty, torch.zeros_like(t), t)


def pose_covariance(src, tgt, R, t, weights, eps: float = 1e-9, dtype=torch.float64):
    """(σ̂²/N_eff)·(Σ ŵᵢ JᵢᵀJᵢ + eps·I)⁻¹, Jᵢ = [−[R sᵢ]ₓ | I], in `dtype`."""
    w = weights.to(dtype)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)
    n_eff = 1.0 / (torch.sum(w * w, dim=-1) + 1e-12)
    rs = torch.einsum("...ij,...nj->...ni", R.to(dtype), src.to(dtype))
    r = rs + t.to(dtype)[..., None, :] - tgt.to(dtype)
    sigma2 = torch.sum(w * torch.sum(r * r, dim=-1), dim=-1) / 3.0
    z = torch.zeros_like(rs[..., 0])
    ax = torch.stack([torch.stack([z, -rs[..., 2], rs[..., 1]], -1),
                      torch.stack([rs[..., 2], z, -rs[..., 0]], -1),
                      torch.stack([-rs[..., 1], rs[..., 0], z], -1)], -2)
    J = torch.cat([-ax, torch.eye(3, dtype=ax.dtype, device=ax.device).expand_as(ax)], dim=-1)
    M = torch.einsum("...n,...nij,...nik->...jk", w, J, J)
    M = M + eps * torch.eye(6, dtype=M.dtype, device=M.device)
    return ((sigma2 / n_eff)[..., None, None] * torch.linalg.inv(M)).float()


# ---------------------------------------------------------------- training


class Model(NamedTuple):
    """The widths of the model a configuration file states."""
    n_layers: int
    top_k: int
    k: int
    loss: dict          # the weights of corr, sim, rot, trans, equi


def _safe_norm(x):
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=-1), min=0.0) + 1e-20)


def _arccos(c, eps=1e-6):
    return torch.arccos(torch.clamp(c, -1.0 + eps, 1.0 - eps))


def losses(out: dict, batch: dict, weights: dict) -> dict:
    """The training losses as the reference scripts combine them: BCE on
    the top-k logits, the standardized-similarity MSE, the pose angles, the
    label-masked chamfer plus cosine MSE; {'total', each term}."""
    s, y = out["scores"], out["top_labels"]
    bce = torch.mean(0.5 * (s + torch.abs(s)) - s * y
                     + torch.log1p(torch.exp(-torch.where(s >= 0, s, -s))))

    def standardize(v):
        return (v - v.mean()) / (v.std(correction=1) + 1e-6)

    sim = torch.mean((standardize(out["similarity"]) - standardize(out["raw_similarity"])) ** 2)
    gt = batch["gt_pose"]
    R_gt, t_gt = gt[:, :3, :3], gt[:, :3, 3]
    trace = (out["R"].mT @ R_gt).diagonal(dim1=-2, dim2=-1).sum(-1)
    rot = torch.mean(_arccos((trace - 1.0) / 2.0))
    cos_t = torch.sum(out["t"] * t_gt, dim=-1) / torch.clamp(
        _safe_norm(out["t"]) * _safe_norm(t_gt), min=1e-8)
    trans = torch.mean(_arccos(cos_t))
    labels = batch["labels"]
    x_tf = torch.einsum("bij,bnj->bni", R_gt, out["x_src"]) + t_gt[:, None, :]
    chamfer = torch.mean(torch.sum((x_tf - out["x_tgt"]) ** 2, dim=-1) * labels)
    hs, ht = out["h_src"], out["h_tgt"]
    cos_h = torch.sum(hs * ht, dim=-1) / (_safe_norm(hs) * _safe_norm(ht) + 1e-8)
    equi = chamfer + torch.mean((cos_h - labels) ** 2)
    terms = dict(corr=bce, sim=sim, rot=rot, trans=trans, equi=equi)
    terms["total"] = sum(weights[k] * v for k, v in terms.items())
    return terms


def train_forward(P: dict, m: Model, batch: dict, rnd=rounder(None)) -> dict:
    """The training forward: whole-cloud exact k-NN graphs, the EGNN on
    both clouds, the train head (top-k by the post-EGNN similarity, score
    MLP logits, Kabsch weights by the masked softmax of the similarity,
    weighted SVD Kabsch over the post-EGNN coordinates)."""
    emb = {}
    for side in ("src", "tgt"):
        x = batch[f"{side}_pts"]
        nbr = knn_whole_cloud(x.float(), m.k)      # the float32 graph at any precision
        emb[side] = egnn(P, m.n_layers, batch[f"{side}_feat"], x, nbr, rnd)
    (hs, xs), (ht, xt) = emb["src"], emb["tgt"]
    sim = torch.sum(hs * ht, dim=-1)
    top = top_indices(sim, m.top_k)
    scores = score_mlp(P, torch.cat([_take(hs, top), _take(ht, top)], dim=-1))
    R, t = kabsch(xs, xt, masked_softmax(sim, batch["labels"]), "svd")
    return dict(R=R, t=t, scores=scores, top_labels=_take(batch["labels"], top),
                similarity=sim,
                raw_similarity=torch.sum(batch["src_feat"] * batch["tgt_feat"], dim=-1),
                h_src=hs, x_src=xs, h_tgt=ht, x_tgt=xt)


def train_steps(P0: dict, m: Model, batches: list, lr: float, rnd=rounder(None),
                rows: Optional[list] = None) -> dict:
    """Adam (β 0.9, 0.999, eps 1e-8 after the root) from the weights P0 over
    `batches`, one step a batch, at the constant learning rate `lr` (the
    staircase schedule's first stair). Returns {'losses': [{term: float}], 'grad':
    {name: the first step's gradient}, 'params1': {name: after the first
    step}, 'params': {name: after the last step}}. `rows` takes those pairs of every batch, in that order: the fault of a
    step that leaves part of its batch out, or in another order."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    opt = torch.optim.Adam(list(P.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    out = {"losses": []}
    for i, batch in enumerate(batches):
        if rows is not None:
            batch = {k: v[torch.as_tensor(rows, device=v.device)] for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        terms = losses(train_forward(P, m, batch, rnd), batch, m.loss)
        terms["total"].backward()
        out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
        if i == 0:
            out["grad"] = {k: v.grad.detach().clone() for k, v in P.items() if v.grad is not None}
        opt.step()
        if i == 0:
            out["params1"] = {k: v.detach().clone() for k, v in P.items()}
    out["params"] = {k: v.detach() for k, v in P.items()}
    return out


# ---------------------------------------------------------------- serving


@torch.no_grad()
def register_forward(P: dict, m: Model, batch: dict, rnd, tile: int = 128,
                     window: int = 384, control: bool = False) -> dict:
    """The serving call on sampled pairs: each cloud Hilbert-sorted, the
    window graph of packed keys, the EGNN in sorted order and un-sorted, the
    eval-fusion head (top-k by the input similarity; the score MLP's logit
    replaces a raw similarity where it is over 0.5 and beats it; weights the
    softmax of the fused scores over their sum), the quaternion Kabsch over
    the input coordinates, the pose covariance. `control` computes the
    head's products on TF32 operands and the covariance in float32. Returns
    {'R', 't', 'cov' per pair, 'similarity_mean' per pair}."""
    rnd_head = rounder("tf32") if control else None
    emb = {}
    for side in ("src", "tgt"):
        x, h = batch[f"{side}_pts"], batch[f"{side}_feat"]
        perm = torch.sort(hilbert_codes(x), dim=-1, stable=True).indices
        xs = torch.take_along_dim(x, perm[..., None], dim=1)
        hs = torch.take_along_dim(h, perm[..., None], dim=1)
        nbr = knn_window_packed(xs, m.k, min(tile, x.shape[1]), min(window, x.shape[1]))
        h_out, _ = egnn(P, m.n_layers, hs, xs, nbr, rnd)
        inv = torch.empty_like(perm).scatter_(-1, perm, torch.arange(
            perm.shape[-1], device=perm.device).expand_as(perm))
        emb[side] = torch.take_along_dim(h_out, inv[..., None], dim=1)
    hs, ht = emb["src"], emb["tgt"]
    raw = torch.sum(batch["src_feat"] * batch["tgt_feat"], dim=-1)
    top = top_indices(raw, m.top_k)
    pred = score_mlp(P, torch.cat([_take(hs, top), _take(ht, top)], dim=-1),
                     rnd_head or rounder(None))
    raw_top = _take(raw, top)
    take = (pred > 0.5) & ((torch.abs(pred - 1.0) < raw_top) | (pred < raw_top))
    fused = raw.scatter(1, top, torch.where(take, pred, raw_top))
    weights = torch.softmax(fused / (torch.sum(fused, dim=-1, keepdim=True) + 1e-6), dim=-1)
    src, tgt = batch["src_pts"], batch["tgt_pts"]
    R, t = kabsch(src, tgt, weights, "quaternion", rnd_head)
    cov = pose_covariance(src, tgt, R, t, weights,
                          dtype=torch.float32 if control else torch.float64)
    return dict(R=R, t=t, cov=cov.float(),
                similarity_mean=torch.sum(hs * ht, dim=-1).mean(-1))
