"""The benchmark's yardstick: the H100's published peaks, the least time of
a piece of work, and the operations and bytes of each kernel and of a whole
step, counted from the cell's shapes.

Frozen here, apart from the program: B2's and B3's counts are those the
port's `chip_smoke.py` times its kernels against (`egcl_bound`,
`egcl_backward_bound`), the k-NN's 8 fp32 operations a (query, candidate)
pair, the input read once and the table written once.
"""
from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

KNN_OPS_PER_PAIR = 8       # d² = (‖q‖² − 2 q·c) + ‖c‖² and the compare


def peak_ops(accurate: bool) -> float:
    """The peak of the arithmetic a path states: fp32 off the tensor cores
    for the accurate path, bf16 for the fast path's bf16 operands."""
    return PEAK_FP32 if accurate else PEAK_BF16


def least_s(nbytes: float, ops: float, peak: float) -> float:
    """The least time of the work on one chip: the larger of its operations
    over the peak and its bytes over the memory bandwidth (seconds)."""
    return max(nbytes / PEAK_BYTES, ops / peak)


def bound_ms(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(least ms, what bounds it: 'bytes' or 'operations')."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def egcl_weights(c: int) -> int:
    """Floats of one EGCL layer's weights as the kernels read them: seven
    C×C blocks (w1's h_row and h_col, w2, wc0, wn0's two, wn1), w1's 12
    geometry columns and nine vectors (b1, b2, the LayerNorm's two, bc0,
    wc1, bn0, bn1, and w1's folded edge_attr column)."""
    return 7 * c * c + 21 * c


def _fwd_edge_ops(c: int, wh: int) -> int:
    return 2 * c * (c + 12) + 2 * c * wh + 2 * c * c + 2 * c + 12 * c


def egcl_bound(c: int, wh: int, b: int, n: int, k: int, weights: int) -> tuple[int, int]:
    """B2's (FLOP, bytes) at width c and head width wh over b clouds of n
    centers and k neighbors: its FLOP an edge and a center, each input read
    once, h′ and x′ written once."""
    center_ops = 2 * c * c + 2 * 2 * c * c + 2 * c * c
    ops = b * n * (k * _fwd_edge_ops(c, wh) + center_ops)
    nbytes = 4 * b * n * (2 * c + 6 + k) + weights * 4
    return ops, nbytes


def _bwd_edge_ops(c: int, wh: int) -> int:
    return (2 * c * c * 4 + 2 * c * wh * 2 + 2 * 12 * c * 2 + 2 * c   # products
            + 20 * c + 150)                                          # LN, SiLU, geometry


def egcl_backward_bound(c: int, wh: int, b: int, n: int, k: int,
                        weights: int) -> tuple[int, int]:
    """B3's (FLOP, bytes): the forward edge program it recomputes and the
    backward's, and the centers' products."""
    center = 3 * 2 * c * c
    ops = b * n * (k * (_fwd_edge_ops(c, wh) + _bwd_edge_ops(c, wh)) + center)
    nbytes = 4 * b * n * (2 * c + 6 + k) + 2 * 4 * b * n * (c + 3) + weights * 4
    return ops, nbytes


def knn_bound(b: int, n: int, k: int, window: int) -> tuple[int, int]:
    """B1's (FLOP, bytes) over b clouds of n queries with `window`
    candidates each (n for the whole cloud): 8 FLOP a pair, the points read
    once, the [b, n, k] int32 table written once."""
    return KNN_OPS_PER_PAIR * b * n * window, 4 * b * n * 3 + 4 * b * n * k


class Shapes:
    """The sizes of a cell's work: from its configuration's widths, its
    path (accurate or fast) and its traffic's batch."""

    def __init__(self, model: dict, accurate: bool, batch: int, window: int):
        self.b, self.n, self.k = batch, model["num_nodes"], model["k"]
        self.c_in, self.c = model["in_node_nf"], model["hidden_nf"]
        self.layers, self.heads = model["n_layers"], model["num_heads"]
        self.wh = self.c // self.heads
        self.top_k = model["top_k"]
        self.accurate = accurate
        self.window = self.n if accurate else window     # accurate: the whole cloud

    # each quantity below is for one step or call over both clouds of every pair

    def knn(self) -> tuple[int, int]:
        ops, nbytes = knn_bound(self.b, self.n, self.k, self.window)
        return 2 * ops, 2 * nbytes

    def egcl_fwd(self) -> tuple[int, int]:
        ops, nbytes = egcl_bound(self.c, self.wh, self.b, self.n, self.k, egcl_weights(self.c))
        return 2 * self.layers * ops, 2 * self.layers * nbytes

    def egcl_bwd(self) -> tuple[int, int]:
        ops, nbytes = egcl_backward_bound(self.c, self.wh, self.b, self.n, self.k,
                                          egcl_weights(self.c))
        return 2 * self.layers * ops, 2 * self.layers * nbytes

    def _embed_ops(self) -> int:
        return 2 * (2 * self.b * self.n * (self.c_in * self.c + self.c * self.c))

    def _mlp_ops(self) -> int:
        c = self.c
        per = 2 * (2 * c * c + c * (c // 2) + c // 2)
        return self.b * self.top_k * per

    def _similarity_ops(self) -> int:
        return 2 * 2 * self.b * self.n * self.c       # post- and pre-EGNN

    def forward_model_ops(self) -> int:
        """Model FLOP of one forward over both clouds: the k-NN, the
        embeddings, the EGCL layers, the similarities and the score MLP."""
        return (self.knn()[0] + self._embed_ops() + self.egcl_fwd()[0]
                + self._similarity_ops() + self._mlp_ops())

    def train_model_ops(self) -> int:
        """Model FLOP of one train step: the forward, and the backward
        without the forward that B3 recomputes (B3's own edge program and
        centers; twice the forward's products for the embeddings, the
        similarity and the score MLP)."""
        center = 3 * 2 * self.c * self.c
        bwd_egcl = 2 * self.layers * self.b * self.n * (
            self.k * _bwd_edge_ops(self.c, self.wh) + center)
        bwd_rest = 2 * (self._embed_ops() + self._similarity_ops() + self._mlp_ops())
        return self.forward_model_ops() + bwd_egcl + bwd_rest
