"""B1's share of its roofline: the cell's k-NN work (8 FLOP a query and
candidate, over the whole cloud or the curve window) over the device time
of every B1 route's kernels (knn_warp, knn_exact_warp, knn_exact_large,
the thread kernel knn), against the fp32 peak on either path; B4's
chunked kernels are not B1's."""
from benchmark import work
from benchmark.metrics._read import roofline_pct


def read(r):
    return roofline_pct(r, r"knn", r"chunked", lambda s: s.knn(), work.PEAK_FP32)
