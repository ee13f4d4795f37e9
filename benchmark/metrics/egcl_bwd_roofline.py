"""B3's share of its roofline: `egcl_backward_bound`'s FLOP and bytes of
every EGCL backward of a step over the device time of every B3 route's
kernels (the bf16 tile, the fp32 tile and the SIMT kernel)."""
from benchmark.metrics._read import roofline_pct


def read(r):
    return roofline_pct(r, r"egcl_bwd|egcl_backward", r"probe", lambda s: s.egcl_bwd())
