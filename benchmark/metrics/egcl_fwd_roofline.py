"""B2's share of its roofline: `egcl_bound`'s FLOP and bytes of every EGCL
forward of a call over the device time of every B2 route's kernels (the
bf16 tile, the fp32 tile and the SIMT kernel), against the path's peak."""
from benchmark.metrics._read import roofline_pct


def read(r):
    return roofline_pct(r, r"egcl", r"bwd|backward|probe", lambda s: s.egcl_fwd())
