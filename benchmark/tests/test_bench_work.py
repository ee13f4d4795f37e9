"""The frozen work functions against the bound figures of the port's
kernel table (PERF.md §6, `chip_smoke.py`): B2 and B3 at N=2048, B=64,
K=16 against the fp32 peak."""
import pytest

from benchmark import work


@pytest.mark.parametrize("c, wh, b2_ms, b3_ms", [(32, 8, 0.1983, 0.5576), (33, 33, 0.2608, 0.7426)])
def test_egcl_bounds_reproduce_the_kernel_table(c, wh, b2_ms, b3_ms):
    w = work.egcl_weights(c)
    ms, by = work.bound_ms(*reversed(work.egcl_bound(c, wh, 64, 2048, 16, w)), work.PEAK_FP32)
    assert round(ms, 4) == b2_ms and by == "operations"
    ms, by = work.bound_ms(*reversed(work.egcl_backward_bound(c, wh, 64, 2048, 16, w)),
                           work.PEAK_FP32)
    assert round(ms, 4) == b3_ms and by == "operations"


def test_knn_bound_reproduces_the_kernel_table():
    # whole cloud at k=16: 0.0321 ms; the window of 384: 0.0060 ms
    for window, ms in ((2048, 0.0321), (384, 0.0060)):
        ops, nbytes = work.knn_bound(64, 2048, 16, window)
        assert round(work.bound_ms(nbytes, ops, work.PEAK_FP32)[0], 4) == ms


def test_step_counts_add_up():
    model = dict(num_nodes=2048, k=16, in_node_nf=32, hidden_nf=32, n_layers=3, num_heads=4,
                 top_k=128)
    s = work.Shapes(model, True, 64, 384)
    assert s.window == 2048                     # the accurate path searches the whole cloud
    assert s.egcl_fwd()[0] == 6 * work.egcl_bound(32, 8, 64, 2048, 16, 7840)[0]
    assert s.forward_model_ops() < s.train_model_ops() < 4 * s.forward_model_ops()
    fast = work.Shapes(model, False, 64, 384)
    assert fast.window == 384 and fast.knn()[0] == 2 * 8 * 64 * 2048 * 384
