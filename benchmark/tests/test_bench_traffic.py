"""The traffic generator repeats by seed and draws what its mix states."""
import pytest
import torch

from benchmark.traffic import generator


@pytest.mark.parametrize("mix", ["train-b64", "eval-b64"])
def test_pool_repeats_by_seed_and_differs_across_seeds(mix):
    m = dict(generator.load_mix(mix), batch=3, points=300, pool=2)
    a = generator.make_pool(m, 33, 2**31 + 77, "cpu")
    b = generator.make_pool(m, 33, 2**31 + 77, "cpu")
    c = generator.make_pool(m, 33, 5, "cpu")
    assert len(a) == 2
    for ra, rb, rc in zip(a, b, c):
        assert all(torch.equal(ra[k], rb[k]) for k in ra)
        assert not torch.equal(ra["src_pts"], rc["src_pts"])
    assert not torch.equal(a[0]["src_pts"], a[1]["src_pts"])       # the pool's requests differ


def test_pairs_hold_their_pose_labels_and_shapes():
    m = dict(generator.load_mix("train-b64"), batch=4, points=2000, pool=1)
    r = generator.make_pool(m, 32, 3, "cpu")[0]
    assert r["src_pts"].shape == (4, 2000, 3) and r["src_feat"].shape == (4, 2000, 32)
    assert abs(float(r["labels"].mean()) - 0.7) < 0.03               # 70% positives
    R, t = r["gt_pose"][:, :3, :3], r["gt_pose"][:, :3, 3]
    assert torch.allclose(R @ R.mT, torch.eye(3).expand(4, 3, 3), atol=1e-5)
    posed = r["src_pts"] @ R.mT + t[:, None]
    res = torch.linalg.norm(posed - r["tgt_pts"], dim=-1)
    inl = r["labels"] > 0
    assert float(res[inl].max()) < 0.02 and float(res[~inl].median()) > 0.1
    assert torch.allclose(torch.linalg.norm(r["src_feat"], dim=-1), torch.ones(4, 2000), atol=1e-4)


def test_eval_mix_spreads_the_inlier_share():
    m = dict(generator.load_mix("eval-b64"), batch=64, points=500, pool=1)
    share = generator.make_pool(m, 32, 9, "cpu")[0]["labels"].mean(1)
    assert 0.08 < float(share.min()) and float(share.max()) < 0.72 and float(share.std()) > 0.1
