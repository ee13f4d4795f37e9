"""The port's data layer against the JAX package's: the 3DMatch (train
format, torch-tensor and numpy pickles, and test format), KITTI and Redwood
readers, the sampling policies, `PairLoader`, and the numpy copies
`core/se3_np.py` and `utils/trajectory.py`, on roots the tests write
themselves. Every array is held `np.array_equal` (the same numpy code on
the same files and seeds), with `legacy_sampling_rng` on and off.
"""
import ast
import os

import numpy as np
import pytest
from torch_port_util import write_pair_root

from se3_equi_graph_registration_tpu.core import se3_np as jse3
from se3_equi_graph_registration_tpu.data import kitti as jkitti
from se3_equi_graph_registration_tpu.data import pipeline as jpipeline
from se3_equi_graph_registration_tpu.data import redwood as jredwood
from se3_equi_graph_registration_tpu.data import sampling as jsampling
from se3_equi_graph_registration_tpu.data import threedmatch as jthreedmatch
from se3_equi_graph_registration_tpu.utils import trajectory as jtraj
from se3_equi_graph_registration_tpu_torch.core import se3_np as tse3
from se3_equi_graph_registration_tpu_torch.data import kitti as tkitti
from se3_equi_graph_registration_tpu_torch.data import pipeline as tpipeline
from se3_equi_graph_registration_tpu_torch.data import redwood as tredwood
from se3_equi_graph_registration_tpu_torch.data import sampling as tsampling
from se3_equi_graph_registration_tpu_torch.data import threedmatch as tthreedmatch
from se3_equi_graph_registration_tpu_torch.utils import trajectory as ttraj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ("core/se3_np.py", "utils/trajectory.py", "data/sampling.py", "data/threedmatch.py",
          "data/kitti.py", "data/redwood.py", "data/pipeline.py", "data/preprocess/__init__.py",
          "data/preprocess/split.py", "data/preprocess/threedmatch_cli.py", "data/synthetic.py")


def _code(path):
    """The module's syntax tree without docstrings, dumped."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("path", COPIES)
def test_the_numpy_modules_are_copies(path):
    """Apart from docstrings, each numpy module of the port is the JAX
    package's, statement for statement."""
    assert _code(os.path.join(ROOT, "se3_equi_graph_registration_tpu_torch", path)) == \
        _code(os.path.join(ROOT, "se3_equi_graph_registration_tpu", path))


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str):
            assert x == y
        else:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    return {
        "3dmatch": write_pair_root(str(base / "3dmatch"), "3dmatch", feat_dim=64, seed=1),
        "3dmatch-numpy": write_pair_root(str(base / "3dmatch-np"), "3dmatch", feat_dim=33,
                                         seed=2, torch_train=False),
        "kitti": write_pair_root(str(base / "kitti"), "kitti", feat_dim=33, seed=3,
                                 inlier_ratio=0.3),
    }


THREEDMATCH = [("3dmatch", "train", "fcgf"), ("3dmatch", "val", "fcgf"),
               ("3dmatch", "test", "fcgf"), ("3dmatch", "test", "fpfh"),
               ("3dmatch-numpy", "train", "fpfh")]


@pytest.mark.parametrize("legacy", [False, True], ids=["generator", "legacy"])
@pytest.mark.parametrize("root,split,descriptor", THREEDMATCH)
def test_threedmatch_reader(roots, root, split, descriptor, legacy):
    kw = dict(root=roots[root], split=split, descriptor=descriptor, num_node=128, seed=7,
              legacy_sampling_rng=legacy)
    ref, got = jthreedmatch.ThreeDMatchPairDataset(**kw), tthreedmatch.ThreeDMatchPairDataset(**kw)
    assert len(got) == len(ref) > 0
    for i in range(len(ref)):            # one pass each: the generator carries across items
        _equal_items(ref[i], got[i])
    if split == "test":                  # the test pickles' FCGF truncates to 32 channels
        assert got[0][4].shape == (128, 32 if descriptor == "fcgf" else 64)


@pytest.mark.parametrize("mode", ["synthetic_pose", "normalize_to_source"])
def test_threedmatch_augmentations(roots, mode):
    kw = dict(root=roots["3dmatch"], split="train", num_node=96, seed=3, **{mode: True})
    ref, got = jthreedmatch.ThreeDMatchPairDataset(**kw), tthreedmatch.ThreeDMatchPairDataset(**kw)
    for i in range(len(ref)):
        _equal_items(ref[i], got[i])


def test_threedmatch_reference_names(roots):
    kw = dict(num_node=64, seed=1)
    _equal_items(jthreedmatch.ThreeDMatchTrainVal(roots["3dmatch"], "val", **kw)[1],
                 tthreedmatch.ThreeDMatchTrainVal(roots["3dmatch"], "val", **kw)[1])
    _equal_items(jthreedmatch.ThreeDMatchTest(roots["3dmatch"], **kw)[2],
                 tthreedmatch.ThreeDMatchTest(roots["3dmatch"], **kw)[2])


@pytest.mark.parametrize("legacy", [False, True], ids=["generator", "legacy"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_kitti_reader(roots, split, legacy):
    """Train and val: the balanced 70% sampler; test: inlier-only draws,
    with replacement here (fewer inliers than num_node)."""
    kw = dict(root=roots["kitti"], split=split, num_node=128, seed=5,
              legacy_sampling_rng=legacy)
    ref, got = jkitti.KITTIPairDataset(**kw), tkitti.KITTIPairDataset(**kw)
    for i in range(len(ref)):
        _equal_items(ref[i], got[i])
    if split == "test":
        assert got[0][1].min() == 1.0 and got[0][4].shape == (128, 33)


def test_kitti_load_pair(roots):
    path = os.path.join(roots["kitti"], "test_kitti", "test_000.pkl")
    ref, got = jkitti.load_kitti_pair(path, "fcgf"), tkitti.load_kitti_pair(path, "fcgf")
    assert list(ref) == list(got)
    _equal_items(list(ref.values()), list(got.values()))


def _write_redwood_root(root, rng, scene="office1-simulated", n_frag=3, n=200):
    frag_dir = os.path.join(root, scene, "fragments")
    os.makedirs(frag_dir)
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    feat = rng.standard_normal((n, 33)).astype(np.float32)
    for i in range(n_frag):
        pose = np.eye(4)
        pose[:3, 3] = [i * 0.1, 0.05 * i, 0]
        np.save(os.path.join(frag_dir, f"fragment_{i:03d}.npy"), pose)
        keep = rng.permutation(n)[: n - 20 * i]
        np.savez(os.path.join(frag_dir, f"fragment_{i:03d}_fpfh.npz"),
                 xyz=(base - pose[:3, 3].astype(np.float32))[keep],
                 feature=feat[keep] + rng.standard_normal((len(keep), 33)).astype(np.float32)
                 * 0.05)
    return root


@pytest.mark.parametrize("kw", [dict(num_node=150), dict(num_node="all", use_mutual=False),
                                dict(num_node=150, compute_overlap=True, min_overlap=0.95)],
                         ids=["sampled", "all-one-way", "overlap-filter"])
def test_redwood_dataset(tmp_path, kw):
    rng = np.random.default_rng(4)
    ref_root = _write_redwood_root(str(tmp_path / "jax"), rng)
    rng = np.random.default_rng(4)
    got_root = _write_redwood_root(str(tmp_path / "port"), rng)
    ref = jredwood.RedwoodDataset(root=ref_root, select_scene="office1-simulated", seed=2, **kw)
    got = tredwood.RedwoodDataset(root=got_root, select_scene="office1-simulated", seed=2, **kw)
    assert ref._pairs == got._pairs and len(got) > 0
    for i in range(len(ref)):
        _equal_items(ref[i], got[i])


def test_mutual_nn_correspondences():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((60, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    g = f[rng.permutation(60)] + rng.standard_normal((60, 16)).astype(np.float32) * 0.3
    for mutual in (True, False):
        assert np.array_equal(jredwood.mutual_nn_correspondences(f, g, mutual),
                              tredwood.mutual_nn_correspondences(f, g, mutual))


def test_sampling_policies():
    labels = (np.random.default_rng(0).uniform(size=500) < 0.4).astype(np.float32)
    for size, frac in ((100, 0.7), (400, 0.9), (1000, 0.7)):
        rngs = np.random.default_rng(1), np.random.default_rng(1)
        assert np.array_equal(jsampling.balanced_sample(labels, size, frac, rngs[0]),
                              tsampling.balanced_sample(labels, size, frac, rngs[1]))
    for size in (50, 400):
        assert np.array_equal(jsampling.inlier_only_sample(labels, size, np.random.default_rng(2)),
                              tsampling.inlier_only_sample(labels, size, np.random.default_rng(2)))
    with pytest.raises(ValueError):
        tsampling.inlier_only_sample(np.zeros(10), 5, np.random.default_rng(0))
    corr = np.random.default_rng(3).integers(0, 40, (64, 2))
    assert np.array_equal(jsampling.remap_correspondences(corr),
                          tsampling.remap_correspondences(corr))


def test_sample_pair(roots):
    d = jthreedmatch.load_train_pkl(os.path.join(roots["3dmatch"], "train_3dmatch",
                                                 "train_001.pkl"))
    args = [d[k] for k in ("src_pts", "tgt_pts", "src_feat", "tgt_feat", "corr", "labels",
                           "gt_pose")]
    ref = jsampling.sample_pair(*args, 200, 0.7, np.random.default_rng(9))
    got = tsampling.sample_pair(*args, 200, 0.7, np.random.default_rng(9))
    assert type(got).__name__ == "SampledPair" and got._fields == ref._fields
    _equal_items(ref, got)


@pytest.mark.parametrize("legacy,workers", [(True, 3), (False, 1)],
                         ids=["legacy-3-workers", "generator-1-worker"])
def test_pair_loader(roots, legacy, workers):
    """The same seeded shuffle and batches. With the shared generator the
    draws follow the order the workers call the dataset, so one worker."""
    kw = dict(root=roots["3dmatch"], split="train", num_node=64, seed=1,
              legacy_sampling_rng=legacy)
    ref = list(jpipeline.PairLoader(jthreedmatch.ThreeDMatchPairDataset(**kw), 2, seed=4,
                                    num_workers=workers))
    got = list(tpipeline.PairLoader(tthreedmatch.ThreeDMatchPairDataset(**kw), 2, seed=4,
                                    num_workers=workers))
    assert len(got) == len(ref) == 2
    for a, b in zip(ref, got):
        _equal_items(a, b)


def test_se3_np():
    for num_axis in (0, 1, 3):
        for seed in range(3):
            assert np.array_equal(jse3.random_pose(np.random.default_rng(seed), num_axis, 1.4, 0.1),
                                  tse3.random_pose(np.random.default_rng(seed), num_axis, 1.4, 0.1))
    legacy = lambda: np.random.RandomState(5)
    assert np.array_equal(jse3.rotation_matrix(legacy(), 3, 1.0),
                          tse3.rotation_matrix(legacy(), 3, 1.0))
    with pytest.raises(ValueError):
        tse3.rotation_matrix(np.random.default_rng(0), 2, 1.0)
    T = tse3.random_pose(np.random.default_rng(1))
    pts = np.random.default_rng(2).standard_normal((10, 3))
    assert np.array_equal(tse3.transform(pts, T), jse3.transform(pts, T))
    assert np.array_equal(tse3.concatenate(T, T), jse3.concatenate(T, T))
    R, t = tse3.decompose_trans(T)
    assert np.array_equal(tse3.integrate_trans(R, t), T)
    assert tse3.integrate_trans(R.astype(np.float32), t).dtype == np.float32


def test_trajectory_log_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    trans = {f"{i}_{j}": tse3.random_pose(rng) for i, j in ((0, 1), (0, 5), (3, 7))}
    ported, ref = str(tmp_path / "port" / "gt.log"), str(tmp_path / "jax" / "gt.log")
    ttraj.write_trajectory_log(ported, trans, num_fragments=8)
    jtraj.write_trajectory_log(ref, trans, num_fragments=8)
    assert open(ported).read() == open(ref).read()
    got, want = ttraj.read_trajectory_log(ref), jtraj.read_trajectory_log(ported)
    assert list(got) == list(want) == list(trans)
    for k in trans:
        assert np.array_equal(got[k], want[k]) and np.allclose(got[k], trans[k], atol=1e-8)


@pytest.mark.parametrize("writer,kw", [
    ("write_reference_test_archive", dict(n_pairs=2, n_points=64)),
    ("write_reference_kitti_archive", dict(n_train=2, n_val=1, n_test=1, n_points=64)),
    ("write_reference_train_archive", dict(n_train=2, n_val=1, n_points=64)),
], ids=["test", "kitti", "train"])
def test_archive_writers_write_the_jax_packages_files(tmp_path, writer, kw):
    """Both packages' writers, from the same seed, write the same files: the
    same names, lists and pickled values (numpy arrays, and torch tensors
    in the 3DMatch train archive), and return the same names."""
    import pickle

    from se3_equi_graph_registration_tpu.data import synthetic as jsyn
    from se3_equi_graph_registration_tpu_torch.data import synthetic as tsyn

    ref = getattr(jsyn, writer)(str(tmp_path / "jax"), **kw)
    got = getattr(tsyn, writer)(str(tmp_path / "port"), **kw)
    assert got == ref
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                           for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    for rel in files:
        a, b = (tmp_path / side / rel for side in ("jax", "port"))
        if rel.endswith(".txt"):
            assert a.read_text() == b.read_text()
            continue
        da, db = (pickle.load(open(p, "rb")) for p in (a, b))
        assert sorted(da) == sorted(db)
        for key in da:
            x, y = np.asarray(da[key]), np.asarray(db[key])
            assert x.dtype == y.dtype and np.array_equal(x, y), (rel, key)
