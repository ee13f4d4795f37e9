"""Port vs JAX: the offline data path — `data/preprocess/{pairs,split,
threedmatch_cli,kitti_cli}.py` and `tools/eval_files.py` — on inputs the
tests write themselves (fragment `.npz` files, `gt.log` files, FCGF-style
pair archives, velodyne `.bin` scans).

Tolerances: the numpy routes ('fcgf' and 'raw' descriptors, the split, the
pair build) run the same numpy code on the same files and seeds, so every
written field is held equal, dtype included, with `legacy_rng` on and off.
The native 'fpfh' route computes FPFH in torch on one side and in jnp on the
other: an edge within fp noise of a bin boundary lands in the next bin (the
FMA contractions of XLA), so it is held by the share of equal correspondence
rows (≥ 0.95, measured ≥ 0.99), the points themselves exactly. The
evaluation report: translation, recall and F1 within 1e-6 relative, rotation
within 1e-3 deg (arccos near trace 3 turns an ulp of the float32 rotation
into ~2e-4 deg at 1 deg of error).
"""
import ast
import os
import pickle
import random
import sys

import numpy as np
import pytest

from se3_equi_graph_registration_tpu.data.preprocess import kitti_cli as jkitti
from se3_equi_graph_registration_tpu.data.preprocess import pairs as jpairs
from se3_equi_graph_registration_tpu.data.preprocess import split as jsplit
from se3_equi_graph_registration_tpu.data.preprocess import threedmatch_cli as jtdm
from se3_equi_graph_registration_tpu.data.synthetic import random_rotation
from se3_equi_graph_registration_tpu.tools import eval_files as jeval
from se3_equi_graph_registration_tpu_torch.core import se3_np
from se3_equi_graph_registration_tpu_torch.data.preprocess import kitti_cli as tkitti
from se3_equi_graph_registration_tpu_torch.data.preprocess import pairs as tpairs
from se3_equi_graph_registration_tpu_torch.data.preprocess import split as tsplit
from se3_equi_graph_registration_tpu_torch.data.preprocess import threedmatch_cli as ttdm
from se3_equi_graph_registration_tpu_torch.tools import eval_files as teval
from se3_equi_graph_registration_tpu_torch.utils.trajectory import write_trajectory_log

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the copies, function by function ---------------------------------------

class _DropDevice(ast.NodeTransformer):
    """Takes out of a syntax tree what threading `device` adds: a parameter
    named `device` and its default, `device=` keywords, and the
    `add_argument("--device", ...)` statement."""

    def visit_arguments(self, node):
        self.generic_visit(node)
        names = [a.arg for a in node.args]
        if "device" in names:
            i = names.index("device")
            j = i - (len(node.args) - len(node.defaults))
            del node.args[i]
            if j >= 0:
                del node.defaults[j]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node

    def visit_Expr(self, node):
        call = node.value
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and call.func.attr == "add_argument" and call.args
                and isinstance(call.args[0], ast.Constant) and call.args[0].value == "--device"):
            return None
        return self.generic_visit(node)


def _functions(path, drop_device):
    """{top-level function or class name: its syntax tree dumped, without
    docstrings (and without the device threading when asked)}."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    if drop_device:
        tree = ast.fix_missing_locations(_DropDevice().visit(tree))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("module,threaded", [
    ("pairs.py", {"extract_fpfh"}),
    ("kitti_cli.py", {"process_archives", "make_sequence_pairs", "main"}),
])
def test_pairs_and_kitti_cli_are_copies_apart_from_the_device(module, threaded):
    path = os.path.join("data", "preprocess", module)
    ref = _functions(os.path.join(ROOT, "se3_equi_graph_registration_tpu", path), False)
    got = _functions(os.path.join(ROOT, "se3_equi_graph_registration_tpu_torch", path), False)
    assert got.keys() == ref.keys()
    assert {n for n in ref if got[n] != ref[n]} == threaded
    dropped = _functions(os.path.join(ROOT, "se3_equi_graph_registration_tpu_torch", path), True)
    assert dropped == ref


# --- split, pair build, augment (tests/test_data.py) --------------------------

def test_split_tool(tmp_path):
    d = tmp_path / "train_3dmatch"
    d.mkdir()
    for i in range(20):
        (d / f"p{i}.pkl").write_bytes(b"x")
    (d / "notes.txt").write_text("not a pair")
    outs = {}
    for name, mod in (("port", tsplit), ("jax", jsplit)):
        outs[name] = mod.split_dataset(str(tmp_path), "train_3dmatch", val_fraction=0.2,
                                       test_fraction=0.1, seed=3)
        outs[name + " files"] = [(tmp_path / f).read_text() for f in
                                 ("train_files.txt", "val_files.txt", "test_files.txt")]
    assert outs["port"] == outs["jax"] and outs["port files"] == outs["jax files"]
    out = outs["port"]
    assert len(out["val"]) == 4 and len(out["test"]) == 2 and len(out["train"]) == 14
    assert set(out["val"]).isdisjoint(out["train"]) and "notes.txt" not in sum(out.values(), [])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tsplit.split_dataset(str(tmp_path), "empty")


def _equal_pair(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def test_preprocess_pair_build(rng):
    n = 200
    src = rng.standard_normal((n, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, 0.0, 0.0]
    tgt = src + pose[:3, 3]
    feat = rng.standard_normal((n, 32)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True)
    pair = tpairs.build_pair(src, tgt, feat, feat, pose, inlier_threshold=0.10,
                             file_0="a", file_1="b")
    _equal_pair(pair, jpairs.build_pair(src, tgt, feat, feat, pose, inlier_threshold=0.10,
                                        file_0="a", file_1="b"))
    np.testing.assert_array_equal(pair["corr"][:, 1], np.arange(n))
    assert pair["labels"].sum() == n and pair["labels"].dtype == np.int32
    feat2 = rng.standard_normal((n, 32)).astype(np.float32)
    pair2 = tpairs.build_pair(src, tgt, feat, feat2, pose, inlier_threshold=0.10)
    _equal_pair(pair2, jpairs.build_pair(src, tgt, feat, feat2, pose, inlier_threshold=0.10))
    assert pair2["labels"].sum() < n
    # the blocked similarity: blocks smaller than the cloud give the same rows
    np.testing.assert_array_equal(tpairs.feature_nn_correspondences(feat, feat2, block=64),
                                  jpairs.feature_nn_correspondences(feat, feat2))
    np.testing.assert_array_equal(tpairs.normalize_descriptors(feat2 * 3),
                                  jpairs.normalize_descriptors(feat2 * 3))


@pytest.mark.parametrize("jitter", [0.0, 0.005])
def test_augment_target_consistency(jitter):
    tgt = np.random.default_rng(5).standard_normal((100, 3)).astype(np.float32)
    aug_pts, pose = tpairs.augment_target(tgt, np.random.default_rng(7), jitter=jitter)
    ref_pts, ref_pose = jpairs.augment_target(tgt, np.random.default_rng(7), jitter=jitter)
    np.testing.assert_array_equal(aug_pts, ref_pts)
    np.testing.assert_array_equal(pose, ref_pose)
    if not jitter:
        np.testing.assert_allclose(se3_np.transform(tgt, pose), aug_pts, atol=1e-5)


# --- the 3DMatch CLI -------------------------------------------------------

def _fragment(rng, n, c):
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.standard_normal((n, c)).astype(np.float32))


@pytest.fixture(scope="module")
def threedmatch_root(tmp_path_factory):
    """Fragments `f<i>.npz` (xyz, feature; `f<i>_fcgf.npz` beside each, in
    the other key names and 8 channels), a pair list, and a test root of two scenes
    with gt.log files (one pair's fragment missing)."""
    base = tmp_path_factory.mktemp("threedmatch")
    rng = np.random.default_rng(11)
    frag = base / "fragments_train"
    frag.mkdir()
    for i in range(4):
        xyz, f = _fragment(rng, 150 + 10 * i, 16)
        np.savez(frag / f"f{i}.npz", xyz=xyz, feature=f)
        np.savez(frag / f"f{i}_fcgf.npz", pcd=xyz, feat=f[:, :8])
    (base / "pairs.txt").write_text("f0.npz f1.npz 0.5\nf1.npz f2.npz\n\nf2.npz f3.npz 0.4\n"
                                    "f3.npz f0.npz 0.3\nbad\n")
    test = base / "test_root"
    for s, scene in enumerate(("scene-a", "scene-b")):
        (test / "fragments" / scene).mkdir(parents=True)
        gt = {}
        for i in range(3):
            xyz, f = _fragment(rng, 120, 33)
            np.savez(test / "fragments" / scene / f"cloud_bin_{i}.npz", xyz=xyz, feature=f)
        for a, b in ((0, 1), (1, 2), (0, 2 + s)):
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = random_rotation(rng), rng.standard_normal(3)
            gt[f"{a}_{b}"] = T
        write_trajectory_log(str(test / "gt_result" / f"{scene}-evaluation" / "gt.log"), gt,
                             num_fragments=3)
    return base


def _outputs(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def _same_outputs(a, b):
    ra, rb = _outputs(a), _outputs(b)
    assert ra and ra.keys() == rb.keys()
    for k in ra:
        _equal_pair(ra[k], rb[k])
    return ra


@pytest.mark.parametrize("descriptor,legacy", [("fcgf", False), ("fcgf", True),
                                               ("fpfh", True), ("raw", False)])
def test_threedmatch_training_pairs(threedmatch_root, tmp_path, descriptor, legacy):
    counts = []
    for name, mod in (("port", ttdm), ("jax", jtdm)):
        np.random.seed(17)
        random.seed(17)
        counts.append(mod.make_training_pairs(
            str(threedmatch_root / "fragments_train"), str(threedmatch_root / "pairs.txt"),
            str(tmp_path / name), seed=4, descriptor=descriptor, legacy_rng=legacy,
            random_swap=legacy))
    assert counts == [4, 4]
    out = _same_outputs(tmp_path / "port", tmp_path / "jax")
    pair = next(iter(out.values()))
    assert pair["corr"].dtype == np.int64 and pair["labels"].dtype == np.int32
    assert pair["feat_0"].shape[1] == (8 if descriptor == "fcgf" else 16)


def test_threedmatch_test_pairs_and_main(threedmatch_root, tmp_path, monkeypatch):
    scenes = ("scene-a", "scene-b")
    root = str(threedmatch_root / "test_root")
    n = [mod.make_test_pairs(root, str(tmp_path / name), scenes=scenes)
         for name, mod in (("port", ttdm), ("jax", jtdm))]
    assert n == [5, 5]                       # scene-b's 0_3 has no cloud_bin_3
    out = _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert out["scene-a@0_1.pkl"]["file_1"] == "scene-a_1"
    # main: train mode with no augmentation through argv, both packages
    for name, mod in (("main-port", ttdm), ("main-jax", jtdm)):
        monkeypatch.setattr(sys, "argv", [
            "threedmatch_cli", "train", str(threedmatch_root / "fragments_train"),
            str(threedmatch_root / "pairs.txt"), str(tmp_path / name), "--no-augment",
            "--descriptor", "raw"])
        mod.main()
    for pair in _same_outputs(tmp_path / "main-port", tmp_path / "main-jax").values():
        np.testing.assert_array_equal(pair["gt_pose"], np.eye(4, dtype=np.float32))


# --- the KITTI CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_archives(tmp_path_factory):
    """FCGF-style pair archives (xyz0/xyz1/features0/features1/gt_trans):
    a posed copy with noise and a share of moved rows, so labels mix."""
    d = tmp_path_factory.mktemp("kitti_archives")
    rng = np.random.default_rng(12)
    for i in range(3):
        n = 180 + 20 * i
        src = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = random_rotation(rng), rng.standard_normal(3)
        tgt = src @ T[:3, :3].T + T[:3, 3] + rng.standard_normal((n, 3)) * 0.05
        tgt[: n // 3] = rng.uniform(-3, 3, (n // 3, 3))
        f = rng.standard_normal((n, 32)).astype(np.float32)
        np.savez(d / f"{i:06d}.npz", xyz0=src, xyz1=tgt.astype(np.float32), features0=f,
                 features1=f + rng.standard_normal(f.shape).astype(np.float32) * 0.2,
                 gt_trans=T)
    return d


@pytest.mark.parametrize("split,legacy,mutual", [("test", False, False), ("train", False, True),
                                                 ("train", True, False)])
def test_kitti_archives_fcgf(kitti_archives, tmp_path, split, legacy, mutual):
    kw = {} if split == "test" else dict(augment_axis=3, augment_rotation=1.0,
                                         augment_translation=0.5)
    counts = []
    for name, mod in (("port", tkitti), ("jax", jkitti)):
        np.random.seed(23)
        counts.append(mod.process_archives(str(kitti_archives), str(tmp_path / name),
                                           split=split, seed=9, legacy_rng=legacy,
                                           use_mutual=mutual, **kw))
    assert counts == [3, 3]
    out = _same_outputs(tmp_path / "port", tmp_path / "jax")
    pair = out["000000.pkl"]
    assert pair["labels"].dtype == np.int64 and 0 < pair["labels"].sum() < len(pair["labels"])
    with pytest.raises(ValueError, match="split"):
        tkitti.process_archives(str(kitti_archives), str(tmp_path / "x"), split="val")


def test_kitti_main_archives(kitti_archives, tmp_path, monkeypatch):
    for name, mod in (("port", tkitti), ("jax", jkitti)):
        monkeypatch.setattr(sys, "argv", ["kitti_cli", str(kitti_archives), str(tmp_path / name),
                                          "--archives", "--split", "test"]
                            + (["--device", "cpu"] if name == "port" else []))
        mod.main()
    _same_outputs(tmp_path / "port", tmp_path / "jax")


# --- the native FPFH route ---------------------------------------------------

def _surface(rng, n):
    """A Gaussian-bump height field (locally distinctive geometry), 3 m wide."""
    centers = rng.uniform(-1.5, 1.5, (12, 2))
    amps = rng.uniform(-0.4, 0.4, 12)
    xy = rng.uniform(-1.5, 1.5, (n, 2))
    z = sum(a * np.exp(-((xy - c) ** 2).sum(-1) / 0.2) for c, a in zip(centers, amps))
    return np.concatenate([xy, z[:, None]], -1).astype(np.float32)


def _share_equal_rows(a, b):
    return float(np.mean(np.all(a == b, axis=1)))


def test_native_fpfh_route_on_the_cpu(tmp_path):
    """pairs.extract_fpfh(backend='native') and both KITTI routes that use
    it (process_archives at 'fpfh', make_sequence_pairs on velodyne scans),
    the port at device='cpu' against the JAX package: identical points,
    correspondences equal row for row in ≥ 95% of the rows."""
    rng = np.random.default_rng(13)
    cloud = _surface(rng, 900)
    for backend in ("native", "auto"):
        pts, feat = tpairs.extract_fpfh(cloud, voxel_size=0.1, backend=backend, device="cpu")
        rpts, rfeat = jpairs.extract_fpfh(cloud, voxel_size=0.1, backend=backend)
        np.testing.assert_array_equal(pts, rpts)
        assert feat.shape == rfeat.shape == (len(pts), 33) and feat.dtype == np.float32
    # raw scans → pairs, 2 frames apart; then archives at 'fpfh'
    velo = tmp_path / "velodyne"
    velo.mkdir()
    poses = []
    for i in range(3):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = random_rotation(rng) if i else np.eye(3), [0.1 * i, 0, 0]
        poses.append(T)
        scan = np.concatenate([se3_np.transform(cloud, np.linalg.inv(T)),
                               rng.uniform(size=(len(cloud), 1))], 1).astype(np.float32)
        scan.tofile(velo / f"{i:06d}.bin")
    np.savetxt(tmp_path / "poses.txt", np.stack([p[:3].reshape(-1) for p in poses]))
    n = [mod.make_sequence_pairs(str(velo), str(tmp_path / "poses.txt"), str(tmp_path / name),
                                 frame_step=2, voxel_size=0.1, **kw)
         for name, mod, kw in (("seq-port", tkitti, dict(device="cpu")), ("seq-jax", jkitti, {}))]
    assert n == [1, 1]
    arch = tmp_path / "arch"
    arch.mkdir()
    f = np.zeros((len(cloud), 4), np.float32)
    np.savez(arch / "000000.npz", xyz0=cloud, xyz1=se3_np.transform(cloud, poses[1]),
             features0=f, features1=f, gt_trans=poses[1])
    for name, mod, kw in (("arch-port", tkitti, dict(device="cpu")), ("arch-jax", jkitti, {})):
        mod.process_archives(str(arch), str(tmp_path / name), descriptor="fpfh",
                             voxel_size=0.1, **kw)
    for a, b in (("seq-port", "seq-jax"), ("arch-port", "arch-jax")):
        got, ref = _outputs(tmp_path / a), _outputs(tmp_path / b)
        assert got.keys() == ref.keys()
        for k in got:
            for field in ("xyz_0", "xyz_1", "gt_pose"):
                np.testing.assert_array_equal(got[k][field], ref[k][field])
            share = _share_equal_rows(got[k]["corr"], ref[k]["corr"])
            assert share >= 0.95, (a, k, share)
            assert got[k]["labels"].dtype == ref[k]["labels"].dtype


def test_extract_fpfh_backends_without_open3d():
    """This image has no open3d: 'open3d' raises ImportError naming the
    native route; an unknown backend raises ValueError."""
    try:
        import open3d  # noqa: F401
        pytest.skip("open3d is installed")
    except ImportError:
        pass
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(ImportError, match="backend='native'"):
        tpairs.extract_fpfh(pts, backend="open3d", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tpairs.extract_fpfh(pts, backend="pcl", device="cpu")


# --- file evaluation (tests/test_nn_extras.py) ------------------------------

def test_evaluate_pairwise_frames(tmp_path, rng):
    """An exact prediction and three off by ~0.5-2 deg / cm, through both
    packages' evaluate_pairwise_frames on the same files."""
    import torch

    from se3_equi_graph_registration_tpu_torch.core.quaternions import (
        rotation_matrix_to_quaternion)

    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    pred_dir = tmp_path / "pred"
    pred_dir.mkdir()
    names = []
    for i in range(4):
        R = random_rotation(rng)
        t = rng.standard_normal(3) * 0.3
        src = rng.standard_normal((100, 3))
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R, t
        with open(gt_dir / f"{i:04d}.pkl", "wb") as f:
            pickle.dump({"gt_pose": pose, "xyz_0": src, "xyz_1": src @ R.T + t}, f)
        w = rng.standard_normal(3) * 0.015 * i
        Rp = _expm(w) @ R
        q = rotation_matrix_to_quaternion(torch.from_numpy(Rp.astype(np.float32))).numpy()
        q_xyzw = np.concatenate([q[1:], q[:1]])
        tp = t + rng.standard_normal(3) * 0.01 * i
        (pred_dir / f"{i:04d}.txt").write_text(" ".join(map(str, np.concatenate([q_xyzw, tp]))))
        names.append(f"{i:04d}")
    args = ([n + ".pkl" for n in names], [n + ".txt" for n in names], str(gt_dir),
            str(pred_dir))
    got = teval.evaluate_pairwise_frames(*args, str(tmp_path / "port"))
    ref = jeval.evaluate_pairwise_frames(*args, str(tmp_path / "jax"))
    assert got.keys() == ref.keys()
    assert abs(got["avg_rotation_error_deg"] - ref["avg_rotation_error_deg"]) <= 1e-3
    for k in ("avg_translation_error_cm", "avg_registration_recall", "avg_f1"):
        assert abs(got[k] - ref[k]) <= 1e-6 * abs(ref[k]), k
    assert 0.3 < got["avg_rotation_error_deg"] < 3 and got["avg_registration_recall"] > 0.5
    report = (tmp_path / "port" / "evaluation_results.txt").read_text()
    assert report.splitlines()[0].startswith("Average Rotation Error:")
    # the exact prediction alone, as tests/test_nn_extras.py holds it
    one = teval.evaluate_pairwise_frames(["0000.pkl"], ["0000.txt"], str(gt_dir),
                                         str(pred_dir), str(tmp_path / "one"))
    assert one["avg_rotation_error_deg"] < 0.1 and one["avg_translation_error_cm"] < 0.1
    assert one["avg_registration_recall"] > 0.99
    # the quaternion line: float32 rotation in a float64 pose, as JAX's
    line = list(map(float, (pred_dir / "0002.txt").read_text().split()))
    T, Tj = teval.quaternion_line_to_matrix(line), jeval.quaternion_line_to_matrix(line)
    assert T.dtype == Tj.dtype == np.float64
    np.testing.assert_allclose(T, Tj, atol=2e-7)
    np.testing.assert_array_equal(T[:3, :3], T[:3, :3].astype(np.float32).astype(np.float64))


def _expm(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
