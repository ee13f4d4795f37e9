"""Train/val(/test) split tooling (a copy of the JAX package's
`data/preprocess/split.py`, which cannot be imported without jax).

Capability parity with the reference's datasets/split_dataset_train_val.py:13-66
and tools/filename_list.py: shuffle the pair-file directory and emit
{train,val,test}_files.txt lists at the dataset root.

  python -m se3_equi_graph_registration_tpu_torch.data.preprocess.split ROOT \
      [--pair-dir train_3dmatch] [--val-fraction 0.1]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def list_pair_files(directory: str, extensions=(".pkl", ".npz")) -> list[str]:
    return sorted(f for f in os.listdir(directory)
                  if f.endswith(tuple(extensions)))


def write_file_list(path: str, names: list[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(names) + ("\n" if names else ""))


def split_dataset(root: str, pair_dir: str, val_fraction: float = 0.10,
                  test_fraction: float = 0.0, seed: int = 0) -> dict[str, list[str]]:
    """Shuffle + split (default 90/10 train/val like the reference) and write
    the *_files.txt lists to `root`."""
    files = list_pair_files(os.path.join(root, pair_dir))
    if not files:
        raise FileNotFoundError(f"no pair files under {root}/{pair_dir}")
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(files))
    n_test = int(len(files) * test_fraction)
    n_val = int(len(files) * val_fraction)
    test = [files[i] for i in order[:n_test]]
    val = [files[i] for i in order[n_test:n_test + n_val]]
    train = [files[i] for i in order[n_test + n_val:]]

    write_file_list(os.path.join(root, "train_files.txt"), train)
    write_file_list(os.path.join(root, "val_files.txt"), val)
    if test_fraction > 0:
        write_file_list(os.path.join(root, "test_files.txt"), test)
    return {"train": train, "val": val, "test": test}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root")
    ap.add_argument("--pair-dir", default="train_3dmatch")
    ap.add_argument("--val-fraction", type=float, default=0.10)
    ap.add_argument("--test-fraction", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    out = split_dataset(args.root, args.pair_dir, args.val_fraction,
                        args.test_fraction, args.seed)
    for k, v in out.items():
        print(f"{k}: {len(v)} files")


if __name__ == "__main__":
    main()
