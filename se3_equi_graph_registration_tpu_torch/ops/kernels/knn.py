"""Window / whole-cloud k-NN: the CUDA kernels `csrc/knn.cu` (B1) and
`csrc/knn_chunked.cu` (B4) with their plain versions (counterpart of
`ops/pallas/knn_kernel.py`, `knn_pallas`).

`knn_window`, the two modes of `_knn_kernel`:

- exact: order by (d², global id) — the lowest-index tie-break of
  `lax.top_k`;
- packed (window ≤ 1024): one int32 key (bits(d²) & ~0x3FF) | window lane,
  compared signed. Candidates whose d² agree within ~2⁻¹³ relative may swap
  against the exact order (near-tie noise).

d² = (‖q‖² − 2·q·c) + ‖c‖², summed in a fixed order with no fused
multiply-adds, so the kernel and the plain version agree bit for bit.

`knn_chunked`, `_knn_kernel_chunked` (`knn_pallas(chunked=True)`), a
different function: packed keys with the window offset r, split into
C = W/128 residue classes c = r mod C; the S_pc = min(2·⌈K/C⌉, 128/C)
smallest keys of each class form a shortlist, whose K smallest keys,
ascending, are the neighbors. d² = (‖c‖² − 2·c·q) + ‖q‖², the TPU kernel's
order, so near-tie keys differ from packed mode's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import morton
from ..knn import cross_dots, smallest_k, sq_norms
from . import build

_PACK_MASK = ~0x3FF


def _geometry(n: int, tile: int, window: Optional[int], packed: bool, k: int
              ) -> tuple[int, int, int]:
    """(W, pad_tiles, max_tile) for the window-start formula, validated."""
    w = n if window is None else window
    if n % tile or w % tile or not tile <= w <= n:
        raise ValueError(f"bad k-NN geometry n={n} tile={tile} window={window}")
    if packed and (window is None or window > 1024):
        raise ValueError("packed keys need a curve window <= 1024")
    if k > w:
        raise ValueError(f"k={k} exceeds the {w} candidates")
    pad_tiles = (w - tile) // 2 // tile if w > tile else 0
    return w, pad_tiles, (n - w) // tile


def knn_window_plain(x: torch.Tensor, k: int, tile: int = 128,
                     window: Optional[int] = None, packed: bool = False,
                     include_self: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [B, N, 3] f32 → [B, N, K] int32."""
    n = x.shape[-2]
    w, _, _ = _geometry(n, tile, window, packed, k)
    queries, cand, starts = morton.window_candidates(x, tile, w)
    d2 = (sq_norms(queries)[..., :, None] - 2.0 * cross_dots(queries, cand)
          + sq_norms(cand)[..., None, :])                       # [B, N/T, T, W]
    lane = torch.arange(w, device=x.device)
    if not include_self:
        qid = torch.arange(n, device=x.device).reshape(n // tile, tile)
        gid = starts[:, None] + lane                             # [N/T, W]
        d2 = d2.masked_fill(gid[:, None, :] == qid[:, :, None], float("inf"))
    if packed:
        key = (d2.contiguous().view(torch.int32) & _PACK_MASK) | lane.to(torch.int32)
        sel = torch.sort(key, dim=-1).values[..., :k]
        idx = (sel & 0x3FF).to(torch.int64)
    else:
        idx = smallest_k(d2, k)
    idx = idx + starts[:, None, None]
    return idx.reshape(x.shape[:-1] + (k,)).to(torch.int32)


def knn_window(x: torch.Tensor, k: int, tile: int = 128,
               window: Optional[int] = None, packed: bool = False,
               include_self: bool = True) -> torch.Tensor:
    """k-NN of curve-sorted clouds x [B, N, 3] f32 → nbr [B, N, K] int32.

    `window=None` searches the whole cloud. A CPU tensor takes the plain
    version; a CUDA tensor launches `csrc/knn.cu`.
    """
    if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [B, N, 3], got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return knn_window_plain(x, k, tile, window, packed, include_self)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if tile > 1024:
        raise ValueError(f"tile={tile} exceeds the 1024 threads of a block")
    b, n, _ = x.shape
    w, pad_tiles, max_tile = _geometry(n, tile, window, packed, k)
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    lib = build.load("knn")
    fn = lib.knn_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b, n, k, tile, w, pad_tiles,
                 max_tile, int(packed), int(include_self), stream)
    build.check(err, "knn_launch")
    knn_window.launches += 1
    return out


knn_window.launches = 0


def _chunked_geometry(n: int, tile: int, window: int, k: int
                      ) -> tuple[int, int, int, int]:
    """(pad_tiles, max_tile, C, S_pc) of chunked mode, validated."""
    _, pad_tiles, max_tile = _geometry(n, tile, window, True, k)
    if window % 128:
        raise ValueError(f"chunked keys need a window that divides by 128, got {window}")
    c = window // 128
    s_pc = min(2 * -(-k // c), 128 // c)
    if s_pc * c < k:
        raise ValueError(f"chunked shortlist {s_pc * c} < k={k}: window {window} is too "
                         "narrow for two-level extraction; use packed keys")
    return pad_tiles, max_tile, c, s_pc


def knn_chunked_plain(x: torch.Tensor, k: int, tile: int = 128, window: int = 768,
                      include_self: bool = True) -> torch.Tensor:
    """Plain PyTorch version of B4: x [B, N, 3] f32 → [B, N, K] int32."""
    n = x.shape[-2]
    _, _, c, s_pc = _chunked_geometry(n, tile, window, k)
    queries, cand, starts = morton.window_candidates(x, tile, window)
    d2 = ((sq_norms(cand)[..., None, :] - 2.0 * cross_dots(queries, cand))
          + sq_norms(queries)[..., :, None])                    # [B, N/T, T, W]
    lane = torch.arange(window, device=x.device)
    if not include_self:
        qid = torch.arange(n, device=x.device).reshape(n // tile, tile)
        gid = starts[:, None] + lane
        d2 = d2.masked_fill(gid[:, None, :] == qid[:, :, None], float("inf"))
    key = (d2.contiguous().view(torch.int32) & _PACK_MASK) | lane.to(torch.int32)
    per_class = key.reshape(key.shape[:-1] + (128, c))          # r = q·C + c
    short = torch.sort(per_class, dim=-2).values[..., :s_pc, :].flatten(-2)
    sel = torch.sort(short, dim=-1).values[..., :k]
    idx = (sel & 0x3FF).to(torch.int64) + starts[:, None, None]
    return idx.reshape(x.shape[:-1] + (k,)).to(torch.int32)


def knn_chunked(x: torch.Tensor, k: int, tile: int = 128, window: int = 768,
                include_self: bool = True) -> torch.Tensor:
    """Chunked packed-key k-NN (B4) of curve-sorted clouds x [B, N, 3] f32 →
    nbr [B, N, K] int32. A CPU tensor takes the plain version; a CUDA tensor
    launches `csrc/knn_chunked.cu`."""
    if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [B, N, 3], got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return knn_chunked_plain(x, k, tile, window, include_self)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if tile > 1024:
        raise ValueError(f"tile={tile} exceeds the 1024 threads of a block")
    b, n, _ = x.shape
    pad_tiles, max_tile, _, s_pc = _chunked_geometry(n, tile, window, k)
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    fn = build.load("knn_chunked").knn_chunked_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b, n, k, tile, window, s_pc, pad_tiles,
                 max_tile, int(include_self), stream)
    build.check(err, "knn_chunked_launch")
    knn_chunked.launches += 1
    return out


knn_chunked.launches = 0
