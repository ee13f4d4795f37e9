"""Window / whole-cloud k-NN: the plain versions and the wrappers of five
CUDA kernels, counterparts of `ops/pallas/knn_kernel.py` (`knn_pallas`).

`knn_window` (B1, `_knn_kernel`, knn_kernel.py:26), two modes:

- exact: order by (d², global id) — the lowest-index tie-break of
  `lax.top_k`;
- packed (window ≤ 1024): one int32 key (bits(d²) & ~0x3FF) | window lane,
  compared signed. Candidates whose d² agree within ~2⁻¹³ relative may swap
  against the exact order (near-tie noise).

d² = (‖q‖² − 2·q·c) + ‖c‖², summed in a fixed order with no fused
multiply-adds, so every kernel and the plain version agree bit for bit.

`knn_chunked` (B4, `_knn_kernel_chunked`, knn_kernel.py:93,
`knn_pallas(chunked=True)`), a different function: packed keys with the
window offset r, split into C = W/128 residue classes c = r mod C; the
S_pc = min(2·⌈K/C⌉, 128/C) smallest keys of each class form a shortlist,
whose K smallest keys, ascending, are the neighbors. d² = (‖c‖² − 2·c·q) +
‖q‖², the TPU kernel's order, so near-tie keys differ from packed mode's.

The kernels, picked by `knn_variant` before the launch and counted in each
wrapper's `launches_by_variant`:

- 'warp', one warp a query, on `csrc/knn_select.cuh`: B1 packed over a
  window (`csrc/knn_warp.cu`), B1 exact over a window or the whole cloud
  at k ≤ 128 (`csrc/knn_exact_warp.cu`), B4 (`csrc/knn_chunked_warp.cu`).
  Neither bytes nor the 8 flops per (query, candidate) bound these on an
  H100, but instruction issue; so the lanes compute their candidates' keys
  from candidates staged once a block and sort them in registers, and
  warp-min steps (`__reduce_min_sync`) extract the smallest keys in
  ascending order, never by divergent insertion. The exact kernel streams
  the candidates in chunks of 1024, drops those not below the query's
  running K-th key, and merges the rest into the running list. A block of
  4 warps covers 4 queries of a tile (16 from 64 k queries on), so one
  cloud fills the card.
- 'thread', one thread a query, sorted insertion lists in shared memory:
  `csrc/knn.cu` (B1, both modes) and `csrc/knn_chunked.cu` (B4). Kept for
  comparison: `variant='thread'` launches them where the warp kernel would
  run, for `chip_smoke.py` to compare and time the two. Exact keys at
  k > 128 run only there, by shape: a block takes 128, 64 or 32 queries of a
  tile (`thread_queries_per_block`), the most whose lists fit the card's
  opt-in shared memory, which the wrapper reads from the device's
  properties; beyond what 32 queries can hold (k ≈ 840 on an H100) it
  raises before any launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import morton
from ..knn import cross_dots, smallest_k, sq_norms
from . import build
from .build import OPS

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


EXACT_WARP_MAX_K = 128    # the exact warp kernel keeps ⌈K/32⌉ running-list keys a lane


def knn_variant(packed: bool | str, window: Optional[int], k: int = 1) -> str:
    """Which hand-written kernel runs a k-NN: 'warp' for packed keys over a
    window of at most 1024 (`csrc/knn_warp.cu`), for chunked keys
    (`packed='chunked'`, `csrc/knn_chunked_warp.cu`) and for exact keys over
    a window or the whole cloud at k ≤ 128 (`csrc/knn_exact_warp.cu`);
    'thread' for exact keys at larger k (`csrc/knn.cu`). A choice by shape,
    made before the launch; a launch that fails raises."""
    if packed == "chunked" or (packed and window is not None and window <= 1024):
        return "warp"
    if not packed and k <= EXACT_WARP_MAX_K:
        return "warp"
    return "thread"


THREAD_STAGED_BYTES = 4 * 1024 * 4   # csrc/knn.cu: x, y, z and ‖c‖² of 1024 candidates


def thread_queries_per_block(k: int, tile: int, packed: bool, smem_limit: int) -> int:
    """Queries a block of `csrc/knn.cu` takes: the largest of 128, 64 and
    32 that divides the tile and whose lists (k keys, and in exact mode k
    distances, a query) fit `smem_limit` bytes of shared memory beside the
    staged candidates; a tile that none divides takes its largest divisor
    up to 128. Raises ValueError, naming the limit in bytes and in k, when
    even the smallest does not fit."""
    per_entry = 4 if packed else 8
    cands = [q for q in (128, 64, 32) if tile % q == 0] or [
        max(d for d in range(1, min(tile, 128) + 1) if tile % d == 0)]
    for qb in cands:
        if THREAD_STAGED_BYTES + k * qb * per_entry <= smem_limit:
            return qb
    qb = cands[-1]
    max_k = (smem_limit - THREAD_STAGED_BYTES) // (qb * per_entry)
    raise ValueError(
        f"k={k} {'packed' if packed else 'exact'} k-NN lists need "
        f"{THREAD_STAGED_BYTES + k * qb * per_entry} bytes of shared memory at {qb} queries "
        f"a block; the card allows {smem_limit} bytes, so k <= {max_k}")


def exact_warp_geometry(n: int, k: int, tile: int, window: Optional[int]
                        ) -> tuple[int, int, int, int]:
    """(T, W, pad_tiles, max_tile) as `csrc/knn_exact_warp.cu` takes them:
    the window geometry, except that the whole cloud is one window that all
    N queries share, so one tile of N queries (T = W = N, S = 0) whatever
    tile divides N."""
    if window is None:
        _geometry(n, tile, None, False, k)
        return n, n, 0, 0
    w, pad_tiles, max_tile = _geometry(n, tile, window, False, k)
    return tile, w, pad_tiles, max_tile


def _queries_per_warp(b: int, n: int) -> int:
    """Queries a warp takes in turn: one while the batch is small, so that one
    cloud spreads over every SM; four from 64 k queries on, where the card
    is full either way and each block stages its window for 16 queries."""
    return 4 if b * n >= 65536 else 1


def _check_call(x: torch.Tensor, tile: int, variant: Optional[str], by_shape: str) -> None:
    """The checks every wrapper makes before it picks a path."""
    if x.dim() != 3 or x.shape[-1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 [B, N, 3], got {x.dtype} {tuple(x.shape)}")
    if variant not in (None, "warp", "thread") or (variant == "warp" and by_shape != "warp"):
        raise ValueError(f"no {variant!r} k-NN kernel for this mode and window")
    if x.device.type == "cpu":
        if variant is not None:
            raise ValueError("a CPU tensor takes the plain version; variant names a CUDA kernel")
        return
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if tile > 1024:
        raise ValueError(f"tile={tile} exceeds the 1024 threads of a block")


def _launch(source: str, symbol: str, x: torch.Tensor, out: torch.Tensor, *ints: int) -> None:
    """Launch `symbol` of `csrc/<source>.cu` on x's current stream; raises on
    a failed launch."""
    fn = getattr(build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * len(ints) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), *ints, stream)
    build.check(err, symbol)


def knn_window(x: torch.Tensor, k: int, tile: int = 128,
               window: Optional[int] = None, packed: bool = False,
               include_self: bool = True, variant: Optional[str] = None) -> torch.Tensor:
    """k-NN of curve-sorted clouds x [B, N, 3] f32 → nbr [B, N, K] int32.

    `window=None` searches the whole cloud. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel `knn_variant` names
    (`csrc/knn_warp.cu` for packed keys, `csrc/knn_exact_warp.cu` for exact
    keys) through the custom op `se3gspr_torch::knn_window`. `variant='thread'`
    asks for `csrc/knn.cu` where a warp kernel would run (to compare the
    two); 'warp' where there is none, or any variant on a CPU tensor, raises.
    """
    by_shape = knn_variant(packed, window, k)
    _check_call(x, tile, variant, by_shape)
    if x.device.type == "cpu":
        return knn_window_plain(x, k, tile, window, packed, include_self)
    _geometry(x.shape[1], tile, window, packed, k)
    variant = variant or by_shape
    qb = 0
    if variant == "thread":
        optin = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
        qb = thread_queries_per_block(k, tile, packed, optin)
    return knn_window_op(x, k, tile, window, packed, include_self, variant, qb)


def run_knn_window(x: torch.Tensor, k: int, tile: int, window: Optional[int], packed: bool,
                   include_self: bool, variant: str, queries_per_block: int) -> torch.Tensor:
    """The CUDA side of `se3gspr_torch::knn_window`: allocates the table,
    launches the variant's kernel and counts the launch (at call time, so an
    exported program counts each of its runs)."""
    b, n, _ = x.shape
    w, pad_tiles, max_tile = _geometry(n, tile, window, packed, k)
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    if variant == "warp" and packed:
        _launch("knn_warp", "knn_warp_launch", x, out, b, n, k, tile, w, pad_tiles, max_tile,
                int(include_self), _queries_per_warp(b, n))
    elif variant == "warp":
        _launch("knn_exact_warp", "knn_exact_warp_launch", x, out, b, n, k,
                *exact_warp_geometry(n, k, tile, window), int(include_self),
                _queries_per_warp(b, n))
    else:
        _launch("knn", "knn_launch", x, out, b, n, k, tile, queries_per_block, w, pad_tiles,
                max_tile, int(packed), int(include_self))
    knn_window.launches += 1
    knn_window.launches_by_variant[variant] += 1
    return out


knn_window.launches = 0
knn_window.launches_by_variant = {"warp": 0, "thread": 0}
knn_window_op = torch.library.custom_op(OPS + "::knn_window", run_knn_window,
                                        mutates_args=(), device_types="cuda")


@knn_window_op.register_fake
def _(x, k, tile, window, packed, include_self, variant, queries_per_block):
    return x.new_empty(x.shape[:2] + (k,), dtype=torch.int32)


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
                include_self: bool = True, variant: Optional[str] = None) -> torch.Tensor:
    """Chunked packed-key k-NN (B4) of curve-sorted clouds x [B, N, 3] f32 →
    nbr [B, N, K] int32. A CPU tensor takes the plain version; a CUDA tensor
    launches `csrc/knn_chunked_warp.cu`, or with `variant='thread'` the
    thread-a-query `csrc/knn_chunked.cu` (to compare the two), through the
    custom op `se3gspr_torch::knn_chunked`."""
    _check_call(x, tile, variant, knn_variant("chunked", window))
    if x.device.type == "cpu":
        return knn_chunked_plain(x, k, tile, window, include_self)
    _chunked_geometry(x.shape[1], tile, window, k)
    return knn_chunked_op(x, k, tile, window, include_self, variant or "warp")


def run_knn_chunked(x: torch.Tensor, k: int, tile: int, window: int, include_self: bool,
                    variant: str) -> torch.Tensor:
    """The CUDA side of `se3gspr_torch::knn_chunked`: allocates, launches,
    counts."""
    b, n, _ = x.shape
    pad_tiles, max_tile, _, s_pc = _chunked_geometry(n, tile, window, k)
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    if variant == "warp":
        _launch("knn_chunked_warp", "knn_chunked_warp_launch", x, out, b, n, k, tile, window,
                s_pc, pad_tiles, max_tile, int(include_self), _queries_per_warp(b, n))
    else:
        _launch("knn_chunked", "knn_chunked_launch", x, out, b, n, k, tile, window, s_pc,
                pad_tiles, max_tile, int(include_self))
    knn_chunked.launches += 1
    knn_chunked.launches_by_variant[variant] += 1
    return out


knn_chunked.launches = 0
knn_chunked.launches_by_variant = {"warp": 0, "thread": 0}
knn_chunked_op = torch.library.custom_op(OPS + "::knn_chunked", run_knn_chunked,
                                         mutates_args=(), device_types="cuda")


@knn_chunked_op.register_fake
def _(x, k, tile, window, include_self, variant):
    return x.new_empty(x.shape[:2] + (k,), dtype=torch.int32)
