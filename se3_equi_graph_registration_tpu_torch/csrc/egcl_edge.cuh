// The scalar edge code shared by every EGCL tile kernel, whatever the type of
// its products: the edge geometry, its backward, and the staging of a row tile
// of 16 edges. Included by egcl_tile.cuh (bf16 mma.sync tiles, fast mode, at
// C = kC) and egcl_tile_f32.cuh (fp32 register-blocked tiles, accurate mode,
// at C = kC and at a padded width).
//
// Numerics (ops/pallas/egcl_kernel.py:97-114, egcl_backward.py:131-235):
// rel = x_i - x_j; g = [radial, dist, dot, a0,b0,c0, a1,b1,c1, a2,b2,c2] with
// _safe_unit n = sqrt(n^2 + 1e-20), v / (n + 1e-8); the frame is the identity
// when |a|, |b| or |c| < 1e-6 (coincident or collinear points), and its
// gradient is 0 there. All fp32.

#pragma once

#include <cuda_runtime.h>

namespace egcl_edge {

constexpr int kC = 32;        // channels
constexpr int kRows = 16;     // edges per row tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unit(float& a, float& b, float& c) {
  const float inv = sqrtf(a * a + b * b + c * c + 1e-20f) + 1e-8f;
  a /= inv; b /= inv; c /= inv;
}

// Edge geometry: rel = xi - xc and the 12 values g.
__device__ __forceinline__ void edge_geometry(float xi0, float xi1, float xi2, float xc0,
                                              float xc1, float xc2, float (&rel)[3],
                                              float (&g)[12]) {
  const float r0 = xi0 - xc0, r1 = xi1 - xc1, r2 = xi2 - xc2;
  rel[0] = r0; rel[1] = r1; rel[2] = r2;
  g[0] = r0 * r0 + r1 * r1 + r2 * r2;
  g[1] = sqrtf(g[0] + 1e-20f);
  g[2] = xi0 * xc0 + xi1 * xc1 + xi2 * xc2;
  float a0 = r0, a1 = r1, a2 = r2;
  unit(a0, a1, a2);
  float b0 = xi1 * xc2 - xi2 * xc1, b1 = xi2 * xc0 - xi0 * xc2, b2 = xi0 * xc1 - xi1 * xc0;
  unit(b0, b1, b2);
  const float c0 = a1 * b2 - a2 * b1, c1 = a2 * b0 - a0 * b2, c2 = a0 * b1 - a1 * b0;
  const float cn = sqrtf(c0 * c0 + c1 * c1 + c2 * c2 + 1e-20f);
  const float an = sqrtf(a0 * a0 + a1 * a1 + a2 * a2 + 1e-20f);
  const float bn = sqrtf(b0 * b0 + b1 * b1 + b2 * b2 + 1e-20f);
  if (an < 1e-6f || bn < 1e-6f || cn < 1e-6f) {
    g[3] = 1.f; g[4] = 0.f; g[5] = 0.f;
    g[6] = 0.f; g[7] = 1.f; g[8] = 0.f;
    g[9] = 0.f; g[10] = 0.f; g[11] = 1.f;
  } else {
    g[3] = a0; g[4] = b0; g[5] = c0;
    g[6] = a1; g[7] = b1; g[8] = c1;
    g[9] = a2; g[10] = b2; g[11] = c2;
  }
}

__device__ __forceinline__ void cross(float a0, float a1, float a2, float b0, float b1,
                                      float b2, float& c0, float& c1, float& c2) {
  c0 = a1 * b2 - a2 * b1;
  c1 = a2 * b0 - a0 * b2;
  c2 = a0 * b1 - a1 * b0;
}

// backward of a = r·inv, inv = 1/(n + 1e-8), n = sqrt(Σr² + 1e-20)
__device__ __forceinline__ void normalize_bwd(float r0, float r1, float r2, float n,
                                              float inv, float& d0, float& d1, float& d2) {
  const float k = (inv * inv / n) * (d0 * r0 + d1 * r1 + d2 * r2);
  d0 = d0 * inv - k * r0;
  d1 = d1 * inv - k * r1;
  d2 = d2 * inv - k * r2;
}

// One edge's geometry backward (egcl_backward.cu, in fp32 on the fp32 frame):
// dgp = dL/dgeo; adds the center's share to dxi, returns the neighbor's.
__device__ __forceinline__ void geometry_bwd(float xi0, float xi1, float xi2, float xc0,
                                             float xc1, float xc2, float dax0, float dax1,
                                             float dax2, float scale, const float* dgp,
                                             float (&dxi)[3], float (&dxn)[3]) {
  const float r0 = xi0 - xc0, r1 = xi1 - xc1, r2 = xi2 - xc2;
  const float radial = r0 * r0 + r1 * r1 + r2 * r2;
  const float dist = sqrtf(radial + 1e-20f);
  const float inv_rel = 1.0f / (dist + 1e-8f);
  const float a0 = r0 * inv_rel, a1 = r1 * inv_rel, a2 = r2 * inv_rel;
  float cr0, cr1, cr2;
  cross(xi0, xi1, xi2, xc0, xc1, xc2, cr0, cr1, cr2);
  const float n_cr = sqrtf(cr0 * cr0 + cr1 * cr1 + cr2 * cr2 + 1e-20f);
  const float inv_cr = 1.0f / (n_cr + 1e-8f);
  const float b0 = cr0 * inv_cr, b1 = cr1 * inv_cr, b2 = cr2 * inv_cr;
  float c0, c1, c2;
  cross(a0, a1, a2, b0, b1, b2, c0, c1, c2);
  const bool degen = sqrtf(a0 * a0 + a1 * a1 + a2 * a2 + 1e-20f) < 1e-6f ||
                     sqrtf(b0 * b0 + b1 * b1 + b2 * b2 + 1e-20f) < 1e-6f ||
                     sqrtf(c0 * c0 + c1 * c1 + c2 * c2 + 1e-20f) < 1e-6f;
  const float live = degen ? 0.0f : 1.0f;   // the identity frame has no gradient
  float da0 = dgp[3] * live, da1 = dgp[6] * live, da2 = dgp[9] * live;
  float db0 = dgp[4] * live, db1 = dgp[7] * live, db2 = dgp[10] * live;
  const float dc0 = dgp[5] * live, dc1 = dgp[8] * live, dc2 = dgp[11] * live;
  float t0, t1, t2;
  cross(b0, b1, b2, dc0, dc1, dc2, t0, t1, t2);     // c = a × b
  da0 += t0; da1 += t1; da2 += t2;
  cross(dc0, dc1, dc2, a0, a1, a2, t0, t1, t2);
  db0 += t0; db1 += t1; db2 += t2;
  normalize_bwd(cr0, cr1, cr2, n_cr, inv_cr, db0, db1, db2);   // → dcr
  float dxr0, dxr1, dxr2, dxc0, dxc1, dxc2;
  cross(xc0, xc1, xc2, db0, db1, db2, dxr0, dxr1, dxr2);       // cr = x_i × x_j
  cross(db0, db1, db2, xi0, xi1, xi2, dxc0, dxc1, dxc2);
  normalize_bwd(r0, r1, r2, dist, inv_rel, da0, da1, da2);     // → drel from a
  const float dradial = dgp[0], ddist = dgp[1], ddot = dgp[2];
  const float q0 = (dax0 * scale + da0) + 2.0f * r0 * dradial + (r0 / dist) * ddist;
  const float q1 = (dax1 * scale + da1) + 2.0f * r1 * dradial + (r1 / dist) * ddist;
  const float q2 = (dax2 * scale + da2) + 2.0f * r2 * dradial + (r2 / dist) * ddist;
  dxi[0] += q0 + xc0 * ddot + dxr0;
  dxi[1] += q1 + xc1 * ddot + dxr1;
  dxi[2] += q2 + xc2 * ddot + dxr2;
  dxn[0] = -q0 + xi0 * ddot + dxc0;
  dxn[1] = -q1 + xi1 * ddot + dxc1;
  dxn[2] = -q2 + xi2 * ddot + dxc2;
}

// Stage edges row0 .. row0 + 15 of `center` into a warp's tile, rows of
// Tile::kStride elements of type Tile::T: [h_col W | what Tile::geo writes].
// Lane l and lane l + 16 both take edge row0 + (l % 16): they load its
// neighbor index and x_j and compute its geometry once (lanes 0-15 write it);
// all 32 lanes then copy the 16 gathered h_j rows. At W = c = 32 that is
// 16-byte loads, 8 lanes a row. At a padded width W > 32 the rows of h have
// their true stride c (32 < c <= W, not 16-byte aligned): the 16 x c words go
// one word a lane, 32 consecutive words of the flattened block a step, and
// the pad columns c .. W - 1 are never written (the caller zeroes them once).
// An edge at or beyond K is staged from the center itself (finite values)
// and reported invalid: the caller masks it out of every sum. Returns
// whether this lane's edge is valid, and its rel.
//
// Tile provides: T; kStride; geo(T* row + W, g, rel, j_nb), the geometry part
// of one row; h4(T* dst, float4 v), four channels of h_col.
template <class Tile, int W = kC>
__device__ __forceinline__ bool stage_edges(const float* __restrict__ h,
                                            const float* __restrict__ x,
                                            const int* __restrict__ nbr, int center, int base,
                                            int K, int row0, float xi0, float xi1, float xi2,
                                            typename Tile::T* tile, int lane, float (&rel)[3],
                                            int c = W) {
  const int row = lane & 15;
  const bool valid = row0 + row < K;
  const int j_nb = valid ? base + nbr[(size_t)center * K + row0 + row] : center;
  const float xc0 = x[(size_t)j_nb * 3 + 0];
  const float xc1 = x[(size_t)j_nb * 3 + 1];
  const float xc2 = x[(size_t)j_nb * 3 + 2];
  float g[12];
  edge_geometry(xi0, xi1, xi2, xc0, xc1, xc2, rel, g);
  __syncwarp();   // the previous tile's operand loads are done
  if (lane < kRows) Tile::geo(tile + row * Tile::kStride + W, g, rel, j_nb);
  if constexpr (W == kC) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * i + (lane >> 3), chunk = lane & 7;
      const int src = __shfl_sync(kFull, j_nb, r);
      const float4 v = reinterpret_cast<const float4*>(h + (size_t)src * kC)[chunk];
      Tile::h4(tile + r * Tile::kStride + 4 * chunk, v);
    }
  } else {
    // word e = r c + ch of the block; with c > 32 a step of 32 words crosses
    // at most one row end. Every lane takes every step (the shuffle).
    int r = 0, ch = lane;
    for (int e0 = 0; e0 < kRows * c; e0 += 32) {
      const int src = __shfl_sync(kFull, j_nb, r);
      if (e0 + lane < kRows * c) tile[r * Tile::kStride + ch] = h[(size_t)src * c + ch];
      ch += 32;
      if (ch >= c) { ch -= c; ++r; }
    }
  }
  __syncwarp();
  return valid;
}

}  // namespace egcl_edge
