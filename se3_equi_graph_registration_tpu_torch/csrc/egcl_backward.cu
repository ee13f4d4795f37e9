// Backward of the fused EGCL layer's edge program ('center' direction,
// 'frame' so3 mode), for Hopper (sm_90a).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_backward.py::_egcl_bwd_kernel (wrapper egcl_backward_pallas, custom
// VJP egcl_fused_diff). Given the layer inputs h, x, the graph and the
// cotangents of agg_m = Σ_k m and agg_x = Σ_k rel·s, it recomputes each
// edge's forward intermediates and runs the chain rule back to dh, dx and
// the gradients of the 11 edge/coord parameters. The node MLP's backward is
// dense per-node work and stays in autograd (ops/kernels/egcl_backward.py).
//
// The TPU kernel turns both scatters into one-hot matmuls and sums the
// parameter gradients into output blocks revisited by every grid step, which
// is race-free only on the TPU's sequential grid. Here:
// - one warp owns one center (lane l: channels l and l + 32, C ≤ 64) and
//   loops over its K edges, as the forward kernel egcl.cu does;
// - the cotangent of every edge comes from its center (dagg_m[i], dagg_x[i]);
//   what flows back onto the center (dh_row, dx_row) accumulates in registers
//   and is written once, without atomics (dh_center, dx_center);
// - what flows onto the neighbor (dh_col, dx_col: C + 3 floats per edge)
//   goes through atomicAdd into zero-filled buffers (dh_nbr, dx_nbr). The
//   sum is exact for any graph but its order changes from run to run;
// - parameter gradients are sums over all B·N·K edges. Each warp keeps its
//   own copy of the matrix gradients in shared memory (lane c owns output
//   row c, so a lane's read-modify-writes never collide and need no atomic);
//   vector gradients sit in registers. Each block sums its warps' copies and
//   flushes once with global atomics. dW1hr = Σ_i (Σ_k du) ⊗ h_i needs one
//   update per center, not per edge.
//
// What bounds it: operations, issued from shared memory. At C = 32 an edge
// recomputes the forward (~7.5 kFLOP) and runs ~2x that backward; every
// multiply-add reads a weight or accumulator word from shared memory, so
// the kernel runs at the shared-memory rate, far below the fp32 pipes. The
// per-warp accumulators (15 KB at C = 32) also cap the warps in flight. wgmma
// tiles over staged edge vectors are the way to the tensor cores, later.
//
// Numerics follow egcl_backward.py:38-50, 131-235: _dsilu; _normalize_bwd
// with n = sqrt(Σr²+1e-20), inv = 1/(n+1e-8); the LayerNorm backward; the
// cross-product terms; (rel/dist)·ddist with dist = sqrt(radial+1e-20); the
// frame's gradient masked to 0 on degenerate edges. FAST rounds the operands
// of every product (weights, activations and cotangents) to bf16 and sums in
// fp32, as the TPU's 1-pass DEFAULT-precision backward does; gathers,
// geometry, LayerNorm statistics and sums stay fp32. The TPU additionally
// rounds the values its one-hot matmuls gather and scatter
// (egcl_backward.py:106-110, 240-246); this kernel gathers and scatters
// exactly. The only off-diagonal blocks of w2 are structural zeros that no
// parameter feeds, so their gradient is left 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxWarps = 8;   // centers in flight per block (fewer at large C)
constexpr int kVec = 64;       // one per-warp broadcast vector (≥ C)
constexpr int kBufs = 8;       // h_i, h_col, s1, m, dcm_in, dv, du, Σdu

template <bool FAST>
__device__ __forceinline__ float rd(float v) {
  return FAST ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float dsilu(float v) {
  const float s = 1.0f / (1.0f + expf(-v));
  return s * (1.0f + v * (1.0f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Offsets {  // float offsets in the packed buffer (egcl.cu, pack_params);
                  // the gradient buffer repeats the layout up to wn0
  int w1hr, w1hc, w1g, b1, w2, b2, lns, lnb, wc0, bc0, wc1, wn0;
  __host__ __device__ explicit Offsets(int C) {
    int o = 0;
    w1hr = o; o += C * C;
    w1hc = o; o += C * C;
    w1g = o;  o += 12 * C;
    b1 = o;   o += C;
    w2 = o;   o += C * C;
    b2 = o;   o += C;
    lns = o;  o += C;
    lnb = o;  o += C;
    wc0 = o;  o += C * C;
    bc0 = o;  o += C;
    wc1 = o;  o += C;
    wn0 = o;
  }
};

struct Smem {  // float offsets in shared memory
  int S;                                             // padded row stride C + 1
  int w1hr, w1hc, w1g, b1, w2, b2, lns, lnb, wc0, bc0, wc1, weights;
  int buf, g_w1hr, g_w1hc, g_w1g, g_w2, g_wc0, per_warp;   // within a warp's slice
  __host__ __device__ Smem(int C, int wh) {
    S = C + 1;  // [in][out] rows padded: lane c reading row c or column c is
                // conflict-free either way
    int o = 0;
    w1hr = o; o += C * S;
    w1hc = o; o += C * S;
    w2 = o;   o += C * S;
    wc0 = o;  o += C * S;
    w1g = o;  o += 12 * C;
    b1 = o;   o += C;
    b2 = o;   o += C;
    lns = o;  o += C;
    lnb = o;  o += C;
    bc0 = o;  o += C;
    wc1 = o;  o += C;
    weights = o;
    int p = 0;
    buf = p;    p += kBufs * kVec;
    g_w1hr = p; p += C * C;     // [in j][out c] at j*C + c
    g_w1hc = p; p += C * C;
    g_wc0 = p;  p += C * C;
    g_w1g = p;  p += 12 * C;    // [q][c]
    g_w2 = p;   p += wh * C;    // [j - head start][c]: the diagonal blocks
    per_warp = p;
  }
};

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

template <int R, bool FAST>
__global__ void __launch_bounds__(kMaxWarps * 32)
egcl_bwd_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const int* __restrict__ nbr, const float* __restrict__ params,
                const float* __restrict__ dagg_m, const float* __restrict__ dagg_x,
                float* __restrict__ dh_center, float* __restrict__ dx_center,
                float* __restrict__ dh_nbr, float* __restrict__ dx_nbr,
                float* __restrict__ grads, int total, int N, int K, int C, int wh) {
  extern __shared__ float smem[];
  const Offsets off(C);
  const Smem sm(C, wh);
  const int S = sm.S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // weights are MLP operands (rounded in FAST); biases and LayerNorm stay fp32
  for (int t = threadIdx.x; t < C * C; t += blockDim.x) {
    const int j = t / C, c = t % C;
    smem[sm.w1hr + j * S + c] = rd<FAST>(params[off.w1hr + t]);
    smem[sm.w1hc + j * S + c] = rd<FAST>(params[off.w1hc + t]);
    smem[sm.w2 + j * S + c] = rd<FAST>(params[off.w2 + t]);
    smem[sm.wc0 + j * S + c] = rd<FAST>(params[off.wc0 + t]);
  }
  for (int t = threadIdx.x; t < 12 * C; t += blockDim.x)
    smem[sm.w1g + t] = rd<FAST>(params[off.w1g + t]);
  for (int t = threadIdx.x; t < C; t += blockDim.x) {
    smem[sm.b1 + t] = params[off.b1 + t];
    smem[sm.b2 + t] = params[off.b2 + t];
    smem[sm.lns + t] = params[off.lns + t];
    smem[sm.lnb + t] = params[off.lnb + t];
    smem[sm.bc0 + t] = params[off.bc0 + t];
    smem[sm.wc1 + t] = rd<FAST>(params[off.wc1 + t]);
  }
  float* mine = smem + sm.weights + warp * sm.per_warp;
  for (int t = lane + sm.g_w1hr; t < sm.per_warp; t += 32) mine[t] = 0.0f;
  __syncthreads();

  const float* W1hr = smem + sm.w1hr;
  const float* W1hc = smem + sm.w1hc;
  const float* W1g = smem + sm.w1g;
  const float* W2 = smem + sm.w2;
  const float* Wc0 = smem + sm.wc0;
  const float* B1 = smem + sm.b1;
  const float* B2 = smem + sm.b2;
  const float* LNS = smem + sm.lns;
  const float* LNB = smem + sm.lnb;
  const float* BC0 = smem + sm.bc0;
  const float* WC1 = smem + sm.wc1;
  float* bHi = mine + sm.buf;
  float* bHc = bHi + kVec;
  float* bS1 = bHc + kVec;
  float* bM = bS1 + kVec;
  float* bDc = bM + kVec;
  float* bDv = bDc + kVec;
  float* bDu = bDv + kVec;
  float* bDs = bDu + kVec;
  float* gW1hr = mine + sm.g_w1hr;
  float* gW1hc = mine + sm.g_w1hc;
  float* gWc0 = mine + sm.g_wc0;
  float* gW1g = mine + sm.g_w1g;
  float* gW2 = mine + sm.g_w2;
  const float invC = 1.0f / (float)C;

  // vector gradients, per lane (channel c = lane + 32 r), over all centers
  float g_b1[R], g_b2[R], g_lns[R], g_lnb[R], g_bc0[R], g_wc1[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    g_b1[r] = g_b2[r] = g_lns[r] = g_lnb[r] = g_bc0[r] = g_wc1[r] = 0.0f;

  for (int center = blockIdx.x * nwarps + warp; center < total;
       center += gridDim.x * nwarps) {
    const int base = center - center % N;          // b·N
    float acc_hr[R], dm0[R], du_sum[R];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < C) {
        bHi[c] = rd<FAST>(h[(size_t)center * C + c]);
        dm0[r] = dagg_m[(size_t)center * C + c];
      } else {
        dm0[r] = 0.0f;
      }
      du_sum[r] = 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {   // h_row block of the first layer, per center
      const int c = lane + 32 * r;
      float s = 0.0f;
      if (c < C)
        for (int j = 0; j < C; ++j) s = fmaf(W1hr[j * S + c], bHi[j], s);
      acc_hr[r] = s;
    }
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];
    const float dax0 = dagg_x[(size_t)center * 3 + 0];
    const float dax1 = dagg_x[(size_t)center * 3 + 1];
    const float dax2 = dagg_x[(size_t)center * 3 + 2];
    float dxi0 = 0.0f, dxi1 = 0.0f, dxi2 = 0.0f;

    for (int e = 0; e < K; ++e) {
      const int j_nb = base + nbr[(size_t)center * K + e];
      const float xc0 = x[(size_t)j_nb * 3 + 0];
      const float xc1 = x[(size_t)j_nb * 3 + 1];
      const float xc2 = x[(size_t)j_nb * 3 + 2];

      // ---- forward recompute: geometry (every lane, the same values) ----
      const float r0 = xi0 - xc0, r1 = xi1 - xc1, r2 = xi2 - xc2;
      const float radial = r0 * r0 + r1 * r1 + r2 * r2;
      const float dist = sqrtf(radial + 1e-20f);
      const float n_rel = sqrtf(radial + 1e-20f);
      const float inv_rel = 1.0f / (n_rel + 1e-8f);
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
      float g[12];
      g[0] = radial;
      g[1] = dist;
      g[2] = xi0 * xc0 + xi1 * xc1 + xi2 * xc2;
      if (degen) {
        g[3] = 1.f; g[4] = 0.f; g[5] = 0.f;
        g[6] = 0.f; g[7] = 1.f; g[8] = 0.f;
        g[9] = 0.f; g[10] = 0.f; g[11] = 1.f;
      } else {
        g[3] = a0; g[4] = b0; g[5] = c0;
        g[6] = a1; g[7] = b1; g[8] = c1;
        g[9] = a2; g[10] = b2; g[11] = c2;
      }
#pragma unroll
      for (int q = 0; q < 12; ++q) g[q] = rd<FAST>(g[q]);

      // ---- forward recompute: edge MLP ----
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) bHc[c] = rd<FAST>(h[(size_t)j_nb * C + c]);
      }
      __syncwarp();
      float u[R], v[R];
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        float shc = 0.0f, sg = 0.0f;
        if (c < C) {
          for (int j = 0; j < C; ++j) shc = fmaf(W1hc[j * S + c], bHc[j], shc);
#pragma unroll
          for (int q = 0; q < 12; ++q) sg = fmaf(W1g[q * C + c], g[q], sg);
          u[r] = ((acc_hr[r] + shc) + sg) + B1[c];
          bS1[c] = rd<FAST>(silu(u[r]));
        } else {
          u[r] = 0.0f;
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        v[r] = 0.0f;
        if (c < C) {
          const int j0 = (c / wh) * wh;
          float s = 0.0f;
          for (int j = j0; j < j0 + wh; ++j) s = fmaf(W2[j * S + c], bS1[j], s);
          v[r] = s + B2[c];
          part += v[r];
        }
      }
      const float mu = warp_sum(part) * invC;
      float vpart = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane + 32 * r < C) vpart += (v[r] - mu) * (v[r] - mu);
      const float sig = rsqrtf(warp_sum(vpart) * invC + 1e-5f);
      float vhat[R], cm_in[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        vhat[r] = (v[r] - mu) * sig;
        if (c < C) bM[c] = rd<FAST>(vhat[r] * LNS[c] + LNB[c]);
      }
      __syncwarp();
      float spart = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        cm_in[r] = 0.0f;
        if (c < C) {
          float s = 0.0f;
          for (int j = 0; j < C; ++j) s = fmaf(Wc0[j * S + c], bM[j], s);
          cm_in[r] = s + BC0[c];
          spart = fmaf(WC1[c], rd<FAST>(silu(cm_in[r])), spart);
        }
      }
      const float scale = warp_sum(spart);

      // ---- backward: coordinate MLP ----
      const float dscale = dax0 * r0 + dax1 * r1 + dax2 * r2;
      const float dscale_r = rd<FAST>(dscale);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) {
          const float dcm_in = dsilu(cm_in[r]) * (WC1[c] * dscale_r);
          g_wc1[r] = fmaf(dscale_r, rd<FAST>(silu(cm_in[r])), g_wc1[r]);
          g_bc0[r] += dcm_in;
          const float dcr = rd<FAST>(dcm_in);
          bDc[c] = dcr;
          for (int j = 0; j < C; ++j) gWc0[j * C + c] = fmaf(dcr, bM[j], gWc0[j * C + c]);
        }
      }
      __syncwarp();
      // ---- backward: dm = dagg_m[i] + Wc0ᵀ dcm_in, then LayerNorm ----
      float dm[R];
      float gpart = 0.0f, gvpart = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        dm[r] = 0.0f;
        if (c < C) {
          float s = 0.0f;
          for (int o = 0; o < C; ++o) s = fmaf(Wc0[c * S + o], bDc[o], s);
          dm[r] = dm0[r] + s;
          g_lns[r] = fmaf(dm[r], vhat[r], g_lns[r]);
          g_lnb[r] += dm[r];
          const float gg = dm[r] * LNS[c];
          gpart += gg;
          gvpart += gg * vhat[r];
        }
      }
      const float mean_g = warp_sum(gpart) * invC;
      const float mean_gv = warp_sum(gvpart) * invC;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) {
          const float dv = sig * (dm[r] * LNS[c] - mean_g - vhat[r] * mean_gv);
          g_b2[r] += dv;
          const float dvr = rd<FAST>(dv);
          bDv[c] = dvr;
          const int j0 = (c / wh) * wh;
          for (int jj = 0; jj < wh; ++jj)
            gW2[jj * C + c] = fmaf(dvr, bS1[j0 + jj], gW2[jj * C + c]);
        }
      }
      __syncwarp();
      // ---- backward: head block, SiLU, first layer ----
      float dgp[12];
#pragma unroll
      for (int q = 0; q < 12; ++q) dgp[q] = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) {
          const int j0 = (c / wh) * wh;
          float s = 0.0f;
          for (int o = j0; o < j0 + wh; ++o) s = fmaf(W2[c * S + o], bDv[o], s);
          const float du = dsilu(u[r]) * s;
          g_b1[r] += du;
          const float dur = rd<FAST>(du);
          du_sum[r] += dur;
          bDu[c] = dur;
          for (int j = 0; j < C; ++j) gW1hc[j * C + c] = fmaf(dur, bHc[j], gW1hc[j * C + c]);
#pragma unroll
          for (int q = 0; q < 12; ++q) {
            gW1g[q * C + c] = fmaf(dur, g[q], gW1g[q * C + c]);
            dgp[q] = fmaf(W1g[q * C + c], dur, dgp[q]);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {   // dh_col = W1hcᵀ du, onto the neighbor
        const int c = lane + 32 * r;
        if (c < C) {
          float s = 0.0f;
          for (int o = 0; o < C; ++o) s = fmaf(W1hc[c * S + o], bDu[o], s);
          atomicAdd(dh_nbr + (size_t)j_nb * C + c, s);
        }
      }
#pragma unroll
      for (int q = 0; q < 12; ++q) dgp[q] = warp_sum(dgp[q]);

      // ---- backward: geometry (every lane, the same values) ----
      const float live = degen ? 0.0f : 1.0f;
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
      normalize_bwd(r0, r1, r2, n_rel, inv_rel, da0, da1, da2);    // → drel from a
      const float dradial = dgp[0], ddist = dgp[1], ddot = dgp[2];
      const float q0 = (dax0 * scale + da0) + 2.0f * r0 * dradial + (r0 / dist) * ddist;
      const float q1 = (dax1 * scale + da1) + 2.0f * r1 * dradial + (r1 / dist) * ddist;
      const float q2 = (dax2 * scale + da2) + 2.0f * r2 * dradial + (r2 / dist) * ddist;
      dxi0 += q0 + xc0 * ddot + dxr0;
      dxi1 += q1 + xc1 * ddot + dxr1;
      dxi2 += q2 + xc2 * ddot + dxr2;
      if (lane < 3) {
        const float d = lane == 0 ? (-q0 + xi0 * ddot + dxc0)
                      : lane == 1 ? (-q1 + xi1 * ddot + dxc1)
                                  : (-q2 + xi2 * ddot + dxc2);
        atomicAdd(dx_nbr + (size_t)j_nb * 3 + lane, d);
      }
    }

    // ---- per center: dh_row = W1hrᵀ Σ_k du, dW1hr += (Σ_k du) ⊗ h_i ----
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r < C) bDs[lane + 32 * r] = du_sum[r];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < C) {
        float s = 0.0f;
        for (int o = 0; o < C; ++o) s = fmaf(W1hr[c * S + o], bDs[o], s);
        dh_center[(size_t)center * C + c] = s;
        for (int j = 0; j < C; ++j) gW1hr[j * C + c] = fmaf(du_sum[r], bHi[j], gW1hr[j * C + c]);
      }
    }
    if (lane == 0) {
      dx_center[(size_t)center * 3 + 0] = dxi0;
      dx_center[(size_t)center * 3 + 1] = dxi1;
      dx_center[(size_t)center * 3 + 2] = dxi2;
    }
  }

  // ---- flush: vector gradients from registers, matrices summed over warps ----
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = lane + 32 * r;
    if (c < C) {
      atomicAdd(grads + off.b1 + c, g_b1[r]);
      atomicAdd(grads + off.b2 + c, g_b2[r]);
      atomicAdd(grads + off.lns + c, g_lns[r]);
      atomicAdd(grads + off.lnb + c, g_lnb[r]);
      atomicAdd(grads + off.bc0 + c, g_bc0[r]);
      atomicAdd(grads + off.wc1 + c, g_wc1[r]);
    }
  }
  __syncthreads();
  const float* warps0 = smem + sm.weights;
  for (int t = threadIdx.x; t < sm.per_warp - sm.g_w1hr; t += blockDim.x) {
    const int idx = sm.g_w1hr + t;
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += warps0[w * sm.per_warp + idx];
    int dst;
    if (idx < sm.g_w1hc) dst = off.w1hr + (idx - sm.g_w1hr);
    else if (idx < sm.g_wc0) dst = off.w1hc + (idx - sm.g_w1hc);
    else if (idx < sm.g_w1g) dst = off.wc0 + (idx - sm.g_wc0);
    else if (idx < sm.g_w2) dst = off.w1g + (idx - sm.g_w1g);
    else {
      const int i = idx - sm.g_w2, jj = i / C, c = i % C;
      dst = off.w2 + ((c / wh) * wh + jj) * C + c;
    }
    atomicAdd(grads + dst, s);
  }
}

template <int R, bool FAST>
int launch(const float* h, const float* x, const int* nbr, const float* params,
           const float* dagg_m, const float* dagg_x, float* dh_center, float* dx_center,
           float* dh_nbr, float* dx_nbr, float* grads, int B, int N, int K, int C,
           int wh, cudaStream_t stream) {
  const Smem sm(C, wh);
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int warps = (optin / (int)sizeof(float) - sm.weights) / sm.per_warp;
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(sm.weights + warps * sm.per_warp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_bwd_kernel<R, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, egcl_bwd_kernel<R, FAST>,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const int total = B * N;
  const int need = (total + warps - 1) / warps;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);   // resident blocks; each flushes once
  const int grid = need < cap ? need : cap;
  egcl_bwd_kernel<R, FAST><<<grid, warps * 32, smem, stream>>>(
      h, x, nbr, params, dagg_m, dagg_x, dh_center, dx_center, dh_nbr, dx_nbr, grads,
      total, N, K, C, wh);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B,N,C], x [B,N,3] f32 (the layer inputs), nbr [B,N,K] int32 in [0, N),
// params: the packed buffer of ops/kernels/egcl.py::pack_params, dagg_m
// [B,N,C], dagg_x [B,N,3]. Outputs: dh_center [B,N,C] and dx_center [B,N,3]
// (written), dh_nbr [B,N,C], dx_nbr [B,N,3] and grads (the packed layout up
// to wn0) accumulated with atomics: the caller zero-fills them.
extern "C" int egcl_backward_launch(const void* h, const void* x, const void* nbr,
                                    const void* params, const void* dagg_m,
                                    const void* dagg_x, void* dh_center, void* dx_center,
                                    void* dh_nbr, void* dx_nbr, void* grads, int B,
                                    int N, int K, int C, int head_width, int fast,
                                    void* stream) {
  if (C < 1 || C > 64 || head_width < 1 || C % head_width) return (int)cudaErrorInvalidValue;
  const float* hf = static_cast<const float*>(h);
  const float* xf = static_cast<const float*>(x);
  const int* nb = static_cast<const int*>(nbr);
  const float* p = static_cast<const float*>(params);
  const float* dm = static_cast<const float*>(dagg_m);
  const float* dx = static_cast<const float*>(dagg_x);
  float* dhc = static_cast<float*>(dh_center);
  float* dxc = static_cast<float*>(dx_center);
  float* dhn = static_cast<float*>(dh_nbr);
  float* dxn = static_cast<float*>(dx_nbr);
  float* g = static_cast<float*>(grads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32)
    return fast ? launch<1, true>(hf, xf, nb, p, dm, dx, dhc, dxc, dhn, dxn, g, B, N, K, C, head_width, s)
                : launch<1, false>(hf, xf, nb, p, dm, dx, dhc, dxc, dhn, dxn, g, B, N, K, C, head_width, s);
  return fast ? launch<2, true>(hf, xf, nb, p, dm, dx, dhc, dxc, dhn, dxn, g, B, N, K, C, head_width, s)
              : launch<2, false>(hf, xf, nb, p, dm, dx, dhc, dxc, dhn, dxn, g, B, N, K, C, head_width, s);
}
