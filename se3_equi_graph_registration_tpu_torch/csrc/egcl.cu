// One fused EGCL layer ('center' direction, 'frame' so3 mode), forward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel se3_equi_graph_registration_tpu/ops/pallas/
// egcl_kernel.py::_egcl_kernel (wrappers egcl_layer_pallas,
// egnn_forward_pallas), forward only. The TPU kernel gathers neighbors with
// one-hot MXU matmuls over a window slice and aggregates with a transposed
// one-hot: workarounds for a machine without fast gathers. Here the
// neighbor gather is a plain indexed load, exact for any graph.
//
// Layout: h [B, N, C] (channels contiguous), x [B, N, 3], nbr [B, N, K]
// int32 with every index in [0, N). One warp owns one center; lane l holds
// channels l and l + 32 (C ≤ 64). The layer's weights sit in shared memory,
// transposed to [in][out] so the 32 lanes read 32 consecutive words (no bank
// conflicts); vectors every lane needs (h_col, activations) go through a
// per-warp shared buffer and are read as broadcasts.
//
// What bounds it: operations. At C = 32 an edge costs ~7.5 kFLOP (first
// layer 2·C·(C+12) with the h_row block hoisted per center, head block,
// coord MLP) against 4·(C+4) bytes of gathered input, so the edge program is
// compute-bound on the fp32 pipes: each FMA also needs a shared-memory
// weight load. The design removes all HBM traffic but the gathers and one
// write per center: messages and coordinate updates accumulate in registers
// (the k-regular sum without atomics), and the node MLP and residual finish
// in the same warp. wgmma tiles for the edge MLPs are later work.
//
// agg_m, the message sum before the node MLP, is written only when the
// caller passes an output for it (training: the backward, egcl_backward.cu,
// needs it); serving passes null and the kernel does the same work as
// without the output.
//
// Numerics (egcl_kernel.py:97-114, 200-268): _safe_unit n = sqrt(n²+1e-20),
// v/(n+1e-8); the frame becomes the identity when ‖a‖, ‖b‖ or ‖c‖ < 1e-6;
// geometry [radial, dist, dot, a0,b0,c0,a1,b1,c1,a2,b2,c2]; edge_attr = 1
// folded into b1; LayerNorm with biased variance and eps 1e-5; x' = x +
// Σ_k rel·s. FAST rounds the operands of every MLP product (weights and
// activations) to bf16 with fp32 accumulation, as the TPU's DEFAULT-precision
// matmul does; gathers, geometry, LayerNorm and sums stay fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;          // warps (centers in flight) per block
constexpr int kBuf = 128;          // per-warp broadcast buffer (≥ 2·C)

template <bool FAST>
__device__ __forceinline__ float rd(float v) {
  return FAST ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Offsets {  // float offsets of each tensor in the packed buffer
  int w1hr, w1hc, w1g, b1, w2, b2, lns, lnb, wc0, bc0, wc1, wn0, bn0, wn1, bn1, total;
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
    wn0 = o;  o += 2 * C * C;
    bn0 = o;  o += C;
    wn1 = o;  o += C * C;
    bn1 = o;  o += C;
    total = o;
  }
};

__device__ __forceinline__ void unit(float& a, float& b, float& c, float& n_out) {
  const float n = sqrtf(a * a + b * b + c * c + 1e-20f);
  const float inv = n + 1e-8f;
  a /= inv; b /= inv; c /= inv;
  n_out = n;
}

template <int R, bool FAST>
__global__ void __launch_bounds__(kWarps * 32)
egcl_kernel(const float* __restrict__ h, const float* __restrict__ x,
            const int* __restrict__ nbr, const float* __restrict__ params,
            float* __restrict__ h_out, float* __restrict__ x_out,
            float* __restrict__ aggm_out, int total, int N, int K, int C, int wh) {
  extern __shared__ float smem[];
  const Offsets off(C);
  float* w = smem;
  for (int t = threadIdx.x; t < off.total; t += blockDim.x) {
    const float v = params[t];
    // weights are MLP operands (rounded in FAST); biases and LayerNorm stay fp32
    const bool is_bias = (t >= off.b1 && t < off.w2) || (t >= off.b2 && t < off.wc0) ||
                         (t >= off.bc0 && t < off.wc1) || (t >= off.bn0 && t < off.wn1) ||
                         t >= off.bn1;
    w[t] = is_bias ? v : rd<FAST>(v);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* buf = smem + off.total + warp * kBuf;
  const float invC = 1.0f / (float)C;

  for (int center = blockIdx.x * kWarps + warp; center < total;
       center += gridDim.x * kWarps) {
    const int base = center - center % N;          // b·N
    float hi[R], acc_hr[R], aggm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      hi[r] = c < C ? h[(size_t)center * C + c] : 0.0f;
      aggm[r] = 0.0f;
    }
    const float xi0 = x[(size_t)center * 3 + 0];
    const float xi1 = x[(size_t)center * 3 + 1];
    const float xi2 = x[(size_t)center * 3 + 2];

    // h_row block of the first edge layer: the same for every edge
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r < C) buf[lane + 32 * r] = rd<FAST>(hi[r]);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      float s = 0.0f;
      if (c < C)
        for (int j = 0; j < C; ++j) s = fmaf(w[off.w1hr + j * C + c], buf[j], s);
      acc_hr[r] = s;
    }

    float ax0 = 0.0f, ax1 = 0.0f, ax2 = 0.0f;
    for (int e = 0; e < K; ++e) {
      const int j_nb = base + nbr[(size_t)center * K + e];
      const float xc0 = x[(size_t)j_nb * 3 + 0];
      const float xc1 = x[(size_t)j_nb * 3 + 1];
      const float xc2 = x[(size_t)j_nb * 3 + 2];

      // --- edge geometry (every lane computes the same 12 values) ---
      const float r0 = xi0 - xc0, r1 = xi1 - xc1, r2 = xi2 - xc2;
      float g[12];
      g[0] = r0 * r0 + r1 * r1 + r2 * r2;
      g[1] = sqrtf(g[0] + 1e-20f);
      g[2] = xi0 * xc0 + xi1 * xc1 + xi2 * xc2;
      float a0 = r0, a1 = r1, a2 = r2, an;
      unit(a0, a1, a2, an);
      float b0 = xi1 * xc2 - xi2 * xc1, b1 = xi2 * xc0 - xi0 * xc2,
            b2 = xi0 * xc1 - xi1 * xc0, bn;
      unit(b0, b1, b2, bn);
      const float c0 = a1 * b2 - a2 * b1, c1 = a2 * b0 - a0 * b2, c2 = a0 * b1 - a1 * b0;
      const float cn = sqrtf(c0 * c0 + c1 * c1 + c2 * c2 + 1e-20f);
      const float aun = sqrtf(a0 * a0 + a1 * a1 + a2 * a2 + 1e-20f);
      const float bun = sqrtf(b0 * b0 + b1 * b1 + b2 * b2 + 1e-20f);
      if (aun < 1e-6f || bun < 1e-6f || cn < 1e-6f) {
        g[3] = 1.f; g[4] = 0.f; g[5] = 0.f;
        g[6] = 0.f; g[7] = 1.f; g[8] = 0.f;
        g[9] = 0.f; g[10] = 0.f; g[11] = 1.f;
      } else {
        g[3] = a0; g[4] = b0; g[5] = c0;
        g[6] = a1; g[7] = b1; g[8] = c1;
        g[9] = a2; g[10] = b2; g[11] = c2;
      }

      // --- edge MLP first layer: h_col block + geometry block ---
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) buf[c] = rd<FAST>(h[(size_t)j_nb * C + c]);
      }
      __syncwarp();
      float m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        float shc = 0.0f, sg = 0.0f;
        if (c < C) {
          for (int j = 0; j < C; ++j) shc = fmaf(w[off.w1hc + j * C + c], buf[j], shc);
#pragma unroll
          for (int q = 0; q < 12; ++q) sg = fmaf(w[off.w1g + q * C + c], rd<FAST>(g[q]), sg);
        }
        m[r] = c < C ? silu(((acc_hr[r] + shc) + sg) + w[off.b1 + c]) : 0.0f;
      }
      // --- block-diagonal head layer ---
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane + 32 * r < C) buf[lane + 32 * r] = rd<FAST>(m[r]);
      __syncwarp();
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) {
          const int j0 = (c / wh) * wh;
          float s = 0.0f;
          for (int j = j0; j < j0 + wh; ++j) s = fmaf(w[off.w2 + j * C + c], buf[j], s);
          m[r] = s + w[off.b2 + c];
          part += m[r];
        }
      }
      // --- LayerNorm over channels (biased variance, eps 1e-5) ---
      const float mu = warp_sum(part) * invC;
      float vpart = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane + 32 * r < C) vpart += (m[r] - mu) * (m[r] - mu);
      const float rstd = rsqrtf(warp_sum(vpart) * invC + 1e-5f);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) {
          m[r] = (m[r] - mu) * rstd * w[off.lns + c] + w[off.lnb + c];
          aggm[r] += m[r];
          buf[c] = rd<FAST>(m[r]);
        }
      }
      __syncwarp();
      // --- coordinate MLP: s = wc1 · silu(wc0 m + bc0) ---
      float spart = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c < C) {
          float s = 0.0f;
          for (int j = 0; j < C; ++j) s = fmaf(w[off.wc0 + j * C + c], buf[j], s);
          spart = fmaf(w[off.wc1 + c], rd<FAST>(silu(s + w[off.bc0 + c])), spart);
        }
      }
      const float sc = warp_sum(spart);
      ax0 += r0 * sc; ax1 += r1 * sc; ax2 += r2 * sc;
    }

    if (lane == 0) {
      x_out[(size_t)center * 3 + 0] = xi0 + ax0;
      x_out[(size_t)center * 3 + 1] = xi1 + ax1;
      x_out[(size_t)center * 3 + 2] = xi2 + ax2;
    }
    if (aggm_out != nullptr) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane + 32 * r < C) aggm_out[(size_t)center * C + lane + 32 * r] = aggm[r];
    }
    // --- node MLP on [h, Σ m] and residual ---
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < C) { buf[c] = rd<FAST>(hi[r]); buf[C + c] = rd<FAST>(aggm[r]); }
    }
    __syncwarp();
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      float s = 0.0f;
      if (c < C)
        for (int j = 0; j < 2 * C; ++j) s = fmaf(w[off.wn0 + j * C + c], buf[j], s);
      o[r] = c < C ? silu(s + w[off.bn0 + c]) : 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + 32 * r < C) buf[lane + 32 * r] = rd<FAST>(o[r]);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < C) {
        float s = 0.0f;
        for (int j = 0; j < C; ++j) s = fmaf(w[off.wn1 + j * C + c], buf[j], s);
        h_out[(size_t)center * C + c] = hi[r] + (s + w[off.bn1 + c]);
      }
    }
  }
}

template <int R, bool FAST>
int launch(const float* h, const float* x, const int* nbr, const float* params,
           float* h_out, float* x_out, float* aggm_out, int B, int N, int K, int C,
           int wh, cudaStream_t stream) {
  const size_t smem = (Offsets(C).total + kWarps * kBuf) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_kernel<R, FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int total = B * N;
  const int need = (total + kWarps - 1) / kWarps;
  const int grid = need < sms * 8 ? need : sms * 8;  // warps loop over centers
  egcl_kernel<R, FAST><<<grid, kWarps * 32, smem, stream>>>(
      h, x, nbr, params, h_out, x_out, aggm_out, total, N, K, C, wh);
  return (int)cudaGetLastError();
}

}  // namespace

// h [B,N,C], x [B,N,3] f32, nbr [B,N,K] int32, params: the packed buffer of
// ops/kernels/egcl.py::pack_params. Outputs h_out [B,N,C], x_out [B,N,3],
// and agg_m [B,N,C] unless aggm_out is null.
extern "C" int egcl_launch(const void* h, const void* x, const void* nbr,
                           const void* params, void* h_out, void* x_out,
                           void* aggm_out, int B, int N, int K, int C,
                           int head_width, int fast, void* stream) {
  if (C < 1 || C > 64 || head_width < 1 || C % head_width) return (int)cudaErrorInvalidValue;
  const float* hf = static_cast<const float*>(h);
  const float* xf = static_cast<const float*>(x);
  const int* nb = static_cast<const int*>(nbr);
  const float* p = static_cast<const float*>(params);
  float* ho = static_cast<float*>(h_out);
  float* xo = static_cast<float*>(x_out);
  float* am = static_cast<float*>(aggm_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 32)
    return fast ? launch<1, true>(hf, xf, nb, p, ho, xo, am, B, N, K, C, head_width, s)
                : launch<1, false>(hf, xf, nb, p, ho, xo, am, B, N, K, C, head_width, s);
  return fast ? launch<2, true>(hf, xf, nb, p, ho, xo, am, B, N, K, C, head_width, s)
              : launch<2, false>(hf, xf, nb, p, ho, xo, am, B, N, K, C, head_width, s);
}
