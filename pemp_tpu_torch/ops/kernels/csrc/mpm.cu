// Meta-prototype module kernels for Hopper (sm_90a): soft assignment (K1)
// and dense cosine matching with a max over prototypes (K2), reading the
// packed purifier output [B, S+Q, n, c] directly (K3 = K1 then K2).
//
// Replaces pemp_tpu/ops/pallas/mpm.py: _assign_kernel (K1), _match_kernel
// (K2), both as run by mpm_chain_packed_pallas (K3).
//
// What bounds them on an H100: device memory. Per pixel row the assign
// kernel does ~8p+2 flops per feature element (f.ctr, a^T f, |f|^2) and
// the match kernel ~4p+2, i.e. ~13 flops per bf16 byte at p=3, far below
// the ~295 flops/byte where the tensor cores would matter and under the
// 67 TFLOP/s fp32 CUDA-core rate's own break-even (~20 flops/byte). So
// both kernels use fp32 CUDA cores (no wgmma, no TMA) and are designed to
// read each feature row from device memory once:
//   - one warp per pixel row, 16-byte vector loads (8 bf16 / 4 f32 per
//     lane), |f|^2 and the 2p dot products reduced with warp shuffles;
//   - the assign kernel stages its tile of rows in shared memory in the
//     input type, so the a^T f reduction re-reads shared memory, not HBM;
//   - the centers / prototypes sit in shared memory, read as float4.
// Determinism: the assign kernel's per-tile partial sums go to a scratch
// buffer and a second launch reduces them over tiles in a fixed order --
// no atomics, so the prototypes (and K2's first-occurrence argmax that
// reads them) are bit-identical from run to run.
// Rows >= n of the boundary tile are never loaded (a select on the row
// index, not a multiply by zero: 0 * NaN would poison the sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxProtos = 8;          // p <= 8 (2p <= 16 columns)
constexpr int kMaxK2 = 2 * kMaxProtos;
constexpr int kTile = 64;              // pixel rows per block
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;

// 16-byte vector of the feature type, unpacked to fp32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// |f|^2 and the k2 dot products of one row (V-chunked, lane-strided)
// against a k-major [k2][c] fp32 table in shared memory. Optionally copies
// the raw row into `stage` (shared memory). Results are warp-reduced, so
// every lane holds the totals.
template <typename T>
__device__ __forceinline__ void row_dots(const T* __restrict__ row, const float* table,
                                         T* stage, int c, int k2, float& sq,
                                         float (&dot)[kMaxK2]) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  sq = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK2; ++k) dot[k] = 0.f;
  for (int v = lane; v < c / V; v += 32) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + v * V);
    if (stage != nullptr) *reinterpret_cast<uint4*>(stage + v * V) = raw;
    float x[V];
    Vec<T>::unpack(raw, x);
#pragma unroll
    for (int j = 0; j < V; ++j) sq += x[j] * x[j];
#pragma unroll
    for (int k = 0; k < kMaxK2; ++k) {
      if (k < k2) {
        const float4* t = reinterpret_cast<const float4*>(table + k * c + v * V);
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 w = t[q];
          dot[k] += x[4 * q] * w.x + x[4 * q + 1] * w.y + x[4 * q + 2] * w.z + x[4 * q + 3] * w.w;
        }
      }
    }
  }
  sq = warp_sum(sq);
#pragma unroll
  for (int k = 0; k < kMaxK2; ++k)
    if (k < k2) dot[k] = warp_sum(dot[k]);
}

// squared norms of the k2 rows of a k-major [k2][c] table, one warp per row
__device__ void table_norms_sq(const float* table, float* out, int c, int k2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < k2; k += kWarps) {
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += table[k * c + j] * table[k * c + j];
    s = warp_sum(s);
    if (lane == 0) out[k] = s;
  }
}

// ---------------------------------------------------------------------------
// K1, launch 1: per (support image, pixel tile) partial sums
//   part[i, t, k, 0:c] = sum_rows a[row, k] * f[row, :],  part[i, t, k, c] = sum_rows a[row, k]
// with a = per-class softmax over the class's own p centers of
// -(|f|^2 - 2 f.ctr + |ctr|^2), times the class mask.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
assign_partial_kernel(const T* __restrict__ fts, const float* __restrict__ fg,
                      const float* __restrict__ bg, const float* __restrict__ ctr,
                      float* __restrict__ part, int S, int SQ, int n, int c, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k2 = 2 * p;
  float* ctr_s = reinterpret_cast<float*>(smem_raw);       // [k2][c]
  float* a_s = ctr_s + k2 * c;                              // [kTile][k2]
  T* tile_s = reinterpret_cast<T*>(a_s + kTile * k2);       // [kTile][c]
  __shared__ float csq_s[kMaxK2];

  const int i = blockIdx.x;                     // support image in [0, B*S)
  const int t = blockIdx.y;                     // pixel tile
  const int tiles = gridDim.y;
  const int img = (i / S) * SQ + i % S;         // packed support row
  const int row0 = t * kTile;
  const int rows = min(kTile, n - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < c * k2; idx += kThreads)
    ctr_s[(idx % k2) * c + idx / k2] = ctr[idx];            // [c,k2] -> [k2,c]
  __syncthreads();
  table_norms_sq(ctr_s, csq_s, c, k2);
  __syncthreads();

  const T* base = fts + ((size_t)img * n + row0) * c;
  const float* mfg = fg + (size_t)i * n + row0;
  const float* mbg = bg + (size_t)i * n + row0;
  for (int r = warp; r < rows; r += kWarps) {
    float fsq, dot[kMaxK2];
    row_dots<T>(base + (size_t)r * c, ctr_s, tile_s + (size_t)r * c, c, k2, fsq, dot);
    if (lane == 0) {
      float dist[kMaxK2];
#pragma unroll
      for (int k = 0; k < kMaxK2; ++k)
        if (k < k2) dist[k] = -(fsq - 2.f * dot[k] + csq_s[k]);
      // softmax over each class's own p columns: no exp of the other
      // class's distances, so no overflow when the classes sit far apart
      float mx_f = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int k = 0; k < kMaxProtos; ++k) {
        if (k < p) {
          mx_f = fmaxf(mx_f, dist[k]);
          mx_b = fmaxf(mx_b, dist[p + k]);
        }
      }
      float e[kMaxK2];
      float sum_f = 0.f, sum_b = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxProtos; ++k) {
        if (k < p) {
          e[k] = expf(dist[k] - mx_f);
          e[p + k] = expf(dist[p + k] - mx_b);
          sum_f += e[k];
          sum_b += e[p + k];
        }
      }
      const float wf = mfg[r] / fmaxf(sum_f, 1e-30f);
      const float wb = mbg[r] / fmaxf(sum_b, 1e-30f);
#pragma unroll
      for (int k = 0; k < kMaxProtos; ++k) {
        if (k < p) {
          a_s[r * k2 + k] = e[k] * wf;
          a_s[r * k2 + p + k] = e[p + k] * wb;
        }
      }
    }
  }
  __syncthreads();

  // a^T f over the staged tile: one thread per column, rows in order
  float* out = part + ((size_t)i * tiles + t) * k2 * (c + 1);
  for (int j = threadIdx.x; j < c; j += kThreads) {
    float acc[kMaxK2];
#pragma unroll
    for (int k = 0; k < kMaxK2; ++k) acc[k] = 0.f;
    for (int r = 0; r < rows; ++r) {
      float x;
      if constexpr (sizeof(T) == 2) x = __bfloat162float(tile_s[(size_t)r * c + j]);
      else x = tile_s[(size_t)r * c + j];
#pragma unroll
      for (int k = 0; k < kMaxK2; ++k)
        if (k < k2) acc[k] += a_s[r * k2 + k] * x;
    }
#pragma unroll
    for (int k = 0; k < kMaxK2; ++k)
      if (k < k2) out[(size_t)k * (c + 1) + j] = acc[k];
  }
  if (threadIdx.x < k2) {
    float den = 0.f;
    for (int r = 0; r < rows; ++r) den += a_s[r * k2 + threadIdx.x];
    out[(size_t)threadIdx.x * (c + 1) + c] = den;
  }
}

// ---------------------------------------------------------------------------
// K1, launch 2: fixed-order reduction over tiles, num/(den+eps), mean over S
//   protos[b, k, j] = mean_s( sum_t num[b*S+s, t, k, j] / (sum_t den[b*S+s, t, k] + eps) )
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
assign_reduce_kernel(const float* __restrict__ part, float* __restrict__ protos,
                     int S, int tiles, int c, int k2, float eps) {
  const int b = blockIdx.x;
  const int idx = blockIdx.y * kThreads + threadIdx.x;
  if (idx >= k2 * c) return;
  const int k = idx / c, j = idx % c;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* src = part + ((size_t)(b * S + s) * tiles) * k2 * (c + 1) + (size_t)k * (c + 1);
    float num = 0.f, den = 0.f;
    for (int t = 0; t < tiles; ++t) {
      num += src[(size_t)t * k2 * (c + 1) + j];
      den += src[(size_t)t * k2 * (c + 1) + c];
    }
    acc += num / (den + eps);
  }
  protos[((size_t)b * k2 + k) * c + j] = acc / (float)S;
}

// ---------------------------------------------------------------------------
// K2: cosine matching of query rows against the 2p prototypes of the
// episode, per-class max and first-occurrence argmax, output [bg, fg].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
match_kernel(const T* __restrict__ fts, const float* __restrict__ protos,
             float* __restrict__ logits, int* __restrict__ inds, int S, int Q,
             int SQ, int n, int c, int p, float dist_scalar, float cos_eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k2 = 2 * p;
  float* pr_s = reinterpret_cast<float*>(smem_raw);        // [k2][c]
  __shared__ float pn_s[kMaxK2];

  const int i = blockIdx.x;                     // query image in [0, B*Q)
  const int b = i / Q;
  const int img = b * SQ + S + i % Q;           // packed query row
  const int row0 = blockIdx.y * kTile;
  const int rows = min(kTile, n - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float4* src = reinterpret_cast<const float4*>(protos + (size_t)b * k2 * c);
  for (int idx = threadIdx.x; idx < k2 * c / 4; idx += kThreads)
    reinterpret_cast<float4*>(pr_s)[idx] = src[idx];
  __syncthreads();
  table_norms_sq(pr_s, pn_s, c, k2);
  __syncthreads();
  if (threadIdx.x < k2) pn_s[threadIdx.x] = sqrtf(pn_s[threadIdx.x]);
  __syncthreads();

  const T* base = fts + ((size_t)img * n + row0) * c;
  for (int r = warp; r < rows; r += kWarps) {
    float qsq, dot[kMaxK2];
    row_dots<T>(base + (size_t)r * c, pr_s, static_cast<T*>(nullptr), c, k2, qsq, dot);
    if (lane == 0) {
      const float qn = sqrtf(qsq);
      float fg_max = 0.f, bg_max = 0.f;
      int fg_idx = 0, bg_idx = 0;
#pragma unroll
      for (int k = 0; k < kMaxProtos; ++k) {
        if (k < p) {
          const float sf = dot[k] / fmaxf(qn * pn_s[k], cos_eps) * dist_scalar;
          const float sb = dot[p + k] / fmaxf(qn * pn_s[p + k], cos_eps) * dist_scalar;
          if (k == 0 || sf > fg_max) { fg_max = sf; fg_idx = k; }
          if (k == 0 || sb > bg_max) { bg_max = sb; bg_idx = k; }
        }
      }
      const size_t o = (size_t)i * n + row0 + r;
      reinterpret_cast<float2*>(logits)[o] = make_float2(bg_max, fg_max);
      if (inds != nullptr) reinterpret_cast<int2*>(inds)[o] = make_int2(bg_idx, fg_idx);
    }
  }
}

template <typename Kernel>
cudaError_t launch_config(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int pemp_mpm_max_protos() { return kMaxProtos; }
int pemp_mpm_tile() { return kTile; }

const char* pemp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of the assign kernel (the wrapper checks it
// against the card's per-block limit before launching).
size_t pemp_mpm_assign_smem(int c, int p, int is_bf16) {
  return (size_t)2 * p * c * 4 + (size_t)kTile * 2 * p * 4 + (size_t)kTile * c * (is_bf16 ? 2 : 4);
}

size_t pemp_mpm_match_smem(int c, int p) { return (size_t)2 * p * c * 4; }

// K1, launch 1. fts [B, S+Q, n, c] (f32 or bf16), fg/bg [B*S, n] f32,
// ctr [c, 2p] f32, part [B*S, tiles, 2p, c+1] f32 out.
// Returns cudaGetLastError().
int pemp_mpm_assign_partial(const void* fts, int is_bf16, const void* fg, const void* bg,
                            const void* ctr, void* part, int B, int S, int Q, int n,
                            int c, int p, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem = pemp_mpm_assign_smem(c, p, is_bf16);
  const dim3 grid(B * S, tiles);
  cudaError_t e;
  if (is_bf16) {
    e = launch_config(assign_partial_kernel<__nv_bfloat16>, smem);
    if (e != cudaSuccess) return e;
    assign_partial_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(fts), static_cast<const float*>(fg),
        static_cast<const float*>(bg), static_cast<const float*>(ctr),
        static_cast<float*>(part), S, S + Q, n, c, p);
  } else {
    e = launch_config(assign_partial_kernel<float>, smem);
    if (e != cudaSuccess) return e;
    assign_partial_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(fts), static_cast<const float*>(fg),
        static_cast<const float*>(bg), static_cast<const float*>(ctr),
        static_cast<float*>(part), S, S + Q, n, c, p);
  }
  return cudaGetLastError();
}

// K1, launch 2. part [B*S, tiles, 2p, c+1] f32, protos [B, 2p, c] f32 out
// (fg prototypes first, then bg). Returns cudaGetLastError().
int pemp_mpm_assign_reduce(const void* part, void* protos, int B, int S, int tiles,
                           int c, int p, float eps, void* stream) {
  const int k2 = 2 * p;
  const dim3 grid(B, (k2 * c + kThreads - 1) / kThreads);
  assign_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(protos), S, tiles, c, k2, eps);
  return cudaGetLastError();
}

// fts [B, S+Q, n, c] (f32 or bf16), protos [B, 2p, c] f32 (fg then bg),
// logits [B*Q, n, 2] f32 out ([bg, fg]), inds [B*Q, n, 2] i32 out or NULL.
int pemp_mpm_match(const void* fts, int is_bf16, const void* protos, void* logits,
                   void* inds, int B, int S, int Q, int n, int c, int p,
                   float dist_scalar, float cos_eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = pemp_mpm_match_smem(c, p);
  const dim3 grid(B * Q, (n + kTile - 1) / kTile);
  cudaError_t e;
  if (is_bf16) {
    e = launch_config(match_kernel<__nv_bfloat16>, smem);
    if (e != cudaSuccess) return e;
    match_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(fts), static_cast<const float*>(protos),
        static_cast<float*>(logits), static_cast<int*>(inds), S, Q, S + Q, n, c, p,
        dist_scalar, cos_eps);
  } else {
    e = launch_config(match_kernel<float>, smem);
    if (e != cudaSuccess) return e;
    match_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(fts), static_cast<const float*>(protos),
        static_cast<float*>(logits), static_cast<int*>(inds), S, Q, S + Q, n, c, p,
        dist_scalar, cos_eps);
  }
  return cudaGetLastError();
}

}  // extern "C"
