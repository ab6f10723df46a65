// Pieces shared by the meta-prototype kernels: csrc/mpm.cu (forward K1
// assign, K2 match) and csrc/mpm_bwd.cu (the backward, K4).
//
// - Vec<T>: 16-byte vectors of the feature type (4 fp32 or 8 bf16),
//   unpacked to and packed from fp32.
// - The row ring: pixel rows stream through shared-memory stages of
//   kStageRows rows filled by 16-byte cp.async; `wait_ring` keeps all but
//   the newest stages in flight.
// - Tables: a k-major [rows][c] fp32 table in shared memory is permuted so
//   that lane l, which owns the 16-byte feature chunks q = l + 32 j, reads
//   the float4 quarters of its chunks consecutively with its neighbours
//   (`tab_off`, `tab4`): a warp reads its slice of a table row once per
//   group of R rows, without bank conflicts.
// - `group_sums` + `reduce_scatter`: the per-row dot products of a group
//   of R rows against such a table, summed over the warp by one
//   reduce-scatter butterfly (31 shuffles), so that lane l ends with sum l.
// - `block_tree`: a fixed-order sum over the warps of a block, so every
//   result is bit-identical run to run without atomics on any sum.
// - p above 8 runs on the instance of the next of 12 and 16
//   (`padded_protos`): the wrappers pad the centers and prototypes with
//   zero columns, the kernels take the live count p and keep the padded
//   columns out of every softmax and max; such an instance accumulates
//   column passes of 256 channels (`pass_cols`), half the registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

// The build compiles each mpm source once per feature type, in parallel
// (build.py): -DPEMP_FEATURE_BF16=1 instantiates the bfloat16 kernels, 0
// the float32 ones, and a library's entry points refuse the other type.
#ifndef PEMP_FEATURE_BF16
#error "compile with -DPEMP_FEATURE_BF16=1 (bfloat16 features) or 0 (float32)"
#endif

namespace pemp {

using Feature = std::conditional_t<PEMP_FEATURE_BF16 != 0, __nv_bfloat16, float>;
constexpr int kFeatureBf16 = PEMP_FEATURE_BF16 != 0;

constexpr int kMaxProtos = 16;                     // p <= 16 (2p <= 32 columns)
constexpr int kMaxK2 = 2 * kMaxProtos;
constexpr int kThreads = 256;                      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 32;                     // pixel rows per ring stage
constexpr int kRowsPerWarp = kStageRows / kWarps;  // 4
constexpr int kPassCols = 512;                     // channels a pass: 16 per lane
constexpr int kMinStages = 2;

// the instance that runs p prototypes a class: p itself up to 8, then
// 12 or 16 (0: none)
__host__ __device__ constexpr int padded_protos(int p) {
  return p < 1 ? 0 : p <= 8 ? p : p <= 12 ? 12 : p <= 16 ? 16 : 0;
}

// channels of a column pass of the instance P: the accumulators hold
// 2P x pass_cols / 32 floats a lane
__host__ __device__ constexpr int pass_cols(int P) { return P <= 8 ? kPassCols : kPassCols / 2; }
constexpr unsigned kFull = 0xffffffffu;

// most stages of a row ring of the feature type T: 128 KB bf16, 192 KB f32
template <typename T>
struct RingStages {
  static constexpr int NS = sizeof(T) == 2 ? 4 : 3;
};

// 16-byte vector of the feature type, unpacked to / packed from fp32.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
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
  // round to nearest even, as a float32 -> bfloat16 cast
  __device__ static uint4 pack(const float* x) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// wait until at most ns-1 stages are in flight, so the oldest has landed
// (ns is 2..4)
__device__ __forceinline__ void wait_ring(int ns) {
  if (ns >= 4) cp_async_wait<3>();
  else if (ns == 3) cp_async_wait<2>();
  else cp_async_wait<1>();
}

// One step of a reduce-scatter butterfly over the warp: a lane keeps the
// half of v[0, 2*HALF) on its side of bit HALF, adds its partner's sums
// of that half into v[0, HALF), and recurses. Lane l ends with the
// warp-wide sum of v[l] in v[0] (31 shuffles for 32 sums); a template so
// every index is a constant and v stays in registers.
template <int HALF>
__device__ __forceinline__ void reduce_scatter(float (&v)[32], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = upper ? v[j] : v[j + HALF];
    const float keep = upper ? v[j + HALF] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
  if constexpr (HALF > 1) reduce_scatter<HALF / 2>(v, lane);
}

// Offset of column `col` of row k of a permuted [rows][c] table whose
// feature chunks hold V columns: the V/4 float4 quarters h of chunk q
// sit at [h][q].
template <int V>
__device__ __forceinline__ int tab_off(int k, int col, int c) {
  return k * c + (col % V) / 4 * (c / V) * 4 + col / V * 4 + col % 4;
}

// quarter h of chunk q of row k
template <int V>
__device__ __forceinline__ float4 tab4(const float* tab, int k, int h, int q, int c) {
  return *reinterpret_cast<const float4*>(tab + k * c + h * (c / V) * 4 + q * 4);
}

// squared norms of the k2 rows of a [k2][c] table in shared memory, one
// warp per row (any column order)
__device__ __forceinline__ void table_norms_sq(const float* table, float* out, int c, int k2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < k2; k += kWarps) {
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += table[k * c + j] * table[k * c + j];
    s = warp_sum(s);
    if (lane == 0) out[k] = s;
  }
}

// Copy a k-major [nt][c] fp32 table (16-byte aligned) from device memory
// into rows k0 .. k0+nt-1 of the permuted table `tab`.
template <int V>
__device__ __forceinline__ void load_table_rows(float* tab, int k0, const float* src, int nt,
                                                int c) {
  const int c4 = c / 4;
  for (int idx = threadIdx.x; idx < nt * c4; idx += kThreads) {
    const int k = idx / c4, col = idx % c4 * 4;
    *reinterpret_cast<float4*>(tab + tab_off<V>(k0 + k, col, c)) =
        __ldg(reinterpret_cast<const float4*>(src) + idx);
  }
}

// Per-lane partial sums of rows g .. g+R-1 of `tile` (row stride c; rows
// at or past `live` count as zero) against the NT rows of the permuted
// table `tab`, over the lane's chunks of every column: v[r*W + k] gets
// x_r . tab_k, and |x_r|^2 goes to v[r*W + NT] (SQ) or to sq[r].
template <typename T, int NT, int R, int W, bool SQ>
__device__ __forceinline__ void group_sums(const T* tile, int g, int live, const float* tab,
                                           int c, int lane, float (&v)[32], float (&sq)[R]) {
  static_assert(R * W <= 32 && W >= NT + (SQ ? 1 : 0), "sums do not fit the warp");
  constexpr int V = Vec<T>::N;
  constexpr int NCH = kPassCols / (32 * V);
  const int cv = c / V;
  for (int q0 = 0; q0 < cv; q0 += 32 * NCH) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = q0 + lane + 32 * j;
      if (q < cv) {
        float x[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (g + r < live) {
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V),
                           x[r]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) x[r][e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if constexpr (SQ) v[r * W + NT] = fmaf(x[r][e], x[r][e], v[r * W + NT]);
            else sq[r] = fmaf(x[r][e], x[r][e], sq[r]);
          }
        }
#pragma unroll
        for (int k = 0; k < NT; ++k) {
#pragma unroll
          for (int h = 0; h < V / 4; ++h) {
            const float4 w = tab4<V>(tab, k, h, q, c);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float& d = v[r * W + k];
              d = fmaf(x[r][4 * h], w.x, d);
              d = fmaf(x[r][4 * h + 1], w.y, d);
              d = fmaf(x[r][4 * h + 2], w.z, d);
              d = fmaf(x[r][4 * h + 3], w.w, d);
            }
          }
        }
      }
    }
  }
}

// The block's sum of acc[K][NCH*V] (each lane's columns q = qz + lane +
// 32 j of one pass) in a fixed tree over the warps through shared memory
// (`slots`: kWarps/2 slots of [K][pc] fp32): warp w adds warp w+h's sums
// for h = 4, 2, 1, and warp 0 ends with the totals in its registers.
template <int K, int NCH, int V>
__device__ __forceinline__ void block_tree(float (&acc)[K][NCH * V], float* slots, int qz,
                                           int cv, int pc, int warp, int lane) {
#pragma unroll
  for (int h = kWarps / 2; h > 0; h >>= 1) {
    if (warp >= h && warp < 2 * h) {
      float* o = slots + (size_t)(warp - h) * K * pc;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int q = qz + lane + 32 * j;
        if (q < cv) {
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int e = 0; e < V; e += 4)
              *reinterpret_cast<float4*>(o + k * pc + (q - qz) * V + e) =
                  make_float4(acc[k][j * V + e], acc[k][j * V + e + 1], acc[k][j * V + e + 2],
                              acc[k][j * V + e + 3]);
        }
      }
    }
    __syncthreads();
    if (warp < h) {
      const float* o = slots + (size_t)warp * K * pc;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int q = qz + lane + 32 * j;
        if (q < cv) {
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int e = 0; e < V; e += 4) {
              const float4 y = *reinterpret_cast<const float4*>(o + k * pc + (q - qz) * V + e);
              acc[k][j * V + e] += y.x;
              acc[k][j * V + e + 1] += y.y;
              acc[k][j * V + e + 2] += y.z;
              acc[k][j * V + e + 3] += y.w;
            }
        }
      }
    }
    __syncthreads();
  }
}

// Store acc[K][NCH*V] (the lane's columns of one pass) to the k-major
// [K][c] fp32 array `dst` in device memory.
template <int K, int NCH, int V>
__device__ __forceinline__ void store_cols(const float (&acc)[K][NCH * V], float* dst, int c,
                                           int qz, int cv, int lane) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int q = qz + lane + 32 * j;
    if (q < cv) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(dst + (size_t)k * c + q * V + e) =
              make_float4(acc[k][j * V + e], acc[k][j * V + e + 1], acc[k][j * V + e + 2],
                          acc[k][j * V + e + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t launch_config(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Ring stages for `kernel`, whose dynamic shared memory at ns stages is
// smem_of(ns), on the current device: among the ns in [kMinStages,
// max_ns] whose shared memory fits a block (beside the kernel's static
// shared memory), the one with the most blocks an SM, the larger on a
// tie; 0 (rows read from device memory) when no ring fits but smem_of(0)
// does; -1 when nothing fits or on a CUDA error. *slots gets the blocks
// the device holds at once.
template <typename Kernel, typename SmemOf>
int ring_plan(Kernel kernel, SmemOf smem_of, int max_ns, int* slots) {
  int dev = 0, limit = 0, sms = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return -1;
  int best = -1, best_blocks = 0;
  for (int ns = max_ns; ns >= 0; --ns) {
    if (ns == 1 || (ns == 0 && best >= 0)) continue;
    const size_t smem = smem_of(ns);
    if (smem + attr.sharedSizeBytes > (size_t)limit) continue;
    int blocks = 0;
    if (launch_config(kernel, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
            cudaSuccess)
      return -1;
    if (blocks > best_blocks) {
      best = ns;
      best_blocks = blocks;
    }
  }
  *slots = best_blocks * sms;
  return best;
}

}  // namespace pemp
