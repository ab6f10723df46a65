// Min-plus ("tropical") matrix product for the exact squared Euclidean
// distance transform, on Hopper (sm_90a):
//
//   out[z, m, n] = min_k a[z, m, k] + b[z, k, n]
//
// Replaces pemp_tpu/ops/pallas/minplus.py: _kernel (via minplus_matmul),
// the two phases of edt2_pallas. Phase 1 is (i-k)^2 [H, H] against the
// per-image source map [B, H, W] (a shared, batch stride 0 on a); phase 2
// is the phase-1 output [B*H, W] against (j-k)^2 [W, W].
//
// What bounds it on an H100: operations. Each (m, n, k) term is one fp32
// add and one fp32 min; with no multiply there is no FMA to pair them, so
// the rate is 67e12 / 2 = 33.5e12 instructions/s per kind, i.e. 2 instructions
// a term, 64 terms per clock per SM. At the train shapes (bs 4, 401^2) a
// phase is 401*401*1604 terms (~0.0154 ms at that rate) and moves ~5.8 MB
// (~0.0017 ms at 3.35 TB/s). The design is a register-blocked SGEMM with
// (+, min) in place of (*, +), sized for these small outputs:
//   - a thread holds an 8x4 register block; per k it reads 8 + 4 floats
//     from shared memory (three 16-byte loads) for 32 terms, so shared
//     memory (128 B per clock per SM) is not the limit;
//   - a warp covers 32x32 outputs, a block of 4 warps a 64x64 tile; a warp
//     whose 32x32 lies wholly past M or N skips the arithmetic, so the
//     edge tiles of 401 = 6*64 + 17 cost a 32-wide warp, not a 64-wide one;
//   - split-K: a cluster of kSplit blocks takes one output tile, each block
//     its share of the K chunks, so both phases fill the card in one wave
//     (392 and 364 blocks of 128 threads at the train shapes, 4 blocks an
//     SM); the blocks' partial minima meet in distributed shared memory,
//     and each block writes its share of the tile's rows: no atomics, no
//     fill, no second pass;
//   - K is walked in chunks of kTk through a kStages-deep ring of shared
//     memory filled with 4-byte cp.async (the rows of these operands are
//     not 16-byte aligned), one __syncthreads a chunk; a is stored k-major
//     (padded to 68 columns) so it is read back as float4;
//   - m >= M and n >= N are zero-filled and never written out; k >= K is
//     +inf and never wins; so no padded copy is made;
//   - blockIdx.z walks batch x slice with the batch's own strides, so phase 1
//     reads the [B, H, W] map in place with no transposed copy.
// Exactness: every term is one fp32 add, which rounds the same in any
// order, and min is exact and order-free, so the result is bit-identical to
// the plain version (ops/kernels/minplus.py) for any non-NaN fp32 input,
// not only for the EDT's integers.
// What holds it back: the add and min of a term issue as FADD + FMNMX, and
// on the H100 that pair sustains about half the 64 terms per clock per SM
// the bound assumes even on large products (chip_smoke.py times one at
// 2048^3); at 401^2 the 32-row edge warps and the uneven waves cost more.
// Not used: Hopper's DPX __viaddmin_s32 (fused add+min on int32) would
// halve the instruction count but is exact only for integer inputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;              // output rows and columns per block
constexpr int kTk = 16;                // K chunk staged in shared memory
constexpr int kStages = 3;             // ring depth
constexpr int kSplit = 2;              // K slices per tile = blocks per cluster
constexpr int kMinBlocks = 4;          // blocks per SM (<= 128 registers a thread)
constexpr int kRm = 8, kRn = 4;        // register block per thread
constexpr int kThreads = 128;          // 4 warps, 2 x 2 warps of 32 x 32
constexpr int kPad = kTile + 4;        // shared row, float4-aligned

__global__ void __cluster_dims__(1, 1, kSplit) __launch_bounds__(kThreads, kMinBlocks)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int K, int N, long long sa,
               long long sb) {
  // the ring a_s[kStages][kTk][kPad], b_s[kStages][kTk][kPad]; after the
  // K loop the block's partial minima [kTile][kPad]
  __shared__ __align__(16) float smem[2 * kStages * kTk * kPad];
  float* a_s = smem;
  float* b_s = smem + kStages * kTk * kPad;

  cg::cluster_group cluster = cg::this_cluster();
  const int slice = (int)cluster.block_rank();
  const long long z = blockIdx.z / kSplit;
  a += z * sa;
  b += z * sb;
  out += z * (long long)M * N;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int chunks = (K + kTk - 1) / kTk;
  const int c_lo = chunks * slice / kSplit, c_hi = chunks * (slice + 1) / kSplit;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int tm = wm * 32 + (lane >> 3) * kRm;     // the thread's first row in the tile
  const int tn = wn * 32 + (lane & 7) * kRn;      // and first column
  const bool active = m0 + wm * 32 < M && n0 + wn * 32 < N;   // warp-uniform

  // the operand elements this thread copies each chunk: a at rows
  // ar0 + j*kAStep (column ak of the chunk), b at rows bk0 + j*kBStep
  // (column bn); rows and columns past M and N are zero-filled
  constexpr int kACopies = kTile * kTk / kThreads, kAStep = kThreads / kTk;
  constexpr int kBCopies = kTk * kTile / kThreads, kBStep = kThreads / kTile;
  const int ak = threadIdx.x % kTk, ar0 = threadIdx.x / kTk;
  const int bn = threadIdx.x % kTile, bk0 = threadIdx.x / kTile;
  const float* a_src = a + (long long)(m0 + ar0) * K + ak;
  const float* b_src = b + (long long)bk0 * N + n0 + bn;
  const int b_bytes = n0 + bn < N ? 4 : 0;

  auto issue = [&](int chunk) {
    if (chunk < c_hi) {
      const int k0 = chunk * kTk;
      float* as = a_s + ((chunk - c_lo) % kStages) * kTk * kPad;
      float* bs = b_s + ((chunk - c_lo) % kStages) * kTk * kPad;
      // as[k][m] (k-major): consecutive threads read consecutive k of a row
#pragma unroll
      for (int j = 0; j < kACopies; ++j) {
        const int r = ar0 + j * kAStep;
        float* dst = as + ak * kPad + r;
        if (k0 + ak < K) {
          const bool live = m0 + r < M;
          pemp::cp_async4(dst, live ? a_src + (long long)j * kAStep * K + k0 : a, live ? 4 : 0);
        } else {
          *dst = INFINITY;
        }
      }
      // bs[k][n]: consecutive threads read consecutive n of a row
#pragma unroll
      for (int j = 0; j < kBCopies; ++j) {
        const int kk = bk0 + j * kBStep;
        float* dst = bs + kk * kPad + bn;
        if (k0 + kk < K) pemp::cp_async4(dst, b_bytes ? b_src + (long long)(k0 + j * kBStep) * N : b, b_bytes);
        else *dst = INFINITY;
      }
    }
    pemp::cp_async_commit();
  };

  float acc[kRm][kRn];
#pragma unroll
  for (int i = 0; i < kRm; ++i)
#pragma unroll
    for (int j = 0; j < kRn; ++j) acc[i][j] = INFINITY;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(c_lo + s);
  for (int chunk = c_lo; chunk < c_hi; ++chunk) {
    issue(chunk + kStages - 1);
    pemp::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      const float* as = a_s + ((chunk - c_lo) % kStages) * kTk * kPad;
      const float* bs = b_s + ((chunk - c_lo) % kStages) * kTk * kPad;
#pragma unroll
      for (int kk = 0; kk < kTk; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kPad + tm);
        const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kPad + tm + 4);
        const float4 bv = *reinterpret_cast<const float4*>(bs + kk * kPad + tn);
        const float ra[kRm] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float rb[kRn] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kRm; ++i)
#pragma unroll
          for (int j = 0; j < kRn; ++j) acc[i][j] = fminf(acc[i][j], ra[i] + rb[j]);
      }
    }
    __syncthreads();                     // this slot is refilled next iteration
  }
  pemp::cp_async_wait<0>();

  // the slices meet in distributed shared memory; block `slice` finishes
  // rows [slice, slice+1) * kTile/kSplit of the tile
  float* part = smem;                    // [kTile][kPad]
#pragma unroll
  for (int i = 0; i < kRm; ++i)
    *reinterpret_cast<float4*>(part + (tm + i) * kPad + tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();
  constexpr int kRows = kTile / kSplit;
  for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
    const int r = slice * kRows + idx / kTile, cc = idx % kTile;
    float v = INFINITY;
#pragma unroll
    for (int q = 0; q < kSplit; ++q) v = fminf(v, cluster.map_shared_rank(part, q)[r * kPad + cc]);
    const int m = m0 + r, n = n0 + cc;
    if (m < M && n < N) out[(long long)m * N + n] = v;
  }
  cluster.sync();                        // keep this block's partial alive for the others
}

}  // namespace

extern "C" {

int pemp_minplus_tile() { return kTile; }
int pemp_minplus_split() { return kSplit; }

const char* pemp_minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [batch, M, N] f32 = min-plus of a [batch, M, K] (batch stride sa
// elements, 0 = shared) and b [batch, K, N] (batch stride sb), all
// contiguous f32. Launches on `stream`; returns cudaGetLastError().
int pemp_minplus(const void* a, const void* b, void* out, int batch, int M, int K,
                 int N, long long sa, long long sb, void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, batch * kSplit);
  minplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      M, K, N, sa, sb);
  return cudaGetLastError();
}

}  // extern "C"
