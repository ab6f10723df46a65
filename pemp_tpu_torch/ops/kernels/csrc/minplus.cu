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
// a term. At the train shapes (bs 4, 401^2) a phase is 401*401*1604 terms
// (~0.0154 ms at that rate) and moves ~5.8 MB (~0.0017 ms at 3.35 TB/s).
// The design is the classic register-blocked SGEMM shape with (+, min) in
// place of (*, +):
//   - a block computes a 64x64 output tile with 256 threads, each thread a
//     4x4 register block, reusing each shared-memory value 4 times;
//   - K is walked in chunks of 32; the a and b sub-tiles are staged in
//     shared memory (a k-major, padded to 68 columns so the transposing
//     store spreads over banks, and read back as float4);
//   - m >= M, n >= N and k >= K are masked in the kernel (the missing
//     terms are +inf and never win), so no padded copy is made;
//   - blockIdx.z walks a batch with its own strides, so phase 1 reads the
//     [B, H, W] map in place with no transposed copy.
// Exactness: the inputs are integer-valued fp32 below 2^24 (squared pixel
// distances) or the 1e12 "no feature" sentinel. Every a+b rounds the same
// way whatever the order, and min is exact and order-free, so the result
// is bit-identical to the plain version (ops/kernels/minplus.py) and to
// the TPU kernel.
// Left for a later PR: Hopper's DPX instruction __viaddmin_s32 fuses the
// add and the min on int32 (exact below 2^24 once the 1e12 sentinel is
// clamped to an int32 INF), which halves the instruction count; and the
// (i-k)^2 operand of either phase could be generated in registers instead
// of loaded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTm = 64;                // output rows per block
constexpr int kTn = 64;                // output columns per block
constexpr int kTk = 32;                // K chunk staged in shared memory
constexpr int kR = 4;                  // register block per thread: kR x kR
constexpr int kThreads = (kTm / kR) * (kTn / kR);   // 256
constexpr int kPadM = kTm + 4;         // k-major a tile row, float4-aligned

__global__ void __launch_bounds__(kThreads)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int K, int N, long long sa,
               long long sb) {
  __shared__ __align__(16) float a_s[kTk][kPadM];   // a_s[k][m]
  __shared__ __align__(16) float b_s[kTk][kTn];     // b_s[k][n]

  const long long z = blockIdx.z;
  a += z * sa;
  b += z * sb;
  out += z * (long long)M * N;
  const int m0 = blockIdx.y * kTm, n0 = blockIdx.x * kTn;
  const int tx = threadIdx.x % (kTn / kR), ty = threadIdx.x / (kTn / kR);

  float acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = INFINITY;

  for (int k0 = 0; k0 < K; k0 += kTk) {
    // a tile [kTm rows][kTk k]: consecutive threads read consecutive k
    for (int idx = threadIdx.x; idx < kTm * kTk; idx += kThreads) {
      const int r = idx / kTk, c = idx % kTk;
      const int m = m0 + r, k = k0 + c;
      a_s[c][r] = (m < M && k < K) ? a[(long long)m * K + k] : INFINITY;
    }
    // b tile [kTk k][kTn cols]: consecutive threads read consecutive n
    for (int idx = threadIdx.x; idx < kTk * kTn; idx += kThreads) {
      const int r = idx / kTn, c = idx % kTn;
      const int k = k0 + r, n = n0 + c;
      b_s[r][c] = (k < K && n < N) ? b[(long long)k * N + n] : INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * kR]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * kR]);
      const float ra[kR] = {av.x, av.y, av.z, av.w};
      const float rb[kR] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = fminf(acc[i][j], ra[i] + rb[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int m = m0 + ty * kR + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int n = n0 + tx * kR + j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int pemp_minplus_tile() { return kTm; }

const char* pemp_minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [batch, M, N] f32 = min-plus of a [batch, M, K] (batch stride sa
// elements, 0 = shared) and b [batch, K, N] (batch stride sb), all
// contiguous f32. Launches on `stream`; returns cudaGetLastError().
int pemp_minplus(const void* a, const void* b, void* out, int batch, int M, int K,
                 int N, long long sa, long long sb, void* stream) {
  const dim3 grid((N + kTn - 1) / kTn, (M + kTm - 1) / kTm, batch);
  minplus_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      M, K, N, sa, sb);
  return cudaGetLastError();
}

}  // extern "C"
