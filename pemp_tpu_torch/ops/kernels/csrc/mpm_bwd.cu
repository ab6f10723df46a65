// The backward of the meta-prototype chain (K4) for Hopper (sm_90a): the
// cotangents of the packed features, the masks and the centers from the
// logit cotangent, in one launch.
//
// Replaces the custom VJPs of pemp_tpu/ops/pallas/mpm_vjp.py: _packed_bwd
// (:216), the composition of _match_bwd (:146) and _assign_bwd (:63).
//
// What bounds it: device memory. Each feature row is read once and its
// cotangent written once (~43.7 MB at the train shapes B=4, n=2601,
// c=512, p=3, bf16: 13 us at 3.35 TB/s); a query row costs ~12 fp32 FMAs
// a channel, a support row ~8p+1. The first hand-written version (two
// kernels: match_bwd on the query rows, then assign_bwd on the support
// rows, each episode's and image's partials summed by one last block)
// took 0.117 ms there, near 0.13 ms at every B from 1 to 8
// (kernel_times.py, H100 at 700 W): the rows' cost grew with B while the
// serial finishes shrank (fewer partials an episode), and neither rows nor
// finishes came near the bound.
//
// This version is one persistent launch: every block the card holds at
// once (one an SM), launched cooperatively so that all are resident, in
// four phases between three grid-wide barriers, each phase spread over
// the whole grid:
//   A. query rows (items: query image x row tile x column pass, a block
//      taking items blockIdx.x, + gridDim.x, ...): per group of 4 rows,
//      |q|^2 and the dots with each row's two argmax prototypes (the
//      forward's indices) in one butterfly, the _safe_norm gates as
//      _match_bwd states them; then row by row g_q written into
//      g_fts[:, S:] and g_p [2p][c] accumulated in registers on the two
//      argmax rows only (warp-uniform branches), g_pn [2p] per warp. The
//      item's partial in a fixed warp tree. Then the block asks for the
//      rows of its first support item (the ring fills across the
//      barriers) and copies the centers.
//   B. the episodes' finish, 8 lanes a float4 of g_packed [B][2p][c]: the
//      lanes sum the tile partials strided (every load of the element
//      asked for before any sum), a fixed butterfly adds the lanes,
//      g_packed = sum + (p_live ? g_pn / pn : 0) p; for each shot, from
//      K1's per-cluster partials of the forward (num = a^T f, den = sum a),
//      g_num = g_packed / S / den_s and the float4's share of g_den's sum
//      over c.
//   C. support rows (items as in A): per group of R rows, the dots with
//      g_num in one butterfly that leaves lane r*2p + k holding row r's
//      f.g_num_k; the row's class softmax is the one K1 computed in the
//      forward (sm, read with the row's masks), so g_a, g_mask, the
//      softmax backward and g_dist run on those lanes without recomputing
//      |f|^2, f.ctr_k or the softmax; g_f = sum_k a_k g_num_k - 2 f g_row +
//      sum_k 2 g_dist_k ctr_k written into g_fts[:, :S] (g_fg, g_bg when
//      asked); f (x) 2 g_dist and sum g_dist into the item's partial.
//   D. g_ctr [c][2p]: a warp a float4 sums every item's partial.
// The rows stream through a cp.async ring of 32-row stages (ns = 0: read
// from device memory where no ring fits); the tables sit in shared memory
// permuted for lanes on fixed columns (mpm_common.cuh). Above a pass's
// channels (512; 256 for the instances P = 12 and 16) each column pass
// recomputes the rows' dot products and writes and accumulates its own
// columns. No atomics touch a sum and every sum has a fixed order: the
// cotangents are bit-identical run to run. The barrier's two counters are
// left at zero by the last block out.
//
// What a timing of each phase's end taught (an instrumented build,
// PERF.md): code run once a launch is slow here, so the loops over a
// row's chunks, a group's rows and the warp tree's rounds stay rolled
// where no register array depends on them, the table copies step their
// indices without a division, and each phase is a function of its own
// (__noinline__) so that the register allocator sees one phase at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mpm_common.cuh"

namespace {

using namespace pemp;

template <typename T>
struct BwdArgs {
  const T* fts;            // [B, S+Q, n, c]
  const float* packed;     // [B, 2P, c] the forward's prototypes (fg, then bg)
  const int* inds;         // [B*Q, n, 2] the forward's argmax over p ([bg, fg])
  const float* g;          // [B*Q, n, 2] logit cotangent ([bg, fg])
  const float* num_part;   // [B*S, fparts, 2P, c] K1's cluster partials
  const float* den_part;   // [B*S, fparts, 2P]
  const float* fg;         // [B*S, n] masks
  const float* bg;
  const float* ctr;        // [c, 2P]
  const float* sm;         // [B*S, n, 2P] K1's class softmax of each support row
  T* g_fts;                // [B, S+Q, n, c]
  float* g_fg;             // [B*S, n] or null
  float* g_bg;
  float* g_ctr;            // [c, 2P]
  float* gp_part;          // [B*Q*tiles_q, 2P, c] scratch
  float* gpn_part;         // [B*Q*tiles_q, 2P]
  float* pnsq;             // [B, 2P]
  float* g_num;            // [B*S, 2P, c]
  float* gden_part;        // [B*S, 2P, c/4]
  float* den_s;            // [B*S, 2P]
  float* gc_part;          // [B*S*tiles_s, 2P, c]
  float* gd_part;          // [B*S*tiles_s, 2P]
  unsigned* sync;          // [2] barrier and exit counters, zero before and after
  int B, S, Q, n, c, fparts, tiles_q, rows_q, tiles_s, rows_s, ns;
  float dist_scalar, cos_eps, eps;
};

template <int P>
struct BwdShape {
  static constexpr int K2 = 2 * P;
  static constexpr int W = K2;                   // lanes a support row: its g_num dots
  static constexpr int R = 4 * W <= 32 ? 4 : 2 * W <= 32 ? 2 : 1;   // support rows a group
  static constexpr int RS = (K2 + 2 + 3) / 4 * 4;  // a row's scalars: masks, softmax
  static constexpr int RH = R < 2 ? R : 2;       // rows of a group whose g_f is formed at once
  static constexpr int WQ = 3;                   // lanes a query row: |q|^2, q.p_bg, q.p_fg
  static constexpr int RQ = kRowsPerWarp;        // query rows a group (a warp's of a stage)
  static constexpr int COLS = pass_cols(P);      // channels a column pass
};

// dynamic shared memory: the tables (packed in A; the centers and g_num
// in C), the per-row scalar ring (RS floats a row), the row ring; each
// item's warp tree reuses all of it
constexpr size_t bwd_smem(int c, int p, int esize, int ns) {
  const int k2 = 2 * p, slots = ns > kMinStages ? ns : kMinStages;
  const int rs = (k2 + 2 + 3) / 4 * 4;
  const size_t loop = (size_t)2 * k2 * c * 4 + (size_t)slots * kStageRows * rs * 4 +
                      (size_t)ns * kStageRows * c * esize;
  const size_t tree = (size_t)kWarps / 2 * k2 * (c < pass_cols(p) ? c : pass_cols(p)) * 4;
  return loop > tree ? loop : tree;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier over resident blocks: the k-th barrier of a launch
// waits for count >= k * gridDim.x. Every block's writes before it are
// seen by every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (ld_acquire(count) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// sum over the G lanes of a group (lanes l with the same l / G) by a
// fixed butterfly: every lane of the group ends with the total
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int G>
__device__ __forceinline__ float4 group_sum4(float4 v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, off);
    v.y += __shfl_xor_sync(kFull, v.y, off);
    v.z += __shfl_xor_sync(kFull, v.z, off);
    v.w += __shfl_xor_sync(kFull, v.w, off);
  }
  return v;
}

// A lane's share of the sum of `count` partials (float4 `idx` of
// part[u * stride]) when G lanes share it: u = sub, sub + G, ... added in
// order, kBatch loads in flight; group_sum4 / group_sum of the shares
// give the group the total in a fixed order. Read through L2: other
// blocks wrote them in this launch. `live` false: zero, nothing read.
constexpr int kBatch = 8;

template <int G>
__device__ __forceinline__ float4 lane_parts4(const float* part, size_t stride, int count,
                                              int idx, int sub, bool live = true) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int u0 = sub; u0 < count; u0 += G * kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int u = u0 + G * m;
      x[m] = live && u < count
                 ? __ldcg(reinterpret_cast<const float4*>(part + u * stride) + idx)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      s.x += x[m].x; s.y += x[m].y; s.z += x[m].z; s.w += x[m].w;
    }
  }
  return s;
}

template <int G>
__device__ __forceinline__ float lane_parts1(const float* part, size_t stride, int count,
                                             int sub, bool live = true) {
  float s = 0.f;
  for (int u0 = sub; u0 < count; u0 += G * kBatch) {
    float x[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int u = u0 + G * m;
      x[m] = live && u < count ? __ldcg(part + u * stride) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m) s += x[m];
  }
  return s;
}

// Copy a k-major [nt][c] fp32 table (n4 float4) into rows k0.. of the
// permuted table `tab` (mpm_common.cuh) in two steps, so that other loads
// can be asked for between them: table_rows_load asks for the thread's
// first kBatch float4 (`L2`: through L2 only, for a table written in this
// launch), table_rows_store stores them and copies the rest.
constexpr int kTab = 4;                         // a thread's table float4 asked for at once

template <bool L2>
__device__ __forceinline__ void table_rows_load(float4 (&x)[kTab], const float* src, int n4) {
  const float4* from = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int m = 0; m < kTab; ++m) {
    const int idx = threadIdx.x + m * kThreads;
    if (idx < n4) x[m] = L2 ? __ldcg(from + idx) : __ldg(from + idx);
  }
}

template <int V, bool L2>
__device__ __forceinline__ void table_rows_store(float* tab, int k0, const float4 (&x)[kTab],
                                                 const float* src, int nt, int c) {
  const int c4 = c / 4, n4 = nt * c4;
  const float4* from = reinterpret_cast<const float4*>(src);
  // float4 idx = threadIdx.x + m * kThreads is (row k, column 4 col4),
  // stepped without a division each
  const int dk = kThreads / c4, dc = kThreads % c4;
  int k = threadIdx.x / c4, col4 = threadIdx.x % c4;
  for (int idx = threadIdx.x, m = 0; idx < n4; idx += kThreads, ++m) {
    float4 y;
    if (m < kTab) {
#pragma unroll
      for (int u = 0; u < kTab; ++u)
        if (u == m) y = x[u];
    } else {
      y = L2 ? __ldcg(from + idx) : __ldg(from + idx);
    }
    *reinterpret_cast<float4*>(tab + tab_off<V>(k0 + k, col4 * 4, c)) = y;
    col4 += dc;
    k += dk;
    if (col4 >= c4) {
      col4 -= c4;
      ++k;
    }
  }
}

// Copy the centers, a column-major [c][nt] fp32 table (16-byte aligned),
// into rows k0.. of `tab` in the same two steps: float4 loads of 4
// consecutive (column, k) entries, stored one float each.
__device__ __forceinline__ void table_cols_load(float4 (&x)[kTab], const float* src, int n4) {
  table_rows_load<false>(x, src, n4);
}

template <int V>
__device__ __forceinline__ void table_col4_store(float* tab, int k0, float4 y, int idx, int nt,
                                                 int c) {
  const float v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int flat = 4 * idx + e;
    tab[tab_off<V>(k0 + flat % nt, flat / nt, c)] = v[e];
  }
}

template <int V>
__device__ __forceinline__ void table_cols_store(float* tab, int k0, const float4 (&x)[kTab],
                                                 const float* src, int nt, int c) {
  const int n4 = c * nt / 4;
#pragma unroll
  for (int m = 0; m < kTab; ++m) {
    const int idx = threadIdx.x + m * kThreads;
    if (idx < n4) table_col4_store<V>(tab, k0, x[m], idx, nt, c);
  }
  for (int idx = threadIdx.x + kTab * kThreads; idx < n4; idx += kThreads)
    table_col4_store<V>(tab, k0, __ldg(reinterpret_cast<const float4*>(src) + idx), idx, nt, c);
}

// group_sums (mpm_common.cuh) with the chunk loop rolled: the backward's
// loops must stay small enough for the instruction cache
template <typename T, int NT, int R, int W, bool SQ>
__device__ __forceinline__ void group_dots(const T* tile, int g, int live, const float* tab,
                                           int c, int lane, float (&v)[32], float (&sq)[R]) {
  static_assert(R * W <= 32 && W >= NT + (SQ ? 1 : 0), "sums do not fit the warp");
  constexpr int V = Vec<T>::N;
  const int cv = c / V;
#pragma unroll 1
  for (int q = lane; q < cv; q += 32) {
    float x[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (g + r < live) {
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V), x[r]);
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

// block_tree (mpm_common.cuh) with its rounds rolled, for the same reason
template <int K, int NCH, int V>
__device__ __forceinline__ void tree_sum(float (&acc)[K][NCH * V], float* slots, int qz, int cv,
                                         int pc, int warp, int lane) {
#pragma unroll 1
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

// stage st of `nrows` rows from `src`: the rows into ring slot st % ns
// (zero-filled past nrows), each row's scalars into slot st % slots (RS
// floats a row): a query row's argmax pair and cotangent pair (s0, s1:
// 2 words a row each), or a support row's fg and bg masks (s0, s1) and
// its 2p softmax values (sm); one commit group
template <typename T, int P>
__device__ __forceinline__ void issue_stage(int st, int stages, int nrows, const T* src,
                                            const void* s0, const void* s1, const float* sm,
                                            T* ring, float* row_f, int c, int ns, int slots) {
  constexpr int K2 = BwdShape<P>::K2, RS = BwdShape<P>::RS, V = Vec<T>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cv = c / V;
  if (st < stages) {
    const int r0 = st * kStageRows;
    if (ns > 0) {
      T* dst = ring + (size_t)(st % ns) * kStageRows * c;
      for (int r = warp; r < kStageRows; r += kWarps) {
        const bool live = r0 + r < nrows;
        for (int q = lane; q < cv; q += 32)
          cp_async16(dst + (size_t)r * c + q * V,
                     live ? src + (size_t)(r0 + r) * c + q * V : src, live ? 16 : 0);
      }
    }
    const int words = sm == nullptr ? 4 : K2 + 2;
    for (int w = threadIdx.x; w < kStageRows * words; w += kThreads) {
      const int r = w / words, e = w % words;   // word e of row r of the stage
      const bool live = r0 + r < nrows;
      const int rr = live ? r0 + r : 0;
      const void* from = sm == nullptr ? static_cast<const int*>(e < 2 ? s0 : s1) + 2 * rr + e % 2
                         : e < 2 ? static_cast<const void*>(static_cast<const float*>(e ? s1 : s0) + rr)
                                 : static_cast<const void*>(sm + (size_t)rr * K2 + e - 2);
      cp_async4(row_f + ((st % slots) * kStageRows + r) * RS + e, from, live ? 4 : 0);
    }
  }
  cp_async_commit();
}

// Support item `item` (image x row tile x column pass, pass fastest): its
// rows, masks and forward softmax rows
template <typename T>
struct SupItem {
  int z, part, i, t, b, row0, nrows, stages;
  const T* src;
  const float* mfg;
  const float* mbg;
  const float* sm;
};

template <typename T, int P>
__device__ __forceinline__ SupItem<T> support_item(const BwdArgs<T>& a, int item, int passes) {
  constexpr int K2 = BwdShape<P>::K2;
  const int n = a.n, c = a.c;
  SupItem<T> s;
  s.z = item % passes;
  s.part = item / passes;
  s.i = s.part / a.tiles_s;
  s.t = s.part % a.tiles_s;
  s.b = s.i / a.S;
  const int img = s.b * (a.S + a.Q) + s.i % a.S;
  s.row0 = s.t * a.rows_s;
  s.nrows = min(a.rows_s, n - s.row0);
  s.stages = (s.nrows + kStageRows - 1) / kStageRows;
  s.src = a.fts + ((size_t)img * n + s.row0) * c;
  s.mfg = a.fg + (size_t)s.i * n + s.row0;
  s.mbg = a.bg + (size_t)s.i * n + s.row0;
  s.sm = a.sm + ((size_t)s.i * n + s.row0) * K2;
  return s;
}

// Each phase is a function of its own (not inlined), so that the register
// allocator sees one phase's values at a time: the query and support
// loops each need most of a thread's 255 registers. The kernel copies its
// arguments into shared memory and hands each phase a reference to them.
#define PEMP_BWD_PHASE template <typename T, int P> __device__ __noinline__ void

PEMP_BWD_PHASE bwd_queries(const BwdArgs<T>& a) {
  using Shape = BwdShape<P>;
  constexpr int K2 = Shape::K2, COLS = Shape::COLS;
  constexpr int WQ = Shape::WQ, RQ = Shape::RQ, RS = Shape::RS;
  constexpr int V = Vec<T>::N, NCH = COLS / (32 * V);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = a.c, n = a.n, cv = c / V, ns = a.ns;
  const int slots = ns > kMinStages ? ns : kMinStages;
  float* tab_s = reinterpret_cast<float*>(smem_raw);                 // [2*K2][c] permuted
  float* row_f = tab_s + 2 * K2 * c;                                 // [slots][kStageRows][RS]
  T* ring = reinterpret_cast<T*>(row_f + slots * kStageRows * RS);   // [ns][kStageRows][c]
  float* tree_s = reinterpret_cast<float*>(smem_raw);                // after an item's rows

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  const int passes = (c + COLS - 1) / COLS, pc = min(c, COLS);
  const int items_q = a.B * a.Q * a.tiles_q * passes;
  const int items_s = a.B * a.S * a.tiles_s * passes;
  const int c4 = c / 4;

  auto issue = [&](int st, int stages, int nrows, const T* src, const void* s0, const void* s1,
                   const float* sm) {
    issue_stage<T, P>(st, stages, nrows, src, s0, s1, sm, ring, row_f, c, ns, slots);
  };

  __shared__ float nsq_s[K2], gpn_w[kWarps][K2];
  // ---------------------------------------------------------------- A
  for (int item = blockIdx.x; item < items_q; item += G) {
    const int z = item % passes, part = item / passes;    // part = iq * tiles_q + t
    const int iq = part / a.tiles_q, t = part % a.tiles_q;
    const int b = iq / a.Q;
    const int img = b * (a.S + a.Q) + a.S + iq % a.Q;     // packed query image
    const int row0 = t * a.rows_q, nrows = min(a.rows_q, n - row0);
    const int stages = (nrows + kStageRows - 1) / kStageRows;
    const int qz = z * 32 * NCH;                          // first chunk of the pass
    const T* src = a.fts + ((size_t)img * n + row0) * c;
    T* dst = a.g_fts + ((size_t)img * n + row0) * c;
    const int* src_ind = a.inds + ((size_t)iq * n + row0) * 2;
    const float* src_g = a.g + ((size_t)iq * n + row0) * 2;
    // the table's (L2-resident) lines first, so they do not queue behind
    // the ring's first stages
    float4 tv[kTab];
    table_rows_load<false>(tv, a.packed + (size_t)b * K2 * c, K2 * c4);
    for (int st = 0; st < slots - 1; ++st) issue(st, stages, nrows, src, src_ind, src_g, nullptr);
    table_rows_store<V, false>(tab_s, 0, tv, a.packed + (size_t)b * K2 * c, K2, c);
    for (int k = lane; k < K2; k += 32) gpn_w[warp][k] = 0.f;
    __syncthreads();
    table_norms_sq(tab_s, nsq_s, c, K2);
    __syncthreads();
    if (t == 0 && z == 0 && iq % a.Q == 0 && threadIdx.x < K2)
      a.pnsq[b * K2 + threadIdx.x] = nsq_s[threadIdx.x];

    float acc[K2][NCH * V];                     // g_p on the lane's columns of the pass
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int j = 0; j < NCH * V; ++j) acc[k][j] = 0.f;

    for (int st = 0; st < stages; ++st) {
      issue(st + slots - 1, stages, nrows, src, src_ind, src_g, nullptr);
      wait_ring(slots);
      __syncthreads();
      const T* tile = ns > 0 ? ring + (size_t)(st % ns) * kStageRows * c
                             : src + (size_t)st * kStageRows * c;
      const float* rs = row_f + (st % slots) * kStageRows * RS;    // the rows' scalars
      const int live_rows = min(kStageRows, nrows - st * kStageRows);
      const int g = warp * kRowsPerWarp;           // the warp's rows: g .. g+RQ-1
      if (g < live_rows) {                                          // warp-uniform
        int kb[RQ], kf[RQ];                       // table rows of the argmax: bg, fg
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float4 sc = *reinterpret_cast<const float4*>(rs + (g + r) * RS);
          kb[r] = P + __float_as_int(sc.x);
          kf[r] = __float_as_int(sc.y);
        }
        // |q|^2 and the dots with the two argmax rows of RQ rows, summed
        // over the warp in one butterfly: lane r*WQ + w holds sum w of row r
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = 0.f;
#pragma unroll 1
        for (int q = lane; q < cv; q += 32) {                    // the row's chunks
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
            float x[V];
            if (g + r < live_rows) {
              Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V),
                             x);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) x[e] = 0.f;
            }
#pragma unroll
            for (int h = 0; h < V / 4; ++h) {
              const float4 wb = tab4<V>(tab_s, kb[r], h, q, c);
              const float4 wf = tab4<V>(tab_s, kf[r], h, q, c);
              const float* xh = x + 4 * h;
              float& s0 = v[r * WQ];
              float& s1 = v[r * WQ + 1];
              float& s2 = v[r * WQ + 2];
              s0 = fmaf(xh[0], xh[0], fmaf(xh[1], xh[1], fmaf(xh[2], xh[2], fmaf(xh[3], xh[3], s0))));
              s1 = fmaf(xh[0], wb.x, fmaf(xh[1], wb.y, fmaf(xh[2], wb.z, fmaf(xh[3], wb.w, s1))));
              s2 = fmaf(xh[0], wf.x, fmaf(xh[1], wf.y, fmaf(xh[2], wf.z, fmaf(xh[3], wf.w, s2))));
            }
          }
        }
        reduce_scatter<16>(v, lane);
        // the _safe_norm gates of _match_bwd on the lanes r*3+1 (bg) and
        // r*3+2 (fg): one class of row r each
        const int my_r = min(lane / WQ, RQ - 1), my_w = lane % WQ;
        const float dot = v[0];
        const float sq = __shfl_sync(kFull, dot, my_r * WQ);
        const float qn = sqrtf(fmaxf(sq, 1e-30f));
        const float4 sc = *reinterpret_cast<const float4*>(rs + (g + my_r) * RS);
        const bool fg_lane = my_w == 2;
        const int kc = fg_lane ? __float_as_int(sc.y) : P + __float_as_int(sc.x);
        const float pn = sqrtf(fmaxf(nsq_s[kc], 1e-30f));
        const bool live = lane < RQ * WQ && my_w > 0 && g + my_r < live_rows;
        const float gc = live ? (fg_lane ? sc.w : sc.z) * a.dist_scalar : 0.f;
        const float d_raw = qn * pn;
        const float d_cl = fmaxf(d_raw, a.cos_eps);
        const float gdot = gc / d_cl;
        const float gdv = d_raw >= a.cos_eps ? -gc * dot / (d_cl * d_cl) : 0.f;
        // the row's coefficient of q (on the bg lane): both classes' g_qn / qn
        const float cq = sq >= 1e-30f ? gdv * pn / qn : 0.f;
        const float coef = cq + __shfl_down_sync(kFull, cq, 1);
        const float gpn_c = gdv * qn;
        // then one row at a time (a rolled loop: the code stays small
        // enough for the instruction cache): g_q on the lane's columns of
        // the pass, and g_p += g_dot q on the row's two argmax prototypes
        // (warp-uniform branches)
#pragma unroll 1
        for (int r = 0; r < RQ; ++r) {
          const float gdb = __shfl_sync(kFull, gdot, r * WQ + 1);
          const float gdf = __shfl_sync(kFull, gdot, r * WQ + 2);
          const float cf = __shfl_sync(kFull, coef, r * WQ + 1);
          const float pb = __shfl_sync(kFull, gpn_c, r * WQ + 1);
          const float pf = __shfl_sync(kFull, gpn_c, r * WQ + 2);
          if (g + r >= live_rows) break;                            // warp-uniform
          const float4 scr = *reinterpret_cast<const float4*>(rs + (g + r) * RS);
          const int kbr = P + __float_as_int(scr.x), kfr = __float_as_int(scr.y);
          if (lane == 0) {
            gpn_w[warp][kbr] += pb;
            gpn_w[warp][kfr] += pf;
          }
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            const int q = qz + lane + 32 * j;
            if (q < cv) {
              float x[V], gq[V];
              Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V),
                             x);
#pragma unroll
              for (int h = 0; h < V / 4; ++h) {
                const float4 wb = tab4<V>(tab_s, kbr, h, q, c);
                const float4 wf = tab4<V>(tab_s, kfr, h, q, c);
                const float b4[4] = {wb.x, wb.y, wb.z, wb.w}, f4[4] = {wf.x, wf.y, wf.z, wf.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  gq[4 * h + e] = fmaf(gdb, b4[e], fmaf(gdf, f4[e], cf * x[4 * h + e]));
              }
              *reinterpret_cast<uint4*>(dst + (size_t)(st * kStageRows + g + r) * c + q * V) =
                  Vec<T>::pack(gq);
#pragma unroll
              for (int k = 0; k < K2; ++k) {
                if (k == kbr || k == kfr) {
                  const float w = k == kfr ? gdf : gdb;
#pragma unroll
                  for (int e = 0; e < V; ++e)
                    acc[k][j * V + e] = fmaf(w, x[e], acc[k][j * V + e]);
                }
              }
            }
          }
        }
      }
      __syncthreads();                     // slots st % ns and st % slots are refilled next
    }
    cp_async_wait<0>();
    __syncthreads();
    tree_sum<K2, NCH, V>(acc, tree_s, qz, cv, pc, warp, lane);
    if (warp == 0) store_cols<K2, NCH, V>(acc, a.gp_part + (size_t)part * K2 * c, c, qz, cv, lane);
    if (z == 0 && threadIdx.x < K2) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += gpn_w[w][threadIdx.x];
      a.gpn_part[(size_t)part * K2 + threadIdx.x] = s;
    }
    __syncthreads();                       // the tree's memory and gpn_w are free
  }

  // the block's first support item's rows are asked for now: they land
  // while the grid waits at the barriers (cp.async groups are the
  // thread's, bwd_supports waits for them); the centers' table too
  float4 cv4[kTab];
  table_cols_load(cv4, a.ctr, c * K2 / 4);
  if (blockIdx.x < items_s) {
    const SupItem<T> s = support_item<T, P>(a, blockIdx.x, passes);
    for (int st = 0; st < slots - 1; ++st)
      issue(st, s.stages, s.nrows, s.src, s.mfg, s.mbg, s.sm);
  }
  table_cols_store<V>(tab_s, 0, cv4, a.ctr, K2, c);
}

PEMP_BWD_PHASE bwd_episodes(const BwdArgs<T>& a) {
  constexpr int K2 = BwdShape<P>::K2;
  const int c = a.c, c4 = c / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  constexpr int kGroup = 8;                     // lanes a float4 in B
  const int sub = lane % kGroup;
  const int gw = (blockIdx.x * kWarps + warp) * (32 / kGroup);      // the warp's first
  const int nw = G * kWarps * (32 / kGroup);
  // ---------------------------------------------------------------- B
  // 8 lanes a float4 of g_packed, 4 a warp: every load of an element is
  // asked for before its sums, and one pass covers the train shapes
  {
    const int parts = a.Q * a.tiles_q;                    // an episode's, in (q, t) order
    const float inv_s = 1.f / (float)a.S;
    const int elems = a.B * K2 * c4;
    for (int e0 = gw; e0 < elems; e0 += nw) {                       // warp-uniform
      const int e = e0 + lane / kGroup;
      const bool live = e < elems;
      const int b = live ? e / (K2 * c4) : 0, idx = live ? e % (K2 * c4) : 0, k = idx / c4;
      const size_t p0 = (size_t)b * parts, i0 = (size_t)b * a.S;
      const float4 gpl = lane_parts4<kGroup>(a.gp_part + p0 * K2 * c, (size_t)K2 * c, parts,
                                             idx, sub, live);
      const float gnl = lane_parts1<kGroup>(a.gpn_part + p0 * K2 + k, K2, parts, sub, live);
      const float dl0 = lane_parts1<kGroup>(a.den_part + i0 * a.fparts * K2 + k, K2, a.fparts,
                                            sub, live);
      const float4 nl0 = lane_parts4<kGroup>(a.num_part + i0 * a.fparts * K2 * c,
                                             (size_t)K2 * c, a.fparts, idx, sub, live);
      const float nsq = live ? __ldcg(a.pnsq + b * K2 + k) : 0.f;
      const float4 pv = live ? __ldg(reinterpret_cast<const float4*>(a.packed + (size_t)b * K2 * c) +
                                     idx)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 gp = group_sum4<kGroup>(gpl);
      const float gpn = group_sum<kGroup>(gnl);
      const float f = nsq >= 1e-30f ? gpn / sqrtf(nsq) : 0.f;    // p_live ? g_pn / pn
      const float4 gk = make_float4(fmaf(f, pv.x, gp.x), fmaf(f, pv.y, gp.y),
                                    fmaf(f, pv.z, gp.z), fmaf(f, pv.w, gp.w));
      const float4 gq = make_float4(gk.x * inv_s, gk.y * inv_s, gk.z * inv_s, gk.w * inv_s);
      for (int s = 0; s < a.S; ++s) {
        const size_t i = i0 + s;
        float dl = dl0;
        float4 nl = nl0;
        if (s > 0) {
          dl = lane_parts1<kGroup>(a.den_part + i * a.fparts * K2 + k, K2, a.fparts, sub, live);
          nl = lane_parts4<kGroup>(a.num_part + i * a.fparts * K2 * c, (size_t)K2 * c, a.fparts,
                                   idx, sub, live);
        }
        const float d = group_sum<kGroup>(dl) + a.eps;
        const float4 nm = group_sum4<kGroup>(nl);
        if (live && sub == 0) {
          reinterpret_cast<float4*>(a.g_num + i * K2 * c)[idx] =
              make_float4(gq.x / d, gq.y / d, gq.z / d, gq.w / d);
          a.gden_part[i * K2 * c4 + idx] = gq.x * nm.x + gq.y * nm.y + gq.z * nm.z + gq.w * nm.w;
          if (idx % c4 == 0) a.den_s[i * K2 + k] = d;
        }
      }
    }
  }
}

PEMP_BWD_PHASE bwd_supports(const BwdArgs<T>& a) {
  using Shape = BwdShape<P>;
  constexpr int K2 = Shape::K2, W = Shape::W, R = Shape::R, RH = Shape::RH, COLS = Shape::COLS;
  constexpr int RS = Shape::RS;
  constexpr int V = Vec<T>::N, NCH = COLS / (32 * V);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = a.c, n = a.n, cv = c / V, ns = a.ns;
  const int slots = ns > kMinStages ? ns : kMinStages;
  float* tab_s = reinterpret_cast<float*>(smem_raw);                 // [2*K2][c] permuted
  float* row_f = tab_s + 2 * K2 * c;                                 // [slots][kStageRows][RS]
  T* ring = reinterpret_cast<T*>(row_f + slots * kStageRows * RS);   // [ns][kStageRows][c]
  float* tree_s = reinterpret_cast<float*>(smem_raw);                // after an item's rows

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  const int passes = (c + COLS - 1) / COLS, pc = min(c, COLS);
  const int items_s = a.B * a.S * a.tiles_s * passes;
  const int c4 = c / 4;

  auto issue = [&](int st, int stages, int nrows, const T* src, const void* s0, const void* s1,
                   const float* sm) {
    issue_stage<T, P>(st, stages, nrows, src, s0, s1, sm, ring, row_f, c, ns, slots);
  };

  __shared__ float gden_s[K2], gd_w[kWarps][32];
  // ---------------------------------------------------------------- C
  for (int item = blockIdx.x; item < items_s; item += G) {
    const SupItem<T> s = support_item<T, P>(a, item, passes);
    const int qz = s.z * 32 * NCH;
    T* dst = a.g_fts + (s.src - a.fts);
    float4 tv[kTab], cv4[kTab];
    table_rows_load<true>(tv, a.g_num + (size_t)s.i * K2 * c, K2 * c4);
    if (item != blockIdx.x) {
      table_cols_load(cv4, a.ctr, c * K2 / 4);
      for (int st = 0; st < slots - 1; ++st)
        issue(st, s.stages, s.nrows, s.src, s.mfg, s.mbg, s.sm);
      table_cols_store<V>(tab_s, 0, cv4, a.ctr, K2, c);
    }
    table_rows_store<V, true>(tab_s, K2, tv, a.g_num + (size_t)s.i * K2 * c, K2, c);
    // g_den of the image: each k's float4 shares summed in a fixed order
    for (int k = warp; k < K2; k += kWarps) {
      const float sum = warp_sum(lane_parts1<32>(a.gden_part + ((size_t)s.i * K2 + k) * c4, 1,
                                                 c4, lane));
      const float d = __ldcg(a.den_s + (size_t)s.i * K2 + k);
      if (lane == 0) gden_s[k] = -sum / (d * d);
    }
    __syncthreads();

    float acc[K2][NCH * V];                     // f (x) 2 g_dist on the lane's columns
#pragma unroll
    for (int k = 0; k < K2; ++k)
#pragma unroll
      for (int j = 0; j < NCH * V; ++j) acc[k][j] = 0.f;
    float gd_acc = 0.f;                         // sum g_dist of the lane's (row, k)
    const int my_r = lane / W, kk = lane % W;   // the lane's row of a group, and column
    const int cls = kk / P;                     // 0: fg columns, 1: bg
    const int rb = my_r * W, cbase = rb + cls * P;

    for (int st = 0; st < s.stages; ++st) {
      issue(st + slots - 1, s.stages, s.nrows, s.src, s.mfg, s.mbg, s.sm);
      wait_ring(slots);
      __syncthreads();
      const T* tile = ns > 0 ? ring + (size_t)(st % ns) * kStageRows * c
                             : s.src + (size_t)st * kStageRows * c;
      const float* rs = row_f + (st % slots) * kStageRows * RS;    // the rows' scalars
      const int live_rows = min(kStageRows, s.nrows - st * kStageRows);
#pragma unroll
      for (int gi = 0; gi < kRowsPerWarp / R; ++gi) {
        const int g = warp * kRowsPerWarp + gi * R;
        if (g >= live_rows) break;                               // warp-uniform
        // the dots with g_num in one pass over the rows and one butterfly:
        // lane r*W + k ends with row r's f.g_num_k; the row's class softmax
        // (the forward's, K1) and masks come with its scalars
        float v[32], sqr[R];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = 0.f;
        group_dots<T, K2, R, W, false>(tile, g, live_rows, tab_s + K2 * c, c, lane, v, sqr);
        reduce_scatter<16>(v, lane);
        const float fgn = v[0];
        const int row = g + my_r;
        const bool live = my_r < R && row < live_rows;
        const float* rsr = rs + min(row, kStageRows - 1) * RS;
        const float sm = rsr[2 + kk];
        const float mask = rsr[cls];
        const float ga = fgn + gden_s[kk];
        float gmask = 0.f, tc = 0.f;
#pragma unroll
        for (int j = 0; j < P; ++j) gmask += __shfl_sync(kFull, sm * ga, (cbase + j) & 31);
        const float gsm = ga * mask;
#pragma unroll
        for (int j = 0; j < P; ++j) tc += __shfl_sync(kFull, sm * gsm, (cbase + j) & 31);
        const float gd = live ? sm * (gsm - tc) : 0.f;
        const float av = live ? sm * mask : 0.f;
        float grow = 0.f;
#pragma unroll
        for (int k = 0; k < K2; ++k) grow += __shfl_sync(kFull, gd, (rb + k) & 31);
        gd_acc += gd;
        if (s.z == 0 && live && (kk == 0 || kk == P)) {
          float* out = kk == 0 ? a.g_fg : a.g_bg;
          if (out != nullptr) out[(size_t)s.i * n + s.row0 + st * kStageRows + row] = gmask;
        }
        // g_f on the lane's columns of the pass, and f (x) 2 g_dist, RH rows
        // at a time (the registers of R at once would spill)
#pragma unroll 1
        for (int r0 = 0; r0 < R; r0 += RH) {
          float ar[RH][K2], gdr[RH][K2], gr[RH];
#pragma unroll
          for (int r = 0; r < RH; ++r) {
            gr[r] = __shfl_sync(kFull, grow, (r0 + r) * W);
#pragma unroll
            for (int k = 0; k < K2; ++k) {
              ar[r][k] = __shfl_sync(kFull, av, (r0 + r) * W + k);
              gdr[r][k] = 2.f * __shfl_sync(kFull, gd, (r0 + r) * W + k);
            }
          }
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            const int q = qz + lane + 32 * j;
            if (q < cv) {
              float x[RH][V], gf[RH][V];
#pragma unroll
              for (int r = 0; r < RH; ++r) {
                if (g + r0 + r < live_rows) {
                  Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r0 + r) * c +
                                                                 q * V),
                                 x[r]);
                } else {
#pragma unroll
                  for (int e = 0; e < V; ++e) x[r][e] = 0.f;
                }
#pragma unroll
                for (int e = 0; e < V; ++e) gf[r][e] = -2.f * x[r][e] * gr[r];
              }
#pragma unroll
              for (int k = 0; k < K2; ++k) {
#pragma unroll
                for (int h = 0; h < V / 4; ++h) {
                  const float4 wc = tab4<V>(tab_s, k, h, q, c);
                  const float4 wn = tab4<V>(tab_s, K2 + k, h, q, c);
                  const float c4v[4] = {wc.x, wc.y, wc.z, wc.w};
                  const float n4v[4] = {wn.x, wn.y, wn.z, wn.w};
#pragma unroll
                  for (int r = 0; r < RH; ++r)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      float& o = gf[r][4 * h + e];
                      o = fmaf(ar[r][k], n4v[e], fmaf(gdr[r][k], c4v[e], o));
                      acc[k][j * V + 4 * h + e] =
                          fmaf(gdr[r][k], x[r][4 * h + e], acc[k][j * V + 4 * h + e]);
                    }
                }
              }
#pragma unroll
              for (int r = 0; r < RH; ++r)
                if (g + r0 + r < live_rows)
                  *reinterpret_cast<uint4*>(dst + (size_t)(st * kStageRows + g + r0 + r) * c +
                                            q * V) = Vec<T>::pack(gf[r]);
            }
          }
        }
      }
      __syncthreads();                     // slots st % ns and st % slots are refilled next
    }
    cp_async_wait<0>();
    // the item's partial: the warps' sums in a fixed tree; sum g_dist of
    // each k over the lanes that held it, in warp and lane order
    gd_w[warp][lane] = gd_acc;
    __syncthreads();
    tree_sum<K2, NCH, V>(acc, tree_s, qz, cv, pc, warp, lane);
    if (warp == 0)
      store_cols<K2, NCH, V>(acc, a.gc_part + (size_t)s.part * K2 * c, c, qz, cv, lane);
    if (s.z == 0 && threadIdx.x < K2) {
      float d = 0.f;
      for (int w = 0; w < kWarps; ++w)
        for (int l = threadIdx.x; l < R * W; l += W) d += gd_w[w][l];
      a.gd_part[(size_t)s.part * K2 + threadIdx.x] = d;
    }
    __syncthreads();                       // the tree's memory is free
  }
}

PEMP_BWD_PHASE bwd_centers(const BwdArgs<T>& a) {
  constexpr int K2 = BwdShape<P>::K2;
  const int c = a.c, c4 = c / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  // ---------------------------------------------------------------- D
  // a warp a float4 of [2p][c]: every support tile's partial, ~4 a lane
  {
    const int parts = a.B * a.S * a.tiles_s;
    const int elems = K2 * c4;
    for (int e = blockIdx.x * kWarps + warp; e < elems; e += G * kWarps) {
      const int k = e / c4, col = e % c4 * 4;
      const float4 sl = lane_parts4<32>(a.gc_part, (size_t)K2 * c, parts, e, lane);
      const float gl = lane_parts1<32>(a.gd_part + k, K2, parts, lane);
      const float4 sum = group_sum4<32>(sl);
      const float gd = group_sum<32>(gl);
      if (lane < 4) {
        const float sv = lane == 0 ? sum.x : lane == 1 ? sum.y : lane == 2 ? sum.z : sum.w;
        const size_t o = (size_t)(col + lane) * K2 + k;
        a.g_ctr[o] = sv - 2.f * __ldg(a.ctr + o) * gd;
      }
    }
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) mpm_bwd_kernel(const BwdArgs<T> args) {
  __shared__ BwdArgs<T> a;
  if (threadIdx.x == 0) a = args;
  __syncthreads();
  const unsigned G = gridDim.x;
  bwd_queries<T, P>(a);
  grid_barrier(a.sync, G);
  bwd_episodes<T, P>(a);
  grid_barrier(a.sync, 2 * G);
  bwd_supports<T, P>(a);
  grid_barrier(a.sync, 3 * G);
  bwd_centers<T, P>(a);
  // the last block out leaves the counters at zero for the next launch
  if (threadIdx.x == 0 && atomicAdd(a.sync + 1, 1u) == G - 1) {
    a.sync[0] = 0u;
    a.sync[1] = 0u;
  }
}

// ---------------------------------------------------------------------------
// Host side: an instance per (feature type, P), its plan and launch.
// ---------------------------------------------------------------------------
template <typename T>
using BwdFn = void (*)(const BwdArgs<T>);

template <typename T>
BwdFn<T> bwd_for(int p) {
  switch (p) {
    case 1: return mpm_bwd_kernel<T, 1>;
    case 2: return mpm_bwd_kernel<T, 2>;
    case 3: return mpm_bwd_kernel<T, 3>;
    case 4: return mpm_bwd_kernel<T, 4>;
    case 5: return mpm_bwd_kernel<T, 5>;
    case 6: return mpm_bwd_kernel<T, 6>;
    case 7: return mpm_bwd_kernel<T, 7>;
    case 8: return mpm_bwd_kernel<T, 8>;
    case 12: return mpm_bwd_kernel<T, 12>;
    case 16: return mpm_bwd_kernel<T, 16>;
    default: return nullptr;
  }
}

template <typename T>
int bwd_plan(int c, int p, int* slots) {
  const BwdFn<T> kernel = bwd_for<T>(p);
  if (kernel == nullptr) return -1;
  return ring_plan(
      kernel, [=](int ns) { return bwd_smem(c, p, sizeof(T), ns); }, RingStages<T>::NS, slots);
}

template <typename T>
int bwd_launch(void* const* ptr, const int* iv, const float* fv, void* stream) {
  BwdArgs<T> a;
  a.fts = static_cast<const T*>(ptr[0]);
  a.packed = static_cast<const float*>(ptr[1]);
  a.inds = static_cast<const int*>(ptr[2]);
  a.g = static_cast<const float*>(ptr[3]);
  a.num_part = static_cast<const float*>(ptr[4]);
  a.den_part = static_cast<const float*>(ptr[5]);
  a.fg = static_cast<const float*>(ptr[6]);
  a.bg = static_cast<const float*>(ptr[7]);
  a.ctr = static_cast<const float*>(ptr[8]);
  a.g_fts = static_cast<T*>(ptr[9]);
  a.g_fg = static_cast<float*>(ptr[10]);
  a.g_bg = static_cast<float*>(ptr[11]);
  a.g_ctr = static_cast<float*>(ptr[12]);
  a.gp_part = static_cast<float*>(ptr[13]);
  a.gpn_part = static_cast<float*>(ptr[14]);
  a.pnsq = static_cast<float*>(ptr[15]);
  a.g_num = static_cast<float*>(ptr[16]);
  a.gden_part = static_cast<float*>(ptr[17]);
  a.den_s = static_cast<float*>(ptr[18]);
  a.gc_part = static_cast<float*>(ptr[19]);
  a.gd_part = static_cast<float*>(ptr[20]);
  a.sync = static_cast<unsigned*>(ptr[21]);
  a.sm = static_cast<const float*>(ptr[22]);
  const int P = iv[5], live_p = iv[6], blocks = iv[13];
  a.B = iv[0];
  a.S = iv[1];
  a.Q = iv[2];
  a.n = iv[3];
  a.c = iv[4];
  a.fparts = iv[7];
  a.tiles_q = iv[8];
  a.rows_q = iv[9];
  a.tiles_s = iv[10];
  a.rows_s = iv[11];
  a.ns = iv[12];
  a.dist_scalar = fv[0];
  a.cos_eps = fv[1];
  a.eps = fv[2];
  const BwdFn<T> kernel = bwd_for<T>(P);
  if (kernel == nullptr || a.ns < 0 || a.ns == 1 || a.ns > RingStages<T>::NS || live_p < 1 ||
      live_p > P || blocks < 1 || a.c % 8 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(a.c, P, sizeof(T), a.ns);
  cudaError_t e = launch_config(kernel, smem);
  if (e != cudaSuccess) return e;
  // cooperative: every block resident at once, or the launch is refused
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pemp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Ring stages (2..NS, or 0: rows read from device memory) of the backward
// kernel's instance P (1..8, 12, 16) for c channels on the current device
// and, in *slots, the blocks the device holds at once (the grid); -1 when
// its shared memory does not fit a block.
int pemp_mpm_bwd_plan(int c, int P, int is_bf16, int* slots) {
  return is_bf16 == kFeatureBf16 ? bwd_plan<Feature>(c, P, slots) : -1;
}

// The backward, one cooperative launch of `blocks` blocks (the plan's
// slots). ptr (22): fts [B, S+Q, n, c] (f32 or bf16); packed [B, 2P, c];
// inds [B*Q, n, 2] i32; g [B*Q, n, 2]; num [B*S, fparts, 2P, c] and den
// [B*S, fparts, 2P] (K1's cluster partials); fg, bg [B*S, n]; ctr [c, 2P];
// out g_fts [B, S+Q, n, c], g_fg and g_bg [B*S, n] (or NULL), g_ctr
// [c, 2P]; scratch gp [B*Q*tiles_q, 2P, c], gpn [B*Q*tiles_q, 2P], pnsq
// [B, 2P], g_num [B*S, 2P, c], gden [B*S, 2P, c/4], den_s [B*S, 2P], gc
// [B*S*tiles_s, 2P, c], gd [B*S*tiles_s, 2P]; sync [2] u32, zero before
// and after; every f32 array 16-byte aligned. iv (14): B, S, Q, n, c, P,
// live p, fparts, tiles_q, rows_q, tiles_s, rows_s, ns, blocks. fv (3):
// dist_scalar, cos_eps, eps. Row tile t of an image holds rows [t*rows,
// min(n, (t+1)*rows)), in cdiv(c, pass channels) column passes.
int pemp_mpm_bwd(int is_bf16, void* const* ptr, const int* iv, const float* fv, void* stream) {
  if (is_bf16 != kFeatureBf16) return cudaErrorInvalidValue;
  return bwd_launch<Feature>(ptr, iv, fv, stream);
}

}  // extern "C"
