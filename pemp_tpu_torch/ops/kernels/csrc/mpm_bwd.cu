// The backward of the meta-prototype chain (K4) for Hopper (sm_90a): the
// cotangents of the packed features, the masks and the centers from the
// logit cotangent, in two launches.
//
// Replaces the custom VJPs of pemp_tpu/ops/pallas/mpm_vjp.py: _packed_bwd
// (:216), the composition of _match_bwd (:146) and _assign_bwd (:63).
// There the backward is jnp, which XLA fuses into a few passes; the port's
// first version launched ~100 PyTorch ops, whose host dispatch, not their
// device work, was what the train step waited for.
//
//   match_bwd_kernel (query rows; grid (T, B*Q, passes)): per row, |q|^2
//     and the dot with each class's argmax prototype (the forward's
//     indices, never recomputed), the _safe_norm gates as _match_bwd
//     states them, g_q written into g_fts[:, S:], and the one-hot g_p
//     [2p][c] and g_pn [2p] accumulated in registers. The last block of
//     each episode (a ticket) sums the block partials in a fixed order,
//     forms g_packed = sum + (p_live ? g_pn / pn : 0) p, and from it and
//     the forward's per-cluster partials of K1 (num = a^T f, den = sum a)
//     g_num = g_packed / S / (den_s + eps) and g_den = -sum_c(g_packed / S
//     * num_s) / (den_s + eps)^2 for each shot.
//   assign_bwd_kernel (support rows; grid (T, B*S, passes)): per row, the
//     4p+1 sums |f|^2, f.ctr_k and f.g_num_k in one butterfly; the class
//     softmax, g_a, g_mask, the softmax backward and g_dist on the lanes
//     that hold the sums; g_f = sum_k a_k g_num_k - 2 f g_row + sum_k
//     2 g_dist_k ctr_k written into g_fts[:, :S] (and g_fg / g_bg when
//     asked); f (x) 2 g_dist and sum g_dist accumulated in registers. The
//     last block of each support image sums that image's block partials;
//     the last image sums the images' and writes g_ctr = sum - 2 ctr
//     sum g_dist.
// Both read each feature row from device memory once and write its
// cotangent once (bytes-bound, like the forward); the tables (the
// prototypes; the centers and g_num) sit in shared memory permuted for
// lanes on fixed columns, and the rows stream through a cp.async ring
// (ns = 0: read from device memory where the ring does not fit). Above
// 512 channels each column pass recomputes the rows' whole dot products
// and writes and accumulates its own 512 columns. No atomics touch a sum:
// the cotangents are bit-identical run to run. The tickets are reset by
// the blocks that draw the last ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mpm_common.cuh"

namespace {

using namespace pemp;

// shared memory after the main loop is reused by the warps' tree
// (kWarps/2 slots of [2p][min(c, kPassCols)])
constexpr size_t tree_bytes(int c, int k2) {
  return (size_t)kWarps / 2 * k2 * (c < kPassCols ? c : kPassCols) * 4;
}

constexpr size_t max3(size_t a, size_t b, size_t d) {
  return a > b ? (a > d ? a : d) : (b > d ? b : d);
}

// match_bwd: the prototype table, the index and cotangent ring (always at
// least kMinStages slots), the row ring; then the tree or the episode's
// finish (g_packed [2p][c] and one float a float4)
constexpr size_t match_bwd_smem(int c, int p, int esize, int ns) {
  const int k2 = 2 * p, slots = ns > kMinStages ? ns : kMinStages;
  return max3((size_t)k2 * c * 4 + (size_t)slots * kStageRows * 16 +
                  (size_t)ns * kStageRows * c * esize,
              tree_bytes(c, k2), (size_t)k2 * c * 5);
}

// assign_bwd: the centers and g_num tables, the mask ring, the row ring;
// then the tree
constexpr size_t assign_bwd_smem(int c, int p, int esize, int ns) {
  const int k2 = 2 * p, slots = ns > kMinStages ? ns : kMinStages;
  return max3((size_t)2 * k2 * c * 4 + (size_t)slots * 2 * kStageRows * 4 +
                  (size_t)ns * kStageRows * c * esize,
              tree_bytes(c, k2), 0);
}

// ---------------------------------------------------------------------------
// match_bwd: query rows, then the episode's finish.
// ---------------------------------------------------------------------------
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
match_bwd_kernel(const T* __restrict__ fts, const float* __restrict__ packed,
                 const int* __restrict__ inds, const float* __restrict__ gl,
                 const float* __restrict__ num_part, const float* __restrict__ den_part,
                 T* __restrict__ g_fts, float* __restrict__ gp_part, float* __restrict__ gpn_part,
                 int* __restrict__ tickets, float* __restrict__ g_num, float* __restrict__ g_den,
                 int S, int Q, int n, int c, int rows, int ns, int fparts, float dist_scalar,
                 float cos_eps, float eps) {
  constexpr int K2 = 2 * P, V = Vec<T>::N, NCH = kPassCols / (32 * V);
  constexpr int R = kRowsPerWarp;      // rows per group: one group a warp and stage
  constexpr int W = 3;                 // sums per row: |q|^2, q.p_bg, q.p_fg
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = ns > kMinStages ? ns : kMinStages;
  float* tab_s = reinterpret_cast<float*>(smem_raw);                 // [K2][c] permuted
  int2* ind_s = reinterpret_cast<int2*>(tab_s + K2 * c);             // [slots][kStageRows]
  float2* g_s = reinterpret_cast<float2*>(ind_s + slots * kStageRows);
  T* ring = reinterpret_cast<T*>(g_s + slots * kStageRows);          // [ns][kStageRows][c]
  __shared__ float psq_s[K2], pfac_s[K2], den_s[K2], gpn_w[kWarps][K2];
  __shared__ int last_s;

  const int t = blockIdx.x, tiles = gridDim.x;
  const int iq = blockIdx.y;                    // query image in [0, B*Q)
  const int z = blockIdx.z, passes = gridDim.z;
  const int b = iq / Q;
  const int img = b * (S + Q) + S + iq % Q;     // packed query row
  const int row0 = t * rows;
  const int nrows = min(rows, n - row0);
  const int stages = (nrows + kStageRows - 1) / kStageRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cv = c / V;
  const int qz = z * 32 * NCH;                  // first chunk of the pass
  const int pc = min(c, kPassCols);
  const T* src = fts + ((size_t)img * n + row0) * c;
  T* dst_rows = g_fts + ((size_t)img * n + row0) * c;
  const int* src_ind = inds + ((size_t)iq * n + row0) * 2;
  const float* src_g = gl + ((size_t)iq * n + row0) * 2;

  // stage st: rows into ring slot st % ns (when ns > 0), indices and
  // cotangents into slot st % slots; rows past the block's zero-filled
  auto issue = [&](int st) {
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
      if (threadIdx.x < 4 * kStageRows) {       // 2 ints and 2 floats a row
        const int e = threadIdx.x % (2 * kStageRows);
        const bool live = r0 + e / 2 < nrows;
        if (threadIdx.x < 2 * kStageRows)
          cp_async4(reinterpret_cast<int*>(ind_s + (st % slots) * kStageRows) + e,
                    src_ind + (live ? 2 * r0 + e : 0), live ? 4 : 0);
        else
          cp_async4(reinterpret_cast<float*>(g_s + (st % slots) * kStageRows) + e,
                    src_g + (live ? 2 * r0 + e : 0), live ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  for (int st = 0; st < slots - 1; ++st) issue(st);
  load_table_rows<V>(tab_s, 0, packed + (size_t)b * K2 * c, K2, c);
  __syncthreads();
  table_norms_sq(tab_s, psq_s, c, K2);          // read after the loop's first barrier

  float acc[K2][NCH * V];                       // g_p on the lane's columns of the pass
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int j = 0; j < NCH * V; ++j) acc[k][j] = 0.f;
  float gpn[K2];                                // g_pn, the same on every lane
#pragma unroll
  for (int k = 0; k < K2; ++k) gpn[k] = 0.f;
  // the sum lane `lane` holds after the butterfly: row my_r, slot my_w
  const int my_r = min(lane / W, R - 1), my_w = lane % W;

  for (int st = 0; st < stages; ++st) {
    issue(st + slots - 1);
    wait_ring(slots);
    __syncthreads();
    const T* tile = ns > 0 ? ring + (size_t)(st % ns) * kStageRows * c
                           : src + (size_t)st * kStageRows * c;
    const int2* is = ind_s + (st % slots) * kStageRows;
    const float2* gs = g_s + (st % slots) * kStageRows;
    const int live_rows = min(kStageRows, nrows - st * kStageRows);
    const int g = warp * R;
    if (g < live_rows) {                                          // warp-uniform
      int kb[R], kf[R];                         // table rows of the argmax: bg, fg
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int2 id = is[g + r];
        kb[r] = P + id.x;
        kf[r] = id.y;
      }
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = 0.f;
      for (int q0 = 0; q0 < cv; q0 += 32 * NCH) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int q = q0 + lane + 32 * j;
          if (q < cv) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float x[V];
              if (g + r < live_rows) {
                Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V), x);
              } else {
#pragma unroll
                for (int e = 0; e < V; ++e) x[e] = 0.f;
              }
#pragma unroll
              for (int h = 0; h < V / 4; ++h) {
                const float4 wb = tab4<V>(tab_s, kb[r], h, q, c);
                const float4 wf = tab4<V>(tab_s, kf[r], h, q, c);
                const float* xh = x + 4 * h;
                v[r * W] = fmaf(xh[0], xh[0], fmaf(xh[1], xh[1], fmaf(xh[2], xh[2], fmaf(xh[3], xh[3], v[r * W]))));
                v[r * W + 1] = fmaf(xh[0], wb.x, fmaf(xh[1], wb.y, fmaf(xh[2], wb.z, fmaf(xh[3], wb.w, v[r * W + 1]))));
                v[r * W + 2] = fmaf(xh[0], wf.x, fmaf(xh[1], wf.y, fmaf(xh[2], wf.z, fmaf(xh[3], wf.w, v[r * W + 2]))));
              }
            }
          }
        }
      }
      reduce_scatter<16>(v, lane);
      // lanes r*3+1 (bg) and r*3+2 (fg): one class of row r each
      const float dot = v[0];
      const float sq = __shfl_sync(kFull, dot, my_r * W);
      const float qn = sqrtf(fmaxf(sq, 1e-30f));
      const int2 id = is[g + my_r];
      const bool fg_lane = my_w == 2;
      const int kc = fg_lane ? id.y : P + id.x;
      const float pn = sqrtf(fmaxf(psq_s[kc], 1e-30f));
      const float2 gg = gs[g + my_r];
      const bool live = lane < R * W && my_w > 0 && g + my_r < live_rows;
      const float gc = live ? (fg_lane ? gg.y : gg.x) * dist_scalar : 0.f;
      const float d_raw = qn * pn;
      const float d_cl = fmaxf(d_raw, cos_eps);
      const float gdot = gc / d_cl;
      const float gd = d_raw >= cos_eps ? -gc * dot / (d_cl * d_cl) : 0.f;
      // the row's coefficient of q (on the bg lane): both classes' g_qn / qn
      const float cq = sq >= 1e-30f ? gd * pn / qn : 0.f;
      const float coef = cq + __shfl_down_sync(kFull, cq, 1);
      const float gpn_c = gd * qn;
      float gdb[R], gdf[R], cf[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gdb[r] = __shfl_sync(kFull, gdot, r * W + 1);
        gdf[r] = __shfl_sync(kFull, gdot, r * W + 2);
        cf[r] = __shfl_sync(kFull, coef, r * W + 1);
        const float pb = __shfl_sync(kFull, gpn_c, r * W + 1);
        const float pf = __shfl_sync(kFull, gpn_c, r * W + 2);
#pragma unroll
        for (int k = 0; k < K2; ++k)
          gpn[k] += k == kb[r] ? pb : (k == kf[r] ? pf : 0.f);
      }
      // g_q on the lane's columns of the pass, and g_p += g_dot q
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int q = qz + lane + 32 * j;
        if (q < cv) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (g + r < live_rows) {
              float x[V], gq[V];
              Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V), x);
#pragma unroll
              for (int h = 0; h < V / 4; ++h) {
                const float4 wb = tab4<V>(tab_s, kb[r], h, q, c);
                const float4 wf = tab4<V>(tab_s, kf[r], h, q, c);
                const float b4[4] = {wb.x, wb.y, wb.z, wb.w}, f4[4] = {wf.x, wf.y, wf.z, wf.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  gq[4 * h + e] = fmaf(gdb[r], b4[e], fmaf(gdf[r], f4[e], cf[r] * x[4 * h + e]));
              }
              *reinterpret_cast<uint4*>(dst_rows + (size_t)(st * kStageRows + g + r) * c + q * V) =
                  Vec<T>::pack(gq);
#pragma unroll
              for (int k = 0; k < K2; ++k) {
                const float w = k == kf[r] ? gdf[r] : (k == kb[r] ? gdb[r] : 0.f);
#pragma unroll
                for (int e = 0; e < V; ++e) acc[k][j * V + e] = fmaf(w, x[e], acc[k][j * V + e]);
              }
            }
          }
        }
      }
    }
    __syncthreads();                     // slots st % ns and st % slots are refilled next
  }
  cp_async_wait<0>();

  // the block's partial: the warps' g_p in a fixed tree, g_pn in warp order
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K2; ++k) gpn_w[warp][k] = gpn[k];
  }
  block_tree<K2, NCH, V>(acc, reinterpret_cast<float*>(smem_raw), qz, cv, pc, warp, lane);
  const size_t part = (size_t)iq * tiles + t;
  if (warp == 0) store_cols<K2, NCH, V>(acc, gp_part + part * K2 * c, c, qz, cv, lane);
  if (z == 0 && threadIdx.x < K2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += gpn_w[w][threadIdx.x];
    gpn_part[part * K2 + threadIdx.x] = s;
  }

  // the last block of episode b finishes it
  if (!last_ticket(&tickets[b], Q * tiles * passes, &last_s)) return;
  const int parts = Q * tiles;                  // partials of the episode, in (q, t) order
  const size_t p0 = (size_t)b * parts;
  if (threadIdx.x < K2) {
    const int k = threadIdx.x;
    const float s = sum_parts1(gpn_part + p0 * K2 + k, K2, parts);
    pfac_s[k] = psq_s[k] >= 1e-30f ? s / sqrtf(psq_s[k]) : 0.f;     // p_live ? g_pn / pn
  }
  __syncthreads();
  float* gpk_s = reinterpret_cast<float*>(smem_raw);             // [K2][c] g_packed
  float* red_s = gpk_s + K2 * c;                                 // [K2 * c / 4]
  const int n4 = K2 * c / 4;
  for (int idx = threadIdx.x; idx < n4; idx += kThreads) {
    const int k = idx * 4 / c;
    const float4 gp = sum_parts4(gp_part + p0 * K2 * c, (size_t)K2 * c, parts, idx);
    const float4 pv = __ldg(reinterpret_cast<const float4*>(packed + (size_t)b * K2 * c) + idx);
    const float f = pfac_s[k];
    reinterpret_cast<float4*>(gpk_s)[idx] =
        make_float4(fmaf(f, pv.x, gp.x), fmaf(f, pv.y, gp.y), fmaf(f, pv.z, gp.z),
                    fmaf(f, pv.w, gp.w));
  }
  // each shot: its sums from K1's cluster partials, g_num and g_den
  const float inv_s = 1.f / (float)S;
  for (int s = 0; s < S; ++s) {
    const size_t i = (size_t)b * S + s;
    if (threadIdx.x < K2)
      den_s[threadIdx.x] =
          sum_parts1(den_part + i * fparts * K2 + threadIdx.x, K2, fparts) + eps;
    __syncthreads();
    for (int idx = threadIdx.x; idx < n4; idx += kThreads) {
      const int k = idx * 4 / c;
      const float4 nm = sum_parts4(num_part + i * fparts * K2 * c, (size_t)K2 * c, fparts, idx);
      const float4 gp = reinterpret_cast<const float4*>(gpk_s)[idx];
      const float4 gq = make_float4(gp.x * inv_s, gp.y * inv_s, gp.z * inv_s, gp.w * inv_s);
      const float d = den_s[k];
      reinterpret_cast<float4*>(g_num + i * K2 * c)[idx] =
          make_float4(gq.x / d, gq.y / d, gq.z / d, gq.w / d);
      red_s[idx] = gq.x * nm.x + gq.y * nm.y + gq.z * nm.z + gq.w * nm.w;
    }
    __syncthreads();
    for (int k = warp; k < K2; k += kWarps) {
      float sum = 0.f;
      for (int j = lane; j < c / 4; j += 32) sum += red_s[k * (c / 4) + j];
      sum = warp_sum(sum);
      if (lane == 0) g_den[i * K2 + k] = -sum / (den_s[k] * den_s[k]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicExch(&tickets[b], 0);
}

// ---------------------------------------------------------------------------
// assign_bwd: support rows, then the finishes of each image and of all.
// ---------------------------------------------------------------------------
template <int P>
struct AssignBwdShape {
  static constexpr int K2 = 2 * P;
  static constexpr int NT = 2 * K2;              // table rows: the centers, then g_num
  static constexpr bool SQ = NT + 1 <= 32;       // |f|^2 in the butterfly (else apart)
  static constexpr int W = SQ ? NT + 1 : NT;     // sums per row
  static constexpr int R = 4 * W <= 32 ? 4 : 2 * W <= 32 ? 2 : 1;   // rows per group
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
assign_bwd_kernel(const T* __restrict__ fts, const float* __restrict__ fg,
                  const float* __restrict__ bg, const float* __restrict__ ctr,
                  const float* __restrict__ g_num, const float* __restrict__ g_den,
                  T* __restrict__ g_fts, float* __restrict__ g_fg, float* __restrict__ g_bg,
                  float* __restrict__ gc_part, float* __restrict__ gd_part,
                  float* __restrict__ gc_img, float* __restrict__ gd_img,
                  int* __restrict__ tickets, float* __restrict__ g_ctr, int S, int Q, int n,
                  int c, int rows, int ns) {
  using Shape = AssignBwdShape<P>;
  constexpr int K2 = Shape::K2, NT = Shape::NT, W = Shape::W, R = Shape::R;
  constexpr bool SQ = Shape::SQ;
  constexpr int V = Vec<T>::N, NCH = kPassCols / (32 * V);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slots = ns > kMinStages ? ns : kMinStages;
  float* tab_s = reinterpret_cast<float*>(smem_raw);            // [NT][c] permuted
  float* mask_s = tab_s + NT * c;                                // [slots][2][kStageRows]
  T* ring = reinterpret_cast<T*>(mask_s + slots * 2 * kStageRows);   // [ns][kStageRows][c]
  __shared__ float csq_s[K2], gden_s[K2], gdt_s[K2];
  __shared__ float gd_w[kWarps][32];
  __shared__ int last_s;

  const int t = blockIdx.x, tiles = gridDim.x;
  const int i = blockIdx.y, images = gridDim.y;   // support image in [0, B*S)
  const int z = blockIdx.z, passes = gridDim.z;
  const int b = i / S;
  const int img = b * (S + Q) + i % S;          // packed support row
  const int row0 = t * rows;
  const int nrows = min(rows, n - row0);
  const int stages = (nrows + kStageRows - 1) / kStageRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cv = c / V;
  const int qz = z * 32 * NCH;
  const int pc = min(c, kPassCols);
  const T* src = fts + ((size_t)img * n + row0) * c;
  T* dst_rows = g_fts + ((size_t)img * n + row0) * c;
  const float* mfg = fg + (size_t)i * n + row0;
  const float* mbg = bg + (size_t)i * n + row0;

  auto issue = [&](int st) {
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
      if (threadIdx.x < 2 * kStageRows) {
        const int cls = threadIdx.x / kStageRows, r = threadIdx.x % kStageRows;
        const bool live = r0 + r < nrows;
        cp_async4(mask_s + ((st % slots) * 2 + cls) * kStageRows + r,
                  (cls ? mbg : mfg) + (live ? r0 + r : 0), live ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  for (int st = 0; st < slots - 1; ++st) issue(st);
  load_table_cols<V>(tab_s, 0, ctr, K2, c);
  load_table_rows<V>(tab_s, K2, g_num + (size_t)i * K2 * c, K2, c);
  if (threadIdx.x < K2) gden_s[threadIdx.x] = g_den[(size_t)i * K2 + threadIdx.x];
  __syncthreads();
  table_norms_sq(tab_s, csq_s, c, K2);          // read after the loop's first barrier

  float acc[K2][NCH * V];                       // f (x) 2 g_dist on the lane's columns
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int j = 0; j < NCH * V; ++j) acc[k][j] = 0.f;
  float gd_acc = 0.f;                           // sum g_dist of the lane's (row, k)
  const int my_r = lane / W, my_k = lane % W;
  const int kk = min(my_k, K2 - 1);
  const int cls = kk / P;                       // 0: fg columns, 1: bg
  const int rb = my_r * W, cbase = rb + cls * P;

  for (int st = 0; st < stages; ++st) {
    issue(st + slots - 1);
    wait_ring(slots);
    __syncthreads();
    const T* tile = ns > 0 ? ring + (size_t)(st % ns) * kStageRows * c
                           : src + (size_t)st * kStageRows * c;
    const float* mk = mask_s + (st % slots) * 2 * kStageRows + cls * kStageRows;
    const int live_rows = min(kStageRows, nrows - st * kStageRows);
#pragma unroll
    for (int gi = 0; gi < kRowsPerWarp / R; ++gi) {
      const int g = warp * kRowsPerWarp + gi * R;
      if (g >= live_rows) break;                               // warp-uniform
      float v[32], sqr[R];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) sqr[r] = 0.f;
      group_sums<T, NT, R, W, SQ>(tile, g, live_rows, tab_s, c, lane, v, sqr);
      float sq_apart = 0.f;
      if constexpr (!SQ) sq_apart = warp_sum(sqr[0]);          // R == 1
      reduce_scatter<16>(v, lane);
      const float fc = v[0];
      const float sq = SQ ? __shfl_sync(kFull, fc, (rb + NT) & 31) : sq_apart;
      const float fgn = __shfl_sync(kFull, fc, (rb + K2 + kk) & 31);
      // the softmax over the class's own p columns, R*2p lanes at once
      const float dist = -(sq - 2.f * fc + csq_s[kk]);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < P; ++j) mx = fmaxf(mx, __shfl_sync(kFull, dist, (cbase + j) & 31));
      const float ex = expf(dist - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) sum += __shfl_sync(kFull, ex, (cbase + j) & 31);
      const float sm = ex / sum;
      const int row = g + my_r;
      const bool live = my_r < R && my_k < K2 && row < live_rows;
      const float mask = mk[min(row, kStageRows - 1)];
      const float ga = fgn + gden_s[kk];
      float gmask = 0.f, tc = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) gmask += __shfl_sync(kFull, sm * ga, (cbase + j) & 31);
      const float gsm = ga * mask;
#pragma unroll
      for (int j = 0; j < P; ++j) tc += __shfl_sync(kFull, sm * gsm, (cbase + j) & 31);
      const float gd = live ? sm * (gsm - tc) : 0.f;
      const float a = live ? sm * mask : 0.f;
      float grow = 0.f;
#pragma unroll
      for (int k = 0; k < K2; ++k) grow += __shfl_sync(kFull, gd, (rb + k) & 31);
      gd_acc += gd;
      if (z == 0 && live && (my_k == 0 || my_k == P)) {
        float* out = my_k == 0 ? g_fg : g_bg;
        if (out != nullptr) out[(size_t)i * n + row0 + st * kStageRows + row] = gmask;
      }
      float ar[R][K2], gdr[R][K2], gr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        gr[r] = __shfl_sync(kFull, grow, r * W);
#pragma unroll
        for (int k = 0; k < K2; ++k) {
          ar[r][k] = __shfl_sync(kFull, a, r * W + k);
          gdr[r][k] = 2.f * __shfl_sync(kFull, gd, r * W + k);
        }
      }
      // g_f on the lane's columns of the pass, and f (x) 2 g_dist
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int q = qz + lane + 32 * j;
        if (q < cv) {
          float x[R][V], gf[R][V];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (g + r < live_rows) {
              Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V), x[r]);
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
              const float c4[4] = {wc.x, wc.y, wc.z, wc.w}, n4[4] = {wn.x, wn.y, wn.z, wn.w};
#pragma unroll
              for (int r = 0; r < R; ++r)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  float& o = gf[r][4 * h + e];
                  o = fmaf(ar[r][k], n4[e], fmaf(gdr[r][k], c4[e], o));
                  acc[k][j * V + 4 * h + e] = fmaf(gdr[r][k], x[r][4 * h + e], acc[k][j * V + 4 * h + e]);
                }
            }
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (g + r < live_rows)
              *reinterpret_cast<uint4*>(dst_rows + (size_t)(st * kStageRows + g + r) * c + q * V) =
                  Vec<T>::pack(gf[r]);
        }
      }
    }
    __syncthreads();                     // slots st % ns and st % slots are refilled next
  }
  cp_async_wait<0>();

  // the block's partial: the warps' sums in a fixed tree; sum g_dist of
  // each k over the lanes that held it, in warp and lane order
  gd_w[warp][lane] = gd_acc;
  block_tree<K2, NCH, V>(acc, reinterpret_cast<float*>(smem_raw), qz, cv, pc, warp, lane);
  const size_t part = (size_t)i * tiles + t;
  if (warp == 0) store_cols<K2, NCH, V>(acc, gc_part + part * K2 * c, c, qz, cv, lane);
  if (z == 0 && threadIdx.x < K2) {
    float d = 0.f;
    for (int w = 0; w < kWarps; ++w)
      for (int l = threadIdx.x; l < R * W; l += W) d += gd_w[w][l];
    gd_part[part * K2 + threadIdx.x] = d;
  }

  // the last block of image i sums its partials in t order
  if (!last_ticket(&tickets[i], tiles * passes, &last_s)) return;
  const int n4 = K2 * c / 4;
  for (int idx = threadIdx.x; idx < n4; idx += kThreads)
    reinterpret_cast<float4*>(gc_img + (size_t)i * K2 * c)[idx] =
        sum_parts4(gc_part + (size_t)i * tiles * K2 * c, (size_t)K2 * c, tiles, idx);
  if (threadIdx.x < K2)
    gd_img[(size_t)i * K2 + threadIdx.x] =
        sum_parts1(gd_part + (size_t)i * tiles * K2 + threadIdx.x, K2, tiles);
  if (threadIdx.x == 0) atomicExch(&tickets[i], 0);

  // the last image sums the images' in i order: g_ctr [c][2p]
  if (!last_ticket(&tickets[images], images, &last_s)) return;
  if (threadIdx.x < K2) gdt_s[threadIdx.x] = sum_parts1(gd_img + threadIdx.x, K2, images);
  __syncthreads();
  for (int idx = threadIdx.x; idx < n4; idx += kThreads) {
    const int k = idx * 4 / c, col = idx * 4 % c;
    const float4 s = sum_parts4(gc_img, (size_t)K2 * c, images, idx);
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t o = (size_t)(col + e) * K2 + k;
      g_ctr[o] = sv[e] - 2.f * __ldg(ctr + o) * gdt_s[k];
    }
  }
  if (threadIdx.x == 0) atomicExch(&tickets[images], 0);
}

// ---------------------------------------------------------------------------
// Host side: an instance per (feature type, p), its ring plan and launch.
// ---------------------------------------------------------------------------
template <typename T>
using MatchBwdFn = void (*)(const T*, const float*, const int*, const float*, const float*,
                            const float*, T*, float*, float*, int*, float*, float*, int, int,
                            int, int, int, int, int, float, float, float);
template <typename T>
using AssignBwdFn = void (*)(const T*, const float*, const float*, const float*, const float*,
                             const float*, T*, float*, float*, float*, float*, float*, float*,
                             int*, float*, int, int, int, int, int, int);

template <typename T>
MatchBwdFn<T> match_bwd_for(int p) {
  switch (p) {
    case 1: return match_bwd_kernel<T, 1>;
    case 2: return match_bwd_kernel<T, 2>;
    case 3: return match_bwd_kernel<T, 3>;
    case 4: return match_bwd_kernel<T, 4>;
    case 5: return match_bwd_kernel<T, 5>;
    case 6: return match_bwd_kernel<T, 6>;
    case 7: return match_bwd_kernel<T, 7>;
    case 8: return match_bwd_kernel<T, 8>;
    default: return nullptr;
  }
}

template <typename T>
AssignBwdFn<T> assign_bwd_for(int p) {
  switch (p) {
    case 1: return assign_bwd_kernel<T, 1>;
    case 2: return assign_bwd_kernel<T, 2>;
    case 3: return assign_bwd_kernel<T, 3>;
    case 4: return assign_bwd_kernel<T, 4>;
    case 5: return assign_bwd_kernel<T, 5>;
    case 6: return assign_bwd_kernel<T, 6>;
    case 7: return assign_bwd_kernel<T, 7>;
    case 8: return assign_bwd_kernel<T, 8>;
    default: return nullptr;
  }
}

template <typename T>
int bwd_plan(int kind, int c, int p, int* slots) {
  if (kind == 0) {
    const MatchBwdFn<T> kernel = match_bwd_for<T>(p);
    if (kernel == nullptr) return -1;
    return ring_plan(
        kernel, [=](int ns) { return match_bwd_smem(c, p, sizeof(T), ns); }, RingStages<T>::NS,
        slots);
  }
  const AssignBwdFn<T> kernel = assign_bwd_for<T>(p);
  if (kernel == nullptr) return -1;
  return ring_plan(
      kernel, [=](int ns) { return assign_bwd_smem(c, p, sizeof(T), ns); }, RingStages<T>::NS,
      slots);
}

bool bad_ring(int ns, int most) { return ns < 0 || ns == 1 || ns > most; }

template <typename T>
int match_bwd_launch(const void* fts, const void* packed, const void* inds, const void* g,
                     const void* num, const void* den, void* g_fts, void* gp_part,
                     void* gpn_part, void* tickets, void* g_num, void* g_den, int B, int S,
                     int Q, int n, int c, int p, int rows, int tiles, int ns, int fparts,
                     float dist_scalar, float cos_eps, float eps, void* stream) {
  const MatchBwdFn<T> kernel = match_bwd_for<T>(p);
  if (kernel == nullptr || bad_ring(ns, RingStages<T>::NS)) return cudaErrorInvalidValue;
  const size_t smem = match_bwd_smem(c, p, sizeof(T), ns);
  const cudaError_t e = launch_config(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, B * Q, (c + kPassCols - 1) / kPassCols);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fts), static_cast<const float*>(packed),
      static_cast<const int*>(inds), static_cast<const float*>(g),
      static_cast<const float*>(num), static_cast<const float*>(den), static_cast<T*>(g_fts),
      static_cast<float*>(gp_part), static_cast<float*>(gpn_part), static_cast<int*>(tickets),
      static_cast<float*>(g_num), static_cast<float*>(g_den), S, Q, n, c, rows, ns, fparts,
      dist_scalar, cos_eps, eps);
  return cudaGetLastError();
}

template <typename T>
int assign_bwd_launch(const void* fts, const void* fg, const void* bg, const void* ctr,
                      const void* g_num, const void* g_den, void* g_fts, void* g_fg, void* g_bg,
                      void* gc_part, void* gd_part, void* gc_img, void* gd_img, void* tickets,
                      void* g_ctr, int B, int S, int Q, int n, int c, int p, int rows, int tiles,
                      int ns, void* stream) {
  const AssignBwdFn<T> kernel = assign_bwd_for<T>(p);
  if (kernel == nullptr || bad_ring(ns, RingStages<T>::NS)) return cudaErrorInvalidValue;
  const size_t smem = assign_bwd_smem(c, p, sizeof(T), ns);
  const cudaError_t e = launch_config(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, B * S, (c + kPassCols - 1) / kPassCols);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fts), static_cast<const float*>(fg), static_cast<const float*>(bg),
      static_cast<const float*>(ctr), static_cast<const float*>(g_num),
      static_cast<const float*>(g_den), static_cast<T*>(g_fts), static_cast<float*>(g_fg),
      static_cast<float*>(g_bg), static_cast<float*>(gc_part), static_cast<float*>(gd_part),
      static_cast<float*>(gc_img), static_cast<float*>(gd_img), static_cast<int*>(tickets),
      static_cast<float*>(g_ctr), S, Q, n, c, rows, ns);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pemp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Ring stages (2..NS, or 0: rows read from device memory) of the backward
// kernel `kind` (0 match_bwd, 1 assign_bwd) for (c, p) on the current
// device and, in *slots, the blocks the device holds at once; -1 when its
// shared memory does not fit a block.
int pemp_mpm_bwd_plan(int kind, int c, int p, int is_bf16, int* slots) {
  return is_bf16 ? bwd_plan<__nv_bfloat16>(kind, c, p, slots) : bwd_plan<float>(kind, c, p, slots);
}

// match_bwd. fts [B, S+Q, n, c] (f32 or bf16); packed [B, 2p, c] f32 (fg
// then bg); inds [B*Q, n, 2] i32 and g [B*Q, n, 2] f32 ([bg, fg]); num
// [B*S, fparts, 2p, c] and den [B*S, fparts, 2p] f32: the forward assign
// kernel's cluster partials. Out: g_fts [B, S+Q, n, c] query rows; g_num
// [B*S, 2p, c] and g_den [B*S, 2p] f32. Scratch gp_part [B*Q, tiles, 2p,
// c], gpn_part [B*Q, tiles, 2p] f32; tickets [B] i32, zero before and
// after. Block t of a query image takes rows [t*rows, min(n, (t+1)*rows)),
// tiles = cdiv(n, rows), in cdiv(c, 512) column passes.
int pemp_mpm_match_bwd(const void* fts, int is_bf16, const void* packed, const void* inds,
                       const void* g, const void* num, const void* den, void* g_fts,
                       void* gp_part, void* gpn_part, void* tickets, void* g_num, void* g_den,
                       int B, int S, int Q, int n, int c, int p, int rows, int tiles, int ns,
                       int fparts, float dist_scalar, float cos_eps, float eps, void* stream) {
  return is_bf16
             ? match_bwd_launch<__nv_bfloat16>(fts, packed, inds, g, num, den, g_fts, gp_part,
                                               gpn_part, tickets, g_num, g_den, B, S, Q, n, c,
                                               p, rows, tiles, ns, fparts, dist_scalar,
                                               cos_eps, eps, stream)
             : match_bwd_launch<float>(fts, packed, inds, g, num, den, g_fts, gp_part,
                                       gpn_part, tickets, g_num, g_den, B, S, Q, n, c, p, rows,
                                       tiles, ns, fparts, dist_scalar, cos_eps, eps, stream);
}

// assign_bwd. fts [B, S+Q, n, c]; fg/bg [B*S, n] f32; ctr [c, 2p] f32;
// g_num [B*S, 2p, c], g_den [B*S, 2p] f32 (from match_bwd). Out: g_fts
// support rows; g_fg/g_bg [B*S, n] f32 (or NULL: not written); g_ctr
// [c, 2p] f32. Scratch gc_part [B*S, tiles, 2p, c], gd_part [B*S, tiles,
// 2p], gc_img [B*S, 2p, c], gd_img [B*S, 2p] f32; tickets [B*S + 1] i32,
// zero before and after.
int pemp_mpm_assign_bwd(const void* fts, int is_bf16, const void* fg, const void* bg,
                        const void* ctr, const void* g_num, const void* g_den, void* g_fts,
                        void* g_fg, void* g_bg, void* gc_part, void* gd_part, void* gc_img,
                        void* gd_img, void* tickets, void* g_ctr, int B, int S, int Q, int n,
                        int c, int p, int rows, int tiles, int ns, void* stream) {
  return is_bf16 ? assign_bwd_launch<__nv_bfloat16>(fts, fg, bg, ctr, g_num, g_den, g_fts, g_fg,
                                                    g_bg, gc_part, gd_part, gc_img, gd_img,
                                                    tickets, g_ctr, B, S, Q, n, c, p, rows,
                                                    tiles, ns, stream)
                 : assign_bwd_launch<float>(fts, fg, bg, ctr, g_num, g_den, g_fts, g_fg, g_bg,
                                            gc_part, gd_part, gc_img, gd_img, tickets, g_ctr, B,
                                            S, Q, n, c, p, rows, tiles, ns, stream);
}

}  // extern "C"
