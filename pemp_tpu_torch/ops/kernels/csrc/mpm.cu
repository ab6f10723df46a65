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
// 67 TFLOP/s fp32 CUDA-core rate's own break-even (~20 flops/byte). The
// centers are fp32 and the contractions are pinned at full fp32 (lower
// precision flips argmax near ties), so both kernels use fp32 CUDA cores
// (no wgmma) and read each feature row from device memory once (K1:
// once per 512-channel pass).
//   - K1 (assign_kernel) streams its rows through a cp.async ring, keeps
//     each lane on fixed columns so the center table is read once per
//     group of rows, reduces the per-row sums with one butterfly, and
//     accumulates a^T f in registers; 2-block clusters add their partials
//     over distributed shared memory and the last block of each episode
//     sums the cluster partials in a fixed order. One launch.
//   - K2 (match_kernel) uses the same pieces (mpm_common.cuh) with a ring
//     per warp, and finds each row's per-class max and first-occurrence
//     argmax on the lanes that hold its sums.
// Determinism: no atomics on any sum, so the prototypes (and K2's
// first-occurrence argmax that reads them) are bit-identical run to run.
// Rows >= n are never loaded (the ring zero-fills them; K1 drops their
// assignment with a select, K2 writes nothing for them).
// p above 8 runs on the instances P = 12 and 16 (mpm_common.cuh): the
// wrapper pads the centers (K1) and the prototypes (K2) with zero columns,
// K1 gives the padded columns no share of the class softmax and K2 none of
// the max; there 2P + 1 sums a row exceed the warp at P = 16, so |f|^2 is
// summed apart, and a column pass holds 256 channels.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mpm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pemp;

// ---------------------------------------------------------------------------
// K1: soft assignment and adaptive prototypes, one launch.
//
//   protos[b, k, :] = mean_s( sum_rows a[row, k] f[row, :] / (sum_rows a[row, k] + eps) )
//
// with a = per-class softmax over the class's own p centers of
// -(|f|^2 - 2 f.ctr + |ctr|^2), times the class mask. Grid (T, B*S, Z):
// block t of support image i takes `rows` consecutive pixel rows, and
// column pass z sums a^T f over channels [z*kPassCols, (z+1)*kPassCols)
// (one pass up to 512 channels; each pass computes the rows' whole dot
// products, so the assignment is the same in every pass).
//   - The rows stream through a ring of `ns` shared-memory stages of
//     kStageRows rows (as many as fit, at most NS), filled by 16-byte
//     cp.async (rows >= n are never read: the copy zero-fills them),
//     ns-1 stages in flight while one is computed.
//   - Each warp takes kRowsPerWarp rows of a stage, R at a time; each lane
//     owns the same 16-byte column chunks (q = lane + 32 j) for the whole
//     kernel, so it reads its slice of the [2p][c] center table once per R
//     rows, not once per row.
//   - The R*(2p+1) partial sums (2p dots and |f|^2 per row) are reduced
//     with one reduce-scatter butterfly (31 shuffles): lane l ends with
//     value l, and the softmax of R rows runs on R*2p lanes at once.
//   - a^T f and sum a accumulate in registers on the lane's own columns of
//     the pass; at the end the warps add theirs in a fixed tree through
//     shared memory.
//   - The kCluster blocks of a cluster (consecutive t of one image) add
//     their partials over distributed shared memory in rank order, each
//     block one slice, and write one [2p][pass columns] num and (pass 0)
//     one [2p] den partial to scratch; each block then fences and takes a
//     ticket of its episode. The block that draws the episode's last
//     ticket sums the cluster partials in fixed (s, t) order, writes
//     protos[b] and resets the ticket to 0 for the next launch. No atomics
//     touch a sum, so the prototypes are bit-identical run to run.
// ---------------------------------------------------------------------------
constexpr int kCluster = 2;                        // blocks of an image per cluster

template <int P>
struct AssignShape {
  static constexpr int K2 = 2 * P;
  static constexpr bool SQ = K2 + 1 <= 32;         // |f|^2 in the butterfly (else apart)
  static constexpr int W = SQ ? K2 + 1 : K2;       // sums per row: 2p dots (and |f|^2)
  static constexpr int R = 4 * W <= 32 ? 4 : 2 * W <= 32 ? 2 : 1;   // rows per group
};

// dynamic shared memory at `ns` stages: the center table, the mask ring,
// and the feature ring, which the warps' tree (kWarps/2 slots of
// [2p][min(c, kPassCols)]) reuses at the end
constexpr size_t assign_smem_bytes(int c, int p, int esize, int ns) {
  const size_t ring = (size_t)ns * kStageRows * c * esize;
  const size_t tree = (size_t)kWarps / 2 * 2 * p * (c < pass_cols(p) ? c : pass_cols(p)) * 4;
  return (size_t)2 * p * c * 4 + (size_t)ns * 2 * kStageRows * 4 + (ring > tree ? ring : tree);
}

template <typename T, int P>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
assign_kernel(const T* __restrict__ fts, const float* __restrict__ fg,
              const float* __restrict__ bg, const float* __restrict__ ctr,
              float* __restrict__ num_part, float* __restrict__ den_part,
              int* __restrict__ tickets, float* __restrict__ protos,
              float* __restrict__ sm_out, int S, int SQ, int n, int c, int rows, int ns,
              int live_p, float eps) {
  using Shape = AssignShape<P>;
  constexpr int K2 = Shape::K2, W = Shape::W, R = Shape::R;
  constexpr bool HAS_SQ = Shape::SQ;
  constexpr int V = Vec<T>::N;
  constexpr int COLS = pass_cols(P);                 // channels a pass
  constexpr int NCH = COLS / (32 * V);               // 16-byte chunks per lane and pass
  const unsigned full = 0xffffffffu;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ctr_s = reinterpret_cast<float*>(smem_raw);           // [K2][c]
  float* mask_s = ctr_s + K2 * c;                               // [ns][2][kStageRows]
  T* ring = reinterpret_cast<T*>(mask_s + ns * 2 * kStageRows);  // [ns][kStageRows][c]
  __shared__ float csq_s[kMaxK2];
  __shared__ float den_s[kWarps][32];
  __shared__ float den_red_s[kMaxK2];
  __shared__ int last_s;

  const int t = blockIdx.x, tiles = gridDim.x;
  const int i = blockIdx.y;                     // support image in [0, B*S)
  const int z = blockIdx.z, passes = gridDim.z;  // column pass
  const int b = i / S;
  const int img = b * SQ + i % S;               // packed support row
  const int row0 = t * rows;
  const int nrows = min(rows, n - row0);
  const int stages = (nrows + kStageRows - 1) / kStageRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cv = c / V;                         // 16-byte chunks per row
  const int qz = z * 32 * NCH;                  // first chunk of the pass
  const int pc = min(c, COLS);                  // tree slot stride
  const T* src = fts + ((size_t)img * n + row0) * c;
  const float* mfg = fg + (size_t)i * n + row0;
  const float* mbg = bg + (size_t)i * n + row0;

  // stage st -> ring slot st % ns (rows past the block's last are zero-filled)
  auto issue = [&](int st) {
    if (st < stages) {
      const int r0 = st * kStageRows;
      T* dst = ring + (size_t)(st % ns) * kStageRows * c;
      for (int r = warp; r < kStageRows; r += kWarps) {
        const bool live = r0 + r < nrows;
        for (int q = lane; q < cv; q += 32)
          pemp::cp_async16(dst + (size_t)r * c + q * V,
                           live ? src + (size_t)(r0 + r) * c + q * V : src, live ? 16 : 0);
      }
      if (threadIdx.x < 2 * kStageRows) {
        const int cls = threadIdx.x / kStageRows, r = threadIdx.x % kStageRows;
        const bool live = r0 + r < nrows;
        pemp::cp_async4(mask_s + ((st % ns) * 2 + cls) * kStageRows + r,
                        (cls ? mbg : mfg) + (live ? r0 + r : 0), live ? 4 : 0);
      }
    }
    pemp::cp_async_commit();
  };

  // ctr [c][K2] is stored k-major, row k holding the V columns of chunk q
  // as V/4 float4 quarters h at [h][q], so a warp's float4 reads of a
  // quarter are consecutive. Its first kPassCols columns' (L2-resident)
  // lines are read before the ring's first stages are asked for, so they
  // are not queued behind them.
  auto put_ctr = [&](int idx, float4 v) {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ctr_s[tab_off<V>((4 * idx + e) % K2, (4 * idx + e) / K2, c)] = x[e];
    }
  };
  const int n_ctr4 = c * K2 / 4;
  constexpr int kCtr = K2 * kPassCols / 4 / kThreads < 8 ? K2 * kPassCols / 4 / kThreads : 8;
  float4 cv4[kCtr];
#pragma unroll
  for (int j = 0; j < kCtr; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    if (idx < n_ctr4) cv4[j] = __ldg(reinterpret_cast<const float4*>(ctr) + idx);
  }
  for (int st = 0; st < ns - 1; ++st) issue(st);
#pragma unroll
  for (int j = 0; j < kCtr; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    if (idx < n_ctr4) put_ctr(idx, cv4[j]);
  }
  for (int idx = threadIdx.x + kCtr * kThreads; idx < n_ctr4; idx += kThreads)
    put_ctr(idx, __ldg(reinterpret_cast<const float4*>(ctr) + idx));
  __syncthreads();
  table_norms_sq(ctr_s, csq_s, c, K2);                      // read after the loop's sync

  float acc[K2][NCH * V];
#pragma unroll
  for (int k = 0; k < K2; ++k)
#pragma unroll
    for (int j = 0; j < NCH * V; ++j) acc[k][j] = 0.f;
  float den = 0.f;
  // the sum lane `lane` holds after the butterfly: row my_r, column my_k
  const int my_r = lane / W, my_k = lane % W;
  const int kk = min(my_k, K2 - 1);
  const int cls = kk / P;

  for (int st = 0; st < stages; ++st) {
    issue(st + ns - 1);
    wait_ring(ns);
    __syncthreads();
    const T* tile = ring + (size_t)(st % ns) * kStageRows * c;
    const float* mk = mask_s + (st % ns) * 2 * kStageRows + cls * kStageRows;
    const int live_rows = min(kStageRows, nrows - st * kStageRows);
#pragma unroll
    for (int gi = 0; gi < kRowsPerWarp / R; ++gi) {
      const int g = warp * kRowsPerWarp + gi * R;
      if (g >= live_rows) break;                               // warp-uniform
      // per-lane partial dots and |f|^2 of rows g .. g+R-1, over all columns
      // (rows past the block's are zero-filled in the ring)
      float v[32], sqr[R];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) sqr[r] = 0.f;
      group_sums<T, K2, R, W, HAS_SQ>(tile, g, kStageRows, ctr_s, c, lane, v, sqr);
      float sq_apart = 0.f;
      if constexpr (!HAS_SQ) sq_apart = warp_sum(sqr[0]);       // R == 1
      reduce_scatter<16>(v, lane);
      const float tot = v[0];
      // softmax over each class's own p columns, R*2p lanes at once (a
      // padded column's distance is -inf: no share)
      const int rbase = my_r * W;
      const float sq = HAS_SQ ? __shfl_sync(full, tot, (rbase + K2) & 31) : sq_apart;
      const float dist = kk % P < live_p ? -(sq - 2.f * tot + csq_s[kk]) : -INFINITY;
      const int cbase = rbase + cls * P;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < P; ++j) mx = fmaxf(mx, __shfl_sync(full, dist, (cbase + j) & 31));
      const float ex = expf(dist - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) sum += __shfl_sync(full, ex, (cbase + j) & 31);
      const int row = g + my_r;
      const bool live = my_r < R && my_k < K2 && row < live_rows;
      const float a = live ? ex * (mk[min(row, kStageRows - 1)] / fmaxf(sum, 1e-30f)) : 0.f;
      den += a;
      // the class softmax of the row (unmasked), for the backward
      if (sm_out != nullptr && z == 0 && live)
        sm_out[((size_t)i * n + row0 + st * kStageRows + row) * K2 + kk] = ex / fmaxf(sum, 1e-30f);
      // a^T f on the lane's own columns of the pass
      float ar[R][K2];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < K2; ++k) ar[r][k] = __shfl_sync(full, a, r * W + k);
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int q = qz + lane + 32 * j;
        if (q < cv) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float x[V];
            Vec<T>::unpack(*reinterpret_cast<const uint4*>(tile + (size_t)(g + r) * c + q * V), x);
#pragma unroll
            for (int k = 0; k < K2; ++k)
#pragma unroll
              for (int e = 0; e < V; ++e) acc[k][j * V + e] += ar[r][k] * x[e];
          }
        }
      }
    }
    __syncthreads();                     // slot st % ns is refilled next iteration
  }
  pemp::cp_async_wait<0>();

  // the block's partial in a fixed order: a tree over the warps through
  // shared memory (the ring, as kWarps/2 slots of [K2][pc]); warp 0 ends
  // with the result
  den_s[warp][lane] = den;
  block_tree<K2, NCH, V>(acc, reinterpret_cast<float*>(ring), qz, cv, pc, warp, lane);
  // the cluster's partial: each block puts its own in shared memory, and
  // block `rank` sums slice `rank` of the kCluster partials in rank order
  // (distributed shared memory) into the scratch
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* red_s = reinterpret_cast<float*>(ring);             // [K2][pc]
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int q = qz + lane + 32 * j;
      if (q < cv) {
#pragma unroll
        for (int k = 0; k < K2; ++k)
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(red_s + k * pc + (q - qz) * V + e) =
                make_float4(acc[k][j * V + e], acc[k][j * V + e + 1],
                            acc[k][j * V + e + 2], acc[k][j * V + e + 3]);
      }
    }
    if (lane < K2) {
      float d = 0.f;
      for (int w = 0; w < kWarps; ++w)
        for (int l = lane; l < R * W; l += W) d += den_s[w][l];
      den_red_s[lane] = d;
    }
  }
  cluster.sync();
  const int cparts = tiles / kCluster;                       // cluster partials per image
  const size_t part = (size_t)i * cparts + t / kCluster;
  const int n_all = K2 * c;                                  // a multiple of 16
  const int pc4 = min(COLS, c - z * COLS) / 4;               // float4 columns of the pass
  const int n4 = K2 * pc4;
  for (int idx = n4 * rank / kCluster + threadIdx.x; idx < n4 * (rank + 1) / kCluster;
       idx += kThreads) {
    const int k = idx / pc4, col = idx % pc4 * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red_s, r) + k * pc + col);
      x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
    }
    *reinterpret_cast<float4*>(num_part + part * n_all + k * c + z * COLS + col) = x;
  }
  if (z == 0 && rank == 0 && threadIdx.x < K2) {
    float d = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) d += cluster.map_shared_rank(den_red_s, r)[threadIdx.x];
    den_part[part * K2 + threadIdx.x] = d;
  }
  cluster.sync();                          // the others' reads are done

  // the last block of episode b finishes it from the S * cparts partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(&tickets[b], 1) == S * tiles * passes - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // loads of kBatch partials are issued together, then summed in order
  constexpr int kBatch = 8;
  for (int idx = threadIdx.x; idx < n_all / 4; idx += kThreads) {
    const int k = idx * 4 / c;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const size_t p0 = (size_t)(b * S + s) * cparts;
      float4 nm = make_float4(0.f, 0.f, 0.f, 0.f);
      float dn = 0.f;
      for (int u0 = 0; u0 < cparts; u0 += kBatch) {
        float4 xs[kBatch];
        float ds[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (u0 + j < cparts) {
            xs[j] = __ldcg(reinterpret_cast<const float4*>(num_part + (p0 + u0 + j) * n_all) + idx);
            ds[j] = __ldcg(den_part + (p0 + u0 + j) * K2 + k);
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (u0 + j < cparts) {
            nm.x += xs[j].x; nm.y += xs[j].y; nm.z += xs[j].z; nm.w += xs[j].w;
            dn += ds[j];
          }
        }
      }
      dn += eps;
      out.x += nm.x / dn; out.y += nm.y / dn; out.z += nm.z / dn; out.w += nm.w / dn;
    }
    out.x /= (float)S; out.y /= (float)S; out.z /= (float)S; out.w /= (float)S;
    reinterpret_cast<float4*>(protos + (size_t)b * n_all)[idx] = out;
  }
  if (threadIdx.x == 0) atomicExch(&tickets[b], 0);
}

// ---------------------------------------------------------------------------
// K2: cosine matching of the query rows against the 2p prototypes of the
// episode, per-class max and first-occurrence argmax, output [bg, fg].
// Grid (T, B*Q), sized to the card: block t of query image i takes `rows`
// consecutive pixel rows.
//   - The episode's [2p][c] prototype table is read once per block into
//     shared memory, permuted for lanes on fixed columns, with its norms.
//   - Each warp streams its own rows through its own ring of `ns` stages
//     of kRowsPerWarp rows (16-byte cp.async, ns-1 stages in flight; rows
//     >= n are zero-filled and never written), the warps' stages
//     interleaved over the block's rows; a warp waits for its own copies
//     only (__syncwarp, no block barrier in the loop). Where not even two
//     stages fit beside the table (very wide c), ns = 0 and each lane
//     reads its chunks from device memory itself.
//   - A warp takes its stage's rows R at a time; each lane owns the same
//     16-byte column chunks for the whole kernel, so it reads its slice of
//     the table once per R rows. The R*(2p+1) sums (2p
//     dots and |q|^2 a row) meet in one reduce-scatter butterfly, and the
//     cosines, the per-class max and the first-occurrence argmax (strict >
//     in k order) run on the R*2p lanes that hold the dots; the lane of
//     each row's first fg column writes its logits and indices.
// Everything per row stays in registers (no local memory).
// ---------------------------------------------------------------------------
template <int P>
struct MatchShape {
  static constexpr int K2 = 2 * P;
  static constexpr bool SQ = K2 + 1 <= 32;         // |q|^2 in the butterfly (else apart)
  static constexpr int W = SQ ? K2 + 1 : K2;       // sums per row: 2p dots (and |q|^2)
  static constexpr int R = 4 * W <= 32 ? 4 : 2 * W <= 32 ? 2 : 1;   // rows per group
};

constexpr int kMatchStages = 3;                    // most ring stages

constexpr size_t match_smem_bytes(int c, int p, int esize, int ns) {
  return (size_t)2 * p * c * 4 + (size_t)ns * kStageRows * c * esize;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
match_kernel(const T* __restrict__ fts, const float* __restrict__ protos,
             float* __restrict__ logits, int* __restrict__ inds, int S, int Q, int SQ, int n,
             int c, int rows, int ns, int live_p, float dist_scalar, float cos_eps) {
  using Shape = MatchShape<P>;
  constexpr int K2 = Shape::K2, W = Shape::W, R = Shape::R;
  constexpr bool HAS_SQ = Shape::SQ;
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tab_s = reinterpret_cast<float*>(smem_raw);             // [K2][c] permuted
  T* ring = reinterpret_cast<T*>(tab_s + K2 * c);   // per warp [ns][kRowsPerWarp][c]
  __shared__ float pnsq_s[K2];

  const int i = blockIdx.y;                     // query image in [0, B*Q)
  const int b = i / Q;
  const int img = b * SQ + S + i % Q;           // packed query row
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, n - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cv = c / V;
  const T* src = fts + ((size_t)img * n + row0) * c;
  // warp stage st: the block's rows [r0, r0 + kRowsPerWarp), r0 =
  // (st * kWarps + warp) * kRowsPerWarp, in slot st % ns of the warp's ring
  const int bstages = (nrows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int wstages = bstages > warp ? (bstages - warp + kWarps - 1) / kWarps : 0;
  T* wring = ring + (size_t)warp * ns * kRowsPerWarp * c;

  // (rows past the block's last are zero-filled)
  auto issue = [&](int st) {
    if (st < wstages) {
      const int r0 = (st * kWarps + warp) * kRowsPerWarp;
      T* dst = wring + (size_t)(st % ns) * kRowsPerWarp * c;
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const bool live = r0 + r < nrows;
        for (int q = lane; q < cv; q += 32)
          cp_async16(dst + (size_t)r * c + q * V,
                     live ? src + (size_t)(r0 + r) * c + q * V : src, live ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // the table's (L2-resident) lines first, so they do not queue behind
  // the ring's first stages
  load_table_rows<V>(tab_s, 0, protos + (size_t)b * K2 * c, K2, c);
  for (int st = 0; st < ns - 1; ++st) issue(st);
  __syncthreads();
  table_norms_sq(tab_s, pnsq_s, c, K2);
  __syncthreads();

  // the sum lane `lane` holds after the butterfly: row my_r, column my_k
  const int my_r = lane / W, my_k = lane % W;
  const int kk = min(my_k, K2 - 1);
  const int cbase = my_r * W + kk / P * P;      // the lane's class: fg columns, then bg
  const float pn = sqrtf(fmaxf(pnsq_s[kk], 1e-30f));
  for (int st = 0; st < wstages; ++st) {
    const int r0 = (st * kWarps + warp) * kRowsPerWarp;
    const int live_rows = min(kRowsPerWarp, nrows - r0);
    if (ns > 0) {
      issue(st + ns - 1);
      wait_ring(ns);
      __syncwarp();                      // every lane's copies have landed
    }
#pragma unroll
    for (int gi = 0; gi < kRowsPerWarp / R; ++gi) {
      const int g = gi * R;
      if (g >= live_rows) break;                               // warp-uniform
      float v[32], sqr[R];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) sqr[r] = 0.f;
      if (ns > 0)
        group_sums<T, K2, R, W, HAS_SQ>(wring + (size_t)(st % ns) * kRowsPerWarp * c, g,
                                        live_rows, tab_s, c, lane, v, sqr);
      else
        group_sums<T, K2, R, W, HAS_SQ>(src + (size_t)r0 * c, g, live_rows, tab_s, c, lane, v,
                                        sqr);
      float sq_apart = 0.f;
      if constexpr (!HAS_SQ) sq_apart = warp_sum(sqr[0]);       // R == 1
      reduce_scatter<16>(v, lane);
      const float dot = v[0];
      const float sq = HAS_SQ ? __shfl_sync(kFull, dot, (my_r * W + K2) & 31) : sq_apart;
      const float sim = dot / fmaxf(sqrtf(fmaxf(sq, 1e-30f)) * pn, cos_eps) * dist_scalar;
      float best = __shfl_sync(kFull, sim, cbase & 31);
      int idx = 0;
#pragma unroll
      for (int j = 1; j < P; ++j) {
        const float s = __shfl_sync(kFull, sim, (cbase + j) & 31);
        if (j < live_p && s > best) {                  // a padded column never wins
          best = s;
          idx = j;
        }
      }
      const float bg_best = __shfl_sync(kFull, best, (my_r * W + P) & 31);
      const int bg_idx = __shfl_sync(kFull, idx, (my_r * W + P) & 31);
      const int row = g + my_r;
      if (my_k == 0 && my_r < R && row < live_rows) {
        const size_t o = (size_t)i * n + row0 + r0 + row;
        reinterpret_cast<float2*>(logits)[o] = make_float2(bg_best, best);
        if (inds != nullptr) reinterpret_cast<int2*>(inds)[o] = make_int2(bg_idx, idx);
      }
    }
    if (ns > 0) __syncwarp();            // slot st % ns is refilled next iteration
  }
  if (ns > 0) cp_async_wait<0>();
}

template <typename T>
using AssignFn = void (*)(const T*, const float*, const float*, const float*, float*, float*,
                          int*, float*, float*, int, int, int, int, int, int, int, float);

// the assign kernel instance for p (p is a template parameter: the
// accumulators are registers)
template <typename T>
AssignFn<T> assign_kernel_for(int p) {
  switch (p) {
    case 1: return assign_kernel<T, 1>;
    case 2: return assign_kernel<T, 2>;
    case 3: return assign_kernel<T, 3>;
    case 4: return assign_kernel<T, 4>;
    case 5: return assign_kernel<T, 5>;
    case 6: return assign_kernel<T, 6>;
    case 7: return assign_kernel<T, 7>;
    case 8: return assign_kernel<T, 8>;
    case 12: return assign_kernel<T, 12>;
    case 16: return assign_kernel<T, 16>;
    default: return nullptr;
  }
}

// ring stages of the assign kernel for (c, p): as many as fit in a
// block's shared memory (beside its static shared memory) on the current
// device, at most NS; 0 when not even kMinStages fit (or on a CUDA error)
template <typename T>
int assign_stages(int c, int p) {
  const AssignFn<T> kernel = assign_kernel_for<T>(p);
  int dev = 0, limit = 0;
  cudaFuncAttributes attr;
  if (kernel == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return 0;
  for (int ns = RingStages<T>::NS; ns >= kMinStages; --ns)
    if (assign_smem_bytes(c, p, sizeof(T), ns) + attr.sharedSizeBytes <= (size_t)limit) return ns;
  return 0;
}

template <typename T>
int assign_slots(int c, int p) {
  const AssignFn<T> kernel = assign_kernel_for<T>(p);
  const int ns = assign_stages<T>(c, p);
  if (kernel == nullptr || ns == 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = assign_smem_bytes(c, p, sizeof(T), ns);
  cudaError_t e = launch_config(kernel, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // blocks of whole clusters the device holds at once
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * sms, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters * kCluster : -(int)e;
}

template <typename T>
using MatchFn = void (*)(const T*, const float*, float*, int*, int, int, int, int, int, int,
                         int, int, float, float);

template <typename T>
MatchFn<T> match_kernel_for(int p) {
  switch (p) {
    case 1: return match_kernel<T, 1>;
    case 2: return match_kernel<T, 2>;
    case 3: return match_kernel<T, 3>;
    case 4: return match_kernel<T, 4>;
    case 5: return match_kernel<T, 5>;
    case 6: return match_kernel<T, 6>;
    case 7: return match_kernel<T, 7>;
    case 8: return match_kernel<T, 8>;
    case 12: return match_kernel<T, 12>;
    case 16: return match_kernel<T, 16>;
    default: return nullptr;
  }
}

template <typename T>
int match_plan(int c, int p, int* slots) {
  const MatchFn<T> kernel = match_kernel_for<T>(p);
  if (kernel == nullptr) return -1;
  return ring_plan(
      kernel, [=](int ns) { return match_smem_bytes(c, p, sizeof(T), ns); }, kMatchStages,
      slots);
}

template <typename T>
int match_launch(const void* fts, const void* protos, void* logits, void* inds, int B, int S,
                 int Q, int n, int c, int p, int live_p, int rows, int tiles, int ns,
                 float dist_scalar, float cos_eps, void* stream) {
  const MatchFn<T> kernel = match_kernel_for<T>(p);
  if (kernel == nullptr || ns == 1 || ns < 0 || ns > kMatchStages || live_p < 1 || live_p > p)
    return cudaErrorInvalidValue;
  const size_t smem = match_smem_bytes(c, p, sizeof(T), ns);
  const cudaError_t e = launch_config(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles, B * Q), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fts), static_cast<const float*>(protos), static_cast<float*>(logits),
      static_cast<int*>(inds), S, Q, S + Q, n, c, rows, ns, live_p, dist_scalar, cos_eps);
  return cudaGetLastError();
}

template <typename T>
int assign_launch(const void* fts, const void* fg, const void* bg, const void* ctr, void* num,
                  void* den, void* tickets, void* protos, void* sm, int B, int S, int Q, int n,
                  int c, int p, int live_p, int rows, int tiles, int ns, float eps,
                  void* stream) {
  const AssignFn<T> kernel = assign_kernel_for<T>(p);
  if (kernel == nullptr || ns < kMinStages || ns > RingStages<T>::NS || live_p < 1 || live_p > p)
    return cudaErrorInvalidValue;
  const size_t smem = assign_smem_bytes(c, p, sizeof(T), ns);
  const cudaError_t e = launch_config(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, B * S, (c + pass_cols(p) - 1) / pass_cols(p));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fts), static_cast<const float*>(fg), static_cast<const float*>(bg),
      static_cast<const float*>(ctr), static_cast<float*>(num), static_cast<float*>(den),
      static_cast<int*>(tickets), static_cast<float*>(protos), static_cast<float*>(sm), S, S + Q,
      n, c, rows, ns, live_p, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pemp_mpm_max_protos() { return kMaxProtos; }
int pemp_mpm_stage_rows() { return kStageRows; }
int pemp_mpm_cluster() { return kCluster; }
// the instance that runs p prototypes a class, and its column pass
int pemp_mpm_padded_protos(int p) { return padded_protos(p); }
int pemp_mpm_pass_channels(int p) { return pass_cols(padded_protos(p)); }

const char* pemp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Ring stages the assign kernel takes for (c, p) on the current device;
// 0 when its shared memory does not fit a block even at the fewest.
int pemp_mpm_assign_stages(int c, int p, int is_bf16) {
  return is_bf16 == kFeatureBf16 ? assign_stages<Feature>(c, p) : 0;
}

// Blocks of the assign kernel the current device holds at once (SMs x
// blocks per SM), or minus a CUDA error code.
int pemp_mpm_assign_slots(int c, int p, int is_bf16) {
  return is_bf16 == kFeatureBf16 ? assign_slots<Feature>(c, p) : -(int)cudaErrorInvalidValue;
}

// K1 on the instance p (padded_protos), live_p <= p columns a class live.
// fts [B, S+Q, n, c] (f32 or bf16), fg/bg [B*S, n] f32, ctr [c, 2p]
// f32; scratch num [B*S, tiles/2, 2p, c] and den [B*S, tiles/2, 2p] f32
// (one partial per 2-block cluster);
// tickets [B] int32, zero before the launch and after it; protos
// [B, 2p, c] f32 out (fg prototypes first, then bg); sm [B*S, n, 2p] f32
// out or NULL: each support row's class softmax before the mask (0 in a
// padded column), what the backward reads. Block t of a support
// image takes pixel rows [t*rows, min(n, (t+1)*rows)), tiles = cdiv(n,
// rows) rounded up to whole clusters, in cdiv(c, pass_cols(p)) column passes,
// with `ns` ring stages
// (pemp_mpm_assign_stages). Returns cudaGetLastError().
int pemp_mpm_assign(const void* fts, int is_bf16, const void* fg, const void* bg,
                    const void* ctr, void* num, void* den, void* tickets, void* protos, void* sm,
                    int B, int S, int Q, int n, int c, int p, int live_p, int rows, int tiles,
                    int ns, float eps, void* stream) {
  if (is_bf16 != kFeatureBf16) return cudaErrorInvalidValue;
  return assign_launch<Feature>(fts, fg, bg, ctr, num, den, tickets, protos, sm, B, S, Q, n, c,
                                p, live_p, rows, tiles, ns, eps, stream);
}

// Ring stages of the match kernel for (c, p) on the current device (2..3,
// or 0: rows read from device memory) and, in *slots, the blocks the
// device holds at once; -1 when not even its table fits a block.
int pemp_mpm_match_plan(int c, int p, int is_bf16, int* slots) {
  return is_bf16 == kFeatureBf16 ? match_plan<Feature>(c, p, slots) : -1;
}

// K2 on the instance p, live_p <= p columns a class live (the others
// never win). fts [B, S+Q, n, c] (f32 or bf16), protos [B, 2p, c] f32 (fg then bg),
// logits [B*Q, n, 2] f32 out ([bg, fg]), inds [B*Q, n, 2] i32 out or NULL.
// Block t of a query image takes pixel rows [t*rows, min(n, (t+1)*rows)),
// tiles = cdiv(n, rows), with `ns` ring stages (pemp_mpm_match_plan).
int pemp_mpm_match(const void* fts, int is_bf16, const void* protos, void* logits, void* inds,
                   int B, int S, int Q, int n, int c, int p, int live_p, int rows, int tiles,
                   int ns, float dist_scalar, float cos_eps, void* stream) {
  if (is_bf16 != kFeatureBf16) return cudaErrorInvalidValue;
  return match_launch<Feature>(fts, protos, logits, inds, B, S, Q, n, c, p, live_p, rows, tiles,
                               ns, dist_scalar, cos_eps, stream);
}

}  // extern "C"
