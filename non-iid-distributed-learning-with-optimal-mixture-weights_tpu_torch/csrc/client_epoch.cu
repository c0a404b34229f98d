// One local-SGD epoch of every client of a round, for the bias-free linear
// model (fedcore/epoch_kernel.py holds the wrapper, the launch plan and the
// plain version).
//
// Replaces the Pallas TPU kernel fedcore/pallas_kernel.py:_epoch_kernel of
// the JAX package. There the TPU's sequential grid walks the S batch steps of
// one client and vmap adds the client axis; here a thread-block cluster owns
// one client and loops over the client's non-empty steps itself. The CTAs
// gather their rows of X (N, D) through rows (J, S, B), so the (J, S, B, D)
// epoch buffer of the JAX path is never built.
//
// Per step, exactly as the TPU kernel: z = xb W^T; CE (logsumexp - label
// logit, top-1 by first max) or MSE (mean over C); masked mean over the
// valid rows; the hand-derived gradient plus mu * (w - anchor) / ||w - anchor||
// and lam * w / ||w|| with zero subgradient at 0, the norms taken on the W of
// before the update; no update when the batch has no valid rows; metrics
// (loss * cnt, correct, cnt) accumulated.
//
// What bounds it on the card: not the bytes (each valid row of X is read
// once, ~4 C fp32 flops per element, far below the fp32 ridge) but the
// longest client's serial chain of steps. Under a Dirichlet(0.01) split one
// client walks ~5x the mean client's steps, and the launch lasts as long as
// that client's S_max steps times the latency of one step. The design cuts
// that latency:
//  - D split over a cluster of k CTAs. Each CTA keeps its (C, Dk) slice of W
//    and of the prox anchor in shared memory, computes partial logits
//    (B, C) and the partial sums of squares of w - anchor and w over its
//    slice, and the cluster exchanges these B*C + 2 floats once per step
//    through distributed shared memory and one cluster barrier. Every CTA
//    sums the k partials in rank order, so all hold the same z and the
//    result is deterministic (no atomics).
//  - Asynchronous row staging. Each CTA copies its (n, Dk) slice of the
//    step's valid rows into shared memory, packed, with one cp.async.bulk
//    per row completing on an mbarrier (D % 4 == 0, X 16-byte aligned) or
//    element-wise cp.async otherwise. The copies of step t+1 are issued at
//    the start of step t, and the next step's row ids and flags are loaded
//    into registers one step earlier still, so neither waits on memory.
//    The backward pass reads the staged rows, not a second global gather.
//  - Largest clients first: the wrapper orders the clusters by each
//    client's count of non-empty steps, so a second wave of clusters holds
//    only short clients.
//  - The class count is a template parameter, exact for the class counts
//    of the registry's datasets (no dead FMA lanes at C = 10), up to 32
//    (the class-tiled kernel of plan 4 takes more).
// Everything is fp32 FMA (no tensor cores, no TF32): the tolerances of
// tests/test_pallas_kernel.py need it, and arithmetic is not the limit.
//
// Rows of X are read in the type they are stored in (RowT): float32, or,
// under the JAX package's feature_dtype, bfloat16 or float16. This file is
// built once per row type (cuda_build.BUILDS: -DCLIENT_EPOCH_ROWS_BF16,
// -DCLIENT_EPOCH_ROWS_F16), the three builds in parallel. 2-byte rows are
// staged as they are, which halves the ring, and widened to fp32 by the
// intrinsics as they are read (the product is fp32, as JAX promotes
// bf16 x f32); W, the anchor, z and the gradient stay fp32.
//
// Four plans, in the wrapper's order (epoch_kernel.launch_plan):
//  1. the staged kernel above, where a cluster of 1, 2, 4 or 8 CTAs holds
//     W's slices and two step tiles in shared memory;
//  2. the unstaged kernel, for batches too large to stage where W and the
//     anchor still fit one CTA whole: one CTA per client that gathers its
//     rows from global memory in both passes;
//  3. the wide kernel, for every other shape of at most 32 classes (a D past
//     the shared-memory limit, a batch past both): a cluster of k CTAs per
//     client as in the staged plan (k up to 16 where the card schedules a
//     16-CTA cluster; the wrapper picks k by how long a longest-first
//     schedule of the clients' steps over the clusters the card runs at
//     once would last, each step timed by a fit to the kernel's measured
//     times), 8 consumer warps and a producer warp. The producer streams
//     each step's rows, slice by slice in tiles of `tile` columns, through
//     a ring of `stages` stages in shared memory (one cp.async.bulk per row
//     per tile on the stage's full mbarrier; the consumers release a stage
//     on its empty mbarrier). The forward pass reads W's tile once for all
//     of a warp's rows, its partial logits in registers across tiles; the
//     gradient pass forms G_tile = dz^T X_tile from the ring and updates
//     the tile. W's and the anchor's slices stay in shared memory for the
//     launch where they fit beside the ring, else W is updated in place in
//     W_out; where one chunk takes the batch and the ring the whole slice,
//     a step's rows stay in their stages from one pass to the next. The
//     batch is worked in chunks of at most 8 warps' forward rows (8, 4, 2
//     or 1 a warp as the classes grow, so that a thread's 168 registers
//     hold them), one exchange of partial logits a chunk, read through
//     32-bit shared::cluster addresses; the loss gradient of the whole
//     batch and its packed row ids stay in shared memory where they fit,
//     else in a per-CTA global scratch. The ring's size does not grow with
//     D or B, so it takes any B and D. The sums of squares of the next
//     step's norms are folded into the update.
//  4. past 32 classes, at every B and D, the class-tiled wide kernel: the
//     wide kernel's cluster, slices, chunks, exchange and batch buffer
//     without its ring (W's slice in W_out, rows read from global memory
//     in both passes), C a run-time argument, one instantiation a row type.
//     Its forward pass carries two rows through one tile of 32 classes of
//     partial logits at a time (the rows read again for each tile), its
//     gradient pass 32 accumulators a column at a time (the column's rows
//     read again for each tile), and each row's loss is one warp's
//     row_loss_grad_tiled, an online logsumexp over the tiles that keeps
//     the first maximum. The chunk's logits (chunk x C rounded up to 4)
//     and the batch's loss gradient take the place of the instantiation's
//     class count in the layout, so the chunk shrinks as C grows (24 rows
//     at C = 1,000) and only a chunk of 8 rows' logits past a block's
//     shared memory (some 3,600 classes) bounds it. At C = 105 a step does
//     ~4 B D C flops a client against ~B D row reads: it may be bound by
//     operations, still fp32 FMA.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "row_loss.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxWideCluster = 16;  // non-portable, where the card takes it
constexpr int kSmemLimit = 232448;   // dynamic shared memory of one block
// header of the staged kernel's shared memory: 2 mbarriers, nrow[2],
// cnt[2], tot[2] (the cluster's sums of squares), padded to 16 bytes
constexpr int kHeaderBytes = 48;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reads of RowT elements widened to fp32: one, two (4 or 8 bytes aligned)
// or four (8 or 16 bytes aligned) at a time.
template <typename T>
struct Rows;

template <>
struct Rows<float> {
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float one(const float* p) { return *p; }
  static __device__ __forceinline__ float2 two(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float4 four(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Rows<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ float one(const T* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float2 two(const T* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ float4 four(const T* p) {
    const float2 lo = two(p), hi = two(p + 2);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

template <>
struct Rows<__half> {
  using T = __half;
  static __device__ __forceinline__ T zero() { return __float2half(0.f); }
  static __device__ __forceinline__ float one(const T* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ float2 two(const T* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  static __device__ __forceinline__ float4 four(const T* p) {
    const float2 lo = two(p), hi = two(p + 2);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

#if defined(CLIENT_EPOCH_ROWS_BF16)
using RowT = __nv_bfloat16;
#elif defined(CLIENT_EPOCH_ROWS_F16)
using RowT = __half;
#else
using RowT = float;
#endif
using R = Rows<RowT>;
// elements of a row in 16 bytes: a slice of this many starts 16-byte aligned
constexpr int kRowAlign = 16 / static_cast<int>(sizeof(RowT));

// ---------------------------------------------------------------------------
// The staged cluster kernel.

struct Args {
  const float* W0;      // (J, C, D)
  const float* anchor;  // (C, D)
  const RowT* X;        // (N, D)
  const int* y_cls;     // (N,) or null
  const float* y_reg;   // (N,) or null
  const int* rows;      // (J, S, B)
  const float* valid;   // (J, S, B)
  const int* order;     // (J,) client of each cluster, largest first
  const int* nsteps;    // (J,) non-empty steps of each client
  float* W_out;         // (J, C, D)
  float* metrics;       // (J, 3)
  int S, B, C, D, k, Dk, bulk;
  float lr, mu, lam;
};

struct Header {
  uint64_t mbar[2];
  int nrow[2];
  float cnt[2];
  float tot[2];
  float pad[2];
};
static_assert(sizeof(Header) == kHeaderBytes, "header layout");

// The slice width one CTA holds: ceil(D / k) rounded up to 16 bytes of
// rows (4 floats, 8 2-byte elements), so that every slice starts 16-byte
// aligned. The last slice may be narrower.
__host__ __device__ int slice_width(int D, int k) {
  return round_up((D + k - 1) / k, kRowAlign);
}

// Shared memory of one CTA, in bytes. Layout after the header, in floats:
// w (C*Dk), anchor (C*Dk); tile (2 stages * Bp * Dk RowT elements); in
// floats part (2 * PS), z (Bp*CP), row_loss (Bp), row_hit (Bp), row_w
// (2*Bp), red (2*kWarps); then row_id (2*Bp ints). Bp = B rounded up to 8,
// CP = the instantiated class count rounded up to 4, PS = 4 + Bp*CP.
size_t staged_smem_bytes(int B, int C, int NC, int D, int k) {
  const size_t Dk = slice_width(D, k), Bp = round_up(B, 8),
               CP = round_up(NC, 4), PS = 4 + Bp * CP;
  const size_t floats = 2 * (size_t)C * Dk + 2 * PS + Bp * CP + 2 * Bp +
                        2 * Bp + 2 * kWarps;
  return kHeaderBytes + (floats + 2 * Bp) * sizeof(float) +
         2 * Bp * Dk * sizeof(RowT);
}

// NC: the instantiated class count; EXACT: C == NC (no guard on the class
// loops), else C < NC and the classes from C on are skipped.
template <int NC, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    staged_epoch_kernel(const Args p) {
  // rows one warp carries through the forward pass at once
  constexpr int RB = NC <= 4 ? 8 : (NC <= 10 ? 4 : (NC <= 16 ? 2 : 1));
  constexpr int CP = round_up(NC, 4);
  const int C = EXACT ? NC : p.C;
  const int S = p.S, B = p.B, D = p.D, k = p.k, Dk = p.Dk;
  const int Bp = round_up(B, 8), PS = 4 + Bp * CP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = p.order[blockIdx.x / k];
  const int T = p.nsteps[j];
  const int d0 = rank * Dk;
  const int wd = max(0, min(Dk, D - d0));  // this CTA's columns of D

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Header* h = reinterpret_cast<Header*>(smem_raw);
  float* w = reinterpret_cast<float*>(smem_raw + kHeaderBytes);
  float* a = w + C * Dk;
  RowT* tile = reinterpret_cast<RowT*>(a + C * Dk);  // [2][Bp][Dk], packed
  // [2][PS]: sp, sr, -, -, z (Bp, CP)
  float* part = reinterpret_cast<float*>(tile + 2 * Bp * Dk);
  float* z = part + 2 * PS;          // [Bp][CP] logits, then dz
  float* row_loss = z + Bp * CP;
  float* row_hit = row_loss + Bp;
  float* row_w = row_hit + Bp;  // [2][Bp] valid weight of each packed row
  float* red = row_w + 2 * Bp;  // [2][kWarps]
  int* row_id = reinterpret_cast<int*>(red + 2 * kWarps);  // [2][Bp]

  const size_t CD = (size_t)C * D;
  const float* Wj = p.W0 + j * CD;
  for (int i = tid; i < C * Dk; i += kThreads) {
    const int c = i / Dk, d = i - c * Dk;
    const bool in = d < wd;
    w[i] = in ? Wj[(size_t)c * D + d0 + d] : 0.f;
    a[i] = in ? p.anchor[(size_t)c * D + d0 + d] : 0.f;
  }
  // the padding columns of both tiles stay 0 (copies write [0, wd) only),
  // so the slices' padded widths need no guard in the passes below
  const int padw = Dk - wd;
  for (int i = tid; i < 2 * Bp * padw; i += kThreads) {
    const int r = i / padw;
    tile[r * Dk + wd + (i - r * padw)] = R::zero();
  }
  if (tid == 0) {
    mbar_init(&h->mbar[0], 1);
    mbar_init(&h->mbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp 0's cursor over the client's steps, and the valid flag and row id
  // of lane b of the step at the cursor, loaded one step ahead of use.
  int look = 0;
  float look_v = 0.f;
  int look_r = 0;
  auto fetch = [&]() {
    if (look < S && lane < B) {
      const size_t base = ((size_t)j * S + look) * B;
      look_v = p.valid[base + lane];
      look_r = p.rows[base + lane];
    }
  };
  if (warp == 0) fetch();

  // Packs the next non-empty step's valid rows into stage st and starts
  // their copies. Called by all threads (element-wise copies need them).
  auto stage = [&](int st) {
    if (warp == 0) {
      int n = 0;
      for (;;) {  // a non-empty step remains: the caller counted them
        const size_t base = ((size_t)j * S + look) * B;
        for (int b0 = 0; b0 < B; b0 += 32) {
          const int b = b0 + lane;
          float v = 0.f;
          int r = 0;
          if (b0 == 0) {
            v = look_v;
            r = look_r;
          } else if (b < B) {
            v = p.valid[base + b];
            r = p.rows[base + b];
          }
          const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
          if (v != 0.f) {
            const int slot = n + __popc(m & ((1u << lane) - 1u));
            row_id[st * Bp + slot] = r;
            row_w[st * Bp + slot] = v;
          }
          n += __popc(m);
        }
        ++look;
        fetch();
        if (n > 0) break;
      }
      __syncwarp();
      if (lane == 0) {
        float cnt = 0.f;
        for (int q = 0; q < n; ++q) cnt += row_w[st * Bp + q];
        h->nrow[st] = n;
        h->cnt[st] = cnt;
      }
      if (p.bulk) {
        if (lane == 0) {
          if (wd > 0)
            mbar_expect_tx(&h->mbar[st],
                           (unsigned)(n * wd * sizeof(RowT)));
          else
            mbar_arrive(&h->mbar[st]);
        }
        __syncwarp();
        if (wd > 0)
          for (int q = lane; q < n; q += 32)
            bulk_copy(tile + (st * Bp + q) * Dk,
                      p.X + (size_t)row_id[st * Bp + q] * D + d0,
                      (unsigned)(wd * sizeof(RowT)), &h->mbar[st]);
      }
    }
    if (!p.bulk) {
      __syncthreads();
      const int n = h->nrow[st];
      for (int i = tid; i < n * wd; i += kThreads) {
        const int q = i / wd, d = i - q * wd;
        RowT* dst = tile + (st * Bp + q) * Dk + d;
        const RowT* src = p.X + (size_t)row_id[st * Bp + q] * D + d0 + d;
        if constexpr (sizeof(RowT) == 4)
          cp_async4(dst, src);
        else
          *dst = *src;  // cp.async moves 4 bytes at least: a plain copy
      }
      cp_async_commit();
    }
  };

  if (T > 0) stage(0);
  __syncthreads();

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // rank 0, thread 0
  for (int t = 0; t < T; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < T;
    if (more) stage(st ^ 1);
    if (p.bulk) {
      mbar_wait(&h->mbar[st], (unsigned)((t >> 1) & 1));
    } else {
      if (more)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const int n = h->nrow[st];
    const float cnt = h->cnt[st];
    const RowT* xt = tile + st * Bp * Dk;
    float* pc = part + (t & 1) * PS;

    // partial z over this slice: one warp per RB rows, lanes over float4
    // columns; then the partial sums of squares of w - anchor and w
    const int Q = Dk / 4;
    const int groups = (n + RB - 1) / RB;
    for (int g = warp; g < groups; g += kWarps) {
      float acc[RB][NC];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
      for (int q = lane; q < Q; q += 32) {
        float4 xv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          xv[r] = R::four(xt + (g * RB + r) * Dk + 4 * q);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          const float4 wv = *reinterpret_cast<const float4*>(w + c * Dk + 4 * q);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float s = acc[r][c];
            s = fmaf(xv[r].x, wv.x, s);
            s = fmaf(xv[r].y, wv.y, s);
            s = fmaf(xv[r].z, wv.z, s);
            s = fmaf(xv[r].w, wv.w, s);
            acc[r][c] = s;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          const float v = warp_sum(acc[r][c]);
          if (lane == 0 && g * RB + r < n) pc[4 + (g * RB + r) * CP + c] = v;
        }
      }
    }
    float sp = 0.f, sr = 0.f;
    for (int i = tid; i < C * Q; i += kThreads) {
      const float4 wv = *reinterpret_cast<const float4*>(w + 4 * i);
      const float4 av = *reinterpret_cast<const float4*>(a + 4 * i);
      const float dx = wv.x - av.x, dy = wv.y - av.y, dz = wv.z - av.z,
                  dw = wv.w - av.w;
      sp = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, fmaf(dw, dw, sp))));
      sr = fmaf(wv.x, wv.x,
                fmaf(wv.y, wv.y, fmaf(wv.z, wv.z, fmaf(wv.w, wv.w, sr))));
    }
    sp = warp_sum(sp);
    sr = warp_sum(sr);
    if (lane == 0) {
      red[warp] = sp;
      red[kWarps + warp] = sr;
    }
    __syncthreads();
    if (tid == 0) {
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < kWarps; ++q) {
        s0 += red[q];
        s1 += red[kWarps + q];
      }
      pc[0] = s0;
      pc[1] = s1;
    }

    // the one exchange of the step: every CTA sums the k partials in rank
    // order. part is double-buffered by step, and a CTA writes step t+2's
    // partials only after the barrier of step t+1, which every CTA reaches
    // after reading step t's.
    cluster.sync();
    for (int i = tid; i < 4 + n * CP; i += kThreads) {
      if (i == 2 || i == 3) continue;
      if (i >= 4 && (i - 4) % CP >= C) continue;
      float v = 0.f;
      for (int q = 0; q < k; ++q) v += cluster.map_shared_rank(pc, q)[i];
      if (i < 2)
        h->tot[i] = v;
      else
        z[i - 4] = v;
    }
    __syncthreads();

    // per row: loss, top-1 hit, and dz (overwrites z), scaled by w_b / cnt
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    for (int b = tid; b < n; b += kThreads) {
      const float bv = row_w[st * Bp + b];
      float hit;
      row_loss[b] = row_loss_grad(z + b * CP, C, p.y_cls, p.y_reg,
                                  row_id[st * Bp + b], bv * inv_cnt, &hit) *
                    bv;
      row_hit[b] = hit * bv;
    }
    __syncthreads();
    const float sq_p = h->tot[0], sq_r = h->tot[1];
    const float norm_p = sq_p > 0.f ? sqrtf(sq_p) : 0.f;
    const float norm_r = sq_r > 0.f ? sqrtf(sq_r) : 0.f;
    if (rank == 0 && tid == 0) {
      float dl = 0.f, hit = 0.f;
      for (int b = 0; b < n; ++b) {
        dl += row_loss[b];
        hit += row_hit[b];
      }
      const float loss = dl * inv_cnt + p.mu * norm_p + p.lam * norm_r;
      acc_loss += loss * cnt;
      acc_hit += hit;
      acc_cnt += cnt;
    }

    // grad[c, d] = sum_b dz[b, c] x_b[d] + penalties over this slice, two
    // columns a thread, the staged rows read from shared memory
    for (int pi = tid; pi < Dk / 2; pi += kThreads) {
      float g0[NC], g1[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) g0[c] = g1[c] = 0.f;
      for (int b = 0; b < n; ++b) {
        const float2 xv = R::two(xt + b * Dk + 2 * pi);
#pragma unroll
        for (int c4 = 0; c4 < CP / 4; ++c4) {
          const float4 dz4 =
              *reinterpret_cast<const float4*>(z + b * CP + 4 * c4);
          const float dzv[4] = {dz4.x, dz4.y, dz4.z, dz4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * c4 + e;
            if (c < NC) {
              g0[c] = fmaf(dzv[e], xv.x, g0[c]);
              g1[c] = fmaf(dzv[e], xv.y, g1[c]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!EXACT && c >= C) break;
        const int i = c * Dk + 2 * pi;
        float2 wv = *reinterpret_cast<float2*>(w + i);
        const float2 av = *reinterpret_cast<const float2*>(a + i);
        float gx = g0[c], gy = g1[c];
        if (sq_p > 0.f) {
          gx += p.mu * ((wv.x - av.x) / fmaxf(norm_p, 1e-30f));
          gy += p.mu * ((wv.y - av.y) / fmaxf(norm_p, 1e-30f));
        }
        if (sq_r > 0.f) {
          gx += p.lam * (wv.x / fmaxf(norm_r, 1e-30f));
          gy += p.lam * (wv.y / fmaxf(norm_r, 1e-30f));
        }
        wv.x -= p.lr * gx;
        wv.y -= p.lr * gy;
        *reinterpret_cast<float2*>(w + i) = wv;
      }
    }
    // this step's tile, rows and z are free, and w is updated
    __syncthreads();
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();

  float* Wo = p.W_out + j * CD;
  for (int i = tid; i < C * Dk; i += kThreads) {
    const int c = i / Dk, d = i - c * Dk;
    if (d < wd) Wo[(size_t)c * D + d0 + d] = w[i];
  }
  if (rank == 0 && tid == 0) {
    p.metrics[j * 3 + 0] = acc_loss;
    p.metrics[j * 3 + 1] = acc_hit;
    p.metrics[j * 3 + 2] = acc_cnt;
  }
}

template <int NC, bool EXACT>
cudaError_t launch_staged(const Args& p, int J, cudaStream_t stream) {
  const size_t smem = staged_smem_bytes(p.B, p.C, NC, p.D, p.k);
  auto kern = staged_epoch_kernel<NC, EXACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(J * p.k));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The class counts with an exact instantiation (the registry's datasets:
// 1 regression output; 3, 6, 10 and 26 classes; 2 for binary data); any
// other C runs the next of 4, 8, 16, 32 with its classes from C on skipped.
template <typename F>
cudaError_t dispatch_classes(int C, F&& f) {
  using std::integral_constant;
  switch (C) {
    case 1: return f(integral_constant<int, 1>{}, std::true_type{});
    case 2: return f(integral_constant<int, 2>{}, std::true_type{});
    case 3: return f(integral_constant<int, 3>{}, std::true_type{});
    case 6: return f(integral_constant<int, 6>{}, std::true_type{});
    case 10: return f(integral_constant<int, 10>{}, std::true_type{});
    case 26: return f(integral_constant<int, 26>{}, std::true_type{});
    default: break;
  }
  if (C < 1) return cudaErrorInvalidValue;
  if (C <= 4) return f(integral_constant<int, 4>{}, std::false_type{});
  if (C <= 8) return f(integral_constant<int, 8>{}, std::false_type{});
  if (C <= 16) return f(integral_constant<int, 16>{}, std::false_type{});
  if (C <= 32) return f(integral_constant<int, 32>{}, std::false_type{});
  return cudaErrorInvalidValue;
}

int instantiated_classes(int C) {
  int nc = 0;
  dispatch_classes(C, [&](auto n, auto) {
    nc = decltype(n)::value;
    return cudaSuccess;
  });
  return nc;
}

// ---------------------------------------------------------------------------
// The unstaged kernel: one CTA per client, W and the anchor whole in shared
// memory, rows gathered from global memory in both passes. Only batches too
// large to stage run it.

__device__ __forceinline__ void block_sum2(float& a, float& b, float* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    a += scratch[w];
    b += scratch[kWarps + w];
  }
  __syncthreads();
}

// Shared memory, in floats: w (C*D), anchor (C*D), z/dz (B*C), row_loss (B),
// row_hit (B), row_ok (B), scratch (2*kWarps); then row_id (B ints).
size_t unstaged_smem_bytes(int B, int C, int D) {
  return (2 * (size_t)C * D + (size_t)B * C + 3 * (size_t)B + 2 * kWarps) *
             sizeof(float) +
         (size_t)B * sizeof(int);
}

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
    unstaged_epoch_kernel(const float* __restrict__ W0,
                          const float* __restrict__ anchor,
                          const RowT* __restrict__ X,
                          const int* __restrict__ y_cls,
                          const float* __restrict__ y_reg,
                          const int* __restrict__ rows,
                          const float* __restrict__ valid,
                          float* __restrict__ W_out,
                          float* __restrict__ metrics, int S, int B, int C,
                          int D, float lr, float mu, float lam) {
  extern __shared__ float smem[];
  const int CD = C * D;
  float* w = smem;
  float* a = w + CD;
  float* z = a + CD;
  float* row_loss = z + B * C;
  float* row_hit = row_loss + B;
  float* row_ok = row_hit + B;
  float* scratch = row_ok + B;
  int* row_id = reinterpret_cast<int*>(scratch + 2 * kWarps);

  const int j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Wj = W0 + (size_t)j * CD;
  for (int i = tid; i < CD; i += kThreads) {
    w[i] = Wj[i];
    a[i] = anchor[i];
  }

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // thread 0's
  for (int s = 0; s < S; ++s) {
    __syncthreads();
    const size_t base = ((size_t)j * S + s) * B;
    for (int b = tid; b < B; b += kThreads) {
      row_id[b] = rows[base + b];
      row_ok[b] = valid[base + b];
    }
    __syncthreads();
    float cnt = 0.f;
    for (int b = 0; b < B; ++b) cnt += row_ok[b];
    if (cnt == 0.f) continue;  // block-uniform
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);

    for (int b = warp; b < B; b += kWarps) {
      if (row_ok[b] == 0.f) continue;  // warp-uniform
      const RowT* xr = X + (size_t)row_id[b] * D;
      float acc[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float xv = R::one(xr + d);
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) acc[c] = fmaf(xv, w[c * D + d], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          const float v = warp_sum(acc[c]);
          if (lane == 0) z[b * C + c] = v;
        }
      }
    }
    __syncthreads();

    for (int b = tid; b < B; b += kThreads) {
      float* zb = z + b * C;
      const float bv = row_ok[b];
      if (bv == 0.f) {
        for (int c = 0; c < C; ++c) zb[c] = 0.f;
        row_loss[b] = 0.f;
        row_hit[b] = 0.f;
        continue;
      }
      float hit;
      row_loss[b] = row_loss_grad(zb, C, y_cls, y_reg, row_id[b],
                                  bv * inv_cnt, &hit) * bv;
      row_hit[b] = hit * bv;
    }

    float sp = 0.f, sr = 0.f;
    for (int i = tid; i < CD; i += kThreads) {
      const float wv = w[i];
      const float dv = wv - a[i];
      sp = fmaf(dv, dv, sp);
      sr = fmaf(wv, wv, sr);
    }
    block_sum2(sp, sr, scratch);
    const float norm_p = sp > 0.f ? sqrtf(sp) : 0.f;
    const float norm_r = sr > 0.f ? sqrtf(sr) : 0.f;
    if (tid == 0) {
      float dl = 0.f, hit = 0.f;
      for (int b = 0; b < B; ++b) {
        dl += row_loss[b];
        hit += row_hit[b];
      }
      const float loss = dl * inv_cnt + mu * norm_p + lam * norm_r;
      acc_loss += loss * cnt;
      acc_hit += hit;
      acc_cnt += cnt;
    }

    for (int d = tid; d < D; d += kThreads) {
      float g[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) g[c] = 0.f;
      for (int b = 0; b < B; ++b) {
        if (row_ok[b] == 0.f) continue;
        const float xv = R::one(X + (size_t)row_id[b] * D + d);
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (c < C) g[c] = fmaf(z[b * C + c], xv, g[c]);
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          const int i = c * D + d;
          const float wv = w[i];
          float gc = g[c];
          if (sp > 0.f) gc += mu * ((wv - a[i]) / fmaxf(norm_p, 1e-30f));
          if (sr > 0.f) gc += lam * (wv / fmaxf(norm_r, 1e-30f));
          w[i] = wv - lr * gc;
        }
      }
    }
  }
  __syncthreads();
  float* Wo = W_out + (size_t)j * CD;
  for (int i = tid; i < CD; i += kThreads) Wo[i] = w[i];
  if (tid == 0) {
    metrics[j * 3 + 0] = acc_loss;
    metrics[j * 3 + 1] = acc_hit;
    metrics[j * 3 + 2] = acc_cnt;
  }
}

// ---------------------------------------------------------------------------
// The wide kernels: the shapes neither kernel above takes.

struct WideArgs {
  const float* W0;      // (J, C, D)
  const float* anchor;  // (C, D)
  const RowT* X;        // (N, D)
  const int* y_cls;     // (N,) or null
  const float* y_reg;   // (N,) or null
  const int* rows;      // (J, S, B)
  const float* valid;   // (J, S, B)
  const int* order;     // (J,) client of each cluster, largest first
  const int* nsteps;    // (J,) non-empty steps of each client
  float* W_out;         // (J, C, D)
  float* metrics;       // (J, 3)
  float* scratch;       // (J*k, wide_batch_floats) or null: the batch buffer
  int S, B, C, D, k, Dk, chunk;
  // the ring of wide_epoch_kernel (the class-tiled kernel ignores them):
  // columns of a stage, stages, W and the anchor held in shared memory, the
  // step's rows held there from the forward pass to the gradient pass,
  // cp.async.bulk row copies
  int tile, stages, w_res, rows_res, bulk;
  float lr, mu, lam;
};

// step header: packed rows, their weight, the cluster's sums of squares
struct WideHeader {
  int n;
  float cnt;
  float tot[2];
};
constexpr int kWideHeaderBytes = sizeof(WideHeader);
static_assert(kWideHeaderBytes == 16, "wide header layout");

// The batch buffer of one CTA, in floats: the packed valid rows' ids (Bp
// ints) and weights (Bp), then d loss / dz of each (Bp * CP).
__host__ __device__ size_t wide_batch_floats(int B, int NC) {
  return (size_t)round_up(B, 8) * (round_up(NC, 4) + 2);
}

// Shared memory of one CTA of the class-tiled wide kernel, and the part
// the wide kernel's layout starts with: the header, then in floats the
// double-buffered exchange (2 * (4 + chunk*CP)), the chunk's row loss and
// hits (2 * chunk) and the block sums (2 * kWarps); then the batch buffer
// when `hold` keeps it in shared memory.
__host__ __device__ size_t wide_smem_bytes(int B, int NC, int chunk,
                                           bool hold) {
  const size_t CP = round_up(NC, 4);
  const size_t floats = 2 * (4 + (size_t)chunk * CP) + 2 * (size_t)chunk +
                        2 * kWarps;
  return kWideHeaderBytes + floats * sizeof(float) +
         (hold ? wide_batch_floats(B, NC) * sizeof(float) : 0);
}

// The wide kernel's ring: 8 consumer warps and one producer warp.
constexpr int kRingThreads = kThreads + 32;
constexpr int kRingMaxStages = 16;
constexpr int kRingTile = 256;  // the widest stage, in columns

// rows one consumer warp carries through the forward pass: its partial
// logits (rows x NC) stay in registers over the slice's tiles, so a chunk
// holds at most kWarps * ring_rows rows. One row past 16 classes: with two,
// 9 warps' 168 registers a thread spill at NC = 26 and 32.
__host__ __device__ constexpr int ring_rows(int NC) {
  return NC <= 4 ? 8 : (NC <= 10 ? 4 : (NC <= 16 ? 2 : 1));
}

// the ring's mbarriers: each stage full (the producer's copies landed) and
// empty (every consumer warp is done with it); the batch buffer full (the
// step's rows packed) and empty (the consumers are done with its ids).
// Then rank 0's running metrics of its client (loss * cnt, hits, cnt) and
// the step's summed row losses, in shared memory rather than in thread 0's
// registers, which the forward pass and the exchange need.
struct RingHeader {
  uint64_t full[kRingMaxStages];
  uint64_t empty[kRingMaxStages];
  uint64_t batch_full;
  uint64_t batch_empty;
  float met[4];
};
static_assert(sizeof(RingHeader) % 16 == 0, "ring header layout");

// the shared::cluster address of this CTA's shared address `a` in CTA
// `rank` of the cluster, and a float read there: 32-bit addresses, where
// cluster.map_shared_rank gives 64-bit generic ones
__device__ __forceinline__ uint32_t cluster_map(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(a)
               : "memory");
  return v;
}

// Shared memory of one CTA of the wide kernel: wide_smem_bytes' layout
// (chunk, NC, the batch buffer when held), rounded to 16 bytes; the ring's
// header; W's and the anchor's (C, Dk) slices when w_res holds them; and
// `stages` stages of (chunk, tile) row elements.
size_t ring_smem_bytes(int B, int C, int NC, int Dk, int chunk, int tile,
                       int stages, bool w_res, bool hold) {
  return round_up((int)wide_smem_bytes(B, NC, chunk, hold), 16) +
         sizeof(RingHeader) +
         (w_res ? 2 * (size_t)C * Dk * sizeof(float) : 0) +
         (size_t)stages * chunk * tile * sizeof(RowT);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// block_sum2 over the consumer warps only (named barrier 1)
__device__ __forceinline__ void consumer_sum2(float& a, float& b,
                                              float* scratch) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  consumer_sync();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    a += scratch[w];
    b += scratch[kWarps + w];
  }
  consumer_sync();
}

// the two halves of cluster.sync(), for the producer warp, which arrives at
// an exchange as soon as it has issued the chunk's copies and waits only
// before it arrives at the next
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

#ifdef CLIENT_EPOCH_PHASE_CLOCKS
// A measurement build only (tools/client_epoch_phases.py compiles this file
// with -DCLIENT_EPOCH_PHASE_CLOCKS): clock64 cycles that CTA 0 (rank 0 of
// the client with the most steps) spends in each phase of the wide
// kernel's steps, summed over its last launch. Consumer thread 0: 0 wait
// for the packed batch, 1 wait for forward tiles, 2 forward FMAs, 3 warp
// sums of the partial logits, 4 the cluster barrier, 5 the exchange's
// DSMEM reads, 6 the row losses, 7 wait for gradient tiles, 8 gradient
// FMAs, 9 the update, 10 the block sums. Producer lane 0: 11 wait for an
// empty stage, 12 issuing copies, 13 wait for the batch buffer, 14 packing
// a step's rows, 15 the cluster barrier's arrive and wait.
constexpr int kWidePhases = 16;
__device__ unsigned long long wide_phase_clocks[kWidePhases];
#define WPHASE(i)                     \
  if (timing) {                       \
    const long long now_ = clock64(); \
    ph[i] += now_ - t_last;           \
    t_last = now_;                    \
  }
#else
#define WPHASE(i)
#endif

// Plan 3. A cluster of k CTAs per client, each owning a slice of Dk columns
// of D, as the staged kernel; per step the chunks of the packed valid rows
// (at most kWarps * ring_rows rows, one DSMEM exchange of partial logits
// each) and, per chunk, the slice in tiles of `tile` columns.
//  - Warp 8, the producer, packs each step's valid rows (their ids and
//    weights into the batch buffer) and streams their tiles through a ring
//    of `stages` stages of (chunk, tile) elements: one cp.async.bulk per
//    row per tile completing on the stage's full mbarrier (element-wise
//    copies where a row or X is not 16-byte aligned), each stage reissued
//    once all 8 consumer warps have released it on its empty mbarrier. It
//    runs ahead of the consumers by the depth of the ring, across passes
//    and steps, and takes part in the cluster's barriers without waiting
//    on them until it must.
//  - The forward pass: each consumer warp carries ring_rows rows of the
//    chunk over every tile of the slice, lanes over float4 columns, its
//    partial logits in registers; W's tile is read once a tile for all of
//    the warp's rows (all 8 warps read the same tile at the same time).
//  - The gradient pass: per tile a thread a column, G_tile = dz^T X_tile
//    over the step's rows (every chunk's, from the ring, the row loop
//    unrolled), then the prox and ridge terms and the update, and the next
//    step's sums of squares folded in.
//  - W's and the anchor's slices live in shared memory for the launch where
//    they fit beside the ring (w_res; W_out written once at the end); else
//    W is updated in place in W_out and each W and anchor tile is read once
//    a step in each pass. Where one chunk holds the batch and the ring holds
//    the whole slice (rows_res), the step's tiles stay in their stages from
//    the forward pass to the gradient pass: rows are read once a step.
//  - Rounded instantiations (C < NC) clamp their class loads to the last
//    class and drop what they compute: no load waits behind a branch.
template <int NC, bool EXACT>
__global__ void __launch_bounds__(kRingThreads, 1)
    wide_epoch_kernel(const WideArgs p) {
  constexpr int RB = ring_rows(NC);
  constexpr int CP = round_up(NC, 4);
  const int C = EXACT ? NC : p.C;
  const int B = p.B, D = p.D, k = p.k, Dk = p.Dk, Bc = p.chunk;
  const int Dt = p.tile, NS = p.stages;
  const int Bp = round_up(B, 8), PS = 4 + Bc * CP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = p.order[blockIdx.x / k];
  const int T = p.nsteps[j];
  const int d0 = rank * Dk;
  const int wd = max(0, min(Dk, D - d0));  // this CTA's columns of D
  const int ntiles = (wd + Dt - 1) / Dt;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideHeader* h = reinterpret_cast<WideHeader*>(smem_raw);
  // [2][PS]: sp, sr, -, -, z (chunk, CP)
  float* part = reinterpret_cast<float*>(smem_raw + kWideHeaderBytes);
  float* row_loss = part + 2 * PS;
  float* row_hit = row_loss + Bc;
  float* red = row_hit + Bc;  // [2][kWarps]
  const bool hold = p.scratch == nullptr;
  float* batch = hold ? red + 2 * kWarps
                      : p.scratch + blockIdx.x * wide_batch_floats(B, NC);
  int* row_id = reinterpret_cast<int*>(batch);
  float* row_w = batch + Bp;
  float* dz = row_w + Bp;  // [Bp][CP]: the summed logits, then d loss / dz
  RingHeader* bars = reinterpret_cast<RingHeader*>(
      smem_raw + round_up((int)wide_smem_bytes(B, NC, Bc, hold), 16));
  float* ws = reinterpret_cast<float*>(bars + 1);  // (C, Dk) when w_res
  float* as = ws + C * Dk;
  RowT* ring = reinterpret_cast<RowT*>(p.w_res ? as + C * Dk : ws);
  const int stage_elems = Bc * Dt;
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  const bool timing = blockIdx.x == 0 && (tid == 0 || tid == kThreads);
  long long ph[kWidePhases] = {};
  long long t_last = clock64();
#endif

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], kWarps);
    }
    mbar_init(&bars->batch_full, 1);
    mbar_init(&bars->batch_empty, 1);
    for (int i = 0; i < 4; ++i) bars->met[i] = 0.f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const size_t CD = (size_t)C * D;
  float* Wo = p.W_out + j * CD;

  if (warp == kWarps) {
    // ---- the producer warp ----
    int look = 0;  // cursor over the client's steps
    // packs the next non-empty step's valid rows (one remains: the caller
    // counted them) into the batch buffer; returns their count
    auto pack = [&]() -> int {
      for (;;) {
        const size_t base = ((size_t)j * p.S + look) * B;
        int n = 0;
        float cnt = 0.f;
        for (int b0 = 0; b0 < B; b0 += 32) {
          const int b = b0 + lane;
          float v = 0.f;
          int r = 0;
          if (b < B) {
            v = p.valid[base + b];
            r = p.rows[base + b];
          }
          const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
          if (v != 0.f) {
            const int slot = n + __popc(m & ((1u << lane) - 1u));
            row_id[slot] = r;
            row_w[slot] = v;
          }
          n += __popc(m);
          cnt += warp_sum(v);
        }
        ++look;
        if (n > 0) {
          if (lane == 0) {
            h->n = n;
            h->cnt = cnt;
          }
          return n;
        }
      }
    };
    // copies rows [q0, q0 + nc) of the batch, tile tl of the slice, into
    // ring entry ri's stage, once its last use is released
    auto issue = [&](int ri, int q0, int nc, int tl) {
      const int s = ri % NS, u = ri / NS;
      WPHASE(12);
      if (u > 0) mbar_wait(&bars->empty[s], (unsigned)((u - 1) & 1));
      WPHASE(11);
      RowT* dst = ring + s * stage_elems;
      const int c0 = tl * Dt, wt = min(Dt, wd - c0);
      const RowT* src = p.X + d0 + c0;
      if (p.bulk) {
        if (lane == 0)
          mbar_expect_tx(&bars->full[s], (unsigned)(nc * wt * sizeof(RowT)));
        __syncwarp();
        for (int r = lane; r < nc; r += 32)
          bulk_copy(dst + r * Dt, src + (size_t)row_id[q0 + r] * D,
                    (unsigned)(wt * sizeof(RowT)), &bars->full[s]);
      } else {
        for (int i = lane; i < nc * wt; i += 32) {
          const int r = i / wt, d = i - r * wt;
          RowT* e = dst + r * Dt + d;
          const RowT* x = src + (size_t)row_id[q0 + r] * D + d;
          if constexpr (sizeof(RowT) == 4)
            cp_async4(e, x);
          else
            *e = *x;  // cp.async moves 4 bytes at least: a plain copy
        }
        if constexpr (sizeof(RowT) == 4) {
          cp_async_commit();
          cp_async_wait<0>();
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&bars->full[s]);
      }
    };
    int ri = 0;
    bool pending = false;  // arrived at an exchange not yet waited on
    for (int t = 0; t < T; ++t) {
      WPHASE(12);
      if (t > 0) mbar_wait(&bars->batch_empty, (unsigned)((t - 1) & 1));
      WPHASE(13);
      const int n = pack();
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars->batch_full);
      WPHASE(14);
      const int nch = (n + Bc - 1) / Bc;
      for (int e = 0; e < nch; ++e) {
        for (int tl = 0; tl < ntiles; ++tl)
          issue(ri++, e * Bc, min(Bc, n - e * Bc), tl);
        WPHASE(12);
        if (pending) cluster_wait();
        cluster_arrive();
        pending = true;
        WPHASE(15);
      }
      if (!p.rows_res)
        for (int tl = 0; tl < ntiles; ++tl)
          for (int e = 0; e < nch; ++e)
            issue(ri++, e * Bc, min(Bc, n - e * Bc), tl);
    }
    WPHASE(12);
    if (pending) cluster_wait();
    WPHASE(15);
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
    if (timing)
      for (int i = 11; i < kWidePhases; ++i) wide_phase_clocks[i] = ph[i];
#endif
    cluster.sync();  // the consumers' last
    return;
  }

  // ---- the 8 consumer warps ----
  // W's slice (to shared memory, or W_out starts as W0) and the sums of
  // squares of w - anchor and w over it, then over the CTA, kept for the
  // first exchange
  const float* Wj = p.W0 + j * CD;
  float sp = 0.f, sr = 0.f;
  for (int c = 0; c < C; ++c) {
    for (int d = tid; d < wd; d += kThreads) {
      const size_t i = (size_t)c * D + d0 + d;
      const float wv = Wj[i];
      const float av = p.anchor[i];
      if (p.w_res) {
        ws[c * Dk + d] = wv;
        as[c * Dk + d] = av;
      } else {
        Wo[i] = wv;
      }
      const float dv = wv - av;
      sp = fmaf(dv, dv, sp);
      sr = fmaf(wv, wv, sr);
    }
  }
  consumer_sum2(sp, sr, red);

  // where the forward pass reads W's tiles: 0 the slice in shared memory,
  // 1 W_out in float4s (D % 4 == 0: aligned), 2 W_out a float at a time.
  // Each is its own code path, so that shared addresses stay 32-bit.
  const int wsrc = p.w_res ? 0 : (D % 4 == 0 ? 1 : 2);
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&bars->empty[s]);
  };

  float* met = bars->met;  // rank 0, thread 0
  int ex = 0;  // exchanges so far: part is double-buffered by exchange
  int ri = 0;  // ring entries consumed
  for (int t = 0; t < T; ++t) {
    WPHASE(10);
    mbar_wait(&bars->batch_full, (unsigned)(t & 1));
    WPHASE(0);
    const int n = h->n;
    const float cnt = h->cnt;
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    const int nch = (n + Bc - 1) / Bc;

    for (int e = 0; e < nch; ++e, ++ex) {
      const int q0 = e * Bc, nc = min(Bc, n - q0);
      float* pc = part + (ex & 1) * PS;
      // partial z of the chunk's rows over this slice: warp w carries rows
      // r0 .. r0 + RB (clamped to the chunk, the extra dropped) over every
      // tile; lanes over float4 columns
      const int r0 = warp * RB;
      float acc[RB][NC];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
      auto forward = [&](auto src_tag) {
        constexpr int SRC = decltype(src_tag)::value;
        const float* wsl;
        int wstride;
        if constexpr (SRC == 0) {
          wsl = ws;
          wstride = Dk;
        } else {
          wsl = Wo + d0;
          wstride = D;
        }
        for (int tl = 0; tl < ntiles; ++tl, ++ri) {
          const int s = ri % NS;
          mbar_wait(&bars->full[s], (unsigned)((ri / NS) & 1));
          WPHASE(1);
          if (r0 < nc) {
            const RowT* xs = ring + s * stage_elems;
            const int c0 = tl * Dt, wt = min(Dt, wd - c0), q4 = wt >> 2;
            const float* wt0 = wsl + c0;
            auto xrow = [&](int r) { return xs + min(r0 + r, nc - 1) * Dt; };
            auto wrow = [&](int c) {
              return wt0 + (EXACT ? c : min(c, C - 1)) * wstride;
            };
            // at most two float4s a lane (tile <= 256)
#pragma unroll 1
            for (int q = lane; q < q4; q += 32) {
              float4 xv[RB];
#pragma unroll
              for (int r = 0; r < RB; ++r) xv[r] = R::four(xrow(r) + 4 * q);
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                const float* w4 = wrow(c) + 4 * q;
                float4 wv;
                if constexpr (SRC == 2)
                  wv = make_float4(w4[0], w4[1], w4[2], w4[3]);
                else
                  wv = *reinterpret_cast<const float4*>(w4);
#pragma unroll
                for (int r = 0; r < RB; ++r) {
                  float a = acc[r][c];
                  a = fmaf(xv[r].x, wv.x, a);
                  a = fmaf(xv[r].y, wv.y, a);
                  a = fmaf(xv[r].z, wv.z, a);
                  a = fmaf(xv[r].w, wv.w, a);
                  acc[r][c] = a;
                }
              }
            }
            // the last tile's columns past a multiple of 4 (D % 4 != 0)
            for (int d = 4 * q4 + lane; d < wt; d += 32) {
              float xv[RB];
#pragma unroll
              for (int r = 0; r < RB; ++r) xv[r] = R::one(xrow(r) + d);
#pragma unroll
              for (int c = 0; c < NC; ++c) {
                const float wv = wrow(c)[d];
#pragma unroll
                for (int r = 0; r < RB; ++r)
                  acc[r][c] = fmaf(xv[r], wv, acc[r][c]);
              }
            }
          }
          if (!p.rows_res) release(s);
          WPHASE(2);
        }
      };
      if (wsrc == 0)
        forward(std::integral_constant<int, 0>{});
      else if (wsrc == 1)
        forward(std::integral_constant<int, 1>{});
      else
        forward(std::integral_constant<int, 2>{});
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float v = warp_sum(acc[r][c]);
          if (lane == 0 && r0 + r < nc && (EXACT || c < C))
            pc[4 + (r0 + r) * CP + c] = v;
        }
      }
      if (q0 == 0 && tid == 0) {
        pc[0] = sp;
        pc[1] = sr;
      }
      WPHASE(3);

      // the chunk's exchange: every CTA sums the k partials in rank order.
      // A CTA writes exchange e+2's partials only after the barrier of
      // exchange e+1, which every CTA reaches after reading exchange e's.
      cluster.sync();
      WPHASE(4);
      const uint32_t pc_s = smem_addr(pc);
      for (int i = (q0 == 0 ? 0 : 4) + tid; i < 4 + nc * CP; i += kThreads) {
        if (i == 2 || i == 3) continue;
        if (i >= 4 && (i - 4) % CP >= C) continue;
        // the k partials' loads all in flight, then their sum in rank order
        float part_q[kMaxWideCluster];
#pragma unroll
        for (int q = 0; q < kMaxWideCluster; ++q)
          if (q < k) part_q[q] = ld_cluster(cluster_map(pc_s + 4 * i, q));
        float v = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxWideCluster; ++q)
          if (q < k) v += part_q[q];
        if (i < 2)
          h->tot[i] = v;
        else
          dz[q0 * CP + i - 4] = v;
      }
      consumer_sync();
      WPHASE(5);

      // per row: loss, top-1 hit, and dz (overwrites z), scaled by w_b / cnt
      for (int b = tid; b < nc; b += kThreads) {
        const int q = q0 + b;
        const float bv = row_w[q];
        float hit;
        row_loss[b] = row_loss_grad(dz + q * CP, C, p.y_cls, p.y_reg,
                                    row_id[q], bv * inv_cnt, &hit) *
                      bv;
        row_hit[b] = hit * bv;
      }
      consumer_sync();
      // the step's row ids and weights are no longer read: the producer
      // may pack the next step's
      if (e == nch - 1 && tid == 0) mbar_arrive(&bars->batch_empty);
      if (rank == 0 && tid == 0) {
        float dl = met[3], hits = met[1];
        for (int b = 0; b < nc; ++b) {
          dl += row_loss[b];
          hits += row_hit[b];
        }
        met[3] = dl;
        met[1] = hits;
      }
      WPHASE(6);
    }

    const float sq_p = h->tot[0], sq_r = h->tot[1];
    const float norm_p = sq_p > 0.f ? sqrtf(sq_p) : 0.f;
    const float norm_r = sq_r > 0.f ? sqrtf(sq_r) : 0.f;
    if (rank == 0 && tid == 0) {
      const float loss = met[3] * inv_cnt + p.mu * norm_p + p.lam * norm_r;
      met[0] += loss * cnt;
      met[2] += cnt;
      met[3] = 0.f;
    }

    // grad[c, d] = sum_b dz[b, c] x_b[d] + penalties over this slice: a
    // column a thread a tile, every chunk's rows from the ring; the updated
    // w's sums of squares are the next step's norms
    sp = 0.f;
    sr = 0.f;
    const float rp = 1.f / fmaxf(norm_p, 1e-30f);
    const float rr = 1.f / fmaxf(norm_r, 1e-30f);
    const int held = ri - ntiles;  // rows_res: this step's forward entries
    // the update of column d: its classes in groups of G, every load of a
    // group before its stores (a clamped load may read a class a store
    // writes)
    auto update = [&](auto shared_tag, const float(&g)[NC], int d) {
      constexpr bool SH = decltype(shared_tag)::value;
      float* wcol;
      const float* acol;
      int stride;
      if constexpr (SH) {
        wcol = ws + d;
        acol = as + d;
        stride = Dk;
      } else {
        wcol = Wo + d0 + d;
        acol = p.anchor + d0 + d;
        stride = D;
      }
      constexpr int G = NC <= 16 ? NC : 8;
#pragma unroll
      for (int cg0 = 0; cg0 < NC; cg0 += G) {
        float wv[G], av[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int c = cg0 + i, cc = EXACT ? c : min(c, C - 1);
          if (c < NC) {
            wv[i] = wcol[cc * stride];
            av[i] = acol[cc * stride];
          }
        }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int c = cg0 + i;
          if (c >= NC || (!EXACT && c >= C)) continue;
          float gc = g[c];
          if (sq_p > 0.f) gc += p.mu * ((wv[i] - av[i]) * rp);
          if (sq_r > 0.f) gc += p.lam * (wv[i] * rr);
          const float nw = wv[i] - p.lr * gc;
          wcol[c * stride] = nw;
          const float dv = nw - av[i];
          sp = fmaf(dv, dv, sp);
          sr = fmaf(nw, nw, sr);
        }
      }
    };
    // tile tl: its G tile over every chunk's rows, then its update. HOLD:
    // dz read through a shared-memory pointer (the batch buffer held),
    // else through a generic one (global scratch).
    auto grad_tile = [&](auto hold_tag, int tl) {
      constexpr bool HOLD = decltype(hold_tag)::value;
      const float* dzb;
      if constexpr (HOLD)
        dzb = red + 2 * kWarps + 2 * Bp;  // dz of the held batch buffer
      else
        dzb = dz;
      const int c0 = tl * Dt, wt = min(Dt, wd - c0);
      float g[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) g[c] = 0.f;
      int s = 0;
      for (int e = 0; e < nch; ++e) {
        const int q0 = e * Bc, nc = min(Bc, n - q0);
        if (p.rows_res) {
          s = (held + tl) % NS;
        } else {
          s = ri % NS;
          mbar_wait(&bars->full[s], (unsigned)((ri / NS) & 1));
          ++ri;
        }
        WPHASE(7);
        // this thread's column, clamped to the tile's width (what a
        // clamped column adds is dropped)
        const RowT* xc = ring + s * stage_elems + min(tid, wt - 1);
        const float* dzq = dzb + q0 * CP;
        auto row = [&](int b) {
          const float xv = R::one(xc + b * Dt);
#pragma unroll
          for (int c4 = 0; c4 < CP / 4; ++c4) {
            const float4 dz4 =
                *reinterpret_cast<const float4*>(dzq + b * CP + 4 * c4);
            const float dzv[4] = {dz4.x, dz4.y, dz4.z, dz4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (4 * c4 + q < NC)
                g[4 * c4 + q] = fmaf(dzv[q], xv, g[4 * c4 + q]);
          }
        };
        // GU rows' loads in flight together, fewer where a row's dz is wide
        constexpr int GU = NC <= 10 ? 4 : (NC <= 16 ? 2 : 1);
        int b = 0;
        for (; b + GU <= nc; b += GU) {
#pragma unroll
          for (int u = 0; u < GU; ++u) row(b + u);
        }
        for (; b < nc; ++b) row(b);
        if (!p.rows_res) release(s);
        WPHASE(8);
      }
      if (p.rows_res) release(s);
      if (tid < wt) {
        if (p.w_res)
          update(std::true_type{}, g, c0 + tid);
        else
          update(std::false_type{}, g, c0 + tid);
      }
      WPHASE(9);
    };
    for (int tl = 0; tl < ntiles; ++tl) {
      if (hold)
        grad_tile(std::true_type{}, tl);
      else
        grad_tile(std::false_type{}, tl);
    }
    // also frees dz and the chunk's scratch for the next step
    consumer_sum2(sp, sr, red);
  }
  if (p.w_res) {
    for (int c = 0; c < C; ++c)
      for (int d = tid; d < wd; d += kThreads)
        Wo[(size_t)c * D + d0 + d] = ws[c * Dk + d];
  }
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  WPHASE(10);
  if (timing)
    for (int i = 0; i < 11; ++i) wide_phase_clocks[i] = ph[i];
#endif
  // no CTA leaves while another may still read its partials
  cluster.sync();
  if (rank == 0 && tid == 0)
    for (int i = 0; i < 3; ++i) p.metrics[j * 3 + i] = met[i];
}

// One launch of a wide kernel (either): J clusters of p.k CTAs of
// `threads` threads and `smem` bytes each.
cudaError_t launch_wide_kernel(void (*kern)(WideArgs), const WideArgs& p,
                               int J, int threads, size_t smem,
                               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (p.k > kMaxCluster) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(J * p.k));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NC, bool EXACT>
cudaError_t launch_wide(const WideArgs& p, int J, cudaStream_t stream) {
  if (p.stages < 1 || p.stages > kRingMaxStages || p.tile < 8 ||
      p.tile > kRingTile || p.tile % 8 != 0 || p.chunk > kWarps * ring_rows(NC))
    return cudaErrorInvalidValue;
  return launch_wide_kernel(
      wide_epoch_kernel<NC, EXACT>, p, J, kRingThreads,
      ring_smem_bytes(p.B, p.C, NC, p.Dk, p.chunk, p.tile, p.stages,
                      p.w_res != 0, p.scratch == nullptr),
      stream);
}

// ---------------------------------------------------------------------------
// The class-tiled wide kernel: the wide kernel for any C, taken at run time
// (one instantiation a row type). The same cluster, slices, chunks, exchange
// and batch buffer, but no ring: W's slice is updated in place in W_out and
// rows are read from global memory in both passes; CP = C rounded up to 4 in place of the
// instantiation's; what held one accumulator a class walks the classes in
// tiles: the forward pass carries kTileRows rows through one tile of
// kTileF partial logits at a time (the rows read again for each tile, from
// L1 or L2), the gradient pass kTileB accumulators a column at a time (the
// column's rows read again for each tile), and each chunk row's loss is one
// warp's row_loss_grad_tiled. A tile past C reads the last class again
// (clamped) and drops what it computes, so that no load waits behind a
// branch: a loop that stops at C issues its W loads one at a time.
constexpr int kTileF = 16;
constexpr int kTileRows = 4;
constexpr int kTileB = 32;

__global__ void __launch_bounds__(kThreads, 1)
    wide_tiled_epoch_kernel(const WideArgs p) {
  const int C = p.C, CP = round_up(C, 4);
  const int B = p.B, D = p.D, k = p.k, Bc = p.chunk;
  const int Bp = round_up(B, 8), PS = 4 + Bc * CP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool cls = p.y_cls != nullptr;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = p.order[blockIdx.x / k];
  const int T = p.nsteps[j];
  const int d0 = rank * p.Dk;
  const int wd = max(0, min(p.Dk, D - d0));  // this CTA's columns of D

  extern __shared__ __align__(16) unsigned char smem_raw[];
  WideHeader* h = reinterpret_cast<WideHeader*>(smem_raw);
  // [2][PS]: sp, sr, -, -, z (chunk, CP)
  float* part = reinterpret_cast<float*>(smem_raw + kWideHeaderBytes);
  float* row_loss = part + 2 * PS;
  float* row_hit = row_loss + Bc;
  float* red = row_hit + Bc;  // [2][kWarps]
  float* batch = p.scratch == nullptr
                     ? red + 2 * kWarps
                     : p.scratch + blockIdx.x * wide_batch_floats(B, C);
  int* row_id = reinterpret_cast<int*>(batch);
  float* row_w = batch + Bp;
  float* dz = row_w + Bp;  // [Bp][CP]: the summed logits, then d loss / dz

  const size_t CD = (size_t)C * D;
  const float* Wj = p.W0 + j * CD;
  float* Wo = p.W_out + j * CD;
  float sp = 0.f, sr = 0.f;
  for (int c = 0; c < C; ++c) {
    for (int d = tid; d < wd; d += kThreads) {
      const size_t i = (size_t)c * D + d0 + d;
      const float wv = Wj[i];
      const float dv = wv - p.anchor[i];
      Wo[i] = wv;
      sp = fmaf(dv, dv, sp);
      sr = fmaf(wv, wv, sr);
    }
  }
  block_sum2(sp, sr, red);

  // warp 0 packs the next non-empty step's valid rows, as the wide kernel
  int look = 0;
  auto pack = [&]() {
    for (;;) {
      const size_t base = ((size_t)j * p.S + look) * B;
      int n = 0;
      float cnt = 0.f;
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        float v = 0.f;
        int r = 0;
        if (b < B) {
          v = p.valid[base + b];
          r = p.rows[base + b];
        }
        const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
        if (v != 0.f) {
          const int slot = n + __popc(m & ((1u << lane) - 1u));
          row_id[slot] = r;
          row_w[slot] = v;
        }
        n += __popc(m);
        cnt += warp_sum(v);
      }
      ++look;
      if (n > 0) {
        if (lane == 0) {
          h->n = n;
          h->cnt = cnt;
        }
        return;
      }
    }
  };

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // rank 0, thread 0
  int ex = 0;  // exchanges so far: part is double-buffered by exchange
  for (int t = 0; t < T; ++t) {
    if (warp == 0) pack();
    __syncthreads();
    const int n = h->n;
    const float cnt = h->cnt;
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    float dl = 0.f, hits = 0.f;  // rank 0, thread 0

    for (int q0 = 0; q0 < n; q0 += Bc, ++ex) {
      const int nc = min(Bc, n - q0);
      float* pc = part + (ex & 1) * PS;
      // partial z of the chunk's rows over this slice: one warp per
      // kTileRows rows and one tile of classes at a time, lanes over
      // columns
      const int groups = (nc + kTileRows - 1) / kTileRows;
      for (int g = warp; g < groups; g += kWarps) {
        const RowT* xr[kTileRows];
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
          xr[r] = p.X +
                  (size_t)row_id[q0 + min(g * kTileRows + r, nc - 1)] * D + d0;
        for (int c0 = 0; c0 < C; c0 += kTileF) {
          const float* wt[kTileF];
#pragma unroll
          for (int c = 0; c < kTileF; ++c)
            wt[c] = Wo + (size_t)min(c0 + c, C - 1) * D + d0;
          float acc[kTileRows][kTileF];
#pragma unroll
          for (int r = 0; r < kTileRows; ++r)
#pragma unroll
            for (int c = 0; c < kTileF; ++c) acc[r][c] = 0.f;
          for (int d = lane; d < wd; d += 32) {
            float xv[kTileRows];
#pragma unroll
            for (int r = 0; r < kTileRows; ++r) xv[r] = R::one(xr[r] + d);
#pragma unroll
            for (int c = 0; c < kTileF; ++c) {
              const float wv = wt[c][d];
#pragma unroll
              for (int r = 0; r < kTileRows; ++r)
                acc[r][c] = fmaf(xv[r], wv, acc[r][c]);
            }
          }
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
            for (int c = 0; c < kTileF; ++c) {
              if (c0 + c >= C) break;
              const float v = warp_sum(acc[r][c]);
              if (lane == 0 && g * kTileRows + r < nc)
                pc[4 + (g * kTileRows + r) * CP + c0 + c] = v;
            }
          }
        }
      }
      if (q0 == 0 && tid == 0) {
        pc[0] = sp;
        pc[1] = sr;
      }

      // the chunk's exchange, as the wide kernel's
      cluster.sync();
      for (int i = (q0 == 0 ? 0 : 4) + tid; i < 4 + nc * CP; i += kThreads) {
        if (i == 2 || i == 3) continue;
        if (i >= 4 && (i - 4) % CP >= C) continue;
        float v = 0.f;
        for (int q = 0; q < k; ++q) v += cluster.map_shared_rank(pc, q)[i];
        if (i < 2)
          h->tot[i] = v;
        else
          dz[q0 * CP + i - 4] = v;
      }
      __syncthreads();

      // per row, one warp: loss, top-1 hit, and dz (overwrites z), scaled
      // by w_b / cnt
      for (int b = warp; b < nc; b += kWarps) {
        const int q = q0 + b;
        const float bv = row_w[q];
        const int r = row_id[q];
        float hit;
        const float loss = row_loss_grad_tiled(
            dz + q * CP, C, cls, cls ? p.y_cls[r] : -1,
            cls ? 0.f : p.y_reg[r], bv * inv_cnt, &hit);
        if (lane == 0) {
          row_loss[b] = loss * bv;
          row_hit[b] = hit * bv;
        }
      }
      __syncthreads();
      if (rank == 0 && tid == 0) {
        for (int b = 0; b < nc; ++b) {
          dl += row_loss[b];
          hits += row_hit[b];
        }
      }
    }

    const float sq_p = h->tot[0], sq_r = h->tot[1];
    const float norm_p = sq_p > 0.f ? sqrtf(sq_p) : 0.f;
    const float norm_r = sq_r > 0.f ? sqrtf(sq_r) : 0.f;
    if (rank == 0 && tid == 0) {
      const float loss = dl * inv_cnt + p.mu * norm_p + p.lam * norm_r;
      acc_loss += loss * cnt;
      acc_hit += hits;
      acc_cnt += cnt;
    }

    // grad[c, d] = sum_b dz[b, c] x_b[d] + penalties over this slice, a
    // column a thread and a tile of classes at a time; the updated w's
    // sums of squares are the next step's norms
    sp = 0.f;
    sr = 0.f;
    for (int d = tid; d < wd; d += kThreads) {
      const RowT* xc = p.X + d0 + d;
      for (int c0 = 0; c0 < C; c0 += kTileB) {
        int off[kTileB / 4];  // the tile's float4s of a dz row, clamped
#pragma unroll
        for (int c4 = 0; c4 < kTileB / 4; ++c4)
          off[c4] = min(c0 + 4 * c4, CP - 4);
        float g[kTileB];
#pragma unroll
        for (int c = 0; c < kTileB; ++c) g[c] = 0.f;
#pragma unroll 4
        for (int b = 0; b < n; ++b) {
          const float xv = R::one(xc + (size_t)row_id[b] * D);
          const float* dzb = dz + b * CP;
#pragma unroll
          for (int c4 = 0; c4 < kTileB / 4; ++c4) {
            const float4 dz4 =
                *reinterpret_cast<const float4*>(dzb + off[c4]);
            g[4 * c4 + 0] = fmaf(dz4.x, xv, g[4 * c4 + 0]);
            g[4 * c4 + 1] = fmaf(dz4.y, xv, g[4 * c4 + 1]);
            g[4 * c4 + 2] = fmaf(dz4.z, xv, g[4 * c4 + 2]);
            g[4 * c4 + 3] = fmaf(dz4.w, xv, g[4 * c4 + 3]);
          }
        }
        // every load of the tile before any store (a store could alias a
        // clamped load's address)
        float wv[kTileB], av[kTileB];
#pragma unroll
        for (int c = 0; c < kTileB; ++c) {
          const size_t i = (size_t)min(c0 + c, C - 1) * D + d0 + d;
          wv[c] = Wo[i];
          av[c] = p.anchor[i];
        }
#pragma unroll
        for (int c = 0; c < kTileB; ++c) {
          if (c0 + c >= C) break;
          float gc = g[c];
          if (sq_p > 0.f)
            gc += p.mu * ((wv[c] - av[c]) / fmaxf(norm_p, 1e-30f));
          if (sq_r > 0.f) gc += p.lam * (wv[c] / fmaxf(norm_r, 1e-30f));
          const float nw = wv[c] - p.lr * gc;
          Wo[(size_t)(c0 + c) * D + d0 + d] = nw;
          const float dv = nw - av[c];
          sp = fmaf(dv, dv, sp);
          sr = fmaf(nw, nw, sr);
        }
      }
    }
    // also frees the batch buffer and the header for the next step
    block_sum2(sp, sr, red);
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
  if (rank == 0 && tid == 0) {
    p.metrics[j * 3 + 0] = acc_loss;
    p.metrics[j * 3 + 1] = acc_hit;
    p.metrics[j * 3 + 2] = acc_cnt;
  }
}

cudaError_t launch_wide_tiled(const WideArgs& p, int J, cudaStream_t stream) {
  return launch_wide_kernel(
      wide_tiled_epoch_kernel, p, J, kThreads,
      wide_smem_bytes(p.B, p.C, p.chunk, p.scratch == nullptr), stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of the staged kernel with a cluster of
// k, and of the unstaged kernel; the wrapper's launch plan computes the
// same numbers and checks them against these.
size_t client_epoch_staged_smem_bytes(int B, int C, int D, int k) {
  return staged_smem_bytes(B, C, instantiated_classes(C), D, k);
}

size_t client_epoch_unstaged_smem_bytes(int B, int C, int D) {
  return unstaged_smem_bytes(B, C, D);
}

// The class count of the instantiation that runs C classes (0: none).
int client_epoch_instantiated_classes(int C) {
  return instantiated_classes(C);
}

// Bytes of one element of X this build reads (4, or 2 for bf16 and f16).
int client_epoch_row_bytes(void) { return static_cast<int>(sizeof(RowT)); }

// The slice of D one CTA of a k-cluster holds in this build.
int client_epoch_slice_width(int D, int k) { return slice_width(D, k); }

// Dynamic shared memory of one CTA of the class-tiled wide kernel working
// chunks of `chunk` rows, with the batch buffer in shared memory (hold) or
// not, and the floats of one CTA's batch buffer (its global scratch when
// not held); `tiled` 0 gives the same part of the wide kernel's layout (the
// instantiated class count's), which ring_smem_bytes starts with.
size_t client_epoch_wide_smem_bytes(int B, int C, int chunk, int hold,
                                    int tiled) {
  return wide_smem_bytes(B, tiled ? C : instantiated_classes(C), chunk,
                         hold != 0);
}

// Dynamic shared memory of one CTA of the wide kernel of a k-cluster: its
// ring of `stages` stages of (chunk, tile) row elements, W's and the
// anchor's slices when w_res holds them, the batch buffer when held.
size_t client_epoch_ring_smem_bytes(int B, int C, int D, int k, int chunk,
                                    int tile, int stages, int w_res,
                                    int hold) {
  return ring_smem_bytes(B, C, instantiated_classes(C), slice_width(D, k),
                         chunk, tile, stages, w_res != 0, hold != 0);
}

#ifdef CLIENT_EPOCH_PHASE_CLOCKS
// The wide kernel's phase clocks of its last launch (kWidePhases values).
int client_epoch_wide_phase_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, wide_phase_clocks,
                                               sizeof(wide_phase_clocks)));
}
#endif

size_t client_epoch_wide_batch_floats(int B, int C, int tiled) {
  return wide_batch_floats(B, tiled ? C : instantiated_classes(C));
}

// How many clusters of k CTAs of the wide kernel the card runs at once,
// each CTA a full block of shared memory (one CTA an SM), from
// cudaOccupancyMaxActiveClusters: a cluster sits in one GPC, so this is
// not the SM count over k. 0 where the card does not take a k-cluster.
int client_epoch_wide_active_clusters(int k) {
  auto kern = wide_epoch_kernel<32, false>;
  if ((k > kMaxCluster &&
       cudaFuncSetAttribute(kern,
                            cudaFuncAttributeNonPortableClusterSizeAllowed,
                            1) != cudaSuccess) ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k);
  cfg.blockDim = dim3(kRingThreads);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  cudaGetLastError();  // a refusal here must not reach a later launch's check
  return e == cudaSuccess ? clusters : 0;
}

// The largest cluster the wide kernels may launch on this card: 16 when
// the card runs a 16-CTA cluster of the wide kernel's largest CTA, else the
// portable 8.
int client_epoch_wide_max_cluster(void) {
  return client_epoch_wide_active_clusters(kMaxWideCluster) > 0
             ? kMaxWideCluster
             : kMaxCluster;
}

// One launch of the staged kernel: J clusters of k CTAs, cluster i running
// client order[i]. is_cls selects int32 labels or float32 targets behind y;
// bulk selects cp.async.bulk row copies (a row a multiple of 16 bytes and X
// 16-byte aligned).
// Returns cudaGetLastError() after the launch.
int client_epoch_launch_staged(const void* W0, const void* anchor,
                               const void* X, const void* y, const void* rows,
                               const void* valid, const void* order,
                               const void* nsteps, void* W_out, void* metrics,
                               int J, int S, int B, int C, int D, int k,
                               int is_cls, int bulk, float lr, float mu,
                               float lam, void* stream) {
  if (k < 1 || k > kMaxCluster) return cudaErrorInvalidValue;
  Args p;
  p.W0 = static_cast<const float*>(W0);
  p.anchor = static_cast<const float*>(anchor);
  p.X = static_cast<const RowT*>(X);
  p.y_cls = is_cls ? static_cast<const int*>(y) : nullptr;
  p.y_reg = is_cls ? nullptr : static_cast<const float*>(y);
  p.rows = static_cast<const int*>(rows);
  p.valid = static_cast<const float*>(valid);
  p.order = static_cast<const int*>(order);
  p.nsteps = static_cast<const int*>(nsteps);
  p.W_out = static_cast<float*>(W_out);
  p.metrics = static_cast<float*>(metrics);
  p.S = S;
  p.B = B;
  p.C = C;
  p.D = D;
  p.k = k;
  p.Dk = slice_width(D, k);
  p.bulk = bulk;
  p.lr = lr;
  p.mu = mu;
  p.lam = lam;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    return launch_staged<decltype(n)::value, decltype(exact)::value>(p, J, s);
  }));
}

// One launch of the unstaged kernel: J CTAs, one per client.
int client_epoch_launch_unstaged(const void* W0, const void* anchor,
                                 const void* X, const void* y,
                                 const void* rows, const void* valid,
                                 void* W_out, void* metrics, int J, int S,
                                 int B, int C, int D, int is_cls, float lr,
                                 float mu, float lam, void* stream) {
  const int* yc = is_cls ? static_cast<const int*>(y) : nullptr;
  const float* yr = is_cls ? nullptr : static_cast<const float*>(y);
  const size_t smem = unstaged_smem_bytes(B, C, D);
  auto f = [&](auto tag) {
    constexpr int M = decltype(tag)::value;
    cudaError_t e = cudaFuncSetAttribute(
        unstaged_epoch_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    unstaged_epoch_kernel<M><<<J, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(W0), static_cast<const float*>(anchor),
        static_cast<const RowT*>(X), yc, yr, static_cast<const int*>(rows),
        static_cast<const float*>(valid), static_cast<float*>(W_out),
        static_cast<float*>(metrics), S, B, C, D, lr, mu, lam);
    return cudaGetLastError();
  };
  cudaError_t e;
  if (C <= 8) e = f(std::integral_constant<int, 8>{});
  else if (C <= 32) e = f(std::integral_constant<int, 32>{});
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// One launch of a wide kernel: J clusters of k CTAs, cluster i running
// client order[i], the batch worked in chunks of `chunk` rows (a multiple
// of 8); scratch holds each CTA's batch buffer (wide_batch_floats floats a
// CTA), or is null to keep it in shared memory; `tiled` runs the
// class-tiled instantiation (any C), else the wide kernel that
// dispatch_classes names (C <= 32) with its ring of `stages` stages of
// `tile` columns, W's slice held in shared memory (w_res), the step's rows
// held from pass to pass (rows_res) and cp.async.bulk copies (bulk: a row a
// multiple of 16 bytes and X 16-byte aligned). Other arguments as
// client_epoch_launch_staged. Returns cudaGetLastError() after the launch.
int client_epoch_launch_wide(const void* W0, const void* anchor, const void* X,
                             const void* y, const void* rows,
                             const void* valid, const void* order,
                             const void* nsteps, void* W_out, void* metrics,
                             void* scratch, int J, int S, int B, int C, int D,
                             int k, int chunk, int tile, int stages, int w_res,
                             int rows_res, int bulk, int tiled, int is_cls,
                             float lr, float mu, float lam, void* stream) {
  if (k < 1 || k > kMaxWideCluster || chunk < 8 || chunk % 8 != 0)
    return cudaErrorInvalidValue;
  WideArgs p;
  p.W0 = static_cast<const float*>(W0);
  p.anchor = static_cast<const float*>(anchor);
  p.X = static_cast<const RowT*>(X);
  p.y_cls = is_cls ? static_cast<const int*>(y) : nullptr;
  p.y_reg = is_cls ? nullptr : static_cast<const float*>(y);
  p.rows = static_cast<const int*>(rows);
  p.valid = static_cast<const float*>(valid);
  p.order = static_cast<const int*>(order);
  p.nsteps = static_cast<const int*>(nsteps);
  p.W_out = static_cast<float*>(W_out);
  p.metrics = static_cast<float*>(metrics);
  p.scratch = static_cast<float*>(scratch);
  p.S = S;
  p.B = B;
  p.C = C;
  p.D = D;
  p.k = k;
  p.Dk = slice_width(D, k);
  p.chunk = chunk;
  p.tile = tile;
  p.stages = stages;
  p.w_res = w_res;
  p.rows_res = rows_res;
  p.bulk = bulk;
  p.lr = lr;
  p.mu = mu;
  p.lam = lam;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled) return static_cast<int>(launch_wide_tiled(p, J, s));
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    return launch_wide<decltype(n)::value, decltype(exact)::value>(p, J, s);
  }));
}

}  // extern "C"
