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
//     16-CTA cluster), but W's slice is updated in place in W_out and the
//     anchor is read from global memory, rows are read from global memory
//     in both passes (the second pass mostly from L2), and the batch is
//     worked in chunks of at most `chunk` rows, one exchange of partial
//     logits a chunk. The loss gradient of the whole batch and its packed
//     row ids stay in shared memory where they fit, else in a per-CTA global
//     scratch. Its shared memory does not grow with D, nor past the chunk
//     with B, so it takes any B and D. The sums of squares of the next
//     step's norms are folded into the update pass.
//  4. past 32 classes, at every B and D, the class-tiled wide kernel: the
//     wide kernel with C a run-time argument, one instantiation a row type.
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
// The wide kernel: the shapes neither kernel above takes.

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
  float* W_out;         // (J, C, D), each CTA's slice updated in place
  float* metrics;       // (J, 3)
  float* scratch;       // (J*k, wide_batch_floats) or null: the batch buffer
  int S, B, C, D, k, Dk, chunk;
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

// Shared memory of one CTA of the wide kernel: the header, then in floats
// the double-buffered exchange (2 * (4 + chunk*CP)), the chunk's row loss
// and hits (2 * chunk) and the block sums (2 * kWarps); then the batch
// buffer when `hold` keeps it in shared memory.
size_t wide_smem_bytes(int B, int NC, int chunk, bool hold) {
  const size_t CP = round_up(NC, 4);
  const size_t floats = 2 * (4 + (size_t)chunk * CP) + 2 * (size_t)chunk +
                        2 * kWarps;
  return kWideHeaderBytes + floats * sizeof(float) +
         (hold ? wide_batch_floats(B, NC) * sizeof(float) : 0);
}

template <int NC, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
    wide_epoch_kernel(const WideArgs p) {
  constexpr int RB = NC <= 4 ? 8 : (NC <= 10 ? 4 : (NC <= 16 ? 2 : 1));
  constexpr int CP = round_up(NC, 4);
  const int C = EXACT ? NC : p.C;
  const int B = p.B, D = p.D, k = p.k, Bc = p.chunk;
  const int Bp = round_up(B, 8), PS = 4 + Bc * CP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

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
  // the batch buffer, shared or global behind one generic pointer
  float* batch = p.scratch == nullptr
                     ? red + 2 * kWarps
                     : p.scratch + blockIdx.x * wide_batch_floats(B, NC);
  int* row_id = reinterpret_cast<int*>(batch);
  float* row_w = batch + Bp;
  float* dz = row_w + Bp;  // [Bp][CP]: the summed logits, then d loss / dz

  // W_out starts as W0; sp, sr: sums of squares of w - anchor and w over
  // this slice, then (block_sum2) over the CTA, kept for the next exchange
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

  // Warp 0 packs the next non-empty step's valid rows (the caller counted
  // them: one remains) into the batch buffer, its cursor in registers.
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
      // partial z of the chunk's rows over this slice: one warp per RB
      // rows, lanes over columns; W read from this CTA's slice of W_out
      const int groups = (nc + RB - 1) / RB;
      for (int g = warp; g < groups; g += kWarps) {
        const RowT* xr[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          xr[r] = p.X + (size_t)row_id[q0 + min(g * RB + r, nc - 1)] * D + d0;
        float acc[RB][NC];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
#pragma unroll 2
        for (int d = lane; d < wd; d += 32) {
          float xv[RB];
#pragma unroll
          for (int r = 0; r < RB; ++r) xv[r] = R::one(xr[r] + d);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (!EXACT && c >= C) break;
            const float wv = Wo[(size_t)c * D + d0 + d];
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[r][c] = fmaf(xv[r], wv, acc[r][c]);
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (!EXACT && c >= C) break;
            const float v = warp_sum(acc[r][c]);
            if (lane == 0 && g * RB + r < nc) pc[4 + (g * RB + r) * CP + c] = v;
          }
        }
      }
      if (q0 == 0 && tid == 0) {
        pc[0] = sp;
        pc[1] = sr;
      }

      // the chunk's exchange: every CTA sums the k partials in rank order.
      // A CTA writes exchange e+2's partials only after the barrier of
      // exchange e+1, which every CTA reaches after reading exchange e's.
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
    // column a thread, the rows read again from global memory; the updated
    // w's sums of squares are the next step's norms
    sp = 0.f;
    sr = 0.f;
    for (int d = tid; d < wd; d += kThreads) {
      float g[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) g[c] = 0.f;
      for (int b = 0; b < n; ++b) {
        const float xv = R::one(p.X + (size_t)row_id[b] * D + d0 + d);
#pragma unroll
        for (int c4 = 0; c4 < CP / 4; ++c4) {
          const float4 dz4 =
              *reinterpret_cast<const float4*>(dz + b * CP + 4 * c4);
          const float dzv[4] = {dz4.x, dz4.y, dz4.z, dz4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * c4 + e;
            if (c < NC) g[c] = fmaf(dzv[e], xv, g[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!EXACT && c >= C) break;
        const size_t i = (size_t)c * D + d0 + d;
        const float wv = Wo[i];
        const float av = p.anchor[i];
        float gc = g[c];
        if (sq_p > 0.f) gc += p.mu * ((wv - av) / fmaxf(norm_p, 1e-30f));
        if (sq_r > 0.f) gc += p.lam * (wv / fmaxf(norm_r, 1e-30f));
        const float nw = wv - p.lr * gc;
        Wo[i] = nw;
        const float dv = nw - av;
        sp = fmaf(dv, dv, sp);
        sr = fmaf(nw, nw, sr);
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

// One launch of a wide kernel (either instantiation): J clusters of p.k
// CTAs of `smem` bytes each.
cudaError_t launch_wide_kernel(void (*kern)(WideArgs), const WideArgs& p,
                               int J, size_t smem, cudaStream_t stream) {
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

template <int NC, bool EXACT>
cudaError_t launch_wide(const WideArgs& p, int J, cudaStream_t stream) {
  return launch_wide_kernel(
      wide_epoch_kernel<NC, EXACT>, p, J,
      wide_smem_bytes(p.B, NC, p.chunk, p.scratch == nullptr), stream);
}

// ---------------------------------------------------------------------------
// The class-tiled wide kernel: the wide kernel for any C, taken at run time
// (one instantiation a row type). The same cluster, slices, chunks, exchange
// and batch buffer, with CP = C rounded up to 4 in place of the
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
      wide_tiled_epoch_kernel, p, J,
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

// Dynamic shared memory of one CTA of the wide kernel working chunks of
// `chunk` rows, with the batch buffer in shared memory (hold) or not, and
// the floats of one CTA's batch buffer (its global scratch when not held);
// `tiled` for the class-tiled instantiation, whose layout holds C classes
// itself, not the instantiated count.
size_t client_epoch_wide_smem_bytes(int B, int C, int chunk, int hold,
                                    int tiled) {
  return wide_smem_bytes(B, tiled ? C : instantiated_classes(C), chunk,
                         hold != 0);
}

size_t client_epoch_wide_batch_floats(int B, int C, int tiled) {
  return wide_batch_floats(B, tiled ? C : instantiated_classes(C));
}

// The largest cluster the wide kernel may launch on this card: 16 when
// cudaOccupancyMaxActiveClusters finds room for one 16-CTA cluster of its
// largest CTA (a full block of shared memory), else the portable 8.
int client_epoch_wide_max_cluster(void) {
  auto kern = wide_epoch_kernel<32, false>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit) != cudaSuccess) {
    cudaGetLastError();
    return kMaxCluster;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxWideCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxWideCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  cudaGetLastError();  // a refusal here must not reach a later launch's check
  return (e == cudaSuccess && clusters > 0) ? kMaxWideCluster : kMaxCluster;
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

// One launch of the wide kernel: J clusters of k CTAs, cluster i running
// client order[i], the batch worked in chunks of `chunk` rows (a multiple
// of 8); scratch holds each CTA's batch buffer (wide_batch_floats floats a
// CTA), or is null to keep it in shared memory; `tiled` runs the
// class-tiled instantiation (any C), else the one dispatch_classes names
// (C <= 32). Other arguments as client_epoch_launch_staged. Returns
// cudaGetLastError() after the launch.
int client_epoch_launch_wide(const void* W0, const void* anchor, const void* X,
                             const void* y, const void* rows,
                             const void* valid, const void* order,
                             const void* nsteps, void* W_out, void* metrics,
                             void* scratch, int J, int S, int B, int C, int D,
                             int k, int chunk, int tiled, int is_cls,
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
