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
// staged as they are, which halves the ring, and widened to fp32 in
// registers as they are read, 8 or 16 bytes a load (the product is fp32,
// as JAX promotes bf16 x f32); W, the anchor, z and the gradient stay fp32.
//
// Four plans, in the wrapper's order (epoch_kernel.launch_plan):
//  1. the staged kernel above, where a cluster of 1, 2, 4 or 8 CTAs holds
//     W's slices and two step tiles in shared memory; for 2-byte rows its
//     redesign for them, staged_ring_epoch_kernel (a producer warp's ring
//     of up to 4 stages, 16-byte row reads, a reduce-scatter of the
//     forward partials, the row losses by 8 lanes a row), where 2 stages
//     fit, its cluster by a rule fitted to its measured times;
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
//  4. past 32 classes, at every B and D, the class-tiled wide kernel, C a
//     run-time argument (one instantiation a row type and a source of W):
//     the wide kernel's producer warp, bulk-copy ring and batch buffer,
//     but its cluster splits the classes, not D (each CTA owns ceil(C / k)
//     classes over the whole rows), so the cluster exchanges four floats a
//     row (the CTA's maximum, first class at it, sum of exponentials and
//     the label's logit) instead of a chunk's partial logits, and the chunk
//     no longer shrinks as C grows. W's slice stays in shared memory where
//     it fits; register-blocked fp32 FMAs in both passes (4 rows x 4
//     classes of logits, 8 classes x 4 columns of the gradient a thread).
//     The cluster is chosen by a fit to the kernel's measured times, as
//     the wide kernel's.

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
// or four (8 or 16 bytes aligned) at a time; 2-byte rows also eight, 16
// bytes aligned. A 2-byte type reads four with one 8-byte load and eight
// with one 16-byte load, and widens each 32-bit word in registers.
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

// Rows of two 2-byte elements a 32-bit word: `pair` widens one word.
template <typename T, typename Pair>
struct NarrowRows {
  static __device__ __forceinline__ float2 two(const T* p) {
    return Pair::pair(*reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ float4 four(const T* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = Pair::pair(u.x), hi = Pair::pair(u.y);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void eight(const T* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const float2 a = Pair::pair(u.x), b = Pair::pair(u.y),
                 c = Pair::pair(u.z), d = Pair::pair(u.w);
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
    f[4] = c.x, f[5] = c.y, f[6] = d.x, f[7] = d.y;
  }
};

template <>
struct Rows<__nv_bfloat16> : NarrowRows<__nv_bfloat16, Rows<__nv_bfloat16>> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ float one(const T* p) {
    return __bfloat162float(*p);
  }
  // a bf16 is the high half of its float: a shift and a mask, exact
  static __device__ __forceinline__ float2 pair(uint32_t u) {
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xffff0000u));
  }
};

template <>
struct Rows<__half> : NarrowRows<__half, Rows<__half>> {
  using T = __half;
  static __device__ __forceinline__ T zero() { return __float2half(0.f); }
  static __device__ __forceinline__ float one(const T* p) {
    return __half2float(*p);
  }
  // the word's two halves widened in place: a repack through a __half2
  // cost the wide kernel registers (48 spill bytes at 8 classes)
  static __device__ __forceinline__ float2 pair(uint32_t u) {
    float lo, hi;
    asm("{\n.reg .f16 l, h;\nmov.b32 {l, h}, %2;\n"
        "cvt.f32.f16 %0, l;\ncvt.f32.f16 %1, h;\n}\n"
        : "=f"(lo), "=f"(hi)
        : "r"(u));
    return make_float2(lo, hi);
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
  int stages;  // the 2-byte staged kernel's ring depth (0: float32 rows)
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

#ifdef CLIENT_EPOCH_PHASE_CLOCKS
// A measurement build only (tools/client_epoch_phases.py --kernel staged
// compiles this file with -DCLIENT_EPOCH_PHASE_CLOCKS): clock64 cycles that
// CTA 0 (rank 0 of the client with the most steps) spends in each phase of
// the staged kernel's steps, summed over its last launch, one a name of
// kStagedPhaseNames. Thread 0 (the float32 kernel's packer, the 2-byte
// kernel's first consumer); the 2-byte kernel's producer lane 0 the last
// four.
constexpr int kStagedPhases = 13;
__device__ unsigned long long staged_phase_clocks[kStagedPhases];
constexpr const char* kStagedPhaseNames =
    "wait_rows,pack_issue,fwd_fma_sums,block_sums,cluster_barrier,"
    "exchange_reads,row_loss,grad_update,closing_barrier,"
    "producer_wait_empty,producer_pack,producer_issue,producer_cluster";
#define SPHASE(i)                     \
  if (timing) {                       \
    const long long now_ = clock64(); \
    ph[i] += now_ - t_last;           \
    t_last = now_;                    \
  }
#else
#define SPHASE(i)
#endif

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
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  const bool timing = blockIdx.x == 0 && tid == 0;
  long long ph[kStagedPhases] = {};
  long long t_last = clock64();
#endif

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // rank 0, thread 0
  for (int t = 0; t < T; ++t) {
    const int st = t & 1;
    const bool more = t + 1 < T;
    if (more) stage(st ^ 1);
    SPHASE(1);
    if (p.bulk) {
      mbar_wait(&h->mbar[st], (unsigned)((t >> 1) & 1));
    } else {
      if (more)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    SPHASE(0);
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
    SPHASE(2);
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
    SPHASE(3);

    // the one exchange of the step: every CTA sums the k partials in rank
    // order. part is double-buffered by step, and a CTA writes step t+2's
    // partials only after the barrier of step t+1, which every CTA reaches
    // after reading step t's.
    cluster.sync();
    SPHASE(4);
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
    SPHASE(5);

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
    SPHASE(6);

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
    SPHASE(7);
    // this step's tile, rows and z are free, and w is updated
    __syncthreads();
    SPHASE(8);
  }
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  if (timing)
    for (int i = 0; i < kStagedPhases; ++i) staged_phase_clocks[i] = ph[i];
#endif
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

// One launch of a staged kernel: J clusters of p.k CTAs of `threads`
// threads and `smem` bytes each.
cudaError_t launch_cluster(void (*kern)(Args), const Args& p, int J,
                           int threads, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
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
cudaError_t launch_staged(const Args& p, int J, cudaStream_t stream) {
  return launch_cluster(staged_epoch_kernel<NC, EXACT>, p, J, kThreads,
                        staged_smem_bytes(p.B, p.C, NC, p.D, p.k), stream);
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
  // the ring: columns of a stage, stages, W (and, in wide_epoch_kernel,
  // the anchor) held in shared memory, the step's rows held there from the
  // forward pass to the gradient pass (wide_epoch_kernel only),
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

// The part of the wide kernel's shared memory that its layout starts with:
// the header, then in floats the
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

// a float read at a shared::cluster address (cluster_map's: 32 bits,
// where cluster.map_shared_rank gives 64-bit generic pointers)
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
// The staged kernel of 2-byte rows (the bfloat16 and float16 builds; plan 1
// for those rows, its cluster by epoch_kernel._narrow_cluster). The float32
// kernel's cluster, slices, exchange and update, redesigned for rows of
// half the bytes. What bounds it is the same serial chain of steps; on
// 2-byte rows the float32 design spent ~2 µs of its 15 a step packing
// rows on warp 0, ~5 µs at the cluster barrier at 4 and 8 CTAs, and read
// rows 4 and 2 bytes a load (tools/client_epoch_phases.py --kernel
// staged).
//  - Warp 8, the producer, packs each step's valid rows (ids, weights and
//    labels: the row losses read no global memory) and issues their copies
//    into a ring of `stages` stages on full and empty mbarriers, one or
//    more steps ahead of the 8 consumer warps, and takes part in the
//    cluster's barriers without waiting on them until it must.
//  - The forward pass reads 8 columns of a row with one 16-byte load and
//    widens them in registers (bf16: a shift and a mask a word); W's and
//    the anchor's slices are held with each group of 8 columns split in
//    halves, so that W's two float4s of a lane are each contiguous across
//    the warp, read once for all of the warp's rows; the warp's partial
//    logits are summed by a reduce-scatter (~1.1 shuffles a value, not 5).
//  - The row losses take 8 lanes a row: 32 rows a pass of the 256
//    consumer threads, each row's sums by shuffles within its 8 lanes.
//  - The gradient pass takes 4, 2 or 1 columns a thread, whichever keeps
//    the most threads busy for the fewest passes (4 with one 8-byte load),
//    and folds the next step's sums of squares into the update, so W is
//    not read again for them.
// The products stay fp32 FMAs; W, the anchor, z and the gradient fp32.
#if defined(CLIENT_EPOCH_ROWS_BF16) || defined(CLIENT_EPOCH_ROWS_F16)
#define CLIENT_EPOCH_NARROW_RING 1
#endif
constexpr int kStagedRingMaxStages = 4;

// the ring's mbarriers and each stage's packed count and weight; the
// cluster's sums of squares of the step
struct StagedRingHeader {
  uint64_t full[kStagedRingMaxStages];
  uint64_t empty[kStagedRingMaxStages];
  int nrow[kStagedRingMaxStages];
  float cnt[kStagedRingMaxStages];
  float tot[2];
  float pad[2];
};
constexpr int kStagedRingHeaderBytes = sizeof(StagedRingHeader);
static_assert(kStagedRingHeaderBytes == 112, "staged ring header layout");

// Shared memory of one CTA of the 2-byte staged kernel. Layout after the
// header, in floats: w (C*Dk), anchor (C*Dk); the ring (stages * Bp * Dk
// RowT elements); part (2 * PS), z (Bp*CP), row_loss (Bp), row_hit (Bp),
// red (2*kWarps); each stage's row weights, labels and ids (3 * stages *
// Bp). Bp, CP and PS as staged_smem_bytes.
size_t staged_ring_smem_bytes(int B, int C, int NC, int D, int k,
                              int stages) {
  const size_t Dk = slice_width(D, k), Bp = round_up(B, 8),
               CP = round_up(NC, 4), PS = 4 + Bp * CP;
  const size_t floats = 2 * (size_t)C * Dk + 2 * PS + Bp * CP + 2 * Bp +
                        2 * kWarps + 3 * (size_t)stages * Bp;
  return kStagedRingHeaderBytes + floats * sizeof(float) +
         (size_t)stages * Bp * Dk * sizeof(RowT);
}

// The columns a thread of the gradient pass takes: of 4, 2 and 1, the
// one whose passes of kThreads over the slice times its columns is least,
// the wider on a tie (fewer loads of dz a column); 4 only where its 4 * NC
// sums fit a thread's registers.
__host__ __device__ constexpr int staged_grad_cols(int Dk, int NC) {
  int best = 4, cost = 1 << 30;
  for (int g = 4; g >= 1; g >>= 1) {
    if (g == 4 && NC > 16) continue;
    const int c = (Dk / g + kThreads - 1) / kThreads * g;
    if (c < cost) {
      cost = c;
      best = g;
    }
  }
  return best;
}

// One halving round of warp_reduce_scatter: lanes `o` apart swap halves
// of their first 2H values, each keeping the sum of the half its bit `o`
// names in v[0, H).
template <int O, int H, int VP>
__device__ __forceinline__ void halve(float (&v)[VP], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The sums over a warp's lanes of VP values a lane (VP a multiple of 8):
// three halving rounds (lanes 16, 8, 4 apart) leave each lane VP / 8
// values, summed over the 8 lanes that share its two low bits; two
// butterfly rounds then sum those over the 4 lanes that differ in them.
// Lane l ends with the sums of values [VP/8 * (l >> 2), + VP/8) in
// v[0, VP/8): ~1.1 shuffles a value, where a butterfly a value takes 5.
template <int VP>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[VP],
                                                    int lane) {
  static_assert(VP % 8 == 0, "a multiple of 8 values");
  halve<16, VP / 2>(v, lane);
  halve<8, VP / 4>(v, lane);
  halve<4, VP / 8>(v, lane);
#pragma unroll
  for (int i = 0; i < VP / 8; ++i) {
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
  }
}

// The row loss, top-1 hit and d loss / dz of row b by the 8 lanes of its
// group (lane g of 8 takes classes g, g + 8, ...; NC <= 32): the first
// maximum, the sum of exponentials and the label's logit by shuffles
// within the group, as row_loss_grad computes them one row a thread.
// z the row's logits (overwritten by dz); returns the loss, *hit the hit.
// A group without a row (`live` false) takes part in the shuffles only.
template <int NC, bool EXACT>
__device__ __forceinline__ float row_loss_grad_group(float* z, bool live,
                                                     int C, bool cls,
                                                     int label, float target,
                                                     float scale,
                                                     float* hit) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int NG = (NC + 7) / 8;  // classes a lane
  if (EXACT) C = NC;
  const int g = threadIdx.x & 7;
  float zc[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = g + 8 * i;
    zc[i] = live && c < C ? z[c] : 0.f;
  }
  if (cls) {
    const float neg_inf = -__int_as_float(0x7f800000);
    float m = neg_inf, zl = 0.f;
    int pred = C;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = g + 8 * i;
      if (c < C && zc[i] > m) {
        m = zc[i];
        pred = c;
      }
      if (c == label) zl = zc[i];
    }
    // the first maximum: the larger value, the lower class on a tie
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(kAll, m, o);
      const int oi = __shfl_xor_sync(kAll, pred, o);
      if (om > m || (om == m && oi < pred)) {
        m = om;
        pred = oi;
      }
      zl += __shfl_xor_sync(kAll, zl, o);
    }
    float e[NG], Z = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      e[i] = g + 8 * i < C ? expf(zc[i] - m) : 0.f;
      Z += e[i];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) Z += __shfl_xor_sync(kAll, Z, o);
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int c = g + 8 * i;
      if (live && c < C)
        z[c] = (e[i] / Z - (c == label ? 1.f : 0.f)) * scale;
    }
    *hit = pred == label ? 1.f : 0.f;
    return (logf(Z) + m) - zl;  // zl 0 for a label outside [0, C)
  }
  float per = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int c = g + 8 * i;
    if (c < C) {
      const float e = zc[i] - target;
      per = fmaf(e, e, per);
      if (live) z[c] = e * (2.f / C) * scale;
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) per += __shfl_xor_sync(kAll, per, o);
  *hit = 0.f;
  return per / C;
}

#ifdef CLIENT_EPOCH_NARROW_RING
template <int NC, bool EXACT>
__global__ void __launch_bounds__(kRingThreads, 1)
    staged_ring_epoch_kernel(const Args p) {
  // rows one warp carries through the forward pass at once
  constexpr int RB = NC <= 4 ? 8 : (NC <= 10 ? 4 : (NC <= 16 ? 2 : 1));
  constexpr int CP = round_up(NC, 4);
  constexpr int VP = round_up(RB * NC, 8);
  const int C = EXACT ? NC : p.C;
  const int S = p.S, B = p.B, D = p.D, k = p.k, Dk = p.Dk, NS = p.stages;
  const int Bp = round_up(B, 8), PS = 4 + Bp * CP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = p.order[blockIdx.x / k];
  const int T = p.nsteps[j];
  const int d0 = rank * Dk;
  const int wd = max(0, min(Dk, D - d0));  // this CTA's columns of D

  extern __shared__ __align__(16) unsigned char smem_raw[];
  StagedRingHeader* h = reinterpret_cast<StagedRingHeader*>(smem_raw);
  float* w = reinterpret_cast<float*>(smem_raw + kStagedRingHeaderBytes);
  float* a = w + C * Dk;
  RowT* tile = reinterpret_cast<RowT*>(a + C * Dk);  // [NS][Bp][Dk], packed
  // [2][PS]: sp, sr, -, -, z (Bp, CP)
  float* part = reinterpret_cast<float*>(tile + NS * Bp * Dk);
  float* z = part + 2 * PS;  // [Bp][CP] logits, then dz
  float* row_loss = z + Bp * CP;
  float* row_hit = row_loss + Bp;
  float* red = row_hit + Bp;         // [2][kWarps]
  float* row_w = red + 2 * kWarps;   // [NS][Bp] valid weight of each row
  float* row_y = row_w + NS * Bp;    // [NS][Bp] its label or target
  int* row_id = reinterpret_cast<int*>(row_y + NS * Bp);  // [NS][Bp]
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  const bool timing = blockIdx.x == 0 && (tid == 0 || tid == kThreads);
  long long ph[kStagedPhases] = {};
  long long t_last = clock64();
#endif

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&h->full[s], 1);
      mbar_init(&h->empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the padding columns of every stage stay 0 (copies write [0, wd)), so
  // the slices' padded widths need no guard in the passes below
  const int padw = Dk - wd;
  for (int i = tid; i < NS * Bp * padw; i += kRingThreads) {
    const int r = i / padw;
    tile[r * Dk + wd + (i - r * padw)] = R::zero();
  }
  // W's and the anchor's slices, each group of 8 columns split in halves:
  // columns 8q..8q+3 at 4q, 8q+4..8q+7 at Dk/2 + 4q, so that a lane's two
  // float4s of its 8 columns are each contiguous across the warp (no bank
  // conflict); and the sums of squares of w - anchor and w over them,
  // kept for the first exchange
  const int Dh = Dk / 2;
  auto wcol = [&](int d) {
    return ((d >> 3) << 2) + (d & 3) + ((d & 4) ? Dh : 0);
  };
  const size_t CD = (size_t)C * D;
  float sp = 0.f, sr = 0.f;
  if (warp < kWarps) {
    const float* Wj = p.W0 + j * CD;
    for (int i = tid; i < C * Dk; i += kThreads) {
      const int c = i / Dk, d = i - c * Dk;
      const bool in = d < wd;
      const float wv = in ? Wj[(size_t)c * D + d0 + d] : 0.f;
      const float av = in ? p.anchor[(size_t)c * D + d0 + d] : 0.f;
      w[c * Dk + wcol(d)] = wv;
      a[c * Dk + wcol(d)] = av;
      const float dv = wv - av;
      sp = fmaf(dv, dv, sp);
      sr = fmaf(wv, wv, sr);
    }
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- the producer warp ----
    int look = 0;          // cursor over the client's steps
    bool pending = false;  // arrived at an exchange not yet waited on
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
    t_last = clock64();
#endif
    for (int t = 0; t < T; ++t) {
      const int s = t % NS, u = t / NS;
      SPHASE(12);
      if (u > 0) mbar_wait(&h->empty[s], (unsigned)((u - 1) & 1));
      SPHASE(9);
      // the next non-empty step's valid rows (one remains: the caller
      // counted them), packed into stage s
      int n = 0;
      float cnt = 0.f;
      for (;;) {
        const size_t base = ((size_t)j * S + look) * B;
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
            const int slot = s * Bp + n + __popc(m & ((1u << lane) - 1u));
            row_id[slot] = r;
            row_w[slot] = v;
            if (p.y_cls != nullptr)
              reinterpret_cast<int*>(row_y)[slot] = p.y_cls[r];
            else
              row_y[slot] = p.y_reg[r];
          }
          n += __popc(m);
          cnt += warp_sum(v);
        }
        ++look;
        if (n > 0) break;
      }
      if (lane == 0) {
        h->nrow[s] = n;
        h->cnt[s] = cnt;
      }
      __syncwarp();
      SPHASE(10);
      RowT* dst = tile + s * Bp * Dk;
      const int* ids = row_id + s * Bp;
      if (p.bulk) {
        if (lane == 0) {
          if (wd > 0)
            mbar_expect_tx(&h->full[s], (unsigned)(n * wd * sizeof(RowT)));
          else
            mbar_arrive(&h->full[s]);
        }
        __syncwarp();
        if (wd > 0)
          for (int q = lane; q < n; q += 32)
            bulk_copy(dst + q * Dk, p.X + (size_t)ids[q] * D + d0,
                      (unsigned)(wd * sizeof(RowT)), &h->full[s]);
      } else {
        // rows not 16-byte aligned: lane-wise copies (cp.async moves 4
        // bytes at least)
        for (int i = lane; i < n * wd; i += 32) {
          const int q = i / wd, d = i - q * wd;
          dst[q * Dk + d] = p.X[(size_t)ids[q] * D + d0 + d];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&h->full[s]);
      }
      SPHASE(11);
      if (pending) cluster_wait();
      cluster_arrive();
      pending = true;
    }
    SPHASE(12);
    if (pending) cluster_wait();
    SPHASE(12);
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
    if (timing)
      for (int i = 9; i < kStagedPhases; ++i) staged_phase_clocks[i] = ph[i];
#endif
    cluster.sync();  // the consumers' last
    return;
  }

  // ---- the 8 consumer warps ----
  consumer_sum2(sp, sr, red);
  const int gcols = staged_grad_cols(Dk, NC);
  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // rank 0, thread 0
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  t_last = clock64();
#endif
  for (int t = 0; t < T; ++t) {
    const int s = t % NS;
    mbar_wait(&h->full[s], (unsigned)((t / NS) & 1));
    SPHASE(0);
    const int n = h->nrow[s];
    const float cnt = h->cnt[s];
    const RowT* xt = tile + s * Bp * Dk;
    float* pc = part + (t & 1) * PS;

    // partial z over this slice: one warp per RB rows, lanes over 8
    // columns (one 16-byte load a row)
    const int Q8 = Dk / 8;
    const int groups = (n + RB - 1) / RB;
    for (int g = warp; g < groups; g += kWarps) {
      float acc[VP];
#pragma unroll
      for (int i = 0; i < VP; ++i) acc[i] = 0.f;
      for (int q = lane; q < Q8; q += 32) {
        float xv[RB][8];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          R::eight(xt + (g * RB + r) * Dk + 8 * q, xv[r]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          const float4 w0 =
              *reinterpret_cast<const float4*>(w + c * Dk + 4 * q);
          const float4 w1 =
              *reinterpret_cast<const float4*>(w + c * Dk + Dh + 4 * q);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float sum = acc[r * NC + c];
#pragma unroll
            for (int e = 0; e < 8; ++e) sum = fmaf(xv[r][e], wv[e], sum);
            acc[r * NC + c] = sum;
          }
        }
      }
      warp_reduce_scatter(acc, lane);
      if ((lane & 3) == 0) {
        const int v0 = (VP / 8) * (lane >> 2);
#pragma unroll
        for (int i = 0; i < VP / 8; ++i) {
          const int vi = v0 + i, r = vi / NC, c = vi - r * NC;
          if (vi < RB * NC && g * RB + r < n && (EXACT || c < C))
            pc[4 + (g * RB + r) * CP + c] = acc[i];
        }
      }
    }
    if (tid == 0) {
      pc[0] = sp;
      pc[1] = sr;
    }
    SPHASE(2);

    // the one exchange of the step: every CTA sums the k partials in rank
    // order. part is double-buffered by step, and a CTA writes step t+2's
    // partials only after the barrier of step t+1, which every CTA's
    // consumers reach after reading step t's.
    cluster.sync();
    SPHASE(4);
    const uint32_t pc_s = smem_addr(pc);
    for (int i = tid; i < 4 + n * CP; i += kThreads) {
      if (i == 2 || i == 3) continue;
      if (i >= 4 && (i - 4) % CP >= C) continue;
      // the k partials' loads all in flight, then their sum in rank order
      float part_q[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < k) part_q[q] = ld_cluster(cluster_map(pc_s + 4 * i, q));
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < k) v += part_q[q];
      if (i < 2)
        h->tot[i] = v;
      else
        z[i - 4] = v;
    }
    consumer_sync();
    SPHASE(5);

    // per row, by a group of 8 lanes: loss, top-1 hit, and dz (overwrites
    // z), scaled by w_b / cnt; the labels were packed with the rows
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    const float* ys = row_y + s * Bp;
    const bool cls = p.y_cls != nullptr;
    for (int b0 = 0; b0 < n; b0 += kThreads / 8) {
      if (b0 + 4 * warp >= n) break;  // this warp's 4 rows: none left
      const int b = b0 + (tid >> 3);
      const bool live = b < n;
      const int bc = min(b, n - 1);
      const float bv = row_w[s * Bp + bc];
      float hit;
      const float loss = row_loss_grad_group<NC, EXACT>(
          z + bc * CP, live, C, cls,
          cls ? reinterpret_cast<const int*>(ys)[bc] : 0,
          cls ? 0.f : ys[bc], bv * inv_cnt, &hit);
      if (live && (tid & 7) == 0) {
        row_loss[b] = loss * bv;
        row_hit[b] = hit * bv;
      }
    }
    consumer_sync();
    const float sq_p = h->tot[0], sq_r = h->tot[1];
    const float norm_p = sq_p > 0.f ? sqrtf(sq_p) : 0.f;
    const float norm_r = sq_r > 0.f ? sqrtf(sq_r) : 0.f;
    if (rank == 0 && warp == 0) {
      float dl = 0.f, hits = 0.f;
      for (int b = lane; b < n; b += 32) {
        dl += row_loss[b];
        hits += row_hit[b];
      }
      dl = warp_sum(dl);
      hits = warp_sum(hits);
      if (lane == 0) {
        const float loss = dl * inv_cnt + p.mu * norm_p + p.lam * norm_r;
        acc_loss += loss * cnt;
        acc_hit += hits;
        acc_cnt += cnt;
      }
    }
    SPHASE(6);

    // grad[c, d] = sum_b dz[b, c] x_b[d] + penalties over this slice, 4, 2
    // or 1 columns a thread (staged_grad_cols), the staged rows read from
    // shared memory; the updated w's sums of squares are the next step's
    // norms
    const float rp = 1.f / fmaxf(norm_p, 1e-30f);
    const float rr = 1.f / fmaxf(norm_r, 1e-30f);
    sp = 0.f;
    sr = 0.f;
    auto update = [&](int i, float gc) {
      const float wv = w[i], av = a[i];
      if (sq_p > 0.f) gc += p.mu * ((wv - av) * rp);
      if (sq_r > 0.f) gc += p.lam * (wv * rr);
      const float nw = wv - p.lr * gc;
      w[i] = nw;
      const float dv = nw - av;
      sp = fmaf(dv, dv, sp);
      sr = fmaf(nw, nw, sr);
    };
    auto grad = [&](auto cols_tag) {
      constexpr int GC = decltype(cols_tag)::value;
      // where the thread's GC columns start in w's split layout
      auto c0w = [&](int pi) { return wcol(GC * pi); };
      for (int pi = tid; pi < Dk / GC; pi += kThreads) {
        float g[GC][NC];
#pragma unroll
        for (int e = 0; e < GC; ++e)
#pragma unroll
          for (int c = 0; c < NC; ++c) g[e][c] = 0.f;
        auto row = [&](int b) {
          float xv[GC];
          if constexpr (GC == 4) {
            const float4 x4 = R::four(xt + b * Dk + 4 * pi);
            xv[0] = x4.x, xv[1] = x4.y, xv[2] = x4.z, xv[3] = x4.w;
          } else if constexpr (GC == 2) {
            const float2 x2 = R::two(xt + b * Dk + 2 * pi);
            xv[0] = x2.x, xv[1] = x2.y;
          } else {
            xv[0] = R::one(xt + b * Dk + pi);
          }
#pragma unroll
          for (int c4 = 0; c4 < CP / 4; ++c4) {
            const float4 dz4 =
                *reinterpret_cast<const float4*>(z + b * CP + 4 * c4);
            const float dzv[4] = {dz4.x, dz4.y, dz4.z, dz4.w};
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const int c = 4 * c4 + e4;
              if (c < NC) {
#pragma unroll
                for (int e = 0; e < GC; ++e)
                  g[e][c] = fmaf(dzv[e4], xv[e], g[e][c]);
              }
            }
          }
        };
        // GU rows' loads in flight together, fewer where a row's dz is wide
        constexpr int GU = NC * GC <= 40 ? 4 : (NC * GC <= 64 ? 2 : 1);
        int b = 0;
        for (; b + GU <= n; b += GU) {
#pragma unroll
          for (int u = 0; u < GU; ++u) row(b + u);
        }
        for (; b < n; ++b) row(b);
        const int wc = c0w(pi);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
#pragma unroll
          for (int e = 0; e < GC; ++e) update(c * Dk + wc + e, g[e][c]);
        }
      }
    };
    if (gcols == 1) {
      grad(std::integral_constant<int, 1>{});
    } else if constexpr (NC <= 16) {
      if (gcols == 4)
        grad(std::integral_constant<int, 4>{});
      else
        grad(std::integral_constant<int, 2>{});
    } else {
      grad(std::integral_constant<int, 2>{});
    }
    SPHASE(7);
    // also the step's closing barrier: its stage, rows and z are free
    consumer_sum2(sp, sr, red);
    if (tid == 0) mbar_arrive(&h->empty[s]);
    SPHASE(8);
  }
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  if (timing)
    for (int i = 0; i < 9; ++i) staged_phase_clocks[i] = ph[i];
#endif
  // no CTA leaves while another may still read its partials
  cluster.sync();

  float* Wo = p.W_out + j * CD;
  for (int i = tid; i < C * Dk; i += kThreads) {
    const int c = i / Dk, d = i - c * Dk;
    if (d < wd) Wo[(size_t)c * D + d0 + d] = w[c * Dk + wcol(d)];
  }
  if (rank == 0 && tid == 0) {
    p.metrics[j * 3 + 0] = acc_loss;
    p.metrics[j * 3 + 1] = acc_hit;
    p.metrics[j * 3 + 2] = acc_cnt;
  }
}

template <int NC, bool EXACT>
cudaError_t launch_staged_ring(const Args& p, int J, cudaStream_t stream) {
  if (p.stages < 2 || p.stages > kStagedRingMaxStages)
    return cudaErrorInvalidValue;
  return launch_cluster(
      staged_ring_epoch_kernel<NC, EXACT>, p, J, kRingThreads,
      staged_ring_smem_bytes(p.B, p.C, NC, p.D, p.k, p.stages), stream);
}
#endif  // CLIENT_EPOCH_NARROW_RING

// ---------------------------------------------------------------------------
// The class-tiled wide kernel (plan 4): any C, taken at run time, one
// instantiation a row type and a source of W. Its cluster splits the
// classes, not D: CTA q of a k-cluster owns classes [q C / k, (q + 1) C / k)
// (at most Ck = ceil(C / k), at least one for k <= C) over all of D, so its
// logits are whole and the cluster exchanges four floats a row: the CTA's
// maximum, its first class at the maximum, its sum of exp(z - max) and
// the label's logit (for the squared error its sum of squares), pushed
// into every peer's shared memory before one cluster barrier a chunk. Each
// CTA combines the k in rank order (the first maximum of the lowest rank
// is the first maximum of the row) and forms its own classes' d loss / dz.
// As the wide kernel:
//  - warp 8, the producer, packs each step's valid rows into the batch
//    buffer and streams (chunk, tile) tiles of them through a ring of
//    `stages` stages on full and empty mbarriers (one cp.async.bulk a row
//    a tile, element-wise copies where a row is not a multiple of 16
//    bytes), running ahead of the consumers across passes and steps;
//    every CTA of a cluster reads the whole rows (from L2: its peers read
//    the same);
//  - W's (Ck, D) slice stays in shared memory for the launch where it fits
//    beside 2 stages of the widest tile (w_res; W_out written once at the
//    end), else it is updated in place in W_out and read through L1 in
//    both passes; the anchor, one (C, D) array that all J clients share,
//    is read from global memory, each update's anchor loaded before the
//    tile's gradient FMAs so that the loads overlap them.
// The FMAs are register-blocked fp32. In the forward pass a thread holds
// 4 rows x 4 classes of a chunk's logits (rows r, r + Bc/4, ..., classes
// c, c + CkP/4, ..., so that a warp's loads fall on distinct banks and
// each row and W float4 is broadcast to the lanes that share it) over its
// float4 columns of each tile; where the blocks are fewer than the 256
// consumer threads, the threads split each tile's columns and their
// partials are summed in a fixed order through shared memory, and where
// they are more, the threads walk them in passes over each tile, adding
// into the chunk's logits in shared memory. In the gradient pass a thread
// holds 8 classes x 4 columns of G = dz^T X over the step's rows; where
// those blocks are fewer than the threads, the lanes of a warp split the
// rows and a butterfly of shuffles sums them; then the prox and ridge
// terms, the update and the next step's sums of squares. Every sum runs in
// a fixed order: two launches are bitwise equal.
//
// What bounds it: not the bytes (each valid row read once, W and the
// anchor) but a step's latency, as the other epoch kernels: at the sector
// stand-in's C = 105 the fp32 FMAs of a CTA's classes (~4 B Ck D a step)
// and the ring's row copies (every CTA of a cluster reads the whole rows,
// one bulk copy a row a tile: a stage of 32 rows takes ~1.6 us to issue
// whatever its width, so tiles are as wide as fit); at C = 1,000 the
// forward FMAs against W read from global memory, which no longer fits
// shared memory (read twice and written once a step). The measurements
// that chose this layout, a multicast ring (slower: a stage then waits
// for the slowest CTA's release) and the dropped variants are in PERF.md.
constexpr int kTiledMaxChunk = 32;          // rows of one exchange
constexpr int kTiledMaxTile = 256;          // columns of one ring stage
constexpr int kZaccMin = kThreads * 16;     // the forward's split partials

// the ring's mbarriers, and the step's header: packed rows, their weight,
// the cluster's sums of squares of w - anchor and w
struct TiledHeader {
  uint64_t full[kRingMaxStages];
  uint64_t empty[kRingMaxStages];
  uint64_t batch_full;
  uint64_t batch_empty;
  int n;
  float cnt;
  float tot[2];
};
static_assert(sizeof(TiledHeader) % 16 == 0, "tiled header layout");

// the classes one CTA of a k-cluster owns at most, and its rows of logits'
// stride
__host__ __device__ int tiled_classes(int C, int k) { return (C + k - 1) / k; }
__host__ __device__ int tiled_stride(int C, int k) {
  return round_up(tiled_classes(C, k), 8);
}
// a row of W's slice in shared memory, and of a ring stage (elements),
// padded by 16 bytes so that a warp's rows fall on distinct banks
__host__ __device__ int tiled_w_stride(int D) { return round_up(D, 4) + 4; }
__host__ __device__ int tiled_row_stride(int tile) { return tile + kRowAlign; }

// The batch buffer of one CTA, in floats: the packed valid rows' ids (Bp
// ints) and weights (Bp), then the logits, then d loss / dz, of this CTA's
// classes (Bp * tiled_stride).
__host__ __device__ size_t tiled_batch_floats(int B, int C, int k) {
  return (size_t)round_up(B, 8) * (tiled_stride(C, k) + 2);
}

// Shared memory of one CTA: the header; in floats the pushed row stats
// (2 exchanges x k ranks x chunk x 4) and sums of squares (2 x k x 4), the
// chunk's row state (8 x chunk), the block sums (2 x kWarps), the
// forward's partials (at least kZaccMin, else chunk x tiled_stride); the
// batch buffer when held; W's slice (Ck x tiled_w_stride) when w_res; and
// `stages` stages of (chunk, tiled_row_stride(tile)) row elements.
size_t tiled_smem_bytes(int B, int C, int D, int k, int chunk, int tile,
                        int stages, bool w_res, bool hold) {
  const size_t CkP = tiled_stride(C, k);
  const size_t zacc = (size_t)chunk * CkP > (size_t)kZaccMin
                          ? (size_t)chunk * CkP
                          : (size_t)kZaccMin;
  const size_t floats = 2 * (size_t)k * chunk * 4 + 2 * (size_t)k * 4 +
                        8 * (size_t)chunk + 2 * kWarps + zacc;
  return sizeof(TiledHeader) + floats * sizeof(float) +
         (hold ? tiled_batch_floats(B, C, k) * sizeof(float) : 0) +
         (w_res ? (size_t)tiled_classes(C, k) * tiled_w_stride(D) *
                      sizeof(float)
                : 0) +
         (size_t)stages * chunk * tiled_row_stride(tile) * sizeof(RowT);
}

// v stored at the shared::cluster address `a` (16-byte aligned) of a CTA of
// the cluster; the next cluster barrier (arrive has release semantics, wait
// acquire) makes it visible there
__device__ __forceinline__ void st_cluster4(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

#ifdef CLIENT_EPOCH_PHASE_CLOCKS
// The class-tiled kernel's phases (WPHASE marks, CTA 0): consumer thread 0,
// then the producer's lane 0.
__device__ unsigned long long tiled_phase_clocks[kWidePhases];
constexpr const char* kTiledPhaseNames =
    "wait_batch,wait_fwd_tiles,fwd_fma,fwd_sum,row_stats_push,"
    "cluster_barrier,combine_dz,wait_grad_tiles,grad_fma,grad_update,"
    "block_sums,producer_wait_empty,producer_issue,producer_wait_batch,"
    "producer_pack,producer_cluster";
#endif

// WSRC: where W's slice lives, each its own code path so that shared
// addresses stay 32-bit: 0 shared memory (w_res), 1 W_out read in float4s
// (D % 4 == 0), 2 W_out a float at a time.
template <int WSRC>
__global__ void __launch_bounds__(kRingThreads, 1)
    wide_tiled_epoch_kernel(const WideArgs p) {
  const int C = p.C, B = p.B, D = p.D, k = p.k, Bc = p.chunk;
  const int Dt = p.tile, NS = p.stages, RS = tiled_row_stride(Dt);
  const int Ck = tiled_classes(C, k), CkP = round_up(Ck, 8);
  const int Bp = round_up(B, 8), WS = tiled_w_stride(D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool cls = p.y_cls != nullptr;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = p.order[blockIdx.x / k];
  const int T = p.nsteps[j];
  const int c_lo = rank * C / k;
  const int cw = (rank + 1) * C / k - c_lo;  // this CTA's classes
  const int ntiles = (D + Dt - 1) / Dt;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TiledHeader* h = reinterpret_cast<TiledHeader*>(smem_raw);
  float* xrow = reinterpret_cast<float*>(h + 1);  // [2][k][Bc][4]
  float* xnrm = xrow + 2 * k * Bc * 4;            // [2][k][4]
  float* rst = xnrm + 2 * k * 4;                  // the chunk's row state
  float* row_m = rst;                             // the row's maximum
  float* row_z = rst + Bc;                        // its sum of exp(z - max)
  int* row_lab = reinterpret_cast<int*>(rst + 2 * Bc);
  float* row_sc = rst + 3 * Bc;                   // w_b / cnt
  float* row_loss = rst + 4 * Bc;
  float* row_hit = rst + 5 * Bc;
  float* row_t = rst + 6 * Bc;                    // the regression target
  float* red = rst + 8 * Bc;                      // [2][kWarps]
  float* zacc = red + 2 * kWarps;
  const int zacc_floats = max(kZaccMin, Bc * CkP);
  const bool hold = p.scratch == nullptr;
  const size_t batch_floats = tiled_batch_floats(B, C, k);
  float* batch =
      hold ? zacc + zacc_floats : p.scratch + blockIdx.x * batch_floats;
  int* row_id = reinterpret_cast<int*>(batch);
  float* row_w = batch + Bp;
  float* dzb = row_w + Bp;  // [Bp][CkP]: the logits, then d loss / dz
  float* ws = zacc + zacc_floats + (hold ? batch_floats : 0);  // (Ck, WS)
  RowT* ring =
      reinterpret_cast<RowT*>(WSRC == 0 ? ws + (size_t)Ck * WS : ws);
  const int stage_elems = Bc * RS;
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  const bool timing = blockIdx.x == 0 && (tid == 0 || tid == kThreads);
  long long ph[kWidePhases] = {};
  long long t_last = clock64();
#endif

  // the gradient pass's blocks of 8 classes x 4 columns of a tile; where
  // they are fewer than the threads the lanes of a warp split the rows in
  // rs groups (a power of 2 up to 8: in the update a lane takes whole
  // classes), else the threads walk them in passes
  const int gblocks = (CkP / 8) * (Dt / 4);
  int rs = 1;
  while (rs < 8 && gblocks * rs * 2 <= kThreads) rs *= 2;
  const int gpasses = (gblocks * rs + kThreads - 1) / kThreads;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&h->full[s], 1);
      mbar_init(&h->empty[s], kWarps);
    }
    mbar_init(&h->batch_full, 1);
    mbar_init(&h->batch_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every CTA of the cluster is running before a peer pushes into it
  cluster.sync();

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
    // copies rows [q0, q0 + nc) of the batch, columns of tile tl, into
    // ring entry ri's stage, once its last use is released
    auto issue = [&](int ri, int q0, int nc, int tl) {
      const int s = ri % NS, u = ri / NS;
      WPHASE(12);
      if (u > 0) mbar_wait(&h->empty[s], (unsigned)((u - 1) & 1));
      WPHASE(11);
      RowT* dst = ring + s * stage_elems;
      const int c0 = tl * Dt, wt = min(Dt, D - c0);
      const RowT* src = p.X + c0;
      if (p.bulk) {
        if (lane == 0)
          mbar_expect_tx(&h->full[s], (unsigned)(nc * wt * sizeof(RowT)));
        __syncwarp();
        for (int r = lane; r < nc; r += 32)
          bulk_copy(dst + r * RS, src + (size_t)row_id[q0 + r] * D,
                    (unsigned)(wt * sizeof(RowT)), &h->full[s]);
      } else {
        for (int i = lane; i < nc * wt; i += 32) {
          const int r = i / wt, d = i - r * wt;
          RowT* e = dst + r * RS + d;
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
        if (lane == 0) mbar_arrive(&h->full[s]);
      }
    };
    int ri = 0;
    bool pending = false;  // arrived at an exchange not yet waited on
    for (int t = 0; t < T; ++t) {
      WPHASE(12);
      if (t > 0) mbar_wait(&h->batch_empty, (unsigned)((t - 1) & 1));
      WPHASE(13);
      const int n = pack();
      __syncwarp();
      if (lane == 0) mbar_arrive(&h->batch_full);
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
      // the gradient pass: a tile's chunks, once a pass of its blocks
      // (once in all where one chunk holds the batch)
      for (int tl = 0; tl < ntiles; ++tl) {
        if (nch == 1) {
          issue(ri++, 0, n, tl);
          continue;
        }
        for (int gp = 0; gp < gpasses; ++gp)
          for (int e = 0; e < nch; ++e)
            issue(ri++, e * Bc, min(Bc, n - e * Bc), tl);
      }
    }
    WPHASE(12);
    if (pending) cluster_wait();
    WPHASE(15);
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
    if (timing)
      for (int i = 11; i < kWidePhases; ++i) tiled_phase_clocks[i] = ph[i];
#endif
    cluster.sync();  // the consumers' last
    return;
  }

  // ---- the 8 consumer warps ----
  // W's slice (to shared memory, or W_out starts as W0) and the sums of
  // squares of w - anchor and w over it, kept for the first exchange
  const float* Wj = p.W0 + j * CD;
  float sp = 0.f, sr = 0.f;
  for (int c = 0; c < cw; ++c) {
    for (int d = tid; d < D; d += kThreads) {
      const size_t i = (size_t)(c_lo + c) * D + d;
      const float wv = Wj[i];
      const float av = p.anchor[i];
      if constexpr (WSRC == 0)
        ws[c * WS + d] = wv;
      else
        Wo[i] = wv;
      const float dv = wv - av;
      sp = fmaf(dv, dv, sp);
      sr = fmaf(wv, wv, sr);
    }
  }
  consumer_sum2(sp, sr, red);

  // the forward pass's blocks of 4 rows x 4 classes of a chunk: split over
  // ds thread groups a tile's columns where fewer than the threads, else
  // walked in fpasses passes
  const int rb = Bc / 4, cb = CkP / 4, fblocks = rb * cb;
  const int ds = fblocks >= kThreads ? 1 : kThreads / fblocks;
  const int fpasses = (fblocks + kThreads - 1) / kThreads;
  // W's row of class c (clamped to this CTA's last: what a clamped class
  // computes is dropped) at column d
  auto wrow = [&](int c) -> const float* {
    const int cc = min(c, cw - 1);
    if constexpr (WSRC == 0)
      return ws + cc * WS;
    else
      return Wo + (size_t)(c_lo + cc) * D;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&h->empty[s]);
  };
  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // rank 0, thread 0
  int ex = 0;  // exchanges so far: the pushed stats are double-buffered
  int ri = 0;  // ring entries consumed
  for (int t = 0; t < T; ++t) {
    WPHASE(10);
    mbar_wait(&h->batch_full, (unsigned)(t & 1));
    WPHASE(0);
    const int n = h->n;
    const float cnt = h->cnt;
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    const int nch = (n + Bc - 1) / Bc;
    float dl = 0.f, hits = 0.f;  // rank 0, thread 0

    for (int e = 0; e < nch; ++e, ++ex) {
      const int q0 = e * Bc, nc = min(Bc, n - q0), buf = ex & 1;
      if (fpasses > 1) {
        for (int i = tid; i < Bc * CkP; i += kThreads) zacc[i] = 0.f;
        consumer_sync();
      }
      // this thread's block (the one of passes == 1) and its sums
      const int blk1 = tid % fblocks, dsi = tid / fblocks;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int tl = 0; tl < ntiles; ++tl, ++ri) {
        const int s = ri % NS;
        mbar_wait(&h->full[s], (unsigned)((ri / NS) & 1));
        WPHASE(1);
        const RowT* xs = ring + s * stage_elems;
        const int c0 = tl * Dt, wt = min(Dt, D - c0), q4 = wt >> 2;
        for (int fp = 0; fp < fpasses; ++fp) {
          const int blk = fpasses == 1 ? blk1 : fp * kThreads + tid;
          const int di = fpasses == 1 ? dsi : 0;
          if (blk >= fblocks || di >= ds) continue;
          if (fpasses > 1) {
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
          }
          const int rblk = blk % rb, cblk = blk / rb;
          const RowT* xr[4];
          const float* wr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xr[i] = xs + min(rblk + rb * i, nc - 1) * RS;
            wr[i] = wrow(cblk + cb * i) + c0;
          }
#pragma unroll 2
          for (int q = di; q < q4; q += ds) {
            float4 xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = R::four(xr[i] + 4 * q);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float* w4 = wr[jj] + 4 * q;
              float4 wv;
              if constexpr (WSRC == 2)
                wv = make_float4(w4[0], w4[1], w4[2], w4[3]);
              else
                wv = *reinterpret_cast<const float4*>(w4);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float a = acc[i][jj];
                a = fmaf(xv[i].x, wv.x, a);
                a = fmaf(xv[i].y, wv.y, a);
                a = fmaf(xv[i].z, wv.z, a);
                a = fmaf(xv[i].w, wv.w, a);
                acc[i][jj] = a;
              }
            }
          }
          // the last tile's columns past a multiple of 4 (D % 4 != 0)
          for (int d = 4 * q4 + di; d < wt; d += ds) {
            float xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = R::one(xr[i] + d);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float wv = wr[jj][d];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[i][jj] = fmaf(xv[i], wv, acc[i][jj]);
            }
          }
          if (fpasses > 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                zacc[(rblk + rb * i) * CkP + cblk + cb * jj] += acc[i][jj];
          }
        }
        release(s);
        WPHASE(2);
      }
      if (fpasses == 1 && dsi < ds) {
        const int rblk = blk1 % rb, cblk = blk1 / rb;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            zacc[(dsi * Bc + rblk + rb * i) * CkP + cblk + cb * jj] =
                acc[i][jj];
      }
      consumer_sync();
      // the chunk's logits: the column groups' partials in group order
      const int nds = fpasses == 1 ? ds : 1;
      for (int i = tid; i < nc * CkP; i += kThreads) {
        float v = 0.f;
        for (int w = 0; w < nds; ++w) v += zacc[w * Bc * CkP + i];
        dzb[(size_t)q0 * CkP + i] = v;
      }
      consumer_sync();
      WPHASE(3);

      // per row, one warp: this CTA's maximum, first class at it, sum of
      // exp(z - max) and label logit (or sum of squared errors), pushed to
      // every CTA of the cluster
      const uint32_t xpush = smem_addr(xrow + (buf * k + rank) * Bc * 4);
      for (int b = warp; b < nc; b += kWarps) {
        const int q = q0 + b, r = row_id[q];
        const float* zr = dzb + (size_t)q * CkP;
        float4 st;
        if (cls) {
          const int lab = p.y_cls[r];
          float m = -__int_as_float(0x7f800000);
          int mi = 0x7fffffff;
          for (int c = lane; c < cw; c += 32) {
            const float v = zr[c];
            if (v > m) {
              m = v;
              mi = c;
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, m, o);
            const int oi = __shfl_xor_sync(0xffffffffu, mi, o);
            if (om > m || (om == m && oi < mi)) {
              m = om;
              mi = oi;
            }
          }
          float sum = 0.f;
          for (int c = lane; c < cw; c += 32) sum += expf(zr[c] - m);
          sum = warp_sum(sum);
          const int li = lab - c_lo;
          const float zl = (li >= 0 && li < cw) ? zr[li] : 0.f;
          st = make_float4(m, sum, zl, __int_as_float(c_lo + mi));
          if (lane == 0) row_lab[b] = lab;
        } else {
          const float tgt = p.y_reg[r];
          float e2 = 0.f;
          for (int c = lane; c < cw; c += 32) {
            const float d = zr[c] - tgt;
            e2 = fmaf(d, d, e2);
          }
          st = make_float4(warp_sum(e2), 0.f, 0.f, 0.f);
          if (lane == 0) row_t[b] = tgt;
        }
        if (lane < k) st_cluster4(cluster_map(xpush + 16 * b, lane), st);
      }
      if (e == 0 && tid == 32) {
        const uint32_t a = smem_addr(xnrm + (buf * k + rank) * 4);
        for (int q = 0; q < k; ++q)
          st_cluster4(cluster_map(a, q), make_float4(sp, sr, 0.f, 0.f));
      }
      WPHASE(4);
      // the chunk's exchange. A CTA pushes exchange x + 2's stats only
      // after the barrier of exchange x + 1, which every CTA reaches after
      // reading exchange x's.
      cluster.sync();
      WPHASE(5);
      const float* xr = xrow + buf * k * Bc * 4;
      for (int b = tid; b < nc; b += kThreads) {
        const float bv = row_w[q0 + b], sc = bv * inv_cnt;
        float loss, hit = 0.f;
        if (cls) {
          float M = xr[b * 4];
          int pred = __float_as_int(xr[b * 4 + 3]);
          for (int q = 1; q < k; ++q) {
            const float mq = xr[(q * Bc + b) * 4];
            if (mq > M) {
              M = mq;
              pred = __float_as_int(xr[(q * Bc + b) * 4 + 3]);
            }
          }
          float Z = 0.f, zl = 0.f;
          for (int q = 0; q < k; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(xr + (q * Bc + b) * 4);
            Z += v.y * expf(v.x - M);
            zl += v.z;
          }
          loss = (logf(Z) + M) - zl;
          hit = pred == row_lab[b] ? 1.f : 0.f;
          row_m[b] = M;
          row_z[b] = Z;
        } else {
          float per = 0.f;
          for (int q = 0; q < k; ++q) per += xr[(q * Bc + b) * 4];
          loss = per / C;
        }
        row_sc[b] = sc;
        row_loss[b] = loss * bv;
        row_hit[b] = hit * bv;
      }
      if (e == 0 && tid == 32) {
        float a = 0.f, b = 0.f;
        for (int q = 0; q < k; ++q) {
          a += xnrm[(buf * k + q) * 4];
          b += xnrm[(buf * k + q) * 4 + 1];
        }
        h->tot[0] = a;
        h->tot[1] = b;
      }
      consumer_sync();
      // the step's row ids and weights are no longer read: the producer
      // may pack the next step's
      if (e == nch - 1 && tid == 0) mbar_arrive(&h->batch_empty);
      if (rank == 0 && tid == 0) {
        for (int b = 0; b < nc; ++b) {
          dl += row_loss[b];
          hits += row_hit[b];
        }
      }
      // d loss / dz of this CTA's classes in place of their logits (0 for
      // the padding past them)
      for (int i = tid; i < nc * CkP; i += kThreads) {
        const int b = i / CkP, c = i - b * CkP;
        float* zp = dzb + (size_t)q0 * CkP + i;
        float d = 0.f;
        if (c < cw) {
          const float z = *zp;
          d = cls ? (expf(z - row_m[b]) / row_z[b] -
                     (c_lo + c == row_lab[b] ? 1.f : 0.f)) *
                        row_sc[b]
                  : (z - row_t[b]) * (2.f / C) * row_sc[b];
        }
        *zp = d;
      }
      WPHASE(6);
    }
    consumer_sync();

    const float sq_p = h->tot[0], sq_r = h->tot[1];
    const float norm_p = sq_p > 0.f ? sqrtf(sq_p) : 0.f;
    const float norm_r = sq_r > 0.f ? sqrtf(sq_r) : 0.f;
    if (rank == 0 && tid == 0) {
      const float loss = dl * inv_cnt + p.mu * norm_p + p.lam * norm_r;
      acc_loss += loss * cnt;
      acc_hit += hits;
      acc_cnt += cnt;
    }

    // grad[c, d] = sum_b dz[b, c] x_b[d] + penalties, a block of 8 classes
    // x 4 columns a thread (its rs lanes splitting the rows); the updated
    // w's sums of squares are the next step's norms
    sp = 0.f;
    sr = 0.f;
    const float rp = 1.f / fmaxf(norm_p, 1e-30f);
    const float rr = 1.f / fmaxf(norm_r, 1e-30f);
    const int L = 32 / rs, sub = lane % L, rsi = lane / L, nq = Dt / 4;
    for (int tl = 0; tl < ntiles; ++tl) {
      const int c0 = tl * Dt, wt = min(Dt, D - c0);
      int s = 0;
      for (int gp = 0; gp < gpasses; ++gp) {
        const int blk = gp * (kThreads / rs) + warp * L + sub;
        const bool act = blk < gblocks;
        const int cblk = act ? blk / nq : 0, qd = act ? blk % nq : 0;
        // lane rsi updates the block's classes cc = rsi mod rs, a float4 of
        // 4 columns each (scalars past the tile's last column or where
        // D % 4 != 0; nothing where the block lies past the tile). Their
        // anchor is loaded before the FMAs, so that the loads overlap them,
        // and W, where it lives in W_out, prefetched into L1.
        const int dq = c0 + 4 * qd, nd = act ? min(4, wt - 4 * qd) : 0;
        const bool vec = nd == 4 && D % 4 == 0;
        auto owns = [&](int cc) {
          return nd > 0 && (cc & (rs - 1)) == rsi && 8 * cblk + cc < cw;
        };
        auto ld4 = [&](const float* q, bool v) {
          if (v) return *reinterpret_cast<const float4*>(q);
          float4 r = make_float4(q[0], 0.f, 0.f, 0.f);
          if (nd > 1) r.y = q[1];
          if (nd > 2) r.z = q[2];
          if (nd > 3) r.w = q[3];
          return r;
        };
        float4 av[8];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          av[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (owns(cc)) {
            const size_t i = (size_t)(c_lo + 8 * cblk + cc) * D + dq;
            av[cc] = ld4(p.anchor + i, vec);
            if constexpr (WSRC != 0)
              asm volatile("prefetch.global.L1 [%0];\n" ::"l"(Wo + i));
          }
        }
        float g[8][4];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) g[a][b] = 0.f;
        for (int e = 0; e < nch; ++e) {
          if (nch > 1 || gp == 0) {
            s = ri % NS;
            mbar_wait(&h->full[s], (unsigned)((ri / NS) & 1));
          }
          WPHASE(7);
          if (act) {
            const int nc = min(Bc, n - e * Bc);
            const RowT* xc = ring + s * stage_elems + 4 * qd;
            const float* dzq = dzb + (size_t)e * Bc * CkP + 8 * cblk;
#pragma unroll 2
            for (int r = rsi; r < nc; r += rs) {
              const float4 xv = R::four(xc + r * RS);
              const float4 d0 =
                  *reinterpret_cast<const float4*>(dzq + (size_t)r * CkP);
              const float4 d1 =
                  *reinterpret_cast<const float4*>(dzq + (size_t)r * CkP + 4);
              const float dv[8] = {d0.x, d0.y, d0.z, d0.w,
                                   d1.x, d1.y, d1.z, d1.w};
#pragma unroll
              for (int a = 0; a < 8; ++a) {
                g[a][0] = fmaf(dv[a], xv.x, g[a][0]);
                g[a][1] = fmaf(dv[a], xv.y, g[a][1]);
                g[a][2] = fmaf(dv[a], xv.z, g[a][2]);
                g[a][3] = fmaf(dv[a], xv.w, g[a][3]);
              }
            }
          }
          if (nch > 1) {
            release(s);
            ++ri;
          }
          WPHASE(8);
        }
        if (nch == 1 && gp == gpasses - 1) {
          release(s);
          ++ri;
        }
        // the row groups' sums, the same in every lane of the block: each
        // level of the butterfly over all 32 sums at once
        for (int o = L; o < 32; o <<= 1) {
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              g[a][b] += __shfl_xor_sync(0xffffffffu, g[a][b], o);
        }
        // W of the classes this lane updates (a row of ws is 16-byte
        // aligned), 4 classes at a time, every load of 4 before their stores
        auto wptr = [&](int c) -> float* {
          if constexpr (WSRC == 0)
            return ws + c * WS + dq;
          else
            return Wo + (size_t)(c_lo + c) * D + dq;
        };
#pragma unroll
        for (int h4 = 0; h4 < 8; h4 += 4) {
          float4 wv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            wv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (owns(h4 + u))
              wv[u] = ld4(wptr(8 * cblk + h4 + u),
                          vec || (WSRC == 0 && nd == 4));
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cc = h4 + u;
            if (!owns(cc)) continue;
            float* wq = wptr(8 * cblk + cc);
            const float wl[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
            const float al[4] = {av[cc].x, av[cc].y, av[cc].z, av[cc].w};
            float nw[4];
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              float gc = g[cc][e4];
              if (sq_p > 0.f) gc += p.mu * ((wl[e4] - al[e4]) * rp);
              if (sq_r > 0.f) gc += p.lam * (wl[e4] * rr);
              nw[e4] = wl[e4] - p.lr * gc;
              if (e4 < nd) {
                const float dv = nw[e4] - al[e4];
                sp = fmaf(dv, dv, sp);
                sr = fmaf(nw[e4], nw[e4], sr);
              }
            }
            if (nd == 4 && (WSRC == 0 || vec)) {
              *reinterpret_cast<float4*>(wq) =
                  make_float4(nw[0], nw[1], nw[2], nw[3]);
            } else {
              wq[0] = nw[0];
              if (nd > 1) wq[1] = nw[1];
              if (nd > 2) wq[2] = nw[2];
              if (nd > 3) wq[3] = nw[3];
            }
          }
        }
        WPHASE(9);
      }
    }
    // also frees the batch buffer and the chunk state for the next step
    consumer_sum2(sp, sr, red);
  }
  if constexpr (WSRC == 0) {
    for (int c = 0; c < cw; ++c)
      for (int d = tid; d < D; d += kThreads)
        Wo[(size_t)(c_lo + c) * D + d] = ws[c * WS + d];
  }
#ifdef CLIENT_EPOCH_PHASE_CLOCKS
  WPHASE(10);
  if (timing)
    for (int i = 0; i < 11; ++i) tiled_phase_clocks[i] = ph[i];
#endif
  // no CTA leaves while a peer may still push into it
  cluster.sync();
  if (rank == 0 && tid == 0) {
    p.metrics[j * 3 + 0] = acc_loss;
    p.metrics[j * 3 + 1] = acc_hit;
    p.metrics[j * 3 + 2] = acc_cnt;
  }
}

cudaError_t launch_wide_tiled(const WideArgs& p, int J, cudaStream_t stream) {
  if (p.stages < 2 || p.stages > kRingMaxStages || p.tile < 8 ||
      p.tile > kTiledMaxTile || p.tile % 8 != 0 || p.chunk > kTiledMaxChunk ||
      p.k > p.C)
    return cudaErrorInvalidValue;
  const size_t smem =
      tiled_smem_bytes(p.B, p.C, p.D, p.k, p.chunk, p.tile, p.stages,
                       p.w_res != 0, p.scratch == nullptr);
  if (p.w_res)
    return launch_wide_kernel(wide_tiled_epoch_kernel<0>, p, J, kRingThreads,
                              smem, stream);
  if (p.D % 4 == 0)
    return launch_wide_kernel(wide_tiled_epoch_kernel<1>, p, J, kRingThreads,
                              smem, stream);
  return launch_wide_kernel(wide_tiled_epoch_kernel<2>, p, J, kRingThreads,
                            smem, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of the staged kernel with a cluster of
// k, of its 2-byte ring of `stages` stages (this build's row type), and of
// the unstaged kernel; the wrapper's launch plan computes the same numbers
// and checks them against these.
size_t client_epoch_staged_smem_bytes(int B, int C, int D, int k) {
  return staged_smem_bytes(B, C, instantiated_classes(C), D, k);
}

size_t client_epoch_staged_ring_smem_bytes(int B, int C, int D, int k,
                                           int stages) {
  return staged_ring_smem_bytes(B, C, instantiated_classes(C), D, k, stages);
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

// Dynamic shared memory of one CTA of the class-tiled wide kernel of a
// k-cluster: chunks of `chunk` rows, a ring of `stages` stages of `tile`
// columns, W's slice held in shared memory (w_res) or not, the batch
// buffer held (hold) or in global scratch.
size_t client_epoch_tiled_smem_bytes(int B, int C, int D, int k, int chunk,
                                     int tile, int stages, int w_res,
                                     int hold) {
  return tiled_smem_bytes(B, C, D, k, chunk, tile, stages, w_res != 0,
                          hold != 0);
}

// The floats of one CTA's batch buffer of the class-tiled wide kernel of a
// k-cluster (its global scratch when not held).
size_t client_epoch_tiled_batch_floats(int B, int C, int k) {
  return tiled_batch_floats(B, C, k);
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
// The staged kernel's phase clocks of its last launch (kStagedPhases
// values, one a name of client_epoch_staged_phase_names).
int client_epoch_staged_phase_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, staged_phase_clocks,
                                               sizeof(staged_phase_clocks)));
}

const char* client_epoch_staged_phase_names(void) {
  return kStagedPhaseNames;
}

// The wide kernel's phase clocks of its last launch (kWidePhases values).
int client_epoch_wide_phase_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, wide_phase_clocks,
                                               sizeof(wide_phase_clocks)));
}

// The class-tiled wide kernel's (kWidePhases values, one a name of
// client_epoch_tiled_phase_names).
int client_epoch_tiled_phase_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, tiled_phase_clocks,
                                               sizeof(tiled_phase_clocks)));
}

const char* client_epoch_tiled_phase_names(void) { return kTiledPhaseNames; }
#endif

// The floats of one CTA's batch buffer of the wide kernel.
size_t client_epoch_wide_batch_floats(int B, int C) {
  return wide_batch_floats(B, instantiated_classes(C));
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
// client order[i]; float32 rows run staged_epoch_kernel (`stages` 0),
// 2-byte rows staged_ring_epoch_kernel with a ring of `stages`. is_cls
// selects int32 labels or float32 targets behind y; bulk selects
// cp.async.bulk row copies (a row a multiple of 16 bytes and X 16-byte
// aligned).
// Returns cudaGetLastError() after the launch.
int client_epoch_launch_staged(const void* W0, const void* anchor,
                               const void* X, const void* y, const void* rows,
                               const void* valid, const void* order,
                               const void* nsteps, void* W_out, void* metrics,
                               int J, int S, int B, int C, int D, int k,
                               int stages, int is_cls, int bulk, float lr,
                               float mu, float lam, void* stream) {
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
  p.stages = stages;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    constexpr int NC = decltype(n)::value;
    constexpr bool EXACT = decltype(exact)::value;
#ifdef CLIENT_EPOCH_NARROW_RING
    return launch_staged_ring<NC, EXACT>(p, J, s);
#else
    if (stages != 0) return cudaErrorInvalidValue;
    return launch_staged<NC, EXACT>(p, J, s);
#endif
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
// CTA, tiled_batch_floats for the class-tiled kernel), or is null to keep
// it in shared memory; both kernels stream rows through a ring of `stages`
// stages of `tile` columns, with W's slice held in shared memory (w_res)
// and cp.async.bulk copies (bulk: a row a multiple of 16 bytes and X
// 16-byte aligned); `tiled` runs the class-tiled kernel (any C, its
// cluster splitting the classes), else the wide kernel that
// dispatch_classes names (C <= 32), which also holds the step's rows from
// pass to pass (rows_res). Other arguments as
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
