// One shuffled epoch of FedAMW's mixture-weight SGD over the pooled
// validation logits (fedcore/psolver_kernel.py holds the wrapper, the launch
// plan and the plain version).
//
// Replaces the Pallas TPU kernel fedcore/pallas_psolver.py:_p_epoch_kernel
// (pallas_psolver.py:38) of the JAX package. Each step gathers its B rows of
// logits (n_val, J, C) itself through positions (S, B); the class-major
// (S, C, B, J) buffer the TPU kernel needed for Mosaic is never built.
//
// Per step, exactly as the TPU kernel: z[b, c] = sum_j L[b, j, c] p_j; CE or
// MSE with the masked mean over the valid rows; g_j = sum_{b,c} L[b, j, c]
// d[b, c] times client_valid_j; buf = m * buf + g; p -= lr * buf (torch/optax
// SGD momentum, no count guard); metrics accumulated. Then, when the launch
// asks for one, the p-guard of the JAX package's make_p_solver
// (aggregate.py:_make_guard) as an epilogue of the p update (apply_guard):
// clip:R or the projection onto the simplex over the valid clients; the
// momentum buffer is not projected (projected SGD).
//
// What bounds it on the card: not bytes (one read of the logits per epoch,
// ~24 MB at the main shapes, which sit in L2 after client_logits wrote them:
// a byte bound of 0.0072 ms) nor flops (4 per element), but the latency of
// S serial steps (749 at the main shapes), each of which needs the p of the
// step before. The staged kernel cuts the latency of one step:
//  - One CTA, one warp per batch row (16 warps at most, each owning rows
//    w, w + 16, ... when B > 16: 512 threads keep 128 registers a thread);
//    p, its momentum buffer and the client mask sit in shared memory.
//  - Rows staged a step ahead. Each warp holds in registers the row id and
//    valid flag of its rows (and its lanes' share of the step's valid count)
//    for the next two steps, and the label of its rows for the next one.
//    At the top of step s it copies its rows of step s + 1 into a two-stage
//    shared-memory ring: one cp.async.bulk per row on the warp's own
//    mbarrier when J*C*4 % 16 == 0 and the logits are 16-byte aligned,
//    element-wise cp.async otherwise. A warp only overwrites a slot it read
//    itself two steps before, so no block barrier guards the ring. No global
//    load is on a step's critical path: the prefetches are volatile loads
//    (ld_early) with no instruction waiting on them in the step they are
//    issued, so neither the compiler nor the in-order issue holds them up.
//  - Warp-local up to the first barrier: lanes split j, accumulate partial
//    z[b, :] and reduce it over the warp (for an even class count the two
//    half-warps first swap halves of z: 3C shuffles instead of 5C), so
//    every lane holds the row's logits;
//    the step's valid count is a warp sum; the warp computes the row's loss
//    and d[b, :] together (row_loss_grad_warp: the arithmetic of
//    row_loss_grad, lane c taking class c's exponential and quotient);
//    lanes write h[b, j] = sum_c L[b, j, c] d[b, c] to shared memory; each
//    warp keeps its rows' loss and hit sums in registers. Rows are read
//    from the ring as float2 when C is even (conflict-free at C = 10).
//  - Barrier 1; threads j < J sum h[:, j] over b in a fixed order and apply
//    the momentum and p updates (and the guard, whose sums are block
//    reductions in a fixed order); barrier 2. Two block barriers per
//    unguarded step.
//  - The metrics are reduced once at the end, in a fixed order: no atomics,
//    so two launches give bitwise-identical p, buf and metrics.
//  - The class count is a template parameter (exact for the registry's
//    class counts), so z and d live in registers; so is whether a guard
//    runs (GUARDED), which keeps the epilogue's code out of the unguarded
//    main path's instantiation (compiled in but never taken, it made a
//    step ~6% slower, measured).
// Everything is fp32 FMA (no tensor cores, no TF32): the tolerances of
// tests/test_pallas_psolver.py need it, and both contractions are
// matrix-vector.
//
// Shapes whose rows do not fit one CTA's shared memory run the split
// kernel: the same step, with J split over a thread-block cluster of k CTAs
// (up to 16). Each CTA owns a contiguous slice of p, buf, cv and of every
// gathered row; its partial z goes through distributed shared memory and
// every CTA sums the k partials in rank order (one cluster barrier), so all
// hold the same z and compute the loss and d of every row redundantly, then
// h, g and the update of their own slice. The guard's sums take one more
// cluster exchange each. A CTA holds its slices of a step's rows in a
// two-stage ring as the staged kernel does when they fit, else it reads
// them from global memory in both passes (the second read finds them in
// L2).
//
// Shapes neither takes (C > 32) run the unstaged kernel below, the port's
// first design: one CTA of 256 threads that gathers each step's (B, J, C)
// block after loading the step's row ids, five block barriers per step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "row_loss.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
// 16 warps: 512 threads leave 128 registers a thread (at 1024 the cap of 64
// spills the C = 10 instantiation)
constexpr int kMaxWarps = 16;
constexpr int kMaxStagedBatch = 32 * kMaxWarps;  // a lane per row of a warp
constexpr int kMaxPortableCluster = 8;
constexpr int kMaxCluster = 16;  // non-portable, where the card schedules it
constexpr int kSmemLimit = 232448;
// the p-guards (psolver_kernel.GUARD_CODES)
constexpr int kGuardNone = 0, kGuardClip = 1, kGuardSimplex = 2;
static_assert(kGuardNone == 0 && kGuardClip == 1 && kGuardSimplex == 2,
              "the codes of psolver_kernel.GUARD_CODES");

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The fixed-order sum of (a, b) over the CTA's NW warps; every thread gets
// both totals. scratch holds two parities of [2][NW] floats and *par
// alternates, so one barrier a call suffices: a parity is written again two
// calls later, after the barrier of the call between, which every thread
// reaches only after reading it.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* scratch,
                                           int& par, int NW) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  float* s = scratch + par * 2 * NW;
  if (lane == 0) {
    s[w] = a;
    s[NW + w] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int q = 0; q < NW; ++q) {
    a += s[q];
    b += s[NW + q];
  }
  par ^= 1;
}

// The p-guard, after the p update, on the slice p[0, n) this CTA holds (all
// of p in a one-CTA plan), each thread taking entries tid, tid + nthreads,
// ...; sum2(a, b) turns per-thread partial sums into totals over all J
// clients, in a fixed order, on every thread. Semantics of the JAX package's
// aggregate.py:_make_guard:
//  - clip: p *= min(1, radius / max(||p||, 1e-30)), the norm over every
//    client, valid or not;
//  - simplex: the Euclidean projection onto the simplex over the valid
//    clients (cv > 0); invalid entries become 0, and every entry does when
//    no client is valid. Michelot's fixed point instead of a sort: theta
//    from every valid entry, then theta = (sum of the support - 1) /
//    |support| with support = {valid j : p_j > theta}, until the support
//    stops shrinking (its size is all a round compares: supports are upper
//    sets of one threshold, so nested); p = max(p - theta, 0). The final
//    theta is the sort-based formula (aggregate.project_simplex) over the
//    same support. At most J + 1 rounds, a handful in practice.
// Returns the fixed point's rounds (0 for clip).
template <typename Sum2>
__device__ int apply_guard(int guard, float radius, float* p, const float* cv,
                           int n, int J, Sum2&& sum2) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  if (guard == kGuardClip) {
    float ss = 0.f, unused = 0.f;
    for (int j = tid; j < n; j += nthreads) ss = fmaf(p[j], p[j], ss);
    sum2(ss, unused);
    const float scale = fminf(1.f, radius / fmaxf(sqrtf(ss), 1e-30f));
    for (int j = tid; j < n; j += nthreads) p[j] *= scale;
    return 0;
  }
  float s = 0.f, m = 0.f;
  for (int j = tid; j < n; j += nthreads) {
    if (cv[j] > 0.f) {
      s += p[j];
      m += 1.f;
    }
  }
  sum2(s, m);
  if (m == 0.f) {
    for (int j = tid; j < n; j += nthreads) p[j] = 0.f;
    return 0;
  }
  float theta = (s - 1.f) / m, prev = m;
  int rounds = 0;
  while (rounds <= J) {
    float t = 0.f, c = 0.f;
    for (int j = tid; j < n; j += nthreads) {
      if (cv[j] > 0.f && p[j] > theta) {
        t += p[j];
        c += 1.f;
      }
    }
    sum2(t, c);
    ++rounds;
    if (c == prev || c == 0.f) break;
    theta = (t - 1.f) / c;
    prev = c;
  }
  for (int j = tid; j < n; j += nthreads)
    p[j] = cv[j] > 0.f ? fmaxf(p[j] - theta, 0.f) : 0.f;
  return rounds;
}

// ---------------------------------------------------------------------------
// The staged kernel.

struct Args {
  const float* p0;      // (J,)
  const float* buf0;    // (J,)
  const float* cv;      // (J,)
  const float* logits;  // (n_val, J, C)
  const int* y;         // (n_val,) int32 labels, or float32 targets' bits
  const int* positions; // (S, B)
  const float* valid;   // (S, B)
  float* p_out;         // (J,)
  float* buf_out;       // (J,)
  float* metrics;       // (3,)
  int S, B, J, C, cls, bulk;
  float lr, momentum;
};

// What the guard epilogue and the split kernel add, as a parameter of its
// own: the same fields appended to Args (28 bytes more) made ptxas compile
// the unguarded staged kernel with 93 registers instead of 123 and ~5%
// slower a step (1.572 against 1.498 ms at the main shape, same card, same
// call), even where it never reads them.
struct Ext {
  int* guard_rounds;  // (2,): the simplex's rounds over all steps and in
                      // the step that took most; or null
  int guard;
  int k, Jk, hold;    // the split kernel's cluster, slice and ring switch
  float radius;
};

int staged_warps(int B) { return B < kMaxWarps ? B : kMaxWarps; }

// Shared memory of the staged kernel, in bytes: 2 mbarriers per warp (one
// per stage), then in floats the ring (2 stages * B rows * JCp, each row
// padded to 4 floats so every row starts 16-byte aligned), h (B*J), p, buf,
// cv (J each) and the per-warp sums (4 * warps: the metrics at the end, the
// guard's block reductions on the way).
size_t staged_smem_bytes(int B, int J, int C) {
  const size_t NW = staged_warps(B), JCp = round_up(J * C, 4);
  return 16 * NW +
         (2 * (size_t)B * JCp + (size_t)B * J + 3 * (size_t)J + 4 * NW) *
             sizeof(float);
}

#ifdef P_EPOCH_PHASE_CLOCKS
// A measurement build only (tools/p_epoch_phases.py compiles this file with
// -DP_EPOCH_PHASE_CLOCKS): clock64 cycles thread 0 spends in each phase of
// the staged kernel's steps, summed over the last launch. Phases of the copy
// issue (bulk path; the element-wise path counts all of it in 3): 0 the
// mbarrier's arrive.expect_tx, 1 __syncwarp, 2 the proxy fence, 3 the
// copy; then 4 prefetch loads, 5 valid count, 6 wait for the staged rows,
// 7 z and its warp sums, 8 row loss, 9 h, 10 barrier 1, 11 p update (and
// guard), 12 barrier 2 and the shift of the prefetched registers.
constexpr int kPhases = 13;
__device__ unsigned long long phase_clocks[kPhases];
#define PHASE(i)                      \
  if (tid == 0) {                     \
    const long long now_ = clock64(); \
    ph[i] += now_ - t_last;           \
    t_last = now_;                    \
  }
#else
#define PHASE(i)
#endif

// L[b, j, :] from a staged row into registers: float2 reads when the class
// count is even (8-byte aligned, and conflict-free across lanes at C = 10),
// else one float at a time.
template <int NC, bool EXACT>
__device__ __forceinline__ void load_row(float (&v)[NC], const float* src,
                                         int C) {
  if constexpr (EXACT && NC % 2 == 0) {
    const float2* s2 = reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int c = 0; c < NC / 2; ++c) {
      const float2 t = s2[c];
      v[2 * c] = t.x;
      v[2 * c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!EXACT && c >= C) break;
      v[c] = src[c];
    }
  }
}

// L[b, j, :] straight from the logits in global memory, one float at a
// time (a row there is only 4-byte aligned in general).
template <int NC, bool EXACT>
__device__ __forceinline__ void load_row_global(float (&v)[NC],
                                                const float* src, int C) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!EXACT && c >= C) break;
    v[c] = __ldg(src + c);
  }
}

// Every lane's z (NC partial sums over its j) becomes the warp's sum, the
// same on every lane. With an even exact class count the first level swaps
// halves (lanes below 16 keep the first NC/2 classes, the others the rest),
// the kept half is summed over 16 lanes, and one more swap gathers both
// halves: 3 NC shuffles instead of the 5 NC of a butterfly per class.
template <int NC, bool EXACT>
__device__ __forceinline__ void warp_sum_classes(float (&z)[NC], int C,
                                                 int lane) {
  if constexpr (EXACT && NC % 2 == 0) {
    constexpr int H = NC / 2;
    const bool hi = lane & 16;
    float u[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float mine = hi ? z[H + k] : z[k];
      const float give = hi ? z[k] : z[H + k];
      u[k] = mine + __shfl_xor_sync(kFull, give, 16);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < H; ++k) u[k] += __shfl_xor_sync(kFull, u[k], o);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float other = __shfl_xor_sync(kFull, u[k], 16);
      z[k] = hi ? other : u[k];
      z[H + k] = hi ? u[k] : other;
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!EXACT && c >= C) break;
      z[c] = warp_sum(z[c]);
    }
  }
}

// NC: the instantiated class count; EXACT: C == NC, else C < NC and the
// classes from C on are skipped; GUARDED: e.guard is not kGuardNone.
template <int NC, bool EXACT, bool GUARDED>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    staged_p_epoch_kernel(const Args a, const Ext e) {
  const int C = EXACT ? NC : a.C;
  const int S = a.S, B = a.B, J = a.J, JC = J * C;
  const int JCp = round_up(JC, 4);
  const int NW = blockDim.x >> 5, nthreads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nrows = (B - 1 - w) / NW + 1;  // rows w, w + NW, ... below B
  const bool cls = a.cls != 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem_raw);  // [2][NW]
  float* ring = reinterpret_cast<float*>(smem_raw + 16 * NW);  // [2][B][JCp]
  float* h = ring + 2 * B * JCp;  // [B][J]
  float* p = h + B * J;
  float* buf = p + J;
  float* cvs = buf + J;
  float* red = cvs + J;  // [4][NW]

  for (int j = tid; j < J; j += nthreads) {
    p[j] = a.p0[j];
    buf[j] = a.buf0[j];
    cvs[j] = a.cv[j];
  }
#ifdef P_EPOCH_PHASE_CLOCKS
  long long ph[kPhases] = {}, t_last = 0;
#endif
  if (lane == 0) {
    mbar_init(&mbar[w], 1);
    mbar_init(&mbar[NW + w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A step's row info in this warp's registers: lane q < nrows holds the
  // row id r and valid flag v of row w + q*NW (lanes past nrows load the
  // last row again and are never read); lane b holds vs, its share of the
  // step's valid count (rows b, b + 32, ...; masked at use when B < 32).
  // The loads are issued with no instruction that waits on them (the issue
  // is in order: an add on a load just issued would stall the warp for the
  // round trip), except the sum over b when B > 32.
  auto load_info = [&](int t, int& r, float& v, float& vs) {
    const size_t base = (size_t)t * B;
    const int b = w + min(lane, nrows - 1) * NW;
    r = ld_early(a.positions + base + b);
    v = ld_early(a.valid + base + b);
    if (B <= 32) {
      vs = ld_early(a.valid + base + min(lane, B - 1));
    } else {
      vs = 0.f;
      for (int q = lane; q < B; q += 32) vs += ld_early(a.valid + base + q);
    }
  };
  // the label (bits of the target, for regression) of row id r
  auto load_label = [&](int r, int& yb) { yb = ld_early(a.y + r); };
  // Copies this warp's rows (row ids r, lane q holding row q's) into stage
  // st of the ring. The slot was last read by this warp two steps earlier.
  auto issue = [&](int st, int r) {
    float* dst = ring + (size_t)st * B * JCp;
    if (a.bulk) {
      uint64_t* bar = &mbar[st * NW + w];
      if (lane == 0) mbar_expect_tx(bar, (unsigned)(nrows * JC * 4));
      PHASE(0);
      __syncwarp();
      PHASE(1);
      if (lane < nrows) {
        fence_proxy_async_smem();
        PHASE(2);
        bulk_copy(dst + (w + lane * NW) * JCp, a.logits + (size_t)r * JC,
                  (unsigned)(JC * 4), bar);
      }
    } else {
      for (int q = 0; q < nrows; ++q) {
        const int rq = __shfl_sync(kFull, r, q);
        float* d = dst + (w + q * NW) * JCp;
        const float* s = a.logits + (size_t)rq * JC;
        for (int e = lane; e < JC; e += 32) cp_async4(d + e, s + e);
      }
      cp_async_commit();
    }
  };

  // cur: step s; n1: step s + 1 (its label loaded at the top of step s);
  // n2: step s + 2 (loaded at the top of step s)
  int r_n1 = 0, r_n2 = 0, y_cur = 0, y_n1 = 0;
  float v_cur = 0.f, vs_cur = 0.f, v_n1 = 0.f, vs_n1 = 0.f, v_n2 = 0.f,
        vs_n2 = 0.f;
  if (S > 0) {
    int r_cur;
    load_info(0, r_cur, v_cur, vs_cur);
    load_label(r_cur, y_cur);
    issue(0, r_cur);
  }
  if (S > 1) load_info(1, r_n1, v_n1, vs_n1);

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // this warp's
  int par = 0, rounds_sum = 0, rounds_max = 0;  // the guard's (GUARDED)
#ifdef P_EPOCH_PHASE_CLOCKS
  for (int i = 0; i < kPhases; ++i) ph[i] = 0;
  t_last = clock64();
#endif
  for (int s = 0; s < S; ++s) {
    const int st = s & 1;
    if (s + 1 < S) {
      issue(st ^ 1, r_n1);
      PHASE(3);
      load_label(r_n1, y_n1);
    } else if (!a.bulk) {
      cp_async_commit();  // an empty group keeps wait_group<1> uniform
      PHASE(3);
    }
    if (s + 2 < S) load_info(s + 2, r_n2, v_n2, vs_n2);
    PHASE(4);

    const float cnt = warp_sum(lane < B ? vs_cur : 0.f);
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    PHASE(5);
    if (a.bulk) {
      mbar_wait(&mbar[st * NW + w], (unsigned)((s >> 1) & 1));
    } else {
      cp_async_wait<1>();
      __syncwarp();
    }
    PHASE(6);

    for (int q = 0; q < nrows; ++q) {
      const int b = w + q * NW;
      const float* Lr = ring + (size_t)(st * B + b) * JCp;
      float z[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] = 0.f;
      for (int j = lane; j < J; j += 32) {
        float Lj[NC];
        load_row<NC, EXACT>(Lj, Lr + j * C, C);
        const float pj = p[j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          z[c] = fmaf(Lj[c], pj, z[c]);
        }
      }
      warp_sum_classes<NC, EXACT>(z, C, lane);
      PHASE(7);
      const float bv = __shfl_sync(kFull, v_cur, q);
      const int yb = __shfl_sync(kFull, y_cur, q);
      float hit;
      const float loss = row_loss_grad_warp<NC, EXACT>(
          z, C, cls, yb, __int_as_float(yb), bv * inv_cnt, &hit);
      acc_loss += loss * bv;
      acc_hit += hit * bv;
      PHASE(8);
      // h[b, j] = sum_c L[b, j, c] d[b, c]; 0 for an invalid row (d = 0)
      for (int j = lane; j < J; j += 32) {
        float Lj[NC];
        load_row<NC, EXACT>(Lj, Lr + j * C, C);
        float hv = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          hv = fmaf(Lj[c], z[c], hv);
        }
        h[b * J + j] = hv;
      }
      PHASE(9);
    }
    acc_cnt += cnt;
    __syncthreads();  // 1: h complete; every warp is done reading p
    PHASE(10);

    for (int j = tid; j < J; j += nthreads) {
      float g = 0.f;
#pragma unroll 4
      for (int b = 0; b < B; ++b) g += h[b * J + j];
      g *= cvs[j];
      const float bj = a.momentum * buf[j] + g;
      buf[j] = bj;
      p[j] = p[j] - a.lr * bj;
    }
    if constexpr (GUARDED) {
      const int rounds = apply_guard(
          e.guard, e.radius, p, cvs, J, J,
          [&](float& u, float& v) { block_sum2(u, v, red, par, NW); });
      rounds_sum += rounds;
      rounds_max = max(rounds_max, rounds);
    }
    PHASE(11);
    __syncthreads();  // 2: p updated; h free for the next step

    v_cur = v_n1;
    vs_cur = vs_n1;
    y_cur = y_n1;
    r_n1 = r_n2;
    v_n1 = v_n2;
    vs_n1 = vs_n2;
    PHASE(12);
  }
#ifdef P_EPOCH_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < kPhases; ++i) phase_clocks[i] = ph[i];
#endif

  if (lane == 0) {
    red[w] = acc_loss;
    red[NW + w] = acc_hit;
  }
  __syncthreads();
  for (int j = tid; j < J; j += nthreads) {
    a.p_out[j] = p[j];
    a.buf_out[j] = buf[j];
  }
  if (tid == 0) {
    float loss = 0.f, hit = 0.f;
    for (int q = 0; q < NW; ++q) {
      loss += red[q];
      hit += red[NW + q];
    }
    a.metrics[0] = loss;
    a.metrics[1] = hit;
    a.metrics[2] = acc_cnt;
    if (GUARDED && e.guard_rounds != nullptr) {
      e.guard_rounds[0] = rounds_sum;
      e.guard_rounds[1] = rounds_max;
    }
  }
}

template <int NC, bool EXACT, bool GUARDED>
cudaError_t launch_staged(const Args& a, const Ext& x, cudaStream_t stream) {
  const size_t smem = staged_smem_bytes(a.B, a.J, a.C);
  auto kern = staged_p_epoch_kernel<NC, EXACT, GUARDED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<1, 32 * staged_warps(a.B), smem, stream>>>(a, x);
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
// The split kernel: J over a cluster of k CTAs.

// The slice of J one CTA of a k-cluster owns: ceil(J / k) rounded up to 4
// clients, so that every slice of a row starts 16-byte aligned when J*C is
// a multiple of 4. The last slices may be narrower, or empty.
int split_slice(int J, int k) { return round_up((J + k - 1) / k, 4); }

// One slot of the cluster exchange, in floats: a step's partial logits
// (B*C), or the guard's two partial sums.
__host__ __device__ int exchange_floats(int B, int C) {
  return round_up(B * C > 2 ? B * C : 2, 4);
}

// Shared memory of one CTA of the split kernel, in bytes: 2 mbarriers per
// warp, then in floats the ring of its row slices when it holds them (2
// stages * B rows * Jk*C), h (B*Jk), p, buf, cv (Jk each), the per-warp sums
// (4 * warps) and two exchange slots.
size_t split_smem_bytes(int B, int J, int C, int k, int hold) {
  const size_t NW = staged_warps(B), Jk = split_slice(J, k);
  const size_t ring = hold ? 2 * (size_t)B * Jk * C : 0;
  return 16 * NW + (ring + (size_t)B * Jk + 3 * Jk + 4 * NW +
                    2 * (size_t)exchange_floats(B, C)) *
                       sizeof(float);
}

template <int NC, bool EXACT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    split_p_epoch_kernel(const Args a, const Ext e) {
  const int C = EXACT ? NC : a.C;
  const int S = a.S, B = a.B, J = a.J, JC = J * C, k = e.k, Jk = e.Jk;
  const int JkC = Jk * C;  // a multiple of 4, as Jk is
  const int NW = blockDim.x >> 5, nthreads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nrows = (B - 1 - w) / NW + 1;  // rows w, w + NW, ... below B
  const bool cls = a.cls != 0, hold = e.hold != 0;
  const int XS = exchange_floats(B, C);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = rank * Jk;
  const int jw = max(0, min(Jk, J - j0));  // this CTA's clients (maybe 0)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem_raw);  // [2][NW]
  float* ring = reinterpret_cast<float*>(smem_raw + 16 * NW);  // [2][B][JkC]
  float* h = ring + (hold ? 2 * B * JkC : 0);  // [B][Jk]
  float* p = h + B * Jk;
  float* buf = p + Jk;
  float* cvs = buf + Jk;
  float* red = cvs + Jk;     // [4][NW]
  float* xch = red + 4 * NW; // [2][XS], read by the whole cluster

  for (int j = tid; j < jw; j += nthreads) {
    p[j] = a.p0[j0 + j];
    buf[j] = a.buf0[j0 + j];
    cvs[j] = a.cv[j0 + j];
  }
  if (lane == 0) {
    mbar_init(&mbar[w], 1);
    mbar_init(&mbar[NW + w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started before any reads another's
  // shared memory
  cluster.sync();

  // the staged kernel's prefetch of row ids, flags and labels
  auto load_info = [&](int t, int& r, float& v, float& vs) {
    const size_t base = (size_t)t * B;
    const int b = w + min(lane, nrows - 1) * NW;
    r = ld_early(a.positions + base + b);
    v = ld_early(a.valid + base + b);
    if (B <= 32) {
      vs = ld_early(a.valid + base + min(lane, B - 1));
    } else {
      vs = 0.f;
      for (int q = lane; q < B; q += 32) vs += ld_early(a.valid + base + q);
    }
  };
  auto load_label = [&](int r, int& yb) { yb = ld_early(a.y + r); };
  // Copies this CTA's slices of this warp's rows into stage st of the ring
  // (holding only). The slot was last read by this warp two steps earlier.
  auto issue = [&](int st, int r) {
    float* dst = ring + (size_t)st * B * JkC;
    const int n = jw * C;
    if (a.bulk) {
      uint64_t* bar = &mbar[st * NW + w];
      // an empty slice (the last CTAs when ceil(J / k) rounds up) arrives
      // expecting no bytes
      if (lane == 0) mbar_expect_tx(bar, (unsigned)(nrows * n * 4));
      __syncwarp();
      if (lane < nrows && n > 0) {
        fence_proxy_async_smem();
        bulk_copy(dst + (w + lane * NW) * JkC,
                  a.logits + (size_t)r * JC + (size_t)j0 * C,
                  (unsigned)(n * 4), bar);
      }
    } else {
      for (int q = 0; q < nrows; ++q) {
        const int rq = __shfl_sync(kFull, r, q);
        float* d = dst + (w + q * NW) * JkC;
        const float* s = a.logits + (size_t)rq * JC + (size_t)j0 * C;
        for (int i = lane; i < n; i += 32) cp_async4(d + i, s + i);
      }
      cp_async_commit();
    }
  };
  // L[b, j0 + j, :] of this warp's row q (row id rq) into registers: from
  // the ring when holding, else from global memory
  auto row = [&](float(&v)[NC], int st, int b, int rq, int j) {
    if (hold)
      load_row<NC, EXACT>(v, ring + (size_t)(st * B + b) * JkC + j * C, C);
    else
      load_row_global<NC, EXACT>(
          v, a.logits + (size_t)rq * JC + (size_t)(j0 + j) * C, C);
  };

  int r_cur = 0, r_n1 = 0, r_n2 = 0, y_cur = 0, y_n1 = 0;
  float v_cur = 0.f, vs_cur = 0.f, v_n1 = 0.f, vs_n1 = 0.f, v_n2 = 0.f,
        vs_n2 = 0.f;
  if (S > 0) {
    load_info(0, r_cur, v_cur, vs_cur);
    load_label(r_cur, y_cur);
    if (hold) issue(0, r_cur);
  }
  if (S > 1) load_info(1, r_n1, v_n1, vs_n1);

  // The cluster exchanges alternate between two slots: exchange x writes
  // slot x & 1 before its cluster barrier and reads every rank's after it,
  // and a CTA writes that slot again (exchange x + 2) only after the
  // barrier of exchange x + 1, which every CTA reaches after its reads.
  int xc = 0;
  auto cluster_sum2 = [&](float& u, float& v, int& par) {
    block_sum2(u, v, red, par, NW);
    float* slot = xch + (xc & 1) * XS;
    if (tid == 0) {
      slot[0] = u;
      slot[1] = v;
    }
    cluster.sync();
    u = 0.f;
    v = 0.f;
    for (int q = 0; q < k; ++q) {
      const float* rs = cluster.map_shared_rank(slot, q);
      u += rs[0];
      v += rs[1];
    }
    ++xc;
  };

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // this warp's
  int par = 0, rounds_sum = 0, rounds_max = 0;  // the guard's
  for (int s = 0; s < S; ++s) {
    const int st = s & 1;
    if (s + 1 < S) {
      if (hold) issue(st ^ 1, r_n1);
      load_label(r_n1, y_n1);
    } else if (hold && !a.bulk) {
      cp_async_commit();  // an empty group keeps wait_group<1> uniform
    }
    if (s + 2 < S) load_info(s + 2, r_n2, v_n2, vs_n2);

    const float cnt = warp_sum(lane < B ? vs_cur : 0.f);
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    if (hold) {
      if (a.bulk) {
        mbar_wait(&mbar[st * NW + w], (unsigned)((s >> 1) & 1));
      } else {
        cp_async_wait<1>();
        __syncwarp();
      }
    }

    // this CTA's partial z of this warp's rows, over its slice
    float* xs = xch + (xc & 1) * XS;
    for (int q = 0; q < nrows; ++q) {
      const int b = w + q * NW;
      const int rq = __shfl_sync(kFull, r_cur, q);
      float z[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] = 0.f;
      for (int j = lane; j < jw; j += 32) {
        float Lj[NC];
        row(Lj, st, b, rq, j);
        const float pj = p[j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          z[c] = fmaf(Lj[c], pj, z[c]);
        }
      }
      warp_sum_classes<NC, EXACT>(z, C, lane);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (!EXACT && c >= C) break;
        if (lane == c) xs[b * C + c] = z[c];
      }
    }
    cluster.sync();  // every CTA's partials are in its slot

    for (int q = 0; q < nrows; ++q) {
      const int b = w + q * NW;
      const int rq = __shfl_sync(kFull, r_cur, q);
      // lane c sums class c over the ranks in rank order, then every lane
      // takes all C: the same z on every CTA
      float zc = 0.f;
      if (lane < C)
        for (int r = 0; r < k; ++r)
          zc += cluster.map_shared_rank(xs, r)[b * C + lane];
      float z[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] = __shfl_sync(kFull, zc, c);
      const float bv = __shfl_sync(kFull, v_cur, q);
      const int yb = __shfl_sync(kFull, y_cur, q);
      float hit;
      const float loss = row_loss_grad_warp<NC, EXACT>(
          z, C, cls, yb, __int_as_float(yb), bv * inv_cnt, &hit);
      acc_loss += loss * bv;
      acc_hit += hit * bv;
      // h[b, j] over this CTA's slice (the row read a second time)
      for (int j = lane; j < jw; j += 32) {
        float Lj[NC];
        row(Lj, st, b, rq, j);
        float hv = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!EXACT && c >= C) break;
          hv = fmaf(Lj[c], z[c], hv);
        }
        h[b * Jk + j] = hv;
      }
    }
    ++xc;
    acc_cnt += cnt;
    __syncthreads();  // h complete; every warp is done reading p

    for (int j = tid; j < jw; j += nthreads) {
      float g = 0.f;
#pragma unroll 4
      for (int b = 0; b < B; ++b) g += h[b * Jk + j];
      g *= cvs[j];
      const float bj = a.momentum * buf[j] + g;
      buf[j] = bj;
      p[j] = p[j] - a.lr * bj;
    }
    if (e.guard != kGuardNone) {
      const int rounds = apply_guard(
          e.guard, e.radius, p, cvs, jw, J,
          [&](float& u, float& v) { cluster_sum2(u, v, par); });
      rounds_sum += rounds;
      rounds_max = max(rounds_max, rounds);
    }
    __syncthreads();  // p updated; h free for the next step

    r_cur = r_n1;
    v_cur = v_n1;
    vs_cur = vs_n1;
    y_cur = y_n1;
    r_n1 = r_n2;
    v_n1 = v_n2;
    vs_n1 = vs_n2;
  }
  // no CTA leaves while another may still read its exchange slots
  cluster.sync();

  if (lane == 0) {
    red[w] = acc_loss;
    red[NW + w] = acc_hit;
  }
  __syncthreads();
  for (int j = tid; j < jw; j += nthreads) {
    a.p_out[j0 + j] = p[j];
    a.buf_out[j0 + j] = buf[j];
  }
  if (rank == 0 && tid == 0) {
    float loss = 0.f, hit = 0.f;
    for (int q = 0; q < NW; ++q) {
      loss += red[q];
      hit += red[NW + q];
    }
    a.metrics[0] = loss;
    a.metrics[1] = hit;
    a.metrics[2] = acc_cnt;
    if (e.guard_rounds != nullptr) {
      e.guard_rounds[0] = rounds_sum;
      e.guard_rounds[1] = rounds_max;
    }
  }
}

template <int NC, bool EXACT>
cudaError_t launch_split(const Args& a, const Ext& x, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(a.B, a.J, a.C, x.k, x.hold);
  auto kern = split_p_epoch_kernel<NC, EXACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (x.k > kMaxPortableCluster) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)x.k);
  cfg.blockDim = dim3((unsigned)(32 * staged_warps(a.B)));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)x.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a, x);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The unstaged kernel (the port's first design): one CTA of 256 threads,
// each step's block gathered after its row ids are loaded. Only shapes the
// staged and split kernels cannot take run it.

constexpr int kThreads = 256;
constexpr int kUnstagedWarps = kThreads / 32;

// Shared memory, in floats: L block (B*J*C), p (J), buf (J), cv (J),
// z/d (B*C), row_loss (B), row_hit (B), row_ok (B), the guard's per-warp
// sums (4 * warps); then row_id (B ints).
size_t unstaged_smem_bytes(int B, int J, int C) {
  return ((size_t)B * J * C + 3 * (size_t)J + (size_t)B * C + 3 * (size_t)B +
          4 * kUnstagedWarps) *
             sizeof(float) +
         (size_t)B * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
    unstaged_p_epoch_kernel(const float* __restrict__ p0,       // (J,)
                            const float* __restrict__ buf0,     // (J,)
                            const float* __restrict__ cv,       // (J,)
                            const float* __restrict__ logits,   // (n_val, J, C)
                            const int* __restrict__ y_cls,      // (n_val,) or null
                            const float* __restrict__ y_reg,    // (n_val,) or null
                            const int* __restrict__ positions,  // (S, B)
                            const float* __restrict__ valid,    // (S, B)
                            float* __restrict__ p_out,          // (J,)
                            float* __restrict__ buf_out,        // (J,)
                            float* __restrict__ metrics,        // (3,)
                            int* __restrict__ guard_rounds,     // (2,) or null
                            int S, int B, int J, int C, int guard, float lr,
                            float momentum, float radius) {
  extern __shared__ float smem[];
  const int JC = J * C;
  float* L = smem;
  float* p = L + B * JC;
  float* buf = p + J;
  float* cvs = buf + J;
  float* z = cvs + J;
  float* row_loss = z + B * C;
  float* row_hit = row_loss + B;
  float* row_ok = row_hit + B;
  float* scratch = row_ok + B;  // [4][kUnstagedWarps]
  int* row_id = reinterpret_cast<int*>(scratch + 4 * kUnstagedWarps);

  const int tid = threadIdx.x;
  for (int j = tid; j < J; j += kThreads) {
    p[j] = p0[j];
    buf[j] = buf0[j];
    cvs[j] = cv[j];
  }

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // thread 0's
  int par = 0, rounds_sum = 0, rounds_max = 0;          // the guard's
  for (int s = 0; s < S; ++s) {
    // the previous step's readers of L/z/rows and writers of p are done
    __syncthreads();
    for (int b = tid; b < B; b += kThreads) {
      row_id[b] = positions[(size_t)s * B + b];
      row_ok[b] = valid[(size_t)s * B + b];
    }
    __syncthreads();
    // stage this step's (B, J, C) logits block, coalesced per row
    for (int i = tid; i < B * JC; i += kThreads) {
      const int b = i / JC;
      L[i] = logits[(size_t)row_id[b] * JC + (i - b * JC)];
    }
    float cnt = 0.f;
    for (int b = 0; b < B; ++b) cnt += row_ok[b];
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    __syncthreads();

    // z[b, c] = sum_j L[b, j, c] p_j
    for (int i = tid; i < B * C; i += kThreads) {
      const int b = i / C, c = i - b * C;
      const float* Lb = L + b * JC + c;
      float acc = 0.f;
      for (int j = 0; j < J; ++j) acc = fmaf(Lb[j * C], p[j], acc);
      z[i] = acc;
    }
    __syncthreads();

    // per row: loss, top-1 hit, and d = dloss/dz (overwrites z)
    for (int b = tid; b < B; b += kThreads) {
      float* zb = z + b * C;
      const float bv = row_ok[b];
      float hit;
      row_loss[b] = row_loss_grad(zb, C, y_cls, y_reg, row_id[b],
                                  bv * inv_cnt, &hit) * bv;
      row_hit[b] = hit * bv;
    }
    __syncthreads();

    if (tid == 0) {
      float dl = 0.f, hit = 0.f;
      for (int b = 0; b < B; ++b) {
        dl += row_loss[b];
        hit += row_hit[b];
      }
      acc_loss += (dl * inv_cnt) * cnt;
      acc_hit += hit;
      acc_cnt += cnt;
    }

    // g_j = sum_{b,c} L[b, j, c] d[b, c], masked; SGD momentum step
    for (int j = tid; j < J; j += kThreads) {
      float g = 0.f;
      for (int b = 0; b < B; ++b) {
        const float* Lbj = L + b * JC + j * C;
        const float* db = z + b * C;
        for (int c = 0; c < C; ++c) g = fmaf(Lbj[c], db[c], g);
      }
      g *= cvs[j];
      const float bj = momentum * buf[j] + g;
      buf[j] = bj;
      p[j] = p[j] - lr * bj;
    }
    if (guard != kGuardNone) {
      const int rounds = apply_guard(
          guard, radius, p, cvs, J, J, [&](float& u, float& v) {
            block_sum2(u, v, scratch, par, kUnstagedWarps);
          });
      rounds_sum += rounds;
      rounds_max = max(rounds_max, rounds);
    }
  }
  __syncthreads();
  for (int j = tid; j < J; j += kThreads) {
    p_out[j] = p[j];
    buf_out[j] = buf[j];
  }
  if (tid == 0) {
    metrics[0] = acc_loss;
    metrics[1] = acc_hit;
    metrics[2] = acc_cnt;
    if (guard_rounds != nullptr) {
      guard_rounds[0] = rounds_sum;
      guard_rounds[1] = rounds_max;
    }
  }
}

Args make_args(const void* p0, const void* buf0, const void* cv,
               const void* logits, const void* y, const void* positions,
               const void* valid, void* p_out, void* buf_out, void* metrics,
               int S, int B, int J, int C, int is_cls, int bulk, float lr,
               float momentum) {
  Args a;
  a.p0 = static_cast<const float*>(p0);
  a.buf0 = static_cast<const float*>(buf0);
  a.cv = static_cast<const float*>(cv);
  a.logits = static_cast<const float*>(logits);
  a.y = static_cast<const int*>(y);
  a.positions = static_cast<const int*>(positions);
  a.valid = static_cast<const float*>(valid);
  a.p_out = static_cast<float*>(p_out);
  a.buf_out = static_cast<float*>(buf_out);
  a.metrics = static_cast<float*>(metrics);
  a.S = S;
  a.B = B;
  a.J = J;
  a.C = C;
  a.cls = is_cls;
  a.bulk = bulk;
  a.lr = lr;
  a.momentum = momentum;
  return a;
}

Ext make_ext(void* guard_rounds, int guard, float radius, int k, int Jk,
             int hold) {
  Ext x;
  x.guard_rounds = static_cast<int*>(guard_rounds);
  x.guard = guard;
  x.k = k;
  x.Jk = Jk;
  x.hold = hold;
  x.radius = radius;
  return x;
}

}  // namespace

extern "C" {

// Dynamic shared memory of each kernel, the staged and split kernels' warps,
// the split kernel's slice and the class count of the instantiation that
// runs C classes (0: none); the wrapper's launch plan computes the same
// numbers and checks them against these before every launch.
size_t p_epoch_staged_smem_bytes(int B, int J, int C) {
  return staged_smem_bytes(B, J, C);
}

size_t p_epoch_split_smem_bytes(int B, int J, int C, int k, int hold) {
  return split_smem_bytes(B, J, C, k, hold);
}

size_t p_epoch_unstaged_smem_bytes(int B, int J, int C) {
  return unstaged_smem_bytes(B, J, C);
}

int p_epoch_staged_warps(int B) { return staged_warps(B); }

int p_epoch_split_slice(int J, int k) { return split_slice(J, k); }

int p_epoch_instantiated_classes(int C) { return instantiated_classes(C); }

// The largest cluster the split kernel may launch on this card: 16 when
// cudaOccupancyMaxActiveClusters finds room for one 16-CTA cluster of the
// largest CTA (512 threads, a full block of shared memory), else the
// portable 8.
int p_epoch_split_max_cluster(void) {
  auto kern = split_p_epoch_kernel<32, false>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit) != cudaSuccess) {
    cudaGetLastError();
    return kMaxPortableCluster;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(32 * kMaxWarps);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  cudaGetLastError();  // a refusal here must not reach a later launch's check
  return (e == cudaSuccess && clusters > 0) ? kMaxCluster
                                            : kMaxPortableCluster;
}

// One launch of the staged kernel: one epoch. is_cls selects int32 labels or
// float32 targets behind y; bulk selects cp.async.bulk row copies (J*C % 4 ==
// 0 and logits 16-byte aligned); guard is 0 (none), 1 (clip to radius) or 2
// (simplex); guard_rounds (2 int32, or null) receives the simplex's fixed
// point rounds. Returns cudaGetLastError() after the launch.
int p_epoch_launch_staged(const void* p0, const void* buf0, const void* cv,
                          const void* logits, const void* y,
                          const void* positions, const void* valid,
                          void* p_out, void* buf_out, void* metrics,
                          void* guard_rounds, int S, int B, int J, int C,
                          int is_cls, int bulk, int guard, float lr,
                          float momentum, float radius, void* stream) {
  if (B < 1 || B > kMaxStagedBatch || J < 1) return cudaErrorInvalidValue;
  const Args a = make_args(p0, buf0, cv, logits, y, positions, valid, p_out,
                           buf_out, metrics, S, B, J, C, is_cls, bulk, lr,
                           momentum);
  const Ext x = make_ext(guard_rounds, guard, radius, 1, J, 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    constexpr int NC = decltype(n)::value;
    constexpr bool EXACT = decltype(exact)::value;
    return guard != kGuardNone ? launch_staged<NC, EXACT, true>(a, x, s)
                               : launch_staged<NC, EXACT, false>(a, x, s);
  }));
}

// One launch of the split kernel: one epoch on one cluster of k CTAs, each
// owning split_slice(J, k) clients; hold selects the ring (the slices of a
// step's rows staged in shared memory) over reading them from global
// memory. Other arguments as p_epoch_launch_staged.
int p_epoch_launch_split(const void* p0, const void* buf0, const void* cv,
                         const void* logits, const void* y,
                         const void* positions, const void* valid,
                         void* p_out, void* buf_out, void* metrics,
                         void* guard_rounds, int S, int B, int J, int C,
                         int is_cls, int bulk, int guard, int k, int hold,
                         float lr, float momentum, float radius,
                         void* stream) {
  if (B < 1 || B > kMaxStagedBatch || J < 1 || k < 2 || k > kMaxCluster)
    return cudaErrorInvalidValue;
  const Args a = make_args(p0, buf0, cv, logits, y, positions, valid, p_out,
                           buf_out, metrics, S, B, J, C, is_cls, bulk, lr,
                           momentum);
  const Ext x = make_ext(guard_rounds, guard, radius, k, split_slice(J, k),
                         hold);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    return launch_split<decltype(n)::value, decltype(exact)::value>(a, x, s);
  }));
}

#ifdef P_EPOCH_PHASE_CLOCKS
// The phase clocks of the last staged launch (kPhases counters).
int p_epoch_phase_clocks(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks)));
}
#endif

// One launch of the unstaged kernel: one epoch, same arguments but bulk.
int p_epoch_launch_unstaged(const void* p0, const void* buf0, const void* cv,
                            const void* logits, const void* y,
                            const void* positions, const void* valid,
                            void* p_out, void* buf_out, void* metrics,
                            void* guard_rounds, int S, int B, int J, int C,
                            int is_cls, int guard, float lr, float momentum,
                            float radius, void* stream) {
  const size_t smem = unstaged_smem_bytes(B, J, C);
  cudaError_t e = cudaFuncSetAttribute(
      unstaged_p_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  unstaged_p_epoch_kernel<<<1, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p0), static_cast<const float*>(buf0),
      static_cast<const float*>(cv), static_cast<const float*>(logits),
      is_cls ? static_cast<const int*>(y) : nullptr,
      is_cls ? nullptr : static_cast<const float*>(y),
      static_cast<const int*>(positions), static_cast<const float*>(valid),
      static_cast<float*>(p_out), static_cast<float*>(buf_out),
      static_cast<float*>(metrics), static_cast<int*>(guard_rounds), S, B, J,
      C, guard, lr, momentum, radius);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
