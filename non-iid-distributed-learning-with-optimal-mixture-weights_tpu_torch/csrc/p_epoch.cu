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
// (aggregate.py:_make_guard) as an epilogue of the p update (warp_guard,
// one warp over the whole of p in every kernel, with no barrier inside its
// fixed point): clip:R or the projection onto the simplex over the valid
// clients; the momentum buffer is not projected (projected SGD).
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
//    the momentum and p updates (guarded, the warps holding clients then
//    meet at a named barrier of their own and warp 0 projects p alone,
//    warp_guard); barrier 2. Two block barriers a step.
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
// gathered row. What bounds it is still a step's latency, and a step adds
// one exchange of partial logits across the cluster to the staged kernel's
// (measured on an H100, tools/p_epoch_phases.py: 0.5-0.7 us a step at 4-8
// CTAs, 1.0 at 16). Its design (split_p_epoch_kernel below):
//  - a producer warp beside one consumer warp a batch row streams each
//    step's row slices through a ring of cp.async.bulk tiles on full and
//    empty mbarriers, and the step's labels, valid flags and their count
//    through two slots of shared memory, so the consumers issue no copy and
//    no global load;
//  - the partial logits are pushed (st.async, 16 bytes at a time) into
//    every CTA's slot for this rank, completing bytes on the receiving
//    warp's own mbarrier; each warp waits on its own and sums the k slots
//    in rank order from its own shared memory: no cluster barrier between
//    the start and the end;
//  - a ring of whole slices held from the z pass to the h pass where it
//    fits (rows copied once a step), else narrower tiles copied for each
//    pass; two block barriers a step around the update of the slice.
// A guard takes one more exchange a step, a gather of the whole of p. The
// cluster is a rule fitted to the card's readings
// (psolver_kernel._split_cluster).
//
// Past 32 classes at B <= 512, the class-tiled split kernel
// (split_tiled_p_epoch_kernel below): C a run-time argument, the classes
// over a cluster of 1 to 16 CTAs, each reading its class slices from a
// class-split copy of the logits through a producer warp's ring, z local,
// the loss's row statistics and then g pushed between the CTAs, p
// replicated. B > 512 runs the unstaged kernel below, the port's first
// design: one CTA of 256 threads that gathers each step's (B, J, C) block
// after loading the step's row ids, five block barriers per step, where
// that block fits one CTA. Only B > 512 past the unstaged kernel, or a
// class slice of which two stages of one row and client pass a block (C
// past ~220,000 at J = 50), is left without a kernel.

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

// Clients a lane of the guard's warp holds in registers (warp_guard's NR),
// the first of its ceil(J / 32); it reads the rest from memory again
// every sum, four at a time. Each kernel's is the most that adds no spill
// (the split kernels run 17 warps, 96 registers a thread) and measured
// fastest (tools/p_epoch_variants.py, PERF.md § 6): 8 in the one-CTA
// kernels (none in the staged kernel's rounded 32-class instantiation),
// 16 in the split kernel below 26 classes and none from 26 on or in the
// class-tiled split kernel.
constexpr int kGuardRegs = 8;
template <int NC>
__host__ __device__ constexpr int staged_guard_regs() {
  return NC < 32 ? kGuardRegs : 0;
}
template <int NC>
__host__ __device__ constexpr int split_guard_regs() {
  return NC < 26 ? 16 : 0;
}

// The p-guard, after the p update, on the whole of p by one warp: every
// lane of the warp calls it, no other warp. Semantics of the JAX package's
// aggregate.py:_make_guard:
//  - clip: p *= min(1, radius / max(||p||, 1e-30)), the norm over every
//    client, valid or not;
//  - simplex: the Euclidean projection onto the simplex over the valid
//    clients (cv > 0); invalid entries become 0, and every entry does when
//    no client is valid. Michelot's fixed point instead of a sort: theta
//    from a support, then theta = (sum of the support - 1) / |support|
//    with support = {valid j : p_j > theta}, until the support stops
//    shrinking (its size is all a round compares: supports are upper sets
//    of one threshold, so nested); p = max(p - theta, 0). The final theta
//    is the sort-based formula (aggregate.project_simplex) over the same
//    support. The first support is {valid j : p_j > start}, start the last
//    step's theta (-inf at a launch's first step; every valid client where
//    none passes it): the theta of any set of clients is at most the
//    projection's, so the rounds from it rise to the same fixed point,
//    and where the support held from the last step they stop after one.
//    A round whose theta does not rise (rounding, near a tie) ends them.
//    start returns the new theta. At most J + 1 rounds.
// Lane l takes clients l, l + 32, ... (the first NR in registers); for the
// simplex an invalid client, and for both a client past J, reads as -inf
// (0 for clip), which passes no theta. Every lane runs the same number of
// clients (lane 0's), in quads, with selects and no branch, so a round is
// its loads and adds, a butterfly and a division. A sum is each lane's
// partial sum over its clients in order, then warp_sum's butterfly, the
// same bits on every lane (aggregate.warp_order_sum mirrors it); the
// support's size an integer warp reduction (redux.sync). So no barrier
// and no cluster exchange sits inside the fixed point, and every CTA that
// projects the same p gets the same bits. Reads src and cv (J each);
// writes dst[j - lo] for lo <= j < hi (a CTA's slice of p; the whole of
// it, in place, with src == dst, lo 0 and hi J: a lane writes only its own
// clients, after its last read). Returns the fixed point's rounds: the
// support's sums after the first (0 for clip and where no client is
// valid).
#ifdef P_EPOCH_PHASE_CLOCKS
// A measurement build only: clock64 cycles the split kernel's rank 0 lane 0
// spends in warp_guard's parts, summed over the last launch: 0 the loads
// into registers, 1 the first sum, 2 the rounds, 3 the write.
__device__ unsigned long long guard_part_clocks[4];
#define GPART(i)                             \
  if (clk != nullptr) {                      \
    const long long now_ = clock64();        \
    clk[i] += now_ - g_last;                 \
    g_last = now_;                           \
  }
#else
#define GPART(i)
#endif

template <int NR>
__device__ int warp_guard(int guard, float radius, const float* src,
                          const float* cv, int J, float* dst, int lo, int hi,
                          float& start, long long* clk = nullptr) {
  static_assert(NR % 4 == 0, "a lane's clients in quads");
#ifdef P_EPOCH_PHASE_CLOCKS
  long long g_last = clock64();
#endif
  const int lane = threadIdx.x & 31;
  const int rows = (J + 31) / 32;  // lane 0's clients, the most of any lane
  const bool simplex = guard == kGuardSimplex;
  const float none = simplex ? -__int_as_float(0x7f800000) : 0.f;
  // client lane + 32 i as the guard reads it: both loads unconditional
  // (addresses clamped below J) and the tests without short circuits, so
  // no branch waits on a load and the loads of a quad issue together
  auto get = [&](int i) -> float {
    const int j = lane + 32 * i, jc = min(j, J - 1);
    const float x = src[jc], c = cv[jc];
    return ((j < J) & (!simplex | (c > 0.f))) ? x : none;
  };
  float v[NR > 0 ? NR : 4];
#pragma unroll
  for (int i = 0; i < NR; i += 4) {
    if (i >= rows) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[i + q] = get(i + q);
  }
  GPART(0);
  // f(x) over this lane's clients in order, a quad at a time
  auto each = [&](auto&& f) {
#pragma unroll
    for (int i = 0; i < NR; i += 4) {
      if (i >= rows) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) f(v[i + q]);
    }
#pragma unroll 2
    for (int i = NR; i < rows; i += 4) {
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = get(i + q);
#pragma unroll
      for (int q = 0; q < 4; ++q) f(x[q]);
    }
  };
  // the warp's sum of the clients above theta, and their count
  auto above = [&](float theta, int& c) -> float {
    float t = 0.f;
    int k = 0;
    each([&](float x) {
      const bool in = x > theta;
      t += in ? x : 0.f;
      k += in;
    });
    c = __reduce_add_sync(kFull, k);
    return warp_sum(t);
  };
  float scale = 1.f, theta = 0.f;
  int rounds = 0;
  if (!simplex) {
    float ss = 0.f;
    each([&](float x) { ss = fmaf(x, x, ss); });
    ss = warp_sum(ss);
    scale = fminf(1.f, radius / fmaxf(sqrtf(ss), 1e-30f));
  } else {
    int m;
    float s = above(start, m);
    if (m == 0 && start != none) s = above(none, m);  // every valid client
    GPART(1);
    if (m > 0) {
      theta = (s - 1.f) / (float)m;
      int prev = m;
      while (rounds <= J) {
        int c;
        const float t = above(theta, c);
        ++rounds;
        if (c == prev || c == 0) break;
        const float next = (t - 1.f) / (float)c;
        // theta only rises: one that does not (an entry within the sums'
        // rounding of it, whose support would otherwise come and go
        // every round until J + 1) is the fixed point
        if (!(next > theta)) break;
        theta = next;
        prev = c;
      }
      start = theta;
    }
    GPART(2);
  }
  // clip: p * scale; simplex: max(p - theta, 0), 0 for an invalid client
  auto out = [&](float x) {
    return simplex ? fmaxf(x - theta, 0.f) : x * scale;
  };
#pragma unroll
  for (int i = 0; i < NR; i += 4) {
    if (i >= rows) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = lane + 32 * (i + q);
      if ((j >= lo) & (j < hi)) dst[j - lo] = out(v[i + q]);
    }
  }
  // past the registers, only this lane's clients in [lo, hi)
  for (int i = max(NR, (lo - lane + 31) / 32); i < rows; ++i) {
    const int j = lane + 32 * i;
    if (j >= hi) break;
    dst[j - lo] = out(get(i));
  }
  GPART(3);
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

// What the guard epilogue adds, as a parameter of its own: the same fields
// appended to Args (28 bytes more) made ptxas compile the unguarded staged
// kernel with 93 registers instead of 123 and ~5% slower a step (1.572
// against 1.498 ms at the main shape, same card, same call), even where it
// never reads them. (The split kernels take their own, SplitExt and
// TiledArgs.)
struct Ext {
  int* guard_rounds;  // (2,): the simplex's rounds over all steps and in
                      // the step that took most; or null
  int guard;
  float radius;
};

int staged_warps(int B) { return B < kMaxWarps ? B : kMaxWarps; }

// Shared memory of the staged kernel, in bytes: 2 mbarriers per warp (one
// per stage), then in floats the ring (2 stages * B rows * JCp, each row
// padded to 4 floats so every row starts 16-byte aligned), h (B*J), p, buf,
// cv (J each) and the per-warp sums (4 * warps: the metrics at the end use
// two; the other two held the guard's block reductions before the guard
// became one warp's, and stay so that every plan keeps its bytes).
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
// 7 z and its warp sums, 8 row loss, 9 h, 10 barrier 1, 11 p update, 12
// guard, 13 barrier 2 and the shift of the prefetched registers
// (p_epoch_phase_names).
constexpr int kPhases = 14;
__device__ unsigned long long phase_clocks[kPhases];
#define PHASE(i)                      \
  if (tid == 0) {                     \
    const long long now_ = clock64(); \
    ph[i] += now_ - t_last;           \
    t_last = now_;                    \
  }
// The split kernel's phases, counted by thread 0 of rank 0 the same way:
// 0 copy issue, 1 prefetch loads, 2 valid count, 3 wait for the rows, 4 z
// (partial logits and their warp sums), 5 the cluster exchange, 6 row
// loss, 7 h, 8 block barriers, 9 p update (and the gather's pushes), 10
// the gather's wait, 11 the guard's projection (p_epoch_split_phase_names).
constexpr int kSplitPhases = 12;
__device__ unsigned long long split_phase_clocks[kSplitPhases];
#define SPHASE(i)                     \
  if (timing) {                       \
    const long long now_ = clock64(); \
    ph[i] += now_ - t_last;           \
    t_last = now_;                    \
  }
#else
#define PHASE(i)
#define SPHASE(i)
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
  int rounds_sum = 0, rounds_max = 0;  // the guard's (GUARDED: warp 0's)
  float guard_theta = -__int_as_float(0x7f800000);  // warp_guard's start
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

    if constexpr (GUARDED) {
      // the warps that hold clients (UW of them) update them, meet at a
      // named barrier of their own, and warp 0 projects p alone; the other
      // warps go on to barrier 2
      const int UW = min(NW, (J + 31) / 32);
      if (w < UW) {
        for (int j = tid; j < J; j += 32 * UW) {
          float g = 0.f;
#pragma unroll 4
          for (int b = 0; b < B; ++b) g += h[b * J + j];
          g *= cvs[j];
          const float bj = a.momentum * buf[j] + g;
          buf[j] = bj;
          p[j] = p[j] - a.lr * bj;
        }
        asm volatile("bar.sync 2, %0;\n" ::"r"(32 * UW) : "memory");
        PHASE(11);
        if (w == 0) {
          const int rounds = warp_guard<staged_guard_regs<NC>()>(
              e.guard, e.radius, p, cvs, J, p, 0, J, guard_theta);
          rounds_sum += rounds;
          rounds_max = max(rounds_max, rounds);
        }
      }
    } else {
      for (int j = tid; j < J; j += nthreads) {
        float g = 0.f;
#pragma unroll 4
        for (int b = 0; b < B; ++b) g += h[b * J + j];
        g *= cvs[j];
        const float bj = a.momentum * buf[j] + g;
        buf[j] = bj;
        p[j] = p[j] - a.lr * bj;
      }
      PHASE(11);
    }
    PHASE(12);
    __syncthreads();  // 2: p updated; h free for the next step

    v_cur = v_n1;
    vs_cur = vs_n1;
    y_cur = y_n1;
    r_n1 = r_n2;
    v_n1 = v_n2;
    vs_n1 = vs_n2;
    PHASE(13);
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

// What the split kernel adds to Args: the guard, the cluster and the slice
// as Ext, and its ring: row tiles of `tile` clients of the slice, `stages`
// of them, and whether a tile stays in its stage from the z pass to the h
// pass (hold: tile == Jk) or is copied again for the h pass.
struct SplitExt {
  int* guard_rounds;
  int guard;
  int k, Jk, tile, stages, hold;
  float radius;
};

constexpr int kSplitMaxStages = 8;

// One rank's slot of the split kernel's exchange, in floats: a group's
// partial logits, one row a warp, each row padded to 4 floats (16-byte
// pushes); the guard's two sums take the first two of each warp's row.
__host__ __device__ int split_slot_floats(int NW, int C) {
  return NW * round_up(C, 4);
}

// floats of one slot of the split kernel's row information: a step's B
// labels (or targets' bits), B valid flags and their count, padded to 4
__host__ __device__ int split_info_floats(int B) {
  return round_up(2 * B + 1, 4);
}

// What a guard adds to one CTA of the split kernel, in floats: the whole of
// p gathered from the cluster every step and the whole of cv (k*Jk each;
// clip's k*kMaxWarps partial sums take the same room, at least as much of
// it), then the exchange's mbarrier (4 floats, with its padding)
__host__ __device__ int split_guard_floats(int J, int k) {
  const int Jk = split_slice(J, k);
  return k * (2 * Jk > kMaxWarps ? 2 * Jk : kMaxWarps) + 4;
}

// Shared memory of one CTA of the split kernel with NW consumer warps and
// a ring of `stages` stages of `tile` clients, in bytes: the mbarriers (a
// full one a stage and warp, an empty one a stage, an exchange one a slot
// set and warp, and a full and an empty one for each of the two slots of
// row information; padded to 16 bytes), the two row-information slots,
// then in floats the stages (NW rows of tile*C logits each), the two slot
// sets of the exchange, one slot a rank (2*k*slot), h (NW*Jk: each warp's
// rows summed), p, buf and cv (Jk each) and the per-warp sums (4*NW);
// guarded, split_guard_floats more.
size_t split_ring_bytes(int B, int J, int C, int k, int NW, int tile,
                        int stages, int guarded) {
  const size_t Jk = split_slice(J, k);
  const size_t header = round_up(8 * (stages * (NW + 1) + 2 * NW + 4), 16);
  return header + (2 * (size_t)split_info_floats(B) +
                   (size_t)stages * NW * tile * C +
                   2 * (size_t)k * split_slot_floats(NW, C) +
                   (size_t)NW * Jk + 3 * Jk + 4 * (size_t)NW +
                   (guarded ? split_guard_floats(J, k) : 0)) *
                      sizeof(float);
}

// The split kernel's layout at (B, J, C, k): holding (hold), one tile of
// the whole slice a stage and a warp a row (staged_warps), as many stages
// as fit up to kSplitMaxStages, at least 2; streaming, the widest tile (the
// slice halved, then halved again, rounded up to 4 clients) of which 2
// stages fit, then as many stages as fit, with a warp a row or, where no
// tile fits, half as many warps (each taking twice the rows; at most 32 a
// warp), and so on. (Four stages of narrower tiles measured slower: a
// tile under 32 clients leaves lanes idle.) Where nothing fits, the least
// layout, whose bytes are past the limit.
struct SplitLayout {
  size_t smem;
  int tile, stages, warps;
};

SplitLayout split_layout(int B, int J, int C, int k, int hold, int guarded) {
  const int Jk = split_slice(J, k), least_warps = (B + 31) / 32;
  const int first = hold ? Jk : round_up((Jk + 1) / 2, 4);
  auto fits = [&](int NW, int tile, int stages) {
    return split_ring_bytes(B, J, C, k, NW, tile, stages, guarded) <=
           (size_t)kSmemLimit;
  };
  for (int NW = staged_warps(B); NW >= least_warps && NW >= 1; NW /= 2) {
    for (int tile = first;; tile = round_up((tile + 1) / 2, 4)) {
      if (fits(NW, tile, 2)) {
        int stages = 2;
        while (stages < kSplitMaxStages && fits(NW, tile, stages + 1))
          ++stages;
        return {split_ring_bytes(B, J, C, k, NW, tile, stages, guarded), tile,
                stages, NW};
      }
      if (hold || tile == 4) break;
    }
    if (hold) break;
  }
  const int NW = staged_warps(B), tile = hold ? Jk : 4;
  return {split_ring_bytes(B, J, C, k, NW, tile, 2, guarded), tile, 2, NW};
}

// v (4 floats) stored at shared::cluster address `a` (16-byte aligned) of a
// CTA of the cluster, completing 16 bytes on the mbarrier at
// shared::cluster address `bar` of the same CTA
__device__ __forceinline__ void st_async4(uint32_t a, float v0, float v1,
                                          float v2, float v3, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(a),
      "f"(v0), "f"(v1), "f"(v2), "f"(v3), "r"(bar)
      : "memory");
}

// the same for 1 float (4-byte aligned), completing 4 bytes
__device__ __forceinline__ void st_async1(uint32_t a, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(a),
      "f"(v), "r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: what the cluster's st.async
// wrote before completing the phase is visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// the block barrier of the consumer warps alone (named barrier 1)
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// L[b, j, :] from a ring row into registers: load_row for an exact class
// count; a rounded instantiation clamps its loads to class C - 1 (no load
// waits behind a branch), and the classes from C on are dropped where they
// are used (their logits are 0 after the exchange, their d 0)
template <int NC, bool EXACT>
__device__ __forceinline__ void split_row(float (&v)[NC], const float* src,
                                          int C) {
  if constexpr (EXACT) {
    load_row<NC, true>(v, src, NC);
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] = src[min(c, C - 1)];
  }
}

// NW consumer warps (one a batch row, rows w, w + NW, ...) and one producer
// warp (warp NW) per CTA; a cluster of k CTAs, each owning a slice of Jk
// clients of p, buf, cv and of every row.
//  - The producer streams each step's row slices into a ring of `stages`
//    stages of (NW rows, tile clients): per group of NW rows and per tile
//    one cp.async.bulk a row on the stage's full mbarrier (element-wise
//    cp.async where rows are not 16-byte aligned), each stage reissued once
//    all NW consumer warps have released it on its empty mbarrier. Holding,
//    a stage keeps its tile of the whole slice from the z pass to the h
//    pass (rows copied once a step); streaming, the tiles are copied again
//    for the h pass. The consumers issue no copy.
//  - z: each warp sums its row's partial logits over the slice (lanes over
//    clients, the class loop in registers, a warp sum), then pushes them
//    into its part of its rank's slot in every CTA of the cluster with
//    16-byte st.async, which complete bytes on that CTA's exchange
//    mbarrier; each CTA waits on its own mbarrier alone and sums the k
//    slots from its own shared memory in rank order: the same z on every
//    CTA. Two slot sets alternate; a set is written again two exchanges
//    later, which a peer reaches only after every warp of this CTA pushed
//    the exchange between, after reading this one. No cluster barrier
//    between the start and the end.
//  - The loss and d of every row, redundantly on every CTA, then h over
//    the slice, each warp's rows summed in row order.
//  - Two block barriers a step (the consumers'), around the update of the
//    slice by a thread a client (g_j over the warps in order). Each warp
//    repeating the whole update instead, with no second barrier, measured
//    slower: its reads of h are NW times the shared-memory traffic.
//  - The simplex guard: the update pushes the slice's new p (a quad of
//    clients a lane, 16 bytes to every CTA) into a J-float gather on one
//    mbarrier instead of storing it, and warp 0 of each CTA waits for the
//    whole of p, projects it (warp_guard, cv loaded whole at the start)
//    and keeps its slice, while the other warps wait at the step's last
//    barrier: one exchange a step, none inside the fixed point. Clip keeps
//    one sum (measured faster than the gather at 1,024 clients): each
//    warp pushes the squares of its clients' new p to every CTA, and each
//    thread sums the k*NW partial sums in one order and scales its own
//    clients. One buffer and one mbarrier suffice: a peer pushes step s +
//    1's only after its z exchanges of step s + 1, which need this CTA's
//    pushes of them, made after it read step s's. Whether a guard runs
//    is a template parameter (GUARDED), as in the staged kernel: the
//    unguarded instantiation holds none of this code.
template <int NC, bool EXACT, bool GUARDED>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 1)
    split_p_epoch_kernel(const Args a, const SplitExt e) {
  constexpr int NCH = (NC + 3) / 4;  // 16-byte chunks of a row's logits
  const int C = EXACT ? NC : a.C;
  const int S = a.S, B = a.B, J = a.J, JC = J * C, k = e.k, Jk = e.Jk;
  const int Jt = e.tile, NS = e.stages;
  const bool hold = e.hold != 0;
  const int NW = (blockDim.x >> 5) - 1;  // consumer warps; warp NW produces
  const int nthreads = 32 * NW;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int G = (B + NW - 1) / NW;  // groups of NW rows
  const bool cls = a.cls != 0;
  const int CP = round_up(C, 4);    // a row of a slot
  const int XS = split_slot_floats(NW, C);
  const int RS = Jt * C;  // floats of a row's tile, a multiple of 4

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j0 = rank * Jk;
  const int jw = max(0, min(Jk, J - j0));  // this CTA's clients (maybe 0)
  const int T = (jw + Jt - 1) / Jt;        // its tiles of the slice

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [NS][NW]
  uint64_t* empty = full + NS * NW;                         // [NS]
  uint64_t* xbar = empty + NS;                              // [2][NW]
  uint64_t* ifull = xbar + 2 * NW;                          // [2]
  uint64_t* iempty = ifull + 2;                             // [2]
  const int IS = split_info_floats(B);
  float* info = reinterpret_cast<float*>(
      smem_raw + round_up(8 * (NS * (NW + 1) + 2 * NW + 4), 16));  // [2][IS]
  float* ring = info + 2 * IS;  // [NS][NW][RS]
  float* xch = ring + NS * NW * RS;  // [2][k][XS], written by the cluster
  float* h = xch + 2 * k * XS;       // [NW][Jk]
  float* p = h + NW * Jk;
  float* buf = p + Jk;
  float* cvs = buf + Jk;
  float* red = cvs + Jk;  // [4][NW]
  // GUARDED only (split_guard_floats): the gather of p (or clip's partial
  // sums), cv whole, the exchange's mbarrier
  float* pall = red + 4 * NW;    // [k * Jk], written by the cluster
  float* cvall = pall + k * Jk;  // [k * Jk]
  uint64_t* gbar = reinterpret_cast<uint64_t*>(
      pall + k * (2 * Jk > kMaxWarps ? 2 * Jk : kMaxWarps));

  for (int j = tid; j < jw; j += blockDim.x) {
    p[j] = a.p0[j0 + j];
    buf[j] = a.buf0[j0 + j];
    cvs[j] = a.cv[j0 + j];
  }
  if constexpr (GUARDED)
    for (int j = tid; j < k * Jk; j += blockDim.x)
      cvall[j] = j < J ? a.cv[j] : 0.f;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      for (int q = 0; q < NW; ++q) mbar_init(&full[s * NW + q], 1);
      mbar_init(&empty[s], NW);
    }
    for (int q = 0; q < 2 * NW; ++q) mbar_init(&xbar[q], 1);
    for (int q = 0; q < 2; ++q) {
      mbar_init(&ifull[q], 1);
      mbar_init(&iempty[q], NW);
    }
    if constexpr (GUARDED) mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every CTA's exchange mbarriers are initialised before any is pushed to
  cluster.sync();

  if (w == NW) {
    // ---- the producer warp: each step's row information, then its ring
    // entries in the consumers' order ----
    int ent = 0;
    for (int s = 0; s < S; ++s) {
      // labels, valid flags and their count (the staged kernel's fixed
      // order) into information slot s & 1, once the consumers are done
      // with step s - 2
      if (s >= 2) mbar_wait(&iempty[s & 1], (unsigned)(((s >> 1) - 1) & 1));
      float* inf = info + (s & 1) * IS;
      const size_t base = (size_t)s * B;
      float vs = 0.f;
      for (int b = lane; b < B; b += 32) {
        const float v = ld_early(a.valid + base + b);
        inf[b] = __int_as_float(ld_early(a.y + ld_early(a.positions + base +
                                                        b)));
        inf[B + b] = v;
        vs += v;
      }
      const float cnt = warp_sum(vs);
      if (lane == 0) inf[2 * B] = cnt;
      __syncwarp();
      if (lane == 0) mbar_arrive(&ifull[s & 1]);
      for (int q = 0; q < G; ++q) {
        const int nr = min(NW, B - q * NW);
        const int r = ld_early(a.positions + (size_t)s * B + q * NW +
                               min(lane, nr - 1));
        for (int pass = 0; pass < (hold ? 1 : 2); ++pass) {
          for (int t = 0; t < T; ++t, ++ent) {
            const int st = ent % NS, u = ent / NS;
            if (u > 0) mbar_wait(&empty[st], (unsigned)((u - 1) & 1));
            float* dst = ring + st * NW * RS;
            uint64_t* bar = &full[st * NW + lane];  // lane q's: warp q's
            const int wt = min(Jt, jw - t * Jt);
            const float* src = a.logits + (size_t)(j0 + t * Jt) * C;
            if (a.bulk) {
              // a row a lane on its warp's barrier; a warp with no row in
              // the group gets an arrival alone
              if (lane < nr) {
                mbar_expect_tx(bar, (unsigned)(wt * C * 4));
                bulk_copy(dst + lane * RS, src + (size_t)r * JC,
                          (unsigned)(wt * C * 4), bar);
              } else if (lane < NW) {
                mbar_arrive(bar);
              }
            } else {
              for (int qq = 0; qq < nr; ++qq) {
                const int rq = __shfl_sync(kFull, r, qq);
                for (int i = lane; i < wt * C; i += 32)
                  cp_async4(dst + qq * RS + i, src + (size_t)rq * JC + i);
              }
              cp_async_commit();
              cp_async_wait<0>();
              __syncwarp();
              if (lane < NW) mbar_arrive(bar);
            }
          }
        }
      }
    }
    cluster.sync();  // the consumers' last
    return;
  }

  // ---- the NW consumer warps ----
  const int nrows = (B - 1 - w) / NW + 1;  // rows w, w + NW, ... below B
  const uint32_t xch_a = smem_addr(xch), xbar_a = smem_addr(xbar);

  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  // Exchange x: slot set x & 1, phase x >> 1 of each warp's mbarrier
  // xbar[x & 1][w], which only warp w of every rank pushes to. Lane 0
  // arrives on this warp's expecting the k ranks' bytes; lane q < k pushes
  // the warp's row of this rank's slot to CTA q; then the warp waits for
  // its row of its own CTA's slots.
  int x = 0;
  auto begin = [&](int bytes, uint32_t& slot, uint32_t& bar) {
    const int set = x & 1;
    if (lane == 0) mbar_expect_tx(&xbar[set * NW + w], (unsigned)bytes);
    const int q = lane < k ? lane : 0;  // the CTA this lane pushes to
    slot = cluster_map(xch_a + 4 * ((set * k + rank) * XS + w * CP), q);
    bar = cluster_map(xbar_a + 8 * (set * NW + w), q);
  };
  auto wait_slots = [&]() -> const float* {
    const int set = x & 1;
    mbar_wait_cluster(&xbar[set * NW + w], (unsigned)((x >> 1) & 1));
    ++x;
    return xch + set * k * XS + w * CP;
  };
  const uint32_t pall_a = smem_addr(pall), gbar_a = smem_addr(gbar);

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // this warp's
  int rounds_sum = 0, rounds_max = 0;  // the guard's (warp 0's)
  float guard_theta = -__int_as_float(0x7f800000);  // warp_guard's start
  int ent = 0;  // ring entries this warp has waited on
#ifdef P_EPOCH_PHASE_CLOCKS
  const bool timing = rank == 0 && tid == 0;
  long long ph[kSplitPhases] = {}, t_last = clock64(), gph[4] = {};
#endif
  for (int s = 0; s < S; ++s) {
    // the step's row information, from the producer
    mbar_wait(&ifull[s & 1], (unsigned)((s >> 1) & 1));
    const float* inf = info + (s & 1) * IS;
    SPHASE(1);
    const float cnt = inf[2 * B];
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    SPHASE(2);

    for (int q = 0; q < G; ++q) {
      const bool mine = q < nrows;  // row b = q*NW + w exists
      // this CTA's partial z of the row over its slice, tile by tile
      float z[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] = 0.f;
      const int e_z = ent;
      for (int t = 0; t < T; ++t, ++ent) {
        const int st = ent % NS;
        mbar_wait(&full[st * NW + w], (unsigned)((ent / NS) & 1));
        SPHASE(3);
        if (mine) {
          const float* Lr = ring + (st * NW + w) * RS;
          const float* pt = p + t * Jt;
          const int wt = min(Jt, jw - t * Jt);
          for (int j = lane; j < wt; j += 32) {
            float Lj[NC];
            split_row<NC, EXACT>(Lj, Lr + j * C, C);
            const float pj = pt[j];
#pragma unroll
            for (int c = 0; c < NC; ++c) z[c] = fmaf(Lj[c], pj, z[c]);
          }
        }
        if (!hold) release(st);
        SPHASE(4);
      }
      warp_sum_classes<NC, true>(z, NC, lane);
      SPHASE(4);
      // push the row's partials (0 for a warp with no row in the group) in
      // 16-byte chunks, then z from the k slots in rank order: lane c sums
      // class c
      {
        uint32_t slot, bar;
        begin(k * CP * 4, slot, bar);
        if (lane < k) {
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            float v4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v4[i] = 4 * ch + i < NC ? z[4 * ch + i] : 0.f;
            if (ch * 4 < C)
              st_async4(slot + 16 * ch, v4[0], v4[1], v4[2], v4[3], bar);
          }
        }
      }
      const float* rs = wait_slots();
      float zc = 0.f;
      if (lane < C)
        for (int r = 0; r < k; ++r) zc += rs[r * XS + lane];
#pragma unroll
      for (int c = 0; c < NC; ++c) z[c] = __shfl_sync(kFull, zc, c);
      SPHASE(5);
      if (mine) {
        const int b = q * NW + w;
        const float bv = inf[B + b];
        const int yb = __float_as_int(inf[b]);
        float hit;
        const float loss = row_loss_grad_warp<NC, EXACT>(
            z, C, cls, yb, __int_as_float(yb), bv * inv_cnt, &hit);
        acc_loss += loss * bv;
        acc_hit += hit * bv;
      }
      SPHASE(6);
      // h over the slice, this warp's rows summed: the held tiles again, or
      // their copies
      int eh = hold ? e_z : ent;
      for (int t = 0; t < T; ++t, ++eh) {
        const int st = eh % NS;
        if (!hold) {
          mbar_wait(&full[st * NW + w], (unsigned)((eh / NS) & 1));
          SPHASE(3);
        }
        if (mine) {
          const float* Lr = ring + (st * NW + w) * RS;
          float* ht = h + w * Jk + t * Jt;
          const int wt = min(Jt, jw - t * Jt);
          for (int j = lane; j < wt; j += 32) {
            float Lj[NC];
            split_row<NC, EXACT>(Lj, Lr + j * C, C);
            float hv = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) hv = fmaf(Lj[c], z[c], hv);
            if (q == 0)
              ht[j] = hv;
            else
              ht[j] += hv;
          }
        }
        release(st);
        SPHASE(7);
      }
      if (!hold) ent = eh;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&iempty[s & 1]);  // done with the information
    acc_cnt += cnt;
    consumers_sync(nthreads);  // h complete; every warp is done reading p
    SPHASE(8);

    if constexpr (GUARDED) {
      if (e.guard == kGuardClip) {
        // the update as unguarded, each warp's squares of its new p pushed
        // by lane q to CTA q's slot of this rank and warp (pall's room)
        float ss = 0.f;
        for (int j = tid; j < jw; j += nthreads) {
          float g = 0.f;
#pragma unroll 4
          for (int u = 0; u < NW; ++u) g += h[u * Jk + j];
          g *= cvs[j];
          const float bj = a.momentum * buf[j] + g;
          buf[j] = bj;
          const float pj = p[j] - a.lr * bj;
          p[j] = pj;
          ss = fmaf(pj, pj, ss);
        }
        ss = warp_sum(ss);
        if (tid == 0) mbar_expect_tx(gbar, (unsigned)(4 * k * NW));
        if (lane < k)
          st_async1(cluster_map(pall_a + 4 * (rank * NW + w), lane), ss,
                    cluster_map(gbar_a, lane));
        SPHASE(9);
        mbar_wait_cluster(gbar, (unsigned)(s & 1));
        SPHASE(10);
        // the k*NW sums in one order on every thread of every CTA
        float t = 0.f;
        for (int i = lane; i < k * NW; i += 32) t += pall[i];
        t = warp_sum(t);
        const float scale = fminf(1.f, e.radius / fmaxf(sqrtf(t), 1e-30f));
        for (int j = tid; j < jw; j += nthreads) p[j] *= scale;
      } else {
        // the update, warp by warp over the slice (lane l client jb + l);
        // each quad's first lane pushes its 4 new p to every CTA's gather
        // (0 past the slice), which warp 0 then projects into p
        for (int jb = tid - lane; jb < jw; jb += nthreads) {
          const int j = jb + lane;
          float pj = 0.f;
          if (j < jw) {
            float g = 0.f;
#pragma unroll 4
            for (int u = 0; u < NW; ++u) g += h[u * Jk + j];
            g *= cvs[j];
            const float bj = a.momentum * buf[j] + g;
            buf[j] = bj;
            pj = p[j] - a.lr * bj;
          }
          const float p1 = __shfl_down_sync(kFull, pj, 1);
          const float p2 = __shfl_down_sync(kFull, pj, 2);
          const float p3 = __shfl_down_sync(kFull, pj, 3);
          if ((lane & 3) == 0 && j < jw)
            for (int q = 0; q < k; ++q)
              st_async4(cluster_map(pall_a + 4 * (j0 + j), q), pj, p1, p2, p3,
                        cluster_map(gbar_a, q));
        }
        SPHASE(9);
        if (w == 0) {
          // every rank's quads: 16 bytes each of the ceil(J / 4) (the
          // slices start at multiples of 4 clients)
          if (lane == 0) mbar_expect_tx(gbar, (unsigned)(16 * ((J + 3) / 4)));
          mbar_wait_cluster(gbar, (unsigned)(s & 1));
          SPHASE(10);
#ifdef P_EPOCH_PHASE_CLOCKS
          long long* gclk = timing ? gph : nullptr;
#else
          long long* gclk = nullptr;
#endif
          const int rounds =
              warp_guard<split_guard_regs<NC>()>(e.guard, e.radius, pall, cvall,
                                                 J, p, j0, j0 + jw, guard_theta,
                                                 gclk);
          rounds_sum += rounds;
          rounds_max = max(rounds_max, rounds);
        }
      }
    } else {
      for (int j = tid; j < jw; j += nthreads) {
        float g = 0.f;
#pragma unroll 4
        for (int u = 0; u < NW; ++u) g += h[u * Jk + j];
        g *= cvs[j];
        const float bj = a.momentum * buf[j] + g;
        buf[j] = bj;
        p[j] = p[j] - a.lr * bj;
      }
      SPHASE(9);
    }
    SPHASE(11);
    consumers_sync(nthreads);  // p updated
    SPHASE(8);

  }
#ifdef P_EPOCH_PHASE_CLOCKS
  if (timing) {
    for (int i = 0; i < kSplitPhases; ++i) split_phase_clocks[i] = ph[i];
    for (int i = 0; i < 4; ++i) guard_part_clocks[i] = gph[i];
  }
#endif

  if (lane == 0) {
    red[w] = acc_loss;
    red[NW + w] = acc_hit;
  }
  consumers_sync(nthreads);
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
  // no CTA leaves while a peer's pushes to it may be in flight
  cluster.sync();
}

// One launch of a split kernel: one cluster of x.k CTAs of `threads`
// threads, `smem` bytes each.
template <typename X>
cudaError_t launch_split_kernel(void (*kern)(Args, X), const Args& a,
                                const X& x, int threads, size_t smem,
                                cudaStream_t stream) {
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
  cfg.blockDim = dim3((unsigned)threads);
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

template <int NC, bool EXACT>
cudaError_t launch_split(const Args& a, const SplitExt& x, int warps,
                         size_t smem, cudaStream_t stream) {
  return launch_split_kernel(x.guard != kGuardNone
                                 ? split_p_epoch_kernel<NC, EXACT, true>
                                 : split_p_epoch_kernel<NC, EXACT, false>,
                             a, x, 32 * (warps + 1), smem, stream);
}

// ---------------------------------------------------------------------------
// The class-tiled split kernel: C over a cluster of k CTAs (1 to 16), any C
// at run time. CTA q owns classes [qC/k, (q+1)C/k) of every client (a
// balanced split: any k <= C runs) and reads only those, from the logits in
// the class-split layout (psolver_kernel.class_split, made once a p-solve):
// (k, n_val, J, W), rank q's slices of every row, each client's padded with
// zeros to W = ceil(C/k) rounded up to 4 floats, so that a row's slice (or a
// tile of its clients) is one contiguous 16-byte aligned span, one
// cp.async.bulk, at any C (rows of 105 or 53 classes are not 16-byte
// multiples in the (n_val, J, C) layout, and a slice there is J strided
// segments).
//  - A producer warp copies each step's rows, R at a time (a group: one
//    bulk copy a row, a lane a row), into a ring of NS stages on full and
//    empty mbarriers, and the step's labels, valid flags and count into two
//    slots of row information; the consumers issue no copy. Holding (one
//    tile of all J clients), a group's slices stay in their stage from the z
//    pass to the h pass: each logit is read once a step. Streaming (a row's
//    slice past the stages), tiles of Jt clients are copied for the z pass
//    and again for the h pass.
//  - z[b, c] for the CTA's classes is a full sum over the J clients: a lane
//    a (row, quad of 4 classes, j mod 4), float4 loads, the 4 parts summed
//    over their lanes in a fixed order, into a shared row buffer.
//  - The loss needs each row's statistics over all C: every CTA pushes its
//    slice's (st.async, 16 bytes a row, into every CTA's slot for this rank,
//    completing on that slot set's mbarrier): cross-entropy the slice's
//    maximum, sum of exp(z - max), the label's logit where it owns the label
//    (else 0) and its first maximum's class; the squared error its sum of
//    squared residuals. Each CTA merges the k ranks' in rank order: the
//    first maximum over all C (a tie across slices to the lower rank, within
//    one to the lower class), Z = sum_q S_q exp(m_q - M). d[b, c] for its
//    classes is then local, and each row's loss and hit the same on every
//    CTA.
//  - Its partial g_j = sum_b sum_{c of its slice} L[b, j, c] d[b, c] for all
//    J (a few lanes a client, each its quads of classes over all the rows,
//    float4 loads, a butterfly sum), over the step's groups in order; then
//    a second push exchange sums g over the ranks in rank order on every
//    CTA (GX clients at a time). So p, buf and g are replicated: every CTA
//    applies the same update to all J with the same bits, and the guard
//    runs locally (warp_guard, one warp), no cluster sums. Rank 0 writes p,
//    buf and the metrics.
//  - Two slot sets alternate for each kind of exchange; a set is written
//    again two exchanges later, which a peer reaches only after this CTA
//    pushed the exchange between, after reading this one (every warp that
//    must push does push every exchange). No cluster barrier inside the
//    epoch.
//  - p, buf, cv and g sit in shared memory, or, where J leaves no room for
//    them beside the ring (the layout's state_global), p, buf and g in a
//    global scratch of 3 * Jp floats a CTA and cv read where it lies.
// What bounds it is still a step's latency: the slices' bytes (in L2 at
// C = 105, from device memory at C = 1,000) overlap the previous group's
// work; a group costs its passes, two block barriers and one exchange, a
// step one more exchange and the update. Measured on an H100 (removing
// one pass at a time, tools/p_epoch_variants.py): the two passes over the
// stage are bound by the SM's issue of shared-memory instructions, not by
// their latency (spreading them over more lanes measured slower).

constexpr int kTiledWarps = 16;     // consumer warps (the producer is one more)
constexpr int kTiledMaxRows = 16;   // rows of a group (a lane a row's copy)
constexpr int kTiledMaxStages = 4;
constexpr int kTiledGChunk = 256;   // clients of g an exchange carries

// The first class CTA q of a k-cluster owns (q = k: C).
__host__ __device__ inline int tiled_class_lo(int C, int k, int q) {
  return (int)(((long long)q * C) / k);
}

// Floats of one client's slice in the class-split layout: the widest slice,
// ceil(C / k), rounded up to 4.
__host__ __device__ inline int tiled_width(int C, int k) {
  return round_up((C + k - 1) / k, 4);
}

// Shared memory of one CTA of the class-tiled split kernel, in bytes: the
// mbarriers (full and empty a stage, two statistics and two g slot sets,
// two full and two empty for the row information; padded to 16 bytes),
// then in floats the two row-information slots, the ring (NS stages of R
// rows of Jt*W), two row buffers of z and d (R*W each), two statistics slot
// sets (k ranks * R rows * 4), two g slot sets (k * GX), the per-warp sums
// (4 * warps) and, unless state_global, p, buf, cv and g (Jp each).
size_t tiled_bytes(int B, int J, int C, int k, int R, int Jt, int NS, int GX,
                   int state_global) {
  const size_t W = tiled_width(C, k), Jp = round_up(J, 4);
  const size_t header = round_up(8 * (2 * NS + 8), 16);
  return header +
         (2 * (size_t)split_info_floats(B) + (size_t)NS * R * Jt * W +
          2 * (size_t)R * W + 8 * (size_t)k * R + 2 * (size_t)k * GX +
          4 * (size_t)kTiledWarps + (state_global ? 0 : 4 * Jp)) *
             sizeof(float);
}

// The kernel's layout at (B, J, C, k): GX = min(Jp, kTiledGChunk); with the
// state in shared memory, then in global memory: holding, groups of R rows
// (min(B, 16), halved while two stages do not fit) of all J clients, as
// many stages as fit up to kTiledMaxStages; else streaming, the most rows
// (halved the same way) and for them the widest tile of clients (J halved,
// and halved again) of which two stages fit. Where nothing fits, the least
// layout, whose bytes are past the limit.
struct TiledLayout {
  size_t smem;
  int rows, tile, stages, gchunk, state_global;
};

TiledLayout tiled_layout(int B, int J, int C, int k) {
  const int GX = min(round_up(J, 4), kTiledGChunk), R0 = min(B, kTiledMaxRows);
  auto make = [&](int R, int Jt, int sg) -> TiledLayout {
    int NS = 2;
    while (NS < kTiledMaxStages &&
           tiled_bytes(B, J, C, k, R, Jt, NS + 1, GX, sg) <=
               (size_t)kSmemLimit)
      ++NS;
    return {tiled_bytes(B, J, C, k, R, Jt, NS, GX, sg), R, Jt, NS, GX, sg};
  };
  auto fits = [&](int R, int Jt, int sg) {
    return tiled_bytes(B, J, C, k, R, Jt, 2, GX, sg) <= (size_t)kSmemLimit;
  };
  for (int sg = 0; sg < 2; ++sg) {
    for (int R = R0; R >= 1; R /= 2)
      if (fits(R, J, sg)) return make(R, J, sg);
    for (int R = R0; R >= 1; R /= 2) {
      for (int Jt = (J + 1) / 2;; Jt = (Jt + 1) / 2) {
        if (fits(R, Jt, sg)) return make(R, Jt, sg);
        if (Jt == 1) break;
      }
    }
  }
  return {tiled_bytes(B, J, C, k, 1, 1, 2, GX, 1), 1, 1, 2, GX, 1};
}

struct TiledArgs {
  const float* p0;      // (J,)
  const float* buf0;    // (J,)
  const float* cv;      // (J,)
  const float* logits;  // (k, n_val, J, W): class_split's layout
  const int* y;         // (n_val,) int32 labels, or float32 targets' bits
  const int* positions; // (S, B)
  const float* valid;   // (S, B)
  float* p_out;         // (J,)
  float* buf_out;       // (J,)
  float* metrics;       // (3,)
  int* guard_rounds;    // (2,) or null
  float* scratch;       // (k, 3, Jp) for the GLOBAL_STATE instantiation
  int S, B, J, C, n_val, cls, guard, k;
  int W, R, Jt, NS, GX;
  float lr, momentum, radius;
};

#ifdef P_EPOCH_PHASE_CLOCKS
// The class-tiled split kernel's phases: rank 0's consumer thread 0, then
// its producer lane 0 (p_epoch_tiled_phase_names, in this order).
constexpr int kTiledPhases = 15;
__device__ unsigned long long tiled_phase_clocks[kTiledPhases];
#define TPHASE(i)                     \
  if (timing) {                       \
    const long long now_ = clock64(); \
    ph[i] += now_ - t_last;           \
    t_last = now_;                    \
  }
#else
#define TPHASE(i)
#endif

// GLOBAL_STATE: the layout's state_global (p, buf and g in a.scratch);
// otherwise they and cv are in shared memory, which the compiler then
// knows (shared loads and stores, not generic ones). GUARDED: a.guard is
// not kGuardNone (the unguarded instantiation holds no guard code).
template <bool GLOBAL_STATE, bool GUARDED>
__global__ void __launch_bounds__(32 * (kTiledWarps + 1), 1)
    split_tiled_p_epoch_kernel(const TiledArgs a) {
  constexpr int NW = kTiledWarps, nthreads = 32 * NW;
  const int S = a.S, B = a.B, J = a.J, C = a.C, k = a.k, W = a.W, R = a.R;
  const int Jt = a.Jt, NS = a.NS, GX = a.GX, Jp = round_up(J, 4);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int G = (B + R - 1) / R;    // groups of rows a step
  const int T = (J + Jt - 1) / Jt;  // tiles of clients a row
  const bool hold = T == 1, cls = a.cls != 0;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c_lo = tiled_class_lo(C, k, rank);
  const int cq = tiled_class_lo(C, k, rank + 1) - c_lo;  // this CTA's classes

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // [NS]
  uint64_t* empty = full + NS;                              // [NS]
  uint64_t* sbar = empty + NS;                              // [2]
  uint64_t* gbar = sbar + 2;                                // [2]
  uint64_t* ifull = gbar + 2;                               // [2]
  uint64_t* iempty = ifull + 2;                             // [2]
  const int IS = split_info_floats(B);
  float* info = reinterpret_cast<float*>(
      smem_raw + round_up(8 * (2 * NS + 8), 16));  // [2][IS]
  float* ring = info + 2 * IS;                      // [NS][R][Jt*W]
  float* zbuf = ring + (size_t)NS * R * Jt * W;     // [2][R][W]
  float* sx = zbuf + 2 * R * W;                     // [2][k][R][4]
  float* gx = sx + 8 * k * R;                       // [2][k][GX]
  float* red = gx + 2 * k * GX;                     // [4][NW]
  float *p, *buf, *g;
  const float* cvs;
  if constexpr (GLOBAL_STATE) {
    p = a.scratch + (size_t)rank * 3 * Jp;
    cvs = a.cv;
  } else {
    p = red + 4 * NW;
    float* cvm = p + 3 * Jp;
    for (int j = tid; j < J; j += blockDim.x) cvm[j] = a.cv[j];
    cvs = cvm;
  }
  buf = p + Jp;
  g = buf + Jp;
  for (int j = tid; j < Jp; j += blockDim.x) {
    p[j] = j < J ? a.p0[j] : 0.f;
    buf[j] = j < J ? a.buf0[j] : 0.f;
    g[j] = 0.f;  // the pad stays 0: g is pushed 4 clients at a time
  }
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NW);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&sbar[q], 1);
      mbar_init(&gbar[q], 1);
      mbar_init(&ifull[q], 1);
      mbar_init(&iempty[q], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every CTA's exchange mbarriers are initialised before any is pushed to
  cluster.sync();
#ifdef P_EPOCH_PHASE_CLOCKS
  const bool timing = rank == 0 && (tid == 0 || tid == 32 * NW);
  long long ph[kTiledPhases] = {}, t_last = clock64();
#endif

  if (w == NW) {
    // ---- the producer warp: each step's row information, then its ring
    // entries in the consumers' order ----
    const float* plane = a.logits + (size_t)rank * a.n_val * J * W;
    int ent = 0;
    for (int s = 0; s < S; ++s) {
      if (s >= 2) mbar_wait(&iempty[s & 1], (unsigned)(((s >> 1) - 1) & 1));
      TPHASE(12);
      float* inf = info + (s & 1) * IS;
      const size_t base = (size_t)s * B;
      float vs = 0.f;
      for (int b = lane; b < B; b += 32) {
        const float v = ld_early(a.valid + base + b);
        inf[b] = __int_as_float(ld_early(a.y + ld_early(a.positions + base +
                                                        b)));
        inf[B + b] = v;
        vs += v;
      }
      const float cnt = warp_sum(vs);
      if (lane == 0) inf[2 * B] = cnt;
      __syncwarp();
      if (lane == 0) mbar_arrive(&ifull[s & 1]);
      TPHASE(13);
      for (int q = 0; q < G; ++q) {
        const int nr = min(R, B - q * R);
        const int r = lane < nr ? ld_early(a.positions + base + q * R + lane)
                                : 0;
        for (int pass = 0; pass < (hold ? 1 : 2); ++pass) {
          for (int t = 0; t < T; ++t, ++ent) {
            const int sl = ent % NS, u = ent / NS;
            if (u > 0) mbar_wait(&empty[sl], (unsigned)((u - 1) & 1));
            TPHASE(12);
            const int wt = min(Jt, J - t * Jt);
            const unsigned bytes = (unsigned)(wt * W * 4);
            if (lane == 0) mbar_expect_tx(&full[sl], (unsigned)nr * bytes);
            __syncwarp();
            if (lane < nr)
              bulk_copy(ring + ((size_t)sl * R + lane) * Jt * W,
                        plane + ((size_t)r * J + t * Jt) * W, bytes,
                        &full[sl]);
            TPHASE(14);
          }
        }
      }
    }
#ifdef P_EPOCH_PHASE_CLOCKS
    if (timing)
      for (int i = 12; i < kTiledPhases; ++i) tiled_phase_clocks[i] = ph[i];
#endif
    cluster.sync();  // the consumers' last
    return;
  }

  // ---- the NW consumer warps ----
  const uint32_t sx_a = smem_addr(sx), sbar_a = smem_addr(sbar);
  const uint32_t gx_a = smem_addr(gx), gbar_a = smem_addr(gbar);
  auto release = [&](int sl) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[sl]);
  };
  const int RS = Jt * W;  // floats from a stage's row to the next
  const int nq = W / 4;   // quads of 4 classes in a slice
  int hl = 1;             // lanes a client in the h pass
  while (hl < nq && hl < 32) hl <<= 1;
  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // this warp's rows'
  int rounds_sum = 0, rounds_max = 0;                  // the guard's (warp 0)
  float guard_theta = -__int_as_float(0x7f800000);     // warp_guard's start
  int ent = 0, xs = 0, xg = 0, zg = 0;  // ring entries, exchanges, groups
  for (int s = 0; s < S; ++s) {
    mbar_wait(&ifull[s & 1], (unsigned)((s >> 1) & 1));
    const float* inf = info + (s & 1) * IS;
    const float cnt = inf[2 * B];
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);
    TPHASE(0);
    for (int q = 0; q < G; ++q, ++zg) {
      const int nr = min(R, B - q * R);
      float* z = zbuf + (zg & 1) * R * W;  // the group's z, then d
      // z over the CTA's classes (its W padded ones), tile by tile: items
      // (row b, quad u of 4 classes, part jp of the clients: j = jp mod
      // 4), a lane an item, float4 loads; the 4 parts of a quad (4 lanes)
      // summed in a fixed order, each part over j in order
      const int e_z = ent;
      for (int t = 0; t < T; ++t, ++ent) {
        const int sl = ent % NS;
        mbar_wait(&full[sl], (unsigned)((ent / NS) & 1));
        TPHASE(1);
        const float* stage = ring + (size_t)sl * R * RS;
        const float* pt = p + t * Jt;
        const int wt = min(Jt, J - t * Jt);
        for (int i0 = 32 * w; i0 < 4 * nr * nq; i0 += nthreads) {
          const int i = i0 + lane, jp = i & 3;
          const bool act = i < 4 * nr * nq;
          const int bu = act ? i >> 2 : 0, b = bu / nq, u = bu - b * nq;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          if (act) {
            const float* L = stage + b * RS + 4 * u;
#pragma unroll 4
            for (int j = jp; j < wt; j += 4) {
              const float4 l = *reinterpret_cast<const float4*>(L + j * W);
              const float pj = pt[j];
              acc.x = fmaf(l.x, pj, acc.x);
              acc.y = fmaf(l.y, pj, acc.y);
              acc.z = fmaf(l.z, pj, acc.z);
              acc.w = fmaf(l.w, pj, acc.w);
            }
          }
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            acc.x += __shfl_xor_sync(kFull, acc.x, o);
            acc.y += __shfl_xor_sync(kFull, acc.y, o);
            acc.z += __shfl_xor_sync(kFull, acc.z, o);
            acc.w += __shfl_xor_sync(kFull, acc.w, o);
          }
          if (act && jp == 0) {
            float4* zq = reinterpret_cast<float4*>(z + b * W + 4 * u);
            if (t > 0) {
              const float4 v = *zq;
              acc.x += v.x;
              acc.y += v.y;
              acc.z += v.z;
              acc.w += v.w;
            }
            *zq = acc;
          }
        }
        if (!hold) release(sl);
        TPHASE(2);
      }
      consumers_sync(nthreads);  // the group's z complete
      TPHASE(3);

      // each row's statistics over this CTA's slice (a warp a row), pushed
      // into every CTA's slot for this rank
      const int set = xs & 1;
      if (tid == 0) mbar_expect_tx(&sbar[set], (unsigned)(16 * k * nr));
      for (int bl = w; bl < nr; bl += NW) {
        const int b = q * R + bl;
        float* zr = z + bl * W;
        float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
        if (cls) {
          const int lc = __float_as_int(inf[b]) - c_lo;
          v2 = (lc >= 0 && lc < cq) ? zr[lc] : 0.f;
          const float neg_inf = -__int_as_float(0x7f800000);
          float m = neg_inf;
          int mi = cq;
          for (int c = lane; c < cq; c += 32) {
            const float v = zr[c];
            if (v > m) {
              m = v;
              mi = c;
            }
          }
          // the slice's first maximum: the larger value, the lower class
          // on a tie
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float om = __shfl_xor_sync(kFull, m, o);
            const int oi = __shfl_xor_sync(kFull, mi, o);
            if (om > m || (om == m && oi < mi)) {
              m = om;
              mi = oi;
            }
          }
          // exp(z - m) kept in place of z: d's exp(z - M) is it times
          // exp(m - M)
          __syncwarp();
          float e = 0.f;
          for (int c = lane; c < cq; c += 32) {
            const float ec = expf(zr[c] - m);
            zr[c] = ec;
            e += ec;
          }
          v0 = m;
          v1 = warp_sum(e);
          v3 = __int_as_float(c_lo + mi);
        } else {
          const float target = inf[b];
          float e2 = 0.f;
          for (int c = lane; c < cq; c += 32) {
            const float e = zr[c] - target;
            e2 = fmaf(e, e, e2);
          }
          v0 = warp_sum(e2);
        }
        if (lane < k)
          st_async4(cluster_map(sx_a + 16 * ((set * k + rank) * R + bl), lane),
                    v0, v1, v2, v3, cluster_map(sbar_a + 8 * set, lane));
      }
      TPHASE(4);
      mbar_wait_cluster(&sbar[set], (unsigned)((xs >> 1) & 1));
      ++xs;
      TPHASE(5);
      // merged in rank order, each row by its warp: the loss, the hit and d
      // over this CTA's classes, in place
      const float* sxs = sx + set * k * R * 4;
      for (int bl = w; bl < nr; bl += NW) {
        const int b = q * R + bl;
        const float bv = inf[B + b], scale = bv * inv_cnt;
        float* zr = z + bl * W;
        float loss, hit = 0.f;
        if (cls) {
          const int label = __float_as_int(inf[b]);
          float M = sxs[4 * bl];
          int pred = __float_as_int(sxs[4 * bl + 3]);
          for (int r = 1; r < k; ++r) {
            const float mr = sxs[4 * (r * R + bl)];
            if (mr > M) {
              M = mr;
              pred = __float_as_int(sxs[4 * (r * R + bl) + 3]);
            }
          }
          // lane r's term of rank r, then summed in rank order
          const float* v = sxs + 4 * (min(lane, k - 1) * R + bl);
          const float term = lane < k ? v[1] * expf(v[0] - M) : 0.f;
          const float zlr = lane < k ? v[2] : 0.f;
          float Z = 0.f, zl = 0.f;
          for (int r = 0; r < k; ++r) {
            Z += __shfl_sync(kFull, term, r);
            zl += __shfl_sync(kFull, zlr, r);
          }
          // softmax over this CTA's classes: exp(z - m) exp(m - M) / Z
          const float f = expf(sxs[4 * (rank * R + bl)] - M) / Z;
          for (int c = lane; c < cq; c += 32)
            zr[c] = (zr[c] * f - (c_lo + c == label ? 1.f : 0.f)) * scale;
          loss = (logf(Z) + M) - zl;
          hit = pred == label ? 1.f : 0.f;
        } else {
          float sse = 0.f;
          for (int r = 0; r < k; ++r) sse += sxs[4 * (r * R + bl)];
          const float target = inf[b];
          for (int c = lane; c < cq; c += 32)
            zr[c] = (zr[c] - target) * (2.f / C) * scale;
          loss = sse / C;
        }
        acc_loss += loss * bv;
        acc_hit += hit * bv;
      }
      consumers_sync(nthreads);  // the group's d complete
      TPHASE(6);

      // this CTA's partial g over the group's rows: hl lanes a client (the
      // quads' count rounded up to a power of 2, at most 32), each lane its
      // quads u, u + hl, ... over all the rows, float4 loads of L and d;
      // the hl lanes summed in a fixed order; a warp's clients the same
      // every group, so g adds in group order: the held stage again, or
      // the tiles' copies
      int eh = hold ? e_z : ent;
      for (int t = 0; t < T; ++t, ++eh) {
        const int sl = eh % NS;
        if (!hold) {
          mbar_wait(&full[sl], (unsigned)((eh / NS) & 1));
          TPHASE(1);
        }
        const float* stage = ring + (size_t)sl * R * RS;
        const int wt = min(Jt, J - t * Jt);
        for (int j0 = w * (32 / hl); j0 < wt; j0 += NW * (32 / hl)) {
          const int j = j0 + lane / hl;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j < wt) {
            for (int u = lane % hl; u < nq; u += hl) {
              const float* L = stage + j * W + 4 * u;
              const float* d = z + 4 * u;
#pragma unroll 4
              for (int bl = 0; bl < nr; ++bl) {
                const float4 l = *reinterpret_cast<const float4*>(L + bl * RS);
                const float4 dd = *reinterpret_cast<const float4*>(d + bl * W);
                acc.x = fmaf(l.x, dd.x, acc.x);
                acc.y = fmaf(l.y, dd.y, acc.y);
                acc.z = fmaf(l.z, dd.z, acc.z);
                acc.w = fmaf(l.w, dd.w, acc.w);
              }
            }
          }
          float hv = (acc.x + acc.y) + (acc.z + acc.w);
          for (int o = hl / 2; o > 0; o >>= 1)
            hv += __shfl_xor_sync(kFull, hv, o);
          if (j < wt && lane % hl == 0) {
            float* gj = g + t * Jt + j;
            *gj = q == 0 ? hv : *gj + hv;
          }
        }
        release(sl);
        TPHASE(7);
      }
      if (!hold) ent = eh;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&iempty[s & 1]);  // done with the information
    acc_cnt += cnt;
    consumers_sync(nthreads);  // g's partial complete; p read for the last time
    TPHASE(8);

    // g summed over the ranks in rank order on every CTA, GX clients an
    // exchange, then the momentum and p updates of those clients
    for (int j0 = 0; j0 < J; j0 += GX) {
      const int n = min(GX, Jp - j0), nc = n / 4, gs = xg & 1;
      if (tid == 0) mbar_expect_tx(&gbar[gs], (unsigned)(4 * k * n));
      for (int i = tid; i < k * nc; i += nthreads) {
        const int dst = i / nc, ch = i - dst * nc;
        const float4 v = *reinterpret_cast<const float4*>(g + j0 + 4 * ch);
        st_async4(cluster_map(gx_a + 4 * ((gs * k + rank) * GX + 4 * ch), dst),
                  v.x, v.y, v.z, v.w, cluster_map(gbar_a + 8 * gs, dst));
      }
      mbar_wait_cluster(&gbar[gs], (unsigned)((xg >> 1) & 1));
      ++xg;
      const float* gr = gx + gs * k * GX;
      for (int j = tid; j < min(n, J - j0); j += nthreads) {
        float gj = 0.f;
        for (int r = 0; r < k; ++r) gj += gr[r * GX + j];
        const int jj = j0 + j;
        gj *= cvs[jj];
        const float bj = a.momentum * buf[jj] + gj;
        buf[jj] = bj;
        p[jj] = p[jj] - a.lr * bj;
      }
      // every thread done reading this set before this CTA pushes the
      // next exchange (a peer's pushes two exchanges on overwrite it)
      if (j0 + GX < J) consumers_sync(nthreads);
    }
    TPHASE(9);
    if constexpr (GUARDED) {
      consumers_sync(nthreads);  // every client updated
      // warp 0 projects the whole of p, the same bits on every CTA; the
      // other warps wait at the step's last barrier
      if (w == 0) {
        const int rounds = warp_guard<0>(a.guard, a.radius, p, cvs, J, p, 0,
                                         J, guard_theta);
        rounds_sum += rounds;
        rounds_max = max(rounds_max, rounds);
      }
    }
    TPHASE(10);
    consumers_sync(nthreads);  // p updated before the next step's z pass
    TPHASE(11);
  }
#ifdef P_EPOCH_PHASE_CLOCKS
  if (timing)
    for (int i = 0; i < 12; ++i) tiled_phase_clocks[i] = ph[i];
#endif

  if (lane == 0) {
    red[w] = acc_loss;
    red[NW + w] = acc_hit;
  }
  consumers_sync(nthreads);
  if (rank == 0) {
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
      if (a.guard_rounds != nullptr) {
        a.guard_rounds[0] = rounds_sum;
        a.guard_rounds[1] = rounds_max;
      }
    }
  }
  // no CTA leaves while a peer's pushes to it may be in flight
  cluster.sync();
}

// ---------------------------------------------------------------------------
// The unstaged kernel (the port's first design): one CTA of 256 threads,
// each step's block gathered after its row ids are loaded. Only shapes the
// staged and split kernels cannot take run it.

constexpr int kThreads = 256;
constexpr int kUnstagedWarps = kThreads / 32;

// Shared memory, in floats: L block (B*J*C), p (J), buf (J), cv (J),
// z/d (B*C), row_loss (B), row_hit (B), row_ok (B), 4 * warps floats (the
// guard's per-warp sums before the guard became one warp's, kept so that
// the plans keep their bytes); then row_id (B ints).
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
  int* row_id = reinterpret_cast<int*>(row_ok + B + 4 * kUnstagedWarps);

  const int tid = threadIdx.x;
  for (int j = tid; j < J; j += kThreads) {
    p[j] = p0[j];
    buf[j] = buf0[j];
    cvs[j] = cv[j];
  }

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // thread 0's
  int rounds_sum = 0, rounds_max = 0;                   // the guard's
  float guard_theta = -__int_as_float(0x7f800000);      // warp_guard's start
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
      __syncthreads();  // every client updated
      // warp 0 projects p; the next step's first barrier holds the others
      if (tid < 32) {
        const int rounds = warp_guard<kGuardRegs>(guard, radius, p, cvs, J,
                                                  p, 0, J, guard_theta);
        rounds_sum += rounds;
        rounds_max = max(rounds_max, rounds);
      }
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

Ext make_ext(void* guard_rounds, int guard, float radius) {
  Ext x;
  x.guard_rounds = static_cast<int*>(guard_rounds);
  x.guard = guard;
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

size_t p_epoch_split_smem_bytes(int B, int J, int C, int k, int hold,
                                int guarded) {
  return split_layout(B, J, C, k, hold, guarded).smem;
}

// The floats a guard adds to one CTA of the split kernel at (J, k).
int p_epoch_split_guard_floats(int J, int k) {
  return split_guard_floats(J, k);
}

size_t p_epoch_unstaged_smem_bytes(int B, int J, int C) {
  return unstaged_smem_bytes(B, J, C);
}

int p_epoch_staged_warps(int B) { return staged_warps(B); }

int p_epoch_split_slice(int J, int k) { return split_slice(J, k); }

// The split kernel's layout at (B, J, C, k, hold, guarded): its tile of
// clients, its stages and its consumer warps (split_layout); returns 0.
int p_epoch_split_layout(int B, int J, int C, int k, int hold, int guarded,
                         int* tile, int* stages, int* warps) {
  const SplitLayout lay = split_layout(B, J, C, k, hold, guarded);
  *tile = lay.tile;
  *stages = lay.stages;
  *warps = lay.warps;
  return 0;
}

int p_epoch_instantiated_classes(int C) { return instantiated_classes(C); }

// The class-tiled split kernel's layout at (B, J, C, k) (tiled_layout):
// out = {rows, tile, stages, gchunk, state_global, width}; returns 0.
int p_epoch_tiled_layout(int B, int J, int C, int k, int* out, size_t* smem) {
  const TiledLayout lay = tiled_layout(B, J, C, k);
  out[0] = lay.rows;
  out[1] = lay.tile;
  out[2] = lay.stages;
  out[3] = lay.gchunk;
  out[4] = lay.state_global;
  out[5] = tiled_width(C, k);
  *smem = lay.smem;
  return 0;
}

// The largest cluster the split kernel may launch on this card: 16 when
// cudaOccupancyMaxActiveClusters finds room for one 16-CTA cluster of the
// largest CTA (512 threads, a full block of shared memory), else the
// portable 8.
int p_epoch_split_max_cluster(void) {
  auto kern = split_p_epoch_kernel<32, false, false>;  // 16 consumer warps
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemLimit) != cudaSuccess) {
    cudaGetLastError();
    return kMaxPortableCluster;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(32 * (kMaxWarps + 1));
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
  const Ext x = make_ext(guard_rounds, guard, radius);
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
// step's rows held from the z pass to the h pass) over copying them for
// each pass; the instantiation dispatch_classes names (C <= 32); a guard
// takes the layout with its gather (split_layout's guarded). Other
// arguments as p_epoch_launch_staged.
int p_epoch_launch_split(const void* p0, const void* buf0, const void* cv,
                         const void* logits, const void* y,
                         const void* positions, const void* valid,
                         void* p_out, void* buf_out, void* metrics,
                         void* guard_rounds, int S, int B, int J, int C,
                         int is_cls, int bulk, int guard, int k, int hold,
                         float lr, float momentum, float radius,
                         void* stream) {
  if (B < 1 || B > kMaxStagedBatch || J < 1 || C < 1 || k < 2 ||
      k > kMaxCluster)
    return cudaErrorInvalidValue;
  const Args a = make_args(p0, buf0, cv, logits, y, positions, valid, p_out,
                           buf_out, metrics, S, B, J, C, is_cls, bulk, lr,
                           momentum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SplitLayout lay = split_layout(B, J, C, k, hold, guard != kGuardNone);
  if (lay.smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  SplitExt x;
  x.guard_rounds = static_cast<int*>(guard_rounds);
  x.guard = guard;
  x.k = k;
  x.Jk = split_slice(J, k);
  x.tile = lay.tile;
  x.stages = lay.stages;
  x.hold = hold;
  x.radius = radius;
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    return launch_split<decltype(n)::value, decltype(exact)::value>(
        a, x, lay.warps, lay.smem, s);
  }));
}

// One launch of the class-tiled split kernel: one epoch on one cluster of k
// CTAs (1 to 16, at most C), CTA q owning classes [qC/k, (q+1)C/k);
// split_logits is (k, n_val, J, tiled_width(C, k)) in class_split's layout,
// 16-byte aligned; scratch (k * 3 * round_up(J, 4) floats) is read only
// where tiled_layout puts the state in global memory, and may be null
// elsewhere. Other arguments as p_epoch_launch_staged.
int p_epoch_launch_split_tiled(
    const void* p0, const void* buf0, const void* cv, const void* split_logits,
    const void* y, const void* positions, const void* valid, void* p_out,
    void* buf_out, void* metrics, void* guard_rounds, void* scratch, int S,
    int B, int J, int C, int n_val, int is_cls, int guard, int k, float lr,
    float momentum, float radius, void* stream) {
  if (B < 1 || B > kMaxStagedBatch || J < 1 || C < 1 || k < 1 ||
      k > kMaxCluster || k > C ||
      reinterpret_cast<uintptr_t>(split_logits) % 16 != 0)
    return cudaErrorInvalidValue;
  const TiledLayout lay = tiled_layout(B, J, C, k);
  if (lay.smem > (size_t)kSmemLimit ||
      (lay.state_global && scratch == nullptr))
    return cudaErrorInvalidValue;
  TiledArgs a;
  a.p0 = static_cast<const float*>(p0);
  a.buf0 = static_cast<const float*>(buf0);
  a.cv = static_cast<const float*>(cv);
  a.logits = static_cast<const float*>(split_logits);
  a.y = static_cast<const int*>(y);
  a.positions = static_cast<const int*>(positions);
  a.valid = static_cast<const float*>(valid);
  a.p_out = static_cast<float*>(p_out);
  a.buf_out = static_cast<float*>(buf_out);
  a.metrics = static_cast<float*>(metrics);
  a.guard_rounds = static_cast<int*>(guard_rounds);
  a.scratch = static_cast<float*>(scratch);
  a.S = S;
  a.B = B;
  a.J = J;
  a.C = C;
  a.n_val = n_val;
  a.cls = is_cls;
  a.guard = guard;
  a.k = k;
  a.W = tiled_width(C, k);
  a.R = lay.rows;
  a.Jt = lay.tile;
  a.NS = lay.stages;
  a.GX = lay.gchunk;
  a.lr = lr;
  a.momentum = momentum;
  a.radius = radius;
  const bool guarded = guard != kGuardNone;
  auto kern = lay.state_global
                  ? (guarded ? split_tiled_p_epoch_kernel<true, true>
                             : split_tiled_p_epoch_kernel<true, false>)
                  : (guarded ? split_tiled_p_epoch_kernel<false, true>
                             : split_tiled_p_epoch_kernel<false, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (k > kMaxPortableCluster) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k);
  cfg.blockDim = dim3(32 * (kTiledWarps + 1));
  cfg.dynamicSmemBytes = lay.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#ifdef P_EPOCH_PHASE_CLOCKS
// The phase clocks of the last staged launch (kPhases counters), and their
// names in order, comma-separated.
int p_epoch_phase_clocks(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, phase_clocks, sizeof(phase_clocks)));
}

const char* p_epoch_phase_names(void) {
  return "copy_expect_tx,copy_syncwarp,copy_fence,copy,prefetch_loads,"
         "valid_count,wait_rows,z,loss,h,barrier_1,update,guard,"
         "barrier_2_shift";
}

// The phase clocks of the last split launch (kSplitPhases counters), and
// their names.
int p_epoch_split_phase_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, split_phase_clocks,
                                               sizeof(split_phase_clocks)));
}

// The cycles of warp_guard's parts in the last split launch (4 counters:
// the loads into registers, the first sum, the rounds, the write).
int p_epoch_guard_part_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, guard_part_clocks,
                                               sizeof(guard_part_clocks)));
}

const char* p_epoch_split_phase_names(void) {
  return "copy_issue,row_info,valid_count,wait_rows,z,exchange,loss,h,"
         "barrier,update,gather,guard";
}

// The phase clocks of the last class-tiled split launch (kTiledPhases
// counters), and their names in order, comma-separated.
int p_epoch_tiled_phase_clocks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, tiled_phase_clocks,
                                               sizeof(tiled_phase_clocks)));
}

const char* p_epoch_tiled_phase_names(void) {
  return "row_info,wait_rows,z,z_barrier,stats,stats_exchange,merge_d,h,"
         "g_barrier,g_exchange_update,guard,barrier,producer_wait,"
         "producer_info,producer_issue";
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
