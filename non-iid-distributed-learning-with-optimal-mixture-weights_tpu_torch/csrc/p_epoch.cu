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
// SGD momentum, no count guard); metrics accumulated.
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
//    the momentum and p updates; barrier 2. Two block barriers per step.
//  - The metrics are reduced once at the end, in a fixed order: no atomics,
//    so two launches give bitwise-identical p, buf and metrics.
//  - The class count is a template parameter (exact for the registry's
//    class counts), so z and d live in registers.
// Everything is fp32 FMA (no tensor cores, no TF32): the tolerances of
// tests/test_pallas_psolver.py need it, and both contractions are
// matrix-vector.
//
// Shapes the staged kernel cannot take (two stages of rows plus h beyond
// shared memory, B > 512 or C > 32) run the unstaged kernel below, the
// port's first design: one CTA of 256 threads that gathers each step's
// (B, J, C) block after loading the step's row ids, five block barriers per
// step.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "row_loss.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// 16 warps: 512 threads leave 128 registers a thread (at 1024 the cap of 64
// spills the C = 10 instantiation)
constexpr int kMaxWarps = 16;
constexpr int kMaxStagedBatch = 32 * kMaxWarps;  // a lane per row of a warp

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

int staged_warps(int B) { return B < kMaxWarps ? B : kMaxWarps; }

// Shared memory of the staged kernel, in bytes: 2 mbarriers per warp (one
// per stage), then in floats the ring (2 stages * B rows * JCp, each row
// padded to 4 floats so every row starts 16-byte aligned), h (B*J), p, buf,
// cv (J each) and the per-warp metric sums (2 * warps).
size_t staged_smem_bytes(int B, int J, int C) {
  const size_t NW = staged_warps(B), JCp = round_up(J * C, 4);
  return 16 * NW +
         (2 * (size_t)B * JCp + (size_t)B * J + 3 * (size_t)J + 2 * NW) *
             sizeof(float);
}

#ifdef P_EPOCH_PHASE_CLOCKS
// A measurement build only (tools/p_epoch_phases.py compiles this file with
// -DP_EPOCH_PHASE_CLOCKS): clock64 cycles thread 0 spends in each phase of
// the staged kernel's steps, summed over the last launch. Phases of the copy
// issue (bulk path; the element-wise path counts all of it in 3): 0 the
// mbarrier's arrive.expect_tx, 1 __syncwarp, 2 the proxy fence, 3 the
// copy; then 4 prefetch loads, 5 valid count, 6 wait for the staged rows,
// 7 z and its warp sums, 8 row loss, 9 h, 10 barrier 1, 11 p update,
// 12 barrier 2 and the shift of the prefetched registers.
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
// classes from C on are skipped.
template <int NC, bool EXACT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    staged_p_epoch_kernel(const Args a) {
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
  float* red = cvs + J;  // [2][NW]

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
  }
}

template <int NC, bool EXACT>
cudaError_t launch_staged(const Args& a, cudaStream_t stream) {
  const size_t smem = staged_smem_bytes(a.B, a.J, a.C);
  auto kern = staged_p_epoch_kernel<NC, EXACT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<1, 32 * staged_warps(a.B), smem, stream>>>(a);
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
// The unstaged kernel (the port's first design): one CTA of 256 threads,
// each step's block gathered after its row ids are loaded. Only shapes the
// staged kernel cannot take run it.

constexpr int kThreads = 256;

// Shared memory, in floats: L block (B*J*C), p (J), buf (J), cv (J),
// z/d (B*C), row_loss (B), row_hit (B), row_ok (B); then row_id (B ints).
size_t unstaged_smem_bytes(int B, int J, int C) {
  return ((size_t)B * J * C + 3 * (size_t)J + (size_t)B * C + 3 * (size_t)B) *
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
                            int S, int B, int J, int C, float lr,
                            float momentum) {
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
  int* row_id = reinterpret_cast<int*>(row_ok + B);

  const int tid = threadIdx.x;
  for (int j = tid; j < J; j += kThreads) {
    p[j] = p0[j];
    buf[j] = buf0[j];
    cvs[j] = cv[j];
  }

  float acc_loss = 0.f, acc_hit = 0.f, acc_cnt = 0.f;  // thread 0's
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
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of each kernel, the staged kernel's warps and the
// class count of the instantiation that runs C classes (0: none); the
// wrapper's launch plan computes the same numbers and checks them against
// these before every launch.
size_t p_epoch_staged_smem_bytes(int B, int J, int C) {
  return staged_smem_bytes(B, J, C);
}

size_t p_epoch_unstaged_smem_bytes(int B, int J, int C) {
  return unstaged_smem_bytes(B, J, C);
}

int p_epoch_staged_warps(int B) { return staged_warps(B); }

int p_epoch_instantiated_classes(int C) { return instantiated_classes(C); }

// One launch of the staged kernel: one epoch. is_cls selects int32 labels or
// float32 targets behind y; bulk selects cp.async.bulk row copies (J*C % 4 ==
// 0 and logits 16-byte aligned). Returns cudaGetLastError() after the launch.
int p_epoch_launch_staged(const void* p0, const void* buf0, const void* cv,
                          const void* logits, const void* y,
                          const void* positions, const void* valid,
                          void* p_out, void* buf_out, void* metrics, int S,
                          int B, int J, int C, int is_cls, int bulk, float lr,
                          float momentum, void* stream) {
  if (B < 1 || B > kMaxStagedBatch || J < 1) return cudaErrorInvalidValue;
  Args a;
  a.p0 = static_cast<const float*>(p0);
  a.buf0 = static_cast<const float*>(buf0);
  a.cv = static_cast<const float*>(cv);
  a.logits = static_cast<const float*>(logits);
  a.y = static_cast<const int*>(y);
  a.cls = is_cls;
  a.positions = static_cast<const int*>(positions);
  a.valid = static_cast<const float*>(valid);
  a.p_out = static_cast<float*>(p_out);
  a.buf_out = static_cast<float*>(buf_out);
  a.metrics = static_cast<float*>(metrics);
  a.S = S;
  a.B = B;
  a.J = J;
  a.C = C;
  a.bulk = bulk;
  a.lr = lr;
  a.momentum = momentum;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_classes(C, [&](auto n, auto exact) {
    return launch_staged<decltype(n)::value, decltype(exact)::value>(a, s);
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
                            void* p_out, void* buf_out, void* metrics, int S,
                            int B, int J, int C, int is_cls, float lr,
                            float momentum, void* stream) {
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
      static_cast<float*>(metrics), S, B, J, C, lr, momentum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
