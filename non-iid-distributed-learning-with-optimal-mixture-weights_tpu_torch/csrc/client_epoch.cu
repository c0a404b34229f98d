// One local-SGD epoch of every client of a round, for the bias-free linear
// model (fedcore/epoch_kernel.py holds the wrapper and the plain version).
//
// Replaces the Pallas TPU kernel fedcore/pallas_kernel.py:_epoch_kernel of
// the JAX package. There the TPU's sequential grid walks the S batch steps of
// one client and vmap adds the client axis; here one CTA owns one client and
// loops over the S steps itself, with the client's weights W (C, D) and the
// prox anchor (C, D) resident in shared memory for the whole epoch. The CTA
// gathers its own batch rows from X (N, D) through rows (J, S, B), so the
// (J, S, B, D) epoch buffer of the JAX path is never built.
//
// Per step, exactly as the TPU kernel: z = xb W^T; CE (logsumexp - label
// logit, top-1 by first max) or MSE (mean over C); masked mean over the
// valid rows; the hand-derived gradient plus mu * (w - anchor) / ||w - anchor||
// and lam * w / ||w|| with zero subgradient at 0; no update when the batch has
// no valid rows; metrics (loss * cnt, correct, cnt) accumulated.
//
// Bound on the card: the bytes of the gathered rows (each valid row of X is
// read twice per step, forward and backward, once from device memory and
// once mostly from L2) against ~4 * C flops per element, far below the
// fp32 ridge, so the kernel is memory- and latency-bound. Everything is fp32
// FMA (no tensor cores, no TF32). The design keeps W, the anchor and all
// per-step intermediates on chip and skips padded rows and empty steps; the
// serial dependence between steps of one client is what bounds it in
// practice (J CTAs, one per client, on 132 SMs).

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of a and b; every thread receives both.
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
size_t smem_bytes(int B, int C, int D) {
  return (2 * (size_t)C * D + (size_t)B * C + 3 * (size_t)B + 2 * kWarps) *
             sizeof(float) +
         (size_t)B * sizeof(int);
}

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
    client_epoch_kernel(const float* __restrict__ W0,      // (J, C, D)
                        const float* __restrict__ anchor,  // (C, D)
                        const float* __restrict__ X,       // (N, D)
                        const int* __restrict__ y_cls,     // (N,) or null
                        const float* __restrict__ y_reg,   // (N,) or null
                        const int* __restrict__ rows,      // (J, S, B)
                        const float* __restrict__ valid,   // (J, S, B)
                        float* __restrict__ W_out,         // (J, C, D)
                        float* __restrict__ metrics,       // (J, 3)
                        int S, int B, int C, int D, float lr, float mu,
                        float lam) {
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
    // the previous step's readers of row_id/row_ok/z and writers of w are done
    __syncthreads();
    const size_t base = ((size_t)j * S + s) * B;
    for (int b = tid; b < B; b += kThreads) {
      row_id[b] = rows[base + b];
      row_ok[b] = valid[base + b];
    }
    __syncthreads();
    float cnt = 0.f;
    for (int b = 0; b < B; ++b) cnt += row_ok[b];
    // block-uniform: an empty batch makes no update and adds no metrics
    if (cnt == 0.f) continue;
    const float inv_cnt = 1.f / fmaxf(cnt, 1.f);

    // z[b, :] = x_b W^T, one warp per row, lanes striding over D
    for (int b = warp; b < B; b += kWarps) {
      if (row_ok[b] == 0.f) continue;  // warp-uniform
      const float* xr = X + (size_t)row_id[b] * D;
      float acc[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float xv = xr[d];
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

    // per row: loss, top-1 hit, and dz (overwrites z), scaled by bv / cnt
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

    // ||w - anchor||^2 and ||w||^2 of the weights before this step's update
    float sp = 0.f, sr = 0.f;
    for (int i = tid; i < CD; i += kThreads) {
      const float wv = w[i];
      const float dv = wv - a[i];
      sp = fmaf(dv, dv, sp);
      sr = fmaf(wv, wv, sr);
    }
    block_sum2(sp, sr, scratch);  // also orders the row pass before the reads below
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

    // grad[c, d] = sum_b dz[b, c] x_b[d] + penalties; one thread per column d
    for (int d = tid; d < D; d += kThreads) {
      float g[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) g[c] = 0.f;
      for (int b = 0; b < B; ++b) {
        if (row_ok[b] == 0.f) continue;
        const float xv = X[(size_t)row_id[b] * D + d];
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

template <int MAXC>
cudaError_t launch(const float* W0, const float* anchor, const float* X,
                   const int* y_cls, const float* y_reg, const int* rows,
                   const float* valid, float* W_out, float* metrics, int J,
                   int S, int B, int C, int D, float lr, float mu, float lam,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(B, C, D);
  cudaError_t e = cudaFuncSetAttribute(
      client_epoch_kernel<MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  client_epoch_kernel<MAXC><<<J, kThreads, smem, stream>>>(
      W0, anchor, X, y_cls, y_reg, rows, valid, W_out, metrics, S, B, C, D,
      lr, mu, lam);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs; the wrapper checks it against the
// card's per-block limit before launching.
size_t client_epoch_smem_bytes(int B, int C, int D) {
  return smem_bytes(B, C, D);
}

// Largest class count the kernel takes (its per-thread register arrays).
int client_epoch_max_classes() { return 32; }

// One launch: every client's epoch. is_cls selects int32 labels or float32
// targets behind y. Returns cudaGetLastError() after the launch.
int client_epoch_launch(const void* W0, const void* anchor, const void* X,
                        const void* y, const void* rows, const void* valid,
                        void* W_out, void* metrics, int J, int S, int B, int C,
                        int D, int is_cls, float lr, float mu, float lam,
                        void* stream) {
  const int* yc = is_cls ? static_cast<const int*>(y) : nullptr;
  const float* yr = is_cls ? nullptr : static_cast<const float*>(y);
  auto f = [&](auto tag) {
    constexpr int M = decltype(tag)::value;
    return launch<M>(static_cast<const float*>(W0),
                     static_cast<const float*>(anchor),
                     static_cast<const float*>(X), yc, yr,
                     static_cast<const int*>(rows),
                     static_cast<const float*>(valid),
                     static_cast<float*>(W_out), static_cast<float*>(metrics),
                     J, S, B, C, D, lr, mu, lam,
                     static_cast<cudaStream_t>(stream));
  };
  cudaError_t e;
  if (C <= 1) e = f(std::integral_constant<int, 1>{});
  else if (C <= 2) e = f(std::integral_constant<int, 2>{});
  else if (C <= 4) e = f(std::integral_constant<int, 4>{});
  else if (C <= 8) e = f(std::integral_constant<int, 8>{});
  else if (C <= 16) e = f(std::integral_constant<int, 16>{});
  else if (C <= 32) e = f(std::integral_constant<int, 32>{});
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
