// One shuffled epoch of FedAMW's mixture-weight SGD over the pooled
// validation logits (fedcore/psolver_kernel.py holds the wrapper and the
// plain version).
//
// Replaces the Pallas TPU kernel fedcore/pallas_psolver.py:_p_epoch_kernel
// of the JAX package. The steps of an epoch are serial (each one moves p), so
// one CTA runs the whole epoch with p, its momentum buffer and the client
// validity mask (J,) resident in shared memory. Each step gathers its B rows
// of logits (n_val, J, C) itself through positions (S, B); the class-major
// (S, C, B, J) buffer the TPU kernel needed for Mosaic is never built.
//
// Per step, exactly as the TPU kernel: z[b, c] = sum_j L[b, j, c] p_j; CE or
// MSE with the masked mean over the valid rows; g_j = sum_{b,c} L[b, j, c]
// d[b, c] times client_valid_j; buf = m * buf + g; p -= lr * buf (torch/optax
// SGD momentum, no count guard); metrics accumulated.
//
// Bound on the card: one read of the logits per epoch (n_val * J * C * 4
// bytes, which fit in L2) against 4 flops per element, so a memory bound of
// microseconds; in practice the S serial steps, each a few block-wide
// barriers, bound it by latency. The design keeps everything but the gathered
// rows on chip and stages each step's (B, J, C) block in shared memory with
// coalesced loads, so z and g read it from there. fp32 FMA throughout.

#include <cuda_runtime.h>
#include <stddef.h>

#include "row_loss.cuh"

namespace {

constexpr int kThreads = 256;

// Shared memory, in floats: L block (B*J*C), p (J), buf (J), cv (J),
// z/d (B*C), row_loss (B), row_hit (B), row_ok (B); then row_id (B ints).
size_t smem_bytes(int B, int J, int C) {
  return ((size_t)B * J * C + 3 * (size_t)J + (size_t)B * C + 3 * (size_t)B) *
             sizeof(float) +
         (size_t)B * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
    p_epoch_kernel(const float* __restrict__ p0,         // (J,)
                   const float* __restrict__ buf0,       // (J,)
                   const float* __restrict__ cv,         // (J,)
                   const float* __restrict__ logits,     // (n_val, J, C)
                   const int* __restrict__ y_cls,        // (n_val,) or null
                   const float* __restrict__ y_reg,      // (n_val,) or null
                   const int* __restrict__ positions,    // (S, B)
                   const float* __restrict__ valid,      // (S, B)
                   float* __restrict__ p_out,            // (J,)
                   float* __restrict__ buf_out,          // (J,)
                   float* __restrict__ metrics,          // (3,)
                   int S, int B, int J, int C, float lr, float momentum) {
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

// Dynamic shared memory the CTA needs; the wrapper checks it against the
// card's per-block limit before launching.
size_t p_epoch_smem_bytes(int B, int J, int C) { return smem_bytes(B, J, C); }

// One launch: one epoch. is_cls selects int32 labels or float32 targets
// behind y. Returns cudaGetLastError() after the launch.
int p_epoch_launch(const void* p0, const void* buf0, const void* cv,
                   const void* logits, const void* y, const void* positions,
                   const void* valid, void* p_out, void* buf_out,
                   void* metrics, int S, int B, int J, int C, int is_cls,
                   float lr, float momentum, void* stream) {
  const size_t smem = smem_bytes(B, J, C);
  cudaError_t e = cudaFuncSetAttribute(
      p_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  p_epoch_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
