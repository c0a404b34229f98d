// What both kernels share: the per-row loss and its gradient with respect to
// the row's logits, and the error string the wrappers raise with.
// Included by client_epoch.cu and p_epoch.cu; cuda_build.library_path hashes
// it into both libraries' names, so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>

// One row of a batch. zb (C) holds the row's logits on entry and
// d loss / d z times `scale` on exit. With y_cls the loss is cross-entropy
// (logsumexp - label logit) and *hit is 1 when the first maximum is the
// label; without it the loss is the squared error averaged over the C
// outputs against the target y_reg[r], and *hit is 0. Returns the loss.
__device__ __forceinline__ float row_loss_grad(float* zb, int C,
                                               const int* y_cls,
                                               const float* y_reg, int r,
                                               float scale, float* hit) {
  if (y_cls != nullptr) {
    const int label = y_cls[r];
    float zmax = zb[0];
    int pred = 0;
    for (int c = 1; c < C; ++c) {
      if (zb[c] > zmax) {
        zmax = zb[c];
        pred = c;
      }
    }
    float Z = 0.f;
    for (int c = 0; c < C; ++c) Z += expf(zb[c] - zmax);
    const float zl = (label >= 0 && label < C) ? zb[label] : 0.f;
    for (int c = 0; c < C; ++c) {
      const float sm = expf(zb[c] - zmax) / Z;
      zb[c] = (sm - (c == label ? 1.f : 0.f)) * scale;
    }
    *hit = (pred == label) ? 1.f : 0.f;
    return (logf(Z) + zmax) - zl;
  }
  const float t = y_reg[r];
  float per = 0.f;
  for (int c = 0; c < C; ++c) {
    const float e = zb[c] - t;
    per = fmaf(e, e, per);
    zb[c] = e * (2.f / C) * scale;
  }
  *hit = 0.f;
  return per / C;
}

// row_loss_grad for one row held in registers by a whole warp: every lane
// holds the same z (NC; the row's C logits, NC == C when EXACT, else the
// entries from C on are ignored) and ends with the same d loss / d z times
// `scale` in z and the same loss and *hit. Same semantics and the same
// arithmetic in the same order as row_loss_grad; for cross-entropy the
// C exponentials and quotients are split over lanes (lane c takes class c)
// and the sum over classes is gathered in class order. cls selects
// cross-entropy against `label` or the squared error against `target`.
template <int NC, bool EXACT>
__device__ __forceinline__ float row_loss_grad_warp(float (&z)[NC], int C,
                                                    bool cls, int label,
                                                    float target, float scale,
                                                    float* hit) {
  static_assert(NC <= 32, "a lane per class");
  if (EXACT) C = NC;
  if (cls) {
    const int lane = threadIdx.x & 31;
    float zmax = z[0], zc = z[0], zl = 0.f;
    int pred = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!EXACT && c >= C) break;
      if (z[c] > zmax) {
        zmax = z[c];
        pred = c;
      }
      if (c == lane) zc = z[c];
      if (c == label) zl = z[c];
    }
    const float e = expf(zc - zmax);  // lane c's class
    float Z = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!EXACT && c >= C) break;
      Z += __shfl_sync(0xffffffffu, e, c);
    }
    const float d = (e / Z - (lane == label ? 1.f : 0.f)) * scale;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (!EXACT && c >= C) break;
      z[c] = __shfl_sync(0xffffffffu, d, c);
    }
    *hit = (pred == label) ? 1.f : 0.f;
    return (logf(Z) + zmax) - zl;
  }
  float per = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!EXACT && c >= C) break;
    const float e = z[c] - target;
    per = fmaf(e, e, per);
    z[c] = e * (2.f / C) * scale;
  }
  *hit = 0.f;
  return per / C;
}

// row_loss_grad for any C, by one whole warp on one row zb (C) in shared or
// global memory: every lane returns the same loss and *hit, and zb holds
// d loss / d z times `scale` on exit (the warp synchronised). The warp walks
// ceil(C / 32) tiles of 32 classes in class order, lane l taking class
// c0 + l of the tile at c0. Cross-entropy keeps an online logsumexp: the
// running maximum and the sum of exp(z - max) rescaled whenever a tile
// raises the maximum; the first maximum wins (within a tile the lower class
// on a tie, across tiles an earlier tile unless a later one is strictly
// larger), as row_loss_grad and the Pallas kernel's argmax; the label's
// logit comes from its tile (0 when the label is out of range); a second
// sweep writes (softmax - onehot) * scale. The squared error sums e^2 over
// the tiles and divides by C. Same semantics as row_loss_grad, another
// summation order.
__device__ __forceinline__ float row_loss_grad_tiled(float* zb, int C,
                                                     bool cls, int label,
                                                     float target,
                                                     float scale,
                                                     float* hit) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  __syncwarp();  // zb may have been written by other lanes
  if (cls) {
    const float neg_inf = -__int_as_float(0x7f800000);
    float m = neg_inf, Z = 0.f, zl = 0.f;
    int pred = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const float v = c < C ? zb[c] : neg_inf;
      // the tile's first maximum: the larger value, the lower class on a tie
      float tm = v;
      int ti = c;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float om = __shfl_xor_sync(kAll, tm, o);
        const int oi = __shfl_xor_sync(kAll, ti, o);
        if (om > tm || (om == tm && oi < ti)) {
          tm = om;
          ti = oi;
        }
      }
      if (c0 == 0 || tm > m) pred = ti;
      const float mn = c0 == 0 ? tm : fmaxf(m, tm);
      float e = c < C ? expf(v - mn) : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(kAll, e, o);
      Z = (c0 == 0 ? 0.f : Z * expf(m - mn)) + e;
      m = mn;
      const float at = __shfl_sync(kAll, v, (label - c0) & 31);
      if (label >= c0 && label < c0 + 32 && label < C) zl = at;
    }
    for (int c = lane; c < C; c += 32)
      zb[c] = (expf(zb[c] - m) / Z - (c == label ? 1.f : 0.f)) * scale;
    __syncwarp();
    *hit = (pred == label) ? 1.f : 0.f;
    return (logf(Z) + m) - zl;
  }
  float per = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float e = zb[c] - target;
    per = fmaf(e, e, per);
    zb[c] = e * (2.f / C) * scale;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) per += __shfl_xor_sync(kAll, per, o);
  __syncwarp();
  *hit = 0.f;
  return per / C;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
