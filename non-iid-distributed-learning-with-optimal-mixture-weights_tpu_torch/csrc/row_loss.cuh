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

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
