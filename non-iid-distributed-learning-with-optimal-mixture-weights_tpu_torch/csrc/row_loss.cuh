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

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
