// Stage shared by the disparity-regression heads (soft_argmin_heads.cu,
// fused_head_sm90.cu): the 3x trilinear upsample (align_corners=False,
// edge-clamped) of a block's fp32 cost tile, a min-stabilised softmin over the
// 3D disparity phases and the expectation sum_d d * p(d), written straight to
// the interleaved (B, 3h, 3w) fp32 map.
//
// A block owns TH x TW low-resolution pixels (3TH x 3TW outputs); its cost
// tile is fp32 [D][TH+2][TW+2] in shared memory, already edge-replicated. The
// tile shape is a template parameter so that kernels with different tiles run
// the same stage; one thread handles one low-res pixel (TH * TW threads).

#pragma once

#include <cuda_runtime.h>

namespace heads {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The 9 (rh, rw) output phases of one low-res pixel at one disparity plane:
// H blend, then W blend, with 1/3 and 2/3 weights, from its 3x3 neighbourhood.
template <int TW>
__device__ __forceinline__ void blend9(const float* p, float cw[9]) {
  constexpr int WR = TW + 2;
  const float third = 1.0f / 3.0f, two_third = 2.0f / 3.0f;
  float ch[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x0 = p[c], x1 = p[WR + c], x2 = p[2 * WR + c];
    ch[0][c] = third * x0 + two_third * x1;
    ch[1][c] = x1;
    ch[2][c] = two_third * x1 + third * x2;
  }
#pragma unroll
  for (int rh = 0; rh < 3; ++rh) {
    cw[rh * 3 + 0] = third * ch[rh][0] + two_third * ch[rh][1];
    cw[rh * 3 + 1] = ch[rh][1];
    cw[rh * 3 + 2] = two_third * ch[rh][1] + third * ch[rh][2];
  }
}

// Upsample + softmin + expectation for this thread's pixel.
// `tile` is the block's fp32 cost tile [D][TH+2][TW+2], already edge-replicated.
template <int TH, int TW>
__device__ void upsample_softmin_store(const float* tile, int D, float* out, int b, int i0,
                                       int j0, int h, int w) {
  constexpr int WR = TW + 2, PLANE = (TH + 2) * WR;
  const float third = 1.0f / 3.0f;
  const int ti = threadIdx.x / TW, tj = threadIdx.x % TW;
  const float* base = tile + ti * WR + tj;

  float prev[9], cur[9], nxt[9], m[9];
  // Pass 1: the minimum over all 3D phases.
  blend9<TW>(base, cur);
#pragma unroll
  for (int k = 0; k < 9; ++k) { prev[k] = cur[k]; m[k] = cur[k]; }
  for (int d = 0; d < D; ++d) {
    if (d + 1 < D) {
      blend9<TW>(base + (d + 1) * PLANE, nxt);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) nxt[k] = cur[k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float a0 = (prev[k] + 2.0f * cur[k]) * third;
      const float a2 = (2.0f * cur[k] + nxt[k]) * third;
      m[k] = fminf(m[k], fminf(fminf(a0, cur[k]), a2));
      prev[k] = cur[k];
      cur[k] = nxt[k];
    }
  }
  // Pass 2: den = sum e, num = sum (3d + r) e.
  float num[9], den[9];
  blend9<TW>(base, cur);
#pragma unroll
  for (int k = 0; k < 9; ++k) { prev[k] = cur[k]; num[k] = 0.0f; den[k] = 0.0f; }
  for (int d = 0; d < D; ++d) {
    if (d + 1 < D) {
      blend9<TW>(base + (d + 1) * PLANE, nxt);
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) nxt[k] = cur[k];
    }
    const float i3 = 3.0f * d;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float a0 = (prev[k] + 2.0f * cur[k]) * third;
      const float a2 = (2.0f * cur[k] + nxt[k]) * third;
      const float e0 = __expf(m[k] - a0);
      const float e1 = __expf(m[k] - cur[k]);
      const float e2 = __expf(m[k] - a2);
      const float s = e0 + e1 + e2;
      den[k] += s;
      num[k] += i3 * s + (e1 + 2.0f * e2);
      prev[k] = cur[k];
      cur[k] = nxt[k];
    }
  }

  const int gi = i0 + ti, gj = j0 + tj;
  if (gi >= h || gj >= w) return;
  const int W3 = 3 * w;
  float* o = out + ((size_t)b * 3 * h + 3 * gi) * W3 + 3 * gj;
#pragma unroll
  for (int rh = 0; rh < 3; ++rh) {
#pragma unroll
    for (int rw = 0; rw < 3; ++rw) o[rh * W3 + rw] = num[rh * 3 + rw] / den[rh * 3 + rw];
  }
}

}  // namespace heads
