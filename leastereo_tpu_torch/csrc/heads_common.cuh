// Stage shared by the disparity-regression heads (soft_argmin_heads.cu,
// fused_head_sm90.cu): the 3x trilinear upsample (align_corners=False,
// edge-clamped) of a block's fp32 cost tile, a min-stabilised softmin over the
// 3D disparity phases and the expectation sum_d d * p(d), written straight to
// the interleaved (B, 3h, 3w) fp32 map.
//
// A block owns TH x TW low-resolution pixels (3TH x 3TW outputs); its cost
// tile is fp32 [D][TH+2][TW+2] in shared memory, already edge-replicated.
//
// One exponential per low-res plane and output phase. Let c_k be the blended
// cost of one output phase (rh, rw) at low-res plane k, m = min_k c_k and
// u_k = exp((m - c_k) / 3). The disparity phases a0 = (c_{k-1} + 2c_k)/3,
// a1 = c_k and a2 = (2c_k + c_{k+1})/3 give exp(m - a0) = u_{k-1} u_k^2,
// exp(m - a1) = u_k^3 and exp(m - a2) = u_k^2 u_{k+1} (u_{-1} = u_0 and
// u_D = u_{D-1}, the edge clamps). Every blend is a convex combination of
// the c_k, so m is also the minimum over all 3D phases, u_k <= 1, and the
// term at the minimum is exactly 1 (pass 2 recomputes c_k bit for bit as
// pass 1 did), so den >= 1. That is 9D exponentials per low-res pixel, where
// the phase-by-phase form needs 27D.
//
// The work of a pixel is split by output row phase rh: a unit is (pixel, rh)
// and owns the 3 column phases of one output row, so it needs nothing from
// other threads and writes one run of 3 floats. A block's NT threads take its
// 3 TH TW units in turn (unit u = thread + r NT); consecutive threads hold
// consecutive pixels of one row phase.

#pragma once

#include <cuda_runtime.h>

namespace heads {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// 2^x on the special-function unit; x <= 0 here.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The 3 column phases of output row phase RH at one plane, from the 3x3
// neighbourhood whose top-left tile site is p: H blend, then W blend, with
// 1/3 and 2/3 weights. Explicit roundings (no contraction left to the
// compiler), so both passes get the same bits.
template <int WR, int RH>
__device__ __forceinline__ void blend_row(const float* p, float c[3]) {
  constexpr float third = 1.0f / 3.0f, two_third = 2.0f / 3.0f;
  float ch[3];
  if constexpr (RH == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) ch[k] = p[WR + k];
  } else {
    const float* q = RH == 0 ? p : p + WR;
    constexpr float wa = RH == 0 ? third : two_third, wb = RH == 0 ? two_third : third;
#pragma unroll
    for (int k = 0; k < 3; ++k) ch[k] = __fmaf_rn(wa, q[k], __fmul_rn(wb, q[WR + k]));
  }
  c[0] = __fmaf_rn(third, ch[0], __fmul_rn(two_third, ch[1]));
  c[1] = ch[1];
  c[2] = __fmaf_rn(two_third, ch[1], __fmul_rn(third, ch[2]));
}

// Pass 1 of one unit: m = min over planes of its 3 column phases.
template <int WR, int PLANE, int RH>
__device__ __forceinline__ void unit_min(const float* p, int D, float m[3]) {
  m[0] = m[1] = m[2] = __int_as_float(0x7f800000);
  for (int d = 0; d < D; ++d, p += PLANE) {  // pass 1
    float c[3];
    blend_row<WR, RH>(p, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = fminf(m[k], c[k]);
  }
}

// Pass 2 of one unit: den = sum_k e0 + e1 + e2 and num = sum_k 3k (e0 + e1 +
// e2) + e1 + 2 e2 of its 3 phases, from u_k = 2^((m - c_k) log2(e) / 3).
template <int WR, int PLANE, int RH>
__device__ __forceinline__ void unit_sums(const float* p, int D, const float m[3], float num[3], float den[3]) {
  constexpr float SCALE = 1.4426950408889634f / 3.0f;
  float c[3], up[3], uc[3], un[3];
  blend_row<WR, RH>(p, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uc[k] = ex2((m[k] - c[k]) * SCALE);
    up[k] = uc[k];
    num[k] = den[k] = 0.0f;
  }
  float i3 = 0.0f;
  for (int d = 0; d < D; ++d, i3 += 3.0f) {
    if (d + 1 < D) {
      p += PLANE;
      blend_row<WR, RH>(p, c);
#pragma unroll
      for (int k = 0; k < 3; ++k) un[k] = ex2((m[k] - c[k]) * SCALE);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) un[k] = uc[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float s = up[k] + uc[k] + un[k], sq = uc[k] * uc[k];
      den[k] = fmaf(sq, s, den[k]);
      num[k] = fmaf(sq, fmaf(i3, s, fmaf(2.0f, un[k], uc[k])), num[k]);
      up[k] = uc[k];
      uc[k] = un[k];
    }
  }
}

// The stage for a block's TH x TW tile, run by all NT threads of the block:
// pass 1 for each of a thread's units (u = thread + r NT), then pass 2 and
// the store for each. (Both passes of one unit before the next measured
// slower in the first design, whose conv loop the compiler then built
// differently.)
template <int TH, int TW, int NT>
struct SoftminStage {
  static constexpr int WR = TW + 2, PLANE = (TH + 2) * WR;
  static constexpr int PIX = TH * TW, UNITS = 3 * PIX, R = (UNITS + NT - 1) / NT;

  const float* tile;
  int D;
  float m[R][3];

  __device__ SoftminStage(const float* tile_, int D_) : tile(tile_), D(D_) {}

  __device__ static bool valid(int r) { return UNITS % NT == 0 || (int)threadIdx.x + r * NT < UNITS; }
  __device__ static int row_phase(int r) { return ((int)threadIdx.x + r * NT) / PIX; }
  __device__ static int pixel(int r) { return ((int)threadIdx.x + r * NT) % PIX; }
  __device__ const float* site(int r) const { return tile + (pixel(r) / TW) * WR + pixel(r) % TW; }

  __device__ void min_pass() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!valid(r)) continue;
      switch (row_phase(r)) {  // warp-uniform when TH TW is a multiple of 32
        case 0: unit_min<WR, PLANE, 0>(site(r), D, m[r]); break;
        case 1: unit_min<WR, PLANE, 1>(site(r), D, m[r]); break;
        default: unit_min<WR, PLANE, 2>(site(r), D, m[r]); break;
      }
    }
  }

  // Pixels outside the frame (i >= h, j >= w or j < 0) are not stored.
  __device__ void sum_pass_store(float* out, int b, int i0, int j0, int h, int w) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!valid(r)) continue;
      const int rh = row_phase(r);
      float num[3], den[3];
      switch (rh) {
        case 0: unit_sums<WR, PLANE, 0>(site(r), D, m[r], num, den); break;
        case 1: unit_sums<WR, PLANE, 1>(site(r), D, m[r], num, den); break;
        default: unit_sums<WR, PLANE, 2>(site(r), D, m[r], num, den); break;
      }
      const int gi = i0 + pixel(r) / TW, gj = j0 + pixel(r) % TW;
      if (gi >= h || gj >= w || gj < 0) continue;
      float* o = out + ((size_t)b * 3 * h + 3 * gi + rh) * (3 * (size_t)w) + 3 * gj;
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = num[k] / den[k];
    }
  }
};

// Upsample + softmin + expectation of a block's whole tile.
template <int TH, int TW, int NT>
__device__ __forceinline__ void upsample_softmin_store(const float* tile, int D, float* out, int b, int i0, int j0,
                                                       int h, int w) {
  SoftminStage<TH, TW, NT> stage(tile, D);
  stage.min_pass();
  stage.sum_pass_store(out, b, i0, j0, h, w);
}

}  // namespace heads
