// Disparity-regression heads of LEAStereo for Hopper (sm_90a), plain C API.
//
// Two kernels share one stage (heads_common.cuh): the 3x trilinear upsample
// (align_corners=False, edge-clamped) of a 1-channel cost (B, D, h, w), a
// min-stabilised softmin over the 3D disparity phases and the expectation
// sum_d d * p(d), written straight to the interleaved (B, 3h, 3w) fp32 map.
//
//  * band kernel (lst_band_soft_argmin) replaces the Pallas `_band_kernel`
//    (leastereo_tpu/ops/pallas_softargmin.py:45-98): each block loads its cost
//    tile with a +-1 edge-clamped halo from device memory.
//  * fused head (lst_head_soft_argmin) replaces the Pallas `_head_kernel`
//    (leastereo_tpu/ops/pallas_head.py:96-236): each block first computes its
//    cost tile itself, the `last_3` 3x3x3 conv (C -> 1, zero padding) of the
//    pre-head volume (B, C, D, h, w), accumulated in fp32 for fp32 and bf16
//    volumes alike, so the cost never reaches device memory.
//
// Tiling: a block owns a tile of low-resolution pixels and keeps its cost
// as fp32 [D][rows+2][cols+2] in shared memory. Tile sites outside the frame
// take the value of the nearest in-frame site: that is the upsample's edge
// replication, and for the fused head it is applied after the conv (the conv
// is evaluated at the clamped site). Ragged frames are handled by clamping
// loads and masking stores. Every thread of a block runs the shared stage.
//
// What bounds them on the H100: the band kernel needs 9D exponentials per
// low-res pixel (30.7 M per KITTI frame: 0.0073 ms on the special-function
// units) against 15.5 MB of traffic (0.0046 ms), but neither is what its
// time follows: that is the instructions its shared stage issues per low-res
// pixel, plane and output row phase over both passes (blends, the min, the
// products and sums, loop overhead); timed without the exponentials it is no
// faster. Its design: 1 x 32 tiles, 96 threads (one per pixel and output row
// phase, a warp on one row: conflict-free shared loads), 26,112 B of shared
// memory at D = 64, so 8 blocks an SM; each SM runs 12 or 13 of the 1664
// KITTI blocks. A block copies its tile with 4-byte cp.async (clamped source
// offsets computed once per site), waits, and runs the stage; the loads
// overlap compute across the blocks resident on an SM. (Running the min pass
// over D-chunks as they landed measured slower.)
//
// The fused head's conv is 27*C multiply-adds per cost element (5.9 GFLOP
// per KITTI frame) on CUDA cores; its ~200 KB of shared memory allows one
// block per SM, so the latency of staging each input channel and the FMA
// throughput bound it, far above its 218 MB read. The design keeps each
// input element in shared memory for all 27 taps (one staged slab per
// channel, halo amplification (TH+4)(TW+4)/(TH*TW) = 1.7x), runs 512 threads
// so more staging loads are in flight, and blocks the conv over 8
// disparities per work item, so each slab value read feeds up to three taps. This kernel serves fp32 volumes and the
// bf16 shapes that fused_head_sm90.cu (TMA staging, tensor-core channel
// contraction) does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "heads_common.cuh"

namespace {

// Band kernel geometry.
constexpr int BTH = 1;                   // low-res rows per block
constexpr int BTW = 32;                  // low-res cols per block
constexpr int BMIN_BLOCKS = 8;           // resident blocks an SM (registers capped to fit)
constexpr int BTHREADS = 3 * BTH * BTW;  // one (pixel, output row phase) unit per thread
constexpr int BWR = BTW + 2;             // cost tile cols (+-1 halo)
constexpr int BPLANE = (BTH + 2) * BWR;
constexpr int BSITES = (BPLANE + BTHREADS - 1) / BTHREADS;  // tile sites each thread loads

// Fused head (first design) geometry.
constexpr int TH = 8;               // low-res rows per block
constexpr int TW = 32;              // low-res cols per block
constexpr int HEAD_THREADS = 512;   // more loads in flight while staging; all run the stage
constexpr int HR = TH + 2;          // cost tile rows (+-1 halo)
constexpr int WR = TW + 2;          // cost tile cols (+-1 halo)
constexpr int PLANE = HR * WR;
constexpr int SR = TH + 4;          // fused head: staged input rows (+-2)
constexpr int SW = TW + 4;          // fused head: staged input cols (+-2)
constexpr int SPLANE = SR * SW;
constexpr int DCHUNK = 8;           // fused head: disparities per conv work item

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

using heads::clampi;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__global__ void __launch_bounds__(BTHREADS, BMIN_BLOCKS)
band_kernel(const float* __restrict__ cost, float* __restrict__ out, int D, int h, int w) {
  extern __shared__ float tile[];  // [D][BTH+2][BTW+2]
  const int b = blockIdx.z, i0 = blockIdx.y * BTH, j0 = blockIdx.x * BTW;
  const size_t hw = (size_t)h * w;
  // Thread t loads tile sites t + k BTHREADS of every plane, each from its
  // clamped source.
#pragma unroll
  for (int k = 0; k < BSITES; ++k) {
    const int s = threadIdx.x + k * BTHREADS;
    if (s < BPLANE) {
      const float* src = cost + (size_t)b * D * hw + (size_t)clampi(i0 - 1 + s / BWR, 0, h - 1) * w +
                         clampi(j0 - 1 + s % BWR, 0, w - 1);
      for (int d = 0; d < D; ++d) cp_async4(tile + d * BPLANE + s, src + d * hw);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  heads::upsample_softmin_store<BTH, BTW, BTHREADS>(tile, D, out, b, i0, j0, h, w);
}

__host__ __device__ inline int padded_depth(int D) { return (D + DCHUNK - 1) / DCHUNK * DCHUNK; }

template <typename T>
__global__ void __launch_bounds__(HEAD_THREADS)
head_kernel(const T* __restrict__ vol, const float* __restrict__ kern, float* __restrict__ out,
            int C, int D, int h, int w) {
  extern __shared__ float smem[];
  const int dp = padded_depth(D);
  float* tile = smem;                          // [D][HR][WR] cost accumulator
  float* slab = tile + D * PLANE;              // [dp+2][SR][SW] one input channel
  float* wsm = slab + (dp + 2) * SPLANE;       // [C][3][3][3] conv weights
  const int b = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;

  for (int idx = threadIdx.x; idx < D * PLANE; idx += HEAD_THREADS) tile[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < C * 27; idx += HEAD_THREADS) wsm[idx] = kern[idx];
  // Depth padding planes of the slab (d = -1 and d >= D) stay zero throughout.
  for (int idx = threadIdx.x; idx < SPLANE; idx += HEAD_THREADS) slab[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < (dp + 1 - D) * SPLANE; idx += HEAD_THREADS)
    slab[(D + 1) * SPLANE + idx] = 0.0f;

  const int nsite = PLANE;
  const int nitems = nsite * (dp / DCHUNK);
  const size_t hw = (size_t)h * w;
  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous channel's slab reads are done
    const T* src = vol + ((size_t)b * C + c) * D * hw;
#pragma unroll 8
    for (int idx = threadIdx.x; idx < D * SPLANE; idx += HEAD_THREADS) {
      const int d = idx / SPLANE, rem = idx % SPLANE;
      const int gi = i0 - 2 + rem / SW, gj = j0 - 2 + rem % SW;
      float v = 0.0f;  // the conv's zero padding outside the frame
      if (gi >= 0 && gi < h && gj >= 0 && gj < w) v = to_float(src[d * hw + (size_t)gi * w + gj]);
      slab[(d + 1) * SPLANE + rem] = v;
    }
    __syncthreads();
    const float* wc = wsm + c * 27;
    for (int item = threadIdx.x; item < nitems; item += HEAD_THREADS) {
      const int s = item % nsite, d0 = (item / nsite) * DCHUNK;
      // Evaluate the conv at the clamped in-frame site (edge replication of
      // the cost happens after the conv); its centre in slab coordinates:
      const int lr = clampi(i0 - 1 + s / WR, 0, h - 1) - (i0 - 2);
      const int lc = clampi(j0 - 1 + s % WR, 0, w - 1) - (j0 - 2);
      float acc[DCHUNK];
#pragma unroll
      for (int k = 0; k < DCHUNK; ++k) acc[k] = 0.0f;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          // slab plane d0 + t holds depth d0 + t - 1
          const float* col = slab + d0 * SPLANE + (lr - 1 + kh) * SW + (lc - 1 + kw);
          float v[DCHUNK + 2];
#pragma unroll
          for (int t = 0; t < DCHUNK + 2; ++t) v[t] = col[t * SPLANE];
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            const float wv = wc[kd * 9 + kh * 3 + kw];
#pragma unroll
            for (int k = 0; k < DCHUNK; ++k) acc[k] = fmaf(wv, v[k + kd], acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < DCHUNK; ++k)
        if (d0 + k < D) tile[(d0 + k) * PLANE + s] += acc[k];
    }
  }
  __syncthreads();
  heads::upsample_softmin_store<TH, TW, HEAD_THREADS>(tile, D, out, b, i0, j0, h, w);
}

size_t band_smem_bytes(int D) { return (size_t)D * BPLANE * sizeof(float); }

size_t head_smem_bytes(int C, int D) {
  return ((size_t)D * PLANE + (size_t)(padded_depth(D) + 2) * SPLANE + (size_t)C * 27) * sizeof(float);
}

dim3 grid_for(int B, int h, int w, int th, int tw) { return dim3((w + tw - 1) / tw, (h + th - 1) / th, B); }

template <typename T>
int launch_head(const void* vol, const void* kern, void* out, int B, int C, int D, int h, int w,
                cudaStream_t stream) {
  const size_t smem = head_smem_bytes(C, D);
  cudaError_t err = cudaFuncSetAttribute(head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_kernel<T><<<grid_for(B, h, w, TH, TW), HEAD_THREADS, smem, stream>>>(
      static_cast<const T*>(vol), static_cast<const float*>(kern), static_cast<float*>(out), C, D, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lst_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory of each kernel, so the host-side gates can be
// checked against the layout that was built.
long long lst_band_smem_bytes(int D) { return (long long)band_smem_bytes(D); }
long long lst_head_smem_bytes(int C, int D) { return (long long)head_smem_bytes(C, D); }

// Band kernel blocks resident on one SM at depth D (registers and shared
// memory), or -1 on an error.
int lst_band_blocks_per_sm(int D) {
  const size_t smem = band_smem_bytes(D);
  if (cudaFuncSetAttribute(band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, band_kernel, BTHREADS, smem) != cudaSuccess) return -1;
  return blocks;
}

// cost: (B, D, h, w) fp32 contiguous; out: (B, 3h, 3w) fp32 contiguous.
int lst_band_soft_argmin(const void* cost, void* out, int B, int D, int h, int w, void* stream) {
  const size_t smem = band_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  band_kernel<<<grid_for(B, h, w, BTH, BTW), BTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(cost), static_cast<float*>(out), D, h, w);
  return (int)cudaGetLastError();
}

// vol: (B, C, D, h, w) contiguous, fp32 (vol_is_bf16 = 0) or bf16 (1);
// kern: (C, 3, 3, 3) fp32 contiguous; out: (B, 3h, 3w) fp32 contiguous.
int lst_head_soft_argmin(const void* vol, int vol_is_bf16, const void* kern, void* out, int B, int C,
                         int D, int h, int w, void* stream) {
  if (vol_is_bf16) return launch_head<__nv_bfloat16>(vol, kern, out, B, C, D, h, w, (cudaStream_t)stream);
  return launch_head<float>(vol, kern, out, B, C, D, h, w, (cudaStream_t)stream);
}

}  // extern "C"
