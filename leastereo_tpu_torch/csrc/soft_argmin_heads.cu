// Band kernel of LEAStereo's disparity regression for Hopper (sm_90a), plain C API.
//
// lst_band_soft_argmin replaces the Pallas `_band_kernel`
// (leastereo_tpu/ops/pallas_softargmin.py:45-98): the 3x trilinear upsample
// (align_corners=False, edge-clamped) of a 1-channel cost (B, D, h, w), a
// min-stabilised softmin over the 3D disparity phases and the expectation
// sum_d d * p(d), written straight to the interleaved (B, 3h, 3w) fp32 map,
// by the stage it shares with the fused head (heads_common.cuh;
// fused_head_sm90.cu computes its cost tile itself, from the pre-head volume).
//
// Tiling: a block owns a tile of low-resolution pixels and loads its cost
// tile, fp32 [D][rows+2][cols+2], with a +-1 edge-clamped halo from device
// memory into shared memory. Tile sites outside the frame take the value of
// the nearest in-frame site: that is the upsample's edge replication. Ragged
// frames are handled by clamping loads and masking stores. Every thread of a
// block runs the shared stage.
//
// What bounds it on the H100: it needs 9D exponentials per low-res pixel
// (30.7 M per KITTI frame: 0.0073 ms on the special-function units) against
// 15.5 MB of traffic (0.0046 ms), but neither is what its time follows: that
// is the instructions its shared stage executes per low-res pixel, plane and
// output row phase over both passes (blends, the min, the products and sums,
// loop overhead); timed without the exponentials it is no faster. Its
// design: 1 x 32 tiles, 96 threads (one per pixel and output row phase, a
// warp on one row: conflict-free shared loads), 26,112 B of shared memory at
// D = 64, so 8 blocks an SM; each SM runs 12 or 13 of the 1664 KITTI blocks.
// A block copies its tile with 4-byte cp.async (clamped source offsets
// computed once per site), waits, and runs the stage; the loads overlap
// compute across the blocks resident on an SM. (Running the min pass over
// D-chunks as they landed measured slower.)

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

size_t band_smem_bytes(int D) { return (size_t)D * BPLANE * sizeof(float); }

dim3 grid_for(int B, int h, int w, int th, int tw) { return dim3((w + tw - 1) / tw, (h + th - 1) / th, B); }

}  // namespace

extern "C" {

const char* lst_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Dynamic shared memory of the band kernel, so the host-side gate can be
// checked against the layout that was built.
long long lst_band_smem_bytes(int D) { return (long long)band_smem_bytes(D); }

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

}  // extern "C"
