// Fused disparity head for Hopper (sm_90a), bf16 volumes, plain C API.
//
// Replaces the Pallas `_head_kernel` (leastereo_tpu/ops/pallas_head.py:96-236)
// for bf16 pre-head volumes (B, C, D, h, w), as soft_argmin_heads.cu's
// head_kernel does for every volume: the `last_3` 3x3x3 conv (C -> 1, zero
// padding) accumulated in fp32, edge replication of the cost after the conv,
// then the shared upsample + softmin + expectation stage (heads_common.cuh).
// The cost never reaches device memory.
//
// What bounds it on the H100: its 218 MB bf16 read at KITTI (0.066 ms at
// 3.35 TB/s); the conv is 5.9 GFLOP of useful multiply-adds. The design:
//  * A block owns TH x TW = 8 x 16 low-res pixels and all D planes, so its
//    shared memory (~110 KB at C = 32, D = 64) lets two blocks share an SM.
//    Tiles start J_SHIFT = 6 columns left of a multiple of 16, so each halo
//    box starts on a 16-byte boundary: TMA refuses (illegal instruction) a
//    box whose innermost start is not 16-byte aligned.
//  * TMA staging. One 5-D tensor map (w, h, d, c, b) over the volume; a box
//    is one input depth plane, all C channels, the +-2 halo in h and w, read
//    into a two-stage ring guarded by mbarriers: plane d+2 is in flight while
//    plane d is computed. TMA's zero fill of out-of-bounds elements is the
//    conv's zero padding in h and w, so no staging code tests bounds; planes
//    d = -1 and d = D contribute nothing and are never loaded.
//  * Channel contraction on tensor cores. For each staged plane,
//    P[voxel, tap] = sum_c V[c, voxel] W[c, tap] with mma.sync.m16n8k16
//    (bf16 in, fp32 accumulate): M = 16 consecutive voxels, K = 16 channels,
//    N = 27 taps padded to 32. A comes from the channel-major box with
//    ldmatrix.trans. Each fp32 weight is split into three bf16 parts,
//    W0 = bf16(W), W1 = bf16(W - W0), W2 = bf16(W - W0 - W1), whose sum is W
//    exactly; their products (bf16 x bf16 is exact in fp32) land in the same
//    fp32 accumulator. Two parts would keep only ~2^-17 of each weight, which
//    moves a diffuse softmin by up to ~1e-3 px at C = 64. When the weights are
//    bf16 already (the main path's), W1 = W2 = 0 and the block skips them.
//    The weight fragments live in registers for the whole kernel.
//  * fp32 tap sum. P goes to shared memory; each cost-tile site, evaluated at
//    its clamped in-frame site (edge replication after the conv), sums its
//    9 (kh, kw) taps per kd and adds them into cost planes d-kd+1, carried
//    in registers until a plane is complete: 27 fp32 adds per cost element.
//  * The shared stage (heads_common.cuh) runs on all 8 warps: its 384
//    (pixel, output row phase) units go to 256 threads, two to each of the
//    first 128.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "heads_common.cuh"

namespace {

constexpr int TH = 8;                  // low-res rows per block
constexpr int TW = 16;                 // low-res cols per block
constexpr int THREADS = 256;           // 8 warps: contraction, tap sum and the shared stage
constexpr int WARPS = THREADS / 32;
constexpr int HR = TH + 2;             // cost tile rows (+-1 halo)
constexpr int WR = TW + 2;             // cost tile cols (+-1 halo)
constexpr int PLANE = HR * WR;
constexpr int SR = TH + 4;             // voxel rows the conv reads (+-2)
constexpr int SW = TW + 4;             // voxel cols the conv reads (+-2)
constexpr int BW = 24;                 // box width: SW rounded up to whole 16-byte rows
constexpr int BH = SR + 1;             // box height: one spare row, so a channel's plane is an
                                       // odd number (39) of 16-byte rows and ldmatrix is conflict-free
constexpr int BOX = BW * BH;           // voxels of one channel in a stage
constexpr int MTILES = SR * BW / 16;   // 16-voxel row tiles of the contraction
constexpr int NTAP = 27;
constexpr int PSTRIDE = SR * SW + 4;   // P is [tap][SR*SW]; stride = 4 (mod 16) spreads fragment stores over 32 banks
constexpr int STAGES = 2;
constexpr int J_SHIFT = 6;             // tile j0 = 16 k - 6, so the box start j0 - 2 is a multiple of 8

static_assert(SR * BW % 16 == 0, "contraction tiles cover whole rows");
static_assert(BW % 8 == 0 && BW >= SW, "box rows are whole 16-byte lines");
static_assert((BOX / 8) % 2 == 1, "odd channel stride in 16-byte lines");
static_assert(PLANE <= THREADS, "one tap-sum thread per cost-tile site");
static_assert((TW - J_SHIFT - 2) % 8 == 0 && TW % 8 == 0, "box starts on 16-byte boundaries");

constexpr int TENSOR_MAP_ERROR = 100000;  // + CUresult of a refused tensor map

__host__ __device__ constexpr size_t stage_bytes(int C) { return (size_t)C * BOX * sizeof(__nv_bfloat16); }

size_t sm90_smem_bytes(int C, int D) {
  return STAGES * stage_bytes(C) + (size_t)NTAP * PSTRIDE * sizeof(float) + (size_t)D * PLANE * sizeof(float) +
         STAGES * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Expect one stage's bytes on `bar` and start the TMA load of input plane
// `d` (all channels, rows i0-2.., cols j0-2..) of batch `b` into `dst`.
__device__ __forceinline__ void load_plane(const CUtensorMap* map, uint32_t dst, uint32_t bar, uint32_t bytes,
                                           int j, int i, int d, int b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(j), "r"(i), "r"(d), "r"(0), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t a[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int PARTS = 3;  // bf16 parts of an fp32 weight

// Two fp32 weights (consecutive k) -> packed bf16 parts, W = sum of parts exactly.
__device__ __forceinline__ void split_pair(float w0, float w1, uint32_t part[PARTS]) {
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(w0), h1 = __float2bfloat16_rn(w1);
    part[p] = pack_bf16(h0, h1);
    w0 -= __bfloat162float(h0);
    w1 -= __bfloat162float(h1);
  }
}

template <int KS>  // C = 16 * KS channels; from C = 48 the shared memory allows one block per SM
__global__ void __launch_bounds__(THREADS, KS <= 2 ? 2 : 1)
head_sm90_kernel(const __grid_constant__ CUtensorMap vmap, const float* __restrict__ kern,
                 float* __restrict__ out, int D, int h, int w) {
  constexpr int C = 16 * KS;
  constexpr uint32_t STAGE_BYTES = static_cast<uint32_t>(stage_bytes(C));
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const __nv_bfloat16* stage = reinterpret_cast<const __nv_bfloat16*>(smem_raw);  // [STAGES][C][BH][BW]
  float* P = reinterpret_cast<float*>(smem_raw + STAGES * STAGE_BYTES);          // [NTAP][PSTRIDE]
  float* tile = P + NTAP * PSTRIDE;                                               // [D][HR][WR] cost
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + D * PLANE);                 // [STAGES]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW - J_SHIFT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < STAGES && s < D; ++s)
      load_plane(&vmap, smem_u32(stage + s * C * BOX), smem_u32(&full[s]), STAGE_BYTES, j0 - 2, i0 - 2, s, b);
  }

  // B fragments of m16n8k16 (K x N, "col"): this lane holds k = 2(lane%4) + {0, 1}
  // and k + 8 of column n = lane/4 of each 8-tap tile; taps >= 27 are zero.
  uint32_t bw[KS][4][2][PARTS];
  int residual = 0;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = nt * 8 + (lane >> 2);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = ks * 16 + 2 * (lane & 3) + 8 * r;
        const float w0 = n < NTAP ? kern[k * NTAP + n] : 0.0f;
        const float w1 = n < NTAP ? kern[(k + 1) * NTAP + n] : 0.0f;
        split_pair(w0, w1, bw[ks][nt][r]);
        residual |= (bw[ks][nt][r][1] | bw[ks][nt][r][2]) != 0u;
      }
    }
  }
  const bool bf16_weights = !__syncthreads_or(residual);  // block-uniform: skip the zero parts

  // Tap-sum thread of cost-tile site `tid`: the conv is evaluated at the
  // clamped in-frame site; pc is its (kh, kw) = (0, 0) voxel in P.
  const bool owner = tid < PLANE;
  int pc = 0;
  if (owner) {
    const int lr = heads::clampi(i0 - 1 + tid / WR, 0, h - 1) - (i0 - 2);
    const int lc = heads::clampi(j0 - 1 + tid % WR, 0, w - 1) - (j0 - 2);
    pc = (lr - 1) * SW + (lc - 1);
  }
  float a_prev = 0.0f;  // cost plane din - 1, all but its kd = 2 term
  float a_cur = 0.0f;   // cost plane din, its kd = 0 term

  for (int din = 0; din < D; ++din) {
    const int s = din % STAGES;
    mbar_wait(smem_u32(&full[s]), (din / STAGES) & 1);
    const __nv_bfloat16* st = stage + s * C * BOX;
    for (int mt = warp; mt < MTILES; mt += WARPS) {
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // A (16 voxels x 16 channels): four 8x8 matrices stored channel-major
        // (a 16-byte line is 8 voxels of one channel), transposed on load.
        const int mi = lane >> 3;
        const int k = ks * 16 + (lane & 7) + 8 * (mi >> 1);
        const int m = mt * 16 + 8 * (mi & 1);
        uint32_t a[4];
        ldmatrix_x4_trans(a, smem_u32(st + k * BOX + m));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int p = 0; p < PARTS; ++p) {
            if (p > 0 && bf16_weights) break;
            const uint32_t bp[2] = {bw[ks][nt][0][p], bw[ks][nt][1][p]};
            mma_bf16(acc[nt], a, bp);
          }
        }
      }
      // Accumulator rows are voxels (lane/4, +8), columns taps 2(lane%4) + {0, 1}.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + (lane >> 2) + 8 * half;
        const int r = m / BW, c = m % BW;
        if (c < SW) {
          float* pv = P + r * SW + c;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int n = nt * 8 + 2 * (lane & 3);
            if (n < NTAP) pv[n * PSTRIDE] = acc[nt][2 * half];
            if (n + 1 < NTAP) pv[(n + 1) * PSTRIDE] = acc[nt][2 * half + 1];
          }
        }
      }
    }
    __syncthreads();  // P holds plane din; every read of stage s is done
    if (tid == 0 && din + STAGES < D) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_plane(&vmap, smem_u32(st), smem_u32(&full[s]), STAGE_BYTES, j0 - 2, i0 - 2, din + STAGES, b);
    }
    if (owner) {
      float q[3];
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        float sum = 0.0f;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) sum += P[(kd * 9 + kh * 3 + kw) * PSTRIDE + pc + kh * SW + kw];
        }
        q[kd] = sum;
      }
      // Input plane din feeds cost planes din + 1 (kd = 0), din (1), din - 1 (2).
      if (din > 0) tile[(din - 1) * PLANE + tid] = a_prev + q[2];
      a_prev = a_cur + q[1];
      a_cur = q[0];
    }
    __syncthreads();  // the tap sum's reads of P are done
  }
  if (owner) tile[(D - 1) * PLANE + tid] = a_prev;  // plane D (zero padding) adds nothing
  __syncthreads();
  // All 256 threads run the stage; it masks pixels outside the frame,
  // including those left of it (j < 0, first tile column only).
  heads::upsample_softmin_store<TH, TW, THREADS>(tile, D, out, b, i0, j0, h, w);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime: no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <int KS>
int launch_sm90(const CUtensorMap& map, const float* kern, float* out, int B, int D, int h, int w,
                cudaStream_t stream) {
  const size_t smem = sm90_smem_bytes(16 * KS, D);
  cudaError_t err =
      cudaFuncSetAttribute(head_sm90_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + J_SHIFT + TW - 1) / TW, (h + TH - 1) / TH, B);
  head_sm90_kernel<KS><<<grid, THREADS, smem, stream>>>(map, kern, out, D, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long lst_head_sm90_smem_bytes(int C, int D) { return (long long)sm90_smem_bytes(C, D); }

// vol: (B, C, D, h, w) bf16 contiguous, 16-byte aligned, C in {16, 32, 48, 64},
// w % 8 == 0; kern: (C, 3, 3, 3) fp32 contiguous; out: (B, 3h, 3w) fp32.
// Returns a cudaError_t, or TENSOR_MAP_ERROR + the CUresult of a refused
// tensor map (TENSOR_MAP_ERROR + 999 when the encoder cannot be found).
int lst_head_sm90_soft_argmin(const void* vol, const void* kern, void* out, int B, int C, int D, int h, int w,
                              void* stream) {
  if (C % 16 != 0 || C < 16 || C > 64 || w % 8 != 0 || reinterpret_cast<uintptr_t>(vol) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_UNKNOWN;
  CUtensorMap map;
  const cuuint64_t es = sizeof(__nv_bfloat16);
  const cuuint64_t dims[5] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[4] = {w * es, (cuuint64_t)h * w * es, (cuuint64_t)D * h * w * es,
                                 (cuuint64_t)C * D * h * w * es};
  const cuuint32_t box[5] = {BW, BH, 1, (cuuint32_t)C, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(vol), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + (int)res;
  const float* k = static_cast<const float*>(kern);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (C / 16) {
    case 1: return launch_sm90<1>(map, k, o, B, D, h, w, st);
    case 2: return launch_sm90<2>(map, k, o, B, D, h, w, st);
    case 3: return launch_sm90<3>(map, k, o, B, D, h, w, st);
    default: return launch_sm90<4>(map, k, o, B, D, h, w, st);
  }
}

}  // extern "C"
