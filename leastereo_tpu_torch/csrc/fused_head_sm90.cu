// Fused disparity head for Hopper (sm_90a), bf16 and fp32 volumes, plain C API.
//
// Replaces the Pallas `_head_kernel` (leastereo_tpu/ops/pallas_head.py:96-236)
// for pre-head volumes (B, C, D, h, w) of bf16 (head_sm90_kernel) and fp32
// (head_sm90_f32_kernel), as soft_argmin_heads.cu's head_kernel does for every
// volume: the `last_3` 3x3x3 conv (C -> 1, zero padding) accumulated in fp32,
// edge replication of the cost after the conv, then the shared upsample +
// softmin + expectation stage (heads_common.cuh). The cost never reaches
// device memory. Both kernels share one body, templated on the volume's
// element type; only the box geometry, the ring depth and the contraction's
// instructions differ.
//
// What bounds it on the H100: its volume read, 218 MB in bf16 and 436 MB in
// fp32 at KITTI (0.066 and 0.131 ms at 3.35 TB/s); the conv is 5.9 GFLOP of
// useful multiply-adds. The design:
//  * A block owns TH x TW = 8 x 16 low-res pixels and all D planes. Its
//    shared memory at C = 32, D = 64 (bf16 112,384 B, fp32 103,168 B) lets two
//    blocks share an SM, so one block's staging and barriers overlap the
//    other's compute: 16 warps an SM, where one fp32 block with a deeper ring
//    (8 warps) measured 30% slower. Tiles start J_SHIFT = 6 columns left of a
//    multiple of 16, so each halo box starts on a 16-byte boundary in either
//    type: TMA refuses (illegal instruction) a box whose innermost start is
//    not 16-byte aligned.
//  * TMA staging. One 5-D tensor map (w, h, d, c, b) over the volume; a box
//    is one input depth plane, all C channels (fp32: C/2, two boxes a
//    stage), the +-2 halo in h and w, read
//    into a ring of stages guarded by mbarriers: while plane d is computed,
//    planes d+1 .. d+stages-1 are in flight. TMA's zero fill of out-of-bounds
//    elements is the conv's zero padding in h and w, so no staging code tests
//    bounds; planes d = -1 and d = D contribute nothing and are never loaded.
//    bf16: two stages. fp32: up to two stages, as many as fit beside the tap
//    products and the cost tile in half an SM's shared memory for C <= 32
//    (one at C = 32, D = 64), or in a whole SM's when half cannot hold one
//    (C >= 48, registers, or a deep D); a stage is two boxes of C/2
//    channels, each on its own mbarrier, so the next plane's first half
//    loads while this plane's second half is contracted and its taps summed
//    (3.7% faster than one box a stage, at one more barrier a plane).
//  * Channel contraction on tensor cores. For each staged plane,
//    P[voxel, tap] = sum_c V[c, voxel] W[c, tap]: M = 16 consecutive voxels,
//    N = 27 taps padded to 32, accumulated in fp32. The weight fragments live
//    in registers for the whole kernel.
//    - bf16 volume: mma.sync.m16n8k16 (bf16 in), K = 16 channels; A comes
//      from the channel-major box with ldmatrix.trans. Each fp32 weight is
//      split into three bf16 parts, W0 = bf16(W), W1 = bf16(W - W0),
//      W2 = bf16(W - W0 - W1), whose sum is W exactly; their products (bf16 x
//      bf16 is exact in fp32) land in the same accumulator. Two parts would
//      keep only ~2^-17 of each weight, which moves a diffuse softmin by up
//      to ~1e-3 px at C = 64. When the weights are bf16 already (the main
//      path's), W1 = W2 = 0 and the block skips them.
//    - fp32 volume: 3xTF32 on mma.sync.m16n8k8 (tf32 in), K = 8 channels.
//      Each value x, voxel and weight alike, is split into two tf32 parts,
//      big = tf32(x) and small = tf32(x - big) (cvt.rna; x - big is exact),
//      which keep x to ~2^-22; the three products small(V) big(W),
//      big(V) small(W), big(V) big(W) are exact in fp32 and share the
//      accumulator, and small(V) small(W) (~2^-22 of the term) is dropped.
//      So the conv is fp32-accurate whatever cuDNN's or cuBLAS's TF32 flags
//      say. A comes from the box with 32-bit shared loads. A channel is
//      BW x BH = 20 x 12 = 240 = 16 (mod 32) words, so the 4 channels x 8
//      voxels of a fragment load meet in pairs on 16 banks (two-way
//      conflicts); two spare box rows (280 = 24 (mod 32) words, no conflict)
//      stage 14% more bytes and measured 1-4% slower. The mma run one
//      product at a time over the 4 tap tiles, so consecutive mma write
//      different accumulators (the 3 products of one accumulator back to
//      back measured 9% slower). When every weight is a tf32 value
//      (small(W) = 0) the block skips that product.
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

#include <type_traits>

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
constexpr int NTAP = 27;
constexpr int PSTRIDE = SR * SW + 4;   // P is [tap][SR*SW]; stride = 4 (mod 16) spreads fragment stores over 32 banks
constexpr int J_SHIFT = 6;             // tile j0 = 16 k - 6, so the box start j0 - 2 is a multiple of 8
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory one block may use (227 KB)
constexpr size_t PAIR_LIMIT = 115712;  // the same with two blocks an SM: (233,472 - 2 x 1 KB reserved) / 2

static_assert(PLANE <= THREADS, "one tap-sum thread per cost-tile site");
static_assert((TW - J_SHIFT - 2) % 8 == 0 && TW % 8 == 0, "box starts on 16-byte boundaries");

// Box geometry and ring depth of each volume element type.
template <typename T>
struct Geom;

template <>
struct Geom<__nv_bfloat16> {
  static constexpr int BW = 24;            // box width: SW rounded up to whole 16-byte rows
  static constexpr int BH = SR + 1;        // one spare row, so a channel's plane is an odd number
                                           // (39) of 16-byte rows and ldmatrix is conflict-free
  static constexpr int MAX_STAGES = 2;
  static constexpr int HALVES = 1;         // loads (and mbarriers) a stage
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct Geom<float> {
  static constexpr int BW = 20;            // SW: 80 bytes, whole 16-byte rows
  static constexpr int BH = SR;            // no spare row: a channel is 240 words
  static constexpr int MAX_STAGES = 2;
  static constexpr int HALVES = 2;         // each channel half of a plane loads on its own mbarrier
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T>
constexpr int BOX = Geom<T>::BW * Geom<T>::BH;  // elements of one channel in a stage
template <typename T>
constexpr int MTILES = SR * Geom<T>::BW / 16;  // 16-voxel row tiles of the contraction

static_assert(SR * Geom<__nv_bfloat16>::BW % 16 == 0 && SR * Geom<float>::BW % 16 == 0,
              "contraction tiles cover whole rows");
static_assert(Geom<__nv_bfloat16>::BW % 8 == 0 && Geom<__nv_bfloat16>::BW >= SW, "bf16 box rows are whole 16-byte lines");
static_assert((BOX<__nv_bfloat16> / 8) % 2 == 1, "odd bf16 channel stride in 16-byte lines");
static_assert(Geom<float>::BW % 4 == 0 && Geom<float>::BW >= SW, "fp32 box rows are whole 16-byte lines");

constexpr int TENSOR_MAP_ERROR = 100000;  // + CUresult of a refused tensor map

template <typename T>
__host__ __device__ constexpr size_t stage_bytes(int C) {
  return (size_t)C * BOX<T> * sizeof(T);
}

// Tap products and cost tile: the shared memory besides the ring.
constexpr size_t fixed_bytes(int D) { return (size_t)NTAP * PSTRIDE * sizeof(float) + (size_t)D * PLANE * sizeof(float); }

size_t sm90_smem_bytes(int C, int D) {
  constexpr int STAGES = Geom<__nv_bfloat16>::MAX_STAGES;
  return STAGES * stage_bytes<__nv_bfloat16>(C) + fixed_bytes(D) + STAGES * sizeof(uint64_t);
}

// fp32 stages (each with its two mbarriers) that fit beside the tap products and
// the cost tile within `limit`, at most MAX_STAGES.
int f32_fit(int C, int D, size_t limit) {
  const size_t per_stage = stage_bytes<float>(C) + Geom<float>::HALVES * sizeof(uint64_t);
  const size_t fixed = fixed_bytes(D);
  const size_t fit = fixed >= limit ? 0 : (limit - fixed) / per_stage;
  return (int)(fit < Geom<float>::MAX_STAGES ? fit : Geom<float>::MAX_STAGES);
}

// fp32 ring depth: within half an SM (two blocks an SM) for C <= 32 when one
// stage fits there, else within the whole limit; 0 when none fits.
int f32_stages(int C, int D) {
  if (C <= 32 && f32_fit(C, D, PAIR_LIMIT) >= 1) return f32_fit(C, D, PAIR_LIMIT);
  return f32_fit(C, D, SMEM_LIMIT);
}

// Shared memory of the fp32 kernel: at least one stage, so it exceeds
// SMEM_LIMIT exactly when none fits.
size_t sm90_f32_smem_bytes(int C, int D) {
  const int stages = f32_stages(C, D) < 1 ? 1 : f32_stages(C, D);
  return stages * (stage_bytes<float>(C) + Geom<float>::HALVES * sizeof(uint64_t)) + fixed_bytes(D);
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

// Expect `bytes` on `bar` and start the TMA load of input plane `d` (the
// box's channels from `c`, rows i0-2.., cols j0-2..) of batch `b` into `dst`.
__device__ __forceinline__ void load_plane(const CUtensorMap* map, uint32_t dst, uint32_t bar, uint32_t bytes,
                                           int j, int i, int d, int c, int b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(j), "r"(i), "r"(d), "r"(c), "r"(b), "r"(bar)
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

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// fp32 -> tf32, rounded to nearest, ties away from zero (low 13 bits zero).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small) tf32 parts: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// The fused head of one block; T is the volume's element type, C = 16 * KS
// channels, `stages` the ring depth.
template <typename T, int KS>
__device__ __forceinline__ void head_sm90_body(const CUtensorMap* vmap, const float* __restrict__ kern,
                                               float* __restrict__ out, int D, int h, int w, int stages) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int C = 16 * KS;
  constexpr int BW = Geom<T>::BW;
  constexpr int BOXT = BOX<T>;
  constexpr int MT = MTILES<T>;
  constexpr uint32_t STAGE_BYTES = static_cast<uint32_t>(stage_bytes<T>(C));
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const T* stage = reinterpret_cast<const T*>(smem_raw);                       // [stages][C][BH][BW]
  float* P = reinterpret_cast<float*>(smem_raw + stages * STAGE_BYTES);          // [NTAP][PSTRIDE]
  float* tile = P + NTAP * PSTRIDE;                                               // [D][HR][WR] cost
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + D * PLANE);                 // [stages][HALVES]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, i0 = blockIdx.y * TH, j0 = blockIdx.x * TW - J_SHIFT;

  constexpr int HALVES = Geom<T>::HALVES;
  if (tid == 0) {
    for (int s = 0; s < HALVES * stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < stages && s < D; ++s)
      for (int hh = 0; hh < HALVES; ++hh)
        load_plane(vmap, smem_u32(stage + (s * C + hh * (C / HALVES)) * BOXT), smem_u32(&full[HALVES * s + hh]),
                   STAGE_BYTES / HALVES, j0 - 2, i0 - 2, s, hh * (C / HALVES), b);
  }

  // B fragments (K x N, "col"), taps >= 27 zero. bf16 (m16n8k16): this lane
  // holds k = 2(lane%4) + {0, 1} and k + 8 of column n = lane/4 of each 8-tap
  // tile, as PARTS packed bf16 parts. fp32 (m16n8k8): k = lane%4 and k + 4
  // of column n, each as its big and small tf32 parts.
  constexpr int KSTEPS = F32 ? 2 * KS : KS;
  constexpr int WPARTS = F32 ? 2 : PARTS;
  uint32_t bw[KSTEPS][4][2][WPARTS];
  int residual = 0;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = nt * 8 + (lane >> 2);
      if constexpr (F32) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = ks * 8 + (lane & 3) + 4 * r;
          split_tf32(n < NTAP ? kern[k * NTAP + n] : 0.0f, bw[ks][nt][r][0], bw[ks][nt][r][1]);
          residual |= bw[ks][nt][r][1] != 0u;
        }
      } else {
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
  }
  // Block-uniform: skip the zero weight parts (bf16 weights in bf16, tf32 weights in fp32).
  const bool one_part_weights = !__syncthreads_or(residual);

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
    const int s = din % stages;
    const T* st = stage + s * C * BOXT;
    if constexpr (F32) {
      // Channel halves, each on its own mbarrier: once every warp has read
      // the first, the next plane's first half loads while this plane's
      // second half is contracted. A warp owns row tiles warp and warp + 8,
      // their accumulators live across both halves.
      static_assert(MT <= 2 * WARPS, "two row tiles a warp");
      constexpr int HK = KSTEPS / 2;  // k-steps of a channel half
      float acc[2][4][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[t][nt][0] = acc[t][nt][1] = acc[t][nt][2] = acc[t][nt][3] = 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mbar_wait(smem_u32(&full[2 * s + hh]), (din / stages) & 1);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int mt = warp + t * WARPS;
          if (mt >= MT) break;  // warp-uniform: warp 7 has one row tile
#pragma unroll
          for (int kk = 0; kk < HK; ++kk) {
            const int ks = hh * HK + kk;
            // A (16 voxels x 8 channels, "row"): a0 (voxel lane/4, channel
            // lane%4), a1 (voxel + 8), a2 (channel + 4), a3 (both).
            const float* pa = st + (ks * 8 + (lane & 3)) * BOXT + mt * 16 + (lane >> 2);
            uint32_t big[4], small[4];
            split_tf32(pa[0], big[0], small[0]);
            split_tf32(pa[8], big[1], small[1]);
            split_tf32(pa[4 * BOXT], big[2], small[2]);
            split_tf32(pa[4 * BOXT + 8], big[3], small[3]);
            // One product over the 4 tap tiles at a time: consecutive mma
            // write different accumulators, so none waits on the one before.
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[t][nt], small, bw[ks][nt][0][0], bw[ks][nt][1][0]);
            if (!one_part_weights) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[t][nt], big, bw[ks][nt][0][1], bw[ks][nt][1][1]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[t][nt], big, bw[ks][nt][0][0], bw[ks][nt][1][0]);
          }
        }
        if (hh == 0) {
          __syncthreads();  // every read of the first channel half is done
          if (tid == 0 && din + stages < D) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            load_plane(vmap, smem_u32(st), smem_u32(&full[2 * s]), STAGE_BYTES / 2, j0 - 2, i0 - 2, din + stages, 0, b);
          }
        }
      }
      // Accumulator rows are voxels (lane/4, +8), columns taps 2(lane%4) +
      // {0, 1}; BW = SW, so a voxel's index in P is its index in the box.
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int mt = warp + t * WARPS;
        if (mt >= MT) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float* pv = P + mt * 16 + (lane >> 2) + 8 * half;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int n = nt * 8 + 2 * (lane & 3);
            if (n < NTAP) pv[n * PSTRIDE] = acc[t][nt][2 * half];
            if (n + 1 < NTAP) pv[(n + 1) * PSTRIDE] = acc[t][nt][2 * half + 1];
          }
        }
      }
    } else {
      mbar_wait(smem_u32(&full[s]), (din / stages) & 1);
      for (int mt = warp; mt < MT; mt += WARPS) {
        float acc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          // A (16 voxels x 16 channels): four 8x8 matrices stored channel-major
          // (a 16-byte line is 8 voxels of one channel), transposed on load.
          const int mi = lane >> 3;
          const int k = ks * 16 + (lane & 7) + 8 * (mi >> 1);
          const int m = mt * 16 + 8 * (mi & 1);
          uint32_t a[4];
          ldmatrix_x4_trans(a, smem_u32(st + k * BOXT + m));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int p = 0; p < PARTS; ++p) {
              if (p > 0 && one_part_weights) break;
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
    }
    __syncthreads();  // P holds plane din; every read of stage s is done
    if (tid == 0 && din + stages < D) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // The stage's last (fp32: second) half of plane din + stages.
      const int c0 = C - C / HALVES;
      load_plane(vmap, smem_u32(st + c0 * BOXT), smem_u32(&full[HALVES * s + HALVES - 1]), STAGE_BYTES / HALVES,
                 j0 - 2, i0 - 2, din + stages, c0, b);
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

template <int KS>  // C = 16 * KS channels; from C = 48 the shared memory allows one block per SM
__global__ void __launch_bounds__(THREADS, KS <= 2 ? 2 : 1)
head_sm90_kernel(const __grid_constant__ CUtensorMap vmap, const float* __restrict__ kern,
                 float* __restrict__ out, int D, int h, int w) {
  head_sm90_body<__nv_bfloat16, KS>(&vmap, kern, out, D, h, w, Geom<__nv_bfloat16>::MAX_STAGES);
}

template <int KS>  // two blocks per SM up to C = 32 (registers capped at 128), as in bf16
__global__ void __launch_bounds__(THREADS, KS <= 2 ? 2 : 1)
head_sm90_f32_kernel(const __grid_constant__ CUtensorMap vmap, const float* __restrict__ kern,
                     float* __restrict__ out, int D, int h, int w, int stages) {
  head_sm90_body<float, KS>(&vmap, kern, out, D, h, w, stages);
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

// The 5-D tensor map (w, h, d, c, b) of a contiguous volume of T, one box a
// depth plane of all C channels. Returns 0 or TENSOR_MAP_ERROR + a CUresult.
template <typename T>
int encode_volume(CUtensorMap* map, const void* vol, int B, int C, int D, int h, int w) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_UNKNOWN;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[5] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)D, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[4] = {w * es, (cuuint64_t)h * w * es, (cuuint64_t)D * h * w * es,
                                 (cuuint64_t)C * D * h * w * es};
  const cuuint32_t box[5] = {Geom<T>::BW, Geom<T>::BH, 1, (cuuint32_t)(C / Geom<T>::HALVES), 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, Geom<T>::TMA_TYPE, 5, const_cast<void*>(vol), dims, strides, box, elem_strides,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

dim3 sm90_grid(int B, int h, int w) { return dim3((w + J_SHIFT + TW - 1) / TW, (h + TH - 1) / TH, B); }

template <int KS>
int launch_sm90(const CUtensorMap& map, const float* kern, float* out, int B, int D, int h, int w,
                cudaStream_t stream) {
  const size_t smem = sm90_smem_bytes(16 * KS, D);
  cudaError_t err =
      cudaFuncSetAttribute(head_sm90_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_sm90_kernel<KS><<<sm90_grid(B, h, w), THREADS, smem, stream>>>(map, kern, out, D, h, w);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_sm90_f32(const CUtensorMap& map, const float* kern, float* out, int B, int D, int h, int w,
                    cudaStream_t stream) {
  const int stages = f32_stages(16 * KS, D);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sm90_f32_smem_bytes(16 * KS, D);
  cudaError_t err =
      cudaFuncSetAttribute(head_sm90_f32_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_sm90_f32_kernel<KS><<<sm90_grid(B, h, w), THREADS, smem, stream>>>(map, kern, out, D, h, w, stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long lst_head_sm90_smem_bytes(int C, int D) { return (long long)sm90_smem_bytes(C, D); }
long long lst_head_sm90_f32_smem_bytes(int C, int D) { return (long long)sm90_f32_smem_bytes(C, D); }
int lst_head_sm90_f32_stages(int C, int D) { return f32_stages(C, D); }

// vol: (B, C, D, h, w) bf16 contiguous, 16-byte aligned, C in {16, 32, 48, 64},
// w % 8 == 0; kern: (C, 3, 3, 3) fp32 contiguous; out: (B, 3h, 3w) fp32.
// Returns a cudaError_t, or TENSOR_MAP_ERROR + the CUresult of a refused
// tensor map (TENSOR_MAP_ERROR + 999 when the encoder cannot be found).
int lst_head_sm90_soft_argmin(const void* vol, const void* kern, void* out, int B, int C, int D, int h, int w,
                              void* stream) {
  if (C % 16 != 0 || C < 16 || C > 64 || w % 8 != 0 || reinterpret_cast<uintptr_t>(vol) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int res = encode_volume<__nv_bfloat16>(&map, vol, B, C, D, h, w);
  if (res != 0) return res;
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

// The same for an fp32 volume: C in {16, 32, 48, 64}, w % 4 == 0, 16-byte
// aligned, and one stage of the ring fitting the shared memory.
int lst_head_sm90_f32_soft_argmin(const void* vol, const void* kern, void* out, int B, int C, int D, int h, int w,
                                  void* stream) {
  if (C % 16 != 0 || C < 16 || C > 64 || w % 4 != 0 || reinterpret_cast<uintptr_t>(vol) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int res = encode_volume<float>(&map, vol, B, C, D, h, w);
  if (res != 0) return res;
  const float* k = static_cast<const float*>(kern);
  float* o = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (C / 16) {
    case 1: return launch_sm90_f32<1>(map, k, o, B, D, h, w, st);
    case 2: return launch_sm90_f32<2>(map, k, o, B, D, h, w, st);
    case 3: return launch_sm90_f32<3>(map, k, o, B, D, h, w, st);
    default: return launch_sm90_f32<4>(map, k, o, B, D, h, w, st);
  }
}

}  // extern "C"
