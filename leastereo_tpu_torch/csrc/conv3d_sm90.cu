// 3x3x3 convolution of NDHWC bf16 volumes for Hopper (sm_90a), bias and
// ReLU in its epilogue, plain C API.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It serves the eval matching net (ops/convbr.py ConvBR.eval_conv), whose
// 3x3x3 convolutions (stride 1, padding 1, C_in -> C_out of 8 -> 8,
// 16 -> 16 and 32 -> 32: 73 calls of a frame's 75) cuDNN ran as Ampere
// implicit GEMMs (sm80_xmma_fprop_implicit_gemm_..._nhwckrsc_nhwc) that
// gather each input voxel again for each of the 27 taps: at 8 to 32
// channels the gather, not the arithmetic, set their time (80 of 109 device
// ms a Middlebury frame, 8% of the bf16 peak). out = relu(conv3d(x, w) + b): fp32 sums, one bf16
// rounding at the end, as cuDNN's fused epilogue.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at 8 and 16
// channels the volume's bytes (read once, written once); at 32 channels the
// multiply-adds (27 C_in C_out a voxel). The design:
//  * A block owns an output tile of TH x TW voxels of one (h, w) window and
//    walks a run of output depth planes. Input planes, each with its +-1
//    halo in h and w ((TH + 2) x (TW + 2) voxels of all C_in channels), come
//    by TMA into a ring of STAGES slots guarded by mbarriers: output plane d
//    reads planes d - 1, d, d + 1 from the ring while plane d + 2 loads, so
//    each input plane is read from device memory once per tile, plus the h/w
//    halo and the two extra planes of each run. One 5-D tensor map (c, w, h,
//    d, n) with the true extents: its out-of-bounds zero fill is the
//    convolution's zero padding in every dimension, so no code tests a bound
//    until the stores.
//  * The slots keep the volume's layout, a voxel's C_in channels in a row of
//    2 C_in bytes, under TMA's swizzle of the matching width (32, 64 bytes;
//    none at 16): the 16-byte chunk of a row is XORed with the address's bits
//    7.., so 8 consecutive voxels of one chunk lie on 8 different bank groups
//    whatever voxel they start at. Weights ([tap][C_out][C_in], the same
//    swizzle) are copied into shared memory once a block (at most 55 KB).
//  * Taps. For each of the 27 taps, P[voxel, co] += sum_ci X[voxel + tap, ci]
//    W[tap, co, ci] on tensor cores (mma.sync m16n8k16, bf16 in, fp32
//    accumulate): the A operand of an M-tile of 16 consecutive output voxels
//    is the staged plane seen at the tap's offset, read by ldmatrix straight
//    from the slot (each lane gives its own voxel's address), so there is no
//    im2col copy. At C_in = 8 one k-step of 16 joins two taps (a zero 28th
//    tap pads the last). A warp owns MT M-tiles and all of C_out, so each B
//    fragment serves MT products.
//  * Epilogue: bias and ReLU on the fp32 sums, one rounding, NDHWC bf16
//    stores of the voxels inside the frame.
//  * A run of planes per block (dchunk) is chosen at launch from the card's
//    resident-block slots, trading the two extra planes a run loads against
//    the last wave's idle slots.
// mma.sync and not wgmma: the A operand of a tap is a shifted window of the
// slot, which ldmatrix reads from any voxel, where wgmma's shared-memory
// descriptors want whole 8-row core matrices at fixed strides. What bounds
// each class here is shared memory: at C_out = 8 and 16 each A byte staged
// feeds only C_out multiply-adds, so ldmatrix, not the tensor cores, sets
// the pace (16 -> 16 reaches ~73% of the SM's 128 bytes a clock).
// Measured on the H100 (PERF.md section 6), a call at Middlebury's shapes:
// 8 -> 8 0.48 ms (bound 0.22, cuDNN 5.43), 16 -> 16 0.144 (0.055, 0.73),
// 32 -> 32 2.73 (1.29, 5.85) and 0.063 (0.020, 0.114). The tiles are those
// measured best: 16 x 32 voxels (8 x 32 and 8 x 64, and 6 ring stages, were
// no faster). Not built: 128 -> 64 (the matching net's two skips), where
// cuDNN's own Hopper kernel runs at 51% of the bf16 peak, more than an
// mma.sync kernel reaches; its 442 KB of weights would also have to stream
// through shared memory.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NTAP = 27;
constexpr int TENSOR_MAP_ERROR = 100000;  // + CUresult of a refused tensor map
constexpr int ALIGN = 1024;               // slot alignment: the 64-byte swizzle's period and more

// Tile of one instantiated class: C_in, C_out, output tile TH x TW (TW a
// multiple of 16), STAGES input planes in the ring.
template <int CIN_, int COUT_, int TH_, int TW_, int STAGES_>
struct Cfg {
  static constexpr int CIN = CIN_, COUT = COUT_, TH = TH_, TW = TW_, STAGES = STAGES_;
  static constexpr int BH = TH + 2, BW = TW + 2;             // staged rows and columns (+-1 halo)
  static constexpr int ROW = 2 * CIN;                          // bytes of a voxel
  static constexpr int BOX_BYTES = BH * BW * ROW;              // one input plane
  static constexpr int SLOT = (BOX_BYTES + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int MTILES = TH * TW / 16;                  // 16-voxel M-tiles of the output tile
  static constexpr int MT = MTILES / WARPS;                    // M-tiles of a warp
  static constexpr int NT = COUT / 8;                          // 8-channel N-tiles
  static constexpr bool PAIRS = CIN == 8;                      // two taps a k-step
  static constexpr int KC = PAIRS ? 1 : CIN / 16;              // k-steps of a tap
  static constexpr int WTAPS = PAIRS ? NTAP + 1 : NTAP;        // a zero 28th tap pads the last pair
  static constexpr int WBYTES = (WTAPS * COUT * ROW + ALIGN - 1) / ALIGN * ALIGN;
  // Swizzle: chunk bits [4, 4 + log2(ROW / 16)) XOR address bits [7, ..).
  static constexpr int SWZ = ROW / 16 - 1;
  static constexpr size_t SMEM = (size_t)STAGES * SLOT + WBYTES + STAGES * sizeof(uint64_t) + ALIGN;
  static_assert(CIN == 8 || CIN == 16 || CIN == 32, "rows of 16, 32 or 64 bytes");
  static_assert(COUT % 8 == 0 && (NT == 1 || NT % 2 == 0), "C_out: 8 or a multiple of 16");
  static_assert(TW % 16 == 0 && MTILES % WARPS == 0, "whole M-tiles in rows, the same number a warp");
  static_assert(STAGES >= 3, "three planes an output plane");
  static_assert(KC >= 1 && WTAPS >= NTAP, "whole k-steps, every tap");
};

// The instantiated classes.
using Conv8 = Cfg<8, 8, 16, 32, 4>;
using Conv16 = Cfg<16, 16, 16, 32, 4>;
using Conv32 = Cfg<32, 32, 16, 32, 4>;

template <int CIN>
constexpr CUtensorMapSwizzle tma_swizzle() {
  return CIN == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CIN == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
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

// Expect `bytes` on `bar` and start the TMA load of the box at (c, w, h, d, n) into `dst`.
__device__ __forceinline__ void load_box(const CUtensorMap* map, uint32_t dst, uint32_t bar, uint32_t bytes, int w,
                                         int h, int d, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(w), "r"(h), "r"(d), "r"(n), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` of row `row` (rows of 16 (SWZ + 1)
// bytes) under the swizzle.
template <int SWZ>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  const uint32_t off = (uint32_t)row * (16 * (SWZ + 1));
  return off + (uint32_t)((chunk ^ (int)((off >> 7) & SWZ)) << 4);
}

template <class C>
__global__ void __launch_bounds__(THREADS)
conv3d_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ wgt,
                   const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int D, int H, int W,
                   int dchunk, int nchunks) {
  constexpr int S = C::STAGES, CIN = C::CIN, COUT = C::COUT, MT = C::MT, NT = C::NT, BW = C::BW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t wsm = base + S * C::SLOT;                                  // [WTAPS][COUT] rows of CIN
  uint64_t* full = reinterpret_cast<uint64_t*>(sbase + S * C::SLOT + C::WBYTES);  // [S]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z / nchunks, d0 = blockIdx.z % nchunks * dchunk;
  const int nout = min(D - d0, dchunk), nin = nout + 2;  // input planes d0 - 1 .. d0 + nout
  const int h0 = blockIdx.y * C::TH, w0 = blockIdx.x * C::TW;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < S && i < nin; ++i)
      load_box(&xmap, base + i * C::SLOT, smem_u32(&full[i]), C::BOX_BYTES, w0 - 1, h0 - 1, d0 - 1 + i, n);
  }
  // Weights: global [COUT][27][CIN] (channels_last_3d) -> shared [tap][COUT]
  // rows of CIN, swizzled; the padding tap of the pairs is zero.
  constexpr int CH = CIN / 8;  // 16-byte chunks of a row
  for (int q = tid; q < COUT * NTAP * CH; q += THREADS) {
    const int co = q / (NTAP * CH), tap = q / CH % NTAP, c = q % CH;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(wgt) + q);
    *reinterpret_cast<uint4*>(sbase + S * C::SLOT + swz<C::SWZ>(tap * COUT + co, c)) = v;
  }
  if (C::PAIRS)
    for (int q = tid; q < COUT; q += THREADS)
      *reinterpret_cast<uint4*>(sbase + S * C::SLOT + swz<C::SWZ>(NTAP * COUT + q, 0)) = make_uint4(0, 0, 0, 0);
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int k = 0; k < 2; ++k) bv[nt][k] = __bfloat162float(bias[nt * 8 + 2 * (lane & 3) + k]);
  __syncthreads();

  // ldmatrix lane roles: matrix mi = lane / 8, its row lane % 8.
  const int mi = lane >> 3, r8 = lane & 7;
  // A: this lane's voxel (row of the M-tile r8 + 8 (mi & 1)) at tap (0, 0, 0), as a slot row.
  int vbox[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int t = warp * MT + mt, tr = t / (C::TW / 16), tc = t % (C::TW / 16) * 16;
    vbox[mt] = tr * BW + tc + r8 + 8 * (mi & 1);
  }
  const int akhi = mi >> 1;  // A: k 8..15 (matrices 2, 3): the tap's next chunk, or the pair's second tap
  // B: output channel row n = 16 np + r8 + 8 (mi >> 1), k chunk mi & 1 (NT = 1: x2, lanes 0..15).
  const int bn = r8 + 8 * (mi >> 1), bkhi = mi & 1;

  auto wait_plane = [&](int i) { mbar_wait(smem_u32(&full[i % S]), (uint32_t)((i / S) & 1)); };
  wait_plane(0);
  if (nin > 1) wait_plane(1);
  for (int j = 0; j < nout; ++j) {
    wait_plane(j + 2);
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
    uint32_t slot[3];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) slot[kd] = base + ((j + kd) % S) * C::SLOT;

    if constexpr (C::PAIRS) {
      // k-step p joins taps 2p (k 0..7) and 2p + 1 (k 8..15); tap 27 is zero.
#pragma unroll
      for (int p = 0; p < (NTAP + 1) / 2; ++p) {
        const int t0 = 2 * p, t1 = 2 * p + 1 < NTAP ? 2 * p + 1 : NTAP - 1;
        const uint32_t sl = akhi ? slot[t1 / 9] : slot[t0 / 9];
        const int shift = akhi ? t1 % 9 / 3 * BW + t1 % 3 : t0 % 9 / 3 * BW + t0 % 3;
        uint32_t b[NT][2];
#pragma unroll
        for (int np = 0; np < (NT + 1) / 2; ++np) {
          const uint32_t addr = wsm + swz<C::SWZ>((t0 + bkhi) * COUT + 16 * np + bn, 0);
          if constexpr (NT == 1) {
            ldmatrix_x2(b[0], addr);
          } else {
            uint32_t r[4];
            ldmatrix_x4(r, addr);
            b[2 * np][0] = r[0], b[2 * np][1] = r[1], b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, sl + swz<C::SWZ>(vbox[mt] + shift, 0));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    } else {
#pragma unroll
      for (int tap = 0; tap < NTAP; ++tap) {
        const uint32_t sl = slot[tap / 9];
        const int shift = tap % 9 / 3 * BW + tap % 3;
#pragma unroll
        for (int kc = 0; kc < C::KC; ++kc) {
          uint32_t b[NT][2];
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4(r, wsm + swz<C::SWZ>(tap * COUT + 16 * np + bn, 2 * kc + bkhi));
            b[2 * np][0] = r[0], b[2 * np][1] = r[1], b[2 * np + 1][0] = r[2], b[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, sl + swz<C::SWZ>(vbox[mt] + shift, 2 * kc + akhi));
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
    }
    __syncthreads();  // every read of plane j's slot is done: load plane j + S into it
    if (tid == 0 && j + S < nin) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_box(&xmap, base + (j % S) * C::SLOT, smem_u32(&full[j % S]), C::BOX_BYTES, w0 - 1, h0 - 1, d0 + j + S - 1,
               n);
    }
    // Epilogue: accumulator rows are voxels lane / 4 (+ 8), columns 2 (lane % 4) + {0, 1}.
    const size_t plane = ((size_t)n * D + d0 + j) * H;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int t = warp * MT + mt;
      const int h = h0 + t / (C::TW / 16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w0 + t % (C::TW / 16) * 16 + (lane >> 2) + 8 * half;
        if (h < H && w < W) {
          __nv_bfloat16* o = out + ((plane + h) * W + w) * COUT + 2 * (lane & 3);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float v0 = fmaxf(acc[mt][nt][2 * half] + bv[nt][0], 0.0f);
            const float v1 = fmaxf(acc[mt][nt][2 * half + 1] + bv[nt][1], 0.0f);
            *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
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

// Output planes a block walks: of the counts that fill the card's resident
// slots in the fewest waves, weighted by a block's planes plus one for its
// start (the first three planes and the weights, not overlapped), the least.
int plane_run(int D, long long tiles, long long slots) {
  int best = D;
  long long best_cost = -1;
  for (int runs = 1; runs <= D; ++runs) {
    const int run = (D + runs - 1) / runs;
    if (runs > 1 && (D + run - 1) / run != runs) continue;  // the same run as a smaller count
    const long long waves = (tiles * runs + slots - 1) / slots;
    const long long cost = waves * (run + 1);
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best = run;
  }
  return best;
}

template <class C>
int launch(const void* x, const void* w, const void* b, void* out, int N, int D, int H, int W, cudaStream_t st) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_UNKNOWN;
  CUtensorMap map;
  const cuuint64_t row = C::ROW;
  const cuuint64_t dims[5] = {(cuuint64_t)C::CIN, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {(cuuint32_t)C::CIN, (cuuint32_t)C::BW, (cuuint32_t)C::BH, 1, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle<C::CIN>(),
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return TENSOR_MAP_ERROR + (int)res;
  // The shared-memory attribute and the resident slots, once a device.
  static int set_dev = -1, slots = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != set_dev) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(conv3d_sm90_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3d_sm90_kernel<C>, THREADS, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    set_dev = dev, slots = per_sm * sms;
  }
  const int tw = (W + C::TW - 1) / C::TW, th = (H + C::TH - 1) / C::TH;
  const int run = plane_run(D, (long long)tw * th * N, slots);
  const int runs = (D + run - 1) / run;
  const dim3 grid(tw, th, N * runs);
  conv3d_sm90_kernel<C><<<grid, THREADS, C::SMEM, st>>>(map, static_cast<const __nv_bfloat16*>(w),
                                                         static_cast<const __nv_bfloat16*>(b),
                                                         static_cast<__nv_bfloat16*>(out), D, H, W, run, runs);
  return (int)cudaGetLastError();
}

template <class C>
void geometry(int* g) {
  g[0] = C::TH, g[1] = C::TW, g[2] = C::STAGES;
}

}  // namespace

extern "C" {

// Tile of the class (cin, cout): {TH, TW, STAGES}; returns 0, or -1 when
// the class is not instantiated.
int lst_conv3d_sm90_geometry(int cin, int cout, int* g) {
  if (cin == 8 && cout == 8) return geometry<Conv8>(g), 0;
  if (cin == 16 && cout == 16) return geometry<Conv16>(g), 0;
  if (cin == 32 && cout == 32) return geometry<Conv32>(g), 0;
  return -1;
}

// x: (N, D, H, W, cin) bf16, 16-byte aligned; w: (cout, 3, 3, 3, cin) bf16
// contiguous; b: (cout,) bf16; out: (N, D, H, W, cout) bf16. Returns a
// cudaError_t (cudaErrorInvalidValue for a class not instantiated), or
// TENSOR_MAP_ERROR + the CUresult of a refused tensor map.
int lst_conv3d_sm90(const void* x, const void* w, const void* b, void* out, int N, int cin, int cout, int D, int H,
                    int W, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || N < 1 || D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cin == 8 && cout == 8) return launch<Conv8>(x, w, b, out, N, D, H, W, st);
  if (cin == 16 && cout == 16) return launch<Conv16>(x, w, b, out, N, D, H, W, st);
  if (cin == 32 && cout == 32) return launch<Conv32>(x, w, b, out, N, D, H, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
