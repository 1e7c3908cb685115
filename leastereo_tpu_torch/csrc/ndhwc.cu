// Kernels of the eval matching net's NDHWC volumes for Hopper (sm_90a), plain C API.
//
// None replaces a TPU kernel: the JAX package leaves the stem's assembly,
// the concatenations and the resizes to XLA. They serve the eval matching net, whose volumes
// are NDHWC (channels_last_3d) so that cuDNN convolves them in place, and
// do there what PyTorch's own kernels do slowly on that layout.
//
// lst_stem_ndhwc assembles the fused stem's output (ops/fused_stem.py) from
// its tables of 2-D maps: at each voxel (d, h, w) one F-channel row of the
// left table (by plane type, diagonal class j = w - d, h, w) plus one of the
// right table (by plane type, h, j), less the right-edge fix at w = W - 1,
// plus the bias, then the ReLU, rounding to the volume's type after each
// step as the PyTorch ops it replaces do (index_select, +=, -=, +=, relu_),
// so the two agree bit for bit. PyTorch's index_select of F-channel rows
// runs one block a row: 23 M blocks of 64 bytes at Middlebury, 14 ms.
//
// lst_cat_ndhwc joins NDHWC volumes along their channels (the cells'
// concatenations and the long skips): each output row of C channels is the
// inputs' rows side by side. PyTorch's cat copies each input apart, so each
// input writes a part of every 32-byte sector of the output (16 bytes at
// 8 channels); here neighbouring threads write neighbouring 16-byte words of
// whole rows.
//
// lst_resize_ndhwc is the trilinear resize (align_corners=True).
// PyTorch's upsample_trilinear3d kernel gives each thread one output voxel
// and loops over its channels, so on an NDHWC volume neighbouring threads
// touch addresses C elements apart, in loads and stores alike. Here a
// thread computes VEC channels (16 bytes) of one output voxel from the eight
// source rows of 16 bytes around it, with PyTorch's arithmetic: the source
// coordinate scale * dst in the accumulation type (float; double for
// double), its integer part, the weights lambda1 = coordinate - index and
// lambda0 = 1 - lambda1, the same nesting of products and sums, one rounding
// to the volume's type. With an NCDHW output (the matching net's last
// resize, whose output the fused head reads NCDHW) a thread computes all C
// channels of one voxel, VEC at a time, and neighbouring threads hold
// neighbouring voxels of a row: the loads stay 16-byte words, and each
// channel's stores from a warp are one run of 32 elements, so the layout
// change costs no pass of its own.
//
// All three: neighbouring threads hold neighbouring channel vectors, then
// neighbouring voxels, so every load and store is a whole 16-byte word of a
// run that neighbouring threads continue (VEC = 1, one element a thread,
// where the channels do not fill 16-byte words or a base is not aligned).
// What bounds them on the H100 is bytes: each output byte is written once
// and each input byte is needed about once (the taps of neighbouring
// outputs overlap and come from L2), so the least time is (input + output
// bytes) / 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T> __device__ __forceinline__ T narrow(typename Acc<T>::type v);
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ __half narrow<__half>(float v) { return __float2half(v); }
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ double narrow<double>(double v) { return v; }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

constexpr int THREADS = 256;

// The stem's plane types: which depth taps lie inside [0, D) at plane d
// depends only on whether d is the first plane, the last, or both.
__device__ __forceinline__ int plane_category(int d, int nd) { return (d == 0) + 2 * (d == nd - 1); }

// ltab: (B, types, 6, H, W, F), rtab: (B, types, H, W + nd - 1, F), fix:
// (B, P, H, F), bias: (F,) or null; y: (B, P, H, W, F); all contiguous in
// that order. Planes lo .. lo + P - 1 of nd; t0 .. t3: the table type of
// each plane category. Thread i writes y's elements [i * VEC, (i + 1) * VEC).
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
stem_ndhwc_kernel(const T* __restrict__ ltab, const T* __restrict__ rtab, const T* __restrict__ fix,
                  const T* __restrict__ bias, T* __restrict__ y, int F, int P, int H, int W, int lo, int nd,
                  int types, int t0, int t1, int t2, int t3, int relu, long long total) {
  using A = typename Acc<T>::type;
  using V = Vec<T, VEC>;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int cv = F / VEC;
  const int c = (int)(i % cv) * VEC;
  long long v = i / cv;
  const int w = (int)(v % W);
  v /= W;
  const int h = (int)(v % H);
  v /= H;
  const int p = (int)(v % P);
  const long long b = v / P;
  const int d = lo + p;
  const int cat = plane_category(d, nd);
  const int pt = cat == 0 ? t0 : cat == 1 ? t1 : cat == 2 ? t2 : t3;
  const int cls = min(max(w - d + 3, 0), 5);
  const int wg = W + nd - 1;
  const long long li = ((b * types + pt) * 6 + cls) * H * W + (long long)h * W + w;
  const long long ri = (b * types + pt) * H * wg + (long long)h * wg + (w - d + nd - 1);
  const V a = *reinterpret_cast<const V*>(ltab + li * F + c);
  const V r = *reinterpret_cast<const V*>(rtab + ri * F + c);
  V out;
  if (w == W - 1) {
    const V fx = *reinterpret_cast<const V*>(fix + (((b * P + p) * H + h) * F + c));
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = narrow<T>(widen(narrow<T>(widen(a.v[k]) + widen(r.v[k]))) - widen(fx.v[k]));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = narrow<T>(widen(a.v[k]) + widen(r.v[k]));
  }
  if (bias != nullptr) {
    const V bv = *reinterpret_cast<const V*>(bias + c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = narrow<T>(widen(out.v[k]) + widen(bv.v[k]));
  }
  if (relu) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = widen(out.v[k]) < static_cast<A>(0) ? narrow<T>(0) : out.v[k];
  }
  *reinterpret_cast<V*>(y + i * VEC) = out;
}

constexpr int CAT_MAX = 8;  // inputs of one lst_cat_ndhwc

struct CatInputs {
  const void* x[CAT_MAX];  // (voxels, c[k]) rows, contiguous
  int c[CAT_MAX];
  int off[CAT_MAX];  // the first channel of input k in the output
  int n;
};

// y: (voxels, C) rows, C the sum of in.c; thread i writes y's elements
// [i * VEC, (i + 1) * VEC), which lie in one input (every c[k] a multiple
// of VEC). The input is chosen by an unrolled scan, so every field of
// `in` is read at a constant index from the parameter bank.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
cat_ndhwc_kernel(const CatInputs in, T* __restrict__ y, int C, long long total) {
  using V = Vec<T, VEC>;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int cv = C / VEC;
  const int c = (int)(i % cv) * VEC;
  const long long voxel = i / cv;
  const void* x = in.x[0];
  int ck = in.c[0], off = 0;
#pragma unroll
  for (int k = 1; k < CAT_MAX; ++k) {
    if (k < in.n && c >= in.off[k]) {
      x = in.x[k];
      ck = in.c[k];
      off = in.off[k];
    }
  }
  const T* src = static_cast<const T*>(x) + voxel * ck + (c - off);
  *reinterpret_cast<V*>(y + i * VEC) = *reinterpret_cast<const V*>(src);
}

// x: (B, D1, H1, W1, C) contiguous in that order. NCDHW false: y is
// (B, D2, H2, W2, C), and thread i writes its elements [i * VEC, (i + 1) *
// VEC); true: y is (B, C, D2, H2, W2), and thread i writes voxel i's C
// channels.
template <typename T, int VEC, bool NCDHW>
__global__ void __launch_bounds__(THREADS)
resize_ndhwc_kernel(const T* __restrict__ x, T* __restrict__ y, int C, int D1, int H1, int W1, int D2, int H2,
                    int W2, typename Acc<T>::type rd, typename Acc<T>::type rh, typename Acc<T>::type rw,
                    long long total) {
  using A = typename Acc<T>::type;
  using V = Vec<T, VEC>;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int cv = NCDHW ? 1 : C / VEC;
  const int c0 = NCDHW ? 0 : (int)(i % cv) * VEC;
  const int c1 = NCDHW ? C : c0 + VEC;
  long long v = i / cv;
  const int w2 = (int)(v % W2);
  v /= W2;
  const int h2 = (int)(v % H2);
  v /= H2;
  const int t2 = (int)(v % D2);
  const long long b = v / D2;

  // PyTorch's area_pixel_compute_source_index (align_corners) and weights.
  const A t1r = rd * t2;
  const int t1 = (int)t1r;
  const int t1p = (t1 < D1 - 1) ? 1 : 0;
  const A t1l = t1r - t1;
  const A t0l = static_cast<A>(1) - t1l;
  const A h1r = rh * h2;
  const int h1 = (int)h1r;
  const int h1p = (h1 < H1 - 1) ? 1 : 0;
  const A h1l = h1r - h1;
  const A h0l = static_cast<A>(1) - h1l;
  const A w1r = rw * w2;
  const int w1 = (int)w1r;
  const int w1p = (w1 < W1 - 1) ? 1 : 0;
  const A w1l = w1r - w1;
  const A w0l = static_cast<A>(1) - w1l;

  const long long sh = (long long)W1 * C, st = (long long)H1 * sh;
  const T* p = x + ((b * D1 + t1) * st + h1 * sh + (long long)w1 * C);
  const long long ow = (long long)w1p * C, oh = h1p * sh, ot = t1p * st;
  const long long plane = (long long)D2 * H2 * W2;  // NCDHW: one channel's elements
  T* q = NCDHW ? y + (b * C * D2 + t2) * (long long)H2 * W2 + (long long)h2 * W2 + w2 : y + i * VEC;
  for (int c = c0; c < c1; c += VEC) {
    const V a000 = *reinterpret_cast<const V*>(p + c);
    const V a001 = *reinterpret_cast<const V*>(p + c + ow);
    const V a010 = *reinterpret_cast<const V*>(p + c + oh);
    const V a011 = *reinterpret_cast<const V*>(p + c + oh + ow);
    const V a100 = *reinterpret_cast<const V*>(p + c + ot);
    const V a101 = *reinterpret_cast<const V*>(p + c + ot + ow);
    const V a110 = *reinterpret_cast<const V*>(p + c + ot + oh);
    const V a111 = *reinterpret_cast<const V*>(p + c + ot + oh + ow);
    V out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const A val = t0l * (h0l * (w0l * widen(a000.v[k]) + w1l * widen(a001.v[k])) +
                           h1l * (w0l * widen(a010.v[k]) + w1l * widen(a011.v[k]))) +
                    t1l * (h0l * (w0l * widen(a100.v[k]) + w1l * widen(a101.v[k])) +
                           h1l * (w0l * widen(a110.v[k]) + w1l * widen(a111.v[k])));
      out.v[k] = narrow<T>(val);
    }
    if (NCDHW) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) q[(c + k) * plane] = out.v[k];
    } else {
      *reinterpret_cast<V*>(q) = out;
    }
  }
}

template <typename T, int VEC, bool NCDHW>
int launch(const void* x, void* y, int B, int C, int D1, int H1, int W1, int D2, int H2, int W2, double rd, double rh,
           double rw, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const long long total = (long long)B * D2 * H2 * W2 * (NCDHW ? 1 : C / VEC);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (total == 0) return 0;
  resize_ndhwc_kernel<T, VEC, NCDHW><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), C, D1, H1, W1, D2, H2, W2, static_cast<A>(rd),
      static_cast<A>(rh), static_cast<A>(rw), total);
  return (int)cudaGetLastError();
}

template <typename T, bool NCDHW>
int dispatch_vec(int vec, const void* x, void* y, int B, int C, int D1, int H1, int W1, int D2, int H2, int W2,
                 double rd, double rh, double rw, cudaStream_t stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE) return launch<T, WIDE, NCDHW>(x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, stream);
  if (vec == 1) return launch<T, 1, NCDHW>(x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int vec, int ncdhw, const void* x, void* y, int B, int C, int D1, int H1, int W1, int D2, int H2,
             int W2, double rd, double rh, double rw, cudaStream_t stream) {
  return ncdhw ? dispatch_vec<T, true>(vec, x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, stream)
               : dispatch_vec<T, false>(vec, x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, stream);
}

template <typename T, int VEC>
int launch_stem(const void* ltab, const void* rtab, const void* fix, const void* bias, void* y, int B, int F, int P,
                int H, int W, int lo, int nd, int types, const int* tmap, int relu, cudaStream_t stream) {
  const long long total = (long long)B * P * H * W * (F / VEC);
  if (total == 0) return 0;
  stem_ndhwc_kernel<T, VEC><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      static_cast<const T*>(ltab), static_cast<const T*>(rtab), static_cast<const T*>(fix),
      static_cast<const T*>(bias), static_cast<T*>(y), F, P, H, W, lo, nd, types, tmap[0], tmap[1], tmap[2], tmap[3],
      relu, total);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_stem(int vec, const void* ltab, const void* rtab, const void* fix, const void* bias, void* y, int B, int F,
                  int P, int H, int W, int lo, int nd, int types, const int* tmap, int relu, cudaStream_t stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE) return launch_stem<T, WIDE>(ltab, rtab, fix, bias, y, B, F, P, H, W, lo, nd, types, tmap, relu, stream);
  if (vec == 1) return launch_stem<T, 1>(ltab, rtab, fix, bias, y, B, F, P, H, W, lo, nd, types, tmap, relu, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_cat(int vec, const CatInputs& in, void* y, long long voxels, int C, cudaStream_t stream) {
  constexpr int WIDE = 16 / sizeof(T);
  const long long total = voxels * (C / vec);
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (vec == WIDE) {
    cat_ndhwc_kernel<T, WIDE><<<blocks, THREADS, 0, stream>>>(in, static_cast<T*>(y), C, total);
  } else if (vec == 1) {
    cat_ndhwc_kernel<T, 1><<<blocks, THREADS, 0, stream>>>(in, static_cast<T*>(y), C, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (voxels, sum of c) = the n <= 8 inputs x[k] (voxels, c[k]) side by side,
// all contiguous rows of one type (dtype as lst_resize_ndhwc's). vec:
// 16 / element size (every c[k] a multiple of it, every base 16-byte
// aligned) or 1. Returns a cudaError_t.
int lst_cat_ndhwc(const void* const* x, const int* c, int n, void* y, int dtype, int vec, long long voxels,
                  void* stream) {
  if (n < 1 || n > CAT_MAX) return (int)cudaErrorInvalidValue;
  CatInputs in{};
  int C = 0;
  for (int k = 0; k < n; ++k) {
    in.x[k] = x[k];
    in.c[k] = c[k];
    in.off[k] = C;
    C += c[k];
  }
  in.n = n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_cat<__nv_bfloat16>(vec, in, y, voxels, C, s);
    case 1: return launch_cat<__half>(vec, in, y, voxels, C, s);
    case 2: return launch_cat<float>(vec, in, y, voxels, C, s);
    case 3: return launch_cat<double>(vec, in, y, voxels, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fused stem's NDHWC output y (B, P, H, W, F) from its tables ltab
// (B, types, 6, H, W, F) and rtab (B, types, H, W + nd - 1, F), the
// right-edge fix (B, P, H, F) and the bias (F,) or null, all contiguous
// and of one type (dtype as lst_resize_ndhwc's); planes lo .. lo + P - 1 of
// nd; t0 .. t3: the table type of a plane that is neither end, the first,
// the last, both; relu: apply the ReLU. vec: 16 / element size (F a
// multiple of it, every base 16-byte aligned) or 1. Returns a cudaError_t.
int lst_stem_ndhwc(const void* ltab, const void* rtab, const void* fix, const void* bias, void* y, int dtype, int vec,
                   int B, int F, int P, int H, int W, int lo, int nd, int types, int t0, int t1, int t2, int t3,
                   int relu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tmap[4] = {t0, t1, t2, t3};
  switch (dtype) {
    case 0: return dispatch_stem<__nv_bfloat16>(vec, ltab, rtab, fix, bias, y, B, F, P, H, W, lo, nd, types, tmap, relu, s);
    case 1: return dispatch_stem<__half>(vec, ltab, rtab, fix, bias, y, B, F, P, H, W, lo, nd, types, tmap, relu, s);
    case 2: return dispatch_stem<float>(vec, ltab, rtab, fix, bias, y, B, F, P, H, W, lo, nd, types, tmap, relu, s);
    case 3: return dispatch_stem<double>(vec, ltab, rtab, fix, bias, y, B, F, P, H, W, lo, nd, types, tmap, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// x: an NDHWC volume (B, D1, H1, W1, C) contiguous in that order; y its
// output, (B, D2, H2, W2, C) (ncdhw 0) or (B, C, D2, H2, W2) (ncdhw 1),
// contiguous. dtype: 0 bf16, 1 fp16, 2 fp32, 3 fp64; vec: 16 / element size
// (C a multiple of it, x 16-byte aligned, and y too when NDHWC) or 1.
// rd, rh, rw: the scales (in - 1) / (out - 1) (0 for an output of one),
// exact in the accumulation type. Returns a cudaError_t.
int lst_resize_ndhwc(const void* x, void* y, int dtype, int vec, int ncdhw, int B, int C, int D1, int H1, int W1,
                     int D2, int H2, int W2, double rd, double rh, double rw, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<__nv_bfloat16>(vec, ncdhw, x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, s);
    case 1: return dispatch<__half>(vec, ncdhw, x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, s);
    case 2: return dispatch<float>(vec, ncdhw, x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, s);
    case 3: return dispatch<double>(vec, ncdhw, x, y, B, C, D1, H1, W1, D2, H2, W2, rd, rh, rw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
