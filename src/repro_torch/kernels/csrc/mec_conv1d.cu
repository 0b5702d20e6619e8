// Causal depthwise conv1d for NVIDIA Hopper (sm_90a), CUDA C++.
//
//   mec_conv1d <- src/repro/kernels/mec_conv1d.py
//                 mec_conv1d_pallas / _conv1d_kernel            (K5)
//
//   out[n, s, c] = sum_{j=0}^{k_w-1} x[n, s - (k_w-1) + j, c] * k[j, c],
//   x read as zero before step 0.  x is (n, t, c) with any batch and time
//   stride and channel stride 1 (the Mamba2 block passes a column slice of
//   its in_proj output, so the model path needs no copy); k is (k_w, c)
//   and out (n, t, c) contiguous, all three of one dtype: f32, bf16 or f16.
//   The sum runs in IEEE f32 over j = 0 .. k_w-1 in that order, each
//   product and each add rounded on its own (__fmul_rn / __fadd_rn, so
//   nvcc fuses nothing into an FMA), and the output is written once, in
//   x's dtype.  That is the arithmetic of the plain version
//   (core/mec.py mec_conv1d_shift), which this kernel matches to the bit.
//
// What bounds it on the card: bytes.  It reads x and k once and writes out
// once, k_w multiply-adds per output element: at the Mamba2 widths
// (c = 7296, k_w = 4, bf16) that is 4 FLOPs for 4 bytes, far below the
// ~300 operations per byte where the H100 stops being bound by its
// 3.35 TB/s; 59.8 MB a call at the zamba2-7b prefill (4 x 512 steps), 17.9
// us.  So the design streams: every byte read from device memory once, in
// wide accesses, with many loads in flight to cover the memory's latency.
//   - 16-byte vectors along channels.  A thread owns one vector of V
//     channels, VB bytes: 16 (8 bf16/f16 or 4 f32), 8, 4, or one element.
//     It loads and stores whole vectors, so a warp moves 32 * VB contiguous
//     bytes of a time step (512 B at 16 B).  VB is a template argument; the
//     wrapper picks the widest that the input's address and strides, c and
//     the kernel's and output's addresses allow (kernels/mec_conv1d.py
//     vector_bytes): a launch configuration of the same kernel.  The
//     output's rows lie c apart, so VB always divides c's bytes: every
//     vector is whole and no thread reads past a row.
//   - A tile of loads in flight.  A thread owns kTimeTile = 16 time steps
//     of its vector and first issues the loads of the k_w - 1 history
//     steps before the tile and its 16 steps, 19 independent 16-byte
//     copies at k_w = 4, then computes and stores.  The copies go to shared
//     memory with cp.async, so the bytes in flight cost no registers (84
//     registers and 38 KB a CTA: five CTAs, 640 threads, an SM); each
//     thread reads back only the vectors it staged, so its own wait is the
//     only sync.  Threads are numbered vector-fastest over (batch row, time
//     tile, vector), with 32-bit divisions, so a CTA's 128 threads take 128
//     neighbouring vectors and no lane idles at the channel edge: 912 CTAs
//     at the zamba2 shape, about 7 an SM.  The history steps are the
//     previous tile's, read again from L2: (k_w - 1)/16 of the input's
//     bytes there, none from device memory.  What is left above the
//     streaming itself is the arithmetic, two IEEE operations a tap that
//     the bit-equal contract keeps apart: without it the same loads and
//     stores take 93% of K5's time, about a device-to-device copy's
//     (tools/conv1d_probe.py).
//   - The causal halo: the TPU kernel fetched the previous time block
//     through a second BlockSpec view and took its last k_w - 1 rows (for
//     k_w = 1 that slice is the whole block: fault F2).  Here a thread
//     simply reads the k_w - 1 steps before its tile, as zeros before step
//     0; there is no second view, and k_w = 1 reads no history at all.
//   - Offsets are 64-bit: the long_500k shape (1, 524288, 7296) holds
//     3.8e9 elements, past 2^31.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;   // vectors per CTA
constexpr int kTimeTile = 16;   // time steps per thread
constexpr int kMaxKw = 8;       // largest kernel width instantiated

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// An element's bits: float for f32, uint16_t for bf16/f16.
template <typename T> struct Bits { using type = uint16_t; };
template <> struct Bits<float> { using type = float; };

template <typename T> __device__ __forceinline__ float to_f32(typename Bits<T>::type b);
template <> __device__ __forceinline__ float to_f32<float>(float b) { return b; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(uint16_t b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
template <> __device__ __forceinline__ float to_f32<__half>(uint16_t b) {
  return __half2float(__ushort_as_half(b));
}

template <typename T> __device__ __forceinline__ typename Bits<T>::type from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ uint16_t from_f32<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ uint16_t from_f32<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// One vector of VB bytes: moved as one load or store, read as elements.
template <int VB> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

template <typename T, int VB>
union Vec {
  typename Raw<VB>::type raw;
  typename Bits<T>::type e[VB / sizeof(T)];
};

// Copy one vector of VB bytes from global src to shared dst, or zeros
// where !valid (src is then not read): cp.async for 16, 8 and 4 bytes, a
// plain copy for one 2-byte element.
template <int VB>
__device__ __forceinline__ void stage(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (VB == 8 || VB == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(VB), "r"(valid ? VB : 0)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : 0;
  }
}

// Thread g takes vector g % nvec of time tile (g / nvec) % tiles of batch
// row g / (nvec * tiles); 32-bit divisions where the count allows.
__device__ __forceinline__ void thread_place(int64_t g, int64_t nvec, int64_t tiles,
                                             int64_t total, int64_t* vec, int64_t* tile,
                                             int64_t* row) {
  if (total <= 0xffffffffLL) {
    const uint32_t g32 = (uint32_t)g, rest = g32 / (uint32_t)nvec;
    *vec = g32 - rest * (uint32_t)nvec;
    *row = rest / (uint32_t)tiles;
    *tile = rest - (uint32_t)*row * (uint32_t)tiles;
  } else {
    const int64_t rest = g / nvec;
    *vec = g - rest * nvec;
    *row = rest / tiles;
    *tile = rest - *row * tiles;
  }
}

// grid = ceil(n * time tiles * vectors / kThreads), one thread a (batch
// row, time tile, vector), vector fastest.
template <typename T, int KW, int VB>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ ker, T* __restrict__ out,
              int64_t t, int64_t c, int64_t stride_n, int64_t stride_t, int64_t nvec,
              int64_t tiles, int64_t total) {
  constexpr int V = VB / (int)sizeof(T);
  constexpr int kSteps = KW - 1 + kTimeTile;
  using R = typename Raw<VB>::type;
  // the tile's input, step-major: a thread's vector of step i at
  // [i][threadIdx.x], so a warp's 32 vectors of a step are contiguous
  __shared__ __align__(16) R tile_in[kSteps][kThreads];
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  int64_t v, tile, n;
  thread_place(g, nvec, tiles, total, &v, &tile, &n);
  const int64_t ch = v * V;
  const int64_t t0 = tile * kTimeTile;
  const T* xr = x + n * stride_n + ch;
  T* outr = out + n * t * c + ch;

  // Every load of the tile first, all in flight together: step t0 -
  // (KW-1) + i into tile_in[i], zeros outside 0 .. t-1.  A thread reads
  // back only what it staged, so its own wait is the only sync.
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int64_t s = t0 - (KW - 1) + i;
    const bool valid = s >= 0 && s < t;
    stage<VB>(&tile_in[i][threadIdx.x], valid ? xr + s * stride_t : xr, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  Vec<T, VB> w[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) w[j].raw = *reinterpret_cast<const R*>(ker + j * c + ch);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < kTimeTile; ++i) {
    const int64_t s = t0 + i;
    if (s >= t) break;
    Vec<T, VB> win[KW], o;
#pragma unroll
    for (int j = 0; j < KW; ++j) win[j].raw = tile_in[i + j][threadIdx.x];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < KW; ++j)
        acc = __fadd_rn(acc, __fmul_rn(to_f32<T>(win[j].e[e]), to_f32<T>(w[j].e[e])));
      o.e[e] = from_f32<T>(acc);
    }
    *reinterpret_cast<R*>(outr + s * c) = o.raw;
  }
}

template <typename T, int KW, int VB>
cudaError_t launch_kw(const void* x, const void* ker, void* out, long long n, long long t,
                      long long c, long long stride_n, long long stride_t,
                      cudaStream_t stream) {
  const long long nvec = c / (VB / (int)sizeof(T));
  const long long tiles = (t + kTimeTile - 1) / kTimeTile;
  const long long total = n * tiles * nvec;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv1d_kernel<T, KW, VB><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ker), static_cast<T*>(out), t, c,
      stride_n, stride_t, nvec, tiles, total);
  return cudaGetLastError();
}

template <typename T, int VB>
cudaError_t launch_vb(const void* x, const void* ker, void* out, long long n, long long t,
                      long long c, long long k_w, long long stride_n, long long stride_t,
                      cudaStream_t stream) {
#define MEC_CONV1D_KW(KW) \
  case KW: return launch_kw<T, KW, VB>(x, ker, out, n, t, c, stride_n, stride_t, stream)
  switch (k_w) {
    MEC_CONV1D_KW(1);
    MEC_CONV1D_KW(2);
    MEC_CONV1D_KW(3);
    MEC_CONV1D_KW(4);
    MEC_CONV1D_KW(5);
    MEC_CONV1D_KW(6);
    MEC_CONV1D_KW(7);
    MEC_CONV1D_KW(8);
    default: return cudaErrorInvalidValue;
  }
#undef MEC_CONV1D_KW
}

template <typename T>
cudaError_t launch(const void* x, const void* ker, void* out, long long n, long long t,
                   long long c, long long k_w, long long stride_n, long long stride_t,
                   long long vec_bytes, cudaStream_t stream) {
  // vec_bytes must divide every address and row the vectors meet
  const long long es = sizeof(T);
  for (long long v : {(long long)reinterpret_cast<uintptr_t>(x),
                      (long long)reinterpret_cast<uintptr_t>(ker),
                      (long long)reinterpret_cast<uintptr_t>(out), stride_n * es,
                      stride_t * es, c * es})
    if (v % vec_bytes != 0) return cudaErrorInvalidValue;
  switch (vec_bytes) {
    case 16: return launch_vb<T, 16>(x, ker, out, n, t, c, k_w, stride_n, stride_t, stream);
    case 8: return launch_vb<T, 8>(x, ker, out, n, t, c, k_w, stride_n, stride_t, stream);
    case 4: return launch_vb<T, 4>(x, ker, out, n, t, c, k_w, stride_n, stride_t, stream);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_vb<T, 2>(x, ker, out, n, t, c, k_w, stride_n, stride_t, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes.  Pointers and the stream are void*, every
// size and stride (in elements) a long long; vec_bytes is the vector width
// (16, 8 or 4 bytes, or one element).  Returns the cudaError_t of the
// launch.
// ---------------------------------------------------------------------------
extern "C" {

const char* mec_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mec_conv1d_max_kw() { return kMaxKw; }

int mec_conv1d(const void* x, const void* ker, void* out, int dtype, long long n,
               long long t, long long c, long long k_w, long long stride_n,
               long long stride_t, long long vec_bytes, void* stream) {
  if (n < 1 || t < 1 || c < 1 || k_w < 1 || k_w > kMaxKw || stride_n < 0 || stride_t < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, ker, out, n, t, c, k_w, stride_n, stride_t, vec_bytes, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, ker, out, n, t, c, k_w, stride_n, stride_t, vec_bytes,
                                   st);
    case kF16:
      return launch<__half>(x, ker, out, n, t, c, k_w, stride_n, stride_t, vec_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
