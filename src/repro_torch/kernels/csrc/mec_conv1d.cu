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
// 3.35 TB/s.  The design therefore aims at reading each element once, with
// coalesced accesses:
//   - Threads run along channels: a warp reads 32 neighbouring channels of
//     one time step, one contiguous run of memory.
//   - Each thread walks a tile of kTimeTile time steps of its channel and
//     keeps the last k_w - 1 inputs in registers (a shift register of k_w
//     floats, fully unrolled: k_w is a template argument, 1 to kMaxKw), so
//     each input element is loaded once per tile, plus the k_w - 1 steps
//     of history before the tile.
//   - The causal halo: the TPU kernel fetched the previous time block
//     through a second BlockSpec view and took its last k_w - 1 rows (for
//     k_w = 1 that slice is the whole block: fault F2).  Here a thread
//     simply reads the k_w - 1 steps before its tile, as zeros before step
//     0; there is no second view, and k_w = 1 reads no history at all.
//   - Offsets are 64-bit: the long_500k shape (1, 524288, 7296) holds
//     3.8e9 elements, past 2^31.
// A simple design, right first: no vectorised loads, no shared memory.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per CTA
constexpr int kTimeTile = 64;   // time steps per thread
constexpr int kMaxKw = 8;       // largest kernel width instantiated

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// grid = (n * ceil(t / kTimeTile), ceil(c / kThreads)); one thread per
// (batch row, time tile, channel).
template <typename T, int KW>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ ker, T* __restrict__ out,
              int64_t t, int64_t c, int64_t stride_n, int64_t stride_t,
              int64_t time_tiles) {
  const int64_t ch = (int64_t)blockIdx.y * kThreads + threadIdx.x;
  if (ch >= c) return;
  const int64_t n = blockIdx.x / time_tiles;
  const int64_t t0 = (blockIdx.x - n * time_tiles) * kTimeTile;
  const int64_t t1 = t0 + kTimeTile < t ? t0 + kTimeTile : t;
  const T* xr = x + n * stride_n + ch;
  T* outr = out + n * t * c + ch;

  float w[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) w[j] = to_f32(ker[j * c + ch]);
  // win[j] is the input at step s - (KW-1) + j for the output step s.
  float win[KW];
#pragma unroll
  for (int j = 0; j < KW - 1; ++j) {
    const int64_t s = t0 - (KW - 1) + j;
    win[j] = s >= 0 ? to_f32(xr[s * stride_t]) : 0.0f;
  }
#pragma unroll 8
  for (int64_t s = t0; s < t1; ++s) {
    win[KW - 1] = to_f32(xr[s * stride_t]);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < KW; ++j) acc = __fadd_rn(acc, __fmul_rn(win[j], w[j]));
    outr[s * c] = from_f32<T>(acc);
#pragma unroll
    for (int j = 0; j < KW - 1; ++j) win[j] = win[j + 1];
  }
}

template <typename T, int KW>
cudaError_t launch_kw(const void* x, const void* ker, void* out, long long n, long long t,
                      long long c, long long stride_n, long long stride_t,
                      cudaStream_t stream) {
  const long long time_tiles = (t + kTimeTile - 1) / kTimeTile;
  const long long grid_x = n * time_tiles;
  const long long grid_y = (c + kThreads - 1) / kThreads;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  conv1d_kernel<T, KW><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ker), static_cast<T*>(out), t, c,
      stride_n, stride_t, time_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* ker, void* out, long long n, long long t,
                   long long c, long long k_w, long long stride_n, long long stride_t,
                   cudaStream_t stream) {
#define MEC_CONV1D_KW(KW) \
  case KW: return launch_kw<T, KW>(x, ker, out, n, t, c, stride_n, stride_t, stream)
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

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes.  Pointers and the stream are void*, every
// size and stride (in elements) a long long; returns the cudaError_t of the
// launch.
// ---------------------------------------------------------------------------
extern "C" {

const char* mec_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mec_conv1d_max_kw() { return kMaxKw; }

int mec_conv1d(const void* x, const void* ker, void* out, int dtype, long long n,
               long long t, long long c, long long k_w, long long stride_n,
               long long stride_t, void* stream) {
  if (n < 1 || t < 1 || c < 1 || k_w < 1 || k_w > kMaxKw || stride_n < 0 || stride_t < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, ker, out, n, t, c, k_w, stride_n, stride_t, st);
    case kBF16:
      return launch<__nv_bfloat16>(x, ker, out, n, t, c, k_w, stride_n, stride_t, st);
    case kF16: return launch<__half>(x, ker, out, n, t, c, k_w, stride_n, stride_t, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
