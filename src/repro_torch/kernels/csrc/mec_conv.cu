// MEC convolution kernels for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Three kernels, each the Hopper counterpart of a Pallas TPU kernel in
// src/repro/kernels/mec_conv.py.  Notation: I is (n, i_h, i_w, i_c), already
// padded; K is (k_h, k_w, i_c, k_c), and K[r] is kernel row r as a
// (k_w*i_c, k_c) matrix; O is (n, o_h, o_w, k_c); L is MEC's compact lowered
// matrix (n, o_w, i_h, k_w*i_c) (paper Eq. 3).  Inputs are f32, bf16 or f16;
// every product accumulates in IEEE f32 (no TF32) and the output is written
// once, in the input dtype.
//
//   mec_lower  <- mec_lower_pallas / _lower_kernel    (K2)
//     L[n, w, h, j*i_c + c] = I[n, h, s_w*w + j, c].  Pure data movement,
//     bound by bytes (read I, write L).  Each L row is one contiguous run of
//     k_w*i_c elements of I, and consecutive h rows of L are adjacent, so a
//     CTA copies a run of whole L rows with consecutive threads on
//     consecutive destination elements: writes coalesce for any i_c,
//     including the short odd rows of i_c = 3.  One 32-bit division per
//     element, 64-bit offsets.
//
//   mec_fused  <- mec_conv_fused_pallas / _fused_kernel  (K1)
//     O[n, h, w-block] = sum_r strip(I[n, h*s_h + r]) @ K[r], with the
//     lowering done in shared memory, so L never exists in device memory.
//   mec_gemm   <- mec_gemm_pallas / _gemm_kernel          (K3)
//     O[n, h] = L[n, :, h*s_h*k_w*i_c : +k_h*k_w*i_c] @ K, the paper's
//     ld-aliasing: the k_h shifted rows of L form one contiguous window per
//     output column, so the kernel reads it as an ordinary GEMM operand with
//     leading dimension i_h*k_w*i_c.
//
// K1 and K3 are GEMMs on the CUDA cores.  At the paper's widths they are
// bound by operations (f32 FMAs), not bytes.  The TPU grid's innermost axis r
// accumulated into one output block across sequential grid steps; CTAs on
// Hopper run in no order, so each CTA owns one (n, h, w-block, k_c tile) and
// loops over r and chunks of i_c itself, keeping the f32 accumulator in
// registers.  Nothing carries across CTAs.  256 threads form a 16 x 16 grid;
// a thread computes TM output columns x 4 output channels, with the reduction
// operands staged in shared memory as f32 (bf16/f16 convert on load).  The
// ragged edges (last w-block, last k_c tile, last i_c chunk) are masked,
// never padded by a copy.  These are simple, correct kernels; tensor-core
// MMA, TMA and pipelining are later work.
//
//   mec_fused2 <- mec_conv_fused2_pallas / _fused2_kernel (K4)
//     The same O as K1, h-blocked: one CTA owns (n, block of oh_blk output
//     rows, w-block, k_c tile).  What bounds it: at the paper's widths,
//     operations (the same f32 FMAs as K1), with bytes I*(1 + halo/rows)
//     + K + O, halo = k_h - s_h input rows shared by consecutive blocks.
//     K1 reads every input row k_h/s_h times (once per output row that
//     uses it), and a narrow layer (cv11: o_w = 12, cv12: o_w = 5) fills
//     12 or 5 of a CTA's 16 position rows, each thread computing a
//     1 x 4 tile at 5 shared-memory loads per 4 FMAs.  K4's design: the
//     CTA's tile is a 2-D sub-tile of tr output rows x tc columns
//     (tr*tc <= 128 positions), flattened onto the 16 thread rows, so a
//     narrow layer stacks several output rows into one CTA and a thread
//     computes up to 8 positions x 4 channels.  Per i_c chunk, the CTA
//     stages the (tr-1)*s_h + k_h input rows its output rows need, over
//     their column span, once, and then loops r over k_h reading every
//     kernel row's window out of the same staged rows.  The TPU kernel's
//     halo (a second BlockSpec view of block h+1, which is wrong when the
//     halo outruns one block: fault F1) has no counterpart: a CTA loads
//     the rows it needs, so any k_h, s_h (k_h < s_h included) is exact.
//     Shared memory is sized against the 227 KB a block may opt into.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 4;               // output channels per thread
constexpr int kBN = 16 * kTN;        // output channels per CTA
constexpr int kGemmBK = 32;          // K3 reduction chunk
constexpr int kFusedMaxCC = 32;      // K1/K4 channel chunk cap
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kFused2MaxPos = 128;   // K4 output positions per sub-tile
constexpr int kFused2MaxRows = 16;   // K4 output rows per sub-tile
// K4's target for one CTA's shared memory: two CTAs fit on an SM's 228 KB.
constexpr size_t kFused2Smem = 96 * 1024;

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

// ---------------------------------------------------------------------------
// K2: compact lowering.  grid = (n*o_w, ceil(i_h / rows_per_cta)).
// ---------------------------------------------------------------------------
template <typename S>   // S: storage type of the element width (a bit copy)
__global__ void __launch_bounds__(kThreads)
lower_kernel(const S* __restrict__ inp, S* __restrict__ low, int i_h, int i_w,
             int i_c, int kwic, int s_w, int o_w, int rows_per_cta) {
  const int64_t nw = blockIdx.x;
  const int64_t n = nw / o_w;
  const int w = (int)(nw - n * o_w);
  const int h0 = blockIdx.y * rows_per_cta;
  const int rows = min(rows_per_cta, i_h - h0);
  const int count = rows * kwic;
  S* dst = low + (nw * i_h + h0) * (int64_t)kwic;
  const S* src = inp + ((n * i_h + h0) * i_w + (int64_t)w * s_w) * i_c;
  const int64_t src_row = (int64_t)i_w * i_c;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    const int hl = e / kwic;
    const int q = e - hl * kwic;
    dst[e] = src[hl * src_row + q];
  }
}

// ---------------------------------------------------------------------------
// K1: fused MEC conv.  grid = (n*o_h, ceil(o_w / w_blk), ceil(k_c / kBN)).
// Per (r, i_c chunk): shared memory holds the input span of one output
// sub-tile, s_w*(BM-1) + k_w columns x cc channels, and the K slab
// K[r, 0:k_w, chunk, k tile], k_w x cc x kBN.  The strided, overlapping
// column windows are read straight out of the span, so the strip is never
// written anywhere.
// ---------------------------------------------------------------------------
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const T* __restrict__ inp, const T* __restrict__ ker,
             T* __restrict__ out, int i_h, int i_w, int i_c, int k_h, int k_w,
             int k_c, int s_h, int s_w, int o_h, int o_w, int w_blk, int cc) {
  constexpr int TM = BM / 16;
  extern __shared__ float smem[];
  const int span = s_w * (BM - 1) + k_w;
  float* s_in = smem;                 // [span][cc]
  float* s_k = smem + span * cc;      // [k_w][cc][kBN]

  const int64_t nh = blockIdx.x;
  const int64_t n = nh / o_h;
  const int h = (int)(nh - n * o_h);
  const int wb_end = min(((int)blockIdx.y + 1) * w_blk, o_w);
  const int k0 = blockIdx.z * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int w0 = blockIdx.y * w_blk; w0 < wb_end; w0 += BM) {
    float acc[TM][kTN];
#pragma unroll
    for (int p = 0; p < TM; ++p)
#pragma unroll
      for (int q = 0; q < kTN; ++q) acc[p][q] = 0.f;
    const int col0 = w0 * s_w;

    for (int r = 0; r < k_h; ++r) {
      const int64_t row_px = (n * i_h + (int64_t)h * s_h + r) * i_w;
      const T* k_row = ker + (int64_t)r * k_w * i_c * k_c;
      for (int c0 = 0; c0 < i_c; c0 += cc) {
        const int ccn = min(cc, i_c - c0);
        __syncthreads();   // the previous chunk's reads of smem are done
        for (int e = threadIdx.x; e < span * cc; e += kThreads) {
          const int col = e / cc;
          const int c = e - col * cc;
          const int gcol = col0 + col;
          float v = 0.f;
          if (c < ccn && gcol < i_w) v = to_f32(inp[(row_px + gcol) * i_c + c0 + c]);
          s_in[e] = v;
        }
        for (int e = threadIdx.x; e < k_w * cc * kBN; e += kThreads) {
          const int kk = e % kBN;
          const int jc = e / kBN;
          const int j = jc / cc;
          const int c = jc - j * cc;
          float v = 0.f;
          if (c < ccn && k0 + kk < k_c)
            v = to_f32(k_row[((int64_t)j * i_c + c0 + c) * k_c + k0 + kk]);
          s_k[e] = v;
        }
        __syncthreads();
        for (int j = 0; j < k_w; ++j) {
          const float* a_col = s_in + (ty * s_w + j) * cc;
          const float* b_row = s_k + j * cc * kBN + tx;
          for (int c = 0; c < ccn; ++c) {
            float a[TM], b[kTN];
#pragma unroll
            for (int p = 0; p < TM; ++p) a[p] = a_col[p * 16 * s_w * cc + c];
#pragma unroll
            for (int q = 0; q < kTN; ++q) b[q] = b_row[c * kBN + q * 16];
#pragma unroll
            for (int p = 0; p < TM; ++p)
#pragma unroll
              for (int q = 0; q < kTN; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < TM; ++p) {
      const int w = w0 + ty + 16 * p;
      if (w >= wb_end) continue;
      T* o = out + ((nh * o_w) + w) * (int64_t)k_c;
#pragma unroll
      for (int q = 0; q < kTN; ++q) {
        const int k = k0 + tx + 16 * q;
        if (k < k_c) o[k] = from_f32<T>(acc[p][q]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: h-blocked fused MEC conv.
// grid = (n*ceil(o_h / oh_blk), ceil(o_w / w_blk), ceil(k_c / kBN)).
// The CTA walks its oh_blk x w_blk block in sub-tiles of tr x tc output
// positions; position m = ty + 16*p (p < TM) is output (m / tc, m % tc) of
// the sub-tile.  Per i_c chunk, shared memory holds the sub-tile's input
// rows (tr-1)*s_h + k_h x its column span (tc-1)*s_w + k_w x cc channels,
// staged once; then, per kernel row r, the slab K[r, 0:k_w, chunk, k tile].
// ---------------------------------------------------------------------------
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
fused2_kernel(const T* __restrict__ inp, const T* __restrict__ ker,
              T* __restrict__ out, int i_h, int i_w, int i_c, int k_h, int k_w,
              int k_c, int s_h, int s_w, int o_h, int o_w, int n_hblk,
              int oh_blk, int w_blk, int tr, int tc, int cc) {
  extern __shared__ float smem[];
  const int rows_in = (tr - 1) * s_h + k_h;
  const int span = (tc - 1) * s_w + k_w;
  const int per_row = span * cc;
  float* s_in = smem;                       // [rows_in][span][cc]
  float* s_k = smem + rows_in * per_row;    // [k_w][cc][kBN]

  const int64_t nb = blockIdx.x;
  const int64_t n = nb / n_hblk;
  const int h_beg = (int)(nb - n * n_hblk) * oh_blk;
  const int h_end = min(h_beg + oh_blk, o_h);
  const int w_beg = blockIdx.y * w_blk;
  const int w_end = min(w_beg + w_blk, o_w);
  const int k0 = blockIdx.z * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tile = tr * tc;

  // Offset of each of this thread's positions in the staged rows (r = 0,
  // j = 0, c = 0); positions past the sub-tile read offset 0 and are
  // never written.
  int off[TM];
#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int m = ty + 16 * p;
    const int dr = m / tc;
    off[p] = m < tile ? (dr * s_h * span + (m - dr * tc) * s_w) * cc : 0;
  }

  for (int h0 = h_beg; h0 < h_end; h0 += tr) {
    for (int w0 = w_beg; w0 < w_end; w0 += tc) {
      float acc[TM][kTN];
#pragma unroll
      for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int q = 0; q < kTN; ++q) acc[p][q] = 0.f;
      const int row0 = h0 * s_h;
      const int col0 = w0 * s_w;

      for (int c0 = 0; c0 < i_c; c0 += cc) {
        const int ccn = min(cc, i_c - c0);
        __syncthreads();   // every read of the previous chunk is done
        for (int e = threadIdx.x; e < rows_in * per_row; e += kThreads) {
          const int row = e / per_row;
          const int rem = e - row * per_row;
          const int col = rem / cc;
          const int c = rem - col * cc;
          const int grow = row0 + row;
          const int gcol = col0 + col;
          float v = 0.f;
          if (c < ccn && grow < i_h && gcol < i_w)
            v = to_f32(inp[((n * i_h + grow) * (int64_t)i_w + gcol) * i_c + c0 + c]);
          s_in[e] = v;
        }
        for (int r = 0; r < k_h; ++r) {
          if (r > 0) __syncthreads();   // every read of K[r-1]'s slab is done
          const T* k_row = ker + (int64_t)r * k_w * i_c * k_c;
          for (int e = threadIdx.x; e < k_w * cc * kBN; e += kThreads) {
            const int kk = e % kBN;
            const int jc = e / kBN;
            const int j = jc / cc;
            const int c = jc - j * cc;
            float v = 0.f;
            if (c < ccn && k0 + kk < k_c)
              v = to_f32(k_row[((int64_t)j * i_c + c0 + c) * k_c + k0 + kk]);
            s_k[e] = v;
          }
          __syncthreads();
          const float* a_row = s_in + r * per_row;
          for (int j = 0; j < k_w; ++j) {
            const float* a_col = a_row + j * cc;
            const float* b_row = s_k + j * cc * kBN + tx;
            for (int c = 0; c < ccn; ++c) {
              float a[TM], b[kTN];
#pragma unroll
              for (int p = 0; p < TM; ++p) a[p] = a_col[off[p] + c];
#pragma unroll
              for (int q = 0; q < kTN; ++q) b[q] = b_row[c * kBN + q * 16];
#pragma unroll
              for (int p = 0; p < TM; ++p)
#pragma unroll
                for (int q = 0; q < kTN; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
            }
          }
        }
      }

#pragma unroll
      for (int p = 0; p < TM; ++p) {
        const int m = ty + 16 * p;
        if (m >= tile) continue;
        const int dr = m / tc;
        const int h = h0 + dr;
        const int w = w0 + (m - dr * tc);
        if (h >= h_end || w >= w_end) continue;
        T* o = out + ((n * o_h + h) * (int64_t)o_w + w) * k_c;
#pragma unroll
        for (int q = 0; q < kTN; ++q) {
          const int k = k0 + tx + 16 * q;
          if (k < k_c) o[k] = from_f32<T>(acc[p][q]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: shifted GEMM over L.  grid = (n*o_h, ceil(o_w / w_blk), ceil(k_c / kBN)).
// A[w, t] = L[n, w, h*s_h*kwic + t] for t < k_h*kwic (row stride i_h*kwic),
// B = K as a (k_h*kwic, k_c) matrix.
// ---------------------------------------------------------------------------
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ low, const T* __restrict__ ker,
            T* __restrict__ out, int o_w, int i_h, int kwic, int k_h, int k_c,
            int s_h, int o_h, int w_blk) {
  constexpr int TM = BM / 16;
  __shared__ float s_a[kGemmBK][BM + 1];   // +1: conflict-free transposed stores
  __shared__ float s_b[kGemmBK][kBN];

  const int64_t nh = blockIdx.x;
  const int64_t n = nh / o_h;
  const int h = (int)(nh - n * o_h);
  const int wb_end = min(((int)blockIdx.y + 1) * w_blk, o_w);
  const int k0 = blockIdx.z * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t red = (int64_t)k_h * kwic;          // window length
  const int64_t lda = (int64_t)i_h * kwic;          // L row stride per w
  const T* a_base = low + n * o_w * lda + (int64_t)h * s_h * kwic;

  for (int w0 = blockIdx.y * w_blk; w0 < wb_end; w0 += BM) {
    float acc[TM][kTN];
#pragma unroll
    for (int p = 0; p < TM; ++p)
#pragma unroll
      for (int q = 0; q < kTN; ++q) acc[p][q] = 0.f;

    for (int64_t t0 = 0; t0 < red; t0 += kGemmBK) {
      __syncthreads();
      for (int e = threadIdx.x; e < BM * kGemmBK; e += kThreads) {
        const int m = e / kGemmBK;
        const int t = e % kGemmBK;
        const int w = w0 + m;
        float v = 0.f;
        if (w < wb_end && t0 + t < red) v = to_f32(a_base[(int64_t)w * lda + t0 + t]);
        s_a[t][m] = v;
      }
      for (int e = threadIdx.x; e < kGemmBK * kBN; e += kThreads) {
        const int t = e / kBN;
        const int kk = e % kBN;
        float v = 0.f;
        if (t0 + t < red && k0 + kk < k_c) v = to_f32(ker[(t0 + t) * k_c + k0 + kk]);
        s_b[t][kk] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int t = 0; t < kGemmBK; ++t) {
        float a[TM], b[kTN];
#pragma unroll
        for (int p = 0; p < TM; ++p) a[p] = s_a[t][ty + 16 * p];
#pragma unroll
        for (int q = 0; q < kTN; ++q) b[q] = s_b[t][tx + 16 * q];
#pragma unroll
        for (int p = 0; p < TM; ++p)
#pragma unroll
          for (int q = 0; q < kTN; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
    }

#pragma unroll
    for (int p = 0; p < TM; ++p) {
      const int w = w0 + ty + 16 * p;
      if (w >= wb_end) continue;
      T* o = out + ((nh * o_w) + w) * (int64_t)k_c;
#pragma unroll
      for (int q = 0; q < kTN; ++q) {
        const int k = k0 + tx + 16 * q;
        if (k < k_c) o[k] = from_f32<T>(acc[p][q]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host launchers
// ---------------------------------------------------------------------------
bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

// The sub-tile height: the smallest of 16/32/64 columns that covers w_blk,
// so narrow layers (cv12: o_w = 5) do not idle 60 of 64 rows.
int tile_rows(long long w_blk) { return w_blk <= 16 ? 16 : (w_blk <= 32 ? 32 : 64); }

template <typename T, int BM>
cudaError_t launch_fused(const void* inp, const void* ker, void* out, long long i_n,
                         int i_h, int i_w, int i_c, int k_h, int k_w, int k_c,
                         int s_h, int s_w, int o_h, int o_w, int w_blk,
                         cudaStream_t stream) {
  const int span = s_w * (BM - 1) + k_w;
  const size_t per_c = (size_t)(span + k_w * kBN) * sizeof(float);
  int cc = (int)(kDefaultSmem / per_c);
  cc = cc < kFusedMaxCC ? cc : kFusedMaxCC;
  cc = cc < i_c ? cc : i_c;
  if (cc >= 8) cc &= ~7;
  if (cc < 1) cc = 1;
  const size_t smem = per_c * cc;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(fused_kernel<T, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long grid_x = i_n * o_h;
  const long long grid_y = (o_w + w_blk - 1) / w_blk;
  const long long grid_z = (k_c + kBN - 1) / kBN;
  if (!fits_int(grid_x) || grid_y > 65535 || grid_z > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
  fused_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(inp), static_cast<const T*>(ker), static_cast<T*>(out),
      i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk, cc);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_fused2_tm(const void* inp, const void* ker, void* out, dim3 grid,
                             size_t smem, int i_h, int i_w, int i_c, int k_h, int k_w,
                             int k_c, int s_h, int s_w, int o_h, int o_w, int n_hblk,
                             int oh_blk, int w_blk, int tr, int tc, int cc,
                             cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fused2_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused2_kernel<T, TM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(inp), static_cast<const T*>(ker), static_cast<T*>(out),
      i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, n_hblk, oh_blk, w_blk, tr, tc,
      cc);
  return cudaGetLastError();
}

// K4's shared memory for one staged channel of a tr x tc sub-tile, in bytes.
size_t fused2_bytes_per_channel(long long tr, long long tc, long long k_h,
                                long long k_w, long long s_h, long long s_w) {
  const long long rows_in = (tr - 1) * s_h + k_h;
  const long long span = (tc - 1) * s_w + k_w;
  return (size_t)(rows_in * span + k_w * kBN) * sizeof(float);
}

// The shared memory a block may opt in to on the current device.
cudaError_t smem_optin(int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// K4's sub-tile of an oh_blk x w_blk block: every row of the block up to
// kFused2MaxRows, then as many columns as keep it within kFused2MaxPos
// positions.  Halved (columns first) only where one channel of its input
// rows and kernel slab would not fit the opt-in.  Returns the bytes of one
// staged channel, or 0 where not even a 1 x 1 sub-tile fits.
size_t fused2_tile(int oh_blk, int w_blk, int k_h, int k_w, int s_h, int s_w, int optin,
                   int* tr_out, int* tc_out) {
  int tr = oh_blk < kFused2MaxRows ? oh_blk : kFused2MaxRows;
  int tc = kFused2MaxPos / tr;
  tc = tc < w_blk ? tc : w_blk;
  size_t per_c = fused2_bytes_per_channel(tr, tc, k_h, k_w, s_h, s_w);
  while (per_c > (size_t)optin && (tr > 1 || tc > 1)) {
    if (tc > 1) tc = (tc + 1) / 2; else tr = (tr + 1) / 2;
    per_c = fused2_bytes_per_channel(tr, tc, k_h, k_w, s_h, s_w);
  }
  *tr_out = tr;
  *tc_out = tc;
  return per_c > (size_t)optin ? 0 : per_c;
}

template <typename T>
cudaError_t launch_fused2(const void* inp, const void* ker, void* out, long long i_n,
                          int i_h, int i_w, int i_c, int k_h, int k_w, int k_c,
                          int s_h, int s_w, int o_h, int o_w, int w_blk, int oh_blk,
                          cudaStream_t stream) {
  int optin = 0, tr = 0, tc = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const size_t per_c = fused2_tile(oh_blk, w_blk, k_h, k_w, s_h, s_w, optin, &tr, &tc);
  if (per_c == 0) return cudaErrorInvalidValue;
  const size_t budget = per_c <= kFused2Smem ? kFused2Smem : (size_t)optin;
  int cc = (int)(budget / per_c);
  cc = cc < kFusedMaxCC ? cc : kFusedMaxCC;
  cc = cc < i_c ? cc : i_c;
  if (cc >= 8) cc &= ~7;
  if (cc < 1) cc = 1;
  const size_t smem = per_c * cc;

  const int n_hblk = (o_h + oh_blk - 1) / oh_blk;
  const long long grid_x = i_n * n_hblk;
  const long long grid_y = (o_w + w_blk - 1) / w_blk;
  const long long grid_z = (k_c + kBN - 1) / kBN;
  if (!fits_int(grid_x) || grid_y > 65535 || grid_z > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
#define MEC_FUSED2_TM(TM)                                                            \
  case TM:                                                                           \
    return launch_fused2_tm<T, TM>(inp, ker, out, grid, smem, i_h, i_w, i_c, k_h,   \
                                   k_w, k_c, s_h, s_w, o_h, o_w, n_hblk, oh_blk,    \
                                   w_blk, tr, tc, cc, stream);
  switch ((tr * tc + 15) / 16) {
    MEC_FUSED2_TM(1)
    MEC_FUSED2_TM(2)
    MEC_FUSED2_TM(3)
    MEC_FUSED2_TM(4)
    MEC_FUSED2_TM(5)
    MEC_FUSED2_TM(6)
    MEC_FUSED2_TM(7)
    MEC_FUSED2_TM(8)
    default: return cudaErrorInvalidValue;
  }
#undef MEC_FUSED2_TM
}

template <typename T, int BM>
cudaError_t launch_gemm(const void* low, const void* ker, void* out, long long i_n,
                        int o_w, int i_h, int kwic, int k_h, int k_c, int s_h, int o_h,
                        int w_blk, cudaStream_t stream) {
  const long long grid_x = i_n * o_h;
  const long long grid_y = (o_w + w_blk - 1) / w_blk;
  const long long grid_z = (k_c + kBN - 1) / kBN;
  if (!fits_int(grid_x) || grid_y > 65535 || grid_z > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
  gemm_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(low), static_cast<const T*>(ker), static_cast<T*>(out),
      o_w, i_h, kwic, k_h, k_c, s_h, o_h, w_blk);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_lower(const void* inp, void* low, long long i_n, int i_h, int i_w,
                         int i_c, int k_w, int s_w, int o_w, cudaStream_t stream) {
  const int kwic = k_w * i_c;
  // About 4096 elements of L per CTA, in whole rows.
  int rows = 4096 / kwic;
  rows = rows < 1 ? 1 : (rows > i_h ? i_h : rows);
  if ((long long)rows * kwic > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long grid_x = i_n * o_w;
  const long long grid_y = (i_h + rows - 1) / rows;
  if (!fits_int(grid_x) || grid_y > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  lower_kernel<S><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(inp), static_cast<S*>(low), i_h, i_w, i_c, kwic, s_w, o_w,
      rows);
  return cudaGetLastError();
}

bool dims_ok(std::initializer_list<long long> dims) {
  for (long long d : dims)
    if (d < 1 || d > 0x7fffffffLL) return false;
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes.  Pointers and the stream are void*, every
// size is a long long; each entry returns the cudaError_t of its launch.
// ---------------------------------------------------------------------------
extern "C" {

const char* mec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mec_lower(const void* inp, void* low, int dtype, long long i_n, long long i_h,
              long long i_w, long long i_c, long long k_w, long long s_w,
              long long o_w, void* stream) {
  if (!dims_ok({i_n, i_h, i_w, i_c, k_w, s_w, o_w, k_w * i_c}) ||
      (o_w - 1) * s_w + k_w > i_w)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_lower<uint32_t>(inp, low, i_n, (int)i_h, (int)i_w, (int)i_c, (int)k_w,
                                    (int)s_w, (int)o_w, st);
    case kBF16:
    case kF16:
      return launch_lower<uint16_t>(inp, low, i_n, (int)i_h, (int)i_w, (int)i_c, (int)k_w,
                                    (int)s_w, (int)o_w, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int mec_fused(const void* inp, const void* ker, void* out, int dtype, long long i_n,
              long long i_h, long long i_w, long long i_c, long long k_h, long long k_w,
              long long k_c, long long s_h, long long s_w, long long o_h, long long o_w,
              long long w_blk, void* stream) {
  if (!dims_ok({i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk}) ||
      w_blk > o_w || (o_h - 1) * s_h + k_h > i_h || (o_w - 1) * s_w + k_w > i_w)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bm = tile_rows(w_blk);
#define MEC_FUSED_ARGS                                                              \
  inp, ker, out, i_n, (int)i_h, (int)i_w, (int)i_c, (int)k_h, (int)k_w, (int)k_c,  \
      (int)s_h, (int)s_w, (int)o_h, (int)o_w, (int)w_blk, st
#define MEC_FUSED_BM(T)                                                             \
  (bm == 16 ? launch_fused<T, 16>(MEC_FUSED_ARGS)                                  \
            : bm == 32 ? launch_fused<T, 32>(MEC_FUSED_ARGS)                       \
                       : launch_fused<T, 64>(MEC_FUSED_ARGS))
  switch (dtype) {
    case kF32: return MEC_FUSED_BM(float);
    case kBF16: return MEC_FUSED_BM(__nv_bfloat16);
    case kF16: return MEC_FUSED_BM(__half);
    default: return cudaErrorInvalidValue;
  }
#undef MEC_FUSED_BM
#undef MEC_FUSED_ARGS
}

int mec_fused2(const void* inp, const void* ker, void* out, int dtype, long long i_n,
               long long i_h, long long i_w, long long i_c, long long k_h, long long k_w,
               long long k_c, long long s_h, long long s_w, long long o_h, long long o_w,
               long long w_blk, long long oh_blk, void* stream) {
  if (!dims_ok({i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk, oh_blk}) ||
      w_blk > o_w || oh_blk > o_h || (o_h - 1) * s_h + k_h > i_h ||
      (o_w - 1) * s_w + k_w > i_w)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MEC_FUSED2_ARGS                                                             \
  inp, ker, out, i_n, (int)i_h, (int)i_w, (int)i_c, (int)k_h, (int)k_w, (int)k_c,  \
      (int)s_h, (int)s_w, (int)o_h, (int)o_w, (int)w_blk, (int)oh_blk, st
  switch (dtype) {
    case kF32: return launch_fused2<float>(MEC_FUSED2_ARGS);
    case kBF16: return launch_fused2<__nv_bfloat16>(MEC_FUSED2_ARGS);
    case kF16: return launch_fused2<__half>(MEC_FUSED2_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef MEC_FUSED2_ARGS
}

// The tr x tc sub-tile mec_fused2 runs for an oh_blk x w_blk block on the
// current device (what kernels/ops.py pick_oh_blk sizes its blocks by).
int mec_fused2_tile(long long oh_blk, long long w_blk, long long k_h, long long k_w,
                    long long s_h, long long s_w, int* tr, int* tc) {
  if (!dims_ok({oh_blk, w_blk, k_h, k_w, s_h, s_w})) return cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  return fused2_tile((int)oh_blk, (int)w_blk, (int)k_h, (int)k_w, (int)s_h, (int)s_w,
                     optin, tr, tc) == 0
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

int mec_gemm(const void* low, const void* ker, void* out, int dtype, long long i_n,
             long long o_w, long long i_h, long long kwic, long long k_h, long long k_c,
             long long s_h, long long o_h, long long w_blk, void* stream) {
  if (!dims_ok({i_n, o_w, i_h, kwic, k_h, k_c, s_h, o_h, w_blk}) || w_blk > o_w ||
      (o_h - 1) * s_h + k_h > i_h)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bm = tile_rows(w_blk);
#define MEC_GEMM_ARGS                                                               \
  low, ker, out, i_n, (int)o_w, (int)i_h, (int)kwic, (int)k_h, (int)k_c, (int)s_h, \
      (int)o_h, (int)w_blk, st
#define MEC_GEMM_BM(T)                                                              \
  (bm == 16 ? launch_gemm<T, 16>(MEC_GEMM_ARGS)                                    \
            : bm == 32 ? launch_gemm<T, 32>(MEC_GEMM_ARGS)                         \
                       : launch_gemm<T, 64>(MEC_GEMM_ARGS))
  switch (dtype) {
    case kF32: return MEC_GEMM_BM(float);
    case kBF16: return MEC_GEMM_BM(__nv_bfloat16);
    case kF16: return MEC_GEMM_BM(__half);
    default: return cudaErrorInvalidValue;
  }
#undef MEC_GEMM_BM
#undef MEC_GEMM_ARGS
}

}  // extern "C"
