// K6: the MEC weight gradient for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Notation as in mec_conv.cu: I (n, i_h, i_w, i_c) the padded input, G
// (n, o_h, o_w, k_c) the cotangent of O, dW (k_h, k_w, i_c, k_c) HWIO.  For
// each kernel row r,
//   dW[r, j, c, k] = sum_{n, h, w} I[n, h*s_h + r, w*s_w + j, c] G[n, h, w, k],
// a product of M = k_w*i_c rows (q = j*i_c + c) by k_c columns over the
// n*o_h*o_w output positions.  Row (n, h) of that reduction reads MEC's strip
// of input row h*s_h + r: S[w, q] = I-row[w*s_w*i_c + q], one row of the
// compact L (paper Eq. 3); G[n, h] is the cotangent's contiguous o_w x k_c
// rows.
//
// K6 replaces no TPU kernel: the JAX package's VJP (src/repro/core/conv_api.py
// _mec_weight_grad) is plain jnp, a lowering and k_h einsums, and so was the
// port's, which built the whole f32 L and, in every einsum, contiguous copies
// of L's strided row views and of the permuted cotangent (30.6 GiB a training
// step of the ResNet-101 stack at batch 128, 1.4% of the card).  K6 computes
// dW from I and G in place, with the lowering on chip.
//
// What bounds it: at the paper's widths, operations (the forward's FLOPs,
// 1,340 GFLOP for the 34-conv stack at batch 128, 2.7 ms at 495 TF32
// TFLOP/s); its bytes are I and G read once and dW written once (cv4: 2.0 GB,
// 0.6 ms at 3.35 TB/s).  What its design does about them:
//   - Tensor cores, f32 sums: mma.sync.m16n8k8 in TF32, three products a
//     multiply-add (lo*hi + hi*lo + hi*hi, as mec_mma.cuh's mma_3xtf32), each
//     stage's products added to the f32 sum with IEEE adds (add_part), so the
//     long reduction never chains in the tensor core's truncating accumulator.
//     The split rounds hi with an integer add on the bits (three instructions
//     an operand, where cvt.rna.tf32 lowers to four each): the loop issued
//     eight instructions an MMA with cvt and was bound by issue.
//   - The lowering stays in shared memory (the paper's ld-aliasing, as K1/K4
//     stage it).  A CTA owns an output tile of kernel row r, a block of jb
//     kernel columns, a chunk of cc input channels (its M = jb*cc rows) and bn
//     output channels, and one range of the positions.  A stage is 64
//     consecutive positions: the CTA copies, for each input row those
//     positions touch, the columns their windows span (cc channels each) and
//     the 64 cotangent rows of its bn channels, with cp.async into a 3-stage
//     ring.  A position's window is read in place, at the staged row's
//     address base + w*s_w*ldc + j*ldc + c: the jb windows that overlap in a
//     row share one staged copy (k_w/s_w reuse), and L is never written.
//     A table of each position's window offset, made while staging, lets a
//     stage cross rows, so narrow layers (cv11: o_w = 12, cv12: 5) fill whole
//     k-steps; each copy loop is one flat range over the stage's granules,
//     not a pass a row.  The row stride ldc is padded so that the four
//     positions of an MMA fragment fall in distinct banks.
//   - Output tiles are few where the reduction is long (cv4: 14 tiles, 1.5 M
//     positions), so the positions are split over CTAs until the grid fills
//     the SMs.  Each split writes its partial tile into a workspace (split,
//     dW); a second pass adds the splits in order and writes dW.  No
//     atomics: two runs give equal bits.
// Ragged edges (k_c off the bn tile, i_c off the chunk, the last kernel-column
// block, the last stage) are zero-filled by the copies; positions past the
// range read a zeroed window.  Offsets into I and G are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mec_mma.cuh"

namespace {

constexpr int kWarpM = 32;     // a warp's tile: 2 m16 x 4 n8 MMA tiles
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;
constexpr int kNT = kWarpN / 8;
constexpr int kBK = 64;        // positions a stage (8 TF32 k-steps)
constexpr int kRing = 3;       // cp.async stages
constexpr int kMaxWarps = 16;  // a CTA: warps_m * warps_n
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxSplits = 64;
constexpr int kMinStages = 16; // stages a split keeps at least
constexpr int kSumThreads = 256;

struct WParams {
  const float* inp;
  const float* g;
  float* dst;                 // dW, or the workspace (splits x dW)
  int i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w;
  long long P;                // positions n * o_h * o_w
  long long stages;           // ceil(P / kBK)
  long long dw_elems;         // k_h * k_w * i_c * k_c
  int cc, ncc;                // channels a chunk, chunks
  int ldc;                    // staged floats a column (>= cc)
  int jb, njb;                // kernel columns a CTA, blocks
  int bn, nkb;                // output channels a CTA, blocks
  int wm;                     // warps along M (bn / kWarpN along N)
  int m_rows;                 // jb * cc
  int in_elems;               // a stage's input floats
  int g_ld;                   // a staged cotangent row, floats (bn + 8)
  int stage_elems;            // in_elems + kBK * g_ld
  int zero_elems;             // the zeroed window, floats
  int vin, vg;                // copy widths, bytes: 16 or 4
  int lgc;                    // log2 of the granules a staged column, or -1
  int lgr;                    // log2 of the granules a staged cotangent row
  int cols_f;                 // staged columns of a full row: (o_w-1)*s_w + jb
  float inv_ow, inv_oh, inv_cols_f;   // reciprocals for small_div
  int splits;
  long long tiles;            // k_h * njb * ncc * nkb
};

// The position (n, h, w) the next stage starts at, carried from stage to
// stage.
struct Pos {
  int n, h, w;
};

// floor(x / d) for 0 <= x < 2^22 from a float reciprocal of d: x + 0.5 lies
// at least 0.5 / d from a multiple of d, far beyond the product's rounding.
__device__ __forceinline__ int small_div(int x, float inv_d) {
  return (int)(((float)x + 0.5f) * inv_d);
}

// Stage the kBK positions from pc (at `at`, advanced past them) into ring
// slot s_in / s_g: the input columns their windows span, row by row (one
// segment of columns per input row the positions touch, back to back),
// the cotangent rows, and each position's window offset in `tab`.  Every
// loop runs over the stage's granules as one flat range, so a stage of
// many short rows (cv12: 13) costs no pass a row.
__device__ __forceinline__ void stage_load(const WParams& p, float* s_in, float* s_g,
                                           int* tab, long long pc, Pos& at, int r, int j0,
                                           int c0, int k0, int zero_off) {
  const int nth = blockDim.x;
  const int nvalid = (int)min((long long)kBK, p.P - pc);
  // segment 0: the rest of the first row; then full rows of cols_f columns
  const int np0 = min(nvalid, p.o_w - at.w);
  const int cols0 = (np0 - 1) * p.s_w + p.jb;
  const int nseg = np0 == nvalid ? 1 : 2 + small_div(nvalid - np0 - 1, p.inv_ow);
  const int np_last = nvalid - np0 - (nseg - 2) * p.o_w;    // positions of the last row
  const int cols = nseg == 1 ? cols0
                             : cols0 + (nseg - 2) * p.cols_f + (np_last - 1) * p.s_w + p.jb;
  const int vpe = p.vin / 4;
  // one granule of staged column X: the segment (input row) X lies in, the
  // column within it
  auto copy = [&](int X, int c) {
    const int k = X < cols0 ? 0 : 1 + small_div(X - cols0, p.inv_cols_f);
    const int x = k == 0 ? X : X - cols0 - (k - 1) * p.cols_f;
    const int hk = at.h + k;
    const int dn = small_div(hk, p.inv_oh);
    const int gcol = (k == 0 ? at.w * p.s_w : 0) + j0 + x;
    const long long row =
        (long long)(at.n + dn) * p.i_h + (long long)(hk - dn * p.o_h) * p.s_h + r;
    const int valid = gcol < p.i_w ? max(0, min(p.vin, (p.i_c - c0 - c) * 4)) : 0;
    const float* src = valid ? p.inp + (row * p.i_w + gcol) * p.i_c + c0 + c : p.inp;
    mec_mma::copy_granule(s_in + X * p.ldc + c, src, p.vin, valid);
  };
  if (p.lgc >= 0) {   // a power-of-two count of granules a column: one a thread
    const int c = (threadIdx.x & ((1 << p.lgc) - 1)) * vpe;
    for (int X = threadIdx.x >> p.lgc; X < cols; X += nth >> p.lgc) copy(X, c);
  } else {
    const int gpc = (p.cc + vpe - 1) / vpe;
    for (int e = threadIdx.x; e < cols * gpc; e += nth) {
      const int X = e / gpc;
      copy(X, (e - X * gpc) * vpe);
    }
  }
  // each position's window: its row's segment, its column there
  for (int i = threadIdx.x; i < kBK; i += nth) {
    int off = zero_off;
    if (i < nvalid) {
      if (i < np0) {
        off = i * p.s_w * p.ldc;
      } else {
        const int k = 1 + small_div(i - np0, p.inv_ow);
        const int wi = i - np0 - (k - 1) * p.o_w;
        off = (cols0 + (k - 1) * p.cols_f + wi * p.s_w) * p.ldc;
      }
    }
    tab[i] = off;
  }
  // the next stage's first position
  {
    const int w = at.w + nvalid;
    const int dh = small_div(w, p.inv_ow);
    at.w = w - dh * p.o_w;
    const int h = at.h + dh;
    const int dn = small_div(h, p.inv_oh);
    at.h = h - dn * p.o_h;
    at.n += dn;
  }
  // cotangent: kBK rows of bn channels, contiguous in G; a power-of-two
  // count of granules a row, so each thread keeps one granule
  {
    const int vg = p.vg / 4;
    const int kk = (threadIdx.x & ((1 << p.lgr) - 1)) * vg;
    const int left_k = (p.k_c - k0 - kk) * 4;
    const float* src0 = p.g + pc * p.k_c + k0 + kk;
    for (int i = threadIdx.x >> p.lgr; i < kBK; i += nth >> p.lgr) {
      const int valid = i < nvalid ? max(0, min(p.vg, left_k)) : 0;
      const float* src = valid ? src0 + (long long)i * p.k_c : p.g;
      mec_mma::copy_granule(s_g + i * p.g_ld + kk, src, p.vg, valid);
    }
  }
}

// x = hi + lo, the three-product split: hi is x rounded to TF32's 10
// mantissa bits (ties away from zero, by an integer add on the bits, as
// cvt.rna.tf32 rounds finite x), lo = x - hi exactly, of which the tensor
// core reads the high 19 bits.  Three instructions an operand where
// cvt.rna.tf32 takes four each (the probe in PERF.md).
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// One k-step's three TF32 products, small terms first (lo*hi, hi*lo, then
// hi*hi, as mec_mma.cuh's mma_3xtf32), each product over all the warp's
// tiles before the next.
__device__ __forceinline__ void mma3(float (&part)[kMT][kNT][4],
                                     const mec_mma::Frags<kMT, kNT>& f) {
  uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) split(f.a[mt][i], ah[mt][i], al[mt][i]);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) split(f.b[nt][i], bh[nt][i], bl[nt][i]);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mec_mma::mma_tf32(part[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mec_mma::mma_tf32(part[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mec_mma::mma_tf32(part[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
}

// grid = tiles * splits CTAs, the split slowest; block = 32 * wm * (bn / 32),
// at most kMaxWarps (128 registers a thread).  kOneJ: cc is a multiple of
// the warp's 32 rows, so they are 32 channels of one kernel column, at
// fixed offsets from one address a position.
template <bool kOneJ>
__global__ void __launch_bounds__(kMaxThreads, 1)
wgrad_kernel(const __grid_constant__ WParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zero = reinterpret_cast<float*>(smem_raw);
  int* tabs = reinterpret_cast<int*>(zero + p.zero_elems);
  float* ring = reinterpret_cast<float*>(tabs + kRing * kBK);

  // grid x < 2^31 (the launcher): 32-bit divisions
  const unsigned bx = blockIdx.x;
  const int split_i = (int)(bx / (unsigned)p.tiles);
  unsigned t = bx - (unsigned)split_i * (unsigned)p.tiles;
  const int kb = (int)(t % (unsigned)p.nkb);
  t /= (unsigned)p.nkb;
  const int cb = (int)(t % (unsigned)p.ncc);
  t /= (unsigned)p.ncc;
  const int jbi = (int)(t % (unsigned)p.njb);
  const int r = (int)(t / (unsigned)p.njb);
  const int j0 = jbi * p.jb, c0 = cb * p.cc, k0 = kb * p.bn;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wmi = warp % p.wm, wni = warp / p.wm;

  // the lane's A rows (output rows m = j*cc + c) as offsets into a window
  int moff[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wmi * kWarpM + mt * 16 + g + 8 * hf;
      const int j = m / p.cc;
      moff[mt][hf] = m < p.m_rows ? j * p.ldc + (m - j * p.cc) : 0;
    }

  for (int i = threadIdx.x; i < p.zero_elems; i += blockDim.x) zero[i] = 0.f;
  const int zero_off = (int)(zero - ring);   // the zeroed window, from a slot's input

  const long long s_beg = split_i * p.stages / p.splits;
  const long long s_end = (split_i + 1) * p.stages / p.splits;
  Pos at;
  {
    const unsigned pc = (unsigned)(s_beg * kBK);   // positions fit in int (the launcher)
    const unsigned R = pc / (unsigned)p.o_w;
    at.w = (int)(pc - R * (unsigned)p.o_w);
    at.n = (int)(R / (unsigned)p.o_h);
    at.h = (int)(R - (unsigned)at.n * (unsigned)p.o_h);
  }

  float acc[kMT][kNT][4], part[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = part[mt][nt][q] = 0.f;

#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (s_beg + i < s_end) {
      float* slot = ring + i * p.stage_elems;
      stage_load(p, slot, slot + p.in_elems, tabs + i * kBK, (s_beg + i) * kBK, at, r, j0, c0,
                 k0, zero_off - i * p.stage_elems);
    }
    mec_mma::cp_async_commit();
  }

  for (long long s = s_beg; s < s_end; ++s) {
    mec_mma::cp_async_wait<kRing - 2>();
    __syncthreads();   // stage s has landed; every read of stage s-1 is done
    {
      const long long nxt = s + kRing - 1;
      if (nxt < s_end) {
        const int k = (int)((nxt - s_beg) % kRing);
        float* slot = ring + k * p.stage_elems;
        stage_load(p, slot, slot + p.in_elems, tabs + k * kBK, nxt * kBK, at, r, j0, c0, k0,
                   zero_off - k * p.stage_elems);
      }
      mec_mma::cp_async_commit();
    }
    const int k = (int)((s - s_beg) % kRing);
    const float* s_in = ring + k * p.stage_elems;
    const float* s_g = s_in + p.in_elems + wni * kWarpN + g;
    const int* tab = tabs + k * kBK + tq;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      // A[m][kk] = window(position kk)[m]; B[kk][n] = G[position kk][n]
      mec_mma::Frags<kMT, kNT> f;
      const int p0 = tab[ks * 8], p1 = tab[ks * 8 + 4];
      if constexpr (kOneJ) {
        const float* a0 = s_in + p0 + moff[0][0];
        const float* a1 = s_in + p1 + moff[0][0];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          f.a[mt][0] = __float_as_uint(a0[mt * 16]);
          f.a[mt][1] = __float_as_uint(a0[mt * 16 + 8]);
          f.a[mt][2] = __float_as_uint(a1[mt * 16]);
          f.a[mt][3] = __float_as_uint(a1[mt * 16 + 8]);
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          f.a[mt][0] = __float_as_uint(s_in[p0 + moff[mt][0]]);
          f.a[mt][1] = __float_as_uint(s_in[p0 + moff[mt][1]]);
          f.a[mt][2] = __float_as_uint(s_in[p1 + moff[mt][0]]);
          f.a[mt][3] = __float_as_uint(s_in[p1 + moff[mt][1]]);
        }
      }
      const float* b0 = s_g + (ks * 8 + tq) * p.g_ld;
      const float* b1 = b0 + 4 * p.g_ld;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        f.b[nt][0] = __float_as_uint(b0[nt * 8]);
        f.b[nt][1] = __float_as_uint(b1[nt * 8]);
      }
      mma3(part, f);
    }
    mec_mma::add_part<kMT, kNT>(acc, part);   // the stage's sum into the f32 sum
  }
  mec_mma::cp_async_wait<0>();

  float* dst = p.dst + (long long)split_i * (p.splits > 1 ? p.dw_elems : 0);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wmi * kWarpM + mt * 16 + g + 8 * hf;
      if (m >= p.m_rows) continue;
      const int j = m / p.cc;
      const int c = m - j * p.cc;
      if (j0 + j >= p.k_w || c0 + c >= p.i_c) continue;
      float* o = dst + (((long long)r * p.k_w + j0 + j) * p.i_c + c0 + c) * p.k_c;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int kk = k0 + wni * kWarpN + nt * 8 + 2 * tq;
        if (kk < p.k_c) o[kk] = acc[mt][nt][2 * hf];
        if (kk + 1 < p.k_c) o[kk + 1] = acc[mt][nt][2 * hf + 1];
      }
    }
}

// dW = the splits' partial sums, added in split order.
__global__ void __launch_bounds__(kSumThreads)
wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ out, long long n,
                 int splits) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += step) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Host launcher
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 64;

struct WLaunch {
  WParams p;
  void (*kern)(WParams);       // the instance: wgrad_kernel<cc % 32 == 0>
  int threads;
  size_t smem;
  int per_sm;                  // CTAs an SM holds
  int sms;
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The widest copy (16 or 4 bytes) that divides a run of `row_bytes` and the
// base address.
int copy_width(long long row_bytes, const void* base) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  return row_bytes % 16 == 0 && a % 16 == 0 ? 16 : 4;
}

// Most bank conflicts among the lanes of one A fragment load: lane (g, t)
// reads word (t * s_w * ldc + g) of a staged row.
int conflicts(int ldc, int s_w) {
  int worst = 0;
  for (int b = 0; b < 32; ++b) {
    int hits = 0;
    for (int t = 0; t < 4; ++t)
      for (int gg = 0; gg < 8; ++gg) hits += (int)(((long long)t * s_w * ldc + gg) % 32 == b);
    worst = hits > worst ? hits : worst;
  }
  return worst;
}

// Everything K6 runs with for this geometry on the current device: the
// tile (jb x cc rows, bn columns), the row padding, the copy widths, the
// split of the positions and the grid.
cudaError_t wgrad_config(const void* inp, const void* g, long long i_n, int i_h, int i_w,
                         int i_c, int k_h, int k_w, int k_c, int s_h, int s_w, int o_h,
                         int o_w, WLaunch* L) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;

  WParams& p = L->p;
  p = WParams{};
  p.i_h = i_h; p.i_w = i_w; p.i_c = i_c; p.k_h = k_h; p.k_w = k_w; p.k_c = k_c;
  p.s_h = s_h; p.s_w = s_w; p.o_h = o_h; p.o_w = o_w;
  p.P = i_n * o_h * (long long)o_w;
  p.stages = ceil_div(p.P, kBK);
  p.dw_elems = (long long)k_h * k_w * i_c * k_c;
  // rows: a chunk of up to 32 channels for every kernel column, unless
  // that takes more warps than a CTA has; columns: 64 output channels, 32
  // where the rows take more than half the warps.  The chunk halves while
  // the ring does not fit the opt-in shared memory (wide strides stage
  // many columns a stage).
  for (p.cc = i_c < 32 ? i_c : 32;; p.cc = (p.cc + 1) / 2) {
    p.ncc = (int)ceil_div(i_c, p.cc);
    const int wm_all = (int)ceil_div((long long)k_w * p.cc, kWarpM);
    const int wn = k_c > kWarpN && 2 * wm_all <= kMaxWarps ? 2 : 1;
    p.bn = wn * kWarpN;
    p.jb = k_w;
    if (wm_all * wn > kMaxWarps) p.jb = (kMaxWarps / wn) * kWarpM / p.cc;
    p.njb = (int)ceil_div(k_w, p.jb);
    p.m_rows = p.jb * p.cc;
    p.wm = (int)ceil_div(p.m_rows, kWarpM);
    p.nkb = (int)ceil_div(k_c, p.bn);
    p.vin = p.cc % 4 == 0 ? copy_width((long long)i_c * 4, inp) : 4;
    p.vg = copy_width((long long)k_c * 4, g);
    const int gpc = (p.cc + p.vin / 4 - 1) / (p.vin / 4);
    p.lgc = -1;
    for (int l = 0; l <= 5; ++l)
      if ((1 << l) == gpc) p.lgc = l;
    p.lgr = 0;
    while ((1 << p.lgr) * (p.vg / 4) < p.bn) ++p.lgr;
    p.cols_f = (o_w - 1) * s_w + p.jb;
    p.inv_ow = 1.0f / (float)o_w;
    p.inv_oh = 1.0f / (float)o_h;
    p.inv_cols_f = 1.0f / (float)p.cols_f;
    // columns a stage stages at most: (kBK - R) * s_w + R * jb over the R
    // input rows its positions touch
    int rows_max = 1 + (int)ceil_div(kBK - 1, o_w);
    if (rows_max > kBK) rows_max = kBK;
    long long cols = (long long)(kBK - rows_max) * s_w + (long long)rows_max * p.jb;
    const long long one_row = (long long)(kBK - 1) * s_w + p.jb;
    if (one_row > cols) cols = one_row;
    p.g_ld = p.bn + 8;
    L->threads = 32 * p.wm * wn;
    // the row stride: cc rounded to the copy width, then padded (by
    // 4-float steps) to the fewest bank conflicts the ring has room for
    const int base = p.vin == 16 ? (p.cc + 3) / 4 * 4 : p.cc;
    int best = 1 << 30;
    L->smem = 0;
    for (int pad = 0; pad <= 28 && best > 1; pad += 4) {
      const int ldc = base + pad;
      const long long in = (cols * ldc + 3) / 4 * 4;
      const long long zero = ((long long)p.jb * ldc + 3) / 4 * 4;
      const long long words = zero + kRing * (in + (long long)kBK * p.g_ld);
      const size_t smem = sizeof(float) * (size_t)words + sizeof(int) * kRing * kBK;
      const int c = conflicts(ldc, s_w);
      if (smem <= (size_t)optin && words <= 0x7fffffffLL && c < best) {
        best = c;
        p.ldc = ldc;
        p.in_elems = (int)in;
        p.zero_elems = (int)zero;
        L->smem = smem;
      }
    }
    if (L->smem > 0) break;
    if (p.cc == 1) return cudaErrorInvalidValue;
  }
  p.stage_elems = p.in_elems + kBK * p.g_ld;

  const int one_j = p.cc % kWarpM == 0;
  L->kern = one_j ? wgrad_kernel<true> : wgrad_kernel<false>;
  // the dynamic shared memory each instance may use, raised only when a
  // launch needs more than before (per device)
  static size_t allowed[2][kMaxDevices];
  if (L->smem > allowed[one_j][dev]) {
    err = cudaFuncSetAttribute(L->kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L->smem);
    if (err != cudaSuccess) return err;
    allowed[one_j][dev] = L->smem;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, L->kern, L->threads, L->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  L->per_sm = per_sm;
  L->sms = sms;

  // The split: the fewest whose CTAs fill 90% of the card's slots in
  // their last wave, else the fullest, each split keeping kMinStages
  // stages.  Fewer splits, longer runs a CTA and less workspace.
  p.tiles = (long long)k_h * p.njb * p.ncc * p.nkb;
  const long long slots = (long long)per_sm * sms;
  p.splits = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= kMaxSplits; ++s) {
    if (s > 1 && p.stages / s < kMinStages) break;
    const long long ctas = p.tiles * s;
    const double fill = (double)ctas / (double)(ceil_div(ctas, slots) * slots);
    if (fill > best_fill) {
      best_fill = fill;
      p.splits = s;
    }
    if (fill >= 0.9) break;
  }
  if (p.tiles * p.splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Sizes the kernel takes: each in int, the windows inside the input, and
// the positions (n * o_h * o_w) in int.
bool wgrad_dims_ok(long long i_n, long long i_h, long long i_w, long long i_c,
                   long long k_h, long long k_w, long long k_c, long long s_h,
                   long long s_w, long long o_h, long long o_w) {
  for (long long d : {i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w})
    if (d < 1 || d > 0x7fffffffLL) return false;
  return (o_h - 1) * s_h + k_h <= i_h && (o_w - 1) * s_w + k_w <= i_w &&
         i_n * o_h * o_w <= 0x7fffffffLL;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, loaded with ctypes from the library mec_conv.cu's entries
// (mec_error_string among them) are built into.  Pointers and the stream are
// void*, every size is a long long; each entry returns a cudaError_t.
// ---------------------------------------------------------------------------
extern "C" {

// What mec_wgrad launches for this geometry on the current device, with
// 16-byte-aligned operands; it launches nothing.  out[0..11] = channel
// chunk, row stride (floats), kernel columns a CTA, output channels a CTA,
// warps along M, threads, shared memory bytes, CTAs an SM holds, splits,
// tiles, workspace floats (0 without a split), stages.
int mec_wgrad_config(long long i_n, long long i_h, long long i_w, long long i_c,
                     long long k_h, long long k_w, long long k_c, long long s_h,
                     long long s_w, long long o_h, long long o_w, long long* out) {
  if (!wgrad_dims_ok(i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w))
    return cudaErrorInvalidValue;
  WLaunch L;
  const cudaError_t err =
      wgrad_config(nullptr, nullptr, i_n, (int)i_h, (int)i_w, (int)i_c, (int)k_h, (int)k_w,
                   (int)k_c, (int)s_h, (int)s_w, (int)o_h, (int)o_w, &L);
  if (err != cudaSuccess) return err;
  const WParams& p = L.p;
  const long long vals[12] = {p.cc, p.ldc, p.jb, p.bn, p.wm, L.threads, (long long)L.smem,
                              L.per_sm, p.splits, p.tiles,
                              p.splits > 1 ? p.splits * p.dw_elems : 0, p.stages};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return cudaSuccess;
}

// dW (k_h, k_w, i_c, k_c) from I (n, i_h, i_w, i_c) and G (n, o_h, o_w, k_c),
// all f32; ws holds ws_floats floats, at least mec_wgrad_config's workspace
// (none without a split).
int mec_wgrad(const void* inp, const void* g, void* ws, void* out, long long ws_floats,
              long long i_n, long long i_h, long long i_w, long long i_c, long long k_h,
              long long k_w, long long k_c, long long s_h, long long s_w, long long o_h,
              long long o_w, void* stream) {
  if (!wgrad_dims_ok(i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w))
    return cudaErrorInvalidValue;
  WLaunch L;
  cudaError_t err = wgrad_config(inp, g, i_n, (int)i_h, (int)i_w, (int)i_c, (int)k_h,
                                 (int)k_w, (int)k_c, (int)s_h, (int)s_w, (int)o_h, (int)o_w,
                                 &L);
  if (err != cudaSuccess) return err;
  WParams& p = L.p;
  if (p.splits > 1 && (ws == nullptr || ws_floats < p.splits * p.dw_elems))
    return cudaErrorInvalidValue;
  p.inp = static_cast<const float*>(inp);
  p.g = static_cast<const float*>(g);
  p.dst = static_cast<float*>(p.splits > 1 ? ws : out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.tiles * p.splits));
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, L.kern, p);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long blocks = ceil_div(p.dw_elems, kSumThreads);
  const long long grid = blocks < 4LL * L.sms ? blocks : 4LL * L.sms;
  cudaLaunchConfig_t sum = {};
  sum.gridDim = dim3((unsigned)grid);
  sum.blockDim = dim3(kSumThreads);
  sum.stream = st;
  err = cudaLaunchKernelEx(&sum, wgrad_sum_kernel, static_cast<const float*>(ws),
                           static_cast<float*>(out), p.dw_elems, p.splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
