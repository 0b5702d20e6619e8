// The tensor-core core of K1 (fused_kernel), K4 (fused2_kernel) and K3
// (gemm_kernel, which runs it on L read as an image): one
// CTA computes an output sub-tile of tr output rows x tc output columns
// (M = tr*tc <= BM positions) by 64 output channels, as a sum over
// reduction steps.  Included by mec_conv.cu; the design notes head that
// file.
//
// A reduction step s is one kernel row r and, on the channel path, one
// chunk of cc input channels (s = r*nchunk + chunk):
//   channel path (i_c > 16):  A[m, (j, c)] = I[n, (h0+dr)*s_h + r, (w0+dc)*s_w + j, c0 + c]
//                             B[(j, c), k] = K[r, j, c0 + c, k0 + k]
//   compact path (i_c <= 16): A[m, q] = I-row[(w0+dc)*s_w*i_c + q],  q < k_w*i_c
//                             B[q, k]   = K[r][q, k0 + k]
// with m = dr*tc + dc.  Per step the CTA stages, for each of its tr output
// rows, the input row it needs (the columns its tc positions span, the
// chunk's channels) and the kernel slab B, in the input dtype, into one
// slot of a ring of kStages buffers with cp.async; the loads of step s+2
// are in flight while step s runs on the tensor cores.  A is never built:
// each lane points ldmatrix (channel path) or its scalar loads (compact
// path, whose rows are not 16-byte aligned) at its own position's window
// in the staged rows.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mec_mma {

constexpr int kBN = 64;                 // output channels per CTA
constexpr int kBNP = kBN + 8;           // staged B row, elements: 16 B of pad
constexpr int kStages = 3;              // cp.async ring
constexpr int kMaxBM = 128;             // output positions per CTA sub-tile

// Everything the kernel needs, computed once by the launcher
// (mec_conv.cu mma_config).
struct Params {
  const void* inp;
  const void* ker;
  void* out;
  int i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w;
  int n_hblk, oh_blk, w_blk;  // the CTA's block: oh_blk rows x w_blk columns
  int tr, tc;                 // its sub-tile: tr rows x tc columns
  int compact;                // 1: reduce over the k_w*i_c run of a row
  int cc;                     // channels a chunk; compact: kp
  int nchunk;                 // channel chunks (compact: 1)
  int ccp;                    // channel path: staged channels a column
  int span;                   // channel path: staged columns a row
  int run;                    // compact path: staged elements a row
  int kwic;                   // k_w * i_c
  int in_elems, k_elems;      // one stage: input rows, kernel slab
  int vin, vk;                // copy width in bytes: 16/8/4 cp.async, 2 plain
  // channel path, for index arithmetic without divisions: cc = 1 << lcc;
  // an input column is 1 << lgc copies; (threads >> lgc) columns =
  // col_rows staged rows + col_rem columns; a kernel row is 1 << lgk copies
  int lcc, lgc, col_rows, col_rem, lgk;
  int base_mis;               // compact path: misalignment of inp, elements
  int split;                  // CTAs of a cluster splitting the reduction
  // 1 (K3): the output is (n, o_w, o_h, k_c), the core's h and w swapped;
  // 0 (K1, K4): NHWC.  (A flag, not three output strides: the strided
  // address cost K1 4% on the Table-3 stack, tools/mma_probe.py.)
  int swap_hw;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `width` bytes from src to shared dst, reading only the first
// `valid` bytes and zero-filling the rest (valid = 0 reads nothing).
__device__ __forceinline__ void copy_granule(void* dst, const void* src, int width,
                                             int valid) {
  const uint32_t d = smem_addr(dst);
  if (width == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid)
                 : "memory");
  } else if (width == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid)
                 : "memory");
  } else if (width == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid)
                 : "memory");
  } else {   // 2-byte elements at odd offsets: cp.async takes 4 bytes at least
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : 0;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// cvt.rna.tf32.f32: round to the 10-bit TF32 mantissa, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo TF32: the three-product split's operands.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&d)[4],
                                                         const uint32_t (&a)[4],
                                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The output's one rounding, f32 to the input dtype.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// MMA depth in elements: k8 for TF32, k16 for bf16/f16.
template <typename T> struct Depth { static constexpr int value = 16; };
template <> struct Depth<float> { static constexpr int value = 8; };

// ---------------------------------------------------------------------------
// Staging one reduction step into one ring slot
// ---------------------------------------------------------------------------
// Element offset of input pixel (n, row, col), channel 0.
__device__ __forceinline__ int64_t pixel(const Params& p, int64_t n, int row, int col) {
  return ((n * p.i_h + row) * (int64_t)p.i_w + col) * p.i_c;
}

// Compact path: the staged copy of a row starts `shift` elements before
// the row's first element, at a 16-byte-aligned address.
template <typename T>
__device__ __forceinline__ int row_shift(const Params& p, int64_t g0) {
  constexpr int kVec = 16 / (int)sizeof(T);
  return (int)((uint64_t)(p.base_mis + g0) % kVec);
}

template <typename T, int NTH>
__device__ void stage_load(const Params& p, T* s_in, T* s_k, int step, int64_t n, int h0,
                           int w0, int k0) {
  constexpr int kE = sizeof(T);
  const T* inp = static_cast<const T*>(p.inp);
  const T* ker = static_cast<const T*>(p.ker);
  const int r = step / p.nchunk;
  const int c0 = (step - r * p.nchunk) * p.cc;

  if (p.compact) {
    constexpr int kVec = 16 / kE;
    const int gran = p.run / kVec;               // granules a staged row
    const int col0 = w0 * p.s_w;
    const int real = min(((p.tc - 1) * p.s_w + p.k_w) * p.i_c, (p.i_w - col0) * p.i_c);
    for (int e = threadIdx.x; e < p.tr * gran; e += NTH) {
      const int dr = e / gran;
      const int t = (e - dr * gran) * kVec;
      const int grow = (h0 + dr) * p.s_h + r;
      const int64_t g0 = pixel(p, n, min(grow, p.i_h - 1), col0);
      const int shift = row_shift<T>(p, g0);
      const int len = grow < p.i_h ? real : 0;
      const int valid = max(0, min(kVec, shift + len - t)) * kE;
      const T* src = valid ? inp + (g0 - shift + t) : inp;
      copy_granule(s_in + dr * p.run + t, src, 16, valid);
    }
    // B: K[r] rows q < kwic, zero rows up to kp
    const int vpe = p.vk / kE > 0 ? p.vk / kE : 1;
    const int per_row = kBN / vpe;
    const T* k_r = ker + (int64_t)r * p.kwic * p.k_c;
    for (int e = threadIdx.x; e < p.cc * per_row; e += NTH) {
      const int q = e / per_row;
      const int kk = (e - q * per_row) * vpe;
      const bool ok = q < p.kwic && k0 + kk < p.k_c;
      const T* src = ok ? k_r + (int64_t)q * p.k_c + k0 + kk : ker;
      copy_granule(s_k + q * kBNP + kk, src, p.vk, ok ? p.vk : 0);
    }
    return;
  }

  // Channel path: tr rows x span columns x cc channels, column stride ccp.
  // Each thread keeps one channel granule and walks the (row, column)
  // pairs NTH >> lgc apart, so the loop divides nothing.
  {
    const int vpe = p.vin / kE > 0 ? p.vin / kE : 1;
    const int gc = threadIdx.x & ((1 << p.lgc) - 1);
    const int c = gc * vpe;
    const bool c_ok = c0 + c < p.i_c;
    const int col0 = w0 * p.s_w;
    int rc = threadIdx.x >> p.lgc;
    int dr = rc / p.span;
    int col = rc - dr * p.span;
    while (dr < p.tr) {
      const int grow = (h0 + dr) * p.s_h + r;
      const int gcol = col0 + col;
      const bool ok = c_ok && grow < p.i_h && gcol < p.i_w;
      const T* src = ok ? inp + pixel(p, n, grow, gcol) + c0 + c : inp;
      copy_granule(s_in + (dr * p.span + col) * p.ccp + c, src, p.vin, ok ? p.vin : 0);
      col += p.col_rem;
      dr += p.col_rows;
      if (col >= p.span) {
        col -= p.span;
        ++dr;
      }
    }
  }
  // Kernel slab: k_w*cc rows of 64 channels; each thread keeps one
  // granule of a row and walks rows NTH >> lgk apart.
  {
    const int vpe = p.vk / kE > 0 ? p.vk / kE : 1;
    const int kk = (threadIdx.x & ((1 << p.lgk) - 1)) * vpe;
    const bool k_ok = k0 + kk < p.k_c;
    const T* k_r = ker + (int64_t)r * p.kwic * p.k_c + k0 + kk;
    const int rows = p.k_w << p.lcc;
    for (int jc = threadIdx.x >> p.lgk; jc < rows; jc += NTH >> p.lgk) {
      const int j = jc >> p.lcc;
      const int c = jc & (p.cc - 1);
      const bool ok = k_ok && c0 + c < p.i_c;
      const T* src = ok ? k_r + ((int64_t)j * p.i_c + c0 + c) * p.k_c : ker;
      copy_granule(s_k + jc * kBNP + kk, src, p.vk, ok ? p.vk : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// Fragments.  Lane l: g = l / 4, t = l % 4 (PTX ISA, mma.m16n8k16 / m16n8k8).
// A (16 x depth, row-major): bf16 a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; tf32 a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4].  ldmatrix.x4 delivers exactly these
// when lane l points at row (l % 8) + 8 * ((l / 8) % 2), 16 bytes into the
// row times (l / 16).
// ---------------------------------------------------------------------------
// The compact path's A rows: lane columns at or past `lim` (= k_w*i_c
// less the k-step's depth offset) lie past the window, where B's rows are
// zero; they read as zero, so a non-finite input there cannot reach an
// output whose window does not hold it.
template <typename T>
__device__ __forceinline__ void load_a_scalar(uint32_t (&a)[4], const T* row_g,
                                              const T* row_g8, int t, int lim);

template <>
__device__ __forceinline__ void load_a_scalar<float>(uint32_t (&a)[4], const float* row_g,
                                                     const float* row_g8, int t, int lim) {
  a[0] = t < lim ? __float_as_uint(row_g[t]) : 0u;
  a[1] = t < lim ? __float_as_uint(row_g8[t]) : 0u;
  a[2] = t + 4 < lim ? __float_as_uint(row_g[t + 4]) : 0u;
  a[3] = t + 4 < lim ? __float_as_uint(row_g8[t + 4]) : 0u;
}

// Elements i and i+1 of a 16-bit row, packed; those at or past lim as 0.
template <typename T>
__device__ __forceinline__ uint32_t pack2(const T* p, int i, int lim) {
  const uint16_t* q = reinterpret_cast<const uint16_t*>(p + i);
  return (i < lim ? (uint32_t)q[0] : 0u) | (i + 1 < lim ? (uint32_t)q[1] << 16 : 0u);
}

template <typename T>
__device__ __forceinline__ void load_a_scalar(uint32_t (&a)[4], const T* row_g,
                                              const T* row_g8, int t, int lim) {
  a[0] = pack2(row_g, 2 * t, lim);
  a[1] = pack2(row_g8, 2 * t, lim);
  a[2] = pack2(row_g, 2 * t + 8, lim);
  a[3] = pack2(row_g8, 2 * t + 8, lim);
}

// One k-step's raw fragments: A per m tile (a0..a3), B per n tile (b0, b1).
template <int MT, int NT>
struct Frags {
  uint32_t a[MT][4];
  uint32_t b[NT][2];
};

// Load the fragments of k-step (j, kk) from a stage: A from the lane's
// window rows (ldmatrix on the channel path, scalar loads on the compact
// path), B from the kernel slab (ldmatrix.trans for 16-bit types; scalar
// loads for f32, whose B fragment is k-major).
template <typename T, int MT, int NT>
__device__ __forceinline__ void load_frags(Frags<MT, NT>& f, const Params& p, const T* s_in,
                                           const T* s_k, const int (&a_off)[MT],
                                           const int (&c_off)[MT][2], int j, int kk, int wn,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (p.compact)
      load_a_scalar<T>(f.a[mt], s_in + c_off[mt][0] + kk, s_in + c_off[mt][1] + kk, t,
                       p.kwic - kk);
    else
      ldsm_x4(f.a[mt], s_in + a_off[mt] + j * p.ccp + kk);
  }
  const T* b_base = s_k + (j * p.cc + kk) * kBNP + wn * NT * 8;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      f.b[nt][0] = __float_as_uint(b_base[t * kBNP + nt * 8 + g]);
      f.b[nt][1] = __float_as_uint(b_base[(t + 4) * kBNP + nt * 8 + g]);
    }
  } else {
    const int ld_row = (lane % 8) + 8 * ((lane / 8) % 2);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];   // r[0], r[1]: n tile 2np; r[2], r[3]: 2np + 1
      ldsm_x4_trans(r, b_base + ld_row * kBNP + np * 16 + (lane / 16) * 8);
      f.b[2 * np][0] = r[0];
      f.b[2 * np][1] = r[1];
      f.b[2 * np + 1][0] = r[2];
      f.b[2 * np + 1][1] = r[3];
    }
  }
}

// One f32 k-step as three TF32 products, small terms first (lo*hi, hi*lo,
// then hi*hi); each product sweeps all MT x NT tiles before the next, so
// consecutive MMAs never wait on one another's accumulator.  Each lo half
// is made just before its products and dies with them (register pressure).
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&part)[MT][NT][4], const Frags<MT, NT>& f) {
  uint32_t a_hi[MT][4], b_hi[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) b_hi[nt][i] = to_tf32(__uint_as_float(f.b[nt][i]));
  {
    uint32_t a_lo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(f.a[mt][i], a_hi[mt][i], a_lo[mt][i]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(part[mt][nt], a_lo[mt], b_hi[nt][0], b_hi[nt][1]);
  }
  {
    uint32_t b_lo[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        b_lo[nt][i] = to_tf32(__uint_as_float(f.b[nt][i]) - __uint_as_float(b_hi[nt][i]));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(part[mt][nt], a_hi[mt], b_lo[nt][0], b_lo[nt][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(part[mt][nt], a_hi[mt], b_hi[nt][0], b_hi[nt][1]);
}

// acc += part; part = 0: a TF32 partial sum into the f32 sum, IEEE adds.
template <int MT, int NT>
__device__ __forceinline__ void add_part(float (&acc)[MT][NT][4], float (&part)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] += part[mt][nt][i];
        part[mt][nt][i] = 0.f;
      }
}

// ---------------------------------------------------------------------------
// The core
// ---------------------------------------------------------------------------
template <typename T, int MT, int NT, int WM, int WN>
__device__ __forceinline__ void mma_core(const Params& p) {
  constexpr int NTH = 32 * WM * WN;
  static_assert(WN * NT * 8 == kBN, "warp layout");
  constexpr int kDepth = Depth<T>::value;
  constexpr bool kTF32 = sizeof(T) == 4;
  constexpr int kVec = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = p.in_elems + p.k_elems;

  namespace cg = cooperative_groups;
  const int rank = p.split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  // 32-bit: grid x < 2^31 (a 64-bit division would be a call)
  const unsigned bx = blockIdx.x / (unsigned)p.split;
  const unsigned bn = bx / (unsigned)p.n_hblk;
  const int64_t n = bn;
  const int h_beg = (int)(bx - bn * (unsigned)p.n_hblk) * p.oh_blk;
  const int h_end = min(h_beg + p.oh_blk, p.o_h);
  const int w_beg = blockIdx.y * p.w_blk;
  const int w_end = min(w_beg + p.w_blk, p.o_w);
  const int k0 = blockIdx.z * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int steps = p.k_h * p.nchunk;
  const int s_beg = rank * steps / p.split;
  const int s_end = (rank + 1) * steps / p.split;
  const int tile = p.tr * p.tc;
  // the lane's ldmatrix row within an m16 tile, and its 16-byte column
  const int ld_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int ld_col = (lane / 16) * kVec;

  for (int h0 = h_beg; h0 < h_end; h0 += p.tr) {
    for (int w0 = w_beg; w0 < w_end; w0 += p.tc) {
      // Channel path: the lane's A row offsets in a stage's input rows.
      int a_off[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = (wm * MT + mt) * 16 + ld_row;
        const int dr = m < tile ? m / p.tc : 0;
        const int dc = m < tile ? m - dr * p.tc : 0;
        a_off[mt] = (dr * p.span + dc * p.s_w) * p.ccp + ld_col;
      }
      // acc: the f32 sum.  TF32 only: part, one step's products (k_w*cc/8
      // k-steps of three MMAs; on the compact path one k-step).  The tensor
      // core truncates when it adds into its accumulator; chained over a
      // whole reduction that bias misses the f32 budget, so each step's sum
      // is added to acc with IEEE f32 adds.
      float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = part[mt][nt][q] = 0.f;

#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        if (s_beg + i < s_end) {
          T* slot = smem + i * stage_elems;
          stage_load<T, NTH>(p, slot, slot + p.in_elems, s_beg + i, n, h0, w0, k0);
        }
        cp_async_commit();
      }

      for (int s = s_beg; s < s_end; ++s) {
        cp_async_wait<kStages - 2>();
        __syncthreads();   // step s has landed; every read of step s-1 is done
        {
          const int nxt = s + kStages - 1;
          if (nxt < s_end) {
            T* slot = smem + ((nxt - s_beg) % kStages) * stage_elems;
            stage_load<T, NTH>(p, slot, slot + p.in_elems, nxt, n, h0, w0, k0);
          }
          cp_async_commit();
        }
        const T* s_in = smem + ((s - s_beg) % kStages) * stage_elems;
        const T* s_k = s_in + p.in_elems;

        // Compact path: the lane's scalar A rows g and g+8 of each m tile.
        int c_off[MT][2] = {};
        if (p.compact) {
          const int r = s / p.nchunk;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = (wm * MT + mt) * 16 + g + 8 * hf;
              const int dr = m < tile ? m / p.tc : 0;
              const int dc = m < tile ? m - dr * p.tc : 0;
              const int grow = (h0 + dr) * p.s_h + r;
              const int64_t g0 = pixel(p, n, min(grow, p.i_h - 1), w0 * p.s_w);
              c_off[mt][hf] = dr * p.run + row_shift<T>(p, g0) + dc * p.s_w * p.i_c;
            }
        }
        // The (window column j, depth kk) k-steps of this step, with the
        // next k-step's fragments loaded while this one's MMAs run.  Not
        // for f32 at 8 warps: that keeps two CTAs an SM within 128
        // registers a thread, and the other CTA's warps hide the loads.
        constexpr bool kPrefetch = !(kTF32 && WM * WN == 8);
        const int q_end = (p.compact ? 1 : p.k_w) * (p.cc / kDepth);
        Frags<MT, NT> cur, nxt;
        int j = 0, kk = 0;
        if (kPrefetch)
          load_frags<T, MT, NT>(cur, p, s_in, s_k, a_off, c_off, 0, 0, wn, lane);
        for (int q = 0; q < q_end; ++q) {
          int j_n = j, kk_n = kk + kDepth;
          if (kk_n == p.cc) {
            kk_n = 0;
            ++j_n;
          }
          if (!kPrefetch)
            load_frags<T, MT, NT>(cur, p, s_in, s_k, a_off, c_off, j, kk, wn, lane);
          else if (q + 1 < q_end)
            load_frags<T, MT, NT>(nxt, p, s_in, s_k, a_off, c_off, j_n, kk_n, wn, lane);
          if constexpr (kTF32) {
            mma_3xtf32<MT, NT>(part, cur);
            // the compact path's one step is a whole window (for K3 all of
            // k_h*k_w*i_c): its k-steps go into the sum one by one
            if (p.compact) add_part<MT, NT>(acc, part);
          } else {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_16816<T>(acc[mt][nt], cur.a[mt], cur.b[nt][0], cur.b[nt][1]);
          }
          if (kPrefetch) cur = nxt;
          j = j_n;
          kk = kk_n;
        }
        if constexpr (kTF32) add_part<MT, NT>(acc, part);   // the step is done
      }
      cp_async_wait<0>();
      __syncthreads();   // the ring is free

      if (p.split > 1) {
        // Partial sums through distributed shared memory: every rank but
        // the leader leaves its accumulators in its own shared memory; the
        // leader adds them in rank order (deterministic) and writes O.
        cg::cluster_group cluster = cg::this_cluster();
        float* red = reinterpret_cast<float*>(smem_raw);
        if (rank != 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                red[((mt * NT + nt) * 4 + q) * NTH + threadIdx.x] = acc[mt][nt][q];
        }
        cluster.sync();
        if (rank == 0) {
          for (int src = 1; src < p.split; ++src) {
            const float* rem = cluster.map_shared_rank(red, src);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  acc[mt][nt][q] += rem[((mt * NT + nt) * 4 + q) * NTH + threadIdx.x];
          }
        }
        cluster.sync();   // the leader's reads are done before anyone reuses smem
      }

      if (rank == 0) {
        T* out = static_cast<T*>(p.out);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = (wm * MT + mt) * 16 + g + 8 * hf;
            if (m >= tile) continue;
            const int dr = m / p.tc;
            const int h = h0 + dr;
            const int w = w0 + (m - dr * p.tc);
            if (h >= h_end || w >= w_end) continue;
            T* o = out + (p.swap_hw ? (n * p.o_w + w) * (int64_t)p.o_h + h
                                    : (n * p.o_h + h) * (int64_t)p.o_w + w) * p.k_c;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int k = k0 + wn * NT * 8 + nt * 8 + 2 * t;
              if (k < p.k_c) o[k] = from_f32<T>(acc[mt][nt][2 * hf]);
              if (k + 1 < p.k_c) o[k + 1] = from_f32<T>(acc[mt][nt][2 * hf + 1]);
            }
          }
      }
    }
  }
}

}  // namespace mec_mma
