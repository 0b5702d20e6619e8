// MEC convolution kernels for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Four kernels, each the Hopper counterpart of a Pallas TPU kernel in
// src/repro/kernels/mec_conv.py.  Notation: I is (n, i_h, i_w, i_c), already
// padded; K is (k_h, k_w, i_c, k_c), and K[r] is kernel row r as a
// (k_w*i_c, k_c) matrix; O is (n, o_h, o_w, k_c); L is MEC's compact lowered
// matrix (n, o_w, i_h, k_w*i_c) (paper Eq. 3).  Inputs are f32, bf16 or f16;
// every sum is kept in f32 and the output is written once, in the input
// dtype.
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
//   mec_gemm   <- mec_gemm_pallas / _gemm_kernel          (K3)
//     O[n, h] = L[n, :, h*s_h*k_w*i_c : +k_h*k_w*i_c] @ K, the paper's
//     ld-aliasing: the k_h shifted rows of L form one contiguous window per
//     output column w.  That is a convolution: read L, which is contiguous
//     (n, o_w, i_h, k_w*i_c), as an NHWC image I' of height o_w, width i_h
//     and k_w*i_c channels, and kernel_mat (k_h, k_w*i_c, k_c) as the HWIO
//     kernel K' (1, k_h, k_w*i_c, k_c); then
//       O[n, h, w, k] = sum_{r, q} L[n, w, h*s_h + r, q] K[r, q, k]
//                     = conv(I', K', stride (1, s_h))[n, w, h, k],
//     so K3 runs the K1/K4 core below on I' and K' with the output's two
//     spatial axes swapped as it writes (no transpose pass): the k_h
//     overlapping windows of one L row are the k_w' = k_h columns of a
//     window in I', staged once per channel chunk, ldmatrix pointed at
//     the overlapping windows in shared memory.  Bound by operations at the
//     paper's widths, like K1 and K4.  A tile row of the core is one output
//     column w and a tile column one output row h, so K4's row stacking
//     fills the MMA tile on narrow layers (cv12: 5 x 5 outputs, cv11:
//     10 x 12) and stages the kernel slab once for all of them, not once
//     for each output row.  L's k_w*i_c channels need not be a power of
//     two (cv4: 448): the last chunk's channels past k_w*i_c are
//     zero-filled in both A and B, and for k_w*i_c <= 16 the core's compact
//     path reduces over the k_h*k_w*i_c run of an L row in one step.
//
//   mec_fused  <- mec_conv_fused_pallas / _fused_kernel   (K1)
//     O[n, h, w-block] = sum_r strip(I[n, h*s_h + r]) @ K[r], with the
//     lowering done in shared memory, so L never exists in device memory.
//     MEC's row-strip form: one CTA per (n, output row, w-block, k_c tile),
//     the TPU grid's (n, h, w); the CTA's tile is 1 row x up to 128 columns.
//   mec_fused2 <- mec_conv_fused2_pallas / _fused2_kernel (K4)
//     The same O, h-blocked: a CTA owns (n, block of oh_blk output rows,
//     w-block, k_c tile) and walks it in tr x tc sub-tiles (tr <= 16 rows,
//     tr*tc <= 128 positions), so narrow layers (cv11: o_w = 12, cv12: 5)
//     stack rows into one MMA tile.  The TPU kernel's halo (a second
//     BlockSpec view of block h+1, wrong when the halo outruns one block:
//     fault F1) has no counterpart: each step stages the input rows its
//     output rows need, so any k_h, s_h (k_h < s_h included) is exact.
//
// K1, K4 and K3 share one device core, mec_mma.cuh: K1 and K4 differ only
// in the tile the launcher gives the CTA, K3 in its operands (above).
// What bounds them: at the paper's widths, operations; on the card, the
// tensor cores' rate for the design's own arithmetic (below), then the
// shared-memory and L2 traffic of restaging the kernel slab for every
// tile.  What the core does about it:
//   - Tensor cores, f32 accumulators in registers.  bf16/f16:
//     mma.sync.m16n8k16.  f32: mma.sync.m16n8k8 in TF32 with three products
//     a multiply-add, hi*hi + hi*lo + lo*hi, hi = cvt.rna.tf32(x), lo =
//     cvt.rna.tf32(x - hi), split as fragments are loaded.  One TF32 product
//     misses the f32 contract (1e-6 * sqrt(K/27), numerics.py) by ~36x; the
//     split keeps errors near 1e-7 scaled.  The tensor core truncates when it
//     adds into its accumulator, which chained over a whole reduction
//     missed the budget on the card (cv11: 1.6e-5 against 9.2e-6), so each
//     reduction step's three-product sum is kept apart and added to the f32
//     sum with IEEE adds (cv11 then reads 4e-7); on the compact path, whose
//     one step spans a whole window, each k-step's.  wgmma is not used: its
//     canonical shared-memory layouts do not take MEC's strided,
//     overlapping windows without a copy, which is the lowering MEC avoids.
//   - The lowering stays in shared memory.  A reduction step is a kernel
//     row r and a chunk of cc input channels: the CTA stages, per output row
//     of its tile, the input row it needs (the columns its positions span,
//     the chunk's channels, a column every cc + 16 B so ldmatrix is
//     conflict-free) and the slab K[r, :, chunk, 64 channels], in the input
//     dtype.  A is the strided window view: each lane points ldmatrix at its
//     own position's window, so the lowered strip reaches the MMA fragments
//     without being written anywhere.  For i_c <= 16 (cv1-cv3, cv7) the
//     step reduces over the contiguous k_w*i_c run of a row, the compact-L
//     row, staged from a 16-byte boundary (rows there are not 16-byte
//     aligned, so A comes by scalar loads), not over channel chunks padded
//     to the MMA depth.  The run is padded to the MMA depth with the next
//     columns' inputs; A reads those as zero, so a non-finite input reaches
//     only the outputs whose windows hold it.
//   - A 3-stage cp.async ring: the loads of step s+2 are in flight while
//     step s runs, and the next k-step's fragments load during this one's
//     MMAs.  Copies are 16 bytes where i_c*elem and the base allow, else 8
//     or 4; 2-byte types with odd i_c on the channel path copy 2 bytes with
//     plain loads (a launch configuration of the same kernel).  Index
//     arithmetic in the copy loops has no divisions.  Shared memory aims at
//     two CTAs an SM (113 KB each); the chunk shrinks to fit.
//   - Tiles of 16/32/64 positions x 64 channels take 4 warps (16x16 to
//     32x32 each); 128 positions take 8 warps of 32 x 32 and are held to
//     128 registers a thread, two CTAs an SM.
//   - Where the tile grid is short of the SMs (cv11 and cv12 at batch 16 in
//     K4, most layers at batch 1), the S <= 4 CTAs of a thread-block cluster
//     each take 1/S of the (r, chunk) steps of one tile; the leader adds the
//     others' partial sums through distributed shared memory
//     (cluster.map_shared_rank) in rank order and writes O.  No split-K
//     workspace in device memory; two runs give equal bits.
// The ragged edges (last w-block and h-block, k_c off the 64-channel tile,
// the last channel chunk) are zero-filled by the copies, never padded in
// device memory; offsets into I, K and O are 64-bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mec_mma.cuh"

namespace {

constexpr int kThreads = 256;        // K2
// K1/K3/K4 (mec_mma.cuh): the row-stacked sub-tile limits of K4 and K3,
// and the shared memory a CTA aims at, so that two CTAs fit an SM's 228 KB
// (1 KB each reserved).
constexpr int kFused2MaxPos = mec_mma::kMaxBM;   // output positions
constexpr int kFused2MaxRows = 16;               // output rows
constexpr size_t kMmaSmem = 113 * 1024;
constexpr int kMaxSplit = 4;                     // CTAs a cluster

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };
// Which kernel a core launch is (the number the C interface uses too).
enum Kind { kK1 = 1, kK3 = 3, kK4 = 4 };

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
// K1, K4 and K3: the tensor-core MEC conv (csrc/mec_mma.cuh).  All three run
// the same core, as separate kernels so that a profile names them apart.
// K1 and K4 differ in the CTA's output tile, which the launcher sets: K1
// one output row x up to 128 columns, K4 tr rows x tc columns; K3 is K4's
// tiling on L read as the image I' (above), its output written transposed.
// grid = (n * row blocks * split, ceil(o_w / w_blk), ceil(k_c / 64)),
// clusters of `split` CTAs along x (all in the core's terms).
// ---------------------------------------------------------------------------
template <typename T, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, WM * WN == 8 ? 2 : 1)
fused_kernel(const __grid_constant__ mec_mma::Params p) {
  mec_mma::mma_core<T, MT, NT, WM, WN>(p);
}

template <typename T, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, WM * WN == 8 ? 2 : 1)
fused2_kernel(const __grid_constant__ mec_mma::Params p) {
  mec_mma::mma_core<T, MT, NT, WM, WN>(p);
}

template <typename T, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, WM * WN == 8 ? 2 : 1)
gemm_kernel(const __grid_constant__ mec_mma::Params p) {
  mec_mma::mma_core<T, MT, NT, WM, WN>(p);
}

// ---------------------------------------------------------------------------
// Host launchers
// ---------------------------------------------------------------------------
bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

constexpr int kMaxDevices = 64;

// The shared memory a block may opt in to, and the SM count, of the
// current device, read once per device.
cudaError_t device_limits(int* optin, int* sms, int* device = nullptr) {
  static int cached_optin[kMaxDevices], cached_sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[dev] == 0) {
    int o = 0, m = 0;
    err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached_optin[dev] = o;
    cached_sms[dev] = m;
  }
  *optin = cached_optin[dev];
  *sms = cached_sms[dev];
  if (device) *device = dev;
  return cudaSuccess;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return (a + b - 1) / b * b; }

// K4's smallest ring for a tr x tc sub-tile, in bytes: each stage holds
// one MMA depth of channels of the tr staged rows (48 B a column: 8 f32 +
// 16 B of pad, or 16 bf16 + 16 B) and the kernel slab k_w x depth x kBNP
// (2304 B a kernel column), dtype-independent.
size_t fused2_min_ring(long long tr, long long tc, long long k_w, long long s_w) {
  const long long span = (tc - 1) * s_w + k_w;
  return (size_t)mec_mma::kStages * (size_t)(tr * span * 48 + k_w * 2304);
}

// K4's sub-tile of an oh_blk x w_blk block: every row of the block up to
// kFused2MaxRows, then as many columns as keep it within the MMA tile's
// kFused2MaxPos positions.  Halved (columns first) only where the smallest
// ring would not fit the opt-in.  Returns false where not even a 1 x 1
// sub-tile fits.
bool fused2_tile(int oh_blk, int w_blk, int k_w, int s_w, int optin, int* tr_out,
                 int* tc_out) {
  int tr = oh_blk < kFused2MaxRows ? oh_blk : kFused2MaxRows;
  int tc = kFused2MaxPos / tr;
  tc = tc < w_blk ? tc : w_blk;
  while (fused2_min_ring(tr, tc, k_w, s_w) > (size_t)optin && (tr > 1 || tc > 1)) {
    if (tc > 1) tc = (tc + 1) / 2; else tr = (tr + 1) / 2;
  }
  *tr_out = tr;
  *tc_out = tc;
  return fused2_min_ring(tr, tc, k_w, s_w) <= (size_t)optin;
}

// The widest copy (16, 8 or 4 bytes for cp.async; 2 for a plain copy) that
// divides a run of `row_bytes` and the base address.
int copy_width(long long row_bytes, const void* base) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && a % v == 0) return v;
  return 2;
}

// Threads of a CTA for an MMA tile of bm rows: 8 warps for 128 rows, else 4.
int mma_threads(int bm) { return bm == 128 ? 256 : 128; }

struct MmaLaunch {
  mec_mma::Params p;
  int bm;        // MMA tile rows: 16, 32, 64 or 128 positions
  size_t smem;   // dynamic shared memory, bytes
  dim3 grid;
};

// Everything K1, K4 or K3 runs with, in the core's terms (for K3: the
// image I' and kernel K'): the sub-tile, the reduction path and chunk, the
// copy widths, the cluster split, the output's axis order, the shared
// memory and the grid.
cudaError_t mma_config(Kind kind, int elem, const void* inp, const void* ker, void* out,
                       long long i_n, int i_h, int i_w, int i_c, int k_h, int k_w, int k_c,
                       int s_h, int s_w, int o_h, int o_w, int w_blk, int oh_blk,
                       MmaLaunch* L) {
  int optin = 0, sms = 0;
  cudaError_t err = device_limits(&optin, &sms);
  if (err != cudaSuccess) return err;
  mec_mma::Params& p = L->p;
  p = mec_mma::Params{};
  p.inp = inp;
  p.ker = ker;
  p.out = out;
  p.i_h = i_h; p.i_w = i_w; p.i_c = i_c; p.k_h = k_h; p.k_w = k_w; p.k_c = k_c;
  p.s_h = s_h; p.s_w = s_w; p.o_h = o_h; p.o_w = o_w;
  p.w_blk = w_blk;
  if (kind == kK1) {
    p.tr = 1;
    p.tc = w_blk < mec_mma::kMaxBM ? w_blk : mec_mma::kMaxBM;
    p.oh_blk = 1;
  } else {
    if (!fused2_tile(oh_blk, w_blk, k_w, s_w, optin, &p.tr, &p.tc))
      return cudaErrorInvalidValue;
    p.oh_blk = oh_blk;
  }
  p.swap_hw = kind == kK3;   // K3: the core's h is the output's w
  p.n_hblk = (int)ceil_div(o_h, p.oh_blk);
  const int tile = p.tr * p.tc;
  L->bm = tile <= 16 ? 16 : (tile <= 32 ? 32 : (tile <= 64 ? 64 : 128));
  const int threads = mma_threads(L->bm);

  const int depth = elem == 4 ? 8 : 16;   // MMA k: TF32 k8, bf16/f16 k16
  const int vec = 16 / elem;
  p.kwic = k_w * i_c;
  size_t stage = 0;
  if (i_c <= 16) {   // compact path: reduce over the k_w*i_c run
    const int kp = round_up(p.kwic, depth);
    const int real = ((p.tc - 1) * s_w + k_w) * i_c;
    const int run = round_up(vec - 1 + real + kp - p.kwic, vec);
    stage = (size_t)(p.tr * run + kp * mec_mma::kBNP) * elem;
    if (mec_mma::kStages * stage <= (size_t)optin) {
      p.compact = 1;
      p.cc = kp;
      p.nchunk = 1;
      p.run = run;
      p.in_elems = p.tr * run;
      p.k_elems = kp * mec_mma::kBNP;
      p.base_mis = (int)(reinterpret_cast<uintptr_t>(inp) % 16) / elem;
    }
  }
  if (!p.compact) {   // channel path: chunks of cc channels, k_w windows
    p.span = (p.tc - 1) * s_w + k_w;
    auto stage_of = [&](int c) {
      return (size_t)(p.tr * p.span * (c + vec) + k_w * c * mec_mma::kBNP) * elem;
    };
    // cc: a power-of-two multiple of the MMA depth, up to 128 B of
    // channels a column, halved until the ring fits the target
    const int cap = 128 / elem;
    int lcc = 0;
    while ((1 << lcc) < depth) ++lcc;
    while ((1 << lcc) < i_c && (1 << lcc) < cap) ++lcc;
    while ((1 << lcc) > depth && mec_mma::kStages * stage_of(1 << lcc) > kMmaSmem) --lcc;
    const int cc = 1 << lcc;
    stage = stage_of(cc);
    if (mec_mma::kStages * stage > (size_t)optin) return cudaErrorInvalidValue;
    p.cc = cc;
    p.lcc = lcc;
    p.ccp = cc + vec;
    p.nchunk = (i_c + cc - 1) / cc;
    p.in_elems = p.tr * p.span * p.ccp;
    p.k_elems = k_w * cc * mec_mma::kBNP;
    p.vin = copy_width((long long)i_c * elem, inp);
    // copies a column (a power of two), and the column walk's stride
    p.lgc = 0;
    while ((p.vin << p.lgc) < cc * elem) ++p.lgc;
    const int step = threads >> p.lgc;
    p.col_rows = step / p.span;
    p.col_rem = step % p.span;
  }
  p.vk = copy_width((long long)k_c * elem, ker);
  p.lgk = 0;
  while ((p.vk << p.lgk) < mec_mma::kBN * elem) ++p.lgk;

  // Split the reduction over a cluster while the grid is short of eight
  // warps an SM and every rank keeps at least two steps.
  const long long tiles =
      i_n * p.n_hblk * ceil_div(o_w, w_blk) * ceil_div(k_c, mec_mma::kBN);
  const int steps = k_h * p.nchunk;
  p.split = 1;
  while (p.split < kMaxSplit && tiles * p.split * (threads / 32) < 8LL * sms &&
         steps >= 4 * p.split)
    p.split *= 2;

  L->smem = mec_mma::kStages * stage;
  const size_t red = (size_t)threads * 32 * sizeof(float);   // 32 sums a thread
  if (p.split > 1 && L->smem < red) L->smem = red;
  const long long grid_x = i_n * p.n_hblk * p.split;
  const long long grid_y = ceil_div(o_w, w_blk);
  const long long grid_z = ceil_div(k_c, mec_mma::kBN);
  if (!fits_int(grid_x) || grid_y > 65535 || grid_z > 65535) return cudaErrorInvalidValue;
  L->grid = dim3((unsigned)grid_x, (unsigned)grid_y, (unsigned)grid_z);
  return cudaSuccess;
}

template <typename T, int MT, int NT, int WM, int WN>
cudaError_t launch_mma_tile(Kind kind, const MmaLaunch& L, cudaStream_t stream) {
  void (*kern)(mec_mma::Params) = kind == kK1   ? fused_kernel<T, MT, NT, WM, WN>
                                  : kind == kK4 ? fused2_kernel<T, MT, NT, WM, WN>
                                                : gemm_kernel<T, MT, NT, WM, WN>;
  const int k = kind == kK1 ? 0 : (kind == kK4 ? 1 : 2);
  // the dynamic shared memory each kernel may use, raised only when a
  // launch needs more than before (per device)
  static size_t allowed[3][kMaxDevices];
  int optin = 0, sms = 0, dev = 0;
  cudaError_t err = device_limits(&optin, &sms, &dev);
  if (err != cudaSuccess) return err;
  if (L.smem > allowed[k][dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.smem);
    if (err != cudaSuccess) return err;
    allowed[k][dev] = L.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = L.grid;
  cfg.blockDim = dim3(32 * WM * WN);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)L.p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = L.p.split > 1 ? 1 : 0;   // a cluster only where the reduction is split
  err = cudaLaunchKernelEx(&cfg, kern, L.p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Warp layouts (WM x WN warps, each MT m16 x NT n8 tiles) for the four
// MMA tiles: 128 x 64 (8 warps of 32 x 32), 64 x 64 (4 warps of 32 x 32),
// 32 x 64 (16 x 32), 16 x 64 (16 x 16).
template <typename T>
cudaError_t launch_mma(Kind kind, const MmaLaunch& L, cudaStream_t stream) {
  switch (L.bm) {
    case 16: return launch_mma_tile<T, 1, 2, 1, 4>(kind, L, stream);
    case 32: return launch_mma_tile<T, 1, 4, 2, 2>(kind, L, stream);
    case 64: return launch_mma_tile<T, 2, 4, 2, 2>(kind, L, stream);
    default: return launch_mma_tile<T, 2, 4, 4, 2>(kind, L, stream);
  }
}

cudaError_t run_mma(Kind kind, int dtype, const void* inp, const void* ker, void* out,
                    long long i_n, long long i_h, long long i_w, long long i_c,
                    long long k_h, long long k_w, long long k_c, long long s_h,
                    long long s_w, long long o_h, long long o_w, long long w_blk,
                    long long oh_blk, cudaStream_t stream, MmaLaunch* L) {
  const int elem = dtype == kF32 ? 4 : 2;
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16) return cudaErrorInvalidValue;
  cudaError_t err = mma_config(kind, elem, inp, ker, out, i_n, (int)i_h, (int)i_w, (int)i_c,
                               (int)k_h, (int)k_w, (int)k_c, (int)s_h, (int)s_w, (int)o_h,
                               (int)o_w, (int)w_blk, (int)oh_blk, L);
  if (err != cudaSuccess || out == nullptr) return err;
  switch (dtype) {
    case kF32: return launch_mma<float>(kind, *L, stream);
    case kBF16: return launch_mma<__nv_bfloat16>(kind, *L, stream);
    default: return launch_mma<__half>(kind, *L, stream);
  }
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
  MmaLaunch L;
  return run_mma(kK1, dtype, inp, ker, out, i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w,
                 o_h, o_w, w_blk, 1, static_cast<cudaStream_t>(stream), &L);
}

int mec_fused2(const void* inp, const void* ker, void* out, int dtype, long long i_n,
               long long i_h, long long i_w, long long i_c, long long k_h, long long k_w,
               long long k_c, long long s_h, long long s_w, long long o_h, long long o_w,
               long long w_blk, long long oh_blk, void* stream) {
  if (!dims_ok({i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk, oh_blk}) ||
      w_blk > o_w || oh_blk > o_h || (o_h - 1) * s_h + k_h > i_h ||
      (o_w - 1) * s_w + k_w > i_w)
    return cudaErrorInvalidValue;
  MmaLaunch L;
  return run_mma(kK4, dtype, inp, ker, out, i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w,
                 o_h, o_w, w_blk, oh_blk, static_cast<cudaStream_t>(stream), &L);
}

// The tr x tc sub-tile mec_fused2 runs for an oh_blk x w_blk block on the
// current device (what kernels/ops.py pick_oh_blk sizes its blocks by).
int mec_fused2_tile(long long oh_blk, long long w_blk, long long k_h, long long k_w,
                    long long s_h, long long s_w, int* tr, int* tc) {
  if (!dims_ok({oh_blk, w_blk, k_h, k_w, s_h, s_w})) return cudaErrorInvalidValue;
  int optin = 0, sms = 0;
  cudaError_t err = device_limits(&optin, &sms);
  if (err != cudaSuccess) return err;
  return fused2_tile((int)oh_blk, (int)w_blk, (int)k_w, (int)s_w, optin, tr, tc)
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// What mec_fused (kernel = 1), mec_fused2 (kernel = 4) or mec_gemm (kernel
// = 3, given the core's geometry: I' and K' as in the notes above, w_blk
// output rows h and oh_blk output columns w per CTA) would launch for this
// geometry on the current device, with 16-byte-aligned operands; it
// launches nothing.  out[0..9] = tr, tc, MMA tile rows, compact (0/1),
// chunk (channels, or the padded k_w*i_c run), chunks, cluster split,
// shared memory bytes, input copy width, kernel copy width.
int mec_fused_config(int kernel, int dtype, long long i_n, long long i_h, long long i_w,
                     long long i_c, long long k_h, long long k_w, long long k_c,
                     long long s_h, long long s_w, long long o_h, long long o_w,
                     long long w_blk, long long oh_blk, long long* out) {
  if ((kernel != kK1 && kernel != kK3 && kernel != kK4) ||
      !dims_ok({i_n, i_h, i_w, i_c, k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk, oh_blk}) ||
      w_blk > o_w || oh_blk > o_h)
    return cudaErrorInvalidValue;
  MmaLaunch L;
  const cudaError_t err =
      run_mma(static_cast<Kind>(kernel), dtype, nullptr, nullptr, nullptr, i_n, i_h, i_w, i_c,
              k_h, k_w, k_c, s_h, s_w, o_h, o_w, w_blk, kernel == kK1 ? 1 : oh_blk, nullptr, &L);
  if (err != cudaSuccess) return err;
  const mec_mma::Params& p = L.p;
  const long long vals[10] = {p.tr, p.tc, L.bm, p.compact, p.cc, p.nchunk, p.split,
                              (long long)L.smem, p.compact ? 16 : p.vin, p.vk};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return cudaSuccess;
}

// K3: O (n, o_h, o_w, k_c) from L (n, o_w, i_h, kwic) and kernel_mat
// (k_h, kwic, k_c), w_blk output columns w and h_blk output rows h per CTA:
// the core on I' (n, o_w, i_h, kwic) and K' (1, k_h, kwic, k_c), stride
// (1, s_h), whose output (n, o_w, o_h, k_c) is written transposed.
int mec_gemm(const void* low, const void* ker, void* out, int dtype, long long i_n,
             long long o_w, long long i_h, long long kwic, long long k_h, long long k_c,
             long long s_h, long long o_h, long long w_blk, long long h_blk, void* stream) {
  if (!dims_ok({i_n, o_w, i_h, kwic, k_h, k_c, s_h, o_h, w_blk, h_blk, k_h * kwic}) ||
      w_blk > o_w || h_blk > o_h || (o_h - 1) * s_h + k_h > i_h)
    return cudaErrorInvalidValue;
  MmaLaunch L;
  return run_mma(kK3, dtype, low, ker, out, i_n, o_w, i_h, kwic, 1, k_h, k_c, 1, s_h, o_w,
                 o_h, h_blk, w_blk, static_cast<cudaStream_t>(stream), &L);
}

}  // extern "C"
