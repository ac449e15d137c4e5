// Weight gradient of one sparse-band neighbourhood-consensus layer, and the
// hit list that it and the layer's input gradient (csrc/band_gemm_dx.cu)
// read, written by hand for Hopper (sm_90a):
//
//   dw[t, c, o] = sum_{(b, n, m) in hits(t)} x[b, m, c] * gp[b, n, o]
//
// x [B,N,C] is the layer's input entry list, gp [B,N,O] its ReLU-masked
// output cotangent, both cell-major (on the symmetric pass the wrapper
// gathers them out of the pass's B-major order), and hits(t) the (output
// entry n, input entry m) pairs that the forward contracts at tap t:
// entry e = (a, s) with B cell beta reads, at tap t = (dA, dB), the entry
// of A cell a + dA - pA whose B cell is beta + dB - pB, as
// csrc/band_gemm_fwd.cu derives them from the band's sorted indices
// [B,hA,wA,K] (on the symmetric pass the A and B offsets trade roles).
// float32 or bfloat16 in and out, float32 sums rounded once to the
// activation dtype.
//
// Replaces: the dw half of ncnet_tpu/kernels/band_gemm_pallas.py::_bwd
// (:147-180; the linear transpose of band_conv_gemm over a [B, N, T]
// pointer table, XLA on the TPU; the custom VJP of _fused_kernel).
//
// What bounds it on an H100: neither the FLOPs nor the bytes of its
// inputs. At the 400 px PF-Pascal config with a K = 50 band at batch 16
// (B*N = 500,000 entries, T = 625), a training batch's band lands 156.4
// hits on an entry: 78.2 M hits a pass, 2 * 78.2 M * 256 = 40 GFLOP for
// the 16->16 layer (0.04 ms on the bfloat16 tensor cores) against 32 MB
// of bfloat16 x and gp (0.01 ms at HBM speed). What takes the time is
// the list: 626 MB written once a pass (0.19 ms at 3.35 TB/s) and read
// once a layer, and its rows gathered from L2 (32 bytes each, 5 GB a
// 16->16 layer). Measured there by chip_smoke.py (band_train_kernels) on
// an NVIDIA H100 80GB HBM3 at 700 W: the hit list 2.08-2.19 ms a pass,
// dw 1.15-1.24 ms a 16->16 launch (about 4.4 TB/s of row gathers) and
// 0.54-0.68 ms a narrow one.
//
// Design (every sum in a fixed order, no float atomics: two calls are
// bitwise equal; every offset into the list is int64, hit rows b*N + row
// int32):
//   * the hit list, by tap, then output A cell (block), then slot: a
//     counting sort. band_bitmap_kernel writes the band as a bitmap, a row
//     of ceil(hB*wB / 32) words a cell (1/32 of a dense mask; 1.6 MB at
//     the shape above), band_rank_kernel each word's rank, so the slot of
//     B cell beta in cell a is found in O(1): the band is sorted, so the
//     slot is the bit's rank. band_hits_kernel<false> takes a block a
//     range of whole cells (about 1,024 entries) and an A offset, and for
//     each of that offset's taps tests every entry against the bitmap row
//     of its neighbour cell: the hit relation the forward derives from
//     its candidates. It counts each (tap, cell) run through a block-wide
//     scan; scan_rows_kernel turns the counts into offsets within each
//     tap, then across taps (tap_start), and add_tap_start_kernel makes
//     them absolute: offsets[t * nblk + blk] is the first position of run
//     (t, blk), offsets[T * nblk] the list's length. band_hits_kernel<true>
//     derives the hits again and writes them where the same scan puts
//     them: a block's hits at one tap are one contiguous stretch of the
//     list, in entry order, so the stores are coalesced (4-byte stores of
//     single hits into 625 runs a block, scattered over the list, leave
//     more partly written sectors than L2 holds, and the fill becomes
//     bound by them). Every run holds its hits in slot order, as
//     ops/band.py::band_hits_plain lists them, on every call. 8 bytes a
//     hit, no [B, N, T] pointer table; built once a pass and shared by the
//     three layers' dw and the two layers' dx;
//   * the contraction: the list is cut evenly into segments of seg_len
//     hits, one block each (the centre tap holds every entry's hit on
//     itself, 4x an average tap's, so a cut by tap would leave blocks
//     running long after the rest). A segment that spans taps sums each
//     tap's piece apart into partial[s + t] (an injective index: a later
//     segment of a tap never meets an earlier tap), and
//     band_dw_reduce_kernel adds each tap's pieces in segment order and
//     rounds once. The cut needs no host pass: every block finds its
//     taps in tap_start;
//   * bfloat16 at C = O = 16 (band_dw_bf16_tc_kernel) runs on the tensor
//     cores: the sum over a tap is X_t^T [16 x H_t] @ G_t [H_t x 16], a
//     GEMM whose depth is the hits (wgmma's 64-row M does not fit M = C =
//     16). Each warp takes every 8th k-step of 16 hits of a piece, gathers
//     its 16 x rows and 16 gp rows whole (32 bytes, two cp.async each)
//     into a 4-stage shared-memory ring, so the next steps' gathers
//     overlap this step's two mma.sync m16n8k16 (A = the x rows
//     transposed by ldmatrix.trans, B = the gp rows, two n-tiles); the 8
//     warps' sums are added in warp order;
//   * float32, and the narrow bfloat16 layers (C = 1 or O = 1, where a
//     16 x 16 tile would be one-sixteenth used), run on FFMA
//     (band_dw_ffma_kernel): one thread a hit (or a hit and 4 of its
//     outputs), the x and gp rows read whole as vectors, the partial sums
//     in registers, added over lanes by a fixed xor tree, then over warps
//     in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "mma_bf16.cuh"

namespace {

constexpr int kHitWarps = 8;
constexpr int kHitThreads = kHitWarps * 32;
// entries a hit-list block takes: whole cells, as many as fit (one cell
// where K is larger)
constexpr int kBlockEntries = 1024;
constexpr int kMaxKB = 81;  // B offsets of a tap: at most 9 x 9
constexpr int kScanThreads = 1024;
constexpr int kDwWarps = 8;
constexpr int kDwThreads = kDwWarps * 32;
constexpr int kStages = 4;  // cp.async ring of a tensor-core dw warp
constexpr int kMaxC = 16;   // channels the contraction takes, in and out
constexpr int kMaxTaps = 6561;  // 9^4
constexpr unsigned kFull = 0xffffffffu;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;
constexpr int kErrChannels = -5;

struct Band {
  int hA, wA, hB, wB, K;       // grids and band slots per A cell
  int N;                       // hA*wA*K
  int ka_i, ka_j, kb_i, kb_j;  // the pass's A- and B-offset extents
  int swapped;                 // 1: the symmetric pass (offsets trade roles)
  int T;                       // taps
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The band as a bitmap, one row of nw words a cell (b, a): bit beta is set
// where the cell's band holds B cell beta. *flag is set where a cell's
// indices are not strictly ascending or leave [0, nb): the rank of a B
// cell among the set bits is its slot only in a sorted band without
// repeats (as the port's top-K gives it).
__global__ void band_bitmap_kernel(const int* __restrict__ indices,
                                   unsigned* __restrict__ bits,
                                   int64_t* __restrict__ flag, int64_t n,
                                   int K, int nb, int nw) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int beta = indices[i];
  if (beta < 0 || beta >= nb || (i % K != 0 && indices[i - 1] >= beta)) {
    *flag = 1;
    return;
  }
  atomicOr(&bits[(i / K) * nw + (beta >> 5)], 1u << (beta & 31));
}

// rank[c * nw + w] = the set bits of cell c's words before word w.
__global__ void band_rank_kernel(const unsigned* __restrict__ bits,
                                 int* __restrict__ rank, int64_t cells,
                                 int nw) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  int r = 0;
  for (int w = 0; w < nw; ++w) {
    rank[c * nw + w] = r;
    r += __popc(bits[c * nw + w]);
  }
}

// Block (sample b = blockIdx.z, A offset da = blockIdx.y, cells [c0, c1)
// of the sample, CB a block): for the kB taps t of that A offset, kTaps at
// a time, every entry e of the cells (cell-major, in slot order) that
// reads, at t, the entry of cell a + da - pA whose B cell is beta + db -
// pB: a bit of that cell's bitmap row, its slot the bit's rank. A
// block-wide scan numbers the hits in entry order. kFill = false:
// offsets[t * nblk + blk] = the hits of cell blk at t; kFill = true: the
// hits are written from offsets[t * nblk + blk of c0] on, one contiguous
// stretch a tap, in the list's order (tap, cell, slot). A thread keeps
// its (up to kPer) entries' neighbour cell and B cell for every tap; the
// block takes kBlockEntries entries at a time (more than one round only
// where one cell holds more, CB = 1).
template <bool kFill>
__global__ void __launch_bounds__(kHitThreads)
    band_hits_kernel(const int* __restrict__ indices,
                     const unsigned* __restrict__ bits,
                     const int* __restrict__ rank,
                     int64_t* __restrict__ offsets, int* __restrict__ hit_n,
                     int* __restrict__ hit_m, const Band s, int CB, int nw) {
  constexpr int kPer = kBlockEntries / kHitThreads;
  constexpr int kTaps = 2;                   // taps a barrier
  constexpr int kGroups = kPer * kHitWarps;  // 32-entry groups a round
  static_assert(kGroups == 32, "a warp scans the groups, a lane each");
  // double-buffered by parity, so one barrier an iteration suffices
  __shared__ int group_hits[2][kTaps][kGroups];
  __shared__ int cell_start[2][kTaps][kBlockEntries + 1];
  __shared__ int done_tap[kMaxKB];  // a tap's hits of the earlier rounds
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z, da = blockIdx.y;
  const int NA = s.hA * s.wA;
  const int c0 = blockIdx.x * CB, c1 = min(NA, c0 + CB);
  const int e0 = c0 * s.K, e1 = c1 * s.K;
  const bool one_round = e1 - e0 <= kBlockEntries;
  const int64_t nblk = (int64_t)gridDim.z * NA;
  const int64_t base = (int64_t)b * s.N;    // the sample's first row
  const int64_t cells0 = (int64_t)b * NA;   // and first bitmap row
  const int* idx = indices + base;
  const int dai = da / s.ka_j, daj = da - (da / s.ka_j) * s.ka_j;
  const int kA = s.ka_i * s.ka_j, kB = s.kb_i * s.kb_j;
  const unsigned below = (1u << lane) - 1u;
  auto tap_of = [&](int db) { return s.swapped ? db * kA + da : da * kB + db; };
  for (int t = threadIdx.x; t < kB; t += kHitThreads) done_tap[t] = 0;
  __syncthreads();
  int it = 0, prev_db = 0;
  // the counts of the taps from db0 on, from cell_start[buf] (one round)
  auto flush = [&](int db0, int buf) {
    for (int u = 0; u < kTaps && db0 + u < kB; ++u) {
      int64_t* run = offsets + (int64_t)tap_of(db0 + u) * nblk + cells0 + c0;
      for (int i = threadIdx.x; i < c1 - c0; i += kHitThreads)
        run[i] = cell_start[buf][u][i + 1] - cell_start[buf][u][i];
    }
  };
  for (int r0 = e0; r0 < e1; r0 += kBlockEntries) {
    const int r1 = min(e1, r0 + kBlockEntries);
    // the thread's entries e = r0 + j * kHitThreads + tid: the bitmap row
    // of the neighbour cell (-1: off the A grid or past r1), its first
    // entry, and the entry's B cell less the B half-widths
    int64_t nbr[kPer];
    int cellk[kPer], ib[kPer], jb[kPer], loc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = r0 + j * kHitThreads + threadIdx.x;
      nbr[j] = -1;
      cellk[j] = ib[j] = jb[j] = 0;
      loc[j] = -1;  // the cell's index in the block, at its first entry
      if (e < r1) {
        const int a = e / s.K;
        if (e == a * s.K) loc[j] = a - c0;
        const int ia = a / s.wA, ja = a - (a / s.wA) * s.wA;
        const int ia2 = ia + dai - s.ka_i / 2, ja2 = ja + daj - s.ka_j / 2;
        if ((unsigned)ia2 < (unsigned)s.hA && (unsigned)ja2 < (unsigned)s.wA) {
          const int beta = idx[e];
          ib[j] = beta / s.wB - s.kb_i / 2;
          jb[j] = beta - (beta / s.wB) * s.wB - s.kb_j / 2;
          cellk[j] = (ia2 * s.wA + ja2) * s.K;
          nbr[j] = (cells0 + ia2 * s.wA + ja2) * nw;
        }
      }
    }
    for (int db0 = 0; db0 < kB; db0 += kTaps, ++it) {
      const int buf = it & 1;
      bool hit[kTaps][kPer];
      int src[kTaps][kPer], done[kTaps];
      unsigned ballot[kTaps][kPer];
#pragma unroll
      for (int u = 0; u < kTaps; ++u) {
        const int db = db0 + u;
        const bool live = db < kB;
        const int dbi = db / s.kb_j, dbj = db - (db / s.kb_j) * s.kb_j;
        done[u] = live ? done_tap[db] : 0;  // read before thread 0 moves it
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          hit[u][j] = false;
          src[u][j] = 0;
          const int tb_i = ib[j] + dbi, tb_j = jb[j] + dbj;
          if (live && nbr[j] >= 0 && (unsigned)tb_i < (unsigned)s.hB &&
              (unsigned)tb_j < (unsigned)s.wB) {
            const int x = tb_i * s.wB + tb_j;
            const int64_t r = nbr[j] + (x >> 5);
            const unsigned word = bits[r];
            if ((word >> (x & 31)) & 1u) {
              src[u][j] =
                  cellk[j] + rank[r] + __popc(word & ((1u << (x & 31)) - 1u));
              hit[u][j] = true;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kTaps; ++u)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          ballot[u][j] = __ballot_sync(kFull, hit[u][j]);
          if (lane == 0)
            group_hits[buf][u][j * kHitWarps + warp] = __popc(ballot[u][j]);
        }
      __syncthreads();
      if constexpr (!kFill) {
        if (one_round && it > 0) flush(prev_db, buf ^ 1);
      }
#pragma unroll
      for (int u = 0; u < kTaps; ++u) {
        const int db = db0 + u;
        if (db >= kB) break;
        // the groups' exclusive prefix: lane g holds group g's
        const int v = group_hits[buf][u][lane];
        int incl = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += y;
        }
        const int excl = incl - v;
        const int total = done[u] + __shfl_sync(kFull, incl, 31);
        const int64_t first =
            kFill ? offsets[(int64_t)tap_of(db) * nblk + cells0 + c0] : 0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int at = done[u] + __shfl_sync(kFull, excl, j * kHitWarps + warp) +
                         __popc(ballot[u][j] & below);
          if constexpr (kFill) {
            if (hit[u][j]) {
              hit_n[first + at] = (int)(base + r0 + j * kHitThreads + threadIdx.x);
              hit_m[first + at] = (int)(base + src[u][j]);
            }
          } else {
            if (loc[j] >= 0) cell_start[buf][u][loc[j]] = at;
          }
        }
        if (threadIdx.x == 0) {
          cell_start[buf][u][c1 - c0] = total;
          done_tap[db] = total;
        }
      }
      prev_db = db0;
    }
  }
  if constexpr (!kFill) {
    __syncthreads();
    if (one_round) {
      flush(prev_db, (it - 1) & 1);
    } else {  // one cell: its count is the tap's total
      for (int db = threadIdx.x; db < kB; db += kHitThreads)
        offsets[(int64_t)tap_of(db) * nblk + cells0 + c0] = done_tap[db];
    }
  }
}

// Each block's row of `values` (n int64, row blockIdx.x) becomes its
// exclusive prefix sum, in place; the row's total goes to totals[blockIdx.x].
__global__ void __launch_bounds__(kScanThreads)
    scan_rows_kernel(int64_t* __restrict__ values, int64_t* __restrict__ totals,
                     int n) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  int64_t* row = values + (int64_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    const int64_t v = i < n ? row[i] : 0;
    int64_t x = v;  // inclusive within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int64_t y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int64_t excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < n) row[i] = excl;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// offsets[t * nblk + i] += tap_start[t] (row t = blockIdx.y); the last
// element, offsets[T * nblk], becomes the list's length.
__global__ void add_tap_start_kernel(int64_t* __restrict__ offsets,
                                     const int64_t* __restrict__ tap_start,
                                     int nblk, int T) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nblk) offsets[(int64_t)t * nblk + i] += tap_start[t];
  if (t == 0 && i == 0) offsets[(int64_t)T * nblk] = tap_start[T];
}

// The first tap whose hits reach past position p < tap_start[T].
__device__ __forceinline__ int tap_at(const int64_t* __restrict__ tap_start,
                                      int T, int64_t p) {
  int lo = 0, hi = T;  // tap_start[lo] <= p < tap_start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tap_start[mid] <= p) lo = mid;
    else hi = mid;
  }
  return lo;
}

// bfloat16, C = O = 16, on the tensor cores: block s sums the hits
// [s * seg_len, (s + 1) * seg_len) of the list, each tap t's piece into
// partial[s + t, 256] (c * 16 + o).
__global__ void __launch_bounds__(kDwThreads)
    band_dw_bf16_tc_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ gp,
                           const int64_t* __restrict__ tap_start,
                           const int* __restrict__ hit_n,
                           const int* __restrict__ hit_m,
                           float* __restrict__ partial, int T,
                           int64_t seg_len) {
  // a warp's ring: per stage 16 x rows, then 16 gp rows, 32 bytes each
  // (two swizzled 16-byte chunks)
  __shared__ __align__(128) unsigned char ring[kDwWarps][kStages][2][512];
  __shared__ float red[kDwWarps][256];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t lo = (int64_t)blockIdx.x * seg_len;
  const int64_t hi = min(tap_start[T], lo + seg_len);
  // this lane's row and chunk of a staged step, and its ldmatrix rows
  const int gr = lane >> 1, gq = lane & 1;
  const uint32_t goff = mma16::swizzle(gr, gq, 2);
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t a_off = mma16::swizzle(lr + (lm >> 1) * 8, lm & 1, 2);
  const uint32_t b_off = mma16::swizzle(lr + (lm & 1) * 8, lm >> 1, 2);
  for (int t = tap_at(tap_start, T, lo); t < T && tap_start[t] < hi; ++t) {
    const int64_t p0 = max(lo, tap_start[t]);
    const int64_t p1 = min(hi, tap_start[t + 1]);
    if (p0 >= p1) continue;  // a tap without hits
    // warp w takes k-steps w, w + 8, ... of 16 hits from p0
    const int64_t steps = (p1 - p0 + 15) / 16;
    const int nk =
        steps > warp ? (int)((steps - warp + kDwWarps - 1) / kDwWarps) : 0;
    float acc[2][4] = {};
    auto issue = [&](int k) {
      const int64_t h = p0 + 16 * ((int64_t)warp + (int64_t)kDwWarps * k) + gr;
      const bool ok = h < p1;
      const int64_t m = ok ? hit_m[h] : 0, n = ok ? hit_n[h] : 0;
      unsigned char* st = ring[warp][k % kStages][0];
      mma16::cp_async16(st + goff, x + m * 16 + gq * 8, ok ? 16 : 0);
      mma16::cp_async16(st + 512 + goff, gp + n * 16 + gq * 8, ok ? 16 : 0);
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < nk) issue(k);
      mma16::cp_async_commit();
    }
    for (int k = 0; k < nk; ++k) {
      mma16::cp_async_wait<kStages - 2>();
      __syncwarp();
      const unsigned char* st = ring[warp][k % kStages][0];
      uint32_t af[4], bf[4];
      mma16::ldmatrix_x4_trans(af, mma16::smem_addr(st + a_off));
      mma16::ldmatrix_x4_trans(bf, mma16::smem_addr(st + 512 + b_off));
      mma16::mma_bf16(acc[0], af, bf[0], bf[1]);
      mma16::mma_bf16(acc[1], af, bf[2], bf[3]);
      __syncwarp();  // the stage is read before it is refilled
      if (k + kStages - 1 < nk) issue(k + kStages - 1);
      mma16::cp_async_commit();
    }
    mma16::cp_async_wait<0>();
    // D rows are input channels c, columns outputs o
    const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      red[warp][g * 16 + j * 8 + c2] = acc[j][0];
      red[warp][g * 16 + j * 8 + c2 + 1] = acc[j][1];
      red[warp][(g + 8) * 16 + j * 8 + c2] = acc[j][2];
      red[warp][(g + 8) * 16 + j * 8 + c2 + 1] = acc[j][3];
    }
    __syncthreads();
    float sum = 0.f;  // the warps' sums, in warp order
#pragma unroll
    for (int w = 0; w < kDwWarps; ++w) sum += red[w][threadIdx.x];
    partial[((int64_t)blockIdx.x + t) * 256 + threadIdx.x] = sum;
    __syncthreads();  // red is read before the next piece
  }
}

// N values of a row from p (n of them live, zeros past them), as vectors
// where the whole row is live and `vec` (16-byte aligned rows).
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, int n,
                                          bool vec, float (&v)[N]) {
  if constexpr (N % 8 == 0 && sizeof(T) == 2) {
    if (vec && n == N) {
#pragma unroll
      for (int i = 0; i < N; i += 8) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + i);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[i + 2 * j] = __low2float(h[j]);
          v[i + 2 * j + 1] = __high2float(h[j]);
        }
      }
      return;
    }
  }
  if constexpr (N % 4 == 0 && sizeof(T) == 4) {
    if (vec && n == N) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = i < n ? to_f32(p[i]) : 0.f;
}

// FFMA: KC input channels a thread (1 where C = 1, else 16, zeros past
// C) and OV outputs (16 where C = 1; else 4 where O is a multiple of 4,
// else 1); OG = ceil(O / OV) threads a hit, padded to OGP, a power of
// two. Block s sums the hits [s * seg_len, (s + 1) * seg_len) as the
// tensor-core kernel does, into partial[s + t, C * O].
template <typename T, int KC, int OV>
__global__ void __launch_bounds__(kDwThreads)
    band_dw_ffma_kernel(const T* __restrict__ x, const T* __restrict__ gp,
                        const int64_t* __restrict__ tap_start,
                        const int* __restrict__ hit_n,
                        const int* __restrict__ hit_m,
                        float* __restrict__ partial, int T_, int C, int O,
                        int OGP, bool vec, int64_t seg_len) {
  __shared__ float red[kDwWarps][256];  // [warp][og * KC * OV + c * OV + v]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int OG = (O + OV - 1) / OV;
  const int og = threadIdx.x & (OGP - 1);
  const int hl = threadIdx.x / OGP;  // the thread's hit lane
  const int HPB = kDwThreads / OGP;  // hits a block takes at once
  const int o0 = og * OV;
  const bool vec_g = vec && (OV == 1 || O % OV == 0);
  const int64_t lo = (int64_t)blockIdx.x * seg_len;
  const int64_t hi = min(tap_start[T_], lo + seg_len);
  for (int t = tap_at(tap_start, T_, lo); t < T_ && tap_start[t] < hi; ++t) {
    const int64_t p0 = max(lo, tap_start[t]);
    const int64_t p1 = min(hi, tap_start[t + 1]);
    if (p0 >= p1) continue;
    float acc[KC][OV] = {};
    if (og < OG) {
      for (int64_t h = p0 + hl; h < p1; h += HPB) {
        const int64_t m = hit_m[h], n = hit_n[h];
        float xv[KC], gv[OV];
        load_vals<T, KC>(x + m * C, C, vec, xv);
        load_vals<T, OV>(gp + n * O + o0, min(OV, O - o0), vec_g, gv);
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
          for (int v = 0; v < OV; ++v) acc[c][v] = fmaf(xv[c], gv[v], acc[c][v]);
      }
    }
    // the lanes of one og (a fixed tree), then the warps in order
    for (int off = 16; off >= OGP; off >>= 1)
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int v = 0; v < OV; ++v)
          acc[c][v] += __shfl_xor_sync(kFull, acc[c][v], off);
    if (lane < OGP) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int v = 0; v < OV; ++v)
          red[warp][(og * KC + c) * OV + v] = acc[c][v];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < C * O; i += kDwThreads) {  // i = c * O + o
      const int c = i / O, o = i - (i / O) * O;
      const int r = ((o / OV) * KC + c) * OV + o % OV;
      float sum = 0.f;
      for (int w = 0; w < kDwWarps; ++w) sum += red[w][r];
      partial[((int64_t)blockIdx.x + t) * C * O + i] = sum;
    }
    __syncthreads();
  }
}

// dw[t] = tap t's pieces partial[s + t] for its segments s, added in
// segment order, rounded once; a tap with no hit writes zeros.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    band_dw_reduce_kernel(const float* __restrict__ partial,
                          const int64_t* __restrict__ tap_start,
                          T* __restrict__ dw, int CO, int64_t seg_len) {
  const int t = blockIdx.x;
  const int64_t h0 = tap_start[t], h1 = tap_start[t + 1];
  for (int i = threadIdx.x; i < CO; i += kDwThreads) {
    float sum = 0.f;
    if (h1 > h0)
      for (int64_t s = h0 / seg_len; s <= (h1 - 1) / seg_len; ++s)
        sum += partial[(s + t) * CO + i];
    dw[(int64_t)t * CO + i] = from_f32<T>(sum);
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <typename T, int KC, int OV>
void launch_ffma(const void* x, const void* gp, const int64_t* tap_start,
                 const int* hn, const int* hm, float* partial, int n_seg,
                 int taps, int C, int O, bool vec, int64_t seg_len,
                 cudaStream_t st) {
  band_dw_ffma_kernel<T, KC, OV><<<n_seg, kDwThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gp), tap_start, hn, hm,
      partial, taps, C, O, pow2_at_least((O + OV - 1) / OV), vec, seg_len);
}

// The contraction's route: the tensor cores for bfloat16 at C = O = 16
// with 16-byte aligned rows; FFMA for the rest.
template <typename T>
int launch_dw(const void* x, const void* gp, const int64_t* tap_start,
              const int* hn, const int* hm, float* partial, void* dw,
              int n_seg, int taps, int C, int O, int64_t seg_len,
              cudaStream_t st) {
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)gp % 16 == 0;
  if (n_seg > 0) {
    if (sizeof(T) == 2 && C == 16 && O == 16 && vec)
      band_dw_bf16_tc_kernel<<<n_seg, kDwThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(gp), tap_start, hn, hm, partial,
          taps, seg_len);
    else if (C == 1)
      launch_ffma<T, 1, 16>(x, gp, tap_start, hn, hm, partial, n_seg, taps,
                            C, O, vec, seg_len, st);
    else if (O % 4 == 0)
      launch_ffma<T, 16, 4>(x, gp, tap_start, hn, hm, partial, n_seg, taps,
                            C, O, vec, seg_len, st);
    else
      launch_ffma<T, 16, 1>(x, gp, tap_start, hn, hm, partial, n_seg, taps,
                            C, O, vec, seg_len, st);
    const int code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  band_dw_reduce_kernel<T><<<taps, kDwThreads, 0, st>>>(
      partial, tap_start, static_cast<T*>(dw), C * O, seg_len);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1, K <= hB*wB, hB < 2^15, "
             "wB < 2^16, odd kernel sizes, at most 81 offsets in each grid "
             "(k1*k2, k3*k4) and a segment length >= 1";
    case kErrGrid:
      return "grid too large: B must be <= 65535, B*hA*wA*K < 2^31 and "
             "taps * B*hA*wA < 2^31";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    case kErrChannels:
      return "channels not taken: cin and cout 1 to 16";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace

extern "C" {

// The hit list of one pass (swapped: the symmetric pass's, its A and B
// offsets trading roles), rows cell-major. indices [B, hA, wA, K] int32
// (strictly ascending per A cell); bits
// and rank [B * hA*wA * nw] int32 scratch, nw = ceil(hB*wB / 32), kept
// from phase 0 to phase 1; offsets [T * B*hA*wA + 1] int64, tap_start
// [T + 2] int64.
// phase 0: the band's bitmap and ranks; then counts the hits of every
// (tap, cell) run and leaves offsets[t * nblk + blk] the run's first
// position in the list, offsets[T * nblk] and tap_start[T] the list's
// length, tap_start[t] tap t's first position, and tap_start[T + 1]
// nonzero where the indices are not strictly ascending in [0, hB*wB) in
// some A cell (the list is then not written: the caller raises).
// phase 1: writes hit_n and hit_m ([tap_start[T]] int32 each), with the
// buffers as phase 0 left them. Returns 0 on a successful launch, a
// cudaError_t value (> 0) when CUDA refused it, or one of the negative
// codes above.
int band_hits(const void* indices, void* bits, void* rank, void* offsets,
              void* tap_start, void* hit_n, void* hit_m, int phase,
              int swapped, int B, int hA, int wA, int hB, int wB, int K,
              int k1, int k2, int k3, int k4, void* stream) {
  if (B < 1 || hA < 1 || wA < 1 || hB < 1 || wB < 1 || K < 1 || k1 < 1 ||
      k2 < 1 || k3 < 1 || k4 < 1)
    return kErrBadShape;
  if ((int64_t)K > (int64_t)hB * wB || hB > 32767 || wB > 65535)
    return kErrBadShape;
  if (k1 % 2 == 0 || k2 % 2 == 0 || k3 % 2 == 0 || k4 % 2 == 0)
    return kErrBadShape;
  const int64_t taps = (int64_t)k1 * k2 * k3 * k4;
  if (taps > kMaxTaps || k1 * k2 > kMaxKB || k3 * k4 > kMaxKB)
    return kErrBadShape;
  const int64_t nblk = (int64_t)B * hA * wA;
  if (B > 65535 || nblk * K > 0x7fffffff || taps * nblk > 0x7fffffff)
    return kErrGrid;
  Band s;
  s.hA = hA, s.wA = wA, s.hB = hB, s.wB = wB, s.K = K, s.N = hA * wA * K;
  s.ka_i = swapped ? k3 : k1, s.ka_j = swapped ? k4 : k2;
  s.kb_i = swapped ? k1 : k3, s.kb_j = swapped ? k2 : k4;
  s.swapped = swapped != 0;
  s.T = (int)taps;
  const int* ix = static_cast<const int*>(indices);
  unsigned* bt = static_cast<unsigned*>(bits);
  int* rk = static_cast<int*>(rank);
  int64_t* off = static_cast<int64_t*>(offsets);
  int64_t* ts = static_cast<int64_t*>(tap_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (int)(((int64_t)hB * wB + 31) / 32);
  const int CB = std::max(1, kBlockEntries / K);  // cells a block
  const dim3 grid((unsigned)((hA * wA + CB - 1) / CB),
                  (unsigned)(s.ka_i * s.ka_j), (unsigned)B);
  const int64_t n = nblk * K;
  int code;
  if (phase == 0) {
    code = (int)cudaMemsetAsync(bt, 0, nblk * nw * sizeof(unsigned), st);
    if (code == 0)
      code = (int)cudaMemsetAsync(ts + taps + 1, 0, sizeof(int64_t), st);
    if (code != 0) return code;
    band_bitmap_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        ix, bt, ts + taps + 1, n, K, hB * wB, nw);
    band_rank_kernel<<<(unsigned)((nblk + 255) / 256), 256, 0, st>>>(
        bt, rk, nblk, nw);
    band_hits_kernel<false><<<grid, kHitThreads, 0, st>>>(
        ix, bt, rk, off, nullptr, nullptr, s, CB, nw);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
    scan_rows_kernel<<<(int)taps, kScanThreads, 0, st>>>(off, ts, (int)nblk);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
    scan_rows_kernel<<<1, kScanThreads, 0, st>>>(ts, ts + taps, (int)taps);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
    const dim3 add_grid((unsigned)((nblk + 255) / 256), (unsigned)taps);
    add_tap_start_kernel<<<add_grid, 256, 0, st>>>(off, ts, (int)nblk,
                                                   (int)taps);
    return (int)cudaGetLastError();
  }
  band_hits_kernel<true><<<grid, kHitThreads, 0, st>>>(
      ix, bt, rk, off, static_cast<int*>(hit_n), static_cast<int*>(hit_m), s,
      CB, nw);
  return (int)cudaGetLastError();
}

const char* band_hits_error_string(int code) { return error_string(code); }

// dw [T, C, O] in x's dtype from x [rows, C], gp [rows, O] (rows = B*N,
// cell-major) and a hit list of band_hits (tap_start [T + 1] int64,
// hit_n, hit_m int32), cut into n_seg = ceil(length / seg_len) segments;
// partial is [n_seg + T, C*O] float32 scratch. dtype: 0 = float32, 1 =
// bfloat16.
int band_gemm_dw(const void* x, const void* gp, const void* tap_start,
                 const void* hit_n, const void* hit_m, void* partial,
                 void* dw, int dtype, int n_seg, int taps, int C, int O,
                 int seg_len, void* stream) {
  if (taps < 1 || taps > kMaxTaps || n_seg < 0 || seg_len < 1)
    return kErrBadShape;
  if (C < 1 || O < 1 || C > kMaxC || O > kMaxC) return kErrChannels;
  const int64_t* ts = static_cast<const int64_t*>(tap_start);
  const int* hn = static_cast<const int*>(hit_n);
  const int* hm = static_cast<const int*>(hit_m);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, gp, ts, hn, hm, part, dw, n_seg, taps, C, O,
                            seg_len, st);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, gp, ts, hn, hm, part, dw, n_seg,
                                    taps, C, O, seg_len, st);
  return kErrDtype;
}

const char* band_gemm_dw_error_string(int code) { return error_string(code); }

}  // extern "C"
