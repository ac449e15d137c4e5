// Weight gradient of one sparse-band neighbourhood-consensus layer, written
// by hand for Hopper (sm_90a):
//
//   dw[t, c, o] = sum_{(b, n, m) in hits(t)} x[b, m, c] * gp[b, n, o]
//
// x [B,N,C] is the layer's input entry list, gp [B,N,O] its ReLU-masked
// output cotangent (both in the pass's order: B-major on the symmetric
// pass), and hits(t) the (output row n, input row m) pairs that the
// forward contracts at tap t: entry e = (a, s) with B cell beta reads, at
// tap t = (dA, dB), the entry of A cell a + dA - pA whose B cell is
// beta + dB - pB, as csrc/band_gemm_fwd.cu derives them from the band's
// sorted indices [B,hA,wA,K] (on the symmetric pass the A and B offsets
// trade roles and rows go through inv). float32 or bfloat16 in and out,
// float32 sums rounded once to the activation dtype.
//
// Replaces: the dw half of ncnet_tpu/kernels/band_gemm_pallas.py::_bwd
// (the linear transpose of band_conv_gemm over a [B, N, T] pointer table,
// XLA on the TPU; the custom VJP of _fused_kernel).
//
// What bounds it on an H100: neither the FLOPs nor the bytes. At the
// 400 px PF-Pascal config with a K = 50 band at batch 16 (B*N = 500,000
// entries, T = 625), a training batch's band (synthetic pairs through the
// trunk) lands 154.6 hits on an entry: 2 * 77.3 M hits * 256 = 39.6 GFLOP
// for the 16->16 layer (0.59 ms at the 67 TFLOP/s FP32 rate) against 32 MB
// of bfloat16 x and gp (0.01 ms at HBM speed). The hits' derivation, the
// gathers of the hit rows and the shared-memory traffic of the
// accumulation take the time: on an NVIDIA H100 80GB HBM3 at 700 W, 4.8 ms
// a launch (the three layers' mean) and 9.9 ms a hit list in a training
// step; 2.2 ms a 16->16 launch and 4.5 ms a hit list on a band of random
// features (42.7 hits an entry).
//
// Design (every sum in a fixed order, no float atomics: two calls are
// bitwise equal):
//   * the hit list, by tap (a counting sort): band_hits_kernel<false>
//     derives every entry's hits as the forward does (one warp a block, one
//     block an A cell of one sample, the cell's candidates staged in shared
//     memory, kTile at a time: once for all of a K = 50 cell's entries;
//     at the forward's 1,024 they were staged anew for each entry, 10.7
//     to 14.0 ms a pass on the same card) and counts them per (tap,
//     block) in shared memory; scan_rows_kernel turns the counts into
//     offsets, first within each tap's row of blocks, then across taps;
//     band_hits_kernel<true>
//     derives the hits again and writes each (n, m) pair at its offset.
//     An entry has at most one hit a tap (a neighbour cell's band holds a
//     B cell once), so within a (tap, block) segment the hits lie in slot
//     order, and the list is the same on every call. It is built once per
//     pass geometry and shared by the layers' dw: 8 bytes a hit, no
//     [B, N, T] pointer table;
//   * the contraction, band_dw_kernel: one block a segment of at most
//     SEGMENT hits of one tap (kernels/band_gemm_dw.py cuts them on the
//     host from the taps' counts: the centre tap holds every entry's hit
//     on itself, B*N of them, 15x an average tap's at the slice's band,
//     so a block a tap left one block running long after the rest: 32 ms
//     a 16->16 launch on the same card), 256 threads; the block stages
//     kChunk hits' x and gp rows in shared memory (the rows are gathered once,
//     not once an output; the chunk's loads are independent, so their L2
//     latency overlaps), and thread (q, c, o..o+V) of group q accumulates
//     every Q-th hit of the chunk in list order for V = 4 outputs where O
//     is a multiple of 4 (one float4 read of gp), else 1; the Q groups'
//     sums are added in group order into the segment's float32 partial.
//     band_dw_reduce_kernel then adds each tap's partials in segment order
//     and rounds once. A tap with no hit writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// candidates staged at once (hit lists): a K = 50 band's 25 x 50 = 1,250
// A-neighbour candidates stay resident for all 50 entries of a cell
constexpr int kTile = 2048;
constexpr int kScanThreads = 1024;
constexpr int kDwThreads = 256;  // the contraction's block
constexpr int kChunk = 256;      // hits staged at once (contraction)
constexpr int kMaxC = 16;        // channels the contraction takes, in and out
constexpr int kMaxTaps = 6561;   // 9^4
constexpr unsigned kFull = 0xffffffffu;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;
constexpr int kErrChannels = -5;

struct Band {
  int hA, wA, wB, K;           // grids and band slots per A cell
  int N;                       // hA*wA*K
  int ka_i, ka_j, kb_i, kb_j;  // the pass's A- and B-offset extents
  int swapped;                 // 1: the symmetric pass (inv given)
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

// kFill = false: counts[t * nblk + blk] = the hits of block blk at tap t.
// kFill = true: counts hold each tap's exclusive offsets over blocks and
// tap_start each tap's first position; every hit (n, m) is written to
// hit_n / hit_m, rows flattened over the batch (b * N + row).
template <bool kFill>
__global__ void __launch_bounds__(32)
    band_hits_kernel(const int* __restrict__ indices,
                     const int* __restrict__ inv, int* __restrict__ counts,
                     const int* __restrict__ tap_start,
                     int* __restrict__ hit_n, int* __restrict__ hit_m,
                     const Band s) {
  extern __shared__ int smem[];
  // the staged candidates: B cell (iB << 16 | jB, -1 where there is none),
  // row in the pass's list, the A offset's part of the tap; then the
  // block's cursor of each tap
  int* cand_b = smem;
  int* cand_src = cand_b + kTile;
  int* cand_tap = cand_src + kTile;
  int* cursor = cand_tap + kTile;
  const int lane = threadIdx.x;
  const int a = blockIdx.x;  // the A cell
  const int64_t nblk = (int64_t)gridDim.x * gridDim.y;
  const int64_t blk = (int64_t)blockIdx.y * gridDim.x + a;
  const int64_t base = (int64_t)blockIdx.y * s.N;
  const int* idx = indices + base;
  const int ia = a / s.wA, ja = a - (a / s.wA) * s.wA;
  const int pa_i = s.ka_i / 2, pa_j = s.ka_j / 2;
  const int pb_i = s.kb_i / 2, pb_j = s.kb_j / 2;
  const int kB = s.kb_i * s.kb_j;
  const int kA = s.ka_i * s.ka_j;
  const int n_cand = kA * s.K;
  const bool resident = n_cand <= kTile;  // staged once for every entry

  // candidates [t0, t0 + n) of this cell into shared memory
  auto stage = [&](int t0, int n) {
    for (int i = lane; i < n; i += 32) {
      const int m = t0 + i;
      const int da = m / s.K;
      const int slot = m - da * s.K;
      const int dai = da / s.ka_j, daj = da - (da / s.ka_j) * s.ka_j;
      const int ia2 = ia + dai - pa_i, ja2 = ja + daj - pa_j;
      int bc = -1, src = 0;
      if (ia2 >= 0 && ia2 < s.hA && ja2 >= 0 && ja2 < s.wA) {
        const int cell = (ia2 * s.wA + ja2) * s.K + slot;
        const int beta = idx[cell];
        const int ib = beta / s.wB;
        src = s.swapped ? inv[base + cell] : cell;
        if ((unsigned)src < (unsigned)s.N) bc = (ib << 16) | (beta - ib * s.wB);
      }
      cand_b[i] = bc;
      cand_src[i] = src;
      cand_tap[i] = s.swapped ? da : da * kB;
    }
  };

  for (int t = lane; t < s.T; t += 32)
    cursor[t] = kFill ? tap_start[t] + counts[t * nblk + blk] : 0;
  if (resident) stage(0, n_cand);
  __syncwarp();
  for (int slot = 0; slot < s.K; ++slot) {
    const int e = a * s.K + slot;  // the entry
    const int beta = idx[e];
    const int ib = beta / s.wB, jb = beta - (beta / s.wB) * s.wB;
    const int row = s.swapped ? inv[base + e] : e;
    const bool row_ok = (unsigned)row < (unsigned)s.N;
    for (int t0 = 0; t0 < n_cand; t0 += kTile) {
      const int n = min(kTile, n_cand - t0);
      if (!resident) {
        __syncwarp();  // the previous tile is read
        stage(t0, n);
        __syncwarp();
      }
      for (int i = lane; i < ((n + 31) & ~31); i += 32) {
        if (i < n && row_ok) {
          const int bc = cand_b[i];
          const int dbi = (bc >> 16) - ib + pb_i;
          const int dbj = (bc & 0xffff) - jb + pb_j;
          if (bc >= 0 && (unsigned)dbi < (unsigned)s.kb_i &&
              (unsigned)dbj < (unsigned)s.kb_j) {
            const int db = dbi * s.kb_j + dbj;
            const int tap = cand_tap[i] + (s.swapped ? db * kA : db);
            // the lanes' taps differ (one hit a tap an entry), so the
            // positions do not depend on the lanes' order
            const int pos = atomicAdd(&cursor[tap], 1);
            if (kFill) {
              hit_n[pos] = (int)(base + row);
              hit_m[pos] = (int)(base + cand_src[i]);
            }
          }
        }
        __syncwarp();  // the entry's hits so far hold their positions
      }
    }
  }
  __syncwarp();
  if (!kFill)
    for (int t = lane; t < s.T; t += 32) counts[t * nblk + blk] = cursor[t];
}

// Each block's row of `values` (n ints, row blockIdx.x) becomes its
// exclusive prefix sum, in place; the row's total goes to totals[blockIdx.x].
__global__ void __launch_bounds__(kScanThreads)
    scan_rows_kernel(int* __restrict__ values, int* __restrict__ totals,
                     int n) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  int* row = values + (int64_t)blockIdx.x * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int i0 = 0; i0 < n; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    const int v = i < n ? row[i] : 0;
    int x = v;  // inclusive within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    const int excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < n) row[i] = excl;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// V: outputs a thread (4 where O is a multiple of 4, else 1). Block s sums
// the hits [seg_lo[s], seg_hi[s]) into partial[s, C*O].
template <typename T, int V>
__global__ void __launch_bounds__(kDwThreads)
    band_dw_kernel(const T* __restrict__ x, const T* __restrict__ gp,
                   const int* __restrict__ seg_lo,
                   const int* __restrict__ seg_hi,
                   const int* __restrict__ hit_n,
                   const int* __restrict__ hit_m,
                   float* __restrict__ partial, int C, int O) {
  __shared__ float xs[kChunk][kMaxC + 1];
  __shared__ __align__(16) float gs[kChunk][kMaxC];
  __shared__ float red[kDwThreads * V];
  const int h0 = seg_lo[blockIdx.x], h1 = seg_hi[blockIdx.x];
  const int OV = O / V;          // threads over one channel's outputs
  const int G = C * OV;          // threads of a group: every output once
  const int Q = kDwThreads / G;  // groups, each over every Q-th hit
  const int tid = threadIdx.x;
  const int q = tid / G;
  const int r = tid - q * G;
  const int c = r / OV;
  const int o = (r - c * OV) * V;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int hb = h0; hb < h1; hb += kChunk) {
    const int nh = min(kChunk, h1 - hb);
    __syncthreads();  // the previous chunk is read
    for (int i = tid; i < nh * C; i += kDwThreads) {
      const int h = i / C, cc = i - (i / C) * C;
      xs[h][cc] = to_f32(x[(int64_t)hit_m[hb + h] * C + cc]);
    }
    for (int i = tid; i < nh * O; i += kDwThreads) {
      const int h = i / O, oo = i - (i / O) * O;
      gs[h][oo] = to_f32(gp[(int64_t)hit_n[hb + h] * O + oo]);
    }
    __syncthreads();
    if (q < Q) {
      for (int h = q; h < nh; h += Q) {
        const float xv = xs[h][c];
        if constexpr (V == 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(&gs[h][o]);
          acc[0] = fmaf(xv, g4.x, acc[0]);
          acc[1] = fmaf(xv, g4.y, acc[1]);
          acc[2] = fmaf(xv, g4.z, acc[2]);
          acc[3] = fmaf(xv, g4.w, acc[3]);
        } else {
          acc[0] = fmaf(xv, gs[h][o], acc[0]);
        }
      }
    }
  }
  // the groups' partial sums, added in group order
  if (q < Q) {
#pragma unroll
    for (int v = 0; v < V; ++v) red[(q * G + r) * V + v] = acc[v];
  }
  __syncthreads();
  for (int i = tid; i < G * V; i += kDwThreads) {  // i = c * O + o
    float sum = 0.f;
    for (int qq = 0; qq < Q; ++qq) sum += red[qq * G * V + i];
    partial[(int64_t)blockIdx.x * C * O + i] = sum;
  }
}

// dw[t] = the partials of tap t's segments [seg_first[t], seg_first[t+1]),
// added in segment order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    band_dw_reduce_kernel(const float* __restrict__ partial,
                          const int* __restrict__ seg_first,
                          T* __restrict__ dw, int CO) {
  const int t = blockIdx.x;
  const int s0 = seg_first[t], s1 = seg_first[t + 1];
  for (int i = threadIdx.x; i < CO; i += kDwThreads) {
    float sum = 0.f;
    for (int s = s0; s < s1; ++s) sum += partial[(int64_t)s * CO + i];
    dw[(int64_t)t * CO + i] = from_f32<T>(sum);
  }
}

template <typename T>
int launch_dw(const void* x, const void* gp, const int* seg_lo,
              const int* seg_hi, const int* seg_first, const int* hit_n,
              const int* hit_m, float* partial, void* dw, int n_seg, int taps,
              int C, int O, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gp);
  if (n_seg > 0) {
    if (O % 4 == 0)
      band_dw_kernel<T, 4><<<n_seg, kDwThreads, 0, st>>>(
          xt, gt, seg_lo, seg_hi, hit_n, hit_m, partial, C, O);
    else
      band_dw_kernel<T, 1><<<n_seg, kDwThreads, 0, st>>>(
          xt, gt, seg_lo, seg_hi, hit_n, hit_m, partial, C, O);
    const int code = (int)cudaGetLastError();
    if (code != 0) return code;
  }
  band_dw_reduce_kernel<T><<<taps, kDwThreads, 0, st>>>(
      partial, seg_first, static_cast<T*>(dw), C * O);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1, K <= hB*wB, hB < 2^15, "
             "wB < 2^16, odd kernel sizes and at most 9^4 taps";
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

// The hit list of one pass. indices [B, hA, wA, K] int32 (sorted per A
// cell), inv [B, N] int32 (NULL on the plain pass), counts [T * B*hA*wA]
// int32 scratch, tap_start [T + 1] int32.
// phase 0: counts the hits and fills tap_start (tap_start[T] is their
// number); phase 1: writes hit_n and hit_m ([tap_start[T]] int32 each),
// with counts and tap_start as phase 0 left them. Returns 0 on a
// successful launch, a cudaError_t value (> 0) when CUDA refused it, or
// one of the negative codes above.
int band_hits(const void* indices, const void* inv, void* counts,
              void* tap_start, void* hit_n, void* hit_m, int phase, int B,
              int hA, int wA, int hB, int wB, int K, int k1, int k2, int k3,
              int k4, void* stream) {
  if (B < 1 || hA < 1 || wA < 1 || hB < 1 || wB < 1 || K < 1 || k1 < 1 ||
      k2 < 1 || k3 < 1 || k4 < 1)
    return kErrBadShape;
  if ((int64_t)K > (int64_t)hB * wB || hB > 32767 || wB > 65535)
    return kErrBadShape;
  if (k1 % 2 == 0 || k2 % 2 == 0 || k3 % 2 == 0 || k4 % 2 == 0)
    return kErrBadShape;
  const int64_t taps = (int64_t)k1 * k2 * k3 * k4;
  if (taps > kMaxTaps) return kErrBadShape;
  const int64_t nblk = (int64_t)B * hA * wA;
  if (B > 65535 || nblk * K > 0x7fffffff || taps * nblk > 0x7fffffff)
    return kErrGrid;
  const bool swapped = inv != nullptr;
  Band s;
  s.hA = hA, s.wA = wA, s.wB = wB, s.K = K, s.N = hA * wA * K;
  s.ka_i = swapped ? k3 : k1, s.ka_j = swapped ? k4 : k2;
  s.kb_i = swapped ? k1 : k3, s.kb_j = swapped ? k2 : k4;
  s.swapped = swapped;
  s.T = (int)taps;
  const int* ix = static_cast<const int*>(indices);
  const int* iv = static_cast<const int*>(inv);
  int* cn = static_cast<int*>(counts);
  int* ts = static_cast<int*>(tap_start);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(hA * wA, B);
  const int smem = (int)((3 * kTile + taps) * sizeof(int));
  if (smem > 48 * 1024) {  // past the default: 9^4 taps
    int code = (int)cudaFuncSetAttribute(
        band_hits_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (code == 0)
      code = (int)cudaFuncSetAttribute(
          band_hits_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
    if (code != 0) return code;
  }
  if (phase == 0) {
    band_hits_kernel<false><<<grid, 32, smem, st>>>(ix, iv, cn, nullptr,
                                                    nullptr, nullptr, s);
    int code = (int)cudaGetLastError();
    if (code != 0) return code;
    scan_rows_kernel<<<(int)taps, kScanThreads, 0, st>>>(cn, ts, (int)nblk);
    code = (int)cudaGetLastError();
    if (code != 0) return code;
    scan_rows_kernel<<<1, kScanThreads, 0, st>>>(ts, ts + taps, (int)taps);
    return (int)cudaGetLastError();
  }
  band_hits_kernel<true><<<grid, 32, smem, st>>>(
      ix, iv, cn, ts, static_cast<int*>(hit_n), static_cast<int*>(hit_m), s);
  return (int)cudaGetLastError();
}

const char* band_hits_error_string(int code) { return error_string(code); }

// dw [T, C, O] in x's dtype from x [rows, C], gp [rows, O] (rows = B*N,
// the pass's order) and a hit list of band_hits cut into n_seg segments:
// segment s holds the hits [seg_lo[s], seg_hi[s]) of one tap, tap t's
// segments are [seg_first[t], seg_first[t + 1]) (int32 each), and partial
// is [n_seg, C*O] float32 scratch. dtype: 0 = float32, 1 = bfloat16.
int band_gemm_dw(const void* x, const void* gp, const void* seg_lo,
                 const void* seg_hi, const void* seg_first, const void* hit_n,
                 const void* hit_m, void* partial, void* dw, int dtype,
                 int n_seg, int taps, int C, int O, void* stream) {
  if (taps < 1 || taps > kMaxTaps || n_seg < 0) return kErrBadShape;
  if (C < 1 || O < 1 || C > kMaxC || O > kMaxC) return kErrChannels;
  const int* lo = static_cast<const int*>(seg_lo);
  const int* hi = static_cast<const int*>(seg_hi);
  const int* first = static_cast<const int*>(seg_first);
  const int* hn = static_cast<const int*>(hit_n);
  const int* hm = static_cast<const int*>(hit_m);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, gp, lo, hi, first, hn, hm, part, dw, n_seg,
                            taps, C, O, st);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, gp, lo, hi, first, hn, hm, part, dw,
                                    n_seg, taps, C, O, st);
  return kErrDtype;
}

const char* band_gemm_dw_error_string(int code) { return error_string(code); }

}  // extern "C"
