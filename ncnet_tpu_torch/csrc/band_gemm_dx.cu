// Input gradient of one sparse-band neighbourhood-consensus layer over the
// pass's hit list, written by hand for Hopper (sm_90a):
//
//   dx[b, m, c] = sum_{(t, n, m) in hits} sum_o gp[b, n, o] * w[t, c, o]
//
// gp [B,N,O] is the layer's ReLU-masked output cotangent and dx [B,N,C]
// the result, both cell-major (on the symmetric pass the wrapper gathers
// gp out of the pass's B-major order and dx back into it), w [T,C,O] the
// forward's kernel (not flipped), and the hits those of
// csrc/band_gemm_dw.cu's list: by tap, then output A cell (block), then
// slot, with offsets[t * nblk + blk] the first position of run (tap t,
// block blk) and offsets[t * nblk + blk + 1] its end. float32 or bfloat16
// in and out, float32 sums rounded once to the activation dtype.
//
// Replaces: the dx half of ncnet_tpu/kernels/band_gemm_pallas.py::_bwd
// (:147-180; band_conv_gemm of gp with the flipped, channel-transposed
// kernel over a [B, N, T] pointer table, XLA on the TPU; the custom VJP
// of _fused_kernel).
//
// What bounds it on an H100: neither the FLOPs nor the bytes of its
// inputs. At the 400 px PF-Pascal config with a K = 50 band at batch 16
// (78.2 M hits a pass) the 16->16 layer's dx is 40 GFLOP (0.04 ms on the
// bfloat16 tensor cores) against 16 MB of gp and 16 MB of dx (0.01 ms at
// HBM speed). The time goes to walking every (input cell, tap) pair (6.25
// M a pass, most of them a run of about 12 hits scattered over the 626 MB
// list) through chains of dependent loads: run bounds, then the run's
// indices, then its rows. Measured by chip_smoke.py (band_train_kernels)
// on an NVIDIA H100 80GB HBM3 at 700 W: 2.20-2.24 ms a 16->16 launch and
// 1.83-1.88 ms a 16->1 one at the shape above; on bands with as many
// (cell, tap) pairs and fewer hits (its "walk" record) 0.43 ms where the
// list (19 MB) fits in L2: the walk, not the hits, takes the time.
//
// Design. Within one tap each entry has at most one hit, and the tap's
// neighbour map is a shift, so each input entry m appears at most once a
// tap; and every hit of tap t from output cell a reads input entries of
// cell a + shift_A(t) (on the symmetric pass the A offsets are (d3, d4)).
// So the hits whose input entry lies in cell a' are the runs (t, a' -
// shift_A(t)) of the list, each contiguous and at most K long, and the
// kB taps of one A offset all read output entries of one cell.
//   * one block an input A cell a' of one sample, W warps (as many as
//     keep the warps' shared memory within 48 KB, up to 8, dividing the
//     work evenly where they can); on the tensor cores warp w takes the A
//     offsets w, w + W, ... (on FFMA the taps w, w + W, ...). It adds each
//     hit's row gp[n] @ w[t]^T into its own [K, C] float32 accumulator at
//     the slot of m (m - a' K), the taps in order. Within a tap no two
//     hits touch one slot, so no atomics; the block then adds the W
//     accumulators in warp order and writes every row of the cell once,
//     rounded once: two calls are bitwise equal;
//   * bfloat16 at C = 16 and O = 16 or 1 (band_dx_bf16_tc_kernel) runs on
//     the tensor cores. For an A offset the warp stages the output cell
//     it reads (K gp rows) in shared memory once, so its kB taps' hits
//     read their rows there, not from L2; it reads the kB run bounds at once, a lane each, and takes the
//     non-empty runs two at a time, issuing both runs' index loads and
//     w[t] fragments together so the two chains overlap: A = 16 hits' gp
//     rows (ldmatrix from the staged cell; O = 1: zeros past output 0), B
//     = w[t]^T (two n-tiles), two mma.sync m16n8k16 with float32
//     accumulators, the 16 x 16 result scattered to the rows' slots;
//   * float32, and bfloat16 at other widths, run on FFMA
//     (band_dx_ffma_kernel): a lane a (hit, channel), w[t]'s row of the
//     channel in registers for the tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxC = 16;
constexpr int kMaxTaps = 6561;  // 9^4
constexpr int kMaxKB = 81;      // offsets in each grid: at most 9 x 9
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemBudget = 48 * 1024;  // the W warps' shared memory
constexpr int kSmemMax = 227 * 1024;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;
constexpr int kErrChannels = -5;

struct Pass {
  int hA, wA, K;               // A grid and band slots per A cell
  int N;                       // hA*wA*K
  int C, O;
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

// Tap (A offset da, B offset db) of the pass, row-major over the kernel.
__device__ __forceinline__ int tap_of(const Pass& s, int da, int db) {
  return s.swapped ? db * s.ka_i * s.ka_j + da : da * s.kb_i * s.kb_j + db;
}

// The output cell whose hits at A offset da read this block's input cell
// (ia1, ja1), or -1 off the A grid.
__device__ __forceinline__ int source_cell(const Pass& s, int da, int ia1,
                                           int ja1) {
  const int dai = da / s.ka_j, daj = da - (da / s.ka_j) * s.ka_j;
  const int ia = ia1 - dai + s.ka_i / 2, ja = ja1 - daj + s.ka_j / 2;
  if (ia < 0 || ia >= s.hA || ja < 0 || ja >= s.wA) return -1;
  return ia * s.wA + ja;
}

// Run (tap t, output cell a) of this block's sample (blockIdx.y): [lo, hi).
__device__ __forceinline__ void run_of(const int64_t* __restrict__ offsets,
                                       const Pass& s, int t, int a,
                                       int64_t& lo, int64_t& hi) {
  const int na = s.hA * s.wA;
  const int64_t* run = offsets + ((int64_t)t * gridDim.y + blockIdx.y) * na + a;
  lo = run[0];
  hi = run[1];
}

// Every row of the cell: the W warps' accumulators ([K][C + 1] floats,
// stride bytes apart from acc0) added in warp order, rounded once.
template <typename T>
__device__ __forceinline__ void write_rows(const unsigned char* acc0,
                                           int stride, int W,
                                           T* __restrict__ dx, const Pass& s,
                                           int64_t row0, int cell0) {
  const int cs = s.C + 1;
  for (int i = threadIdx.x; i < s.K * s.C; i += blockDim.x) {
    const int slot = i / s.C, c = i - (i / s.C) * s.C;
    float sum = 0.f;
    for (int w = 0; w < W; ++w)
      sum += reinterpret_cast<const float*>(acc0 + w * stride)[slot * cs + c];
    dx[(row0 + cell0 + slot) * s.C + c] = from_f32<T>(sum);
  }
}

// Two bfloat16 values p[o], p[o + 1] as one fragment register, zeros past
// n (kWhole: n is even and p is 4-byte aligned, one load).
template <bool kWhole>
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* __restrict__ p,
                                         int o, int n) {
  if constexpr (kWhole) return *reinterpret_cast<const uint32_t*>(p + o);
  const uint16_t lo = o < n ? mma16::bf16_bits(p[o]) : (uint16_t)0;
  const uint16_t hi = o + 1 < n ? mma16::bf16_bits(p[o + 1]) : (uint16_t)0;
  return mma16::pack(lo, hi);
}

// bfloat16, C = 16, on the tensor cores; kO16: O = 16, else O = 1. Warp w
// of the block's W takes the A offsets w, w + W, ...; for each it stages
// the output cell the offset reads (its K gp rows, 32 bytes each,
// swizzled; O = 1: K values) in shared memory, reads the kB taps' run
// bounds at once (a lane each) and takes the non-empty runs kU at a time:
// the index loads of the kU runs' first 16 hits and their w[t] fragments
// are issued together, then the rows come from the staged cell (ldmatrix),
// so kU chains of dependent loads overlap and no gp row is read from L2.
template <bool kO16>
__global__ void __launch_bounds__(kMaxWarps * 32)
    band_dx_bf16_tc_kernel(const __nv_bfloat16* __restrict__ gp,
                           const __nv_bfloat16* __restrict__ w,
                           const int64_t* __restrict__ offsets,
                           const int* __restrict__ hit_n,
                           const int* __restrict__ hit_m,
                           __nv_bfloat16* __restrict__ dx, const Pass s,
                           int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kC = 16, kCs = kC + 1, kU = 2;
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int O = kO16 ? 16 : 1;
  // a warp's shared memory: its accumulator [K][17], then the staged cell
  float* acc = reinterpret_cast<float*>(smem_raw + warp * warp_bytes);
  unsigned char* cell_rows =
      smem_raw + warp * warp_bytes + ((s.K * kCs * 4 + 15) & ~15);
  for (int i = lane; i < s.K * kCs; i += 32) acc[i] = 0.f;
  const int a1 = blockIdx.x;  // the input A cell
  const int ia1 = a1 / s.wA, ja1 = a1 - (a1 / s.wA) * s.wA;
  const int64_t row0 = (int64_t)blockIdx.y * s.N;
  const int cell0 = a1 * s.K;
  const int kA = s.ka_i * s.ka_j, kB = s.kb_i * s.kb_j;
  const int g = lane >> 2, i2 = 2 * (lane & 3);
  // ldmatrix: this lane gives row h of matrix lm; tile row h's n is held
  // by lane 4 * (h & 7), as its row g (h < 8) or g + 8
  const int lr = lane & 7, lm = lane >> 3;
  const int h_lane = lr + (lm & 1) * 8;

  struct Chunk {
    int n[2], m[2];  // rows g, g + 8 (-1 past the run)
    uint32_t bf[4];
  };
  // 16 hits [h0, min(h0 + 16, hi)) of tap t: (n, m) of the tile's rows g
  // and g + 8, and B = w[t]^T (B[o][c] = w[t, c, o]; n-tile j holds
  // channels 8j..8j+7)
  auto load = [&](int t, int64_t h0, int64_t hi, Chunk& k) {
    const int64_t ha = h0 + g, hb = ha + 8;
    k.n[0] = ha < hi ? hit_n[ha] : -1;
    k.n[1] = hb < hi ? hit_n[hb] : -1;
    k.m[0] = ha < hi ? hit_m[ha] : -1;
    k.m[1] = hb < hi ? hit_m[hb] : -1;
    const __nv_bfloat16* wt = w + (int64_t)t * kC * O;
    k.bf[0] = pair<kO16>(wt + g * O, i2, O);
    k.bf[1] = pair<kO16>(wt + g * O, i2 + 8, O);
    k.bf[2] = pair<kO16>(wt + (8 + g) * O, i2, O);
    k.bf[3] = pair<kO16>(wt + (8 + g) * O, i2 + 8, O);
  };
  auto add = [&](const Chunk& k, int64_t src0) {
    uint32_t af[4];
    if constexpr (kO16) {
      // A = the tile's gp rows [16 hits][16 outputs] from the staged cell
      const int na = __shfl_sync(kFull, k.n[0], 4 * (h_lane & 7));
      const int nb = __shfl_sync(kFull, k.n[1], 4 * (h_lane & 7));
      const int n_h = h_lane < 8 ? na : nb;
      const int slot = n_h >= 0 ? (int)(n_h - src0) : 0;
      mma16::ldmatrix_x4(af, mma16::smem_addr(
                                 cell_rows + mma16::swizzle(slot, lm >> 1, 2)));
    } else {
      const uint16_t* v = reinterpret_cast<const uint16_t*>(cell_rows);
      const uint32_t va = k.n[0] >= 0 ? v[k.n[0] - src0] : 0u;
      const uint32_t vb = k.n[1] >= 0 ? v[k.n[1] - src0] : 0u;
      af[0] = i2 == 0 ? va : 0u;
      af[1] = i2 == 0 ? vb : 0u;
      af[2] = af[3] = 0u;
    }
    float d[2][4] = {};
    mma16::mma_bf16(d[0], af, k.bf[0], k.bf[1]);
    mma16::mma_bf16(d[1], af, k.bf[2], k.bf[3]);
    const int sa = k.m[0] >= 0 ? (int)(k.m[0] - row0) - cell0 : -1;
    const int sb = k.m[1] >= 0 ? (int)(k.m[1] - row0) - cell0 : -1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if ((unsigned)sa < (unsigned)s.K) {
        acc[sa * kCs + 8 * j + i2] += d[j][0];
        acc[sa * kCs + 8 * j + i2 + 1] += d[j][1];
      }
      if ((unsigned)sb < (unsigned)s.K) {
        acc[sb * kCs + 8 * j + i2] += d[j][2];
        acc[sb * kCs + 8 * j + i2 + 1] += d[j][3];
      }
    }
    __syncwarp();  // the rows are added before another chunk's
  };

  for (int da = warp; da < kA; da += W) {
    const int a = source_cell(s, da, ia1, ja1);
    if (a < 0) continue;
    const int64_t src0 = row0 + (int64_t)a * s.K;  // the cell's first row
    __syncwarp();  // the previous cell's rows are read
    if constexpr (kO16) {
      for (int i = lane; i < 2 * s.K; i += 32)
        mma16::cp_async16(cell_rows + mma16::swizzle(i >> 1, i & 1, 2),
                          gp + (src0 + (i >> 1)) * 16 + (i & 1) * 8, 16);
      mma16::cp_async_commit();
    } else {
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(cell_rows);
      for (int i = lane; i < s.K; i += 32) v[i] = gp[src0 + i];
    }
    for (int ub = 0; ub < kB; ub += 32) {
      int64_t rlo = 0, rhi = 0;
      if (ub + lane < kB) run_of(offsets, s, tap_of(s, da, ub + lane), a, rlo, rhi);
      unsigned live = __ballot_sync(kFull, rhi > rlo);
      if constexpr (kO16) mma16::cp_async_wait<0>();
      __syncwarp();  // the cell's rows are staged
      while (live) {  // uniform over the warp
        int t[kU];
        int64_t lo[kU], hi[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int j = live ? __ffs(live) - 1 : 0;
          const bool on = live != 0;
          live &= live - 1;
          lo[u] = __shfl_sync(kFull, rlo, j);
          hi[u] = __shfl_sync(kFull, rhi, j);
          if (!on) hi[u] = lo[u];
          t[u] = tap_of(s, da, ub + j);
        }
        Chunk k[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) load(t[u], lo[u], hi[u], k[u]);
        // the taps in order, each run's chunks in order
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (hi[u] <= lo[u]) continue;
          add(k[u], src0);
          for (int64_t h0 = lo[u] + 16; h0 < hi[u]; h0 += 16) {
            Chunk c;
            load(t[u], h0, hi[u], c);
            add(c, src0);
          }
        }
      }
    }
  }
  __syncthreads();
  write_rows(smem_raw, warp_bytes, W, dx, s, row0, cell0);
}

// FFMA, any dtype and C, O <= 16: lane (hit lane hl, channel c) of CP =
// the power of two >= C lanes a hit; the channel's row w[t, c, :] in
// registers for the tap. Warp w takes the taps w, w + W, ... in order.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
    band_dx_ffma_kernel(const T* __restrict__ gp, const T* __restrict__ w,
                        const int64_t* __restrict__ offsets,
                        const int* __restrict__ hit_n,
                        const int* __restrict__ hit_m, T* __restrict__ dx,
                        const Pass s, int CP) {
  extern __shared__ __align__(16) unsigned char acc_raw[];  // [W][K][C + 1]
  const int W = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cs = s.C + 1;
  float* acc_all = reinterpret_cast<float*>(acc_raw);
  for (int i = threadIdx.x; i < W * s.K * cs; i += blockDim.x) acc_all[i] = 0.f;
  __syncthreads();
  float* acc = acc_all + warp * s.K * cs;
  const int a1 = blockIdx.x;
  const int ia1 = a1 / s.wA, ja1 = a1 - (a1 / s.wA) * s.wA;
  const int64_t row0 = (int64_t)blockIdx.y * s.N;
  const int cell0 = a1 * s.K;
  const int c = lane & (CP - 1), hl = lane / CP, HP = 32 / CP;
  const bool live = c < s.C;
  const int kA = s.ka_i * s.ka_j;
  for (int t = warp; t < s.T; t += W) {
    const int da = s.swapped ? t % kA : t / (s.kb_i * s.kb_j);
    const int a = source_cell(s, da, ia1, ja1);
    if (a < 0) continue;
    int64_t lo, hi;
    run_of(offsets, s, t, a, lo, hi);
    if (lo >= hi) continue;
    float wv[kMaxC];
    const T* wt = w + ((int64_t)t * s.C + (live ? c : 0)) * s.O;
#pragma unroll
    for (int o = 0; o < kMaxC; ++o) wv[o] = o < s.O ? to_f32(wt[o]) : 0.f;
    for (int64_t h = lo + hl; h < hi; h += HP) {
      const T* gr = gp + (int64_t)hit_n[h] * s.O;
      float r = 0.f;
#pragma unroll
      for (int o = 0; o < kMaxC; ++o)
        if (o < s.O) r = fmaf(to_f32(gr[o]), wv[o], r);
      const int slot = (int)(hit_m[h] - row0) - cell0;
      if (live && (unsigned)slot < (unsigned)s.K) acc[slot * cs + c] += r;
    }
    __syncwarp();  // the rows are added before another tap's
  }
  __syncthreads();
  write_rows(acc_raw, s.K * cs * (int)sizeof(float), W, dx, s, row0, cell0);
}

template <typename K>
int set_smem(K kernel, int smem) {
  if (smem <= kSmemBudget) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Warps a block: as many (up to 8) as keep their shared memory within
// kSmemBudget, at least one; then the largest count that divides `work`
// evenly, where one above half of them does.
int warps_for(int per_warp, int work) {
  const int most = std::max(1, std::min(kMaxWarps, kSmemBudget / per_warp));
  for (int w = most; 2 * w > most; --w)
    if (work % w == 0) return w;
  return most;
}

template <typename T>
int launch(const void* gp, const void* w, const int64_t* off, const int* hn,
           const int* hm, void* dx, int B, const Pass& s, cudaStream_t st) {
  const int acc_bytes = s.K * (s.C + 1) * (int)sizeof(float);
  const dim3 grid(s.hA * s.wA, B);
  const T* g = static_cast<const T*>(gp);
  const T* wt = static_cast<const T*>(w);
  T* out = static_cast<T*>(dx);
  const bool aligned = (uintptr_t)gp % 16 == 0 && (uintptr_t)w % 4 == 0;
  int code;
  if constexpr (sizeof(T) == 2) {
    if (s.C == 16 && (s.O == 16 || s.O == 1) && aligned) {
      const bool o16 = s.O == 16;
      // 16-byte aligned: cp.async and ldmatrix rows
      const int per_warp = ((acc_bytes + 15) & ~15) +
                           (o16 ? s.K * 32 : ((s.K * 2 + 15) & ~15));
      const int W = warps_for(per_warp, s.ka_i * s.ka_j);
      const int smem = W * per_warp;
      if (o16) {
        code = set_smem(band_dx_bf16_tc_kernel<true>, smem);
        if (code == 0)
          band_dx_bf16_tc_kernel<true><<<grid, W * 32, smem, st>>>(
              g, wt, off, hn, hm, out, s, per_warp);
      } else {
        code = set_smem(band_dx_bf16_tc_kernel<false>, smem);
        if (code == 0)
          band_dx_bf16_tc_kernel<false><<<grid, W * 32, smem, st>>>(
              g, wt, off, hn, hm, out, s, per_warp);
      }
      return code != 0 ? code : (int)cudaGetLastError();
    }
  }
  int cp = 1;
  while (cp < s.C) cp <<= 1;
  const int W = warps_for(acc_bytes, s.T);
  const int smem = W * acc_bytes;
  code = set_smem(band_dx_ffma_kernel<T>, smem);
  if (code == 0)
    band_dx_ffma_kernel<T><<<grid, W * 32, smem, st>>>(g, wt, off, hn, hm, out,
                                                       s, cp);
  return code != 0 ? code : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dx [B*N, C] in gp's dtype from gp [B*N, O] and w [T, C, O] (rows
// cell-major) over one pass's hit list (swapped: the symmetric pass's):
// offsets [T * B*hA*wA + 1] int64, hit_n and hit_m int32
// (csrc/band_gemm_dw.cu::band_hits). dtype: 0 = float32, 1 = bfloat16.
// Returns 0 on a successful launch, a cudaError_t value (> 0) when CUDA
// refused it, or one of the negative codes below.
int band_gemm_dx(const void* gp, const void* w, const void* offsets,
                 const void* hit_n, const void* hit_m, void* dx, int dtype,
                 int swapped, int B, int hA, int wA, int K, int C, int O,
                 int k1, int k2, int k3, int k4, void* stream) {
  if (B < 1 || hA < 1 || wA < 1 || K < 1 || k1 < 1 || k2 < 1 || k3 < 1 ||
      k4 < 1)
    return kErrBadShape;
  if (k1 % 2 == 0 || k2 % 2 == 0 || k3 % 2 == 0 || k4 % 2 == 0)
    return kErrBadShape;
  const int64_t taps = (int64_t)k1 * k2 * k3 * k4;
  if (taps > kMaxTaps || k1 * k2 > kMaxKB || k3 * k4 > kMaxKB)
    return kErrBadShape;
  if (C < 1 || O < 1 || C > kMaxC || O > kMaxC) return kErrChannels;
  if ((int64_t)K * ((C + 1) * 4 + 32) + 16 > kSmemMax) return kErrBadShape;
  if (B > 65535 || (int64_t)B * hA * wA * K > 0x7fffffff) return kErrGrid;
  Pass s;
  s.hA = hA, s.wA = wA, s.K = K, s.N = hA * wA * K, s.C = C, s.O = O;
  s.ka_i = swapped ? k3 : k1, s.ka_j = swapped ? k4 : k2;
  s.kb_i = swapped ? k1 : k3, s.kb_j = swapped ? k2 : k4;
  s.swapped = swapped != 0;
  s.T = (int)taps;
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int* hn = static_cast<const int*>(hit_n);
  const int* hm = static_cast<const int*>(hit_m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(gp, w, off, hn, hm, dx, B, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(gp, w, off, hn, hm, dx, B, s, st);
  return kErrDtype;
}

const char* band_gemm_dx_error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1, odd kernel sizes, at most 81 "
             "offsets in each grid (k1*k2, k3*k4), and K * (cin + 1) * 4 "
             "bytes within 227 KB";
    case kErrGrid:
      return "grid too large: B must be <= 65535 and B*hA*wA*K < 2^31";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    case kErrChannels:
      return "channels not taken: cin and cout 1 to 16";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
