// Forward of the SAME, stride-1 4D convolution of neighbourhood consensus,
// written by hand for Hopper (sm_90a).
//
//   out[b,i,j,k,l,o] = bias[o] + sum_{di,dj,dk,dl,c}
//       x[b, i+di-p, j+dj-p, k+dk-p, l+dl-p, c] * w[di,dj,dk,dl,c,o]
//
// with zero padding p = ks/2, an odd hypercubic ks^4 kernel, channels-last
// activations x [B,I,J,K,L,C] (the packed [B,I,J,K*L*C] layout of the JAX
// package) and weights w [ks,ks,ks,ks,C,O]. float32 or bfloat16 in and out,
// float32 accumulation, the bias added once in float32. The input gradient
// is the same call on flip(w)^T with a zero bias.
//
// Replaces: ncnet_tpu/kernels/conv4d_pallas.py::_fwd_kernel (TPU Pallas).
//
// What bounds it on an H100: operations. At the 400 px PF-Pascal config the
// three NC layers (1->16, 16->16, 16->1 at 5^4 taps on a 25^4 grid) do about
// 281 GFLOP per served pair (both symmetric directions) while moving well
// under 0.1 GB, so the arithmetic intensity is thousands of FLOP per byte.
//
// Both routes keep one block per (b, i, j) output row and per tile of
// output positions: for each (di, dj) tap pair whose input row
// (i+di-p, j+dj-p) lies on the grid, the block stages the zero-padded
// (k, l, c) halo of that row and the [ks, ks, C, O] weight slice in shared
// memory and folds the remaining (dk, dl, c) taps into one contraction.
// Rows off the grid are skipped, halo cells off the grid are 0, so small
// and rectangular grids need no special case.
//
// bfloat16 (the training path: forward and dx) runs on the tensor cores,
// bf16 x bf16 -> float32 as the JAX kernel's preferred_element_type=f32:
//   * per staged row the contraction is a GEMM with M = output positions
//     (640 a block: 8 warps x 5 m16 tiles, 40 float32 accumulators a
//     thread at 16 outputs), N = output channels (8 or 16 a block),
//     K = (dk, dl, c) in k-steps of 16;
//   * C >= 2: K runs over taps x 16-channel groups (C padded with zeros).
//     The halo keeps each position's 16 channels as two swizzled 16-byte
//     chunks, so the A fragment is one ldmatrix.x4 whose lanes address the
//     shifted positions (k+dk, l+dl) directly: no im2col copy. The B
//     fragment is ldmatrix.trans of the staged [tap*c][o] weight slice,
//     loaded once per k-step and used by all 5 m-tiles of a warp;
//   * C == 1 (the 1->16 forward, the 16->1 layer's dx): K runs over the
//     (dk, dl) taps themselves (25 padded to 32), and the A fragment is
//     built from scalar shared loads of the one-channel halo;
//   * O == 1 (the 16->1 forward; ks <= 8): padding N = o to 8 would leave
//     7/8 of every MMA zero, so N runs over dl instead. Per dk a warp
//     computes Z[u][dl] = sum_c x_halo[u + dk*(L+2p), c] * w[dk, dl, c]
//     over the halo rows u its 80 positions reach (at most 7 m16 tiles,
//     K = c), parks Z in its own shared rows, and each lane adds
//     Z[u(pos) + dl][dl] over dl for its positions: a fifth of the MMAs
//     and A loads of the per-tap form, no block-wide barrier;
//   * the halo and weights are staged in bfloat16 (never widened) and
//     double-buffered with cp.async (16-byte chunks, zero-filled off the
//     grid), so the next (di, dj) row's copy overlaps this row's MMAs;
//     shapes whose rows are not 16-byte chunks (C or O not a multiple of
//     8) stage with plain loads;
//   * every output is summed by one thread in a fixed order: a repeated
//     call is bitwise equal.
// float32 (serving, the gradient check) takes one of two routes, chosen
// by the shape rule f32_route (below) and nothing else:
//   * split-TF32 ("3xTF32") on the tensor cores, conv4d_fwd_tf32x3_tc,
//     for C >= 2 and O >= 2 (the 16->16 layer): the bfloat16 route's
//     kModeChannels structure (tap shifts as ldmatrix row addresses, one
//     owner thread an output) with mma.sync m16n8k8 .tf32 products
//     (mma_tf32.cuh). Each float32 operand a is split into hi =
//     cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi), and a product is
//     lo*hi + hi*lo + hi*hi, in that order; only lo*lo (about 2^-22
//     relative) is dropped. One TF32 product keeps 10 mantissa bits: about
//     4e-4 of the scale on a 10,000-term NC sum, short of the serving
//     check's 1e-4; the split keeps about 2e-6 (both emulated in
//     tests/test_torch_tf32_split.py). Three MMAs a product put the bound
//     at 495 / 3 = 165 TFLOP/s of float32-accurate work;
//   * the MMA's own accumulation rounds toward zero, which over a whole
//     10,000-term sum biases it by about 8e-5 of the scale (measured on an
//     H100). So the tensor cores sum one dk slice of a row (ks taps x C
//     channels) into a zeroed partial, and each partial is added into the
//     float32 accumulators with one rounding to nearest: about 1e-6;
//   * the halo keeps each position's 16 channels as a 64-byte record of
//     four swizzled 16-byte chunks, so a k8 step's A fragment (8 channels
//     of 16 shifted positions) is one ldmatrix.x4 of the hi array and one
//     of the lo array. The halo is split once a staged row, when it has
//     landed (a pass between the row's two barriers): a position is read
//     by 25 taps, so splitting per fragment in registers cost 25 times the
//     conversions (cvt.rna is 4 instructions with its inf/NaN guard; that
//     form took 32 ms for 16->16, this one well under 20);
//   * the weights are split once a staged row too, into hi and lo arrays,
//     [k row][o] with o XOR-swizzled so that a warp's B loads hit 32
//     distinct banks. Their global loads (float4 where O % 4 == 0) are
//     issued before the halo's split in the same pass, which hides their
//     latency. Splitting a B fragment per k8 step in registers instead
//     (every warp splitting every weight) read 17.8 ms for 16->16, this
//     17.1;
//   * the m16 tiles a warp (5, 2 or 1) are a template parameter, so the
//     tile loop unrolls with no branch and the ldmatrix loads of all tiles
//     issue ahead of their MMAs;
//   * shared memory at the PF-Pascal 16->16 layer (25^4 grid, 5^4 taps,
//     640-position tile): a halo array is 29 x 29 positions x 64 B =
//     53,824 B, held three times (hi and lo of this row, raw of the next),
//     and a weight array 25 taps x 16 c x 16 o x 4 B = 25,600 B, hi and lo:
//     3 x 53,824 + 2 x 25,600 = 212,672 B of the 232,448 a block may have,
//     so one block of 8 warps an SM (the bfloat16 route fits two). The
//     next row's halo copy overlaps this row's MMAs. Where a tile does not
//     fit (wide rows), the plan takes fewer m16 tiles a warp before it
//     refuses: at 16 channels, rows of up to about 150 positions (a dense
//     grid that wide holds 150^4 x 16 x 4 B = 32 GB a sample);
//   * what bounds 16->16 now: mma.sync's m16n8k8 fragments, hi and lo,
//     cost 2 ldmatrix.x4 for 6 MMAs; the loop issues about 2.3
//     instructions an MMA and runs at about a third of the TF32 rate.
//     wgmma, reading B (and A, where its rows are regular) from shared
//     memory, is the next step;
//   * FFMA on the CUDA cores for the layers f32_route keeps there (one
//     input or one output channel; why, at f32_route), two kernels, one
//     a shape class:
//       - conv4d_fwd_ffma_c1 (C == 1: the 1->16 layer, the 16->1 layer's
//         dx): a thread owns R = 4 or 5 consecutive outputs along l x 16
//         (8, 4) output channels and, per dk, its input window's R + ks - 1
//         activations in registers; a tap is OT / 4 broadcast float4
//         weight loads for R x OT FMAs;
//       - conv4d_fwd_ffma_o1 (O == 1: the 16->1 layer): a thread owns R =
//         4 or 5 consecutive outputs along l and, per dk, the ks x 16
//         weights in registers; it walks its input window once in (l, c)
//         order, one float4 a 4-channel chunk, into every owned output the
//         chunk is a tap of, so a staged activation feeds up to ks FMAs
//         from registers (the one generic FFMA kernel these replaced read
//         one activation from shared memory per FMA);
//       - both: the lanes of a warp run down k (the halo's row pitch is
//         odd, so their loads fall in distinct banks); a group of threads
//         owns one tile of k rows of one (b, i, j) row and
//         a block as many groups as fill about 128 threads, so small grids
//         keep their lanes busy; each (di, dj) input row's halo and weights
//         are copied by cp.async (16-byte chunks where C or O allow);
//         halo cells off the grid are zeroed once and never copied. C == 1
//         double-buffers (a row is 3.4 KB at 25^4: the next row's copy
//         runs under this row's FMAs, one barrier a row); O == 1 stages
//         one row (53.8 KB at 25^4 and 16 channels), so four blocks fit an
//         SM and cover each other's copies: on an H100 at 8 samples on
//         25^4, 2.35 ms against 2.59 double-buffered with two blocks an SM
//         (PERF.md);
//     The chain rule: one thread owns an output and sums one fmaf chain
//     from +0 in (di, dj, dk, dl, c) order over the taps whose input row
//     (ii, jj) lies on the grid, the bias added last in float32, as that
//     generic kernel did. A term whose input is in the
//     zero halo or a zero-padded channel adds +0 * w, which leaves every
//     finite sum's bits as they are (a sum from +0 is never -0), so both
//     kernels are bitwise equal to that kernel and to the test-only chain
//     oracle (conv4d_fwd_chain_oracle) at every shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;

// ---------------------------------------------------------------------------
// float32 route on the CUDA cores (FFMA): the layers f32_route keeps there
// (see the header). Both kernels share one frame: a group of threads owns
// one tile of one (b, i, j) output row; a block holds G groups; every
// group stages the halo of its own input row and the block the weights of
// the (di, dj) step with cp.async (ffma_steps).

constexpr int kFfmaMaxThreads = 256;  // threads a block, at most
constexpr int kFfmaGroupTarget = 128;  // a block takes groups up to this
constexpr int kO1Rec = 16;  // floats a staged position (O == 1, C <= 16)

struct FfmaShape {
  int B, I, J, K, L, C, O, ks;
  int W;         // staged halo columns
  int rec;       // floats a staged position: 1 (C == 1), 4 * C4p (O == 1)
  int C4p;       // O == 1: 4-channel chunks a position, a multiple of 4
  int tile;      // k rows a tile, at most
  int n_tiles;   // tiles a (b, i, j) row
  int S;         // threads a group: one tile of one (b, i, j) row
  int G;         // groups a block
  int n_seg;     // segments of R outputs a k row
  int OT;        // C == 1: output channels a block; O == 1: 1
  int x_floats;  // floats of one halo buffer of a group (a multiple of 4)
  int w_floats;  // floats of one staged weight slice (a multiple of 4)
  int vec_x;     // O == 1: stage the halo in 16-byte chunks
  int vec_w;     // stage the weights in 16-byte chunks
  long long n_items;  // groups in all: B * I * J * n_tiles
};
static_assert(sizeof(FfmaShape) <= 128, "kernel parameters past 128 bytes");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   mma16::smem_addr(dst)),
               "l"(src));
}

// Where 4-channel chunk c4 of a staged position of halo row hk lives
// (O == 1): the low two bits rotate with hk / 2, so the 8 lanes of a
// quarter-warp, on 8 consecutive k rows, read 8 distinct 16-byte bank
// groups.
__device__ __forceinline__ int o1_slot(int c4, int hk) {
  return (c4 & ~3) | ((c4 ^ (hk >> 1)) & 3);
}

struct FfmaItem {
  int b, i, j, tile;
  bool valid;
};

// Group item n: the (b, i, j) output row and the tile of it.
__device__ __forceinline__ FfmaItem ffma_item(const FfmaShape& s,
                                              long long n) {
  FfmaItem it;
  it.valid = n < s.n_items;
  if (!it.valid) n = 0;
  it.tile = (int)(n % s.n_tiles);
  n /= s.n_tiles;
  it.j = (int)(n % s.J);
  n /= s.J;
  it.i = (int)(n % s.I);
  it.b = (int)(n / s.I);
  return it;
}

// Input row (ii, jj) of item it at step v = di * ks + dj; true where it
// lies on the grid.
__device__ __forceinline__ bool ffma_row(const FfmaShape& s, const FfmaItem& it,
                                         int ks, int v, int& ii, int& jj) {
  const int p = ks / 2;
  ii = it.i + v / ks - p;
  jj = it.j + v % ks - p;
  return it.valid && ii >= 0 && ii < s.I && jj >= 0 && jj < s.J;
}

// The cells (r, q) of an nrows x m array, walked by the S threads of a
// group: thread t takes column t % m of every (S / m)-th row where a row
// is no wider than the group, else cells t, t + S, ... in row order.
template <typename F>
__device__ __forceinline__ void ffma_cells(int nrows, int m, int t, int S,
                                           F f) {
  if (S >= m) {
    const int step = S / m;
    if (t >= step * m) return;
    const int q = t % m;
    for (int r = t / m; r < nrows; r += step) f(r, q);
    return;
  }
  int r = 0, q = t;
  for (int e = t; e < nrows * m; e += S) {
    f(r, q);
    q += S;
    if (q >= m) q -= m, ++r;
  }
}

// Zero the block's shared memory: halo cells off the grid, channels past
// C and weight columns past O are never written after, so they stay 0.
__device__ __forceinline__ void ffma_zero(float* smem, int floats) {
  float4* z = reinterpret_cast<float4*>(smem);
  for (int e = threadIdx.x; e < floats / 4; e += blockDim.x)
    z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
}

// The block's (di, dj) steps in ascending order. kBuffers = 2: step v +
// 1's weights and rows are copied while step v's FMAs run, one barrier a
// step. kBuffers = 1: one staged row, copied once every group is done
// with the last (two barriers a step); the copy's wait is hidden by the
// other blocks of the SM, which the halved footprint lets in. With one
// group a block, the steps whose input row is off the grid are skipped
// (uniform over the block); with several, every step runs and a group off
// the grid idles through it.
template <int kBuffers, typename Stage, typename Compute>
__device__ __forceinline__ void ffma_steps(const FfmaShape& s,
                                           const FfmaItem& lead, int ks,
                                           Stage stage, Compute compute) {
  const int T = ks * ks;
  auto next = [&](int v) {
    int ii, jj;
    while (v < T && s.G == 1 && !ffma_row(s, lead, ks, v, ii, jj)) ++v;
    return v;
  };
  if constexpr (kBuffers == 1) {
    for (int v = next(0); v < T; v = next(v + 1)) {
      __syncthreads();  // every group is done with the staged row
      stage(v, 0);
      mma16::cp_async_commit();
      mma16::cp_async_wait<0>();
      __syncthreads();  // step v landed
      compute(v, 0);
    }
    return;
  }
  int v = next(0);
  if (v < T) stage(v, 0);
  mma16::cp_async_commit();
  int buf = 0;
  while (v < T) {
    const int vn = next(v + 1);
    mma16::cp_async_wait<0>();
    __syncthreads();  // step v landed; every group is done with buf ^ 1
    if (vn < T) stage(vn, buf ^ 1);
    mma16::cp_async_commit();
    compute(v, buf);
    v = vn;
    buf ^= 1;
  }
}

// C == 1 (the 1->16 layer, the 16->1 layer's dx): a thread owns R
// consecutive outputs (k, l .. l + R - 1) of one k row x OT output
// channels (R x OT float32 accumulators); the lanes of a warp run down k.
// Per dk it holds its input window's R + ks - 1 activations in registers
// (one scalar shared load each) and, per dl, the OT weights of the tap as
// broadcast float4s, which feed R x OT FMAs: output s takes window entry
// s + dl, so its terms come in (dk, dl) order. KS = 0: any kernel size,
// the window read from shared memory a use.
template <int KS, int OT, int R>
__global__ void __launch_bounds__(kFfmaMaxThreads, 1)
    conv4d_fwd_ffma_c1(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, const FfmaShape s) {
  extern __shared__ __align__(16) float ffma_smem[];
  const int ks = KS > 0 ? KS : s.ks;
  const int p = ks / 2;
  const int T = ks * ks;
  const int KL = s.K * s.L;
  const int tid = threadIdx.x;
  const int g = min(tid / s.S, s.G - 1);
  const int t = tid - g * s.S;  // >= S past the last group's threads
  const bool in_group = t < s.S;
  const int o0 = blockIdx.y * OT;
  const long long item0 = (long long)blockIdx.x * s.G;
  const FfmaItem it = ffma_item(s, item0 + g);
  const FfmaItem lead = ffma_item(s, item0);
  const int k0 = it.tile * s.tile;
  const int kl = t % s.tile;   // lanes run down k
  const int seg = t / s.tile;  // < n_seg in a group
  const bool owner = in_group && it.valid && k0 + kl < s.K;
  float* sw = ffma_smem;  // [2][T][OT]
  float* sx = ffma_smem + 2 * s.w_floats + (size_t)g * 2 * s.x_floats;
  ffma_zero(ffma_smem, 2 * (s.w_floats + s.G * s.x_floats));

  float acc[R][OT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[r][o] = 0.f;

  auto stage = [&](int v, int buf) {
    // step v's weights as [tap][OT]: channels past O stay 0
    float* dw = sw + buf * s.w_floats;
    const float* wv = w + (int64_t)v * T * s.O + o0;
    if (s.vec_w) {
      for (int e = tid; e < T * (OT / 4); e += blockDim.x) {
        const int tap = e / (OT / 4), q = e % (OT / 4);
        if (o0 + 4 * q < s.O)
          mma16::cp_async16(dw + tap * OT + 4 * q,
                            wv + (int64_t)tap * s.O + 4 * q, 16);
      }
    } else {
      for (int e = tid; e < T * OT; e += blockDim.x) {
        const int tap = e / OT, oo = e % OT;
        if (o0 + oo < s.O) cp_async4(dw + tap * OT + oo, wv + (int64_t)tap * s.O + oo);
      }
    }
    int ii, jj;
    if (!in_group || !ffma_row(s, it, ks, v, ii, jj)) return;
    // the on-grid cells of the tile's halo rows k0 - p .. k0 + tile + p - 1
    const int k_lo = max(0, k0 - p), k_hi = min(s.K, k0 + s.tile + p);
    const float* xr = x + (((int64_t)it.b * s.I + ii) * s.J + jj) * KL +
                      (int64_t)k_lo * s.L;
    float* xb = sx + buf * s.x_floats + (k_lo - k0 + p) * s.W + p;
    ffma_cells(k_hi - k_lo, s.L, t, s.S, [&](int r, int c) {
      cp_async4(xb + r * s.W + c, xr + (int64_t)r * s.L + c);
    });
  };

  auto compute = [&](int v, int buf) {
    int ii, jj;
    if (!owner || !ffma_row(s, it, ks, v, ii, jj)) return;
    const float* xk = sx + buf * s.x_floats + kl * s.W + seg * R;
    const float4* wk = reinterpret_cast<const float4*>(sw + buf * s.w_floats);
#pragma unroll 1
    for (int dk = 0; dk < ks; ++dk, xk += s.W, wk += ks * (OT / 4)) {
      if constexpr (KS > 0) {
        float xw[R + KS - 1];  // the input window of row k + dk - p
#pragma unroll
        for (int e = 0; e < R + KS - 1; ++e) xw[e] = xk[e];
#pragma unroll
        for (int dl = 0; dl < KS; ++dl)
#pragma unroll
          for (int o4 = 0; o4 < OT / 4; ++o4) {
            const float4 wv = wk[dl * (OT / 4) + o4];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][4 * o4 + 0] = fmaf(xw[r + dl], wv.x, acc[r][4 * o4 + 0]);
              acc[r][4 * o4 + 1] = fmaf(xw[r + dl], wv.y, acc[r][4 * o4 + 1]);
              acc[r][4 * o4 + 2] = fmaf(xw[r + dl], wv.z, acc[r][4 * o4 + 2]);
              acc[r][4 * o4 + 3] = fmaf(xw[r + dl], wv.w, acc[r][4 * o4 + 3]);
            }
          }
      } else {
        for (int dl = 0; dl < ks; ++dl)
#pragma unroll
          for (int o4 = 0; o4 < OT / 4; ++o4) {
            const float4 wv = wk[dl * (OT / 4) + o4];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xv = xk[r + dl];
              acc[r][4 * o4 + 0] = fmaf(xv, wv.x, acc[r][4 * o4 + 0]);
              acc[r][4 * o4 + 1] = fmaf(xv, wv.y, acc[r][4 * o4 + 1]);
              acc[r][4 * o4 + 2] = fmaf(xv, wv.z, acc[r][4 * o4 + 2]);
              acc[r][4 * o4 + 3] = fmaf(xv, wv.w, acc[r][4 * o4 + 3]);
            }
          }
      }
    }
  };

  ffma_steps<2>(s, lead, ks, stage, compute);

  if (!owner) return;
  const bool vec_out = s.O % 4 == 0 && o0 + OT <= s.O;
  float* dst = out + ((((int64_t)it.b * s.I + it.i) * s.J + it.j) * KL +
                      (k0 + kl) * s.L + seg * R) * s.O + o0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (seg * R + r >= s.L) break;
    float* d = dst + (int64_t)r * s.O;
    if (vec_out) {
#pragma unroll
      for (int o4 = 0; o4 < OT / 4; ++o4)
        reinterpret_cast<float4*>(d)[o4] = make_float4(
            acc[r][4 * o4 + 0] + bias[o0 + 4 * o4 + 0],
            acc[r][4 * o4 + 1] + bias[o0 + 4 * o4 + 1],
            acc[r][4 * o4 + 2] + bias[o0 + 4 * o4 + 2],
            acc[r][4 * o4 + 3] + bias[o0 + 4 * o4 + 3]);
    } else {
#pragma unroll
      for (int o = 0; o < OT; ++o)
        if (o0 + o < s.O) d[o] = acc[r][o] + bias[o0 + o];
    }
  }
}

// O == 1, C >= 2 (the 16->1 layer): a thread owns R consecutive outputs
// (k, l .. l + R - 1) of one k row; the lanes of a warp run down k. Per
// dk it holds the ks x 16 weights w[di, dj, dk, :, :] in registers (KS >
// 0, C <= 16) and walks its input window (l .. l + R + ks - 2) in (ll, c)
// order, one float4 load a 4-channel chunk, FMA-ing each chunk into every
// owned output whose window covers it: output s takes it as tap dl = ll -
// s, so its terms still come in (dk, dl, c) order, and a staged
// activation feeds up to ks outputs instead of one. One staged row a
// group (ffma_steps<1>). KS = 0: any kernel size and channel count, the
// weights read from shared memory a use.
template <int KS, int R>
__global__ void __launch_bounds__(kFfmaMaxThreads, 1)
    conv4d_fwd_ffma_o1(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, const FfmaShape s) {
  extern __shared__ __align__(16) float ffma_smem[];
  constexpr bool kReg = KS > 0;
  const int ks = kReg ? KS : s.ks;
  const int p = ks / 2;
  const int T = ks * ks;
  const int KL = s.K * s.L;
  const int rec = kReg ? kO1Rec : s.rec;
  const int tid = threadIdx.x;
  const int g = min(tid / s.S, s.G - 1);
  const int t = tid - g * s.S;
  const bool in_group = t < s.S;
  const long long item0 = (long long)blockIdx.x * s.G;
  const FfmaItem it = ffma_item(s, item0 + g);
  const FfmaItem lead = ffma_item(s, item0);
  const int k0 = it.tile * s.tile;
  const int kl = t % s.tile;   // lanes run down k
  const int seg = t / s.tile;  // < n_seg in a group
  const bool owner = in_group && it.valid && k0 + kl < s.K;
  float* sw = ffma_smem;  // [T][rec], one staged step
  float* sx = ffma_smem + s.w_floats + (size_t)g * s.x_floats;
  ffma_zero(ffma_smem, s.w_floats + s.G * s.x_floats);

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  auto stage = [&](int v, int) {
    // step v's weights as [tap][rec]: channels past C stay 0
    float* dw = sw;
    const float* wv = w + (int64_t)v * T * s.C;
    if (s.vec_w) {
      const int c4s = s.C / 4;
      for (int e = tid; e < T * c4s; e += blockDim.x) {
        const int tap = e / c4s, q = e % c4s;
        mma16::cp_async16(dw + tap * rec + 4 * q, wv + tap * s.C + 4 * q, 16);
      }
    } else {
      for (int e = tid; e < T * s.C; e += blockDim.x) {
        const int tap = e / s.C, c = e % s.C;
        cp_async4(dw + tap * rec + c, wv + tap * s.C + c);
      }
    }
    int ii, jj;
    if (!in_group || !ffma_row(s, it, ks, v, ii, jj)) return;
    // the on-grid cells of the tile's halo rows k0 - p .. k0 + tile + p - 1
    const int k_lo = max(0, k0 - p), k_hi = min(s.K, k0 + s.tile + p);
    const float* xr = x + (((int64_t)it.b * s.I + ii) * s.J + jj) * KL * s.C;
    float* xb = sx;
    const int hk0 = k_lo - k0 + p;  // halo row of k_lo
    if (s.vec_x) {
      const int c4s = s.C / 4;
      ffma_cells(k_hi - k_lo, s.L * c4s, t, s.S, [&](int r, int q) {
        const int ll = q / c4s, c4 = q - ll * c4s, hk = hk0 + r;
        mma16::cp_async16(
            xb + (hk * s.W + p + ll) * rec + 4 * o1_slot(c4, hk),
            xr + ((int64_t)(k_lo + r) * s.L + ll) * s.C + 4 * c4, 16);
      });
    } else {
      ffma_cells(k_hi - k_lo, s.L * s.C, t, s.S, [&](int r, int q) {
        const int ll = q / s.C, c = q - ll * s.C, hk = hk0 + r;
        cp_async4(xb + (hk * s.W + p + ll) * rec + 4 * o1_slot(c >> 2, hk) +
                      (c & 3),
                  xr + ((int64_t)(k_lo + r) * s.L + ll) * s.C + c);
      });
    }
  };

  auto compute = [&](int v, int) {
    int ii, jj;
    if (!owner || !ffma_row(s, it, ks, v, ii, jj)) return;
    const float* xb = sx;
    const float* wb = sw;
#pragma unroll 1
    for (int dk = 0; dk < ks; ++dk) {
      const int hk = kl + dk;
      const float* xrow = xb + (hk * s.W + seg * R) * rec;
      if constexpr (kReg) {
        float4 wr[KS][4];  // w[dk, dl, 4 c4 .. 4 c4 + 3]
#pragma unroll
        for (int dl = 0; dl < KS; ++dl)
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4)
            wr[dl][c4] = reinterpret_cast<const float4*>(
                wb + (dk * KS + dl) * kO1Rec)[c4];
        const float* xp[4];
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) xp[c4] = xrow + 4 * o1_slot(c4, hk);
#pragma unroll
        for (int ll = 0; ll < R + KS - 1; ++ll) {
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xp[c4] + ll * kO1Rec);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int dl = ll - r;
              if (dl < 0 || dl >= KS) continue;
              acc[r] = fmaf(xv.x, wr[dl][c4].x, acc[r]);
              acc[r] = fmaf(xv.y, wr[dl][c4].y, acc[r]);
              acc[r] = fmaf(xv.z, wr[dl][c4].z, acc[r]);
              acc[r] = fmaf(xv.w, wr[dl][c4].w, acc[r]);
            }
          }
        }
      } else {
        for (int ll = 0; ll < R + ks - 1; ++ll) {
          for (int c4 = 0; c4 < s.C4p; ++c4) {
            const float4 xv = *reinterpret_cast<const float4*>(
                xrow + ll * rec + 4 * o1_slot(c4, hk));
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int dl = ll - r;
              if (dl < 0 || dl >= ks) continue;
              const float4 wv = reinterpret_cast<const float4*>(
                  wb + (dk * ks + dl) * rec)[c4];
              acc[r] = fmaf(xv.x, wv.x, acc[r]);
              acc[r] = fmaf(xv.y, wv.y, acc[r]);
              acc[r] = fmaf(xv.z, wv.z, acc[r]);
              acc[r] = fmaf(xv.w, wv.w, acc[r]);
            }
          }
        }
      }
    }
  };

  ffma_steps<1>(s, lead, ks, stage, compute);

  if (!owner) return;
  float* dst = out + (((int64_t)it.b * s.I + it.i) * s.J + it.j) * KL +
               (k0 + kl) * s.L + seg * R;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (seg * R + r < s.L) dst[r] = acc[r] + bias[0];
}

// The test-only chain oracle: one thread an output, the whole (di, dj,
// dk, dl, c) chain in that order with every tap (an input off the grid
// reads 0), fmaf from +0, the bias added last. Nothing on the main path
// launches it; the tests hold the FFMA kernels to it bit for bit.
__global__ void __launch_bounds__(256)
    conv4d_fwd_chain_oracle_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out, int B, int I,
                                   int J, int K, int L, int C, int O, int ks) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (int64_t)B * I * J * K * L * O) return;
  int64_t r = n;
  const int o = (int)(r % O);
  r /= O;
  const int l = (int)(r % L);
  r /= L;
  const int k = (int)(r % K);
  r /= K;
  const int j = (int)(r % J);
  r /= J;
  const int i = (int)(r % I);
  const int b = (int)(r / I);
  const int p = ks / 2;
  float acc = 0.f;
  for (int di = 0; di < ks; ++di)
    for (int dj = 0; dj < ks; ++dj)
      for (int dk = 0; dk < ks; ++dk)
        for (int dl = 0; dl < ks; ++dl) {
          const int ii = i + di - p, jj = j + dj - p, kk = k + dk - p,
                    ll = l + dl - p;
          const bool on = ii >= 0 && ii < I && jj >= 0 && jj < J && kk >= 0 &&
                          kk < K && ll >= 0 && ll < L;
          const float* xs =
              x + (((((int64_t)b * I + ii) * J + jj) * K + kk) * L + ll) * C;
          const float* ws =
              w + ((((int64_t)di * ks + dj) * ks + dk) * ks + dl) * C * O + o;
          for (int c = 0; c < C; ++c)
            acc = fmaf(on ? xs[c] : 0.f, ws[(int64_t)c * O], acc);
        }
  out[n] = acc + bias[o];
}

// The FFMA plan of a float32 layer with C == 1 or O == 1 (the kernel
// taken, its tile, groups and shared memory), from the shape and the
// block's shared-memory limit alone. kernels/conv4d.py::ffma_plan mirrors
// it. Returns 0 or an error code.
struct FfmaPlan {
  FfmaShape s;
  int o1;       // 1: conv4d_fwd_ffma_o1; 0: conv4d_fwd_ffma_c1
  int KS;       // the kernel's KS: ks where unrolled (3 or 5), else 0
  int R;        // outputs a thread along l
  int threads;  // a block
  long long blocks;
  size_t smem;
};

int plan_ffma(int B, int I, int J, int K, int L, int C, int O, int ks,
              int max_smem, FfmaPlan& plan) {
  FfmaShape& s = plan.s;
  s = FfmaShape{B, I, J, K, L, C, O, ks};
  const int p = ks / 2;
  const int T = ks * ks;
  plan.o1 = C >= 2;
  const bool unrolled = ks == 3 || ks == 5;
  // R = 5 or 4 outputs a thread along l, whichever pads the row less (5
  // on a tie); W odd, so lanes down k read distinct banks
  plan.R = (L + 4) / 5 * 5 <= (L + 3) / 4 * 4 ? 5 : 4;
  s.n_seg = (L + plan.R - 1) / plan.R;
  if (s.n_seg > kFfmaMaxThreads) return kErrSharedMemory;
  s.W = (s.n_seg * plan.R + 2 * p) | 1;
  // C == 1 double-buffers its rows and weights, O == 1 stages one of each
  const size_t buffers = plan.o1 ? 1 : 2;
  if (!plan.o1) {  // C == 1
    plan.KS = unrolled ? ks : 0;
    s.OT = O <= 4 ? 4 : (O <= 8 ? 8 : 16);
    s.rec = 1;
  } else {  // O == 1
    const bool reg = unrolled && C <= 16;
    plan.KS = reg ? ks : 0;
    s.OT = 1;
    s.C4p = reg ? 4 : ((C + 3) / 4 + 3) / 4 * 4;
    s.rec = 4 * s.C4p;
  }
  s.w_floats = (T * s.OT * s.rec + 3) / 4 * 4;
  // k rows a tile: as many as the block's threads and shared memory take
  int tile = K < kFfmaMaxThreads / s.n_seg ? K : kFfmaMaxThreads / s.n_seg;
  auto x_floats = [&](int rows) {
    return ((size_t)(rows + 2 * p) * s.W * s.rec + 3) / 4 * 4;
  };
  while (tile > 0 && 4 * buffers * (x_floats(tile) + s.w_floats) >
                         (size_t)max_smem)
    --tile;
  if (tile == 0) return kErrSharedMemory;
  s.n_tiles = (K + tile - 1) / tile;
  s.tile = (K + s.n_tiles - 1) / s.n_tiles;
  s.x_floats = (int)x_floats(s.tile);
  s.S = s.tile * s.n_seg;
  s.n_items = (long long)B * I * J * s.n_tiles;
  const size_t group_bytes = 4 * buffers * s.x_floats;
  const size_t w_bytes = 4 * buffers * s.w_floats;
  long long G = kFfmaGroupTarget / s.S;
  if (G > s.n_items) G = s.n_items;
  if (G < 1) G = 1;
  while (G > 1 && w_bytes + G * group_bytes > (size_t)max_smem) --G;
  s.G = (int)G;
  plan.smem = w_bytes + G * group_bytes;
  plan.threads = (s.G * s.S + 31) / 32 * 32;
  plan.blocks = (s.n_items + G - 1) / G;
  if (plan.blocks > 2147483647LL) return kErrGrid;
  return 0;
}

template <typename Kernel>
int launch_ffma(Kernel kernel, const void* x, const void* w,
                const float* bias, void* out, const FfmaPlan& plan,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)plan.blocks,
                  plan.o1 ? 1 : (plan.s.O + plan.s.OT - 1) / plan.s.OT);
  kernel<<<grid, plan.threads, plan.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), plan.s);
  return (int)cudaGetLastError();
}

template <int KS, int R>
int launch_c1(const void* x, const void* w, const float* bias, void* out,
              const FfmaPlan& plan, cudaStream_t stream) {
  if (plan.s.OT == 4)
    return launch_ffma(conv4d_fwd_ffma_c1<KS, 4, R>, x, w, bias, out, plan,
                       stream);
  if (plan.s.OT == 8)
    return launch_ffma(conv4d_fwd_ffma_c1<KS, 8, R>, x, w, bias, out, plan,
                       stream);
  return launch_ffma(conv4d_fwd_ffma_c1<KS, 16, R>, x, w, bias, out, plan,
                     stream);
}

template <int KS>
int launch_c1(const void* x, const void* w, const float* bias, void* out,
              const FfmaPlan& plan, cudaStream_t stream) {
  if (plan.R == 5) return launch_c1<KS, 5>(x, w, bias, out, plan, stream);
  return launch_c1<KS, 4>(x, w, bias, out, plan, stream);
}

template <int KS>
int launch_o1(const void* x, const void* w, const float* bias, void* out,
              const FfmaPlan& plan, cudaStream_t stream) {
  if (plan.R == 5)
    return launch_ffma(conv4d_fwd_ffma_o1<KS, 5>, x, w, bias, out, plan, stream);
  return launch_ffma(conv4d_fwd_ffma_o1<KS, 4>, x, w, bias, out, plan, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (see the header).

constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcMT = 5;                       // m16 tiles a warp
constexpr int kTcTile = kTcWarps * kTcMT * 16;  // 640 positions a block
constexpr int kZRows = 112;  // Z rows a warp on kModeDlN (7 m16 tiles)
constexpr int kZStride = 9;  // floats a Z row: odd, so gathers miss no bank

// What the GEMM's M, N and K run over.
constexpr int kModeChannels = 0;  // M = positions, N = o, K = (dk, dl, 16 c)
constexpr int kModeTaps = 1;      // C == 1: M = positions, N = o, K = (dk, dl)
constexpr int kModeDlN = 2;       // O == 1: M = halo positions, N = dl, K = c

struct TcShape {
  int B, I, J, K, L, C, O, ks;
  int mode;
  int CG;       // 16-channel groups; 0 when C == 1 (K over the taps)
  int NK;       // k-steps of 16 per staged (di, dj) row
  int HP;       // halo positions of the largest position tile
  int x_bytes;  // staged halo bytes per buffer (a multiple of 16)
  int w_bytes;  // staged weight bytes per buffer
  int vec_x;    // stage the halo with cp.async (C % 8 == 0, 16-byte aligned)
  int vec_w;    // stage the weights with cp.async (O % 8 == 0, aligned)
};

// NT: n8 tiles a block (8 * NT output channels); kMode: one of the modes.
template <int NT, int kMode>
__global__ void __launch_bounds__(kTcThreads, 2)
    conv4d_fwd_bf16_tc(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, const TcShape s) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  using namespace mma16;
  constexpr bool kTap = kMode == kModeTaps;
  constexpr bool kDlN = kMode == kModeDlN;
  const int p = s.ks / 2;
  const int KL = s.K * s.L;
  const int cols = s.L + 2 * p;
  const int T = s.ks * s.ks;
  const int OT = 8 * NT;
  const int n_otiles = (s.O + OT - 1) / OT;
  const int tile = blockIdx.x / n_otiles;
  const int o0 = (blockIdx.x % n_otiles) * OT;
  const int j = blockIdx.y;
  const int b = blockIdx.z / s.I;
  const int i = blockIdx.z % s.I;
  const int p0 = tile * kTcTile;
  const int p1 = min(p0 + kTcTile, KL);
  const int kmin = p0 / s.L;
  const int rows = (p1 - 1) / s.L - kmin + 1 + 2 * p;
  const int hp = rows * cols;  // this tile's staged halo positions
  const int stage_bytes = s.x_bytes + s.w_bytes;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m_warp = warp * kTcMT * 16;  // first position of the warp
  const int n_mt = max(0, min(kTcMT, (p1 - p0 - m_warp + 15) / 16));

  // the halo index of an output position at tap (0, 0); rows past the
  // tile read position 0 (their sums are never stored)
  auto halo_of = [&](int m) {
    const int pos = p0 + m;
    return pos < p1 ? (pos / s.L - kmin) * cols + pos % s.L : 0;
  };
  int hrow[kTcMT][2];  // general: [mt][0] = ldmatrix row; tap: rows g, g+8
#pragma unroll
  for (int mt = 0; mt < kTcMT; ++mt) {
    const int m = m_warp + mt * 16;
    if (kTap) {
      hrow[mt][0] = halo_of(m + (lane >> 2));
      hrow[mt][1] = halo_of(m + (lane >> 2) + 8);
    } else {
      hrow[mt][0] = halo_of(m + (lane & 15));
      hrow[mt][1] = 0;
    }
  }

  float acc[kTcMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kTcMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto on_rows = [&](int v) {
    const int ii = i + v / s.ks - p;
    const int jj = j + v % s.ks - p;
    return ii >= 0 && ii < s.I && jj >= 0 && jj < s.J;
  };
  auto next_tap = [&](int v) {
    while (v < T && !on_rows(v)) ++v;
    return v;
  };

  const int64_t row_elems = (int64_t)KL * s.C;
  auto stage = [&](int v, int buf) {
    unsigned char* xs = tc_smem + buf * stage_bytes;
    unsigned char* ws = xs + s.x_bytes;
    const int ii = i + v / s.ks - p;
    const int jj = j + v % s.ks - p;
    const __nv_bfloat16* xr =
        x + (((int64_t)b * s.I + ii) * s.J + jj) * row_elems;
    stage_halo(xs, xr, kmin, rows, cols, p, s.K, s.L, s.C, s.CG, s.HP,
               s.vec_x, tid, kTcThreads);
    // the weight slice as [k row][OT]: k row = (tap, c) of the contraction
    const __nv_bfloat16* wr = w + (int64_t)v * T * s.C * s.O;
    auto row_tc = [&](int krow, int& t, int& c) {
      if (kTap) {
        t = krow;
        c = 0;
        return t < T;
      }
      const int kstep = krow >> 4;
      t = s.CG == 1 ? kstep : kstep / s.CG;
      c = (s.CG == 1 ? 0 : kstep % s.CG) * 16 + (krow & 15);
      return c < s.C;
    };
    if (kDlN) {  // [(dk, 16 c)][8 dl]: B of the per-dk GEMM
      for (int e = tid; e < s.NK * 16 * 8; e += kTcThreads) {
        const int dl = e & 7;
        const int kstep = e >> 7;  // (dk, channel group)
        const int c = (kstep % s.CG) * 16 + ((e >> 3) & 15);
        const int t = (kstep / s.CG) * s.ks + dl;
        reinterpret_cast<uint16_t*>(ws)[e] =
            (c < s.C && dl < s.ks) ? bf16_bits(wr[(int64_t)t * s.C + c])
                                   : (uint16_t)0;
      }
      return;
    }
    const int krows = s.NK * 16;
    if (s.vec_w) {
      for (int e = tid; e < krows * NT; e += kTcThreads) {
        const int q = e % NT;
        const int krow = e / NT;
        int t, c;
        const bool ok = row_tc(krow, t, c) && o0 + q * 8 < s.O;
        const __nv_bfloat16* src =
            ok ? wr + ((int64_t)t * s.C + c) * s.O + o0 + q * 8 : wr;
        cp_async16(ws + swizzle(krow, q, NT), src, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < krows * OT; e += kTcThreads) {
        const int o = e % OT;
        const int krow = e / OT;
        int t, c;
        const bool ok = row_tc(krow, t, c) && o0 + o < s.O;
        *reinterpret_cast<uint16_t*>(ws + swizzle(krow, o >> 3, NT) +
                                     (o & 7) * 2) =
            ok ? bf16_bits(wr[((int64_t)t * s.C + c) * s.O + o0 + o])
               : (uint16_t)0;
      }
    }
  };

  auto compute = [&](int buf) {
    const unsigned char* xs = tc_smem + buf * stage_bytes;
    const uint32_t xs_addr = smem_addr(xs);
    const uint32_t ws_addr = smem_addr(xs + s.x_bytes);
    const uint16_t* xh = reinterpret_cast<const uint16_t*>(xs);
    const int mi = lane >> 3;
    // B: the [tap*c][o] weights of k-step st, used by all 5 m-tiles
    auto load_b = [&](int st, uint32_t (&bf)[NT][2]) {
      const int krow = st * 16 + (mi & 1) * 8 + (lane & 7);
      if constexpr (NT == 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws_addr + swizzle(krow, mi >> 1, 2));
        bf[0][0] = r[0], bf[0][1] = r[1], bf[1][0] = r[2], bf[1][1] = r[3];
      } else {
        ldmatrix_x2_trans(bf[0][0], bf[0][1], ws_addr + swizzle(krow, 0, 1));
      }
    };
    if constexpr (kTap) {
      for (int st = 0; st < s.NK; ++st) {
        uint32_t bf[NT][2];
        load_b(st, bf);
        int off[4];  // taps of this lane's A columns 2c, 2c+1, 2c+8, 2c+9
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = st * 16 + 2 * (lane & 3) + (q & 1) + (q >> 1) * 8;
          off[q] = t < T ? (t / s.ks) * cols + t % s.ks : 0;
        }
#pragma unroll
        for (int mt = 0; mt < kTcMT; ++mt) {
          if (mt >= n_mt) break;
          const int h0 = hrow[mt][0], h1 = hrow[mt][1];
          const uint32_t a[4] = {pack(xh[h0 + off[0]], xh[h0 + off[1]]),
                                 pack(xh[h1 + off[0]], xh[h1 + off[1]]),
                                 pack(xh[h0 + off[2]], xh[h0 + off[3]]),
                                 pack(xh[h1 + off[2]], xh[h1 + off[3]])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    } else {
      // k-step st = (dk * ks + dl) * CG + cg: the halo records of tap
      // (dk, dl) start dk * (L+2p) + dl positions on
      int st = 0;
      for (int dk = 0; dk < s.ks; ++dk)
        for (int dl = 0; dl < s.ks; ++dl)
          for (int cg = 0; cg < s.CG; ++cg, ++st) {
            uint32_t bf[NT][2];
            load_b(st, bf);
            const int rec = cg * s.HP + dk * cols + dl;
#pragma unroll
            for (int mt = 0; mt < kTcMT; ++mt) {
              if (mt >= n_mt) break;
              uint32_t a[4];
              ldmatrix_x4(a,
                          xs_addr + swizzle(rec + hrow[mt][0], lane >> 4, 2));
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
            }
          }
    }
  };

  // kModeDlN: per dk, Z[u][dl] = sum_c x_halo[u + dk*(L+2p), c] *
  // w[dk, dl, c] over the halo rows u of this warp's 80 positions (one
  // GEMM, N = dl), then out[pos] += sum_dl Z[u(pos) + dl][dl] from the
  // warp's own shared rows: a fifth of the per-tap form's MMAs at O = 1
  const int zm0 = p0 + m_warp;
  const int zm1 = min(zm0 + kTcMT * 16, p1);
  const int umin = halo_of(m_warp);
  const int n_zt = n_mt > 0
      ? (halo_of(zm1 - 1 - p0) - umin + s.ks + 15) / 16 : 0;  // <= 7
  int uo[3];
  float zout[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int pos = zm0 + lane + 32 * q;
    uo[q] = pos < zm1 ? halo_of(pos - p0) - umin : 0;
  }
  float* zw = reinterpret_cast<float*>(tc_smem + 2 * stage_bytes) +
              warp * kZRows * kZStride;
  auto compute_dln = [&](int buf) {
    const unsigned char* xs = tc_smem + buf * stage_bytes;
    const uint32_t xs_addr = smem_addr(xs);
    const uint32_t ws_addr = smem_addr(xs + s.x_bytes);
    for (int dk = 0; dk < s.ks; ++dk) {
      float z[kZRows / 16][4];
#pragma unroll
      for (int mt = 0; mt < kZRows / 16; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[mt][e] = 0.f;
      for (int cg = 0; cg < s.CG; ++cg) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          ws_addr + ((dk * s.CG + cg) * 16 +
                                     ((lane >> 3) & 1) * 8 + (lane & 7)) * 16);
#pragma unroll
        for (int mt = 0; mt < kZRows / 16; ++mt) {
          if (mt >= n_zt) break;
          const int u = min(umin + dk * cols + mt * 16 + (lane & 15), hp - 1);
          uint32_t a[4];
          ldmatrix_x4(a, xs_addr + swizzle(cg * s.HP + u, lane >> 4, 2));
          mma_bf16(z[mt], a, b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kZRows / 16; ++mt) {
        if (mt >= n_zt) break;
        float* zr = zw + (mt * 16 + (lane >> 2)) * kZStride + 2 * (lane & 3);
        zr[0] = z[mt][0];
        zr[1] = z[mt][1];
        zr[8 * kZStride] = z[mt][2];
        zr[8 * kZStride + 1] = z[mt][3];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 3; ++q)
        if (zm0 + lane + 32 * q < zm1)
          for (int dl = 0; dl < s.ks; ++dl)
            zout[q] += zw[(uo[q] + dl) * kZStride + dl];
      __syncwarp();  // the gathers are done before the next dk's rows land
    }
  };

  // double-buffered over the (di, dj) rows on the grid: the copy of the
  // next row is in flight while this row's MMAs run
  int v = next_tap(0);  // (p, p) is always on the grid
  stage(v, 0);
  cp_async_commit();
  int buf = 0;
  while (v < T) {
    const int vn = next_tap(v + 1);
    if (vn < T) stage(vn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (n_mt > 0) {
      if constexpr (kDlN)
        compute_dln(buf);
      else
        compute(buf);
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
    v = vn;
    buf ^= 1;
  }

  __nv_bfloat16* dst =
      out + (((int64_t)b * s.I + i) * s.J + j) * (int64_t)KL * s.O;
  if constexpr (kDlN) {  // O == 1
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int pos = zm0 + lane + 32 * q;
      if (pos < zm1) dst[pos] = __float2bfloat16_rn(zout[q] + bias[0]);
    }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < kTcMT; ++mt) {
    if (mt >= n_mt) break;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = p0 + m_warp + mt * 16 + (lane >> 2) + half * 8;
        const int o = o0 + nt * 8 + 2 * (lane & 3);  // and o + 1
        if (pos >= p1 || o >= s.O) continue;
        const float v0 = acc[mt][nt][2 * half] + bias[o];
        __nv_bfloat16* d = dst + (int64_t)pos * s.O + o;
        if (o + 1 < s.O && s.O % 2 == 0) {  // a 4-byte aligned pair
          *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(
              v0, acc[mt][nt][2 * half + 1] + bias[o + 1]);
        } else {
          d[0] = __float2bfloat16_rn(v0);
          if (o + 1 < s.O)
            d[1] = __float2bfloat16_rn(acc[mt][nt][2 * half + 1] + bias[o + 1]);
        }
      }
  }
}

template <int NT, int kMode>
int launch_tc(const void* x, const void* w, const float* bias, void* out,
              const TcShape& s, int n_tiles, size_t smem,
              cudaStream_t stream) {
  auto kernel = conv4d_fwd_bf16_tc<NT, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_otiles = (s.O + 8 * NT - 1) / (8 * NT);
  const dim3 grid(n_tiles * n_otiles, s.J, s.B * s.I);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 route on the tensor cores: split-TF32 (see the header).

// The float32 routes, by shape alone (f32_route): never a retry after a
// failed build or launch, which raises. C == 1 and O == 1 run on FFMA
// (conv4d_fwd_ffma_c1 and conv4d_fwd_ffma_o1, bitwise the chain oracle);
// on an H100 at 8 samples on 25^4 (PERF.md):
//   * C == 1 (the 1->16 layer, and the 16->1 layer's dx): 1.73 ms. A
//     split-TF32 form with K over the taps took 3.54 ms against the
//     generic FFMA kernel's 3.19, with too little work a staged row to
//     hide the row's load, split and barriers;
//   * O == 1 (the 16->1 layer): 2.35 ms. A split-TF32 form with the
//     bfloat16 route's Z pass (N over dl) took 8.8 ms against the generic
//     FFMA kernel's 10.9, at 2.1e-6 of the scale from the plain version
//     (FFMA: 5.7e-6), but on the PF-Pascal gradient check's batch its
//     last bits route the score objective's max and ReLU gradients
//     otherwise than the plain float32 version does (3.1e-4 of the scale
//     off float64, against 5.6e-5), past that check's gate. The FFMA
//     kernels keep every output's bits, so no gate moves.
constexpr int kRouteFfma = 0;
constexpr int kRouteTf32x3 = 1;
constexpr int kRouteBf16 = 2;

int f32_route(int C, int O) {
  return C >= 2 && O >= 2 ? kRouteTf32x3 : kRouteFfma;
}

struct F32Shape {
  int B, I, J, K, L, C, O, ks;
  int CG;       // 16-channel groups
  int HP;       // halo positions of the largest position tile
  int krows;    // k rows (tap, channel) of a staged (di, dj) row's weights
  int x_bytes;  // bytes of one halo array (raw, hi or lo; a multiple of 64)
  int w_bytes;  // bytes of one weight array (hi or lo)
  int vec_x;    // stage the halo with cp.async (C % 4 == 0, 16-byte aligned)
  int vec_w;    // load the weights as float4 (O % 4 == 0, 16-byte aligned)
};

// NT: n8 tiles a block (8 * NT output channels); MT: m16 tiles a warp (the
// tile is 8 warps x MT x 16 positions). Shared memory: the halo's hi, lo
// and raw (next row) arrays, then the weights' hi and lo arrays.
template <int NT, int MT>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv4d_fwd_tf32x3_tc(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         float* __restrict__ out, const F32Shape s) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  using namespace mma16;
  using namespace mma32;
  constexpr int OT = 8 * NT;
  constexpr int kTilePos = kTcWarps * MT * 16;
  const int p = s.ks / 2;
  const int KL = s.K * s.L;
  const int cols = s.L + 2 * p;
  const int T = s.ks * s.ks;
  const int n_otiles = (s.O + OT - 1) / OT;
  const int tile = blockIdx.x / n_otiles;
  const int o0 = (blockIdx.x % n_otiles) * OT;
  const int j = blockIdx.y;
  const int b = blockIdx.z / s.I;
  const int i = blockIdx.z % s.I;
  const int p0 = tile * kTilePos;
  const int p1 = min(p0 + kTilePos, KL);
  const int kmin = p0 / s.L;
  const int rows = (p1 - 1) / s.L - kmin + 1 + 2 * p;
  unsigned char* xhi = tc_smem;
  unsigned char* xlo = xhi + s.x_bytes;
  unsigned char* xraw = xlo + s.x_bytes;
  unsigned char* wbufs = xraw + s.x_bytes;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m_warp = warp * MT * 16;  // first position of the warp
  const bool active = p0 + m_warp < p1;

  // the halo index of an output position at tap (0, 0); rows past the
  // tile read position 0 (their sums are never stored)
  auto halo_of = [&](int m) {
    const int pos = p0 + m;
    return pos < p1 ? (pos / s.L - kmin) * cols + pos % s.L : 0;
  };
  int hrow[MT];  // this lane's ldmatrix row: position lane % 16
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    hrow[mt] = halo_of(m_warp + mt * 16 + (lane & 15));

  // weights as [k row][OT]: output channel o of k row r sits at o ^ 8
  // when bit 1 of r is set (OT == 16), so the 4 k rows x 8 o of a B load
  // fall in 32 distinct banks; 4-channel chunks stay contiguous
  auto wslot = [](int r, int o) {
    return r * OT + (OT == 16 ? o ^ (((r >> 1) & 1) << 3) : o);
  };
  // this lane's B words at k rows c and c + 4 of a k8 step starting at a
  // multiple of 8 (which leaves bit 1 of the row to c)
  int boff[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      boff[nt][h] = wslot((lane & 3) + 4 * h, nt * 8 + (lane >> 2));

  // acc: the float32 sums; part: the tensor cores' sum over one dk slice
  // of a row (ks taps x C channels), added into acc with one rounding to
  // nearest. The MMA's own accumulation rounds toward zero, which biases
  // a long running sum (about 8e-5 of the scale over 10,000 terms on an
  // H100); over 5 x 16 terms it stays near 1e-6.
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto on_rows = [&](int v) {
    const int ii = i + v / s.ks - p;
    const int jj = j + v % s.ks - p;
    return ii >= 0 && ii < s.I && jj >= 0 && jj < s.J;
  };
  auto next_tap = [&](int v) {
    while (v < T && !on_rows(v)) ++v;
    return v;
  };

  const int64_t row_elems = (int64_t)KL * s.C;
  // the raw halo of input row v, by cp.async
  auto stage_x = [&](int v) {
    const int ii = i + v / s.ks - p;
    const int jj = j + v % s.ks - p;
    stage_halo32(xraw, x + (((int64_t)b * s.I + ii) * s.J + jj) * row_elems,
                 kmin, rows, cols, p, s.K, s.L, s.C, s.CG, s.HP, s.vec_x, tid,
                 kTcThreads);
  };

  // input row v's weights as [k row][OT], in chunks of 4 columns: chunk f
  // holds output channels 4q .. 4q+3 of k row r, with q = f % (OT/4) and
  // r = f / (OT/4). k row r = (tap t, channel group, channel), t = (r /
  // 16) / CG
  const int n_wchunks = s.krows * OT / 4;
  auto w_chunk = [&](int v, int f) {
    const int q = f % (OT / 4);
    const int r = f / (OT / 4);
    const int kstep = r >> 4;
    const int t = s.CG == 1 ? kstep : kstep / s.CG;
    const int c = (s.CG == 1 ? 0 : kstep % s.CG) * 16 + (r & 15);
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    if (c < s.C) {
      const float* src =
          w + ((int64_t)(v * T + t) * s.C + c) * s.O + o0 + 4 * q;
      if (s.vec_w) {
        if (o0 + 4 * q < s.O) {
          const float4 v4 = __ldg(reinterpret_cast<const float4*>(src));
          e[0] = v4.x, e[1] = v4.y, e[2] = v4.z, e[3] = v4.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (o0 + 4 * q + k < s.O) e[k] = src[k];
      }
    }
    return make_float4(e[0], e[1], e[2], e[3]);
  };
  auto split4 = [](const float4& v, float4& hi, float4& lo) {
    uint32_t h[4], l[4];
    tf32_split(v.x, h[0], l[0]);
    tf32_split(v.y, h[1], l[1]);
    tf32_split(v.z, h[2], l[2]);
    tf32_split(v.w, h[3], l[3]);
    hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
    lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                     __uint_as_float(l[2]), __uint_as_float(l[3]));
  };
  float* whi = reinterpret_cast<float*>(wbufs);
  float* wlo = whi + s.w_bytes / 4;
  auto put_w = [&](int f, const float4& v) {
    const int slot = wslot(f / (OT / 4), 4 * (f % (OT / 4)));
    split4(v, *reinterpret_cast<float4*>(whi + slot),
           *reinterpret_cast<float4*>(wlo + slot));
  };

  // between a row's barriers: input row v's weights into the hi and lo
  // arrays, and its landed halo into its hi and lo arrays. A thread's first
  // kWRegs weight chunks are loaded before the halo is split, so their
  // latency hides behind it
  constexpr int kWRegs = 8;
  auto split_row = [&](int v) {
    float4 wv[kWRegs];
#pragma unroll
    for (int k = 0; k < kWRegs; ++k) {
      const int f = tid + k * kTcThreads;
      if (f < n_wchunks) wv[k] = w_chunk(v, f);
    }
    const float4* raw = reinterpret_cast<const float4*>(xraw);
    float4* hi = reinterpret_cast<float4*>(xhi);
    float4* lo = reinterpret_cast<float4*>(xlo);
    for (int e = tid; e < s.x_bytes / 16; e += kTcThreads)
      split4(raw[e], hi[e], lo[e]);
#pragma unroll
    for (int k = 0; k < kWRegs; ++k) {
      const int f = tid + k * kTcThreads;
      if (f < n_wchunks) put_w(f, wv[k]);
    }
    for (int f = tid + kWRegs * kTcThreads; f < n_wchunks; f += kTcThreads)
      put_w(f, w_chunk(v, f));
  };

  const uint32_t xhi_addr = smem_addr(xhi);
  const uint32_t xlo_addr = smem_addr(xlo);
  const uint32_t* whi_u = reinterpret_cast<const uint32_t*>(whi);
  const uint32_t* wlo_u = reinterpret_cast<const uint32_t*>(wlo);
  auto compute = [&]() {
    // k rows of group st16 = (dk * ks + dl) * CG + cg start at 16 * st16;
    // the halo records of tap (dk, dl) start dk * (L+2p) + dl positions on
    int st16 = 0;
    for (int dk = 0; dk < s.ks; ++dk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
      for (int dl = 0; dl < s.ks; ++dl)
        for (int cg = 0; cg < s.CG; ++cg, ++st16) {
          const int rec = cg * s.HP + dk * cols + dl;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // channels 8h .. 8h+7 of the group
            const int wbase = (st16 * 16 + h * 8) * OT;
            uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                bh[nt][e] = whi_u[wbase + boff[nt][e]];
                bl[nt][e] = wlo_u[wbase + boff[nt][e]];
              }
            // A: 8 channels of 16 shifted positions, hi and lo
            const int chunk = 2 * h + (lane >> 4);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint32_t off = swizzle4(rec + hrow[mt], chunk);
              uint32_t ah[4], al[4];
              ldmatrix_x4(ah, xhi_addr + off);
              ldmatrix_x4(al, xlo_addr + off);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_tf32x3(part[mt][nt], ah, al, bh[nt], bl[nt]);
            }
          }
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  };

  // over the (di, dj) rows on the grid: the copy of the next row's raw
  // halo is in flight while this row's MMAs run; the next row's halo and
  // weights are split between the two barriers that close the row
  int v = next_tap(0);  // (p, p) is always on the grid
  stage_x(v);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_row(v);
  __syncthreads();
  while (v < T) {
    const int vn = next_tap(v + 1);
    if (vn < T) stage_x(vn);
    cp_async_commit();
    if (active) compute();
    cp_async_wait<0>();
    __syncthreads();  // the next row has landed; every warp is done with this
    if (vn < T) split_row(vn);
    __syncthreads();  // its hi and lo arrays are written
    v = vn;
  }

  float* dst = out + (((int64_t)b * s.I + i) * s.J + j) * (int64_t)KL * s.O;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = p0 + m_warp + mt * 16 + (lane >> 2) + half * 8;
        const int o = o0 + nt * 8 + 2 * (lane & 3);  // and o + 1
        if (pos >= p1 || o >= s.O) continue;
        const float v0 = acc[mt][nt][2 * half] + bias[o];
        float* d = dst + (int64_t)pos * s.O + o;
        if (o + 1 < s.O && s.O % 2 == 0) {  // an 8-byte aligned pair
          *reinterpret_cast<float2*>(d) =
              make_float2(v0, acc[mt][nt][2 * half + 1] + bias[o + 1]);
        } else {
          d[0] = v0;
          if (o + 1 < s.O) d[1] = acc[mt][nt][2 * half + 1] + bias[o + 1];
        }
      }
}

template <int NT, int MT>
int launch_f32_tc(const void* x, const void* w, const float* bias, void* out,
                  const F32Shape& s, int n_tiles, size_t smem,
                  cudaStream_t stream) {
  auto kernel = conv4d_fwd_tf32x3_tc<NT, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_otiles = (s.O + 8 * NT - 1) / (8 * NT);
  const dim3 grid(n_tiles * n_otiles, s.J, s.B * s.I);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}

int max_shared_memory(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The bfloat16 route: plan, check shared memory, launch.
int conv4d_fwd_bf16(const void* x, const void* w, const float* bias,
                    void* out, int B, int I, int J, int K, int L, int C,
                    int O, int ks, cudaStream_t stream) {
  const int p = ks / 2;
  const int KL = K * L;
  const int cols = L + 2 * p;
  const int n_tiles = (KL + kTcTile - 1) / kTcTile;
  int rows_max = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = t * kTcTile;
    const int p1 = KL < p0 + kTcTile ? KL : p0 + kTcTile;
    const int rows = (p1 - 1) / L - p0 / L + 1 + 2 * p;
    if (rows > rows_max) rows_max = rows;
  }
  // kModeDlN's Z rows of a warp's 80 positions: at most 79 + 2p per row
  // boundary they cross, plus ks
  const int z_rows = kTcMT * 16 - 1 + 2 * p * ((kTcMT * 16 - 1) / L + 1) + ks;
  TcShape s{B, I, J, K, L, C, O, ks};
  s.mode = C == 1 ? kModeTaps
                  : (O == 1 && ks <= 8 && z_rows <= kZRows ? kModeDlN
                                                           : kModeChannels);
  const bool tap = s.mode == kModeTaps;
  const int NT = O <= 8 ? 1 : 2;
  s.CG = tap ? 0 : (C + 15) / 16;
  s.NK = tap ? (ks * ks + 15) / 16
             : (s.mode == kModeDlN ? ks : ks * ks) * s.CG;
  s.HP = rows_max * cols;
  s.x_bytes = tap ? (s.HP * 2 + 15) / 16 * 16 : s.CG * s.HP * 32;
  s.w_bytes = s.NK * 16 * NT * 16;
  s.vec_x = !tap && C % 8 == 0 && (uintptr_t)x % 16 == 0;
  s.vec_w = O % 8 == 0 && (uintptr_t)w % 16 == 0;
  const size_t smem =
      2 * ((size_t)s.x_bytes + s.w_bytes) +
      (s.mode == kModeDlN ? (size_t)kTcWarps * kZRows * kZStride * 4 : 0);
  int max_smem = 0;
  const int err = max_shared_memory(&max_smem);
  if (err != 0) return err;
  if (smem > (size_t)max_smem) return kErrSharedMemory;
  if (s.mode == kModeDlN)
    return launch_tc<1, kModeDlN>(x, w, bias, out, s, n_tiles, smem, stream);
  if (NT == 1)
    return tap ? launch_tc<1, kModeTaps>(x, w, bias, out, s, n_tiles, smem,
                                         stream)
               : launch_tc<1, kModeChannels>(x, w, bias, out, s, n_tiles,
                                             smem, stream);
  return tap ? launch_tc<2, kModeTaps>(x, w, bias, out, s, n_tiles, smem,
                                       stream)
             : launch_tc<2, kModeChannels>(x, w, bias, out, s, n_tiles, smem,
                                           stream);
}

// The split-TF32 route: plan (the most m16 tiles a warp, 5, 2 or 1,
// whose staged arrays fit), check shared memory, launch.
int conv4d_fwd_f32_tc(const void* x, const void* w, const float* bias,
                      void* out, int B, int I, int J, int K, int L, int C,
                      int O, int ks, cudaStream_t stream) {
  const int p = ks / 2;
  const int KL = K * L;
  const int cols = L + 2 * p;
  const int NT = O <= 8 ? 1 : 2;
  F32Shape s{B, I, J, K, L, C, O, ks};
  s.CG = (C + 15) / 16;
  s.krows = ks * ks * s.CG * 16;
  s.w_bytes = s.krows * 8 * NT * 4;
  s.vec_x = C % 4 == 0 && (uintptr_t)x % 16 == 0;
  s.vec_w = O % 4 == 0 && (uintptr_t)w % 16 == 0;
  int max_smem = 0;
  const int err = max_shared_memory(&max_smem);
  if (err != 0) return err;
  const int mts[] = {5, 2, 1};
  for (const int mt : mts) {
    const int tile = kTcWarps * mt * 16;
    const int n_tiles = (KL + tile - 1) / tile;
    int rows_max = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int p0 = t * tile;
      const int p1 = KL < p0 + tile ? KL : p0 + tile;
      const int rows = (p1 - 1) / L - p0 / L + 1 + 2 * p;
      if (rows > rows_max) rows_max = rows;
    }
    s.HP = rows_max * cols;
    s.x_bytes = s.CG * s.HP * 64;
    const size_t smem = 3 * (size_t)s.x_bytes + 2 * (size_t)s.w_bytes;
    if (smem > (size_t)max_smem) continue;
    if (NT == 1) {
      if (mt == 5)
        return launch_f32_tc<1, 5>(x, w, bias, out, s, n_tiles, smem, stream);
      if (mt == 2)
        return launch_f32_tc<1, 2>(x, w, bias, out, s, n_tiles, smem, stream);
      return launch_f32_tc<1, 1>(x, w, bias, out, s, n_tiles, smem, stream);
    }
    if (mt == 5)
      return launch_f32_tc<2, 5>(x, w, bias, out, s, n_tiles, smem, stream);
    if (mt == 2)
      return launch_f32_tc<2, 2>(x, w, bias, out, s, n_tiles, smem, stream);
    return launch_f32_tc<2, 1>(x, w, bias, out, s, n_tiles, smem, stream);
  }
  return kErrSharedMemory;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns 0 on a successful launch, a
// cudaError_t value (> 0) when CUDA refused it, or one of the negative codes
// above when the shape cannot be taken.
int conv4d_fwd(const void* x, const void* w, const void* bias, void* out,
               int dtype, int B, int I, int J, int K, int L, int C, int O,
               int ks, void* stream) {
  if (B < 1 || I < 1 || J < 1 || K < 1 || L < 1 || C < 1 || O < 1 ||
      ks < 1 || ks % 2 == 0)
    return kErrBadShape;
  if ((int64_t)B * I > 65535 || J > 65535) return kErrGrid;
  if (dtype == 1)
    return conv4d_fwd_bf16(x, w, static_cast<const float*>(bias), out, B, I,
                           J, K, L, C, O, ks, static_cast<cudaStream_t>(stream));
  if (dtype != 0) return kErrDtype;
  if (f32_route(C, O) == kRouteTf32x3)
    return conv4d_fwd_f32_tc(x, w, static_cast<const float*>(bias), out, B, I,
                             J, K, L, C, O, ks,
                             static_cast<cudaStream_t>(stream));
  // FFMA: one of C == 1 or O == 1
  int max_smem = 0;
  const int err = max_shared_memory(&max_smem);
  if (err != 0) return err;
  FfmaPlan plan;
  const int code = plan_ffma(B, I, J, K, L, C, O, ks, max_smem, plan);
  if (code != 0) return code;
  plan.s.vec_x = plan.o1 && C % 4 == 0 && (uintptr_t)x % 16 == 0;
  plan.s.vec_w =
      (plan.o1 ? C % 4 == 0 : O % 4 == 0) && (uintptr_t)w % 16 == 0;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan.o1) {
    if (plan.KS == 5) return launch_o1<5>(x, w, b, out, plan, st);
    if (plan.KS == 3) return launch_o1<3>(x, w, b, out, plan, st);
    return launch_o1<0>(x, w, b, out, plan, st);
  }
  if (plan.KS == 5) return launch_c1<5>(x, w, b, out, plan, st);
  if (plan.KS == 3) return launch_c1<3>(x, w, b, out, plan, st);
  return launch_c1<0>(x, w, b, out, plan, st);
}

// The test-only chain oracle (conv4d_fwd_chain_oracle_kernel) on float32
// tensors: 0 on a successful launch, else a code as conv4d_fwd's.
int conv4d_fwd_chain_oracle(const void* x, const void* w, const void* bias,
                            void* out, int B, int I, int J, int K, int L,
                            int C, int O, int ks, void* stream) {
  if (B < 1 || I < 1 || J < 1 || K < 1 || L < 1 || C < 1 || O < 1 ||
      ks < 1 || ks % 2 == 0)
    return kErrBadShape;
  const long long blocks =
      ((long long)B * I * J * K * L * O + 255) / 256;
  if (blocks > 2147483647LL) return kErrGrid;
  conv4d_fwd_chain_oracle_kernel<<<(unsigned)blocks, 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, I, J, K,
      L, C, O, ks);
  return (int)cudaGetLastError();
}

// The FFMA route's plan of a float32 (C, O) layer (C == 1 or O == 1)
// under a shared-memory limit, for the tests: out[0..17] = o1, KS, R, W,
// rec, C4p, tile, n_tiles, S, G, n_seg, OT, x_floats, w_floats, threads,
// blocks, smem, n_items. Returns 0 or an error code.
int conv4d_fwd_ffma_plan(int B, int I, int J, int K, int L, int C, int O,
                         int ks, int max_smem, long long* out) {
  if (B < 1 || I < 1 || J < 1 || K < 1 || L < 1 || C < 1 || O < 1 ||
      ks < 1 || ks % 2 == 0 || f32_route(C, O) != kRouteFfma)
    return kErrBadShape;
  FfmaPlan plan;
  const int code = plan_ffma(B, I, J, K, L, C, O, ks, max_smem, plan);
  if (code != 0) return code;
  const FfmaShape& s = plan.s;
  const long long v[] = {plan.o1, plan.KS,  plan.R,   s.W,        s.rec,
                         s.C4p,   s.tile,   s.n_tiles, s.S,       s.G,
                         s.n_seg, s.OT,     s.x_floats, s.w_floats,
                         plan.threads, plan.blocks, (long long)plan.smem,
                         s.n_items};
  for (int e = 0; e < 18; ++e) out[e] = v[e];
  return 0;
}

// The route conv4d_fwd takes for a (dtype, C, O) layer: 0 = FFMA, 1 =
// split-TF32 on the tensor cores (float32), 2 = bfloat16 tensor cores;
// -1 for a dtype not taken.
int conv4d_fwd_route(int dtype, int C, int O) {
  if (dtype == 1) return kRouteBf16;
  return dtype == 0 ? f32_route(C, O) : -1;
}

const char* conv4d_fwd_error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1 and an odd kernel size";
    case kErrSharedMemory:
      return "the staged halo and weights exceed the block's shared memory";
    case kErrGrid:
      return "grid too large: B*I and J must be <= 65535";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
