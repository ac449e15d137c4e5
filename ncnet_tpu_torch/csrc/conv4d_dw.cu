// Weight gradient of the SAME, stride-1 4D convolution of neighbourhood
// consensus, written by hand for Hopper (sm_90a).
//
//   dw[di,dj,dk,dl,c,o] = sum_{b,i,j,k,l}
//       x[b, i+di-p, j+dj-p, k+dk-p, l+dl-p, c] * g[b, i, j, k, l, o]
//
// with zero padding p = ks/2 (an odd hypercubic ks^4 kernel), channels-last
// x [B,I,J,K,L,C] and g [B,I,J,K,L,O] (float32 or bfloat16), and a float32
// dw [ks,ks,ks,ks,C,O]: products and sums in float32, rounded once by the
// caller where it wants bfloat16 (as JAX's preferred_element_type=f32).
//
// Replaces: ncnet_tpu/kernels/conv4d_pallas.py::_dw_scan (an XLA scan of
// per-tap einsums in the JAX package, the dw half of the Pallas kernel's
// custom VJP at _vjp_bwd).
//
// What bounds it on an H100: operations. At the 400 px PF-Pascal config the
// 16->16 layer's dw at 32 samples is about 3.6 TFLOP on the grid against
// under 1 GB of x and g, thousands of FLOP per byte.
//
// Both routes compute the folded GEMM of ncnet_tpu/ops/conv4d.py::_dw_fold:
// for one (b, i, j) row and one (di, dj) tap pair the contribution is one
// [ks*ks*C, K*L] @ [K*L, O] product.
//   * pass 1: one block per (chunk of (b, i, j) rows, (di, dj) tap pair).
//     For each row of its chunk whose input row (i+di-p, j+dj-p) is on the
//     grid, the block walks the row in windows of kwin k-rows: it stages
//     the window's zero-padded (k, l, c) halo (kwin + 2p rows of the input
//     row) and the window's kwin*L positions of g in shared memory and adds
//     the product into float32 registers. The windows are the fewest that
//     keep two blocks on an SM, with K spread evenly over them (all of K at
//     the PF-Pascal grid, so one window a row; 4 of 12 rows at 48x48), so
//     the shared memory no longer grows with K; only a single
//     k-row too wide for the block is refused (L of about 590 at 16
//     channels);
//   * every kFlushRows rows the registers are added into the thread's own
//     slots of a partial buffer in global memory, so no float chain is
//     longer than kFlushRows rows' worth of a position group's products;
//   * pass 2: one thread per dw element sums the partials of every chunk
//     and position group in a fixed order. No atomics: a repeated call is
//     bitwise reproducible.
//
// bfloat16 (the training path) runs on the tensor cores, bf16 x bf16 ->
// float32 as the JAX scan's preferred_element_type=f32 (the products are
// exact in float32; only the order of the sums differs):
//   * for each (dk, dl) tap the row's product is a GEMM with M = input
//     channels (16 a tile; C padded with zeros), N = output channels (8 or
//     16 a block), K = positions in k-steps of 16 (625 padded to 640 with
//     zero g rows), on mma.sync.m16n8k16 bf16 -> f32;
//   * the A fragment (x^T) is one ldmatrix.x4.trans of the staged halo,
//     whose lanes address the positions shifted by (dk, dl) directly (each
//     position keeps 16 channels as two swizzled 16-byte chunks): no
//     im2col copy. The B fragment (g) is one ldmatrix.trans per k-step,
//     used for every tap the warp owns;
//   * a warp owns up to 5 (tap, channel group) m-tiles (up to 40 float32
//     accumulators a thread) over every other k-step: 10 warps = 5 tap
//     groups x 2 position groups at the 16->16 layer;
//   * C == 1 (the 1->16 layer): M runs over the (dk, dl) taps themselves
//     (25 padded to 32, 2 m-tiles a warp) and the A fragment is built from
//     scalar shared loads of the one-channel halo;
//   * O == 1 (the 16->1 layer; ks <= 8): padding N = o to 8 would leave
//     7/8 of every MMA zero, so N runs over dl instead. The block spreads
//     the g row into gt[u][dl] = g[k, l' - dl] over u = k*(L+2p) + l'
//     (zero off the row), and then dw[dk, dl, c] = sum_u x_halo[u +
//     dk*(L+2p), c] * gt[u][dl]: one GEMM per (dk, channel group), 725
//     values of u a row, a fifth of the MMAs and A loads of the per-tap
//     form;
//   * each window's halo and g rows are staged in bfloat16 (never widened)
//     and double-buffered with cp.async (16-byte chunks, zero-filled off
//     the grid), so the next window's copy overlaps this one's MMAs (the
//     positions of a window, not of a row, are the GEMM's K); shapes whose
//     rows are not 16-byte chunks (C or O not a multiple of 8) stage with
//     plain loads;
//   * the row chunks are sized for 4 waves of the card's resident blocks.
// float32 (the gradient check) keeps the CUDA-core route: each thread owns
// one (dk, dl) tap, a tile of CT input and OT output channels and a group
// of the K*L positions, with CT x OT float32 accumulators (register-blocked
// FFMA); the float32 halo stores each position with a stride that keeps a
// warp's float4 reads in distinct banks. TF32 would change the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxThreads = 384;  // __launch_bounds__ of pass 1
constexpr int kFlushRows = 8;     // rows summed in registers per flush
constexpr int kBlocksPerSm = 4;   // pass-1 blocks aimed at per SM
constexpr int kReduceThreads = 256;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrUnits = -3;
constexpr int kSmemReserve = 1024;  // shared memory the runtime keeps a block
constexpr int kErrDtype = -4;
constexpr int kErrWorkspace = -5;

struct Plan {
  int B, I, J, K, L, C, O, ks;
  int CT, OT;          // channel tiles of a thread
  int cs, os;          // floats per staged x / g position
  int n_ct, n_ot;      // tiles over C and O
  int units;           // ks*ks*n_ct*n_ot: (dk, dl, c tile, o tile)
  int n_pg;            // position groups (threads = n_pg * units)
  int rows_per_chunk;  // (b, i, j) rows per pass-1 block
  int n_chunks;
  int kwin, n_win;     // k-rows a staged window holds; windows a row
  int x_floats;        // staged halo floats of a window (a multiple of 4)
  size_t smem;
  int64_t workspace;   // partial floats
};

__device__ __forceinline__ float to_f32(float v) { return v; }

// What a plan needs of the card: its SMs, and the shared memory a block
// may take to leave room for a second block on its SM (`pair`) or at all
// (`max`, the opt-in limit).
struct Device {
  int sms;
  size_t pair, max;
};

int query_device(Device* d) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return (int)err;
  d->sms = sms;
  d->max = (size_t)max_smem;
  d->pair = (size_t)(per_sm / 2 - kSmemReserve);
  return 0;
}

// The window of k-rows a block stages: the fewest windows whose staged
// footprint `smem_of(kwin)` lets two blocks share an SM (else fits a block
// at all), with the K rows spread evenly over them, so no window computes
// past the grid; 0 when a single k-row does not fit.
template <typename SmemOf>
int choose_window(int K, const Device& d, SmemOf smem_of) {
  const size_t budgets[2] = {d.pair, d.max};
  for (size_t budget : budgets)
    for (int kwin = K; kwin >= 1; --kwin)
      if (smem_of(kwin) <= budget) {
        const int n_win = (K + kwin - 1) / kwin;
        return (K + n_win - 1) / n_win;
      }
  return 0;
}

template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
      const float4 v = reinterpret_cast<const float4*>(src)[n];
      dst[4 * n + 0] = v.x;
      dst[4 * n + 1] = v.y;
      dst[4 * n + 2] = v.z;
      dst[4 * n + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) dst[n] = src[n];
  }
}

template <typename T, int CT, int OT>
__global__ void __launch_bounds__(kMaxThreads)
    conv4d_dw_partial(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, const Plan s) {
  extern __shared__ __align__(16) float smem[];
  const int p = s.ks / 2;
  const int cols = s.L + 2 * p;
  const int halo = (s.kwin + 2 * p) * cols;
  const int KL = s.K * s.L;
  const int ks2 = s.ks * s.ks;
  float* sx = smem;               // [kwin+2p][L+2p][cs]
  float* sg = smem + s.x_floats;  // [kwin*L][os]

  const int chunk = blockIdx.x;
  const int dij = blockIdx.y;
  const int di = dij / s.ks;
  const int dj = dij % s.ks;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int unit = tid % s.units;
  const int pg = tid / s.units;
  const int ot = unit % s.n_ot;
  const int ct = (unit / s.n_ot) % s.n_ct;
  const int dkl = unit / (s.n_ot * s.n_ct);
  const int dk = dkl / s.ks;
  const int dl = dkl % s.ks;
  const int c0 = ct * CT;
  const int o0 = ot * OT;
  // this group's share of a window's positions
  const int per = (s.kwin * s.L + s.n_pg - 1) / s.n_pg;
  const int q0 = pg * per;
  const int xoff = (dk * cols + dl) * s.cs + c0;

  // this thread's slots: partial[chunk][dij][pg][dkl][c][o]
  float* slot = partial +
                ((((int64_t)chunk * ks2 + dij) * s.n_pg + pg) * ks2 + dkl) *
                    s.C * s.O;

  float acc[CT][OT];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[c][o] = 0.f;
  bool first = true;
  int pending = 0;

  auto flush = [&]() {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
#pragma unroll
      for (int o = 0; o < OT; ++o) {
        if (c0 + c < s.C && o0 + o < s.O) {
          float* d = slot + (c0 + c) * s.O + o0 + o;
          *d = first ? acc[c][o] : *d + acc[c][o];
        }
        acc[c][o] = 0.f;
      }
    }
    first = false;
    pending = 0;
  };

  const int64_t row_x = (int64_t)KL * s.C;
  const int64_t row_g = (int64_t)KL * s.O;
  const int rows_total = s.B * s.I * s.J;
  const int r0 = chunk * s.rows_per_chunk;
  const int r1 = min(rows_total, r0 + s.rows_per_chunk);
  for (int r = r0; r < r1; ++r) {
    const int j = r % s.J;
    const int i = (r / s.J) % s.I;
    const int b = r / (s.I * s.J);
    const int ii = i + di - p;
    const int jj = j + dj - p;
    if (ii < 0 || ii >= s.I || jj < 0 || jj >= s.J) continue;  // uniform
    const T* xr = x + (((int64_t)b * s.I + ii) * s.J + jj) * row_x;
    const T* gr = g + (((int64_t)b * s.I + i) * s.J + j) * row_g;
    for (int win = 0; win < s.n_win; ++win) {
      const int k0 = win * s.kwin;
      const int npos = min(s.kwin, s.K - k0) * s.L;  // the window's positions
      __syncthreads();  // the previous window's reads of sx/sg are done
      for (int e = tid; e < halo * s.cs; e += nthreads) {
        const int c = e % s.cs;
        const int cell = e / s.cs;
        const int kk = k0 + cell / cols - p;
        const int ll = cell % cols - p;
        sx[e] = (c < s.C && kk >= 0 && kk < s.K && ll >= 0 && ll < s.L)
                    ? to_f32(xr[((int64_t)kk * s.L + ll) * s.C + c])
                    : 0.f;
      }
      const T* gw = gr + (int64_t)k0 * s.L * s.O;
      for (int e = tid; e < npos * s.os; e += nthreads) {
        const int o = e % s.os;
        sg[e] = o < s.O ? to_f32(gw[(int64_t)(e / s.os) * s.O + o]) : 0.f;
      }
      __syncthreads();

      const int q1 = min(npos, q0 + per);
      int k = q0 / s.L;
      int l = q0 % s.L;
      for (int q = q0; q < q1; ++q) {
        float xv[CT];
        float gv[OT];
        load_vec<CT>(sx + xoff + (k * cols + l) * s.cs, xv);
        load_vec<OT>(sg + q * s.os + o0, gv);
#pragma unroll
        for (int c = 0; c < CT; ++c)
#pragma unroll
          for (int o = 0; o < OT; ++o)
            acc[c][o] = fmaf(xv[c], gv[o], acc[c][o]);
        if (++l == s.L) {
          l = 0;
          ++k;
        }
      }
    }
    if (++pending == kFlushRows) flush();
  }
  if (first || pending) flush();  // a chunk with no row writes zeros
}

// dw[dij][dkl][c][o] = sum over chunks, then position groups, in order.
__global__ void __launch_bounds__(kReduceThreads)
    conv4d_dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                     int n_chunks, int ks2, int n_pg, int per_tap) {
  const int64_t n = (int64_t)ks2 * per_tap;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int dij = (int)(idx / per_tap);
  const int rest = (int)(idx % per_tap);
  float sum = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch)
    for (int pg = 0; pg < n_pg; ++pg)
      sum += partial[(((int64_t)ch * ks2 + dij) * n_pg + pg) * per_tap + rest];
  dw[idx] = sum;
}

int make_plan(int B, int I, int J, int K, int L, int C, int O, int ks,
              Plan* s) {
  if (B < 1 || I < 1 || J < 1 || K < 1 || L < 1 || C < 1 || O < 1 ||
      ks < 1 || ks % 2 == 0)
    return kErrBadShape;
  if ((int64_t)B * I * J > 0x7fffffff || (int64_t)K * L > 0x7fffffff)
    return kErrBadShape;
  Plan p{};
  p.B = B, p.I = I, p.J = J, p.K = K, p.L = L, p.C = C, p.O = O, p.ks = ks;
  p.OT = O == 1 ? 1 : (O <= 4 ? 4 : (O <= 8 ? 8 : 16));
  p.CT = C == 1 ? 1 : (p.OT <= 4 && C >= 16 ? 16 : 4);
  p.n_ct = (C + p.CT - 1) / p.CT;
  p.n_ot = (O + p.OT - 1) / p.OT;
  p.cs = p.n_ct * p.CT + (p.CT == 16 ? 4 : 0);  // 20 floats: no conflicts
  p.os = p.n_ot * p.OT;
  p.units = ks * ks * p.n_ct * p.n_ot;
  if (p.units > kMaxThreads) return kErrUnits;
  p.n_pg = kMaxThreads / p.units;
  if (p.n_pg > K * L) p.n_pg = K * L;
  const int p2 = ks / 2;
  const int cols = L + 2 * p2;
  auto x_floats = [&](int kwin) {
    return ((kwin + 2 * p2) * cols * p.cs + 3) / 4 * 4;
  };
  auto smem_of = [&](int kwin) {
    return ((size_t)x_floats(kwin) + (size_t)kwin * L * p.os) * sizeof(float);
  };

  Device d;
  const int code = query_device(&d);
  if (code != 0) return code;
  p.kwin = choose_window(K, d, smem_of);
  if (p.kwin == 0) return kErrSharedMemory;
  p.n_win = (K + p.kwin - 1) / p.kwin;
  p.x_floats = x_floats(p.kwin);
  p.smem = smem_of(p.kwin);

  const int rows = B * I * J;
  const int sms = d.sms;
  int chunks = (kBlocksPerSm * sms + ks * ks - 1) / (ks * ks);
  if (chunks < 1) chunks = 1;
  if (chunks > rows) chunks = rows;
  p.rows_per_chunk = (rows + chunks - 1) / chunks;
  p.n_chunks = (rows + p.rows_per_chunk - 1) / p.rows_per_chunk;
  p.workspace = (int64_t)p.n_chunks * ks * ks * p.n_pg * ks * ks * C * O;
  *s = p;
  return 0;
}

template <typename T, int CT, int OT>
int launch_partial(const void* x, const void* g, float* partial,
                   const Plan& s, cudaStream_t stream) {
  auto kernel = conv4d_dw_partial<T, CT, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.n_chunks, s.ks * s.ks);
  kernel<<<grid, s.n_pg * s.units, s.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* g, float* partial, const Plan& s,
             cudaStream_t st) {
  if (s.CT == 1) {
    if (s.OT == 1) return launch_partial<T, 1, 1>(x, g, partial, s, st);
    if (s.OT == 4) return launch_partial<T, 1, 4>(x, g, partial, s, st);
    if (s.OT == 8) return launch_partial<T, 1, 8>(x, g, partial, s, st);
    return launch_partial<T, 1, 16>(x, g, partial, s, st);
  }
  if (s.CT == 4) {
    if (s.OT == 1) return launch_partial<T, 4, 1>(x, g, partial, s, st);
    if (s.OT == 4) return launch_partial<T, 4, 4>(x, g, partial, s, st);
    if (s.OT == 8) return launch_partial<T, 4, 8>(x, g, partial, s, st);
    return launch_partial<T, 4, 16>(x, g, partial, s, st);
  }
  if (s.OT == 1) return launch_partial<T, 16, 1>(x, g, partial, s, st);
  return launch_partial<T, 16, 4>(x, g, partial, s, st);
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (see the header).

constexpr int kTcMaxMPW = 5;    // m16 tiles a warp (channels x taps)
constexpr int kTapMaxMPW = 2;   // m16 tiles a warp when M is the taps
constexpr int kTcMaxWarps = 10;
constexpr int kTcThreads = kTcMaxWarps * 32;
constexpr int kTcWaves = 4;     // pass-1 blocks aimed at per resident slot

// What the GEMM's M, N and K run over.
constexpr int kModeChannels = 0;  // M = (dk, dl, 16 c), N = o, K = positions
constexpr int kModeTaps = 1;      // C == 1: M = (dk, dl), N = o, K = positions
constexpr int kModeShiftG = 2;    // O == 1: M = (dk, 16 c), N = dl, K = (k, l')

struct TcPlan {
  int B, I, J, K, L, C, O, ks;
  int mode;
  int CG;           // 16-channel groups; 0 on the taps mode
  int nM;           // m16 tiles in all
  int MW, MPW, KW;  // warps over m-tiles, m-tiles a warp, warps over k-steps
  int n_mg;         // blocks over m-tile groups of MW * MPW
  int NT;           // n8 tiles a block (8 * NT output channels)
  int n_ot;         // blocks over output-channel tiles
  int kwin, n_win;  // k-rows a staged window holds; windows a row
  int NKS;          // k-steps of 16 a window: positions kwin*L, or (k, l')
                    // kwin*(L+2p)
  int HP;           // staged halo positions (kwin+2p) * (L+2p)
  int x_bytes;      // staged halo bytes per buffer
  int g_bytes;      // staged g bytes per buffer (the raw row on kModeShiftG)
  int gt_bytes;     // the shifted g copy of kModeShiftG (one buffer)
  int tab_bytes;
  int vec_x, vec_g;  // stage with cp.async (16-byte chunks, aligned)
  int rows_per_chunk, n_chunks;
  int smem;
  int64_t workspace;  // partial floats
};
// The kernel's parameter: past 128 bytes nvcc compiled the O = 1
// instantiation to more instructions, and it ran a third slower on an H100
// at the PF-Pascal grid.
static_assert(sizeof(TcPlan) <= 128, "TcPlan is the kernel's parameter");

// NT: n8 tiles a block; kMode: one of the modes above; kWin: a row takes
// more than one window (else the window is the whole row, and the loop
// over windows folds away).
template <int NT, int kMode, bool kWin>
__global__ void __launch_bounds__(kTcThreads, 2)
    conv4d_dw_bf16_tc(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ partial, const TcPlan s) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  using namespace mma16;
  constexpr bool kTap = kMode == kModeTaps;
  constexpr bool kShift = kMode == kModeShiftG;
  constexpr int kMPW = kTap ? kTapMaxMPW : kTcMaxMPW;
  const int p = s.ks / 2;
  const int cols = s.L + 2 * p;
  const int KL = s.K * s.L;
  const int T = s.ks * s.ks;
  const int OT = 8 * NT;
  const int chunk = blockIdx.x;
  const int mg = blockIdx.y % s.n_mg;
  const int ot = (blockIdx.y / s.n_mg) % s.n_ot;
  const int dij = blockIdx.y / (s.n_mg * s.n_ot);
  const int di = dij / s.ks;
  const int dj = dij % s.ks;
  const int o0 = ot * OT;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp / s.MW;
  const int m_first = (mg * s.MW + warp % s.MW) * s.MPW;
  const int n_mt = max(0, min(s.MPW, s.nM - m_first));
  const int stage_bytes = s.x_bytes + s.g_bytes;
  int* tab = reinterpret_cast<int*>(tc_smem);  // [NKS*16]
  unsigned char* bufs = tc_smem + s.tab_bytes;
  uint16_t* gt = reinterpret_cast<uint16_t*>(bufs + 2 * stage_bytes);

  // the halo index of each window position at tap (0, 0); positions past
  // the window read position 0 against g rows of zeros
  for (int e = tid; e < s.NKS * 16; e += nthreads)
    tab[e] = e < s.kwin * s.L ? (e / s.L) * cols + e % s.L : 0;

  // per m-tile: channels, the halo record offset of its (tap, channel
  // group); taps, the offsets of this lane's rows g and g+8; shifted g,
  // the record offset of its (dk, channel group) and its last record
  int moff[kMPW][2];
#pragma unroll
  for (int mt = 0; mt < kMPW; ++mt) {
    const int mi = m_first + mt;
    if (kTap) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = mi * 16 + (lane >> 2) + h * 8;
        moff[mt][h] = t < T ? (t / s.ks) * cols + t % s.ks : 0;
      }
    } else if (kShift) {
      const int cg = mi % s.CG;
      moff[mt][0] = mi < s.nM ? cg * s.HP + (mi / s.CG) * cols : 0;
      moff[mt][1] = cg * s.HP + s.HP - 1;
    } else {
      const int t = mi / s.CG;
      moff[mt][0] = mi < s.nM
                        ? (mi % s.CG) * s.HP + (t / s.ks) * cols + t % s.ks
                        : 0;
      moff[mt][1] = 0;
    }
  }

  float acc[kMPW][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMPW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  bool first = true;
  int pending = 0;

  // this warp's slots: partial[chunk][dij][kw][dkl][c][o]
  const int64_t per_tap = (int64_t)T * s.C * s.O;
  float* slot = partial + (((int64_t)chunk * T + dij) * s.KW + kw) * per_tap;
  auto flush = [&]() {
#pragma unroll
    for (int mt = 0; mt < kMPW; ++mt) {
      if (mt >= n_mt) break;
      const int mi = m_first + mt;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (lane >> 2) + (e >> 1) * 8;
          const int col = nt * 8 + 2 * (lane & 3) + (e & 1);
          int t, c, o;
          bool ok;
          if (kTap) {
            t = mi * 16 + row, c = 0, o = o0 + col;
            ok = t < T && o < s.O;
          } else if (kShift) {  // the column is dl
            t = (mi / s.CG) * s.ks + col, c = (mi % s.CG) * 16 + row, o = 0;
            ok = col < s.ks && c < s.C;
          } else {
            t = mi / s.CG, c = (mi % s.CG) * 16 + row, o = o0 + col;
            ok = c < s.C && o < s.O;
          }
          if (ok) {
            float* d = slot + ((int64_t)t * s.C + c) * s.O + o;
            *d = first ? acc[mt][nt][e] : *d + acc[mt][nt][e];
          }
          acc[mt][nt][e] = 0.f;
        }
    }
    first = false;
    pending = 0;
  };

  const int64_t row_x = (int64_t)KL * s.C;
  const int64_t row_g = (int64_t)KL * s.O;
  const int rows_total = s.B * s.I * s.J;
  const int r0 = chunk * s.rows_per_chunk;
  const int r1 = min(rows_total, r0 + s.rows_per_chunk);
  auto on_grid = [&](int r) {
    const int ii = (r / s.J) % s.I + di - p;
    const int jj = r % s.J + dj - p;
    return ii >= 0 && ii < s.I && jj >= 0 && jj < s.J;
  };
  auto next_row = [&](int r) {
    while (r < r1 && !on_grid(r)) ++r;
    return r;
  };
  // the first g element of window `win` of row r (a row's windows are
  // consecutive k-rows of its g row)
  auto g_window = [&](int r, int win) {
    return kWin ? g + (int64_t)r * row_g + (int64_t)win * s.kwin * s.L * s.O
                : g + (int64_t)r * row_g;
  };
  // k-rows in window `win`
  auto win_rows = [&](int win) {
    return kWin ? min(s.kwin, s.K - win * s.kwin) : s.K;
  };
  const int n_win = kWin ? s.n_win : 1;
  // kModeShiftG stages a window's g raw from the 16-byte chunk that holds
  // its first element: the window starts `lead` elements into the buffer
  auto lead = [&](int r, int win) {
    return s.vec_g ? (int)(((uintptr_t)g_window(r, win) & 15) / 2) : 0;
  };

  auto stage = [&](int r, int win, int buf) {
    unsigned char* xs = bufs + buf * stage_bytes;
    unsigned char* gs = xs + s.x_bytes;
    const int j = r % s.J;
    const int i = (r / s.J) % s.I;
    const int b = r / (s.I * s.J);
    const __nv_bfloat16* xr =
        x + (((int64_t)b * s.I + i + di - p) * s.J + j + dj - p) * row_x;
    const __nv_bfloat16* gw = g_window(r, win);
    const int wpos = win_rows(win) * s.L;  // the window's positions
    stage_halo(xs, xr, kWin ? win * s.kwin : 0, s.kwin + 2 * p, cols, p, s.K,
               s.L, s.C, s.CG, s.HP, s.vec_x, tid, nthreads);
    if (kShift) {  // the raw g window (O == 1), spread into gt by `shift_g`
      if (s.vec_g) {
        const int ld = lead(r, win);
        const int n_el = ld + wpos;
        // elements from the first staged one to the end of g
        const int64_t left = (int64_t)rows_total * KL - (gw - ld - g);
        for (int e = tid; e < (n_el + 7) / 8; e += nthreads) {
          const int64_t rest = 2 * (left - 8 * (int64_t)e);
          cp_async16(gs + 16 * e, gw - ld + 8 * e, rest < 16 ? (int)rest : 16);
        }
      } else {
        uint16_t* graw = reinterpret_cast<uint16_t*>(gs);
        for (int e = tid; e < wpos; e += nthreads) graw[e] = bf16_bits(gw[e]);
      }
      return;
    }
    // the g window as [position][OT], zero past its positions and past O
    const int npos = s.NKS * 16;
    if (s.vec_g) {
      for (int e = tid; e < npos * NT; e += nthreads) {
        const int q = e % NT;
        const int pos = e / NT;
        const bool ok = pos < wpos && o0 + q * 8 < s.O;
        const __nv_bfloat16* src =
            ok ? gw + (int64_t)pos * s.O + o0 + q * 8 : gw;
        cp_async16(gs + swizzle(pos, q, NT), src, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < npos * OT; e += nthreads) {
        const int o = e % OT;
        const int pos = e / OT;
        const bool ok = pos < wpos && o0 + o < s.O;
        *reinterpret_cast<uint16_t*>(gs + swizzle(pos, o >> 3, NT) +
                                     (o & 7) * 2) =
            ok ? bf16_bits(gw[(int64_t)pos * s.O + o0 + o]) : (uint16_t)0;
      }
    }
  };

  // kModeShiftG: gt[u][dl] = g[k, l' - dl] for u = k*(L+2p) + l' over the
  // window's k-rows (zero where l' - dl is off the row, past the window's
  // rows, or dl >= ks), so that
  //   dw[dk, dl, c] = sum_u x_halo[u + dk*(L+2p), c] * gt[u][dl]
  // is one GEMM per (dk, channel group) with N = dl
  auto shift_g = [&](int buf, int r, int win) {
    const uint16_t* graw =
        reinterpret_cast<const uint16_t*>(bufs + buf * stage_bytes + s.x_bytes) +
        lead(r, win);
    const int nk = win_rows(win);
    const int dl = tid & 7;  // a thread keeps one dl and walks u
    const int ustep = nthreads / 8;
    int u = tid / 8;
    int k = u / cols;
    int l = u % cols;
    for (; u < s.NKS * 16; u += ustep) {
      const int lg = l - dl;
      gt[u * 8 + dl] = (k < nk && dl < s.ks && lg >= 0 && lg < s.L)
                           ? graw[k * s.L + lg]
                           : (uint16_t)0;
      for (l += ustep; l >= cols; l -= cols) ++k;
    }
  };

  auto compute = [&](int buf) {
    const unsigned char* xs = bufs + buf * stage_bytes;
    const uint32_t xs_addr = smem_addr(xs);
    const uint32_t gs_addr = smem_addr(kShift ? (const void*)gt : xs + s.x_bytes);
    const uint16_t* xh = reinterpret_cast<const uint16_t*>(xs);
    const int q8 = lane >> 3;
    for (int st = kw; st < s.NKS; st += s.KW) {
      // B: the g rows of 16 positions (shifted g: 16 values of u), shared
      // by every m-tile of the warp
      uint32_t bf[NT][2];
      const int pos_b = st * 16 + (q8 & 1) * 8 + (lane & 7);
      if constexpr (NT == 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, gs_addr + swizzle(pos_b, q8 >> 1, 2));
        bf[0][0] = r[0], bf[0][1] = r[1], bf[1][0] = r[2], bf[1][1] = r[3];
      } else {
        ldmatrix_x2_trans(bf[0][0], bf[0][1], gs_addr + swizzle(pos_b, 0, 1));
      }
      if constexpr (kTap) {
        // A = the shifted one-channel halo, [tap][position]: this lane's
        // columns are positions 2c, 2c+1, 2c+8, 2c+9 of the k-step
        int hb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hb[q] = tab[st * 16 + 2 * (lane & 3) + (q & 1) + (q >> 1) * 8];
#pragma unroll
        for (int mt = 0; mt < kMPW; ++mt) {
          if (mt >= n_mt) break;
          const int t0 = moff[mt][0], t1 = moff[mt][1];
          const uint32_t a[4] = {pack(xh[hb[0] + t0], xh[hb[1] + t0]),
                                 pack(xh[hb[0] + t1], xh[hb[1] + t1]),
                                 pack(xh[hb[2] + t0], xh[hb[3] + t0]),
                                 pack(xh[hb[2] + t1], xh[hb[3] + t1])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      } else {
        // A = x^T, [channel][position]: ldmatrix.trans of the shifted
        // halo records, one row address per lane (shifted g: the records
        // u + dk*(L+2p), kept inside the staged halo)
        const int row_a = st * 16 + (q8 >> 1) * 8 + (lane & 7);
        const int hb = kShift ? row_a : tab[row_a];
#pragma unroll
        for (int mt = 0; mt < kMPW; ++mt) {
          if (mt >= n_mt) break;
          const int rec = kShift ? min(moff[mt][0] + hb, moff[mt][1])
                                 : moff[mt][0] + hb;
          uint32_t a[4];
          ldmatrix_x4_trans(a, xs_addr + swizzle(rec, q8 & 1, 2));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
  };

  // double-buffered over the windows of the chunk's rows whose input row
  // is on the grid: the next window's copy is in flight while this
  // window's MMAs run
  int r = next_row(r0), win = 0;
  if (r < r1) stage(r, 0, 0);
  cp_async_commit();
  int buf = 0;
  while (r < r1) {
    const bool last = win + 1 == n_win;  // the row's last window
    const int rn = last ? next_row(r + 1) : r;
    const int wn = last ? 0 : win + 1;
    if (rn < r1) stage(rn, wn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kShift) {
      shift_g(buf, r, win);
      __syncthreads();
    }
    if (n_mt > 0) compute(buf);
    __syncthreads();  // every warp is done with `buf` before it is refilled
    if (last && ++pending == kFlushRows) flush();
    r = rn;
    win = wn;
    buf ^= 1;
  }
  if (first || pending) flush();  // a chunk with no row writes zeros
}

template <int NT, int kMode>
int occupancy(const TcPlan& s, int threads, int* per_sm) {
  auto kernel = s.n_win > 1 ? conv4d_dw_bf16_tc<NT, kMode, true>
                            : conv4d_dw_bf16_tc<NT, kMode, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                            threads, s.smem);
}

template <int NT, int kMode>
int launch_tc(const void* x, const void* g, float* partial, const TcPlan& s,
              cudaStream_t stream) {
  auto kernel = s.n_win > 1 ? conv4d_dw_bf16_tc<NT, kMode, true>
                            : conv4d_dw_bf16_tc<NT, kMode, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s.n_chunks, s.ks * s.ks * s.n_ot * s.n_mg);
  kernel<<<grid, s.MW * s.KW * 32, s.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), partial, s);
  return (int)cudaGetLastError();
}

// The instantiations: (NT, mode) of a plan. `occupancy` if per_sm is set,
// else the launch.
int by_instance(const void* x, const void* g, float* partial,
                const TcPlan& s, cudaStream_t st, int threads, int* per_sm) {
  if (s.mode == kModeShiftG)
    return per_sm ? occupancy<1, kModeShiftG>(s, threads, per_sm)
                  : launch_tc<1, kModeShiftG>(x, g, partial, s, st);
  if (s.mode == kModeTaps)
    return s.NT == 1 ? (per_sm ? occupancy<1, kModeTaps>(s, threads, per_sm)
                               : launch_tc<1, kModeTaps>(x, g, partial, s, st))
                     : (per_sm ? occupancy<2, kModeTaps>(s, threads, per_sm)
                               : launch_tc<2, kModeTaps>(x, g, partial, s, st));
  return s.NT == 1
             ? (per_sm ? occupancy<1, kModeChannels>(s, threads, per_sm)
                       : launch_tc<1, kModeChannels>(x, g, partial, s, st))
             : (per_sm ? occupancy<2, kModeChannels>(s, threads, per_sm)
                       : launch_tc<2, kModeChannels>(x, g, partial, s, st));
}

int make_tc_plan(int B, int I, int J, int K, int L, int C, int O, int ks,
                 const void* x, const void* g, TcPlan* out) {
  TcPlan s{};
  s.B = B, s.I = I, s.J = J, s.K = K, s.L = L, s.C = C, s.O = O, s.ks = ks;
  const int T = ks * ks;
  const int p = ks / 2;
  const int cols = L + 2 * p;
  s.mode = C == 1 ? kModeTaps
                  : (O == 1 && ks <= 8 ? kModeShiftG : kModeChannels);
  const bool tap = s.mode == kModeTaps;
  const bool shift = s.mode == kModeShiftG;
  s.CG = tap ? 0 : (C + 15) / 16;
  s.nM = tap ? (T + 15) / 16 : (shift ? ks : T) * s.CG;
  s.NT = O <= 8 ? 1 : 2;
  s.n_ot = shift ? 1 : (O + 8 * s.NT - 1) / (8 * s.NT);
  const int max_mpw = tap ? kTapMaxMPW : kTcMaxMPW;
  const int mb = s.nM < kTcMaxWarps * max_mpw ? s.nM : kTcMaxWarps * max_mpw;
  s.MW = (mb + max_mpw - 1) / max_mpw;
  s.MPW = (mb + s.MW - 1) / s.MW;
  s.KW = kTcMaxWarps / s.MW;
  s.n_mg = (s.nM + s.MW * s.MPW - 1) / (s.MW * s.MPW);
  if ((int64_t)T * s.n_ot * s.n_mg > 65535) return kErrBadShape;
  s.vec_x = !tap && C % 8 == 0 && (uintptr_t)x % 16 == 0;
  s.vec_g = (shift || O % 8 == 0) && (uintptr_t)g % 16 == 0;
  // the staged sizes of a window of kwin k-rows
  auto size = [&](int kwin, TcPlan* t) {
    t->NKS = ((shift ? kwin * cols : kwin * L) + 15) / 16;
    t->HP = (kwin + 2 * p) * cols;
    t->x_bytes = tap ? (t->HP * 2 + 15) / 16 * 16 : t->CG * t->HP * 32;
    t->g_bytes = shift ? (kwin * L * 2 + 15) / 16 * 16 + 16
                       : t->NKS * 16 * t->NT * 16;
    t->gt_bytes = shift ? t->NKS * 16 * 16 : 0;
    t->tab_bytes = (t->NKS * 16 * 4 + 15) / 16 * 16;
    const size_t smem = (size_t)t->tab_bytes +
                        2 * ((size_t)t->x_bytes + t->g_bytes) + t->gt_bytes;
    t->smem = (int)smem;
    return smem;
  };

  Device d;
  int code = query_device(&d);
  if (code != 0) return code;
  s.kwin = choose_window(K, d, [&](int kwin) {
    TcPlan t = s;
    return size(kwin, &t);
  });
  if (s.kwin == 0) return kErrSharedMemory;
  s.n_win = (K + s.kwin - 1) / s.kwin;
  size(s.kwin, &s);
  const int sms = d.sms;
  int per_sm = 0;
  code = by_instance(x, g, nullptr, s, nullptr, s.MW * s.KW * 32, &per_sm);
  if (code != 0) return code;
  if (per_sm < 1) per_sm = 1;

  // enough blocks for kTcWaves waves of the card's resident slots
  const int rows = B * I * J;
  const int per_chunk_blocks = T * s.n_ot * s.n_mg;
  int chunks = (kTcWaves * per_sm * sms + per_chunk_blocks - 1) /
               per_chunk_blocks;
  if (chunks < 1) chunks = 1;
  if (chunks > rows) chunks = rows;
  s.rows_per_chunk = (rows + chunks - 1) / chunks;
  s.n_chunks = (rows + s.rows_per_chunk - 1) / s.rows_per_chunk;
  s.workspace = (int64_t)s.n_chunks * T * s.KW * T * C * O;
  *out = s;
  return 0;
}

int dispatch_tc(const void* x, const void* g, float* partial, const TcPlan& s,
                cudaStream_t st) {
  return by_instance(x, g, partial, s, st, 0, nullptr);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. With partial == NULL only the plan is
// made: *workspace receives the partial buffer's size in floats and nothing
// is launched. Otherwise partial must hold at least that many floats, and
// both passes are launched on `stream`. Returns 0 on success, a cudaError_t
// value (> 0) when CUDA refused a launch, or a negative code below.
int conv4d_dw(const void* x, const void* g, float* partial, float* dw,
              long long* workspace, int dtype, int B, int I, int J, int K,
              int L, int C, int O, int ks, void* stream) {
  if (dtype != 0 && dtype != 1) return kErrDtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int code, n_chunks, n_pg;
  if (dtype == 1) {
    TcPlan s;
    code = make_tc_plan(B, I, J, K, L, C, O, ks, x, g, &s);
    if (code != 0) return code;
    if (partial == nullptr) {
      *workspace = (long long)s.workspace;
      return 0;
    }
    if (*workspace < (long long)s.workspace) return kErrWorkspace;
    code = dispatch_tc(x, g, partial, s, st);
    n_chunks = s.n_chunks;
    n_pg = s.KW;
  } else {
    Plan s;
    code = make_plan(B, I, J, K, L, C, O, ks, &s);
    if (code != 0) return code;
    if (partial == nullptr) {
      *workspace = (long long)s.workspace;
      return 0;
    }
    if (*workspace < (long long)s.workspace) return kErrWorkspace;
    code = dispatch<float>(x, g, partial, s, st);
    n_chunks = s.n_chunks;
    n_pg = s.n_pg;
  }
  if (code != 0) return code;
  const int ks2 = ks * ks;
  const int per_tap = ks2 * C * O;
  const int64_t n = (int64_t)ks2 * per_tap;
  const int blocks = (int)((n + kReduceThreads - 1) / kReduceThreads);
  conv4d_dw_reduce<<<blocks, kReduceThreads, 0, st>>>(
      partial, dw, n_chunks, ks2, n_pg, per_tap);
  return (int)cudaGetLastError();
}

const char* conv4d_dw_error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1, an odd kernel size, and "
             "B*I*J and K*L within int32";
    case kErrSharedMemory:
      return "one k-row window (its (1+2p) x (L+2p) halo and L positions of "
             "g) exceeds the block's shared memory: the grid's last dim L is "
             "too wide (about 590 at 16 channels)";
    case kErrUnits:
      return "too many (tap, channel tile) units for one block: "
             "ks^2 * ceil(C/CT) * ceil(O/OT) must be <= 384";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    case kErrWorkspace:
      return "the partial buffer is smaller than the plan needs";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
