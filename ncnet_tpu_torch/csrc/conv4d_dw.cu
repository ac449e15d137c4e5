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
// 16->16 layer's dw at 32 samples is about 3.3 TFLOP on the grid against
// under 2 GB of x and g, thousands of FLOP per byte.
//
// Both routes compute the folded GEMM of ncnet_tpu/ops/conv4d.py::_dw_fold:
// for one (b, i, j) row and one (di, dj) tap pair the contribution is one
// [ks*ks*C, K*L] @ [K*L, O] product.
//   * pass 1: one block per (chunk of (b, i, j) rows, (di, dj) tap pair, and
//     on wide layers a group of output tiles). For each row of its chunk
//     whose input row (i+di-p, j+dj-p) is on the grid, the block walks the
//     row in windows of kwin k-rows: it stages the window's zero-padded
//     (k, l, c) halo (kwin + 2p rows of the input row) and the window's g
//     rows in shared memory, double-buffered with cp.async so the next
//     window's copy overlaps this one's MMAs, and adds the product into
//     float32 registers. The windows are the fewest that keep two blocks on
//     an SM, with K spread evenly over them, so the shared memory does not
//     grow with K; only a single k-row too wide for the block is refused;
//   * the row chunks are sized from the blocks the card holds at once (the
//     occupancy API on the kernel itself), for a whole number of waves;
//   * pass 2 sums each dw element's partials over the chunks in a fixed
//     order. No atomics: a repeated call is bitwise reproducible.
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
//   * every kFlushRows rows a warp adds its registers into its own slots
//     of the partial buffer, one slot set per k-step warp; pass 2
//     (conv4d_dw_reduce) sums chunks, then k-step warps, one thread an
//     element;
//   * the row chunks are sized for 4 waves of the card's resident blocks.
// float32 (dense float32 training, the gradient check, the synthetic
// float32 run) runs split-TF32 ("3xTF32") on the tensor cores,
// conv4d_dw_tf32x3_tc, at any odd ks, C and O:
//   * each float32 of x and g is split once a call (conv4d_dw_split_f32,
//     a pass over both, into a workspace after the partials) into hi =
//     cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi), kept side by side as
//     a float2; a product is lo*hi + hi*lo + hi*hi on mma.sync m16n8k8
//     .tf32, in that order (mma_tf32.cuh, as the forward's float32 route).
//     The copies take twice x and g, so the batch is cut into groups of
//     whole samples whose copies fit kSplitBytes (1 GiB; one sample at
//     least), split and run through pass 1 in turn, each into partials of
//     its own: the workspace holds one group's copies, not the batch's;
//   * the GEMM of a window runs over u = k*(L+2p) + l', the window's
//     positions at the halo's row pitch. Channel mode (C >= 2): M = (dk,
//     c), N = (dl, o), and
//       dw[dk, dl, c, o] = sum_u x_halo[u + dk*(L+2p), c] * G[u + 2p - dl, o]
//     where G is the window's g rows at the halo's pitch, zero in its pad
//     columns and 2p zero positions ahead of it: G[u + 2p - dl] is g[k, l'
//     - dl], zero off the row. So both operands shift by whole positions,
//     dl moves into N (80 columns at 16->16, 8 at 16->1), and each staged
//     x fragment feeds every (dl, o) tile of a warp. Taps mode (C == 1:
//     the 1->16 layer): M = the (dk, dl) taps, N = o, x shifted by dk *
//     (L+2p) + dl;
//   * ldmatrix has no .trans for 32-bit data, and both operands here need
//     the positions (the GEMM's K) contiguous, which x and g are not. So a
//     lane loads its fragments as float2 (hi, lo) from per-lane offsets
//     fixed for the whole kernel (a k-step adds 8 positions): 4 8-byte
//     loads an A tile, 2 a B tile. Records of 16 or more channels XOR the
//     channel with (position & 3) * 4, so each half-warp's 4 positions x 4
//     channels fall in distinct bank pairs;
//   * the tensor cores round each MMA's sum toward zero, which biases a
//     long sum kept inside them (one undrained sum of 40,000 positions
//     reads 4e-4 to 5e-4 of the scale in the emulation of
//     tests/test_torch_tf32_split.py, past the gradient check's 1e-4). So
//     each tile's k-step (its three products) goes into a zeroed partial,
//     added into the float32 accumulators with one rounding to nearest:
//     kDrainK8 = 1, kernels/conv4d_dw.py's DW_PARTIAL_K8, the cadence the
//     test emulates (about 2e-6). Holding a partial over several k-steps
//     doubles the accumulator registers, and registers set the warps an SM
//     holds;
//   * the three products of a k-step are issued product by product over
//     the m-tile's n-tiles, so consecutive MMAs are independent (one
//     tile's three in a row each wait for the last). On an H100 the first
//     form (three in a row, a partial held over 8 k-steps, 185 registers)
//     ran the 16->16 layer at 32 samples in 301 ms; this one in 148;
//   * a warp owns 5 m-tiles x 2 n-tiles (channel mode), 5 x 1 (O == 1) or
//     2 x 2 (taps mode): up to 40 float32 sums a thread, at most 102
//     registers (two blocks of 10 warps an SM; the 5 x 2 tile spills a few
//     bytes, which cost less than half the warps). A block holds up to 10
//     warps: tile warps, then warps over every KW-th k-step (2 at 16->16;
//     on the narrow layers as many as keep kStepsPerWarp k-steps each, 8 at
//     the PF-Pascal grid and 2 at the synthetic run's 8^4), whose sums the
//     block folds in shared memory in a fixed order before one write per
//     (chunk, element) (no partial per position group);
//   * pass 2 (conv4d_dw_reduce_f32) gives each element a warp where one
//     thread an element would leave the card mostly idle (fewer than 65,536
//     elements: the synthetic run's 1,296), each lane summing every 32nd
//     chunk in order, then a fixed xor tree; else one thread an element;
//   * what bounds it now (PERF.md, probes that compute wrong numbers
//     on purpose, on an H100): no one part. At 16->16, 32 samples, 148
//     ms; without the MMAs 62, without the A loads 121, without the
//     partials' adds 138, without staging past the first window 129. The
//     narrow layers are bound by staging the float2 copies (without it
//     1->16 12.6 ms of 22.8, 16->1 19.8 of 32.4). Next: staging raw
//     float32 where an operand is split once a block anyway, and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kFlushRows = 8;     // rows summed in registers per flush
constexpr int kReduceThreads = 256;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kSmemReserve = 1024;  // shared memory the runtime keeps a block
constexpr int kErrDtype = -4;
constexpr int kErrWorkspace = -5;

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

// ---------------------------------------------------------------------------
// float32 route: split-TF32 on the tensor cores (see the header).

constexpr int kF32Warps = 10;     // warps a block at most
constexpr int kF32Waves = 4;      // pass-1 blocks aimed at per resident slot
constexpr int kDrainK8 = 1;       // k8 steps the MMAs sum between drains
static_assert(kDrainK8 == 1, "compute() zeroes a partial every k-step");
constexpr int kStepsPerWarp = 4;  // k-steps a window gives a warp at least
constexpr int kSplitThreads = 256;
// bytes of split x and g copies a group of samples may take: the batch is
// cut into groups of whole samples (at least one) under it, each split and
// run through pass 1 in turn, so the workspace does not grow with the batch
constexpr int64_t kSplitBytes = int64_t(1) << 30;
// warp tiles (m16 tiles x n8 tiles a warp) of the three instantiations:
// the channel mode with N >= 16, with N <= 8 (O == 1), and the taps mode
constexpr int kF32Tiles[3][2] = {{5, 2}, {5, 1}, {2, 2}};

struct F32Plan {
  int B, I, J, K, L, C, O, ks;
  int taps;         // 1: C == 1, M = the (dk, dl) taps, N = o;
                    // 0: M = (dk, c), N = (dl, o) on g shifted by dl
  int tile;         // the warp tile: a row of kF32Tiles
  int nM, nN;       // m16 and n8 tiles in all
  int CP, OP;       // float2 (hi, lo) of a staged x / g position
  int MW, NW, KW;   // warps over m-tile groups, n-tile groups, k-steps
  int n_mg, n_ng;   // blocks over m-tile and n-tile groups
  int kwin, n_win;  // k-rows a staged window holds; windows a row
  int NKS;          // k8 steps a window: u < kwin * (L + 2p)
  int HPa, GPa;     // staged x / g positions a buffer
  int nbuf;         // staged buffers: 2 (the next window's copy overlaps
                    // this one's MMAs) or 1
  int rows_per_chunk, n_chunks;
  int smem;
};
static_assert(sizeof(F32Plan) <= 128, "F32Plan is the kernel's parameter");

// float2 a pre-split position: 1 for one channel, else C padded to even,
// so that every channel pair is one 16-byte chunk
__host__ __device__ __forceinline__ int split_stride(int C) {
  return C == 1 ? 1 : (C + 1) & ~1;
}

// Where channel ch of staged position pos lives in its record of `rec`
// float2: records of 16 or more XOR the channel with (pos & 3) * 4, so
// that the 4 positions x 4 channels a half-warp reads with one 8-byte load
// fall in 16 distinct 8-byte bank pairs.
__device__ __forceinline__ int swz(int ch, int pos, int rec) {
  return rec >= 16 ? ch ^ ((pos & 3) << 2) : ch;
}

// 8 bytes global -> shared (zeros where src_bytes is 0).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   mma16::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// out[pos][cs] = (hi, lo) of src[pos][c], tf32_split (zeros past C): each
// float32 is split once a call, not once a staged copy.
__global__ void __launch_bounds__(kSplitThreads)
    conv4d_dw_split_f32(const float* __restrict__ src, float2* __restrict__ out,
                        int64_t n_pos, int C, int CS) {
  const int64_t n = n_pos * CS;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float v;
    if (CS == C) {
      v = src[e];
    } else {
      const int64_t pos = e / CS;
      const int c = (int)(e - pos * CS);
      v = c < C ? src[pos * C + c] : 0.f;
    }
    uint32_t hi, lo;
    mma32::tf32_split(v, hi, lo);
    out[e] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
}

// dw[e] = sum over chunks of partial[chunk][e]: G lanes an element (a power
// of two up to 32), lane q summing chunks q, q + G, ... in order, then a
// fixed xor tree over the G lanes (a + b == b + a, so every lane holds the
// same bits). No atomics: a repeated call is bitwise the first.
__global__ void __launch_bounds__(kReduceThreads)
    conv4d_dw_reduce_f32(const float* __restrict__ partial,
                         float* __restrict__ dw, int n_chunks, int64_t n_el,
                         int log2_g) {
  const int G = 1 << log2_g;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t e = t >> log2_g;
  const int q = (int)(t & (G - 1));
  float sum = 0.f;
  if (e < n_el)
    for (int ch = q; ch < n_chunks; ch += G)
      sum += partial[(int64_t)ch * n_el + e];
  for (int off = G / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (e < n_el && q == 0) dw[e] = sum;
}

// Pass 1 of the float32 route: one block per (chunk of (b, i, j) rows,
// (di, dj) tap pair, m-tile group, n-tile group). Per window of a row:
//   D[m][n] += sum_u X[u + ax(m)][ac(m)] * G[u + bx(n)][bc(n)]
// over u < kwin * (L + 2p), on the staged halo X and g row G; channel
// mode: m = (dk, c), ax = dk * (L + 2p); n = (dl, o), bx = 2p - dl (G is
// the g row with 2p zero positions ahead and the halo's row pitch, so
// G[u + 2p - dl] = g[k, l' - dl], zero off the row). Taps mode (C == 1):
// m = (dk, dl), ax = dk * (L + 2p) + dl; n = o, bx = 0.
template <int MPW, int NPW>
__global__ void __launch_bounds__(kF32Warps * 32, 2)
    conv4d_dw_tf32x3_tc(const float2* __restrict__ xs,
                        const float2* __restrict__ gs,
                        float* __restrict__ partial, const F32Plan s) {
  extern __shared__ __align__(16) float2 f2_smem[];
  using namespace mma16;
  const int p = s.ks / 2;
  const int cols = s.L + 2 * p;
  const int T = s.ks * s.ks;
  const int CS = split_stride(s.C), OS = split_stride(s.O);
  const int glead = s.taps ? 0 : 2 * p;
  const int Mr = s.taps ? T : s.ks * s.C;  // rows of M, columns of N
  const int Nc = s.taps ? s.O : s.ks * s.O;
  const int chunk = blockIdx.x;
  const int mg = blockIdx.y % s.n_mg;
  const int ng = (blockIdx.y / s.n_mg) % s.n_ng;
  const int dij = blockIdx.y / (s.n_mg * s.n_ng);
  const int di = dij / s.ks, dj = dij % s.ks;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int TW = s.MW * s.NW;  // tile warps; warp = kw * TW + tile warp
  const int tw = warp % TW, kw = warp / TW;
  const int m_first = (mg * s.MW + tw % s.MW) * MPW;
  const int n_first = (ng * s.NW + tw / s.MW) * NPW;
  const int n_mt = max(0, min(MPW, s.nM - m_first));
  const int n_nt = max(0, min(NPW, s.nN - n_first));
  const int gq = lane >> 2, cq = lane & 3;
  const int xf2 = s.HPa * s.CP;         // float2 of a buffer's x part
  const int buf_f2 = xf2 + s.GPa * s.OP;

  // zero the buffers once: the pad channels, the halo's pad columns, g's
  // pad columns, lead and tail are never copied to
  {
    float4* z = reinterpret_cast<float4*>(f2_smem);
    for (int e = tid; e < s.nbuf * buf_f2 / 2; e += nthreads)
      z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();  // before any copy lands in the zeroed buffers

  // per lane: the staged float2 of its A rows (g, g+8) at u = cq, and of
  // its B column g at u = cq; a k-step adds 8 positions, rows and columns
  // past M and N read position 0 and are never written
  int aoff[MPW][2];
#pragma unroll
  for (int mt = 0; mt < MPW; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (m_first + mt) * 16 + gq + 8 * h;
      int xpos = 0, ch = 0;
      if (m < Mr) {
        if (s.taps) {
          xpos = (m / s.ks) * cols + m % s.ks;
        } else {
          xpos = (m / s.C) * cols;
          ch = m % s.C;
        }
      }
      const int pos = xpos + cq;
      aoff[mt][h] = pos * s.CP + swz(ch, pos, s.CP);
    }
  int boff[NPW];
#pragma unroll
  for (int nt = 0; nt < NPW; ++nt) {
    const int n = (n_first + nt) * 8 + gq;
    int gpos = glead, o = 0;
    if (n < Nc) {
      if (s.taps) {
        o = n;
      } else {
        gpos = glead - n / s.O;
        o = n % s.O;
      }
    }
    const int pos = gpos + cq;
    boff[nt] = xf2 + pos * s.OP + swz(o, pos, s.OP);
  }

  // the float32 sums of the warp's tiles
  float acc[MPW][NPW][4];
#pragma unroll
  for (int mt = 0; mt < MPW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

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

  // the window's halo (kwin + 2p rows of the input row, its L interior
  // columns) and its kwin k-rows of g, from the pre-split copies, in 16-byte
  // chunks of two channels (8 bytes where a position has one); rows off the
  // grid are zero-filled. A thread keeps one (column, chunk) and walks rows.
  auto stage = [&](int r, int win, int buf) {
    float2* xb = f2_smem + buf * buf_f2;
    float2* gb = xb + xf2;
    const int j = r % s.J, i = (r / s.J) % s.I, b = r / (s.I * s.J);
    const int k0 = win * s.kwin;
    const int64_t KL = (int64_t)s.K * s.L;
    const float2* xr =
        xs + (((int64_t)b * s.I + i + di - p) * s.J + j + dj - p) * KL * CS;
    const float2* gr = gs + (((int64_t)b * s.I + i) * s.J + j) * KL * OS;
    const int nx = s.C == 1 ? 1 : CS / 2;
    for (int e = tid; e < s.L * nx; e += nthreads) {
      const int l = e / nx, q = e - l * nx;
      for (int hr = 0; hr < s.kwin + 2 * p; ++hr) {
        const int kk = k0 + hr - p;
        const bool ok = kk >= 0 && kk < s.K;
        const int pos = hr * cols + p + l;
        float2* dst = xb + pos * s.CP + swz(2 * q, pos, s.CP);
        const float2* src = ok ? xr + ((int64_t)kk * s.L + l) * CS + 2 * q : xs;
        if (s.C == 1)
          cp_async8(dst, src, ok ? 8 : 0);
        else
          cp_async16(dst, src, ok ? 16 : 0);
      }
    }
    const int nq = s.O == 1 ? 1 : OS / 2;
    for (int e = tid; e < s.L * nq; e += nthreads) {
      const int l = e / nq, q = e - l * nq;
      for (int kl = 0; kl < s.kwin; ++kl) {
        const int kk = k0 + kl;
        const bool ok = kk < s.K;
        const int pos = glead + kl * cols + l;
        float2* dst = gb + pos * s.OP + swz(2 * q, pos, s.OP);
        const float2* src = ok ? gr + ((int64_t)kk * s.L + l) * OS + 2 * q : gs;
        if (s.O == 1)
          cp_async8(dst, src, ok ? 8 : 0);
        else
          cp_async16(dst, src, ok ? 16 : 0);
      }
    }
  };

  auto compute = [&](int buf) {
    const float2* sb = f2_smem + buf * buf_f2;
    for (int st = kw; st < s.NKS; st += s.KW) {
      const int ux = st * 8 * s.CP, ug = st * 8 * s.OP;
      // B: g at positions u and u + 4 of this lane's column, shared by
      // every m-tile of the warp
      uint32_t bh[NPW][2], bl[NPW][2];
#pragma unroll
      for (int nt = 0; nt < NPW; ++nt) {
        const float2 v0 = sb[boff[nt] + ug];
        const float2 v1 = sb[boff[nt] + ug + 4 * s.OP];
        bh[nt][0] = __float_as_uint(v0.x), bl[nt][0] = __float_as_uint(v0.y);
        bh[nt][1] = __float_as_uint(v1.x), bl[nt][1] = __float_as_uint(v1.y);
      }
      // A: x^T, rows g and g+8 at positions u and u + 4 (rows past M read
      // position 0). Each tile's k-step goes into a zeroed partial, the
      // three products of mma_tf32x3 in its order (lo*hi, hi*lo, hi*hi),
      // each over the m-tile's NPW tiles before the next, so consecutive
      // MMAs are independent; the partial is then added into the float32
      // sums with one rounding to nearest (kDrainK8 = 1)
#pragma unroll
      for (int mt = 0; mt < MPW; ++mt) {
        if (mt >= n_mt) break;
        const float2 v0 = sb[aoff[mt][0] + ux];
        const float2 v1 = sb[aoff[mt][1] + ux];
        const float2 v2 = sb[aoff[mt][0] + ux + 4 * s.CP];
        const float2 v3 = sb[aoff[mt][1] + ux + 4 * s.CP];
        const uint32_t ah[4] = {__float_as_uint(v0.x), __float_as_uint(v1.x),
                                __float_as_uint(v2.x), __float_as_uint(v3.x)};
        const uint32_t al[4] = {__float_as_uint(v0.y), __float_as_uint(v1.y),
                                __float_as_uint(v2.y), __float_as_uint(v3.y)};
        float part[NPW][4] = {};
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int nt = 0; nt < NPW; ++nt)
            if (nt < n_nt)
              mma32::mma_tf32(part[nt], q == 0 ? al : ah,
                              q == 1 ? bl[nt][0] : bh[nt][0],
                              q == 1 ? bl[nt][1] : bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];
      }
    }
  };

  // over the windows of the chunk's rows whose input row is on the grid;
  // with two buffers the next window's copy is in flight during this one's
  // MMAs
  auto advance = [&](int& r, int& win) {
    if (win + 1 == s.n_win) {
      r = next_row(r + 1);
      win = 0;
    } else {
      ++win;
    }
  };
  const bool two = s.nbuf == 2;
  int r = next_row(r0), win = 0, buf = 0;
  if (r < r1) stage(r, 0, 0);
  cp_async_commit();
  while (r < r1) {
    int rn = r, wn = win;
    advance(rn, wn);
    if (two) {
      if (rn < r1) stage(rn, wn, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(buf);
    __syncthreads();  // every warp is done with `buf` before it is refilled
    if (!two && rn < r1) {
      stage(rn, wn, 0);
      cp_async_commit();
    }
    r = rn;
    win = wn;
    if (two) buf ^= 1;
  }
  cp_async_wait<0>();

  // fold the k-step warps of each tile warp in order (kw = 0, 1, ...) in
  // shared memory, then one write per (chunk, element)
  constexpr int NA = MPW * NPW * 4;
  float* fold = reinterpret_cast<float*>(f2_smem);
  __syncthreads();
  if (kw > 0) {
    float* f = fold + ((kw - 1) * TW + tw) * NA * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MPW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[((mt * NPW + nt) * 4 + e) * 32] = acc[mt][nt][e];
  }
  __syncthreads();
  if (kw > 0) return;
  for (int k2 = 1; k2 < s.KW; ++k2) {
    const float* f = fold + ((k2 - 1) * TW + tw) * NA * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MPW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NPW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += f[((mt * NPW + nt) * 4 + e) * 32];
  }
  // partial[chunk][dij][dk][dl][c][o]
  float* slot = partial + ((int64_t)chunk * T + dij) * ((int64_t)T * s.C * s.O);
#pragma unroll
  for (int mt = 0; mt < MPW; ++mt) {
    if (mt >= n_mt) break;
#pragma unroll
    for (int nt = 0; nt < NPW; ++nt) {
      if (nt >= n_nt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = (m_first + mt) * 16 + gq + (e >> 1) * 8;
        const int n = (n_first + nt) * 8 + 2 * cq + (e & 1);
        if (m >= Mr || n >= Nc) continue;
        int el;
        if (s.taps) {
          el = m * s.O + n;  // tap * O + o (C == 1)
        } else {
          const int dk = m / s.C, c = m % s.C, dl = n / s.O, o = n % s.O;
          el = ((dk * s.ks + dl) * s.C + c) * s.O + o;
        }
        slot[el] = acc[mt][nt][e];
      }
    }
  }
}

template <int MPW, int NPW>
int launch_f32(const float2* xs, const float2* gs, float* partial,
               const F32Plan& s, cudaStream_t st, int* per_sm) {
  auto kernel = conv4d_dw_tf32x3_tc<MPW, NPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = s.MW * s.NW * s.KW * 32;
  if (per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, threads, s.smem);
  const dim3 grid(s.n_chunks, s.ks * s.ks * s.n_mg * s.n_ng);
  kernel<<<grid, threads, s.smem, st>>>(xs, gs, partial, s);
  return (int)cudaGetLastError();
}

// The instantiation of a plan's tile: its occupancy if per_sm is set,
// else its launch.
int by_tile(const float2* xs, const float2* gs, float* partial,
            const F32Plan& s, cudaStream_t st, int* per_sm) {
  if (s.tile == 0) return launch_f32<5, 2>(xs, gs, partial, s, st, per_sm);
  if (s.tile == 1) return launch_f32<5, 1>(xs, gs, partial, s, st, per_sm);
  return launch_f32<2, 2>(xs, gs, partial, s, st, per_sm);
}
static_assert(kF32Tiles[0][0] == 5 && kF32Tiles[0][1] == 2 &&
                  kF32Tiles[1][0] == 5 && kF32Tiles[1][1] == 1 &&
                  kF32Tiles[2][0] == 2 && kF32Tiles[2][1] == 2,
              "by_tile instantiates kF32Tiles");

// A float32 call: the batch cut into n_groups groups of `group` samples
// (the last may hold fewer), pass 1 planned for a whole group, and the
// workspace: every group's chunk partials, in group order, then one group's
// split x copy (its float2 rounded up to even, so that the g copy after it
// starts on 16 bytes for cp.async) and split g copy.
struct F32Call {
  F32Plan s;
  int batch, group, n_groups;
  int64_t partial_floats, xs_f2, workspace;
};

// The float32 call's plan.
int make_f32_plan(int B, int I, int J, int K, int L, int C, int O, int ks,
                  F32Call* call) {
  if (B < 1 || I < 1 || J < 1 || K < 1 || L < 1 || C < 1 || O < 1 ||
      ks < 1 || ks % 2 == 0)
    return kErrBadShape;
  if ((int64_t)B * I * J > 0x7fffffff || (int64_t)K * L > 0x7fffffff)
    return kErrBadShape;
  const int64_t sample_pos = (int64_t)I * J * K * L;
  const int64_t sample_bytes =
      8 * sample_pos * (split_stride(C) + split_stride(O));
  int64_t most = kSplitBytes / sample_bytes;
  if (most < 1) most = 1;
  const int b_groups = (int)((B + most - 1) / most);
  const int group = (B + b_groups - 1) / b_groups;
  F32Plan s{};
  s.B = group, s.I = I, s.J = J, s.K = K, s.L = L, s.C = C, s.O = O, s.ks = ks;
  const int T = ks * ks;
  const int p = ks / 2;
  const int cols = L + 2 * p;
  s.taps = C == 1;
  s.tile = s.taps ? 2 : (ks * O <= 8 ? 1 : 0);
  const int MPW = kF32Tiles[s.tile][0], NPW = kF32Tiles[s.tile][1];
  s.nM = ((s.taps ? T : ks * C) + 15) / 16;
  s.nN = ((s.taps ? O : ks * O) + 7) / 8;
  s.CP = C == 1 ? 1 : (C + 15) / 16 * 16;
  s.OP = O == 1 ? 1 : (O + 15) / 16 * 16;
  const int n_groups = (s.nN + NPW - 1) / NPW, m_groups = (s.nM + MPW - 1) / MPW;
  s.NW = n_groups < kF32Warps ? n_groups : kF32Warps;
  s.MW = m_groups < kF32Warps / s.NW ? m_groups : kF32Warps / s.NW;
  s.KW = kF32Warps / (s.MW * s.NW);
  s.n_mg = (s.nM + s.MW * MPW - 1) / (s.MW * MPW);
  s.n_ng = (s.nN + s.NW * NPW - 1) / (s.NW * NPW);
  if ((int64_t)T * s.n_mg * s.n_ng > 65535) return kErrBadShape;
  const int glead = s.taps ? 0 : 2 * p;
  // the staged sizes of a window of kwin k-rows (the fold of the k-step
  // warps at the end reuses the buffers)
  auto size = [&](int kwin, int nbuf, F32Plan* t) {
    t->NKS = (kwin * cols + 7) / 8;
    t->HPa = ((kwin + 2 * p) * cols + 8 + 2 * p + 1) & ~1;
    t->GPa = (glead + kwin * cols + 8 + 1) & ~1;
    t->nbuf = nbuf;
    const size_t stage =
        (size_t)nbuf * ((size_t)t->HPa * t->CP + (size_t)t->GPa * t->OP) * 8;
    const size_t fold =
        (size_t)(t->KW - 1) * t->MW * t->NW * MPW * NPW * 4 * 32 * 4;
    const size_t smem = ((stage > fold ? stage : fold) + 15) / 16 * 16;
    t->smem = (int)smem;
    return smem;
  };

  Device d;
  int code = query_device(&d);
  if (code != 0) return code;
  // two buffers that leave room for a second block on the SM, else two in
  // a block's limit, else one; the k-rows spread evenly over the windows
  const size_t budgets[3] = {d.pair, d.max, d.max};
  const int bufs[3] = {2, 2, 1};
  for (int c = 0; c < 3 && s.kwin == 0; ++c)
    for (int kwin = K; kwin >= 1; --kwin) {
      F32Plan t = s;
      if (size(kwin, bufs[c], &t) <= budgets[c]) {
        const int n_win = (K + kwin - 1) / kwin;
        s.kwin = (K + n_win - 1) / n_win;
        s.nbuf = bufs[c];
        break;
      }
    }
  if (s.kwin == 0) return kErrSharedMemory;
  s.n_win = (K + s.kwin - 1) / s.kwin;
  // no more k-step warps than a window's k-steps keep busy: on short rows
  // smaller blocks, more of them an SM, cover each other's copies
  {
    F32Plan t = s;
    size(s.kwin, s.nbuf, &t);
    const int kw = t.NKS / kStepsPerWarp;
    s.KW = kw < 1 ? 1 : (kw < s.KW ? kw : s.KW);
  }
  size(s.kwin, s.nbuf, &s);

  // the blocks the card holds at once, from the occupancy of this very
  // kernel, times kF32Waves: no row chunk past the last whole wave
  int per_sm = 0;
  code = by_tile(nullptr, nullptr, nullptr, s, nullptr, &per_sm);
  if (code != 0) return code;
  if (per_sm < 1) per_sm = 1;
  const int rows = group * I * J;
  const int per_chunk_blocks = T * s.n_mg * s.n_ng;
  int chunks = kF32Waves * per_sm * d.sms / per_chunk_blocks;
  if (chunks < 1) chunks = 1;
  if (chunks > rows) chunks = rows;
  s.rows_per_chunk = (rows + chunks - 1) / chunks;
  s.n_chunks = (rows + s.rows_per_chunk - 1) / s.rows_per_chunk;
  const int64_t n_el = (int64_t)T * T * C * O;
  const int64_t group_pos = (int64_t)group * sample_pos;
  call->s = s;
  call->batch = B, call->group = group, call->n_groups = b_groups;
  call->partial_floats =
      ((int64_t)b_groups * s.n_chunks * n_el + 3) / 4 * 4;
  call->xs_f2 = (group_pos * split_stride(C) + 1) & ~int64_t(1);
  call->workspace = call->partial_floats +
                    2 * (call->xs_f2 + group_pos * split_stride(O));
  return 0;
}

// make_f32_plan for the last shape this thread planned on this device, from
// a cache: the wrapper asks for the workspace, then launches, and every
// call of a training run repeats a few shapes, while a plan costs several
// CUDA queries (the occupancy among them) of host time, most of a small
// layer's call.
int cached_f32_plan(int B, int I, int J, int K, int L, int C, int O, int ks,
                    F32Call* out) {
  struct Entry {
    int key[9];
    F32Call call;
  };
  constexpr int kEntries = 8;
  thread_local Entry cache[kEntries];
  thread_local int used = 0, next = 0;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int key[9] = {dev, B, I, J, K, L, C, O, ks};
  for (int e = 0; e < used; ++e) {
    bool same = true;
    for (int k = 0; k < 9; ++k) same = same && cache[e].key[k] == key[k];
    if (same) {
      *out = cache[e].call;
      return 0;
    }
  }
  const int code = make_f32_plan(B, I, J, K, L, C, O, ks, out);
  if (code != 0) return code;
  Entry& e = cache[next];
  for (int k = 0; k < 9; ++k) e.key[k] = key[k];
  e.call = *out;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return 0;
}

// Per group of samples: split its x and g, then pass 1 into its chunks'
// partials (a short last group's chunks past its rows write zeros); then
// pass 2 over every group's chunks in order.
int run_f32(const float* x, const float* g, float* work, float* dw,
            const F32Call& call, cudaStream_t st) {
  const F32Plan& s = call.s;
  const int64_t sample_pos = (int64_t)s.I * s.J * s.K * s.L;
  const int CS = split_stride(s.C), OS = split_stride(s.O);
  const int T = s.ks * s.ks;
  const int64_t n_el = (int64_t)T * T * s.C * s.O;
  float2* xs = reinterpret_cast<float2*>(work + call.partial_floats);
  float2* gs = xs + call.xs_f2;
  auto split = [&](const float* src, float2* dst, int64_t n_pos, int C,
                   int stride) {
    const int64_t n = n_pos * stride;
    const int64_t want = (n + kSplitThreads - 1) / kSplitThreads;
    const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
    conv4d_dw_split_f32<<<blocks, kSplitThreads, 0, st>>>(src, dst, n_pos, C,
                                                          stride);
    return (int)cudaGetLastError();
  };
  for (int grp = 0; grp < call.n_groups; ++grp) {
    const int b0 = grp * call.group;
    F32Plan sg = s;
    sg.B = call.batch - b0 < call.group ? call.batch - b0 : call.group;
    const int64_t pos0 = (int64_t)b0 * sample_pos;
    const int64_t n_pos = (int64_t)sg.B * sample_pos;
    int code = split(x + pos0 * s.C, xs, n_pos, s.C, CS);
    if (code == 0) code = split(g + pos0 * s.O, gs, n_pos, s.O, OS);
    if (code == 0)
      code = by_tile(xs, gs, work + (int64_t)grp * s.n_chunks * n_el, sg, st,
                     nullptr);
    if (code != 0) return code;
  }
  const int n_chunks = call.n_groups * s.n_chunks;
  // a warp an element where one thread an element would leave most of the
  // card idle
  const int log2_g = n_el < (1 << 16) ? 5 : 0;
  const int64_t threads = n_el << log2_g;
  const int blocks = (int)((threads + kReduceThreads - 1) / kReduceThreads);
  conv4d_dw_reduce_f32<<<blocks, kReduceThreads, 0, st>>>(
      work, dw, n_chunks, n_el, log2_g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `workspace` points at two values:
// workspace[1] receives the launches of pass 1 a call makes (float32: one a
// group of samples; bfloat16: 1). With partial == NULL only the plan is
// made: workspace[0] receives the partial buffer's size in floats and
// nothing is launched. Otherwise partial must hold at least that many
// floats, and every pass is launched on `stream`. Returns 0 on success, a
// cudaError_t value (> 0) when CUDA refused a launch, or a negative code
// below.
int conv4d_dw(const void* x, const void* g, float* partial, float* dw,
              long long* workspace, int dtype, int B, int I, int J, int K,
              int L, int C, int O, int ks, void* stream) {
  if (dtype != 0 && dtype != 1) return kErrDtype;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    F32Call call;
    const int code = cached_f32_plan(B, I, J, K, L, C, O, ks, &call);
    if (code != 0) return code;
    workspace[1] = call.n_groups;
    if (partial == nullptr) {
      *workspace = (long long)call.workspace;
      return 0;
    }
    if (*workspace < (long long)call.workspace) return kErrWorkspace;
    return run_f32(static_cast<const float*>(x), static_cast<const float*>(g),
                   partial, dw, call, st);
  }
  TcPlan s;
  int code = make_tc_plan(B, I, J, K, L, C, O, ks, x, g, &s);
  if (code != 0) return code;
  workspace[1] = 1;
  if (partial == nullptr) {
    *workspace = (long long)s.workspace;
    return 0;
  }
  if (*workspace < (long long)s.workspace) return kErrWorkspace;
  code = dispatch_tc(x, g, partial, s, st);
  if (code != 0) return code;
  const int ks2 = ks * ks;
  const int per_tap = ks2 * C * O;
  const int64_t n = (int64_t)ks2 * per_tap;
  const int blocks = (int)((n + kReduceThreads - 1) / kReduceThreads);
  conv4d_dw_reduce<<<blocks, kReduceThreads, 0, st>>>(
      partial, dw, s.n_chunks, ks2, s.KW, per_tap);
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
             "too wide (at 16 channels about 590 in bfloat16, 290 in "
             "float32)";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    case kErrWorkspace:
      return "the partial buffer is smaller than the plan needs";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
