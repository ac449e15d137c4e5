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
// Design (a first, simple and correct kernel; wgmma/TMA come later): the
// folded GEMM of ncnet_tpu/ops/conv4d.py::_dw_fold. For one (b, i, j) row
// and one (di, dj) tap pair the contribution is one
// [ks*ks*C, K*L] @ [K*L, O] product.
//   * pass 1: one block per (chunk of (b, i, j) rows, (di, dj) tap pair).
//     For each row of its chunk whose input row (i+di-p, j+dj-p) is on the
//     grid, the block stages the zero-padded (k, l, c) halo of that input
//     row and the g row in shared memory as float32. Each thread owns one
//     (dk, dl) tap, a tile of CT input and OT output channels, and a group
//     of the K*L positions, and keeps CT x OT float32 accumulators in
//     registers (register-blocked FFMA on the CUDA cores);
//   * every kFlushRows rows the registers are added into the thread's own
//     slots of a partial buffer in global memory, so no float chain is
//     longer than kFlushRows * (K*L / position groups) products;
//   * pass 2: one thread per dw element sums the partials of every chunk
//     and position group in a fixed order. No atomics: a repeated call is
//     bitwise reproducible;
//   * the staged halo stores each position with a stride that keeps a
//     warp's float4 reads in distinct banks; threads that share an output
//     tile read the same g value (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;  // __launch_bounds__ of pass 1
constexpr int kFlushRows = 8;     // rows summed in registers per flush
constexpr int kBlocksPerSm = 4;   // pass-1 blocks aimed at per SM
constexpr int kReduceThreads = 256;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrUnits = -3;
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
  int x_floats;        // staged halo floats (a multiple of 4)
  size_t smem;
  int64_t workspace;   // partial floats
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
  const int halo = (s.K + 2 * p) * cols;
  const int KL = s.K * s.L;
  const int ks2 = s.ks * s.ks;
  float* sx = smem;               // [K+2p][L+2p][cs]
  float* sg = smem + s.x_floats;  // [K*L][os]

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
  const int per = (KL + s.n_pg - 1) / s.n_pg;
  const int q0 = min(KL, pg * per);
  const int q1 = min(KL, q0 + per);
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
    __syncthreads();  // the previous row's reads of sx/sg are done
    const T* xr = x + (((int64_t)b * s.I + ii) * s.J + jj) * row_x;
    for (int e = tid; e < halo * s.cs; e += nthreads) {
      const int c = e % s.cs;
      const int cell = e / s.cs;
      const int kk = cell / cols - p;
      const int ll = cell % cols - p;
      sx[e] = (c < s.C && kk >= 0 && kk < s.K && ll >= 0 && ll < s.L)
                  ? to_f32(xr[((int64_t)kk * s.L + ll) * s.C + c])
                  : 0.f;
    }
    const T* gr = g + (((int64_t)b * s.I + i) * s.J + j) * row_g;
    for (int e = tid; e < KL * s.os; e += nthreads) {
      const int o = e % s.os;
      sg[e] = o < s.O ? to_f32(gr[(int64_t)(e / s.os) * s.O + o]) : 0.f;
    }
    __syncthreads();

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
        for (int o = 0; o < OT; ++o) acc[c][o] = fmaf(xv[c], gv[o], acc[c][o]);
      if (++l == s.L) {
        l = 0;
        ++k;
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
  const int halo = (K + 2 * p2) * (L + 2 * p2);
  p.x_floats = (halo * p.cs + 3) / 4 * 4;
  p.smem = ((size_t)p.x_floats + (size_t)K * L * p.os) * sizeof(float);

  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (p.smem > (size_t)max_smem) return kErrSharedMemory;

  const int rows = B * I * J;
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
  Plan s;
  int code = make_plan(B, I, J, K, L, C, O, ks, &s);
  if (code != 0) return code;
  if (partial == nullptr) {
    *workspace = (long long)s.workspace;
    return 0;
  }
  if (*workspace < (long long)s.workspace) return kErrWorkspace;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  code = dtype == 0 ? dispatch<float>(x, g, partial, s, st)
                    : dispatch<__nv_bfloat16>(x, g, partial, s, st);
  if (code != 0) return code;
  const int ks2 = ks * ks;
  const int per_tap = ks2 * C * O;
  const int64_t n = (int64_t)ks2 * per_tap;
  const int blocks = (int)((n + kReduceThreads - 1) / kReduceThreads);
  conv4d_dw_reduce<<<blocks, kReduceThreads, 0, st>>>(
      partial, dw, s.n_chunks, ks2, s.n_pg, per_tap);
  return (int)cudaGetLastError();
}

const char* conv4d_dw_error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1, an odd kernel size, and "
             "B*I*J and K*L within int32";
    case kErrSharedMemory:
      return "the staged halo and g row exceed the block's shared memory";
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
