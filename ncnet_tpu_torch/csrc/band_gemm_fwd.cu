// Forward of one sparse-band neighbourhood-consensus layer, fused, written by
// hand for Hopper (sm_90a). It derives each band entry's conv neighbours
// from the band itself, so no pointer table exists:
//
//   out[b,n,o] = relu(bias[o] + sum_{(t, m) in taps(b, n)} sum_c
//                                  x[b, m, c] * w[t*C + c, o])
//
// x [B,N,C] is the band's flat entry list (N = hA*wA*K), w the flattened
// kernel [T*C, O] (T = k1*k2*k3*k4 taps, row-major over the kernel), and
// indices [B,hA,wA,K] int32 the band's B-indices iB*wB + jB, sorted
// ascending per A cell. taps(b, n) are the (tap, entry) pairs whose
// neighbour is on the band: entry e = (a, s) with B cell beta reads, at tap
// t = (dA, dB), the entry of A cell a + dA - pA whose B cell is
// beta + dB - pB. float32 or bfloat16 in and out, float32 accumulation; in
// bfloat16 the result is rounded as the reference rounds it (the product to
// bfloat16 first, then the bfloat16 bias added and the sum rounded again).
//
// The symmetric pass (inv given: the inverse of sparse/nc.py's
// b_major_order permutation) runs over the entries enumerated B-major: the
// A and B offsets trade roles (A by (d3, d4), B by (d1, d2)), entry e's
// row is inv[e], and a neighbour's cell-major slot m is read at inv[m] of
// the B-major list: the table of sparse/nc.py's swapped_pointers, never
// built.
//
// Replaces: ncnet_tpu/kernels/band_gemm_pallas.py::_fused_kernel (TPU
// Pallas; it reads a [B, N, T] pointer table), public
// band_conv_bias_relu_pallas.
//
// What bounds it on an H100: operations, if anything. At the 400 px
// PF-Pascal config (K = 16, N = 10,000 entries a sample, T = 625) about
// 2.3% of the taps are on the band, so the 16->16 layer does about 0.3
// GFLOP at the served batch of 4 (4.4 us at the FP32 peak), against about
// 6 MB of entries, indices, weights and output (1.8 us at HBM speed). In
// practice the tap derivation (25*K = 400 candidate checks a row) and the
// gathers from L2 take the time.
//
// Design:
//   * one block per A cell, 8 warps, a warp per entry of the cell (rounds
//     of 8 entries): the K entries of one cell share their A-neighbour
//     cells, so the block stages the candidates once: for each (A offset,
//     slot) of the kA neighbour cells its B cell (iB, jB) decoded, its
//     entry in the pass's list and its A offset, kTile at a time (all of
//     them at once up to kTile; a wider band, such as the complete band,
//     re-stages tiles each round);
//   * tap derivation: a warp tests 32 candidates at a time, a lane each,
//     against the B window of its entry (two subtractions and an unsigned
//     compare), and a ballot appends the hits, in candidate order, to a
//     per-warp list in shared memory;
//   * accumulation: when the list could overflow, and at the end of the
//     entry, the lanes share each hit's C x O products: lane (q, o) keeps
//     V outputs from o*V (V = 4 where O is a multiple of 4, read as one
//     vector, else 1) and takes every (32/OL)-th (hit, channel) pair of
//     the list, so a hit costs the warp C*O/32 FMAs a lane, not C*O as one
//     thread per entry would. A lane's pairs are independent loads, and
//     the loop is unrolled so they are in flight together: the gathers
//     from L2 are latency, not bandwidth. A tap's weight row w[t, c, :] is
//     read coalesced by the OL lanes of one q; the entry list (640 KB at
//     16 float32 channels) and the weights (640 KB) stay in the 50 MB L2;
//   * the OL lanes of each q hold partial sums, added across q by a fixed
//     xor-shuffle tree; the bias and ReLU are applied and the row is
//     written once. Every sum has a fixed order: two calls are bitwise
//     equal;
//   * tensor cores do not pay: each hit is a [1, C] x [C, O] product with
//     its own weight matrix, so an MMA tile would carry one useful row in
//     16 unless rows were regrouped by tap, and the FMAs are not what
//     bounds the kernel (above);
//   * an inv value outside [0, N) is neither read nor written through, so
//     no access leaves the entry list or the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // entries of a cell in flight (one a warp)
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;  // candidates staged at once
constexpr int kCap = 64;     // hits a warp lists before it accumulates them
constexpr unsigned kFull = 0xffffffffu;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;
constexpr int kErrChannels = -5;

struct Band {
  int hA, wA, wB, K;           // grids and band slots per A cell
  int N;                       // hA*wA*K
  int C, O;
  int ka_i, ka_j, kb_i, kb_j;  // the pass's A- and B-offset extents
  int swapped;                 // 1: the symmetric pass (inv given)
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

// float32: the sum is exact as accumulated; bfloat16: the reference's
// product rounding
template <typename T>
__device__ __forceinline__ float round_like(float v) {
  return to_f32(from_f32<T>(v));
}

// V outputs of x's type read as one vector (V = 4 needs w and O aligned
// to it).
template <typename T, int V>
__device__ __forceinline__ void load_w(const T* p, float (&v)[V]) {
  if constexpr (V == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo), v[1] = __high2float(lo);
    v[2] = __low2float(hi), v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

// OL: lanes over output channels, V outputs a lane (OL*V >= O, OL a power
// of two); 32 / OL lanes share the (hit, channel) products of each. kC:
// the input channels C when fixed at compile time (the NC layers' 1 and
// 16), else 0.
template <typename T, int OL, int V, int kC>
__global__ void __launch_bounds__(kThreads)
    band_nc_fwd_kernel(const T* __restrict__ x,
                       const int* __restrict__ indices,
                       const int* __restrict__ inv, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ out,
                       const Band s) {
  constexpr int Q = 32 / OL;
  // the staged candidates: B cell (iB << 16 | jB, -1 where there is none),
  // entry in the pass's list, and the A offset's part of the tap
  __shared__ int cand_b[kTile];
  __shared__ int cand_src[kTile];
  __shared__ int cand_tap[kTile];
  __shared__ int hit_tap[kWarps][kCap];
  __shared__ int hit_src[kWarps][kCap];
  const int C = kC > 0 ? kC : s.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int a = blockIdx.x;  // the A cell
  const int64_t base = (int64_t)blockIdx.y * s.N;
  const int* idx = indices + base;
  const T* xb = x + base * C;
  const int ia = a / s.wA, ja = a - (a / s.wA) * s.wA;
  const int pa_i = s.ka_i / 2, pa_j = s.ka_j / 2;
  const int pb_i = s.kb_i / 2, pb_j = s.kb_j / 2;
  const int kB = s.kb_i * s.kb_j;
  const int kA = s.ka_i * s.ka_j;
  const int n_cand = kA * s.K;
  const bool resident = n_cand <= kTile;  // staged once for every entry

  // candidates [t0, t0 + n) of this cell into shared memory
  auto stage = [&](int t0, int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
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

  // the lane's share of the listed hits' products, into acc
  const int o = (lane % OL) * V;  // the lane's first output
  const int q = lane / OL;
  const bool o_live = o < s.O;
  const int ow = o_live ? o : 0;
  float acc[V];
  auto accumulate = [&](int nh) {
    __syncwarp();  // the list is written
    const int n_prod = nh * C;
#pragma unroll 4
    for (int j = q; j < n_prod; j += Q) {
      const int h = j / C;
      const int c = j - h * C;
      const float xv = to_f32(xb[(int64_t)hit_src[warp][h] * C + c]);
      float wv[V];
      load_w<T, V>(w + ((int64_t)hit_tap[warp][h] * C + c) * s.O + ow, wv);
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = fmaf(xv, o_live ? wv[v] : 0.f, acc[v]);
    }
    __syncwarp();  // the list is read before it is refilled
  };

  if (resident) {
    stage(0, n_cand);
    __syncthreads();
  }
  for (int s0 = 0; s0 < s.K; s0 += kWarps) {  // uniform over the block
    const int slot = s0 + warp;
    const bool live = slot < s.K;
    const int e = a * s.K + (live ? slot : 0);  // the warp's entry
    const int beta = idx[e];
    const int ib = beta / s.wB, jb = beta - (beta / s.wB) * s.wB;
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    int nh = 0;
    for (int t0 = 0; t0 < n_cand; t0 += kTile) {
      const int n = min(kTile, n_cand - t0);
      if (!resident) {
        __syncthreads();  // every warp is done with the previous tile
        stage(t0, n);
        __syncthreads();
      }
      if (!live) continue;
      for (int m0 = 0; m0 < n; m0 += 32) {
        const int i = m0 + lane;
        bool hit = false;
        int tap = 0, src = 0;
        if (i < n) {
          const int bc = cand_b[i];
          const int dbi = (bc >> 16) - ib + pb_i;
          const int dbj = (bc & 0xffff) - jb + pb_j;
          if (bc >= 0 && (unsigned)dbi < (unsigned)s.kb_i &&
              (unsigned)dbj < (unsigned)s.kb_j) {
            const int db = dbi * s.kb_j + dbj;
            tap = cand_tap[i] + (s.swapped ? db * kA : db);
            src = cand_src[i];
            hit = true;
          }
        }
        const unsigned mask = __ballot_sync(kFull, hit);
        if (mask == 0) continue;
        if (nh + 32 > kCap) {
          accumulate(nh);
          nh = 0;
        }
        if (hit) {
          const int at = nh + __popc(mask & ((1u << lane) - 1));
          hit_tap[warp][at] = tap;
          hit_src[warp][at] = src;
        }
        nh += __popc(mask);
      }
    }
    if (!live) continue;
    accumulate(nh);
    // the partial sums of the q groups, in a fixed tree
#pragma unroll
    for (int off = 16; off >= OL; off >>= 1)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += __shfl_xor_sync(kFull, acc[v], off);
    const int row = s.swapped ? inv[base + e] : e;
    if (q == 0 && (unsigned)row < (unsigned)s.N) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (o + v < s.O) {
          const float y = round_like<T>(acc[v]) + bias[o + v];
          out[(base + row) * s.O + o + v] = from_f32<T>(fmaxf(y, 0.f));
        }
      }
    }
  }
}

template <typename T, int OL, int V>
int launch(const void* x, const int* indices, const int* inv, const void* w,
           const float* bias, void* out, int B, const Band& s,
           cudaStream_t stream) {
  const dim3 grid(s.hA * s.wA, B);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (s.C == 1)
    band_nc_fwd_kernel<T, OL, V, 1>
        <<<grid, kThreads, 0, stream>>>(xt, indices, inv, wt, bias, ot, s);
  else if (s.C == 16)
    band_nc_fwd_kernel<T, OL, V, 16>
        <<<grid, kThreads, 0, stream>>>(xt, indices, inv, wt, bias, ot, s);
  else
    band_nc_fwd_kernel<T, OL, V, 0>
        <<<grid, kThreads, 0, stream>>>(xt, indices, inv, wt, bias, ot, s);
  return (int)cudaGetLastError();
}

// Lanes over outputs: 4 outputs a lane where O is a multiple of 4 and w
// is aligned to 4 of them, else 1.
template <typename T>
int dispatch(const void* x, const int* indices, const int* inv, const void* w,
             const float* bias, void* out, int B, const Band& s,
             cudaStream_t st) {
  if (s.O % 4 == 0 && (uintptr_t)w % (4 * sizeof(T)) == 0) {
    if (s.O == 4)
      return launch<T, 1, 4>(x, indices, inv, w, bias, out, B, s, st);
    if (s.O == 8)
      return launch<T, 2, 4>(x, indices, inv, w, bias, out, B, s, st);
    return launch<T, 4, 4>(x, indices, inv, w, bias, out, B, s, st);
  }
  if (s.O == 1) return launch<T, 1, 1>(x, indices, inv, w, bias, out, B, s, st);
  if (s.O == 2) return launch<T, 2, 1>(x, indices, inv, w, bias, out, B, s, st);
  if (s.O <= 4) return launch<T, 4, 1>(x, indices, inv, w, bias, out, B, s, st);
  if (s.O <= 8) return launch<T, 8, 1>(x, indices, inv, w, bias, out, B, s, st);
  return launch<T, 16, 1>(x, indices, inv, w, bias, out, B, s, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias is float32 (the activation-dtype
// bias converted exactly). inv ([B, N] int32, a permutation of [0, N)) is NULL on the
// plain pass and given on the symmetric pass. Returns 0 on a successful
// launch, a cudaError_t value (> 0) when CUDA refused it, or one of the
// negative codes above.
int band_gemm_fwd(const void* x, const void* indices, const void* inv,
                  const void* w, const void* bias, void* out, int dtype,
                  int B, int hA, int wA, int hB, int wB, int K,
                  int C, int O, int k1, int k2, int k3, int k4, void* stream) {
  if (B < 1 || hA < 1 || wA < 1 || hB < 1 || wB < 1 || K < 1 || C < 1 ||
      O < 1 || k1 < 1 || k2 < 1 || k3 < 1 || k4 < 1)
    return kErrBadShape;
  // B cells pack into 16 bits a coordinate
  if ((int64_t)K > (int64_t)hB * wB || hB > 32767 || wB > 65535)
    return kErrBadShape;
  if ((int64_t)hA * wA * K > 0x7fffffff) return kErrGrid;
  if (O > 16) return kErrChannels;
  if (B > 65535) return kErrGrid;
  const bool swapped = inv != nullptr;
  Band s;
  s.hA = hA, s.wA = wA, s.wB = wB, s.K = K, s.N = hA * wA * K;
  s.C = C, s.O = O;
  s.ka_i = swapped ? k3 : k1, s.ka_j = swapped ? k4 : k2;
  s.kb_i = swapped ? k1 : k3, s.kb_j = swapped ? k2 : k4;
  s.swapped = swapped;
  if (bias == nullptr) return kErrBadShape;
  const int* ix = static_cast<const int*>(indices);
  const int* iv = static_cast<const int*>(inv);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, ix, iv, w, bs, out, B, s, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, ix, iv, w, bs, out, B, s, st);
  return kErrDtype;
}

const char* band_gemm_fwd_error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: every dim >= 1, K <= hB*wB, hB < 2^15 and "
             "wB < 2^16, and a bias";
    case kErrGrid:
      return "grid too large: B must be <= 65535 and hA*wA*K < 2^31";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    case kErrChannels:
      return "cout not taken: the instantiations take 1 to 16";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
