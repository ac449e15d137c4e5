// Forward of the SAME, stride-1 4D convolution of neighbourhood consensus,
// written by hand for Hopper (sm_90a).
//
//   out[b,i,j,k,l,o] = bias[o] + sum_{di,dj,dk,dl,c}
//       x[b, i+di-p, j+dj-p, k+dk-p, l+dl-p, c] * w[di,dj,dk,dl,c,o]
//
// with zero padding p = ks/2, an odd hypercubic ks^4 kernel, channels-last
// activations x [B,I,J,K,L,C] (the packed [B,I,J,K*L*C] layout of the JAX
// package) and weights w [ks,ks,ks,ks,C,O]. float32 or bfloat16 in and out,
// float32 accumulation, the bias added once in float32.
//
// Replaces: ncnet_tpu/kernels/conv4d_pallas.py::_fwd_kernel (TPU Pallas).
//
// What bounds it on an H100: operations. At the 400 px PF-Pascal config the
// three NC layers (1->16, 16->16, 16->1 at 5^4 taps on a 25^4 grid) do about
// 281 GFLOP per served pair (both symmetric directions) while moving well
// under 0.1 GB, so the arithmetic intensity is thousands of FLOP per byte.
//
// Design (a first, simple and correct kernel; wgmma/TMA come later):
//   * one block per (b, i, j) output row and per tile of up to 640 (k, l)
//     output positions (the whole 25x25 plane fits one tile) and per tile of
//     OT output channels;
//   * the TPU kernel's blocking (ki A-rows DMA'd per (b, i) grid step, an
//     im2col over (dl, c)) is not carried over: for each (di, dj) tap pair
//     whose input row (i+di-p, j+dj-p) lies on the grid, the block stages
//     the zero-padded (k, l, c) halo of that row and the [ks, ks, C, OT]
//     weight slice in shared memory, converted to float32;
//   * the remaining (dk, dl, c) taps are folded into one contraction of up
//     to ks^2*C per staged row; each thread keeps 4 positions x OT output
//     channels of float32 accumulators in registers, reads one activation
//     per position and a broadcast float4 of weights per step, so the
//     inner loop is register-blocked FFMA on the CUDA cores;
//   * the staged halo stores each (k, l) position with an odd stride in
//     floats, so a warp's activation reads fall in distinct banks;
//   * grids smaller than the kernel and rectangular grids need no special
//     case: rows off the grid are skipped, halo cells off the grid are 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 160;     // 5 warps
constexpr int kPosPerThread = 4;  // output (k, l) positions per thread
constexpr int kTile = kThreads * kPosPerThread;

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;

struct Shape {
  int B, I, J, K, L, C, O, ks;
  int cp;        // floats per staged (k, l) position: C rounded up to odd
  int x_floats;  // floats of the staged halo region (multiple of 4)
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

template <typename T, int OT>
__global__ void __launch_bounds__(kThreads)
    conv4d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ out,
                      const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int p = s.ks / 2;
  const int KL = s.K * s.L;
  const int cols = s.L + 2 * p;
  const int n_otiles = (s.O + OT - 1) / OT;
  const int tile = blockIdx.x / n_otiles;
  const int o0 = (blockIdx.x % n_otiles) * OT;
  const int j = blockIdx.y;
  const int b = blockIdx.z / s.I;
  const int i = blockIdx.z % s.I;
  const int p0 = tile * kTile;
  const int p1 = min(p0 + kTile, KL);
  const int kmin = p0 / s.L;
  const int kmax = (p1 - 1) / s.L;
  const int rows = kmax - kmin + 1 + 2 * p;  // staged padded k-rows
  const int taps2 = s.ks * s.ks;             // (dk, dl) pairs
  const int cp = s.cp;
  float* sx = smem;               // [rows][cols][cp]
  float* sw = smem + s.x_floats;  // [ks][ks][C][OT]
  const int tid = threadIdx.x;

  int base[kPosPerThread];
  bool valid[kPosPerThread];
#pragma unroll
  for (int q = 0; q < kPosPerThread; ++q) {
    const int pos = p0 + tid + q * kThreads;
    valid[q] = pos < p1;
    const int kk = valid[q] ? pos / s.L : kmin;
    const int ll = valid[q] ? pos % s.L : 0;
    base[q] = ((kk - kmin) * cols + ll) * cp;
  }

  float acc[kPosPerThread][OT];
#pragma unroll
  for (int q = 0; q < kPosPerThread; ++q)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[q][o] = 0.f;

  const int64_t row_elems = (int64_t)KL * s.C;
  for (int di = 0; di < s.ks; ++di) {
    const int ii = i + di - p;
    if (ii < 0 || ii >= s.I) continue;  // uniform over the block
    for (int dj = 0; dj < s.ks; ++dj) {
      const int jj = j + dj - p;
      if (jj < 0 || jj >= s.J) continue;
      __syncthreads();  // the previous tap's reads of sx/sw are done
      const T* xr = x + (((int64_t)b * s.I + ii) * s.J + jj) * row_elems;
      for (int e = tid; e < rows * cols; e += kThreads) {
        const int kk = kmin - p + e / cols;
        const int ll = e % cols - p;
        float* dst = sx + e * cp;
        if (kk >= 0 && kk < s.K && ll >= 0 && ll < s.L) {
          const T* src = xr + ((int64_t)kk * s.L + ll) * s.C;
          for (int c = 0; c < s.C; ++c) dst[c] = to_f32(src[c]);
        } else {
          for (int c = 0; c < s.C; ++c) dst[c] = 0.f;
        }
      }
      const T* wr = w + (int64_t)(di * s.ks + dj) * taps2 * s.C * s.O;
      for (int e = tid; e < taps2 * s.C * OT; e += kThreads) {
        const int o = e % OT;
        const int tc = e / OT;  // (dk * ks + dl) * C + c
        sw[e] = (o0 + o < s.O) ? to_f32(wr[(int64_t)tc * s.O + o0 + o]) : 0.f;
      }
      __syncthreads();

      for (int dk = 0; dk < s.ks; ++dk) {
        for (int dl = 0; dl < s.ks; ++dl) {
          const int off = (dk * cols + dl) * cp;
          const float* wt = sw + (dk * s.ks + dl) * s.C * OT;
#pragma unroll 2
          for (int c = 0; c < s.C; ++c) {
            float xv[kPosPerThread];
#pragma unroll
            for (int q = 0; q < kPosPerThread; ++q) xv[q] = sx[base[q] + off + c];
            if constexpr (OT % 4 == 0) {
              const float4* w4 = reinterpret_cast<const float4*>(wt + c * OT);
#pragma unroll
              for (int o4 = 0; o4 < OT / 4; ++o4) {
                const float4 wv = w4[o4];
#pragma unroll
                for (int q = 0; q < kPosPerThread; ++q) {
                  acc[q][4 * o4 + 0] = fmaf(xv[q], wv.x, acc[q][4 * o4 + 0]);
                  acc[q][4 * o4 + 1] = fmaf(xv[q], wv.y, acc[q][4 * o4 + 1]);
                  acc[q][4 * o4 + 2] = fmaf(xv[q], wv.z, acc[q][4 * o4 + 2]);
                  acc[q][4 * o4 + 3] = fmaf(xv[q], wv.w, acc[q][4 * o4 + 3]);
                }
              }
            } else {
#pragma unroll
              for (int o = 0; o < OT; ++o) {
                const float wv = wt[c * OT + o];
#pragma unroll
                for (int q = 0; q < kPosPerThread; ++q)
                  acc[q][o] = fmaf(xv[q], wv, acc[q][o]);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kPosPerThread; ++q) {
    if (!valid[q]) continue;
    const int pos = p0 + tid + q * kThreads;
    T* dst = out + ((((int64_t)b * s.I + i) * s.J + j) * KL + pos) * s.O + o0;
#pragma unroll
    for (int o = 0; o < OT; ++o)
      if (o0 + o < s.O) dst[o] = from_f32<T>(acc[q][o] + bias[o0 + o]);
  }
}

template <typename T, int OT>
int launch(const void* x, const void* w, const float* bias, void* out,
           const Shape& s, int n_tiles, size_t smem, cudaStream_t stream) {
  auto kernel = conv4d_fwd_kernel<T, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_otiles = (s.O + OT - 1) / OT;
  const dim3 grid(n_tiles * n_otiles, s.J, s.B * s.I);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w), bias,
                                           static_cast<T*>(out), s);
  return (int)cudaGetLastError();
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
  const int p = ks / 2;
  const int KL = K * L;
  const int cols = L + 2 * p;
  const int n_tiles = (KL + kTile - 1) / kTile;
  int rows_max = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int p0 = t * kTile;
    const int p1 = KL < p0 + kTile ? KL : p0 + kTile;
    const int rows = (p1 - 1) / L - p0 / L + 1 + 2 * p;
    if (rows > rows_max) rows_max = rows;
  }
  const int OT = O == 1 ? 1 : (O <= 8 ? 8 : 16);
  Shape s{B, I, J, K, L, C, O, ks, C | 1, 0};
  s.x_floats = (rows_max * cols * s.cp + 3) / 4 * 4;
  const size_t smem =
      ((size_t)s.x_floats + (size_t)ks * ks * C * OT) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return kErrSharedMemory;

  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (OT == 1) return launch<float, 1>(x, w, b, out, s, n_tiles, smem, st);
    if (OT == 8) return launch<float, 8>(x, w, b, out, s, n_tiles, smem, st);
    return launch<float, 16>(x, w, b, out, s, n_tiles, smem, st);
  }
  if (dtype == 1) {
    if (OT == 1)
      return launch<__nv_bfloat16, 1>(x, w, b, out, s, n_tiles, smem, st);
    if (OT == 8)
      return launch<__nv_bfloat16, 8>(x, w, b, out, s, n_tiles, smem, st);
    return launch<__nv_bfloat16, 16>(x, w, b, out, s, n_tiles, smem, st);
  }
  return kErrDtype;
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
