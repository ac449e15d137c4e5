// Forward of one sparse-band neighbourhood-consensus layer, fused, written by
// hand for Hopper (sm_90a):
//
//   out[b,n,o] = relu(bias[o] + sum_{t,c} x[b, ptr[b,n,t], c] * w[t*C + c, o])
//
// x [B,N,C] is the band's flat entry list, ptr [B,N,T] int32 the neighbour
// pointer table (T = k^4 taps, tap-major / channel-minor against the
// flattened kernel w [T*C, O]); a pointer equal to N is the null slot and
// reads zeros. float32 or bfloat16 in and out, float32 accumulation. In
// bfloat16 the result is rounded as the reference rounds it: the product to
// bfloat16 first, then the bfloat16 bias added and the sum rounded again.
//
// Replaces: ncnet_tpu/kernels/band_gemm_pallas.py::_fused_kernel (TPU
// Pallas), public band_conv_bias_relu_pallas.
//
// What bounds it on an H100: bytes. At the 400 px PF-Pascal config with a
// K = 16 band (N = 10,000 entries per sample, T = 625) the pointer table is
// 25 MB per layer pass and sample, while the entry list is 640 KB at 16
// float32 channels and stays in the 50 MB L2. Counting every tap, a served
// pair is 7.2 GFLOP over both symmetric passes, and most taps are null, so
// the work that carries data is far smaller still.
//
// Design (a first, simple and correct kernel; tensor cores and cp.async/TMA
// gathers come later):
//   * one thread per band entry (row), kRows rows per block, all OT <= 16
//     output channels accumulated in registers;
//   * taps are walked in chunks of tc: the block stages the chunk's weight
//     slice [tc, C, OT] (float32, zero-padded to OT) and its rows' pointers
//     [kRows, tc] in shared memory. The pointer tile is read coalesced
//     along the taps, once: the table is the one large array, so every
//     pointer byte crosses the memory bus exactly once;
//   * each thread then walks its row's staged pointers and, for each
//     non-null one, reads that neighbour's C channels from global memory
//     (L2-resident) and does C x OT FMAs against the broadcast weights. Null
//     pointers cost one shared-memory read and no FLOP;
//   * the bias and ReLU are applied in registers and the row is written
//     once. A pointer outside [0, N] is treated as null, so no read ever
//     leaves the entry list.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kRows = 128;        // band entries (threads) per block
constexpr int kMaxTapChunk = 64;  // taps staged per chunk
constexpr int kWeightBudget = 32 * 1024;  // bytes of staged weights

// Error codes returned besides cudaError_t values (which are >= 0).
constexpr int kErrBadShape = -1;
constexpr int kErrSharedMemory = -2;
constexpr int kErrGrid = -3;
constexpr int kErrDtype = -4;
constexpr int kErrChannels = -5;

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

template <typename T, int OT>
__global__ void __launch_bounds__(kRows)
    band_gemm_fwd_kernel(const T* __restrict__ x, const int* __restrict__ ptr,
                         const T* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int N, int taps, int C, int O, int tc) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                          // [tc][C][OT]
  int* ps = reinterpret_cast<int*>(smem + tc * C * OT);      // [kRows][tc+1]
  const int pitch = tc + 1;  // odd: a warp's row reads hit distinct banks
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - row0);
  const int tid = threadIdx.x;
  const bool live = tid < rows;
  const T* xb = x + (int64_t)b * N * C;
  const int* pb = ptr + ((int64_t)b * N + row0) * taps;

  float acc[OT];
#pragma unroll
  for (int o = 0; o < OT; ++o) acc[o] = 0.f;

  for (int t0 = 0; t0 < taps; t0 += tc) {
    const int nt = min(tc, taps - t0);
    __syncthreads();  // the previous chunk's reads of ws/ps are done
    const T* wc = w + (int64_t)t0 * C * O;
    for (int e = tid; e < nt * C * OT; e += kRows) {
      const int o = e % OT;
      ws[e] = o < O ? to_f32(wc[(int64_t)(e / OT) * O + o]) : 0.f;
    }
    for (int e = tid; e < rows * nt; e += kRows) {
      const int r = e / nt;
      const int t = e - r * nt;
      ps[r * pitch + t] = pb[(int64_t)r * taps + t0 + t];
    }
    __syncthreads();
    if (!live) continue;
    const int* mine = ps + tid * pitch;
    for (int t = 0; t < nt; ++t) {
      const int p = mine[t];
      if ((unsigned)p >= (unsigned)N) continue;  // null slot: zeros
      const T* xr = xb + (int64_t)p * C;
      const float* wt = ws + t * C * OT;
      for (int c = 0; c < C; ++c) {
        const float xv = to_f32(xr[c]);
        if constexpr (OT % 4 == 0) {
          const float4* w4 = reinterpret_cast<const float4*>(wt + c * OT);
#pragma unroll
          for (int o4 = 0; o4 < OT / 4; ++o4) {
            const float4 wv = w4[o4];
            acc[4 * o4 + 0] = fmaf(xv, wv.x, acc[4 * o4 + 0]);
            acc[4 * o4 + 1] = fmaf(xv, wv.y, acc[4 * o4 + 1]);
            acc[4 * o4 + 2] = fmaf(xv, wv.z, acc[4 * o4 + 2]);
            acc[4 * o4 + 3] = fmaf(xv, wv.w, acc[4 * o4 + 3]);
          }
        } else {
#pragma unroll
          for (int o = 0; o < OT; ++o)
            acc[o] = fmaf(xv, wt[c * OT + o], acc[o]);
        }
      }
    }
  }

  if (!live) return;
  T* dst = out + ((int64_t)b * N + row0 + tid) * O;
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    if (o < O) {
      const float y = round_like<T>(acc[o]) + bias[o];
      dst[o] = from_f32<T>(fmaxf(y, 0.f));
    }
  }
}

template <typename T, int OT>
int launch(const void* x, const int* ptr, const void* w, const float* bias,
           void* out, int B, int N, int taps, int C, int O, int tc,
           size_t smem, cudaStream_t stream) {
  auto kernel = band_gemm_fwd_kernel<T, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kRows - 1) / kRows, B);
  kernel<<<grid, kRows, smem, stream>>>(
      static_cast<const T*>(x), ptr, static_cast<const T*>(w), bias,
      static_cast<T*>(out), N, taps, C, O, tc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const int* ptr, const void* w, const float* bias,
             void* out, int B, int N, int taps, int C, int O, int OT, int tc,
             size_t smem, cudaStream_t st) {
  switch (OT) {
    case 1:
      return launch<T, 1>(x, ptr, w, bias, out, B, N, taps, C, O, tc, smem, st);
    case 4:
      return launch<T, 4>(x, ptr, w, bias, out, B, N, taps, C, O, tc, smem, st);
    case 8:
      return launch<T, 8>(x, ptr, w, bias, out, B, N, taps, C, O, tc, smem, st);
    default:
      return launch<T, 16>(x, ptr, w, bias, out, B, N, taps, C, O, tc, smem,
                           st);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bias is float32 (the activation-dtype
// bias converted exactly). Returns 0 on a successful launch, a cudaError_t
// value (> 0) when CUDA refused it, or one of the negative codes above.
int band_gemm_fwd(const void* x, const void* ptr, const void* w,
                  const void* bias, void* out, int dtype, int B, int N,
                  int taps, int C, int O, void* stream) {
  if (B < 1 || N < 1 || taps < 1 || C < 1 || O < 1) return kErrBadShape;
  if (O > 16) return kErrChannels;
  if (B > 65535) return kErrGrid;
  const int OT = O == 1 ? 1 : (O <= 4 ? 4 : (O <= 8 ? 8 : 16));
  int tc = kWeightBudget / (C * OT * (int)sizeof(float));
  tc = tc < 1 ? 1 : (tc > kMaxTapChunk ? kMaxTapChunk : tc);
  if (tc > taps) tc = taps;
  const size_t smem = ((size_t)tc * C * OT + (size_t)kRows * (tc + 1)) * 4;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return kErrSharedMemory;

  const int* p = static_cast<const int*>(ptr);
  const float* bs = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, p, w, bs, out, B, N, taps, C, O, OT, tc, smem,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, p, w, bs, out, B, N, taps, C, O, OT, tc,
                                   smem, st);
  return kErrDtype;
}

const char* band_gemm_fwd_error_string(int code) {
  switch (code) {
    case kErrBadShape:
      return "shape not taken: B, N, taps, C and O must be >= 1";
    case kErrSharedMemory:
      return "one tap's staged weights exceed the block's shared memory";
    case kErrGrid:
      return "grid too large: B must be <= 65535";
    case kErrDtype:
      return "dtype not taken: float32 (0) or bfloat16 (1)";
    case kErrChannels:
      return "cout not taken: the instantiations take 1 to 16";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
