// Tensor-core building blocks of the bfloat16 routes of the conv4d kernels
// (conv4d_fwd.cu, conv4d_dw.cu), for sm_90a:
//
//   * mma_bf16: one mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
//     D += A (16x16 bf16, row) * B (16x8 bf16, col), float32 accumulators;
//   * ldmatrix_x4 / ldmatrix_x4_trans / ldmatrix_x2_trans: the fragments
//     from shared memory, one 16-byte row address per lane;
//   * cp_async16: a 16-byte asynchronous copy global -> shared that fills
//     zeros where the source is out of range (src_bytes = 0);
//   * swizzle: where a staged record of 16 bf16 (two 16-byte chunks) lives;
//   * stage_halo: the zero-padded halo of one input row into such records
//     (cp.async where rows are 16-byte chunks, plain loads else), or as
//     plain bf16 when there is one channel.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and c = lane % 4:
//   A regs a0..a3: (row g, cols 2c..2c+1), (row g+8, 2c..), (row g, 2c+8..),
//                  (row g+8, 2c+8..); the lower column in the low half;
//   B regs b0, b1: (rows 2c..2c+1, col g), (rows 2c+8.., col g);
//   D d0..d3: (row g, cols 2c, 2c+1), (row g+8, cols 2c, 2c+1).
// ldmatrix hands matrix q to register q; lanes 8q..8q+7 give its rows.
// Without .trans a lane receives (row g, cols 2c..2c+1) of each 8x8
// matrix; with .trans (rows 2c..2c+1, col g), which turns a [k][n] tile
// stored n-contiguous into the B fragment and a [k][m] tile stored
// m-contiguous into the A fragment.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Two bf16 bit patterns into one .b32 fragment register (lo: lower index).
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Byte offset of 16-byte chunk q (0 or 1) of record r in an array of
// records of nq chunks (nq = 1: 8 bf16; nq = 2: 16 bf16). With nq = 2 the
// chunks of records r and r+4 trade places, so the 8 rows that one
// ldmatrix phase reads (8 consecutive records, one chunk each) fall on 8
// distinct 16-byte bank groups; with nq = 1 they already do.
__device__ __forceinline__ uint32_t swizzle(int r, int q, int nq) {
  return (uint32_t)(nq == 2 ? 2 * r + (q ^ ((r >> 2) & 1)) : r) * 16u;
}

// The zero-padded (k, l, c) halo of one input row: padded row hr < rows
// and column hc < cols hold x[k0 + hr - p, hc - p, :] (zeros off the
// grid). src_row is the [K, L, C] row.
//   * C == 1: plain bf16, position hr * cols + hc at element of that index;
//   * else records of 16 channels (two swizzled 16-byte chunks, zeros past
//     C): channel group cg of the position at record cg * rec_stride +
//     hr * cols + hc. With `async` (C % 8 == 0 and a 16-byte aligned
//     src_row, the caller's to check) by cp.async, each thread keeping
//     one chunk column and walking the rows, so the loop does no
//     division; else by plain loads.
__device__ __forceinline__ void stage_halo(
    unsigned char* dst, const __nv_bfloat16* src_row, int k0, int rows,
    int cols, int p, int K, int L, int C, int CG, int rec_stride, bool async,
    int tid, int nthreads) {
  auto on_grid = [&](int kk, int ll) {
    return kk >= 0 && kk < K && ll >= 0 && ll < L;
  };
  if (C == 1) {
    uint16_t* xh = reinterpret_cast<uint16_t*>(dst);
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int kk = k0 + e / cols - p, ll = e % cols - p;
      xh[e] = on_grid(kk, ll) ? bf16_bits(src_row[(int64_t)kk * L + ll])
                              : (uint16_t)0;
    }
    return;
  }
  const int cpr = 2 * cols;  // chunks a padded row
  if (!async) {
    for (int e = tid; e < CG * rows * cols * 16; e += nthreads) {
      const int c16 = e & 15;
      const int hc = (e >> 4) % cols;
      const int hr = (e / (16 * cols)) % rows;
      const int cg = e / (16 * cols * rows);
      const int kk = k0 + hr - p, ll = hc - p, c = cg * 16 + c16;
      *reinterpret_cast<uint16_t*>(
          dst + swizzle(cg * rec_stride + hr * cols + hc, c16 >> 3, 2) +
          (c16 & 7) * 2) =
          on_grid(kk, ll) && c < C
              ? bf16_bits(src_row[((int64_t)kk * L + ll) * C + c])
              : (uint16_t)0;
    }
    return;
  }
  auto copy = [&](int cg, int hr, int hc, int q) {
    const int kk = k0 + hr - p, ll = hc - p, c0 = cg * 16 + q * 8;
    const bool ok = on_grid(kk, ll) && c0 < C;
    cp_async16(dst + swizzle(cg * rec_stride + hr * cols + hc, q, 2),
               ok ? src_row + ((int64_t)kk * L + ll) * C + c0 : src_row,
               ok ? 16 : 0);
  };
  if (cpr > nthreads) {  // a row wider than the block: plain walk
    for (int e = tid; e < CG * rows * cpr; e += nthreads)
      copy(e / (cpr * rows), (e / cpr) % rows, (e >> 1) % cols, e & 1);
    return;
  }
  const int step = nthreads / cpr;  // rows walked at once
  int hr = tid / cpr;
  if (hr >= step) return;  // the threads past the last whole column set
  const int hc = (tid % cpr) >> 1;
  int cg = 0;
  while (hr >= rows) hr -= rows, ++cg;
  while (cg < CG) {
    copy(cg, hr, hc, tid & 1);
    hr += step;
    while (hr >= rows) hr -= rows, ++cg;
  }
}

}  // namespace mma16
