// Tensor-core building blocks of the float32 route of the conv4d forward
// (conv4d_fwd.cu), for sm_90a: split-TF32 ("3xTF32") products.
//
//   * tf32_split: a float32 a as hi = cvt.rna.tf32.f32(a) and
//     lo = cvt.rna.tf32.f32(a - hi). a - hi is exact in float32, so
//     hi + lo keeps a to about 2^-22 relative;
//   * mma_tf32: one mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
//     D += A (16x8, row) * B (8x8, col), float32 accumulators;
//   * mma_tf32x3: A*B as A_lo*B_hi, then A_hi*B_lo, then A_hi*B_hi into
//     the same accumulators, in that fixed order. A_lo*B_lo (about 2^-22
//     relative) is the one product dropped. TF32 x TF32 products are exact
//     in float32, so what is left is float32 accumulation;
//   * swizzle4 / stage_halo32: the zero-padded halo of one input row as
//     records of 16 float32 channels (four 16-byte chunks).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32),
// with g = lane / 4 and c = lane % 4:
//   A regs a0..a3: (row g, col c), (row g+8, col c), (row g, col c+4),
//                  (row g+8, col c+4);
//   B regs b0, b1: (row c, col g), (row c+4, col g);
//   D d0..d3: (row g, cols 2c, 2c+1), (row g+8, cols 2c, 2c+1).
// A non-.trans ldmatrix.x4 of 32-bit data gives lane l the word (row l/4,
// word l%4) of each 8-row x 16-byte matrix: with matrix 0 the positions
// 0-7 at channels 0-3, 1 the positions 8-15 at channels 0-3, 2 and 3 the
// same at channels 4-7, that is exactly a0..a3, so the lanes address
// shifted positions directly, as on the bfloat16 route.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma32 {

__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// hi + lo == a to about 2^-22 relative (both TF32 bit patterns).
__device__ __forceinline__ void tf32_split(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A * B on split operands, in the fixed order lo*hi, hi*lo, hi*hi.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// Byte offset of 16-byte chunk q (0..3) of record r, records of 16 float32
// (64 bytes). Chunk q of record r sits in slot q ^ ((r >> 1) & 3): the 8
// records of one ldmatrix phase (8 consecutive records, one chunk each)
// then cover all 8 16-byte bank groups, since r mod 8 picks both r's
// parity and its slot.
__device__ __forceinline__ uint32_t swizzle4(int r, int q) {
  return (uint32_t)(4 * r + (q ^ ((r >> 1) & 3))) * 16u;
}

// The zero-padded (k, l, c) halo of one input row as float32 records:
// channel group cg of padded row hr < rows, column hc < cols at record
// cg * rec_stride + hr * cols + hc holds x[k0 + hr - p, hc - p, 16 cg ..
// 16 cg + 15] (zeros off the grid and past C). With `async` (C % 4 == 0
// and a 16-byte aligned src_row, the caller's to check) by cp.async, each
// thread keeping one chunk column and walking the rows, so the loop does
// no division; else by plain loads.
__device__ __forceinline__ void stage_halo32(
    unsigned char* dst, const float* src_row, int k0, int rows, int cols,
    int p, int K, int L, int C, int CG, int rec_stride, bool async, int tid,
    int nthreads) {
  auto on_grid = [&](int kk, int ll) {
    return kk >= 0 && kk < K && ll >= 0 && ll < L;
  };
  if (!async) {
    for (int e = tid; e < CG * rows * cols * 16; e += nthreads) {
      const int c16 = e & 15;
      const int hc = (e >> 4) % cols;
      const int hr = (e / (16 * cols)) % rows;
      const int cg = e / (16 * cols * rows);
      const int kk = k0 + hr - p, ll = hc - p, c = cg * 16 + c16;
      *reinterpret_cast<float*>(
          dst + swizzle4(cg * rec_stride + hr * cols + hc, c16 >> 2) +
          (c16 & 3) * 4) =
          on_grid(kk, ll) && c < C ? src_row[((int64_t)kk * L + ll) * C + c]
                                   : 0.f;
    }
    return;
  }
  auto copy = [&](int cg, int hr, int hc, int q) {
    const int kk = k0 + hr - p, ll = hc - p, c0 = cg * 16 + q * 4;
    const bool ok = on_grid(kk, ll) && c0 < C;
    mma16::cp_async16(
        dst + swizzle4(cg * rec_stride + hr * cols + hc, q),
        ok ? src_row + ((int64_t)kk * L + ll) * C + c0 : src_row,
        ok ? 16 : 0);
  };
  const int cpr = 4 * cols;  // chunks a padded row
  if (cpr > nthreads) {      // a row wider than the block: plain walk
    for (int e = tid; e < CG * rows * cpr; e += nthreads)
      copy(e / (cpr * rows), (e / cpr) % rows, (e >> 2) % cols, e & 3);
    return;
  }
  const int step = nthreads / cpr;  // rows walked at once
  int hr = tid / cpr;
  if (hr >= step) return;  // the threads past the last whole column set
  const int hc = (tid % cpr) >> 2;
  int cg = 0;
  while (hr >= rows) hr -= rows, ++cg;
  while (cg < CG) {
    copy(cg, hr, hc, tid & 3);
    hr += step;
    while (hr >= rows) hr -= rows, ++cg;
  }
}

}  // namespace mma32
