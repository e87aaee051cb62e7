// Tensor-core building blocks shared by the port's bf16 kernels (flash
// attention, mLSTM, the SSD scan; decode attention uses the cp.async
// pieces): cp.async copies global -> shared, ldmatrix, the mma.sync
// m16n8k16 bf16 product with fp32 accumulation, and the split of an fp32
// accumulator fragment into the bf16 hi + lo A-fragments of a second
// product.  Plain CUDA, no PyTorch headers (see kernels/_build.py).
//
// Fragment layouts (PTX ISA, "mma.m16n8k16" for .bf16), with g = lane / 4
// and t = lane % 4:
//   A (16 x 16, row major), 4 regs of 2 bf16:
//     a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, "col": element (k, n) at n-major storage), 2 regs:
//     b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C/D (16 x 8), 4 fp32:
//     c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// So the accumulators of two neighbouring n8 blocks of one product are,
// element for element, the A-fragment of a k16 step of the next product
// (FlashAttention-2's register reuse): `split_a` does that without a trip
// through shared memory.
//
// Shared-memory tiles are row major with a pitch of (columns + 8) bf16: the
// 16 bytes of padding put the eight rows of one ldmatrix 8x8 matrix in
// eight distinct groups of four banks, so ldmatrix is free of bank
// conflicts for the widths used here (rows of 32, 64 or 128 bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared.  With `valid` false the
// source size is 0: nothing is read and the 16 destination bytes are
// zero-filled (the ragged edge of a tile).  `src` must still be a mapped
// address; callers pass the tile's first row.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a (ROWS x COLS) bf16 tile into shared memory (pitch COLS + PAD) by
// 16-byte cp.async, NT threads.  Row i is read at src + i * row_stride;
// rows at or past `nvalid` are zero-filled.  Rows must be 16-byte aligned
// (the Python wrappers check it).
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* src, long long row_stride,
                                          int nvalid) {
  constexpr int CPR = COLS / 8;  // 16-byte chunks per row
  constexpr int P = COLS + PAD;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int i = c / CPR, j = (c % CPR) * 8;
    const bool ok = i < nvalid;
    cp_async16(sm + i * P + j, src + (ok ? (long long)i * row_stride + j : 0), ok);
  }
}

// Four 8x8 b16 matrices from shared memory: lanes 8m..8m+7 give the row
// addresses of matrix m, register m receives it.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way to the registers.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A-fragment of the 16 x 16 tile at (row r0, col c0) of a row-major tile
// with pitch P.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* sm, int P, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, sm + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}

// A-fragment of the 16 x 16 block of A = tile^T whose rows are tile columns
// m0..m0+15 and whose k are tile rows k0..k0+15 (a tile stored k-major,
// as x rows (s, p) for the product x^T B), through ldmatrix.trans.
__device__ __forceinline__ void ldsm_a_kmajor(uint32_t (&a)[4], const bf16* sm, int P, int k0,
                                              int m0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, sm + (k0 + (lane & 7) + ((lane >> 4) << 3)) * P + m0 + ((lane >> 3) & 1) * 8);
}

// B-fragments of two n8 blocks from a tile stored n-major (row n holds the
// k values of column n, as K rows for q.k^T): rows n0..n0+15, cols
// k0..k0+15.  b[0], b[1]: n block n0; b[2], b[3]: n block n0 + 8.
__device__ __forceinline__ void ldsm_b_nmajor(uint32_t (&b)[4], const bf16* sm, int P, int n0,
                                              int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, sm + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// B-fragments of two n8 blocks from a tile stored k-major (row k holds the
// n values, as V rows for p.v): rows k0..k0+15, cols n0..n0+15, through
// ldmatrix.trans.  b[0], b[1]: n block n0; b[2], b[3]: n block n0 + 8.
__device__ __forceinline__ void ldsm_b_kmajor(uint32_t (&b)[4], const bf16* sm, int P, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, sm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 + (lane >> 4) * 8);
}

// d += a * b on the tensor cores: bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> the bf16 pair hi = bf16(x, y), and lo = bf16((x, y) - hi):
// hi + lo carries x to about 16 significant bits.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// The accumulators c0, c1 of the n8 blocks 2j and 2j + 1 of one product ->
// the hi and lo A-fragments of the k16 step j of the next.
__device__ __forceinline__ void split_a(const float (&c0)[4], const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

}  // namespace tc
