// The bf16 tensor-core building blocks of the port's kernels: the product
// mma.sync.m16n8k16 of bf16 operands summed in f32 (sgcn_fwd.cu,
// sgcn_bwd.cu, tconv_mma.cuh), ldmatrix fragment loads and cp.async staging
// of bf16 tiles into shared memory (the spatial conv's kernels), and a
// fixed-order sum across lanes.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16 operands): lane = 4 g + q;
// A (16 x 16): a0 = A[g][2q, 2q+1], a1 = A[g+8][2q, 2q+1], a2 = A[g][2q+8,
// 2q+9], a3 = A[g+8][2q+8, 2q+9]; B (16 x 8): b0 = B[2q, 2q+1][g], b1 =
// B[2q+8, 2q+9][g]; C (16 x 8, f32): c0, c1 = C[g][2q, 2q+1], c2, c3 =
// C[g+8][2q, 2q+1]; the lower half of a 32-bit register holds the element
// of the lower index.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices: lane l gives the address of
// row l % 8 of matrix l / 8, and register i receives matrix i, lane l
// holding elements (l / 4, 2 (l % 4) and 2 (l % 4) + 1) of it, or of its
// transpose with .trans. The *_at helpers place the four matrices so that
// the registers are an A fragment (a0..a3), or the B fragments (b0, b1) of
// two neighbouring n8 tiles (registers 0, 1 and 2, 3), of an operand stored
// either way round in shared memory: "rows" means A as [m][k] or B as
// [n][k] (plain ldmatrix), "cols" A as [k][m] or B as [k][n] (.trans). So
// no operand is ever transposed in memory. Staged rows are padded so that
// the 8 rows of a matrix fall in distinct banks (a row stride of 4, 12 or
// 20 words mod 32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// This lane's ldmatrix address for the A fragment of rows m0..m0+15 and
// depth k0..k0+15, A stored [m][k] with row stride ld (ldsm_x4).
__device__ __forceinline__ const bf16* a_rows_at(const bf16* a, int ld,
                                                 int m0, int k0, int lane) {
  return a + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3);
}

// The same fragment of A stored [k][m] (ldsm_x4_trans).
__device__ __forceinline__ const bf16* a_cols_at(const bf16* a, int ld,
                                                 int m0, int k0, int lane) {
  return a + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
         (((lane >> 3) & 1) << 3);
}

// This lane's address for the B fragments of columns n0..n0+15 (two n8
// tiles) and depth k0..k0+15, B stored [n][k] (ldsm_x4).
__device__ __forceinline__ const bf16* b_rows_at(const bf16* b, int ld,
                                                 int n0, int k0, int lane) {
  return b + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         (((lane >> 3) & 1) << 3);
}

// The same fragments of B stored [k][n] (ldsm_x4_trans).
__device__ __forceinline__ const bf16* b_cols_at(const bf16* b, int ld,
                                                 int n0, int k0, int lane) {
  return b + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
         ((lane >> 4) << 3);
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows with 16-byte aligned starts: a row length (in bf16) that is a
// multiple of 8 and an aligned base.
__device__ __forceinline__ bool rows_aligned(const bf16* base, int ld) {
  return ld % 8 == 0 && (reinterpret_cast<size_t>(base) & 15) == 0;
}

// Stage rows [0, ROWS) and columns [c0, c0 + COLS) of the row-major bf16
// matrix src (row stride ld; rows < n_rows and columns < n_cols hold data)
// into dst[row * ld_s + column - c0], zero elsewhere. Unless ALL_COLS, only
// the columns up to the next multiple of 16 past n_cols are written: where
// the columns are a product's depth, or columns whose results are never
// stored, it reads no further. aligned (rows_aligned, and c0 a multiple of
// 8): by cp.async in 16-byte groups, each all in or all out of range, which
// the caller commits and waits for. Otherwise (a row of C_in = 3 is 6
// bytes) element by element, at once.
template <int ROWS, int COLS, int THREADS, bool ALL_COLS = false>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld_s,
                                           const bf16* src, int ld,
                                           int n_rows, int c0, int n_cols,
                                           bool aligned, int tid) {
  const int span =
      ALL_COLS ? COLS : min(COLS, (n_cols - c0 + 15) / 16 * 16);
  if (aligned) {
    const int groups = span / 8;
    for (int i = tid; i < ROWS * groups; i += THREADS) {
      const int r = i / groups, c = (i % groups) * 8;
      const bool ok = r < n_rows && c0 + c < n_cols;
      cp_async16(dst + r * ld_s + c, ok ? src + size_t(r) * ld + c0 + c : src,
                 ok);
    }
  } else {
    for (int i = tid; i < ROWS * span; i += THREADS) {
      const int r = i / span, c = i % span;
      dst[r * ld_s + c] = (r < n_rows && c0 + c < n_cols)
                              ? src[size_t(r) * ld + c0 + c]
                              : __float2bfloat16(0.f);
    }
  }
}

// Sum v over the 8 lanes that share lane % 4, in a fixed order.
__device__ __forceinline__ float lane_group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// Blocks of a persistent kernel: per_sm on each SM of the current device,
// and no more than there are tiles.
inline int persistent_blocks(int per_sm, int tiles) {
  int device = 0, sms = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return tiles < per_sm * sms ? tiles : per_sm * sms;
}

}  // namespace mma_bf16
