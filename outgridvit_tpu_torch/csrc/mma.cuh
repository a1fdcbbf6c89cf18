// Warp-level tensor-core primitives shared by the grid attention kernels
// that stage bf16 tiles in shared memory and multiply them on mma.sync
// (csrc/grid_mhsa_th.cu, csrc/grid_mhsa_packed_mma.cu): 16-byte cp.async,
// ldmatrix, mma.sync m16n8k16 / m16n8k8 with bf16 operands and fp32
// accumulators, movmatrix transposes and the two-term bf16 split of an fp32
// operand.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane
// (g, t) = (lane / 4, lane % 4) holds, of an m16n8 fp32 accumulator d,
// d[0..1] = row g, columns 2t, 2t + 1 and d[2..3] = row g + 8, the same
// columns. Of a 16 x 16 bf16 A operand it holds a[0] = (row g, k 2t..2t+1),
// a[1] = (row g + 8, the same k), a[2] = (row g, k 2t+8..2t+9), a[3] =
// (row g + 8, k 2t+8..2t+9), the lower column in the lower 16 bits; of a
// 16 x 8 B operand b[0] = (k 2t..2t+1, column g), b[1] = (k 2t+8..2t+9,
// column g). The m16n8k8 step takes a[0..1] and b[0].
#pragma once

#include <cuda_bf16.h>

namespace ogvt {

// Row stride of a staged [rows, hd] bf16 tile in 16-byte units: hd / 8
// made odd, so that the 8 rows one ldmatrix reads fall in 8 distinct bank
// groups.
__host__ __device__ constexpr int row16(int nt) { return nt | 1; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes of `src` when `bytes` is 16, 16 zero bytes when it is 0 (src
// is then not read).
__device__ __forceinline__ void cp_async16_zfill(unsigned dst,
                                                 const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x1(unsigned addr, unsigned& r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x1_t(unsigned addr, unsigned& r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(addr)
               : "memory");
}

// d += a.b on an m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_k16(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b on an m16n8k8 tile (a k tail of 8).
__device__ __forceinline__ void mma_k8(float (&d)[4], const unsigned (&a)[2],
                                       unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// The transpose of an 8 x 8 bf16 matrix held as an mma fragment.
__device__ __forceinline__ unsigned transpose8(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as two bf16 pairs whose sum is x to about 2^-17 relative:
// hi = bf16(x), lo = bf16(x - hi) (x - hi is exact in fp32).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A fragments (hi and lo terms) of the 16 x 16 matrix held in the two
// m16n8 accumulators s0 (columns 0-7) and s1 (columns 8-15).
__device__ __forceinline__ void to_a(const float (&s0)[4],
                                     const float (&s1)[4], unsigned (&hi)[4],
                                     unsigned (&lo)[4]) {
  split2(s0[0], s0[1], hi[0], lo[0]);  // rows 0-7, k 0-7
  split2(s0[2], s0[3], hi[1], lo[1]);  // rows 8-15, k 0-7
  split2(s1[0], s1[1], hi[2], lo[2]);  // rows 0-7, k 8-15
  split2(s1[2], s1[3], hi[3], lo[3]);  // rows 8-15, k 8-15
}

// The A fragment of the transpose of the matrix whose A fragment is a.
__device__ __forceinline__ void transpose_a(const unsigned (&a)[4],
                                            unsigned (&t)[4]) {
  t[0] = transpose8(a[0]);
  t[1] = transpose8(a[2]);
  t[2] = transpose8(a[1]);
  t[3] = transpose8(a[3]);
}

}  // namespace ogvt
