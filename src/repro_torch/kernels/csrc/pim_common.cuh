// Device helpers shared by the port's CUDA kernels: the PIM attention
// kernels (prefill and decode) and the PIM matmul.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pim {

// Masked score code.  Any real code lies in [-128, 127], so a slot holding
// kNeg is a masked one.
constexpr float kNeg = -16777216.0f;  // -(1 << 24)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The 8-bit score code of one integer dot product s = float(s_int) (exact),
// with the reference's multiply order ((s * qs) * ks) * sm_scale, IEEE
// division and round-half-to-even, and no conversion instruction: for
// |x| <= 2^22 the float 1.5 * 2^23 + x rounds to 1.5 * 2^23 + rint(x) (half
// to even), so its bits less those of 1.5 * 2^23 are rint(x).  x is clamped
// to +-2^22 first, which changes no code in [-qmax - 1, qmax].
__device__ inline int score_code_int(float s, float qs, float ks, float sm_scale,
                                     float score_scale, int qmax) {
  s = __fmul_rn(__fmul_rn(__fmul_rn(s, qs), ks), sm_scale);
  const float x = fminf(fmaxf(__fdiv_rn(s, score_scale), -4194304.0f), 4194304.0f);
  const int r = __float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000;
  return min(max(r, -qmax - 1), qmax);
}

// ---- Hopper building blocks: cp.async staging, ldmatrix, s8 mma.sync ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past `src_bytes` are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (a strided scale); zero when `src_bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += A (16 x 32, row) . B (32 x 8, col), int8 in, exact int32 sums
__device__ __forceinline__ void mma_k32(int (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Raise a kernel's dynamic shared memory limit once per process.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace pim
