// Hopper building blocks shared by the wgmma kernels (wgmma_mix.cuh's
// channel mix of K2, K3 and K4, weight_sums.cuh's sums) and K1's tile ring
// (normalize_flip.cu): shared-memory addresses, mbarriers,
// 16-byte cp.async copies that complete on an mbarrier or in commit groups, the 128-byte
// swizzled tile layout and its wgmma matrix descriptors, wgmma itself, and
// setmaxnreg. All of it is inline PTX for sm_90a; no library is involved.
//
// Tile layout. Every operand tile in shared memory is made of rows of 128
// bytes (64 bf16), 1024-byte aligned, with the 16-byte chunk c of row r stored
// at chunk c ^ (r % 8): the canonical SWIZZLE_128B layout that TMA writes and
// wgmma reads (CUTLASS's Swizzle<3,4,3>). The producers here write it with
// cp.async (sw128 below), because the mirrored operands need a per-row
// address that one TMA box cannot express.
//
//  * K-major (desc_k): rows are the M (or N) index, the 64 bf16 of a row are
//    K. 8-row groups lie 1024 bytes apart (SBO); a k16 step advances the start
//    address by 32 bytes inside the swizzle atom.
//  * MN-major (desc_mn): rows are K, the 64 bf16 of a row are M (or N).
//    A panel holds 64 columns; panels lie `panel_bytes` apart (LBO) and 8-row
//    groups 1024 bytes apart (SBO); a k16 step advances 16 rows (2048 bytes).

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte swizzled tile.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)r * 128u + ((uint32_t)(c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros and reads
// nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// Close the group of cp.async copies this thread issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed; the barrier's expected count includes it (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Order shared-memory writes of the generic proxy (cp.async) before reads of
// the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

constexpr uint64_t kDescSwizzle128 = 1ull << 62;

// K-major SWIZZLE_128B descriptor of the tile at shared address `addr`.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | kDescSwizzle128;
}

// MN-major SWIZZLE_128B descriptor: 64-column panels `panel_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t panel_bytes) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((panel_bytes >> 4) & 0x3FFF) << 16) |
         (64ull << 32) | kDescSwizzle128;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from moving accumulator registers across asynchronous
// wgmma operations that are still writing them.
template <int kN>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (m64 x n64, fp32, 32 registers a thread) += A (m64 x k16) B (k16 x n64), bf16
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// D (m64 x n128, fp32, 64 registers a thread) += A (m64 x k16) B (k16 x n128), bf16
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t desc_a, uint64_t desc_b) {
  static_assert(kN == 64 || kN == 128, "wgmma_bf16: N is 64 or 128");
  if constexpr (kN == 64)
    wgmma_m64n64k16<kTransA, kTransB>(d, desc_a, desc_b);
  else
    wgmma_m64n128k16<kTransA, kTransB>(d, desc_a, desc_b);
}

}  // namespace
