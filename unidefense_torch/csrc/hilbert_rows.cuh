// The row-Hilbert pass shared by K2 (sfconv_freq_fwd.cu), K2-bwd
// (sfconv_freq_bwd.cu), K3 and K3-bwd (sfconv_v4.cu) and K4 and K4-bwd
// (sfconv_v3.cu):
//
//   hx[n, h] = round_T(hm @ x[n, h])   for every image row (n, h),
//
// hm the (W, W) circular row-Hilbert matrix, fp32 accumulation, the result
// rounded to the storage type T as the TPU kernels round it
// (unidefense_tpu/ops/sfconv_pallas.py:152,241). hm @ x_m, the product at the
// mirror row, is hx at row m, so each product is formed once. The TPU kernel
// forms this product in its own body; here it is a pass of its own, because
// the mixes that read hx tile output channels and would otherwise form it once
// per tile.
//
// Bound on an H100: 2*W^2*C flops per row against 2*W*C elements moved
// (W = 95: 95 flops per element), so on the CUDA cores (fp32 FMA, 67
// TFLOP/s) the pass is bound by operations, on the tensor cores by bytes.
//
//  * bfloat16 (hilbert_rows_mma_kernel): on the tensor cores, 16x16x16 WMMA
//    (mma.sync) with M = W padded to 16, K = W, N = 64 channels at a time. A
//    block keeps hm in shared memory once and walks kRowsPerBlock image rows
//    and kChannelsPerBlock channels; the product goes through shared memory
//    so the store is 16 bytes a thread. wgmma's 64-row tiles would idle
//    most of a tile at W = 12 or 24; mma.sync's 16 rows fit.
//  * float32 (hilbert_rows_kernel): one block per image row keeps hm and a
//    64-channel chunk of the row in shared memory, fp32 FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The dynamic shared memory limit a kernel was raised to, per device: the
// attribute belongs to the device's context, so a process that launches on
// several cards (a Predictor's replicas) raises it on each.
constexpr int kMaxDevices = 64;
struct SmemLimit {
  size_t bytes[kMaxDevices] = {};
};

// Raise a kernel's dynamic shared memory limit on the current device once,
// to the largest size asked for there so far.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, SmemLimit* configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= configured->bytes[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) configured->bytes[dev] = bytes;
  return e;
}

constexpr int kHilbertThreads = 256;
constexpr int kHC = 64;  // channels per chunk

template <typename T>
__global__ void __launch_bounds__(kHilbertThreads)
hilbert_rows_kernel(const T* __restrict__ x, const T* __restrict__ hm, T* __restrict__ hx,
                    int W, int C) {
  extern __shared__ float hsmem[];
  float* hm_s = hsmem;        // W * W
  float* xs = hm_s + W * W;   // W * kHC
  const long long row = (long long)blockIdx.x * W * C;  // image row n*H + h
  for (int i = threadIdx.x; i < W * W; i += kHilbertThreads) hm_s[i] = to_f32(hm[i]);
  const int c = threadIdx.x % kHC;
  for (int c0 = 0; c0 < C; c0 += kHC) {
    __syncthreads();
    for (int i = threadIdx.x; i < W * kHC; i += kHilbertThreads) {
      const int v = i / kHC, k = i % kHC;
      xs[i] = c0 + k < C ? to_f32(x[row + (long long)v * C + c0 + k]) : 0.f;
    }
    __syncthreads();
    if (c0 + c >= C) continue;
    for (int w = threadIdx.x / kHC; w < W; w += kHilbertThreads / kHC) {
      const float* hrow = hm_s + w * W;
      float acc = 0.f;
      for (int v = 0; v < W; ++v) acc = fmaf(hrow[v], xs[v * kHC + c], acc);
      hx[row + (long long)w * C + c0 + c] = from_f32<T>(acc);
    }
  }
}

// rows = N * H image rows of (W, C) each.
template <typename T>
cudaError_t launch_hilbert_rows(const T* x, const T* hm, T* hx, int rows, int W, int C,
                                cudaStream_t s) {
  static SmemLimit configured;
  const size_t smem = sizeof(float) * ((size_t)W * W + (size_t)W * kHC);
  cudaError_t e = allow_smem(hilbert_rows_kernel<T>, smem, &configured);
  if (e != cudaSuccess) return e;
  hilbert_rows_kernel<T><<<rows, kHilbertThreads, smem, s>>>(x, hm, hx, W, C);
  return cudaGetLastError();
}

constexpr int kRowsPerBlock = 4;        // image rows a block walks
constexpr int kChannelsPerBlock = 256;  // channels a block covers, in chunks of kHC
constexpr int kLdX = kHC + 8;           // bf16 row stride of the staged chunk
constexpr int kLdO = kHC + 4;           // fp32 row stride of the product

// Shared memory of hilbert_rows_mma_kernel at width W (padded to Wp).
inline size_t hilbert_mma_smem(int W) {
  const size_t wp = (W + 15) / 16 * 16;
  return 2 * wp * (wp + 8) + 2 * wp * kLdX + 4 * wp * kLdO;
}

__global__ void __launch_bounds__(kHilbertThreads)
hilbert_rows_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ hm,
                        __nv_bfloat16* __restrict__ hx, int rows, int W, int C) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char hmsmem[];
  const int Wp = (W + 15) / 16 * 16;
  const int ldh = Wp + 8;
  bf16* hm_s = reinterpret_cast<bf16*>(hmsmem);  // Wp x ldh, zero past W
  bf16* x_s = hm_s + Wp * ldh;                   // Wp x kLdX, rows past W zero
  float* o_s = reinterpret_cast<float*>(x_s + Wp * kLdX);  // Wp x kLdO
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < Wp * Wp; i += kHilbertThreads) {
    const int r = i / Wp, c = i % Wp;
    hm_s[r * ldh + c] = r < W && c < W ? hm[r * W + c] : zero;
  }
  for (int i = W * kLdX + threadIdx.x; i < Wp * kLdX; i += kHilbertThreads) x_s[i] = zero;

  const int warp = threadIdx.x / 32;
  const int tiles_m = Wp / 16;
  const int tasks = tiles_m * (kHC / 16);
  for (int r = 0; r < kRowsPerBlock; ++r) {
    const int ir = blockIdx.x * kRowsPerBlock + r;
    if (ir >= rows) break;
    const long long base = (long long)ir * W * C;
    for (int cc = 0; cc < kChannelsPerBlock / kHC; ++cc) {
      const int c0 = blockIdx.y * kChannelsPerBlock + cc * kHC;
      if (c0 >= C) break;
      __syncthreads();  // x_s and o_s free again
      for (int i = threadIdx.x; i < W * (kHC / 8); i += kHilbertThreads) {
        const int v = i / (kHC / 8), k = (i % (kHC / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (c0 + k < C) val = *reinterpret_cast<const uint4*>(x + base + (long long)v * C + c0 + k);
        *reinterpret_cast<uint4*>(x_s + v * kLdX + k) = val;
      }
      __syncthreads();
      for (int task = warp; task < tasks; task += kHilbertThreads / 32) {
        const int mi = task / (kHC / 16), nj = task % (kHC / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = 0; k < tiles_m; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, hm_s + 16 * mi * ldh + 16 * k, ldh);
          wmma::load_matrix_sync(fb, x_s + 16 * k * kLdX + 16 * nj, kLdX);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(o_s + 16 * mi * kLdO + 16 * nj, acc, kLdO, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < W * (kHC / 8); i += kHilbertThreads) {
        const int w = i / (kHC / 8), k = (i % (kHC / 8)) * 8;
        if (c0 + k >= C) continue;
        const float* o = o_s + w * kLdO + k;
        __align__(16) __nv_bfloat162 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = __floats2bfloat162_rn(o[2 * q], o[2 * q + 1]);
        *reinterpret_cast<uint4*>(hx + base + (long long)w * C + c0 + k) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
  }
}

// bfloat16 takes the tensor-core kernel; needs C % 8 == 0 (16-byte loads).
inline cudaError_t launch_hilbert_rows(const __nv_bfloat16* x, const __nv_bfloat16* hm,
                                       __nv_bfloat16* hx, int rows, int W, int C,
                                       cudaStream_t s) {
  static SmemLimit configured;
  const size_t smem = hilbert_mma_smem(W);
  cudaError_t e = allow_smem(hilbert_rows_mma_kernel, smem, &configured);
  if (e != cudaSuccess) return e;
  dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock,
            (C + kChannelsPerBlock - 1) / kChannelsPerBlock);
  hilbert_rows_mma_kernel<<<grid, kHilbertThreads, smem, s>>>(x, hm, hx, rows, W, C);
  return cudaGetLastError();
}

}  // namespace
