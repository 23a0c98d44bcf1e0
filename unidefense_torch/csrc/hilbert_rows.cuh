// The row-Hilbert pass shared by K2 (sfconv_freq_fwd.cu) and K2-bwd
// (sfconv_freq_bwd.cu):
//
//   hx[n, h] = round_T(hm @ x[n, h])   for every image row (n, h),
//
// hm the (W, W) circular row-Hilbert matrix, fp32 accumulation, the result
// rounded to the storage type T as the TPU kernels round it
// (unidefense_tpu/ops/sfconv_pallas.py:152,241). One block per image row
// keeps hm and a 64-channel chunk of the row in shared memory. hm @ x_m, the
// product at the mirror row, is hx at row m, so each product is formed once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Raise a kernel's dynamic shared memory limit once, to the largest size
// asked for so far.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) *configured = bytes;
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
  static size_t configured = 0;
  const size_t smem = sizeof(float) * ((size_t)W * W + (size_t)W * kHC);
  cudaError_t e = allow_smem(hilbert_rows_kernel<T>, smem, &configured);
  if (e != cudaSuccess) return e;
  hilbert_rows_kernel<T><<<rows, kHilbertThreads, smem, s>>>(x, hm, hx, W, C);
  return cudaGetLastError();
}

}  // namespace
