// K1: fused uint8 -> normalised float input preprocessing with a per-sample
// horizontal flip.
//
// Replaces the Pallas kernel unidefense_tpu/ops/pallas_preprocess.py
// (_kernel / _normalize, called by normalize_flip and DevicePipeline). The TPU
// kernel could not reverse inside the kernel (Mosaic has no `rev`), so it
// flipped the normalised output afterwards in a second pass; here the flip is
// a reversed read along W driven by a per-sample mask, and the whole op is one
// pass: read u8 once, write the output once.
//
// Bound on an H100: bytes. N*H*W*3 * (1 + out bytes) moved for 2 flops per
// element, far below the ~295 flop/byte ridge, so the least time is the bytes
// over 3.35 TB/s. Design: one thread per output element, consecutive threads on
// consecutive output addresses (coalesced stores); the flipped read of a warp
// covers one contiguous reversed run of the same row, so loads stay coalesced.
//
// out[n, h, w, c] = (x[n, h, w', c] * (1/255) - mean[c]) * inv_std[c],
//   w' = flip[n] ? W-1-w : w

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void normalize_flip_kernel(const uint8_t* __restrict__ x,
                                      const uint8_t* __restrict__ flip,
                                      T* __restrict__ out, long long total,
                                      int h, int w, float m0, float m1, float m2,
                                      float s0, float s1, float s2) {
  const long long row = 3LL * w;
  const long long image = row * h;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / image;
    const long long in_row = i % row;
    const int c = (int)(in_row % 3);
    long long src = i;
    if (flip != nullptr && flip[n]) {
      const long long wo = in_row / 3;
      src = i - in_row + (w - 1 - wo) * 3 + c;
    }
    const float mean = c == 0 ? m0 : (c == 1 ? m1 : m2);
    const float inv_std = c == 0 ? s0 : (c == 1 ? s1 : s2);
    const float v = (float)x[src] * (1.0f / 255.0f);
    out[i] = from_float<T>((v - mean) * inv_std);
  }
}

}  // namespace

// x: (N, H, W, 3) uint8; flip: (N,) uint8 or null; out: (N, H, W, 3) float32
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1). Returns cudaGetLastError().
extern "C" int ud_normalize_flip(const void* x, const void* flip, void* out,
                                 const void* mean_inv_std, int n, int h, int w,
                                 int out_bf16, void* stream) {
  const float* p = static_cast<const float*>(mean_inv_std);  // host array of 6
  const long long total = 3LL * n * h * w;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xu = static_cast<const uint8_t*>(x);
  const uint8_t* fu = static_cast<const uint8_t*>(flip);
  if (out_bf16) {
    normalize_flip_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        xu, fu, static_cast<__nv_bfloat16*>(out), total, h, w, p[0], p[1], p[2],
        p[3], p[4], p[5]);
  } else {
    normalize_flip_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        xu, fu, static_cast<float*>(out), total, h, w, p[0], p[1], p[2], p[3],
        p[4], p[5]);
  }
  return (int)cudaGetLastError();
}
