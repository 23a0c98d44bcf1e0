// K2-bwd: SFConv frequency branch, backward, the four C x C weight sums.
//
// Replaces the dW half of the Pallas kernel
// unidefense_tpu/ops/sfconv_pallas.py (_bwd_kernel_call, reached through
// _bwd from sfconv_freq_pallas). With hx = round_T(hm @ x) per image row
// (the Hilbert pass of hilbert_rows.cuh), m = (-h) mod H the mirror row and
// Pw the width reversal, the TPU kernel accumulates over every (n, h):
//
//   A1_bar += x_h^T g_h             A2_bar += -(hx_h)^T g_h
//   B1_bar += (Pw x_m)^T g_h        B2_bar += (Pw hx_m)^T g_h
//
// All four are one product S = A^T G with K = N*H*W pixel rows,
// A = [x | hx | R(x) | R(hx)] (P x 4C) and G = g (P x C), where R reads pixel
// (n, (-h) mod H, (-w) mod W). This file returns S (4C x C, fp32) with the
// A2 block not negated; the wrapper (ops/sfconv_cuda.py) negates it and
// repacks the blocks into the (2C, 2C) kernel gradient. R is an index map at
// load time, not a copy. x_bar, the other half of the TPU kernel, is K2's
// forward on g with the blocks (A1^T, -A2^T, B1^T, B2^T), launched by the
// wrapper through sfconv_freq_fwd.cu.
//
// Bound on an H100: operations. The sums need 8*P*C^2 flops plus 2*P*W*C for
// the Hilbert pass, against (2 inputs + hx) * P*C elements, e.g. 95x95/C192 at
// batch 20 is 53 GFLOP for ~0.2 GB. K is long (up to 180,500) and the output
// small (36 tiles of 64 x 64 at C = 192), so K is split across blocks: each
// block sums one range of pixel rows into a workspace slice, and a second
// kernel adds the slices in a fixed order. No float atomics, so runs repeat
// bit for bit.
//
// Two paths, chosen from the input:
//  * bfloat16 (training): one block per (64 output columns, section and 64
//    output rows, K range); 32 pixel rows per chunk staged in shared memory,
//    A^T G on the tensor cores through WMMA (16x16x16 bf16, fp32
//    accumulators), two fragments per warp. Needs C % 8 == 0 (16-byte loads).
//  * float32: the same tiling on the CUDA cores, 4 x 4 outputs per thread.
// hx is formed by the Hilbert pass into a scratch tensor the wrapper
// allocates: one (N, H, W, C) tensor in the compute type per call, freed when
// the backward returns; the forward saves nothing extra.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hilbert_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;         // output rows (A channels) and columns (g channels) per block
constexpr int kKR = 32;           // pixel rows per chunk
constexpr int kLd = kTile + 8;    // bf16 row stride in shared memory (a multiple of 8 for WMMA)
constexpr int kLdF = kTile + 4;   // fp32 row stride in shared memory

// Offset of pixel p's channel vector in an (N, H, W, C) tensor, read directly
// or at the mirror pixel (n, (-h) mod H, (-w) mod W).
__device__ __forceinline__ long long pixel_offset(long long p, int H, int W, int C, bool mirror) {
  const long long hw = (long long)H * W;
  const long long n = p / hw;
  const int r = (int)(p - n * hw);
  int h = r / W, w = r - (r / W) * W;
  if (mirror) {
    h = (H - h) % H;
    w = (W - w) % W;
  }
  return ((n * H + h) * W + w) * (long long)C;
}

struct Tile {
  int sec, i0, j0;
  long long p_begin, p_end;
  bool mirror;
};

__device__ __forceinline__ Tile tile_of_block(int C, long long P, long long rows_per_split) {
  const int tiles_c = (C + kTile - 1) / kTile;
  Tile t;
  t.sec = blockIdx.y / tiles_c;
  t.i0 = (blockIdx.y % tiles_c) * kTile;
  t.j0 = blockIdx.x * kTile;
  t.p_begin = (long long)blockIdx.z * rows_per_split;
  t.p_end = t.p_begin + rows_per_split < P ? t.p_begin + rows_per_split : P;
  t.mirror = t.sec >= 2;
  return t;
}

using namespace nvcuda;
using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(kThreads)
dw_wmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ hx,
               const bf16* __restrict__ g, float* __restrict__ dst_base, int H, int W, int C,
               long long P, long long rows_per_split) {
  __shared__ __align__(128) bf16 a_s[kKR][kLd];      // [pixel row][A channel]
  __shared__ __align__(128) bf16 g_s[kKR][kLd];      // [pixel row][g channel]
  __shared__ __align__(128) float c_s[kTile][kLdF];  // epilogue
  const Tile t = tile_of_block(C, P, rows_per_split);
  const bf16* src = (t.sec & 1) ? hx : x;
  const int warp = threadIdx.x / 32;
  float* dst = dst_base + (long long)blockIdx.z * 4 * C * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  const int lr = threadIdx.x / (kTile / 8);       // row of this thread's 16-byte load
  const int lk = (threadIdx.x % (kTile / 8)) * 8;  // first channel of it
  for (long long p0 = t.p_begin; p0 < t.p_end; p0 += kKR) {
    const long long p = p0 + lr;
    uint4 va = make_uint4(0, 0, 0, 0), vg = va;
    if (p < t.p_end) {
      if (t.i0 + lk < C)
        va = *reinterpret_cast<const uint4*>(src + pixel_offset(p, H, W, C, t.mirror) + t.i0 + lk);
      if (t.j0 + lk < C) vg = *reinterpret_cast<const uint4*>(g + p * C + t.j0 + lk);
    }
    *reinterpret_cast<uint4*>(&a_s[lr][lk]) = va;
    *reinterpret_cast<uint4*>(&g_s[lr][lk]) = vg;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKR; kk += 16) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = 2 * warp + q, fi = f / 4, fj = f % 4;
        // A^T: element (i, k) of the fragment is a_s[k][i], i.e. column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, &a_s[kk][16 * fi], kLd);
        wmma::load_matrix_sync(fb, &g_s[kk][16 * fj], kLd);
        wmma::mma_sync(acc[q], fa, fb, acc[q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int f = 2 * warp + q, fi = f / 4, fj = f % 4;
    wmma::store_matrix_sync(&c_s[16 * fi][16 * fj], acc[q], kLdF, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, col = e % kTile;
    if (t.i0 + r < C && t.j0 + col < C)
      dst[((long long)t.sec * C + t.i0 + r) * C + t.j0 + col] = c_s[r][col];
  }
}

__global__ void __launch_bounds__(kThreads)
dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ hx,
              const float* __restrict__ g, float* __restrict__ dst_base, int H, int W, int C,
              long long P, long long rows_per_split) {
  __shared__ __align__(16) float a_s[kKR][kLdF];
  __shared__ __align__(16) float g_s[kKR][kLdF];
  const Tile t = tile_of_block(C, P, rows_per_split);
  const float* src = (t.sec & 1) ? hx : x;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;  // 4 rows x 4 columns each
  float* dst = dst_base + (long long)blockIdx.z * 4 * C * C;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (long long p0 = t.p_begin; p0 < t.p_end; p0 += kKR) {
    for (int e = threadIdx.x; e < kKR * kTile; e += kThreads) {
      const int r = e / kTile, k = e % kTile;
      const long long p = p0 + r;
      float va = 0.f, vg = 0.f;
      if (p < t.p_end) {
        if (t.i0 + k < C) va = src[pixel_offset(p, H, W, C, t.mirror) + t.i0 + k];
        if (t.j0 + k < C) vg = g[p * C + t.j0 + k];
      }
      a_s[r][k] = va;
      g_s[r][k] = vg;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKR; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[k][4 * ti]);
      const float4 b = *reinterpret_cast<const float4*>(&g_s[k][4 * tj]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = t.i0 + 4 * ti + u;
    if (r >= C) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = t.j0 + 4 * tj + v;
      if (col < C) dst[((long long)t.sec * C + r) * C + col] = acc[u][v];
    }
  }
}

// out[i] = sum over s = 0, 1, ... of ws[s][i], always in that order.
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ out, long long count,
                     int splits) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < count;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(long long)z * count + i];
    out[i] = s;
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* x, const void* g, const void* hm, void* hx,
           void* workspace, void* out, int N, int H, int W, int C, int splits, cudaStream_t s) {
  cudaError_t e = launch_hilbert_rows(static_cast<const T*>(x), static_cast<const T*>(hm),
                                      static_cast<T*>(hx), N * H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  const long long P = (long long)N * H * W;
  const long long rows_per_split = (P + splits - 1) / splits;
  const int tiles_c = (C + kTile - 1) / kTile;
  float* dst = static_cast<float*>(splits == 1 ? out : workspace);
  dim3 grid(tiles_c, 4 * tiles_c, splits);
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(hx),
                                   static_cast<const T*>(g), dst, H, W, C, P, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long count = 4LL * C * C;
  long long blocks = (count + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  reduce_splits_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(out), count, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g: (N, H, W, C) float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous,
// 16-byte aligned; hm: (W, W) in the same type; hx: an (N, H, W, C) scratch
// tensor in the same type. out: (4C, C) float32, the sums [x | hx | R(x) |
// R(hx)]^T g in four row blocks. The pixel rows are split into `splits`
// ranges; with splits > 1, workspace holds (splits, 4C, C) float32 partial
// sums. Needs 1 <= W <= 128, and C % 8 == 0 for bfloat16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these
// limits.
extern "C" int ud_sfconv_freq_bwd_dw(const void* x, const void* g, const void* hm, void* hx,
                                     void* workspace, void* out, int n, int h, int w, int c,
                                     int splits, int bf16, void* stream) {
  if (w < 1 || w > 128 || n < 1 || h < 1 || c < 1 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (c % 8 != 0) return (int)cudaErrorInvalidValue;
    return launch<__nv_bfloat16>(dw_wmma_kernel, x, g, hm, hx, workspace, out, n, h, w, c,
                                 splits, s);
  }
  return launch<float>(dw_fma_kernel, x, g, hm, hx, workspace, out, n, h, w, c, splits, s);
}
