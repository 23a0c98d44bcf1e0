// The split-K weight-sum product shared by K2-bwd (sfconv_freq_bwd.cu),
// K3-bwd (sfconv_v4.cu) and K4-bwd (sfconv_v3.cu):
//
//   S[sec] = sum over pixel rows p of  a_sec(p)^T g_sec(p),   sec = 0..3,
//
// four C x C fp32 sums stacked as S (4C x C). Each section names its own
// A operand and G operand ((N, H, W, C) tensors in the compute type), and
// either may be read at the mirror pixel (n, (-h) mod H, (-w) mod W): the
// double reversal R is an index map at load time, not a copy. The three
// backward kernels differ only in these operands:
//
//   K2-bwd  A = x, hx, R(x), R(hx)   G = g, g, g, g
//   K3-bwd  A = x, hx, x, hx         G = g, g, R(g), R(g)
//   K4-bwd  A = x, hx, rx, h(rx)     G = g, g, g, g     (rx materialised)
//
// The sums have no sequential grid on the card, so K = N*H*W is split across
// blocks: each block sums one range of pixel rows into a workspace slice, and
// reduce_splits_kernel adds the slices in a fixed order. No float atomics, so
// runs repeat bit for bit.
//
//  * bfloat16: one block per (64 output columns, section and 64 output rows,
//    K range); 32 pixel rows per chunk staged in shared memory, A^T G on the
//    tensor cores through WMMA (16x16x16 bf16, fp32 accumulators), two
//    fragments per warp. Needs C % 8 == 0 (16-byte loads).
//  * float32: the same tiling on the CUDA cores, 4 x 4 outputs per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kSumThreads = 256;
constexpr int kSumTile = 64;             // output rows (A channels) and columns (G channels) per block
constexpr int kSumKR = 32;               // pixel rows per chunk
constexpr int kSumLd = kSumTile + 8;     // bf16 row stride in shared memory (a multiple of 8 for WMMA)
constexpr int kSumLdF = kSumTile + 4;    // fp32 row stride in shared memory

template <typename T>
struct SumOperands {
  const T* a[4];
  const T* g[4];
  unsigned mirror_a;  // bit sec: read a[sec] at the mirror pixel
  unsigned mirror_g;  // bit sec: read g[sec] at the mirror pixel
};

// Offset of pixel p's channel vector in an (N, H, W, C) tensor, read directly
// or at the mirror pixel (n, (-h) mod H, (-w) mod W).
__device__ __forceinline__ long long pixel_offset(long long p, int H, int W, int C, bool mirror) {
  if (!mirror) return p * C;
  const long long hw = (long long)H * W;
  const long long n = p / hw;
  const int r = (int)(p - n * hw);
  const int h = (H - r / W) % H;
  const int w = (W - r % W) % W;
  return ((n * H + h) * W + w) * (long long)C;
}

struct SumTile {
  int sec, i0, j0;
  long long p_begin, p_end;
};

__device__ __forceinline__ SumTile sum_tile_of_block(int C, long long P, long long rows_per_split) {
  const int tiles_c = (C + kSumTile - 1) / kSumTile;
  SumTile t;
  t.sec = blockIdx.y / tiles_c;
  t.i0 = (blockIdx.y % tiles_c) * kSumTile;
  t.j0 = blockIdx.x * kSumTile;
  t.p_begin = (long long)blockIdx.z * rows_per_split;
  t.p_end = t.p_begin + rows_per_split < P ? t.p_begin + rows_per_split : P;
  return t;
}

__global__ void __launch_bounds__(kSumThreads)
dw_wmma_kernel(SumOperands<__nv_bfloat16> ops, float* __restrict__ dst_base, int H, int W, int C,
               long long P, long long rows_per_split) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  __shared__ __align__(128) bf16 a_s[kSumKR][kSumLd];        // [pixel row][A channel]
  __shared__ __align__(128) bf16 g_s[kSumKR][kSumLd];        // [pixel row][G channel]
  __shared__ __align__(128) float c_s[kSumTile][kSumLdF];    // epilogue
  const SumTile t = sum_tile_of_block(C, P, rows_per_split);
  const bf16* src = ops.a[t.sec];
  const bf16* gsrc = ops.g[t.sec];
  const bool ma = (ops.mirror_a >> t.sec) & 1u, mg = (ops.mirror_g >> t.sec) & 1u;
  const int warp = threadIdx.x / 32;
  float* dst = dst_base + (long long)blockIdx.z * 4 * C * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  const int lr = threadIdx.x / (kSumTile / 8);       // row of this thread's 16-byte load
  const int lk = (threadIdx.x % (kSumTile / 8)) * 8;  // first channel of it
  for (long long p0 = t.p_begin; p0 < t.p_end; p0 += kSumKR) {
    const long long p = p0 + lr;
    uint4 va = make_uint4(0, 0, 0, 0), vg = va;
    if (p < t.p_end) {
      if (t.i0 + lk < C)
        va = *reinterpret_cast<const uint4*>(src + pixel_offset(p, H, W, C, ma) + t.i0 + lk);
      if (t.j0 + lk < C)
        vg = *reinterpret_cast<const uint4*>(gsrc + pixel_offset(p, H, W, C, mg) + t.j0 + lk);
    }
    *reinterpret_cast<uint4*>(&a_s[lr][lk]) = va;
    *reinterpret_cast<uint4*>(&g_s[lr][lk]) = vg;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSumKR; kk += 16) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int f = 2 * warp + q, fi = f / 4, fj = f % 4;
        // A^T: element (i, k) of the fragment is a_s[k][i], i.e. column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, &a_s[kk][16 * fi], kSumLd);
        wmma::load_matrix_sync(fb, &g_s[kk][16 * fj], kSumLd);
        wmma::mma_sync(acc[q], fa, fb, acc[q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int f = 2 * warp + q, fi = f / 4, fj = f % 4;
    wmma::store_matrix_sync(&c_s[16 * fi][16 * fj], acc[q], kSumLdF, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSumTile * kSumTile; e += kSumThreads) {
    const int r = e / kSumTile, col = e % kSumTile;
    if (t.i0 + r < C && t.j0 + col < C)
      dst[((long long)t.sec * C + t.i0 + r) * C + t.j0 + col] = c_s[r][col];
  }
}

__global__ void __launch_bounds__(kSumThreads)
dw_fma_kernel(SumOperands<float> ops, float* __restrict__ dst_base, int H, int W, int C,
              long long P, long long rows_per_split) {
  __shared__ __align__(16) float a_s[kSumKR][kSumLdF];
  __shared__ __align__(16) float g_s[kSumKR][kSumLdF];
  const SumTile t = sum_tile_of_block(C, P, rows_per_split);
  const float* src = ops.a[t.sec];
  const float* gsrc = ops.g[t.sec];
  const bool ma = (ops.mirror_a >> t.sec) & 1u, mg = (ops.mirror_g >> t.sec) & 1u;
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;  // 4 rows x 4 columns each
  float* dst = dst_base + (long long)blockIdx.z * 4 * C * C;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (long long p0 = t.p_begin; p0 < t.p_end; p0 += kSumKR) {
    for (int e = threadIdx.x; e < kSumKR * kSumTile; e += kSumThreads) {
      const int r = e / kSumTile, k = e % kSumTile;
      const long long p = p0 + r;
      float va = 0.f, vg = 0.f;
      if (p < t.p_end) {
        if (t.i0 + k < C) va = src[pixel_offset(p, H, W, C, ma) + t.i0 + k];
        if (t.j0 + k < C) vg = gsrc[pixel_offset(p, H, W, C, mg) + t.j0 + k];
      }
      a_s[r][k] = va;
      g_s[r][k] = vg;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kSumKR; ++k) {
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
__global__ void __launch_bounds__(kSumThreads)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ out, long long count,
                     int splits) {
  for (long long i = blockIdx.x * (long long)kSumThreads + threadIdx.x; i < count;
       i += (long long)gridDim.x * kSumThreads) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(long long)z * count + i];
    out[i] = s;
  }
}

inline cudaError_t run_dw(const SumOperands<__nv_bfloat16>& ops, float* dst, dim3 grid, int H,
                          int W, int C, long long P, long long rows, cudaStream_t s) {
  dw_wmma_kernel<<<grid, kSumThreads, 0, s>>>(ops, dst, H, W, C, P, rows);
  return cudaGetLastError();
}

inline cudaError_t run_dw(const SumOperands<float>& ops, float* dst, dim3 grid, int H, int W,
                          int C, long long P, long long rows, cudaStream_t s) {
  dw_fma_kernel<<<grid, kSumThreads, 0, s>>>(ops, dst, H, W, C, P, rows);
  return cudaGetLastError();
}

// The four sums into out (4C x C fp32), through workspace ((splits, 4C, C)
// fp32 partial sums) when splits > 1.
template <typename T>
int launch_weight_sums(const SumOperands<T>& ops, void* workspace, void* out, int N, int H,
                       int W, int C, int splits, cudaStream_t s) {
  const long long P = (long long)N * H * W;
  const long long rows_per_split = (P + splits - 1) / splits;
  const int tiles_c = (C + kSumTile - 1) / kSumTile;
  float* dst = static_cast<float*>(splits == 1 ? out : workspace);
  dim3 grid(tiles_c, 4 * tiles_c, splits);
  cudaError_t e = run_dw(ops, dst, grid, H, W, C, P, rows_per_split, s);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long count = 4LL * C * C;
  long long blocks = (count + kSumThreads - 1) / kSumThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  reduce_splits_kernel<<<(unsigned)blocks, kSumThreads, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(out), count, splits);
  return (int)cudaGetLastError();
}

// Arguments every sums entry checks before a launch.
inline bool sums_args_ok(int n, int h, int w, int c, int splits, const void* workspace, int bf16) {
  if (w < 1 || w > 128 || n < 1 || h < 1 || c < 1 || splits < 1 || splits > 65535) return false;
  if (splits > 1 && workspace == nullptr) return false;
  return !bf16 || c % 8 == 0;
}

}  // namespace
