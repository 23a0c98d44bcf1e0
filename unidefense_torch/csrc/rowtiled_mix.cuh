// The row-tiled channel mix shared by K3 (sfconv_v4.cu) and K4
// (sfconv_v3.cu): for a block of R consecutive image rows (up to 128 pixel
// rows) and 64 output channels,
//
//   out_o = sum over s of  src_s @ (+/- Blk[o][s])     o < NOUT, s < NSRC,
//
// every source an (N, H, W, C) tensor read at the same pixel (aligned
// streams, no mirror rows), Blk[o][s] one of the four (C, C) blocks in the
// compute type, each with its own sign. The Hilbert products among the
// sources come from the pass of hilbert_rows.cuh, rounded to the compute
// type first. An output may be written at the mirror pixel
// (n, (-h) mod H, (-w) mod W), so that a double reversal after the kernel
// is not a pass of its own. fp32 accumulation over K = NSRC * C, one rounding
// per output. The TPU kernels' R-row tiles (R*W <= 512) and their dense
// block-diagonal I_R (x) hm Hilbert matrix do not carry over: the Hilbert
// product is per image row here, so R is this card's choice.
//
//  * bfloat16: [src_0 | src_1 | ...] and the signed block tiles staged in
//    shared memory 32 input channels at a time, 16x16x16 WMMA fragments
//    (mma.sync), each warp up to 4 tiles of each output. Needs C % 8 == 0.
//  * float32: the same staging on the CUDA cores, 8 rows x 4 channels of
//    each output per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hilbert_rows.cuh"

namespace {

constexpr int kMixThreads = 256;
constexpr int kMixWarps = kMixThreads / 32;
constexpr int kMixNT = 64;                    // output channels per block
constexpr int kMixKC = 32;                    // input channels per chunk and source
constexpr int kMixMaxM = 128;                 // pixel rows per block
constexpr int kMixRows = kMixMaxM / 16;       // fp32: pixel rows per thread
constexpr int kMixLdB = kMixNT + 8;           // bf16 row stride of the block tiles
constexpr int kMixLdC = kMixNT + 4;           // fp32 row stride of the epilogue tiles
constexpr int kMixTasks = (kMixMaxM / 16) * (kMixNT / 16) / kMixWarps;  // 16x16 tiles per warp

template <typename T>
struct MixOperands {
  const T* src[4];       // the NSRC sources
  T* out[2];             // the NOUT outputs
  int blk[2][4];         // block (0..3) of output o and source s
  unsigned neg;          // bit 4*o + s: that block enters negated
  unsigned reverse_out;  // bit o: output o is written at the mirror pixel
};

// Image rows per block: as many as keep R*W <= kMixMaxM, balanced over the
// row groups so the last group is not nearly empty.
inline int mix_rows_per_block(int H, int W) {
  const int max_r = kMixMaxM / W < 1 ? 1 : kMixMaxM / W;
  const int groups = (H + max_r - 1) / max_r;
  return (H + groups - 1) / groups;
}

// Offset of output pixel (n, hh, wp), or of its mirror pixel.
__device__ __forceinline__ long long mix_out_offset(long long n, int hh, int wp, int H, int W,
                                                    int C, bool mirror) {
  if (mirror) {
    hh = (H - hh) % H;
    wp = (W - wp) % W;
  }
  return ((n * H + hh) * W + wp) * (long long)C;
}

template <int NSRC, int NOUT>
__global__ void __launch_bounds__(kMixThreads)
rowtiled_mix_wmma_kernel(MixOperands<__nv_bfloat16> ops, const __nv_bfloat16* __restrict__ blocks,
                         int H, int W, int C, int R, int Mp) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int kK = NSRC * kMixKC;  // K of one chunk
  constexpr int kLdA = kK + 8;
  extern __shared__ __align__(128) unsigned char msmem[];
  bf16* a_s = reinterpret_cast<bf16*>(msmem);  // Mp x kLdA
  bf16* b_s = a_s + Mp * kLdA;                 // NOUT x kK x kMixLdB
  float* c_s = reinterpret_cast<float*>(msmem);  // epilogue: NOUT x Mp x kMixLdC

  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * kMixNT;
  const int h0 = blockIdx.y * R;
  const long long n = blockIdx.z;
  const long long img = (long long)H * W * C;
  const int M = R * W;
  const int ntasks = (Mp / 16) * (kMixNT / 16);
  const long long cc = (long long)C * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NOUT][kMixTasks];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int q = 0; q < kMixTasks; ++q) wmma::fill_fragment(acc[o][q], 0.f);

  for (int k0 = 0; k0 < C; k0 += kMixKC) {
    // A: the chunk of every source at the block's rows, 8 channels (16 bytes) per load
    for (int i = threadIdx.x; i < Mp * (kMixKC / 8); i += kMixThreads) {
      const int row = i / (kMixKC / 8), k = (i % (kMixKC / 8)) * 8;
      const int hh = h0 + row / W, wp = row % W;
      const bool ok = row < M && hh < H && k0 + k < C;
      const long long off = n * img + ((long long)hh * W + wp) * C + k0 + k;
#pragma unroll
      for (int s = 0; s < NSRC; ++s) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ok) v = *reinterpret_cast<const uint4*>(ops.src[s] + off);
        *reinterpret_cast<uint4*>(a_s + row * kLdA + s * kMixKC + k) = v;
      }
    }
    // B: rows k0..k0+kMixKC, columns j0..j0+kMixNT of every signed block
    for (int i = threadIdx.x; i < kMixKC * (kMixNT / 8); i += kMixThreads) {
      const int k = i / (kMixNT / 8), col = (i % (kMixNT / 8)) * 8;
      const bool ok = k0 + k < C && j0 + col < C;
      const long long off = (long long)(k0 + k) * C + j0 + col;
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
#pragma unroll
        for (int s = 0; s < NSRC; ++s) {
          uint4 v = make_uint4(0, 0, 0, 0);
          if (ok) v = *reinterpret_cast<const uint4*>(blocks + ops.blk[o][s] * cc + off);
          if ((ops.neg >> (4 * o + s)) & 1u) {
            bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
            for (int u = 0; u < 8; ++u) e[u] = __hneg(e[u]);
          }
          *reinterpret_cast<uint4*>(b_s + (o * kK + s * kMixKC + k) * kMixLdB + col) = v;
        }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
#pragma unroll
      for (int q = 0; q < kMixTasks; ++q) {
        const int t = warp + kMixWarps * q;
        if (t < ntasks) {
          const int i = t / (kMixNT / 16), j = t % (kMixNT / 16);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, a_s + 16 * i * kLdA + kk, kLdA);
#pragma unroll
          for (int o = 0; o < NOUT; ++o) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, b_s + (o * kK + kk) * kMixLdB + 16 * j, kMixLdB);
            wmma::mma_sync(acc[o][q], fa, fb, acc[o][q]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kMixTasks; ++q) {
    const int t = warp + kMixWarps * q;
    if (t < ntasks) {
      const int i = t / (kMixNT / 16), j = t % (kMixNT / 16);
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        wmma::store_matrix_sync(c_s + (o * Mp + 16 * i) * kMixLdC + 16 * j, acc[o][q], kMixLdC,
                                wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NOUT * M * kMixNT; e += kMixThreads) {
    const int o = e / (M * kMixNT), rem = e % (M * kMixNT);
    const int row = rem / kMixNT, col = rem % kMixNT;
    const int hh = h0 + row / W, wp = row % W;
    if (hh >= H || j0 + col >= C) continue;
    const long long dst = mix_out_offset(n, hh, wp, H, W, C, (ops.reverse_out >> o) & 1u);
    ops.out[o][dst + j0 + col] = __float2bfloat16(c_s[(o * Mp + row) * kMixLdC + col]);
  }
}

template <int NSRC, int NOUT>
__global__ void __launch_bounds__(kMixThreads)
rowtiled_mix_fma_kernel(MixOperands<float> ops, const float* __restrict__ blocks, int H, int W,
                        int C, int R) {
  constexpr int kK = NSRC * kMixKC;
  constexpr int kLdA = kK + 1;
  extern __shared__ float fsmem[];
  float* w_s = fsmem;                    // NOUT x kK x kMixNT, first: float4-aligned
  float* a_s = w_s + NOUT * kK * kMixNT;  // M x kLdA

  const int tx = threadIdx.x % 16;  // 4 output channels each
  const int ty = threadIdx.x / 16;  // pixel rows ty, ty + 16, ...
  const int j0 = blockIdx.x * kMixNT;
  const int h0 = blockIdx.y * R;
  const long long n = blockIdx.z;
  const long long img = (long long)H * W * C;
  const int M = R * W;
  const long long cc = (long long)C * C;

  float acc[NOUT][kMixRows][4];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < kMixRows; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[o][i][q] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kMixKC) {
    for (int i = threadIdx.x; i < M * kMixKC; i += kMixThreads) {
      const int row = i / kMixKC, k = i % kMixKC;
      const int hh = h0 + row / W, wp = row % W;
      const bool ok = hh < H && k0 + k < C;
      const long long off = n * img + ((long long)hh * W + wp) * C + k0 + k;
#pragma unroll
      for (int s = 0; s < NSRC; ++s) a_s[row * kLdA + s * kMixKC + k] = ok ? ops.src[s][off] : 0.f;
    }
    for (int i = threadIdx.x; i < NOUT * kK * kMixNT; i += kMixThreads) {
      const int o = i / (kK * kMixNT), rem = i % (kK * kMixNT);
      const int s = rem / (kMixKC * kMixNT), rem2 = rem % (kMixKC * kMixNT);
      const int k = rem2 / kMixNT, col = rem2 % kMixNT;
      float v = 0.f;
      if (k0 + k < C && j0 + col < C)
        v = blocks[ops.blk[o][s] * cc + (long long)(k0 + k) * C + j0 + col];
      w_s[i] = ((ops.neg >> (4 * o + s)) & 1u) ? -v : v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      float4 wv[NOUT];
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        wv[o] = *reinterpret_cast<const float4*>(w_s + (o * kK + k) * kMixNT + 4 * tx);
#pragma unroll
      for (int i = 0; i < kMixRows; ++i) {
        const int row = ty + 16 * i;
        if (row < M) {
          const float a = a_s[row * kLdA + k];
#pragma unroll
          for (int o = 0; o < NOUT; ++o) {
            acc[o][i][0] = fmaf(a, wv[o].x, acc[o][i][0]);
            acc[o][i][1] = fmaf(a, wv[o].y, acc[o][i][1]);
            acc[o][i][2] = fmaf(a, wv[o].z, acc[o][i][2]);
            acc[o][i][3] = fmaf(a, wv[o].w, acc[o][i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMixRows; ++i) {
    const int row = ty + 16 * i;
    if (row >= M) continue;
    const int hh = h0 + row / W, wp = row % W;
    if (hh >= H) continue;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      float* dst = ops.out[o] + mix_out_offset(n, hh, wp, H, W, C, (ops.reverse_out >> o) & 1u);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = j0 + 4 * tx + q;
        if (col < C) dst[col] = acc[o][i][q];
      }
    }
  }
}

template <int NSRC, int NOUT>
int launch_mix(const MixOperands<__nv_bfloat16>& ops, const __nv_bfloat16* blocks, int N, int H,
               int W, int C, cudaStream_t s) {
  constexpr int kLdA = NSRC * kMixKC + 8;
  const int R = mix_rows_per_block(H, W);
  const int Mp = (R * W + 15) / 16 * 16;
  const size_t staging = sizeof(__nv_bfloat16) *
                         ((size_t)Mp * kLdA + (size_t)NOUT * NSRC * kMixKC * kMixLdB);
  const size_t epilogue = sizeof(float) * (size_t)NOUT * Mp * kMixLdC;
  const size_t smem = staging > epilogue ? staging : epilogue;
  static size_t configured = 0;
  cudaError_t e = allow_smem(rowtiled_mix_wmma_kernel<NSRC, NOUT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + kMixNT - 1) / kMixNT, (H + R - 1) / R, N);
  rowtiled_mix_wmma_kernel<NSRC, NOUT><<<grid, kMixThreads, smem, s>>>(ops, blocks, H, W, C, R, Mp);
  return (int)cudaGetLastError();
}

template <int NSRC, int NOUT>
int launch_mix(const MixOperands<float>& ops, const float* blocks, int N, int H, int W, int C,
               cudaStream_t s) {
  const int R = mix_rows_per_block(H, W);
  const size_t smem = sizeof(float) * ((size_t)NOUT * NSRC * kMixKC * kMixNT +
                                       (size_t)R * W * (NSRC * kMixKC + 1));
  static size_t configured = 0;
  cudaError_t e = allow_smem(rowtiled_mix_fma_kernel<NSRC, NOUT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + kMixNT - 1) / kMixNT, (H + R - 1) / R, N);
  rowtiled_mix_fma_kernel<NSRC, NOUT><<<grid, kMixThreads, smem, s>>>(ops, blocks, H, W, C, R);
  return (int)cudaGetLastError();
}

// Arguments every mix entry checks before a launch.
inline bool mix_args_ok(int n, int h, int w, int c, int bf16) {
  if (w < 1 || w > kMixMaxM || n < 1 || h < 1 || c < 1) return false;
  return !bf16 || c % 8 == 0;
}

}  // namespace
