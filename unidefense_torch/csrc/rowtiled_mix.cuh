// The row-tiled channel mix shared by K3 (sfconv_v4.cu) and K4
// (sfconv_v3.cu): for R consecutive image rows (up to 128 pixel rows) and a
// tile of output channels,
//
//   out_o = sum over s of  src_s @ Blk[o][s]     o < NOUT, s < NSRC,
//
// every source an (N, H, W, C) tensor read at the same pixel (aligned
// streams, no mirror rows), Blk[o][s] one of the four (C, C) blocks in the
// compute type, every block added (the callers pass signed blocks,
// ops/sfconv_cuda._split_blocks). The Hilbert products among the sources
// come from the pass of hilbert_rows.cuh, rounded to the compute type first.
// An output may be written at the mirror pixel (n, (-h) mod H, (-w) mod W),
// so that a double reversal after the kernel is not a pass of its own. fp32
// accumulation over K = NSRC * C, one rounding per output. The TPU kernels'
// R-row tiles (R*W <= 512) and their dense block-diagonal I_R (x) hm Hilbert
// matrix do not carry over: the Hilbert product is per image row here, so R
// is this card's choice.
//
// Bound on an H100: operations (8*W*C^2 flops per image row against reading
// two or four bf16 streams and writing one or two; see sfconv_v4.cu and
// sfconv_v3.cu). The blocks do not fit in shared memory at these widths, so
// each tile streams them, and the tensor cores are fed only as fast as staged
// bytes are reused.
//
//  * bfloat16: wgmma_mix.cuh, the same mix as K2's, in K3's split mode
//    (rowtiled_mix_split_kernel: one A tile [x | hx] a stage and two B tiles
//    [b0; b1], [b2; b3], two accumulators, o2 stored at the mirror pixel; 48
//    KB a stage at 128 output channels, 4 stages) and K4's pair mode
//    (rowtiled_mix_pair_kernel: A tiles [x | hx] and [rx | hr], both at the
//    core pixel, the same two B tiles, one accumulator; 64 KB a stage, 3
//    stages). A producer warpgroup fills the ring with 16-byte cp.async
//    copies, two consumer warpgroups of 64 pixel rows run wgmma, tiles are
//    128 pixel rows of the flattened (n, h) rows by 128 (C = 192: 64) output
//    channels, and the epilogue stores bf16x2 straight from the fragments.
//    The launch geometry comes from ops/sfconv_cuda.mix_geometry. Needs
//    C % 8 == 0.
//  * float32 (the checks and the fp32 parity step): rowtiled_mix_fma_kernel
//    on the CUDA cores, 32-channel chunks of every source and block tile
//    staged in shared memory, 8 rows x 4 channels of each output per thread,
//    64 output channels and one image's rows per block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "wgmma_mix.cuh"

namespace {

constexpr int kFmaThreads = 256;
constexpr int kFmaNT = 64;                  // output channels per block
constexpr int kFmaKC = 32;                  // input channels per chunk and source
constexpr int kFmaMaxM = 128;               // pixel rows per block
constexpr int kFmaRows = kFmaMaxM / 16;     // pixel rows per thread

template <typename T>
struct MixOperands {
  const T* src[4];       // the NSRC sources
  T* out[2];             // the NOUT outputs
  int blk[2][4];         // block (0..3) of output o and source s
  unsigned reverse_out;  // bit o: output o is written at the mirror pixel
};

// Image rows per block: as many as keep R*W <= kFmaMaxM, balanced over the
// row groups so the last group is not nearly empty.
inline int fma_rows_per_block(int H, int W) {
  const int max_r = kFmaMaxM / W < 1 ? 1 : kFmaMaxM / W;
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
__global__ void __launch_bounds__(kFmaThreads)
rowtiled_mix_fma_kernel(MixOperands<float> ops, const float* __restrict__ blocks, int H, int W,
                        int C, int R) {
  constexpr int kK = NSRC * kFmaKC;
  constexpr int kLdA = kK + 1;
  extern __shared__ float fsmem[];
  float* w_s = fsmem;                    // NOUT x kK x kFmaNT, first: float4-aligned
  float* a_s = w_s + NOUT * kK * kFmaNT;  // M x kLdA

  const int tx = threadIdx.x % 16;  // 4 output channels each
  const int ty = threadIdx.x / 16;  // pixel rows ty, ty + 16, ...
  const int j0 = blockIdx.x * kFmaNT;
  const int h0 = blockIdx.y * R;
  const long long n = blockIdx.z;
  const long long img = (long long)H * W * C;
  const int M = R * W;
  const long long cc = (long long)C * C;

  float acc[NOUT][kFmaRows][4];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int i = 0; i < kFmaRows; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[o][i][q] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kFmaKC) {
    for (int i = threadIdx.x; i < M * kFmaKC; i += kFmaThreads) {
      const int row = i / kFmaKC, k = i % kFmaKC;
      const int hh = h0 + row / W, wp = row % W;
      const bool ok = hh < H && k0 + k < C;
      const long long off = n * img + ((long long)hh * W + wp) * C + k0 + k;
#pragma unroll
      for (int s = 0; s < NSRC; ++s) a_s[row * kLdA + s * kFmaKC + k] = ok ? ops.src[s][off] : 0.f;
    }
    for (int i = threadIdx.x; i < NOUT * kK * kFmaNT; i += kFmaThreads) {
      const int o = i / (kK * kFmaNT), rem = i % (kK * kFmaNT);
      const int s = rem / (kFmaKC * kFmaNT), rem2 = rem % (kFmaKC * kFmaNT);
      const int k = rem2 / kFmaNT, col = rem2 % kFmaNT;
      float v = 0.f;
      if (k0 + k < C && j0 + col < C)
        v = blocks[ops.blk[o][s] * cc + (long long)(k0 + k) * C + j0 + col];
      w_s[i] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      float4 wv[NOUT];
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
        wv[o] = *reinterpret_cast<const float4*>(w_s + (o * kK + k) * kFmaNT + 4 * tx);
#pragma unroll
      for (int i = 0; i < kFmaRows; ++i) {
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
  for (int i = 0; i < kFmaRows; ++i) {
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
int launch_fma_mix(const MixOperands<float>& ops, const float* blocks, int N, int H, int W, int C,
                   cudaStream_t s) {
  const int R = fma_rows_per_block(H, W);
  const size_t smem = sizeof(float) * ((size_t)NOUT * NSRC * kFmaKC * kFmaNT +
                                       (size_t)R * W * (NSRC * kFmaKC + 1));
  static SmemLimit configured;
  cudaError_t e = allow_smem(rowtiled_mix_fma_kernel<NSRC, NOUT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + kFmaNT - 1) / kFmaNT, (H + R - 1) / R, N);
  rowtiled_mix_fma_kernel<NSRC, NOUT><<<grid, kFmaThreads, smem, s>>>(ops, blocks, H, W, C, R);
  return (int)cudaGetLastError();
}

// K3's bf16 mix: o1 = [x | hx] @ [b0; b1] at the core pixel, o2 = [x | hx] @
// [b2; b3] at the mirror pixel.
template <int BN>
__global__ void __launch_bounds__(kMixThreads, 1) rowtiled_mix_split_kernel(WgmmaMix a) {
  wgmma_mix<BN, kMixSplit>(a);
}

// K4's bf16 mix: out = [x | hx] @ [b0; b1] + [rx | hr] @ [b2; b3], one sum.
template <int BN>
__global__ void __launch_bounds__(kMixThreads, 1) rowtiled_mix_pair_kernel(WgmmaMix a) {
  wgmma_mix<BN, kMixPair>(a);
}

template <int MODE>
int launch_rowtiled_wgmma(const WgmmaMix& a, int bn, cudaStream_t s) {
  if constexpr (MODE == kMixSplit) {
    if (bn == 64) return launch_wgmma_mix<64, kMixSplit>(rowtiled_mix_split_kernel<64>, a, s);
    return launch_wgmma_mix<128, kMixSplit>(rowtiled_mix_split_kernel<128>, a, s);
  } else {
    if (bn == 64) return launch_wgmma_mix<64, kMixPair>(rowtiled_mix_pair_kernel<64>, a, s);
    return launch_wgmma_mix<128, kMixPair>(rowtiled_mix_pair_kernel<128>, a, s);
  }
}

// Arguments every mix entry checks before a launch: the shape for both
// dtypes, then wgmma_mix_args_ok's limits for bfloat16 and parts == 3 (the
// Hilbert pass and the mix together) for float32.
inline bool mix_args_ok(int n, int h, int w, int c, int bf16, int bn, int rows, int parts) {
  if (w < 1 || w > kFmaMaxM || n < 1 || h < 1 || c < 1) return false;
  return bf16 ? wgmma_mix_args_ok(n, h, w, c, bn, rows, parts) : parts == 3;
}

}  // namespace
