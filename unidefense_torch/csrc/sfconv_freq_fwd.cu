// K2: SFConv frequency branch, forward.
//
// Replaces the Pallas kernel unidefense_tpu/ops/sfconv_pallas.py
// (_kernel_call, reached through sfconv_freq_pallas from SFConv). For every
// image row h with mirror row m = (-h) mod H:
//
//   out[n,h] = x_h@A1 - (hm@x_h)@A2 + Pw @ (x_m@B1 + (hm@x_m)@B2)
//
// hm is the (W, W) circular row-Hilbert matrix, Pw the width reversal
// (row w of the mirror term comes from row (-w) mod W), and A1, A2, B1, B2 the
// (C, C) blocks split from the packed 2C x 2C kernel. Rounding follows the TPU
// kernel: blocks and hm in the compute type, fp32 accumulation, the Hilbert
// products and the mirror term rounded to the compute type before use.
//
// Bound on an H100: operations. Per image row the function needs 8*W*C^2 +
// 2*W^2*C flops (hm@x_m is hm@x at row m, so each Hilbert product is needed
// once) against 2*W*C elements read and written, e.g. 12x12/C1632 at batch 32
// is ~98 GFLOP for ~36 MB, far above the ~295 flop/byte ridge. The TPU kernel
// held the four C x C blocks in VMEM; here they cannot fit in shared memory
// (21 MB at C=1632 in bf16), so both paths tile output channels and stream the
// weights.
//
// Two paths, chosen from the input. float32 runs the kernel below on the CUDA
// cores with fp32 FMA:
//
//  * one block per (n, group of R consecutive image rows, 64 output channels),
//    R = floor(128 / W) so every block works on up to 128 pixel rows;
//  * the loop runs over input channels in chunks of 32: it stages the chunk of
//    the R rows, of their R mirror rows, and the four 32x64 weight tiles in
//    shared memory, forms the Hilbert products of the chunk there
//    (hm @ x_chunk; hm itself stays in shared memory), and accumulates the core
//    and mirror sums in registers (each thread owns 8 rows x 4 channels of each);
//  * the epilogue passes the mirror sums through shared memory, applies Pw as
//    an index permutation and adds them to the core sums.
//
// bfloat16, the serving case, runs a Hilbert pass and a tensor-core (WMMA,
// mma.sync) channel mix further down and needs C % 8 == 0 (true of every
// SFConv width in the repo). wgmma and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hilbert_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 16;         // threads along output channels (4 channels each)
constexpr int kTy = 16;         // threads along pixel rows
constexpr int kNT = 4 * kTx;    // output channels per block
constexpr int kKC = 32;         // input channels per chunk
constexpr int kXS = kKC + 1;    // padded row stride of the staged chunks
constexpr int kMaxRows = 8;     // pixel rows per thread
constexpr int kMaxM = kTy * kMaxRows;  // pixel rows per block

__global__ void __launch_bounds__(kThreads)
sfconv_freq_fwd_kernel(const float* __restrict__ x, const float* __restrict__ blocks,
                       const float* __restrict__ hm, float* __restrict__ out, int H, int W,
                       int C, int R) {
  extern __shared__ float smem[];
  const int M = R * W;
  float* w_s = smem;                  // 4 * kKC * kNT, first: float4-aligned
  float* hm_s = w_s + 4 * kKC * kNT;  // W * W
  float* xh_s = hm_s + W * W;         // M * kXS each
  float* xm_s = xh_s + M * kXS;
  float* hxh_s = xm_s + M * kXS;
  float* hxm_s = hxh_s + M * kXS;
  float* mir_s = xh_s;                // epilogue: M * kNT, reuses the staging

  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int j0 = blockIdx.x * kNT;
  const int h0 = blockIdx.y * R;
  const long long n = blockIdx.z;
  const long long img = (long long)H * W * C;

  for (int i = tid; i < W * W; i += kThreads) hm_s[i] = hm[i];

  float core[kMaxRows][4];
  float mir[kMaxRows][4];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) core[i][q] = mir[i][q] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    // stage the chunk of the R rows and their mirror rows
    for (int i = tid; i < M * kKC; i += kThreads) {
      const int row = i / kKC, k = i % kKC;
      const int hh = h0 + row / W, wp = row % W;
      float vh = 0.f, vm = 0.f;
      if (hh < H && k0 + k < C) {
        const int mm = (H - hh) % H;
        vh = x[n * img + ((long long)hh * W + wp) * C + k0 + k];
        vm = x[n * img + ((long long)mm * W + wp) * C + k0 + k];
      }
      xh_s[row * kXS + k] = vh;
      xm_s[row * kXS + k] = vm;
    }
    // stage the four weight tiles (A1, A2, B1, B2)[k0:k0+kKC, j0:j0+kNT]
    for (int i = tid; i < 4 * kKC * kNT; i += kThreads) {
      const int mat = i / (kKC * kNT), rem = i % (kKC * kNT);
      const int k = rem / kNT, col = rem % kNT;
      float v = 0.f;
      if (k0 + k < C && j0 + col < C)
        v = blocks[(long long)mat * C * C + (long long)(k0 + k) * C + j0 + col];
      w_s[i] = v;
    }
    __syncthreads();
    // Hilbert products of the chunk
    for (int i = tid; i < M * kKC; i += kThreads) {
      const int row = i / kKC, k = i % kKC;
      const int base = (row / W) * W, wp = row % W;
      const float* hrow = hm_s + wp * W;
      float ah = 0.f, am = 0.f;
      for (int v = 0; v < W; ++v) {
        const float hv = hrow[v];
        ah = fmaf(hv, xh_s[(base + v) * kXS + k], ah);
        am = fmaf(hv, xm_s[(base + v) * kXS + k], am);
      }
      hxh_s[row * kXS + k] = ah;
      hxm_s[row * kXS + k] = am;
    }
    __syncthreads();
    // the four channel mixes
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      const float4 a1 = *reinterpret_cast<const float4*>(w_s + (0 * kKC + k) * kNT + 4 * tx);
      const float4 a2 = *reinterpret_cast<const float4*>(w_s + (1 * kKC + k) * kNT + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(w_s + (2 * kKC + k) * kNT + 4 * tx);
      const float4 b2 = *reinterpret_cast<const float4*>(w_s + (3 * kKC + k) * kNT + 4 * tx);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int row = ty + kTy * i;
        if (row < M) {
          const float xh = xh_s[row * kXS + k], hxh = hxh_s[row * kXS + k];
          const float xm = xm_s[row * kXS + k], hxm = hxm_s[row * kXS + k];
          core[i][0] = fmaf(xh, a1.x, fmaf(-hxh, a2.x, core[i][0]));
          core[i][1] = fmaf(xh, a1.y, fmaf(-hxh, a2.y, core[i][1]));
          core[i][2] = fmaf(xh, a1.z, fmaf(-hxh, a2.z, core[i][2]));
          core[i][3] = fmaf(xh, a1.w, fmaf(-hxh, a2.w, core[i][3]));
          mir[i][0] = fmaf(xm, b1.x, fmaf(hxm, b2.x, mir[i][0]));
          mir[i][1] = fmaf(xm, b1.y, fmaf(hxm, b2.y, mir[i][1]));
          mir[i][2] = fmaf(xm, b1.z, fmaf(hxm, b2.z, mir[i][2]));
          mir[i][3] = fmaf(xm, b1.w, fmaf(hxm, b2.w, mir[i][3]));
        }
      }
    }
    __syncthreads();
  }

  // epilogue: mirror sums through shared memory, then Pw
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int row = ty + kTy * i;
    if (row < M)
#pragma unroll
      for (int q = 0; q < 4; ++q) mir_s[row * kNT + 4 * tx + q] = mir[i][q];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int row = ty + kTy * i;
    if (row >= M) continue;
    const int r = row / W, wp = row % W, hh = h0 + r;
    if (hh >= H) continue;
    const int mrow = r * W + (W - wp) % W;
    float* dst = out + n * img + ((long long)hh * W + wp) * C;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = j0 + 4 * tx + q;
      if (col < C) dst[col] = core[i][q] + mir_s[mrow * kNT + 4 * tx + q];
    }
  }
}

// Image rows per block: as many as keep R*W <= kMaxM, balanced over the
// row groups so the last group is not nearly empty.
inline int rows_per_block(int H, int W) {
  const int max_r = kMaxM / W < 1 ? 1 : kMaxM / W;
  const int groups = (H + max_r - 1) / max_r;
  return (H + groups - 1) / groups;
}

int launch_fma(const void* x, const void* blocks, const void* hm, void* out, int N, int H,
               int W, int C, cudaStream_t s) {
  const int R = rows_per_block(H, W);
  const int M = R * W;
  const size_t smem = sizeof(float) * ((size_t)W * W + 4 * (size_t)M * kXS + 4 * kKC * kNT);
  static size_t configured = 0;
  cudaError_t e = allow_smem(sfconv_freq_fwd_kernel, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + kNT - 1) / kNT, (H + R - 1) / R, N);
  sfconv_freq_fwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(blocks),
      static_cast<const float*>(hm), static_cast<float*>(out), H, W, C, R);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path on the tensor cores (mma.sync through WMMA), for C % 8 == 0.
//
// Pass 1 (hilbert_rows_kernel, hilbert_rows.cuh): hx[n,h] = bf16(hm @ x[n,h])
// for every image row, fp32 accumulation, written to a scratch tensor. hm@x_m
// is then simply hx at the mirror row, so each Hilbert product is formed
// once, not once per output-channel tile.
// Pass 2 (sfconv_mix_wmma_kernel): per block of R image rows and 64 output
// channels, the two products
//   core = [x_h | hx_h] @ [A1; -A2]      mir = [x_m | hx_m] @ [B1; B2]
// with K = 2C streamed in chunks of 2 x 32 through shared memory, 16x16x16
// bf16 WMMA fragments and fp32 accumulators; the epilogue rounds mir to bf16,
// applies Pw and adds core.

using namespace nvcuda;

constexpr int kWarps = kThreads / 32;
constexpr int kKP = 2 * kKC;       // K of one chunk: [x | hx]
constexpr int kLdA = kKP + 8;      // bf16 row strides (multiples of 8 for WMMA)
constexpr int kLdB = kNT + 8;
constexpr int kLdC = kNT + 4;      // fp32 row stride of the epilogue tiles
constexpr int kMaxTasks = (kMaxM / 16) * (kNT / 16) / kWarps;  // 16x16 tiles per warp

__global__ void __launch_bounds__(kThreads)
sfconv_mix_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ hx,
                       const __nv_bfloat16* __restrict__ blocks,
                       __nv_bfloat16* __restrict__ out, int H, int W, int C, int R, int Mp) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  __nv_bfloat16* a_core = reinterpret_cast<__nv_bfloat16*>(wsmem);   // Mp x kLdA
  __nv_bfloat16* a_mir = a_core + Mp * kLdA;                         // Mp x kLdA
  __nv_bfloat16* b_core = a_mir + Mp * kLdA;                         // kKP x kLdB
  __nv_bfloat16* b_mir = b_core + kKP * kLdB;                        // kKP x kLdB
  float* c_core = reinterpret_cast<float*>(wsmem);                   // epilogue: Mp x kLdC
  float* c_mir = c_core + Mp * kLdC;

  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * kNT;
  const int h0 = blockIdx.y * R;
  const long long n = blockIdx.z;
  const long long img = (long long)H * W * C;
  const int M = R * W;
  const int ntasks = (Mp / 16) * (kNT / 16);
  const long long cc = (long long)C * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_c[kMaxTasks], acc_m[kMaxTasks];
#pragma unroll
  for (int q = 0; q < kMaxTasks; ++q) {
    wmma::fill_fragment(acc_c[q], 0.f);
    wmma::fill_fragment(acc_m[q], 0.f);
  }

  for (int k0 = 0; k0 < C; k0 += kKC) {
    // A operands, 8 channels (16 bytes) per load: [x | hx] of the rows and mirror rows
    for (int i = threadIdx.x; i < Mp * (kKC / 8); i += kThreads) {
      const int row = i / (kKC / 8), k = (i % (kKC / 8)) * 8;
      const int hh = h0 + row / W, wp = row % W;
      uint4 xh = make_uint4(0, 0, 0, 0), hh4 = xh, xm = xh, hm4 = xh;
      if (row < M && hh < H && k0 + k < C) {
        const int mm = (H - hh) % H;
        const long long oh = n * img + ((long long)hh * W + wp) * C + k0 + k;
        const long long om = n * img + ((long long)mm * W + wp) * C + k0 + k;
        xh = *reinterpret_cast<const uint4*>(x + oh);
        hh4 = *reinterpret_cast<const uint4*>(hx + oh);
        xm = *reinterpret_cast<const uint4*>(x + om);
        hm4 = *reinterpret_cast<const uint4*>(hx + om);
      }
      *reinterpret_cast<uint4*>(a_core + row * kLdA + k) = xh;
      *reinterpret_cast<uint4*>(a_core + row * kLdA + kKC + k) = hh4;
      *reinterpret_cast<uint4*>(a_mir + row * kLdA + k) = xm;
      *reinterpret_cast<uint4*>(a_mir + row * kLdA + kKC + k) = hm4;
    }
    // B operands: [A1; -A2] and [B1; B2] rows k0..k0+kKC, columns j0..j0+kNT
    for (int i = threadIdx.x; i < kKC * (kNT / 8); i += kThreads) {
      const int k = i / (kNT / 8), col = (i % (kNT / 8)) * 8;
      uint4 a1 = make_uint4(0, 0, 0, 0), a2 = a1, b1 = a1, b2 = a1;
      if (k0 + k < C && j0 + col < C) {
        const long long o = (long long)(k0 + k) * C + j0 + col;
        a1 = *reinterpret_cast<const uint4*>(blocks + o);
        a2 = *reinterpret_cast<const uint4*>(blocks + cc + o);
        b1 = *reinterpret_cast<const uint4*>(blocks + 2 * cc + o);
        b2 = *reinterpret_cast<const uint4*>(blocks + 3 * cc + o);
      }
      __nv_bfloat16* neg = reinterpret_cast<__nv_bfloat16*>(&a2);
#pragma unroll
      for (int e = 0; e < 8; ++e) neg[e] = __hneg(neg[e]);
      *reinterpret_cast<uint4*>(b_core + k * kLdB + col) = a1;
      *reinterpret_cast<uint4*>(b_core + (kKC + k) * kLdB + col) = a2;
      *reinterpret_cast<uint4*>(b_mir + k * kLdB + col) = b1;
      *reinterpret_cast<uint4*>(b_mir + (kKC + k) * kLdB + col) = b2;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKP; kk += 16) {
#pragma unroll
      for (int q = 0; q < kMaxTasks; ++q) {
        const int t = warp + kWarps * q;
        if (t < ntasks) {
          const int i = t / (kNT / 16), j = t % (kNT / 16);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, a_core + 16 * i * kLdA + kk, kLdA);
          wmma::load_matrix_sync(fb, b_core + kk * kLdB + 16 * j, kLdB);
          wmma::mma_sync(acc_c[q], fa, fb, acc_c[q]);
          wmma::load_matrix_sync(fa, a_mir + 16 * i * kLdA + kk, kLdA);
          wmma::load_matrix_sync(fb, b_mir + kk * kLdB + 16 * j, kLdB);
          wmma::mma_sync(acc_m[q], fa, fb, acc_m[q]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kMaxTasks; ++q) {
    const int t = warp + kWarps * q;
    if (t < ntasks) {
      const int i = t / (kNT / 16), j = t % (kNT / 16);
      wmma::store_matrix_sync(c_core + 16 * i * kLdC + 16 * j, acc_c[q], kLdC, wmma::mem_row_major);
      wmma::store_matrix_sync(c_mir + 16 * i * kLdC + 16 * j, acc_m[q], kLdC, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M * kNT; i += kThreads) {
    const int row = i / kNT, col = i % kNT;
    const int r = row / W, wp = row % W, hh = h0 + r;
    if (hh >= H || j0 + col >= C) continue;
    const int mrow = r * W + (W - wp) % W;
    const float mir = __bfloat162float(__float2bfloat16(c_mir[mrow * kLdC + col]));
    out[n * img + ((long long)hh * W + wp) * C + j0 + col] =
        __float2bfloat16(c_core[row * kLdC + col] + mir);
  }
}

int launch_wmma(const void* x, const void* blocks, const void* hm, void* out, void* hx,
                int N, int H, int W, int C, cudaStream_t s) {
  using bf = __nv_bfloat16;
  static size_t mix_configured = 0;
  cudaError_t e = launch_hilbert_rows(static_cast<const bf*>(x), static_cast<const bf*>(hm),
                                      static_cast<bf*>(hx), N * H, W, C, s);
  if (e != cudaSuccess) return (int)e;

  const int R = rows_per_block(H, W);
  const int Mp = (R * W + 15) / 16 * 16;
  const size_t staging = sizeof(bf) * (2 * (size_t)Mp * kLdA + 2 * (size_t)kKP * kLdB);
  const size_t epilogue = sizeof(float) * 2 * (size_t)Mp * kLdC;
  const size_t msmem = staging > epilogue ? staging : epilogue;
  e = allow_smem(sfconv_mix_wmma_kernel, msmem, &mix_configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + kNT - 1) / kNT, (H + R - 1) / R, N);
  sfconv_mix_wmma_kernel<<<grid, kThreads, msmem, s>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(hx), static_cast<const bf*>(blocks),
      static_cast<bf*>(out), H, W, C, R, Mp);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (N, H, W, C); blocks: (4, C, C) = A1, A2, B1, B2 with rows = input
// channels; hm: (W, W). All float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// contiguous. scratch: an (N, H, W, C) bfloat16 buffer for the Hilbert
// products, required for bfloat16 and unused for float32. Needs
// 1 <= W <= 128, and C % 8 == 0 for bfloat16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int ud_sfconv_freq_fwd(const void* x, const void* blocks, const void* hm,
                                  void* out, void* scratch, int n, int h, int w, int c,
                                  int bf16, void* stream) {
  if (w < 1 || w > kMaxM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (c % 8 != 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    return launch_wmma(x, blocks, hm, out, scratch, n, h, w, c, s);
  }
  return launch_fma(x, blocks, hm, out, n, h, w, c, s);
}
