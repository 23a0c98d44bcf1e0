// K2: SFConv frequency branch, forward.
//
// Replaces the Pallas kernel unidefense_tpu/ops/sfconv_pallas.py
// (_kernel_call, reached through sfconv_freq_pallas from SFConv). For every
// image row h with mirror row m = (-h) mod H:
//
//   out[n,h] = x_h@b0 + (hm@x_h)@b1 + Pw @ (x_m@b2 + (hm@x_m)@b3)
//
// hm is the (W, W) circular row-Hilbert matrix, Pw the width reversal
// (row w of the mirror term comes from row (-w) mod W), and b0..b3 the four
// (C, C) blocks, rows = input channels, every one added: the caller passes
// (A1, -A2, B1, B2) for the forward and (A1^T, A2^T, B1^T, B2^T) for x_bar
// (negation is exact in every dtype). Rounding follows the TPU kernel
// (sfconv_pallas.py:147-163): blocks and hm in the compute type, fp32
// accumulation, the Hilbert products and the mirror term rounded to the
// compute type before use.
//
// Bound on an H100: operations. Per image row the function needs 8*W*C^2 +
// 2*W^2*C flops (hm@x_m is hm@x at row m, so each Hilbert product is needed
// once) against 2*W*C elements read and written, e.g. 12x12/C1632 at batch 32
// is ~98 GFLOP for ~36 MB, far above the ~295 flop/byte ridge. The four C x C
// blocks cannot stay in shared memory (21 MB at C=1632 in bf16), so both
// paths tile output channels and stream the weights; what the tensor cores can
// be fed then depends on how often each staged byte is used.
//
// Two paths, chosen from the input. float32 runs the kernel below on the CUDA
// cores with fp32 FMA (the checks and the fp32 parity step):
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
// bfloat16, the serving and training case, needs C % 8 == 0 (true of every
// SFConv width in the repo) and runs two kernels: the Hilbert pass of
// hilbert_rows.cuh on the tensor cores, then the channel mix on wgmma in the
// mirror mode of wgmma_mix.cuh (its design note is there; K3 and K4 run the
// same mix in their own modes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "wgmma_mix.cuh"

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
    // stage the four weight tiles (b0, b1, b2, b3)[k0:k0+kKC, j0:j0+kNT]
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
          core[i][0] = fmaf(xh, a1.x, fmaf(hxh, a2.x, core[i][0]));
          core[i][1] = fmaf(xh, a1.y, fmaf(hxh, a2.y, core[i][1]));
          core[i][2] = fmaf(xh, a1.z, fmaf(hxh, a2.z, core[i][2]));
          core[i][3] = fmaf(xh, a1.w, fmaf(hxh, a2.w, core[i][3]));
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
  static SmemLimit configured;
  cudaError_t e = allow_smem(sfconv_freq_fwd_kernel, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((C + kNT - 1) / kNT, (H + R - 1) / R, N);
  sfconv_freq_fwd_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(blocks),
      static_cast<const float*>(hm), static_cast<float*>(out), H, W, C, R);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The four blocks from the packed (2C, 2C) fp32 kernel w (w[i][o] at
// i*s0 + o*s1, any strides: the model passes a transposed view of its
// weight), in one launch instead of a chain of tensor ops:
//
//   forward (transposed = 0):  A1, -A2, B1, B2          x_bar:  A1^T, A2^T, B1^T, B2^T
//
// with A1 = (Wrr+Wii)/2, A2 = (Wri-Wir)/2, B1 = (Wrr-Wii)/2, B2 = (Wri+Wir)/2
// (sfconv_pallas.py:124-133), each formed in fp32 and rounded once to T, and
// the fourth block negated when negate_last is set (K4's signs; negation is
// exact). A block of 256 threads moves one 32 x 32 tile of each quadrant
// through shared memory, reading along w's contiguous index and writing rows.

constexpr int kSplitTile = 32;

template <typename T>
__global__ void __launch_bounds__(256)
split_blocks_kernel(const float* __restrict__ w, long long s0, long long s1, T* __restrict__ blocks,
                    int C, int transposed, int negate_last) {
  __shared__ float q[4][kSplitTile][kSplitTile + 1];  // quadrants rr, ri, ir, ii at (i, o)
  const int i0 = blockIdx.y * kSplitTile, o0 = blockIdx.x * kSplitTile;
  const bool along_o = s1 <= s0;
  constexpr int kTileElems = kSplitTile * kSplitTile;
  for (int e = threadIdx.x; e < 4 * kTileElems; e += 256) {
    const int quad = e / kTileElems, rem = e % kTileElems;
    const int a = along_o ? rem / kSplitTile : rem % kSplitTile;
    const int b = along_o ? rem % kSplitTile : rem / kSplitTile;
    const int i = i0 + a, o = o0 + b;
    q[quad][a][b] = i < C && o < C ? w[(long long)(i + (quad >> 1) * C) * s0 +
                                       (long long)(o + (quad & 1) * C) * s1]
                                   : 0.f;
  }
  __syncthreads();
  const float last = negate_last ? -0.5f : 0.5f;
  for (int e = threadIdx.x; e < 4 * kTileElems; e += 256) {
    const int m = e / kTileElems, rem = e % kTileElems;
    const int dk = rem / kSplitTile, dj = rem % kSplitTile;  // j fastest: row writes
    const int a = transposed ? dj : dk, b = transposed ? dk : dj;
    const int k = (transposed ? o0 : i0) + dk, j = (transposed ? i0 : o0) + dj;
    if (k >= C || j >= C) continue;
    const float rr = q[0][a][b], ri = q[1][a][b], ir = q[2][a][b], ii = q[3][a][b];
    const float v = m == 0 ? rr + ii : m == 1 ? (transposed ? ri - ir : ir - ri)
                             : m == 2 ? rr - ii : ri + ir;
    blocks[((long long)m * C + k) * C + j] = from_f32<T>(v * (m == 3 ? last : 0.5f));
  }
}

// ---------------------------------------------------------------------------
// bf16 channel mix: wgmma_mix.cuh in its mirror mode, the second operand
// [x | hx] loaded at the mirror pixel.

template <int BN>
__global__ void __launch_bounds__(kMixThreads, 1) sfconv_mix_wgmma_kernel(WgmmaMix a) {
  wgmma_mix<BN, kMixMirror>(a);
}

// parts: 1 the Hilbert pass alone, 2 the mix alone (on the hx in scratch),
// 3 both (K2).
int launch_wgmma(const void* x, const void* blocks, const void* hm, void* out, void* hx, int N,
                 int H, int W, int C, int bn, int R, int parts, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  bf* hb = static_cast<bf*>(hx);
  if (parts & 1) {
    cudaError_t e = launch_hilbert_rows(xb, static_cast<const bf*>(hm), hb, N * H, W, C, s);
    if (e != cudaSuccess || !(parts & 2)) return (int)e;
  }
  const WgmmaMix a{{{xb, hb}, {xb, hb}}, static_cast<const bf*>(blocks),
                   {static_cast<bf*>(out), nullptr}, H, W, C, R, N * H};
  if (bn == 64) return launch_wgmma_mix<64, kMixMirror>(sfconv_mix_wgmma_kernel<64>, a, s);
  return launch_wgmma_mix<128, kMixMirror>(sfconv_mix_wgmma_kernel<128>, a, s);
}

}  // namespace

// x, out: (N, H, W, C); blocks: (4, C, C) = b0, b1, b2, b3 with rows = input
// channels, every block added (see the top of this file); hm: (W, W). All
// float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous, 16-byte aligned.
// scratch: an (N, H, W, C) bfloat16 buffer for the Hilbert products, required
// for bfloat16 and unused for float32. bn and rows set the bfloat16 mix's
// tiles (ops/sfconv_cuda.mix_geometry; limits in wgmma_mix_args_ok) and are
// unused for float32. parts (bfloat16 only; 3 for float32) is 3 for K2, or 1
// or 2 to run the Hilbert pass or the mix alone, for timing. Needs
// 1 <= W <= 128. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside these limits.
extern "C" int ud_sfconv_freq_fwd(const void* x, const void* blocks, const void* hm,
                                  void* out, void* scratch, int n, int h, int w, int c,
                                  int bf16, int bn, int rows, int parts, void* stream) {
  if (w < 1 || w > kMaxM || n < 1 || h < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (scratch == nullptr || !wgmma_mix_args_ok(n, h, w, c, bn, rows, parts))
      return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, blocks, hm, out, scratch, n, h, w, c, bn, rows, parts, s);
  }
  if (parts != 3) return (int)cudaErrorInvalidValue;
  return launch_fma(x, blocks, hm, out, n, h, w, c, s);
}

// The (4, C, C) blocks the SFConv kernels add (b0..b3 above, rows = input
// channels) from the packed (2C, 2C) float32 kernel w with element strides
// s0, s1: the forward's (A1, -A2, B1, B2), or with transposed = 1 x_bar's
// (A1^T, A2^T, B1^T, B2^T); with negate_last = 1 the fourth block negated
// (K4's). blocks: contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// these limits.
extern "C" int ud_sfconv_split_blocks(const void* w, void* blocks, int c, int s0, int s1,
                                      int transposed, int negate_last, int bf16, void* stream) {
  if (c < 1 || s0 < 1 || s1 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (c + kSplitTile - 1) / kSplitTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles, tiles);
  const float* wf = static_cast<const float*>(w);
  if (bf16)
    split_blocks_kernel<<<grid, 256, 0, s>>>(wf, s0, s1, static_cast<__nv_bfloat16*>(blocks), c,
                                             transposed, negate_last);
  else
    split_blocks_kernel<<<grid, 256, 0, s>>>(wf, s0, s1, static_cast<float*>(blocks), c,
                                             transposed, negate_last);
  return (int)cudaGetLastError();
}
