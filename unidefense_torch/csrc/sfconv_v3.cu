// K4 and K4-bwd: the SFConv frequency branch over a precomputed double
// reversal.
//
// Replaces the Pallas kernels unidefense_tpu/ops/sfconv_pallas.py
// _kernel_call_v3 (K4, reached through sfconv_freq_pallas_v3, whose only
// caller in the JAX package is the per-op A/B tool tools/bench_sfconv.py) and
// _bwd_kernel_call_v3 (K4-bwd, through _bwd_v3). With rx = R(x) materialised
// by the caller (rx[n, h, w] = x[n, (-h) mod H, (-w) mod W]),
//
//   out = x@A1 - (hm x)@A2 + rx@B1 - (hm rx)@B2,
//
// x and rx read as two aligned streams, the Hilbert products of both formed
// per image row and rounded to the compute type T (hilbert_rows.cuh), the
// four products accumulated in fp32 and rounded once (rowtiled_mix.cuh,
// K = 4C per output channel). The kernel adds every block it is given (the
// blocks come signed from ops/sfconv_cuda._split_blocks): (A1, -A2, B1, -B2)
// for the forward.
//
// Backward: x_bar is this same forward on (g, R(g)) with the blocks
// (A1^T, A2^T, B1^T, -B2^T), launched by the wrapper
// (ops/sfconv_rowtiled.py). ud_sfconv_v3_bwd_dw is the rest of K4-bwd, the
// four C x C fp32 sums over aligned streams (weight_sums.cuh):
//
//   a1b = sum x^T g    a2b = -sum (hx)^T g    b1b = sum rx^T g    b2b = -sum (h rx)^T g
//
// returned with the A2 and B2 blocks not negated.
//
// Bound on an H100: operations. Per image row the forward needs
// 8*W*C^2 + 4*W^2*C flops against reading x and rx and writing out, e.g.
// 48x48/C336 at batch 20 is 45 GFLOP for ~93 MB, above the ~295 flop/byte
// ridge. The blocks are streamed, so the tensor cores are fed only as fast as
// each staged byte is reused. The bf16 forward is three kernels: the Hilbert
// pass over x and over rx, then the mix on wgmma in the pair mode of
// wgmma_mix.cuh (rowtiled_mix.cuh): tiles of 128 pixel rows of the flattened
// (n, h) rows by 128 output channels (64 at C = 192), a 3-stage cp.async ring
// (4 at C = 192) of 64 KB stages (A tiles [x | hx] and [rx | hr], both at the
// core pixel, and the B tiles [b0; b1] and [b2; b3]), both products in one
// fp32 accumulator, rounded once in the epilogue from the fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "rowtiled_mix.cuh"
#include "weight_sums.cuh"

namespace {

template <typename T>
cudaError_t hilbert_both(const void* x, const void* rx, const void* hm, void* hx, void* hr,
                         int N, int H, int W, int C, cudaStream_t s) {
  const T* hmt = static_cast<const T*>(hm);
  cudaError_t e = launch_hilbert_rows(static_cast<const T*>(x), hmt, static_cast<T*>(hx),
                                      N * H, W, C, s);
  if (e != cudaSuccess) return e;
  return launch_hilbert_rows(static_cast<const T*>(rx), hmt, static_cast<T*>(hr), N * H, W, C, s);
}

// parts: 1 the Hilbert passes alone, 2 the mix alone (on the hx and hr
// given), 3 both (K4).
int forward_bf16(const void* x, const void* rx, const void* blocks, const void* hm, void* out,
                 void* hx, void* hr, int N, int H, int W, int C, int bn, int R, int parts,
                 cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (parts & 1) {
    cudaError_t e = hilbert_both<bf>(x, rx, hm, hx, hr, N, H, W, C, s);
    if (e != cudaSuccess || !(parts & 2)) return (int)e;
  }
  // out = [x | hx] @ [b0; b1] + [rx | hr] @ [b2; b3]
  const WgmmaMix a{{{static_cast<const bf*>(x), static_cast<const bf*>(hx)},
                    {static_cast<const bf*>(rx), static_cast<const bf*>(hr)}},
                   static_cast<const bf*>(blocks), {static_cast<bf*>(out), nullptr}, H, W, C, R,
                   N * H};
  return launch_rowtiled_wgmma<kMixPair>(a, bn, s);
}

int forward_fp32(const void* x, const void* rx, const void* blocks, const void* hm, void* out,
                 void* hx, void* hr, int N, int H, int W, int C, cudaStream_t s) {
  cudaError_t e = hilbert_both<float>(x, rx, hm, hx, hr, N, H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  // out = x@b0 + hx@b1 + rx@b2 + hr@b3
  const MixOperands<float> ops{{static_cast<const float*>(x), static_cast<const float*>(hx),
                                static_cast<const float*>(rx), static_cast<const float*>(hr)},
                               {static_cast<float*>(out), nullptr},
                               {{0, 1, 2, 3}, {0, 0, 0, 0}},
                               0u};
  return launch_fma_mix<4, 1>(ops, static_cast<const float*>(blocks), N, H, W, C, s);
}

template <typename T>
int sums(const void* x, const void* rx, const void* g, const void* hm, void* hx, void* hr,
         void* workspace, void* out, int N, int H, int W, int C, int splits, cudaStream_t s) {
  cudaError_t e = hilbert_both<T>(x, rx, hm, hx, hr, N, H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  const T* gt = static_cast<const T*>(g);
  // A = [x | hx | rx | hr], G = g in every section, no mirror reads
  const SumOperands<T> ops{{static_cast<const T*>(x), static_cast<const T*>(hx),
                            static_cast<const T*>(rx), static_cast<const T*>(hr)},
                           {gt, gt, gt, gt},
                           0u,
                           0u};
  return launch_weight_sums(ops, workspace, out, N, H, W, C, splits, s);
}

}  // namespace

// K4. x, rx: (N, H, W, C), rx = R(x); blocks: (4, C, C), rows = input
// channels, every one added: x's two, then rx's two; hm: (W, W); out:
// (N, H, W, C); hx, hr: two (N, H, W, C) scratch tensors. All float32
// (bf16 = 0) or bfloat16 (bf16 = 1), contiguous, 16-byte aligned. bn and rows
// set the bfloat16 mix's tiles (ops/sfconv_cuda.mix_geometry; limits in
// wgmma_mix_args_ok) and are unused for float32. parts (bfloat16 only; 3 for
// float32) is 3 for K4, or 1 or 2 to run the Hilbert passes or the mix alone,
// for timing. Needs 1 <= W <= 128. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int ud_sfconv_v3_fwd(const void* x, const void* rx, const void* blocks, const void* hm,
                                void* out, void* hx, void* hr, int n, int h, int w, int c,
                                int bf16, int bn, int rows, int parts, void* stream) {
  if (!mix_args_ok(n, h, w, c, bf16, bn, rows, parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return forward_bf16(x, rx, blocks, hm, out, hx, hr, n, h, w, c, bn, rows, parts, s);
  return forward_fp32(x, rx, blocks, hm, out, hx, hr, n, h, w, c, s);
}

// K4-bwd's sums. x, rx, g: (N, H, W, C) as for K4; hx, hr: scratch; out:
// (4C, C) float32, [x | hx | rx | hr]^T g in four row blocks; workspace:
// (splits, 4C, C) float32 when splits > 1. Limits as for K4.
extern "C" int ud_sfconv_v3_bwd_dw(const void* x, const void* rx, const void* g, const void* hm,
                                   void* hx, void* hr, void* workspace, void* out, int n, int h,
                                   int w, int c, int splits, int bf16, void* stream) {
  if (!sums_args_ok(n, h, w, c, splits, workspace, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return sums<__nv_bfloat16>(x, rx, g, hm, hx, hr, workspace, out, n, h, w, c, splits, s);
  return sums<float>(x, rx, g, hm, hx, hr, workspace, out, n, h, w, c, splits, s);
}
