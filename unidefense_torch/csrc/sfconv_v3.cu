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
// K = 4C per output channel).
//
// Backward: x_bar is this same forward on (g, R(g)) with the blocks
// (A1^T, -A2^T, B1^T, B2^T), launched by the wrapper
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
// ridge. The mix tiles 64 output channels and streams 32-channel chunks of
// the four blocks; wgmma, TMA and pipelining are later work.

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

template <typename T>
int forward(const void* x, const void* rx, const void* blocks, const void* hm, void* out,
            void* hx, void* hr, int N, int H, int W, int C, cudaStream_t s) {
  cudaError_t e = hilbert_both<T>(x, rx, hm, hx, hr, N, H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  // out = x@A1 - hx@A2 + rx@B1 - hr@B2
  const MixOperands<T> ops{{static_cast<const T*>(x), static_cast<const T*>(hx),
                            static_cast<const T*>(rx), static_cast<const T*>(hr)},
                           {static_cast<T*>(out), nullptr},
                           {{0, 1, 2, 3}, {0, 0, 0, 0}},
                           0xAu,
                           0u};
  return launch_mix<4, 1>(ops, static_cast<const T*>(blocks), N, H, W, C, s);
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

// K4. x, rx: (N, H, W, C), rx = R(x); blocks: (4, C, C) = A1, A2, B1, B2,
// rows = input channels; hm: (W, W); out: (N, H, W, C); hx, hr: two
// (N, H, W, C) scratch tensors. All float32 (bf16 = 0) or bfloat16
// (bf16 = 1), contiguous, 16-byte aligned. Needs 1 <= W <= 128, and
// C % 8 == 0 for bfloat16. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int ud_sfconv_v3_fwd(const void* x, const void* rx, const void* blocks, const void* hm,
                                void* out, void* hx, void* hr, int n, int h, int w, int c,
                                int bf16, void* stream) {
  if (!mix_args_ok(n, h, w, c, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return forward<__nv_bfloat16>(x, rx, blocks, hm, out, hx, hr, n, h, w, c, s);
  return forward<float>(x, rx, blocks, hm, out, hx, hr, n, h, w, c, s);
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
