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
// forward on g with the blocks (A1^T, A2^T, B1^T, B2^T), every one added,
// launched by the wrapper through sfconv_freq_fwd.cu.
//
// Bound on an H100: operations. The sums need 8*P*C^2 flops plus 2*P*W*C for
// the Hilbert pass, against (2 inputs + hx) * P*C elements, e.g. 95x95/C192 at
// batch 20 is 53 GFLOP for ~0.2 GB. K is long (up to 180,500) and the output
// small (4C x C), so K is split across blocks with a fixed-order reduction:
// the split-K product of weight_sums.cuh, shared with K3-bwd and K4-bwd. Its
// bf16 path runs 128 x 128 tiles of two sections at once on wgmma from a
// 4-stage cp.async ring (sections 0-1 read x and hx, 2-3 the same at the
// mirror pixel, all against one staged g); its fp32 path runs on the CUDA
// cores. The Hilbert pass runs on the tensor cores for bf16
// (hilbert_rows.cuh).
//
// hx is formed by the Hilbert pass into a scratch tensor the wrapper
// allocates: one (N, H, W, C) tensor in the compute type per call, freed when
// the backward returns; the forward saves nothing extra.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "weight_sums.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* g, const void* hm, void* hx, void* workspace, void* out,
           int N, int H, int W, int C, int splits, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* hxt = static_cast<const T*>(hx);
  cudaError_t e = launch_hilbert_rows(xt, static_cast<const T*>(hm), static_cast<T*>(hx),
                                      N * H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  // A = [x | hx | R(x) | R(hx)], G = g in every section
  const SumOperands<T> ops{{xt, hxt, xt, hxt}, {gt, gt, gt, gt}, 0xCu, 0u};
  return launch_weight_sums(ops, workspace, out, N, H, W, C, splits, s);
}

}  // namespace

// x, g: (N, H, W, C) float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous,
// 16-byte aligned; hm: (W, W) in the same type; hx: an (N, H, W, C) scratch
// tensor in the same type. out: (4C, C) float32, the sums [x | hx | R(x) |
// R(hx)]^T g in four row blocks. The N*H image rows are split into `splits`
// ranges of whole rows (splits <= N*H); with splits > 1, workspace holds
// (splits, 4C, C) float32 partial sums. Needs 1 <= W <= 128, and C % 8 == 0
// for bfloat16. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside these limits.
extern "C" int ud_sfconv_freq_bwd_dw(const void* x, const void* g, const void* hm, void* hx,
                                     void* workspace, void* out, int n, int h, int w, int c,
                                     int splits, int bf16, void* stream) {
  if (!sums_args_ok(n, h, w, c, splits, workspace, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, g, hm, hx, workspace, out, n, h, w, c, splits, s);
  return launch<float>(x, g, hm, hx, workspace, out, n, h, w, c, splits, s);
}
