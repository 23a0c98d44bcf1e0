// K3 and K3-bwd: the SFConv frequency branch in split-output form.
//
// Replaces the Pallas kernels unidefense_tpu/ops/sfconv_pallas.py
// _kernel_call_v4 (K3, reached through sfconv_freq_pallas_v4 and the
// UD_SFCONV_V4 gate of the model's SFConv) and _bwd_kernel_call_v4 (K3-bwd,
// through _bwd_v4). R commutes with the channel mixes and R o H = -H o R, so
//
//   out = [x@A1 - H(x)@A2] + R(x@B1 + H(x)@B2) = o1 + R(o2):
//
// the kernel reads x once, in aligned rows with no mirror rows, and writes
// o1 and o2. It writes o2 at the mirror pixel, so R(o2) is what lands in
// memory and the caller's o1 + R(o2) is one elementwise add. Rounding follows
// the TPU kernel: hx = round_T(hm @ x) per image row (hilbert_rows.cuh), o1
// and o2 each rounded to T, the add in T by the caller.
//
// Backward: x_bar = x1 + R(x2) with x1 = g@A1^T + H(g)@A2^T and
// x2 = g@B1^T + H(g)@B2^T is this same forward on g with the blocks
// (A1^T, -A2^T, B1^T, B2^T), launched by the wrapper (ops/sfconv_rowtiled.py).
// ud_sfconv_v4_bwd_dw is the rest of K3-bwd, the four C x C fp32 sums
//
//   a1b = sum x^T g    a2b = -sum (hx)^T g    b1b = sum x^T rg    b2b = sum (hx)^T rg
//
// with rg = R(g) read through the mirror-pixel index map (weight_sums.cuh),
// not a copy; the A2 block comes back not negated.
//
// Bound on an H100: operations. Per image row the forward needs
// 8*W*C^2 + 2*W^2*C flops against reading x and writing o1 and o2, e.g.
// 24x24/C960 at batch 32 is 137 GFLOP for ~106 MB, above the ~295 flop/byte
// ridge. The blocks do not fit in shared memory at these widths (C up to 960),
// so the mix tiles 64 output channels and streams 32-channel weight chunks
// (rowtiled_mix.cuh); the Hilbert product is formed once per row, never as
// the TPU's dense I_R (x) hm. wgmma, TMA and pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "rowtiled_mix.cuh"
#include "weight_sums.cuh"

namespace {

template <typename T>
int forward(const void* x, const void* blocks, const void* hm, void* o1, void* o2r, void* hx,
            int N, int H, int W, int C, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  cudaError_t e = launch_hilbert_rows(xt, static_cast<const T*>(hm), static_cast<T*>(hx),
                                      N * H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  // o1 = x@A1 - hx@A2, o2 = x@B1 + hx@B2, o2 written reversed
  const MixOperands<T> ops{{xt, static_cast<const T*>(hx), nullptr, nullptr},
                           {static_cast<T*>(o1), static_cast<T*>(o2r)},
                           {{0, 1, 0, 0}, {2, 3, 0, 0}},
                           0x2u,
                           0x2u};
  return launch_mix<2, 2>(ops, static_cast<const T*>(blocks), N, H, W, C, s);
}

template <typename T>
int sums(const void* x, const void* g, const void* hm, void* hx, void* workspace, void* out,
         int N, int H, int W, int C, int splits, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* hxt = static_cast<const T*>(hx);
  cudaError_t e = launch_hilbert_rows(xt, static_cast<const T*>(hm), static_cast<T*>(hx),
                                      N * H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  // A = [x | hx | x | hx], G = [g | g | R(g) | R(g)]
  const SumOperands<T> ops{{xt, hxt, xt, hxt}, {gt, gt, gt, gt}, 0u, 0xCu};
  return launch_weight_sums(ops, workspace, out, N, H, W, C, splits, s);
}

}  // namespace

// K3. x: (N, H, W, C); blocks: (4, C, C) = the blocks of o1 (first two) and
// o2 (last two), rows = input channels; hm: (W, W); o1, o2r: (N, H, W, C)
// outputs, o2r receiving R(o2); hx: an (N, H, W, C) scratch tensor. All
// float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous, 16-byte aligned.
// Needs 1 <= W <= 128, and C % 8 == 0 for bfloat16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these
// limits.
extern "C" int ud_sfconv_v4_fwd(const void* x, const void* blocks, const void* hm, void* o1,
                                void* o2r, void* hx, int n, int h, int w, int c, int bf16,
                                void* stream) {
  if (!mix_args_ok(n, h, w, c, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return forward<__nv_bfloat16>(x, blocks, hm, o1, o2r, hx, n, h, w, c, s);
  return forward<float>(x, blocks, hm, o1, o2r, hx, n, h, w, c, s);
}

// K3-bwd's sums. x, g: (N, H, W, C) as for K3; hx: scratch; out: (4C, C)
// float32, [x | hx | x | hx]^T [g | g | R(g) | R(g)] in four row blocks;
// workspace: (splits, 4C, C) float32 when splits > 1. Limits as for K3.
extern "C" int ud_sfconv_v4_bwd_dw(const void* x, const void* g, const void* hm, void* hx,
                                   void* workspace, void* out, int n, int h, int w, int c,
                                   int splits, int bf16, void* stream) {
  if (!sums_args_ok(n, h, w, c, splits, workspace, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return sums<__nv_bfloat16>(x, g, hm, hx, workspace, out, n, h, w, c, splits, s);
  return sums<float>(x, g, hm, hx, workspace, out, n, h, w, c, splits, s);
}
