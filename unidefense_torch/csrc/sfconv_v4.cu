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
// The kernel adds every block it is given (the blocks come signed from
// ops/sfconv_cuda._split_blocks): (A1, -A2, B1, B2) for the forward.
// Backward: x_bar = x1 + R(x2) with x1 = g@A1^T + H(g)@A2^T and
// x2 = g@B1^T + H(g)@B2^T is this same forward on g with the blocks
// (A1^T, A2^T, B1^T, B2^T), launched by the wrapper (ops/sfconv_rowtiled.py).
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
// ridge. The blocks do not fit in shared memory at these widths (C up to
// 960), so the mix streams them through a ring and the tensor cores are fed
// only as fast as each staged byte is reused. The bf16 forward is two
// kernels: the Hilbert pass (hilbert_rows.cuh, once per row, never the TPU's
// dense I_R (x) hm), then the mix on wgmma in the split mode of
// wgmma_mix.cuh (rowtiled_mix.cuh): tiles of 128 pixel rows of the flattened
// (n, h) rows by 128 output channels (64 at C = 192), a 4-stage cp.async ring
// of 48 KB stages (one A tile [x | hx], 32 channels of each side by side, and
// the two B tiles [b0; b1] and [b2; b3]), two accumulators (o1, o2), o2
// stored from the fragments at the mirror pixel. Both products share the one
// A tile, so a stage carries 48 KB for two products where K2's carries 64 KB
// (its mirror A tile as well).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "rowtiled_mix.cuh"
#include "weight_sums.cuh"

namespace {

int forward_bf16(const void* x, const void* blocks, const void* hm, void* o1, void* o2r,
                 void* hx, int N, int H, int W, int C, int bn, int R, int parts, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const bf* xb = static_cast<const bf*>(x);
  bf* hb = static_cast<bf*>(hx);
  if (parts & 1) {
    cudaError_t e = launch_hilbert_rows(xb, static_cast<const bf*>(hm), hb, N * H, W, C, s);
    if (e != cudaSuccess || !(parts & 2)) return (int)e;
  }
  // o1 = [x | hx] @ [b0; b1], o2 = [x | hx] @ [b2; b3] written reversed
  const WgmmaMix a{{{xb, hb}, {xb, hb}}, static_cast<const bf*>(blocks),
                   {static_cast<bf*>(o1), static_cast<bf*>(o2r)}, H, W, C, R, N * H};
  return launch_rowtiled_wgmma<kMixSplit>(a, bn, s);
}

int forward_fp32(const void* x, const void* blocks, const void* hm, void* o1, void* o2r,
                 void* hx, int N, int H, int W, int C, cudaStream_t s) {
  const float* xt = static_cast<const float*>(x);
  cudaError_t e = launch_hilbert_rows(xt, static_cast<const float*>(hm), static_cast<float*>(hx),
                                      N * H, W, C, s);
  if (e != cudaSuccess) return (int)e;
  // o1 = x@b0 + hx@b1, o2 = x@b2 + hx@b3, o2 written reversed
  const MixOperands<float> ops{{xt, static_cast<const float*>(hx), nullptr, nullptr},
                               {static_cast<float*>(o1), static_cast<float*>(o2r)},
                               {{0, 1, 0, 0}, {2, 3, 0, 0}},
                               0x2u};
  return launch_fma_mix<2, 2>(ops, static_cast<const float*>(blocks), N, H, W, C, s);
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
// o2 (last two), rows = input channels, every one added; hm: (W, W); o1, o2r:
// (N, H, W, C) outputs, o2r receiving R(o2); hx: an (N, H, W, C) scratch
// tensor. All float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous, 16-byte
// aligned. bn and rows set the bfloat16 mix's tiles
// (ops/sfconv_cuda.mix_geometry; limits in wgmma_mix_args_ok) and are unused
// for float32. parts (bfloat16 only; 3 for float32) is 3 for K3, or 1 or 2 to
// run the Hilbert pass or the mix (on the hx given) alone, for timing. Needs
// 1 <= W <= 128. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments outside these limits.
extern "C" int ud_sfconv_v4_fwd(const void* x, const void* blocks, const void* hm, void* o1,
                                void* o2r, void* hx, int n, int h, int w, int c, int bf16, int bn,
                                int rows, int parts, void* stream) {
  if (!mix_args_ok(n, h, w, c, bf16, bn, rows, parts)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return forward_bf16(x, blocks, hm, o1, o2r, hx, n, h, w, c, bn, rows, parts, s);
  return forward_fp32(x, blocks, hm, o1, o2r, hx, n, h, w, c, s);
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
