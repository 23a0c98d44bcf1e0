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
// blocks: each block sums one range of whole image rows into a workspace
// slice, and reduce_splits_kernel adds the slices in a fixed order. No float
// atomics, so runs repeat bit for bit.
//
// Bound on an H100: operations (8*P*C^2 flops against 3*P*C elements read
// and 4*C^2 fp32 written; 95x95/C192 at batch 20: 53 GFLOP for ~0.2 GB).
//
//  * bfloat16 (dw_wgmma_kernel, below): 128 x 128 output tiles of two
//    sections at once on wgmma, fed by a 4-stage cp.async ring. Needs
//    C % 8 == 0 (16-byte copies).
//  * float32 (dw_fma_kernel): 64 x 64 tiles of one section on the CUDA
//    cores, 4 x 4 outputs per thread, staged synchronously.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "hopper_async.cuh"

namespace {

constexpr int kSumThreads = 256;
constexpr int kSumTile = 64;             // fp32: output rows (A channels) and columns (G channels) per block
constexpr int kSumKR = 32;               // fp32: pixel rows per chunk
constexpr int kSumLdF = kSumTile + 4;    // fp32 row stride in shared memory

template <typename T>
struct SumOperands {
  const T* a[4];
  const T* g[4];
  unsigned mirror_a;  // bit sec: read a[sec] at the mirror pixel
  unsigned mirror_g;  // bit sec: read g[sec] at the mirror pixel
};

// Offset of pixel p's channel vector in an (N, H, W, C) tensor, read directly
// or at the mirror pixel (fp32 path) (n, (-h) mod H, (-w) mod W).
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

// ---------------------------------------------------------------------------
// bfloat16 sums on wgmma.
//
// What bounded the WMMA kernel this replaces: a 64 x 64 output tile (A read
// once per 64 output columns, g once per 64 rows of each section), one
// 32-pixel chunk staged synchronously with two block barriers, a transposed
// (col-major) WMMA A fragment, and a 64-bit division per 16-byte load of a
// mirrored section. Here:
//
//  * one block per (128 G channels, section pair q and 128 A channels, split
//    of image rows): sections 2q and 2q+1 share their G operand in every
//    caller (K2-bwd: g, g; K3-bwd: g, g and R(g), R(g); K4-bwd: g, g), so a
//    staged g chunk feeds both, and each consumer thread holds both
//    accumulators (2 x 64 fp32 registers);
//  * 384 threads: two consumer warpgroups (64 A channels each, setmaxnreg
//    232) and a producer warpgroup (setmaxnreg 40) that fills a ring of
//    kSumStages stages of 64 pixel rows (two A tiles and the G tile, each 64
//    rows x 128 channels in two 128-byte swizzled panels: 48 KB a stage) with
//    16-byte cp.async copies arriving on an mbarrier per stage;
//  * both operands are MN-major (pixels are K and the channels contiguous),
//    which wgmma takes for 16-bit types through its transpose bits: no
//    transposed copy;
//  * a producer thread follows one pixel row (n, h, w) and walks it 64 pixels
//    per stage, so a mirrored read is computed from (n, h, w) with no
//    division; split ranges are whole image rows;
//  * the split-K partial sums are written to a workspace slice per split and
//    added by reduce_splits_kernel in a fixed order: no float atomics, so
//    runs repeat bit for bit. The split count (ops/sfconv_cuda.sums_geometry)
//    aims at two waves of blocks and keeps the workspace under 64 MiB.

constexpr int kSumWgThreads = 384;
constexpr int kSumBK = 64;                    // pixel rows per stage
constexpr int kSumWT = 128;                   // A channels and G channels per block
constexpr int kSumPanel = kSumBK * 128;       // 64 pixel rows x 64 channels, 8 KB
constexpr int kSumOpTile = 2 * kSumPanel;     // 64 pixel rows x 128 channels
constexpr int kSumStage = 3 * kSumOpTile;     // two A sections and G: 48 KB
constexpr int kSumStages = 4;
// + alignment, barriers, the pixel table (two slots of 64 direct and 64 mirror pixels)
constexpr int kSumSmem = kSumStages * kSumStage + 1024 + 2 * 8 * kSumStages + 4 * kSumBK * 4;

__global__ void __launch_bounds__(kSumWgThreads, 1)
dw_wgmma_kernel(SumOperands<__nv_bfloat16> ops, float* __restrict__ dst_base, int H, int W, int C,
                int img_rows, int rows_per_split) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char sum_smem[];
  const uint32_t ring = (smem_u32(sum_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + kSumStages * kSumStage;
  const uint32_t empty = full + 8 * kSumStages;
  int* pix = reinterpret_cast<int*>(sum_smem + (empty + 8 * kSumStages - smem_u32(sum_smem)));

  const int tiles = (C + kSumWT - 1) / kSumWT;
  const int q = blockIdx.y / tiles;  // section pair
  const int i0 = (blockIdx.y % tiles) * kSumWT;
  const int j0 = blockIdx.x * kSumWT;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = r_begin + rows_per_split < img_rows ? r_begin + rows_per_split : img_rows;
  const long long p_begin = (long long)r_begin * W, p_end = (long long)r_end * W;
  const int nk = (int)((p_end - p_begin + kSumBK - 1) / kSumBK);
  float* dst = dst_base + (long long)blockIdx.z * 4 * C * C;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSumStages; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == 2) {
    // ---- producer. Threads 0..63 each follow one pixel row of the stage,
    // walking it 64 pixels per stage, and publish its direct and mirror
    // pixel in a shared table (two slots, one per parity of the stage); then
    // 16 threads cover one pixel row's 128 channels (256 bytes) per copy
    // instruction, whole 32-byte sectors.
    setmaxnreg_dec<40>();
    const bf16* a0 = ops.a[2 * q];
    const bf16* a1 = ops.a[2 * q + 1];
    const bf16* g = ops.g[2 * q];
    const bool m0 = (ops.mirror_a >> (2 * q)) & 1u, m1 = (ops.mirror_a >> (2 * q + 1)) & 1u;
    const bool mg = (ops.mirror_g >> (2 * q)) & 1u;
    long long p = p_begin + t;
    int n = 0, h = 0, w = 0;
    if (t < kSumBK) {
      const long long ir = p / W;
      w = (int)(p - ir * W);
      n = (int)(ir / H);
      h = (int)(ir - (long long)n * H);
    }
    const int c16 = t & 15;  // 16-byte chunk of the 128-channel tile row
    const int ca = i0 + 8 * c16, cg = j0 + 8 * c16;
    const uint32_t off0 = (c16 >> 3) * kSumPanel;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kSumStages;
      if (it >= kSumStages) mbar_wait(empty + 8 * s, ((it / kSumStages) - 1) & 1);
      int* slot = pix + 2 * kSumBK * (it & 1);
      if (t < kSumBK) {
        const bool valid = p < p_end;
        slot[t] = valid ? (int)p : -1;
        slot[kSumBK + t] = valid ? (n * H + (h ? H - h : 0)) * W + (w ? W - w : 0) : -1;
        p += kSumBK;  // next stage: 64 pixels further, walked row by row
        w += kSumBK;
        while (w >= W) {
          w -= W;
          if (++h == H) {
            h = 0;
            ++n;
          }
        }
      }
      named_barrier(1, 128);
      const uint32_t st = ring + s * kSumStage + off0;
#pragma unroll
      for (int i = 0; i < kSumBK / 8; ++i) {
        const int row = (t >> 4) + 8 * i;
        const int pd = slot[row], pm = slot[kSumBK + row];
        const uint32_t off = sw128(row, c16 & 7);
        const int na = pd >= 0 && ca < C ? 16 : 0;
        const int ng = pd >= 0 && cg < C ? 16 : 0;
        const long long o0 = (long long)(m0 ? pm : pd) * C, o1 = (long long)(m1 ? pm : pd) * C;
        const long long og = (long long)(mg ? pm : pd) * C;
        cp_async16(st + off, na ? a0 + o0 + ca : a0, na);
        cp_async16(st + kSumOpTile + off, na ? a1 + o1 + ca : a1, na);
        cp_async16(st + 2 * kSumOpTile + off, ng ? g + og + cg : g, ng);
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // leave no copy in flight at exit
  } else {
    // ---- consumers: warpgroup wg owns A channels i0 + 64*wg .. +63 of both sections
    setmaxnreg_inc<232>();
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kSumStages;
      mbar_wait(full + 8 * s, (it / kSumStages) & 1);
      fence_proxy_async();
      const uint32_t st = ring + s * kSumStage;
      const uint32_t ta0 = st + wg * kSumPanel;
      const uint32_t ta1 = ta0 + kSumOpTile;
      const uint32_t tg = st + 2 * kSumOpTile;
      fence_regs<64>(acc0);
      fence_regs<64>(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSumBK / 16; ++kk) {
        const uint64_t dg = desc_mn(tg + 2048 * kk, kSumPanel);
        wgmma_bf16<128, 1, 1>(acc0, desc_mn(ta0 + 2048 * kk, kSumPanel), dg);
        wgmma_bf16<128, 1, 1>(acc1, desc_mn(ta1 + 2048 * kk, kSumPanel), dg);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<64>(acc0);
      fence_regs<64>(acc1);
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kSumStages));
    }
    wgmma_wait<0>();
    fence_regs<64>(acc0);
    fence_regs<64>(acc1);

    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int i = i0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hi;
      if (i >= C) continue;
      float* d0 = dst + ((long long)(2 * q) * C + i) * C;
      float* d1 = d0 + (long long)C * C;
#pragma unroll
      for (int jn = 0; jn < kSumWT / 8; ++jn) {
        const int j = j0 + 8 * jn + 2 * (lane & 3);
        if (j >= C) continue;
        const int e = 4 * jn + 2 * hi;
        *reinterpret_cast<float2*>(d0 + j) = make_float2(acc0[e], acc0[e + 1]);
        *reinterpret_cast<float2*>(d1 + j) = make_float2(acc1[e], acc1[e + 1]);
      }
    }
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

// Image rows per split: the splits cover the N*H image rows in whole rows.
inline int sum_rows_per_split(int img_rows, int splits) { return (img_rows + splits - 1) / splits; }

inline cudaError_t run_dw(const SumOperands<__nv_bfloat16>& ops, float* dst, int N, int H, int W,
                          int C, int splits, cudaStream_t s) {
  // sections 2q and 2q+1 must share their G operand (true of every caller)
  for (int q = 0; q < 2; ++q)
    if (ops.g[2 * q] != ops.g[2 * q + 1] ||
        ((ops.mirror_g >> (2 * q)) & 1u) != ((ops.mirror_g >> (2 * q + 1)) & 1u))
      return cudaErrorInvalidValue;
  static SmemLimit configured;
  cudaError_t e = allow_smem(dw_wgmma_kernel, kSumSmem, &configured);
  if (e != cudaSuccess) return e;
  const int tiles = (C + kSumWT - 1) / kSumWT;
  const int img_rows = N * H;
  dim3 grid(tiles, 2 * tiles, splits);
  dw_wgmma_kernel<<<grid, kSumWgThreads, kSumSmem, s>>>(ops, dst, H, W, C, img_rows,
                                                       sum_rows_per_split(img_rows, splits));
  return cudaGetLastError();
}

inline cudaError_t run_dw(const SumOperands<float>& ops, float* dst, int N, int H, int W, int C,
                          int splits, cudaStream_t s) {
  const long long P = (long long)N * H * W;
  const long long rows = (long long)sum_rows_per_split(N * H, splits) * W;
  const int tiles_c = (C + kSumTile - 1) / kSumTile;
  dim3 grid(tiles_c, 4 * tiles_c, splits);
  dw_fma_kernel<<<grid, kSumThreads, 0, s>>>(ops, dst, H, W, C, P, rows);
  return cudaGetLastError();
}

// The four sums into out (4C x C fp32), through workspace ((splits, 4C, C)
// fp32 partial sums) when splits > 1.
template <typename T>
int launch_weight_sums(const SumOperands<T>& ops, void* workspace, void* out, int N, int H,
                       int W, int C, int splits, cudaStream_t s) {
  float* dst = static_cast<float*>(splits == 1 ? out : workspace);
  cudaError_t e = run_dw(ops, dst, N, H, W, C, splits, s);
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
  if (splits > (long long)n * h) return false;  // every split holds at least one image row
  if (splits > 1 && workspace == nullptr) return false;
  // bf16: C % 8 == 0 (16-byte copies), pixel indices in 32 bits
  return !bf16 || (c % 8 == 0 && (long long)n * h * w <= 0x7FFFFFFF);
}

}  // namespace
