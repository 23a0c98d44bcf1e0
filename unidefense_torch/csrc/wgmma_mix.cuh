// The bf16 channel mix on wgmma shared by K2 (sfconv_freq_fwd.cu), K3
// (sfconv_v4.cu) and K4 (sfconv_v3.cu). After the Hilbert pass (hx = bf16(hm
// @ x) per image row, hilbert_rows.cuh) every one of them is, per pixel row p,
// products of K = 2C against the (4, C, C) blocks b0..b3 (rows = input
// channels, every block added: the callers pass signed blocks), fp32
// accumulation:
//
//   K2, mirror (kMixMirror):  out(p)  = bf16(A(p)@[b0;b1] + bf16(A(p*)@[b2;b3]))
//   K3, split  (kMixSplit):   o1(p)   = bf16(A(p)@[b0;b1]),
//                             o2(p*)  = bf16(A(p)@[b2;b3])     (R(o2) in memory)
//   K4, pair   (kMixPair):    out(p)  = bf16(A(p)@[b0;b1] + A'(p)@[b2;b3])
//
// with A = [x | hx], A' = [rx | hr] (K4's materialised double reversal) and
// p* = (n, (-h) mod H, (-w) mod W) the mirror pixel. K2 loads its second
// operand at p*, which folds the row mirror and Pw into the addresses, so the
// mirror accumulator row of p is already out's row p; K3 stores o2 at p*
// instead, so the caller's o1 + R(o2) is one add.
//
// Bound on an H100: operations (8*W*C^2 flops per image row against 2-3
// bf16 streams; see each kernel's file). The blocks do not fit in shared
// memory (C up to 1632), so each block streams them: what the tensor cores
// can be fed depends on how often a staged byte is used. What bounded the
// WMMA kernels this replaced (one for K2, one shared by K3 and K4):
// synchronous staging through registers (two block barriers per chunk,
// nothing overlapped), 64-channel output tiles (A re-read from L2 C/64
// times), mma.sync, one 8-warp block per SM at 215-218 registers, tiles cut at
// image ends, and an fp32 epilogue tile in shared memory. Here:
//
//  * one block per (BN output channels, group of R image rows), R = floor(128
//    / W) image rows taken from the flattened (n, h) sequence, so a group may
//    end in one image and go on in the next: 128 - R*W rows of the tile idle
//    (W = 12: 120 of 128; W = 48: 96), none lost to a group cut short at an
//    image's end. grid = (C / BN, ceil(N*H / R)); x is fastest, so the blocks
//    that share a row group's A tiles run together and find them in L2;
//  * 384 threads: two consumer warpgroups, each owning 64 pixel rows and the
//    accumulators (K2, K3: 2 x BN/2 fp32 registers a thread, K4: BN/2;
//    setmaxnreg 224), and one producer warpgroup (setmaxnreg 56) that keeps a
//    ring of kStages stages in flight with 16-byte cp.async copies that
//    arrive on an mbarrier per stage;
//  * a stage holds 32 input channels of each source pair side by side, K = 64
//    in one 128-byte swizzled row: kATiles A tiles (128 x 64, K-major; K3
//    one, K2 and K4 two) and two B tiles [b0; b1] and [b2; b3] (64 x BN,
//    MN-major, straight from the row-major blocks). K2 and K4: 64 KB at BN =
//    128 (3 stages) or 48 KB at BN = 64 (4); K3: 48 KB at BN = 128 or 32 KB
//    at BN = 64 (4 stages). BN = 64 only where 128 would pad more than a fifth
//    of C (C = 192). A 64-channel stage at BN = 128 would not leave room for a
//    ring; the per-stage row of 64 bf16 keeps the 128-byte swizzle that
//    wgmma reads without bank conflicts;
//  * per stage each consumer issues 4 k16 steps x 2 products of m64nBNk16
//    and releases the previous stage once its wgmma group has retired (one
//    group stays in flight);
//  * every copy is a whole 16-byte chunk, 8 threads to a 128-byte A row, so
//    each warp instruction reads whole 32-byte sectors. The producer uses
//    cp.async throughout: TMA cannot express K2's mirror operand in one box
//    (Pw reverses within a row, and row 0 is its own mirror), and one
//    mechanism keeps one barrier protocol;
//  * the epilogue stores straight from the fragments as bf16x2: each tile row
//    is a contiguous C-run at one pixel (K3's o2 at its mirror pixel), so no
//    fp32 tile goes through shared memory.
//
// Rows of the tile past R*W (or past the last image) are zero-filled and feed
// only accumulator rows the epilogue drops; channels past C are zero-filled in
// both operands. The launch geometry (BN, R) comes from the caller
// (ops/sfconv_cuda.mix_geometry), checked by wgmma_mix_args_ok.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "hopper_async.cuh"

namespace {

enum MixMode : int { kMixMirror = 0, kMixSplit = 1, kMixPair = 2 };

constexpr int kMixThreads = 384;
constexpr int kMixBM = 128;              // pixel rows per tile, 64 per consumer warpgroup
constexpr int kMixKC = 32;               // input channels of each source per stage
constexpr int kMixATile = kMixBM * 128;  // bytes of one A tile: 128 rows of 64 bf16
constexpr int kMixPanel = 64 * 128;      // bytes of a 64 K-row x 64 column B panel
constexpr int kMixMaxStages = 4;
constexpr int kMixSmemLimit = 232448;    // shared memory one block may use
constexpr int kConsumerRegs = 224;  // 2 x 64 accumulators and the epilogue
constexpr int kProducerRegs = 56;   // four A row addresses, two B row addresses, loop state

// Operands of one mix launch. A tile t holds channels of [a[t][0] | a[t][1]]:
// K2 (x, hx) at the core and at the mirror pixel, K3 (x, hx), K4 (x, hx) and
// (rx, hr) at the core pixel. out[1] is K3's o2 (stored reversed).
struct WgmmaMix {
  const __nv_bfloat16* a[2][2];
  const __nv_bfloat16* blocks;  // (4, C, C), every block added
  __nv_bfloat16* out[2];
  int H, W, C;
  int R;     // image rows per tile
  int rows;  // N * H image rows
};

template <int BN, int MODE>
struct MixCfg {
  static constexpr int kATiles = MODE == kMixSplit ? 1 : 2;
  static constexpr bool kTwoAcc = MODE != kMixPair;
  static constexpr int kBTile = BN / 64 * kMixPanel;  // one B tile: 64 K-rows x BN
  static constexpr int kStage = kATiles * kMixATile + 2 * kBTile;
  // + alignment, barriers (16 bytes a stage), the pixel table (2 x 128 ints)
  static constexpr int kFit = (kMixSmemLimit - 1024 - 2 * kMixBM * 4) / (kStage + 16);
  static constexpr int kStages = kFit < kMixMaxStages ? kFit : kMixMaxStages;
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * 8 * kStages + 2 * kMixBM * 4;
  static_assert(kStages >= 3, "the ring needs three stages");
};

// The mirror pixel (n, (-h) mod H, (-w) mod W) of flat pixel row `row` of a
// tile that starts at image row ir0.
__device__ __forceinline__ int mirror_pixel(int ir0, int row, int H, int W) {
  const int ir = ir0 + row / W, w = row % W;
  const int n = ir / H, h = ir - n * H;
  return (n * H + (h ? H - h : 0)) * W + (w ? W - w : 0);
}

template <int BN, int MODE>
__device__ __forceinline__ void wgmma_mix(const WgmmaMix& a) {
  using Cfg = MixCfg<BN, MODE>;
  using bf16 = __nv_bfloat16;
  constexpr int kStages = Cfg::kStages;
  constexpr int kAcc = BN / 2;  // fp32 accumulator registers a thread, per product
  extern __shared__ unsigned char mix_smem[];
  const uint32_t ring = (smem_u32(mix_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * Cfg::kStage;  // one mbarrier (8 bytes) per stage
  const uint32_t empty = full + 8 * kStages;
  // pixel of each tile row's core and mirror operand, after the barriers
  int* pix = reinterpret_cast<int*>(mix_smem + (empty + 8 * kStages - smem_u32(mix_smem)));

  const int H = a.H, W = a.W, C = a.C;
  const int nk = (C + kMixKC - 1) / kMixKC;
  const int j0 = blockIdx.x * BN;
  const int ir0 = blockIdx.y * a.R;  // first image row (n*H + h) of the group
  const int M = (a.rows - ir0 < a.R ? a.rows - ir0 : a.R) * W;  // valid pixel rows of the tile
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);   // every producer thread's copies
      mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == 2) {
    // ---- producer. Each copy instruction of a warp reads whole 32-byte
    // sectors: 8 threads cover one A row (64 bytes of each source), 16 (or
    // 8) threads one B row. The pixel of every tile row and of its mirror
    // is computed once, into shared memory.
    setmaxnreg_dec<kProducerRegs>();
    {
      int pc = -1, pm = -1;  // flat pixel (n*H + h)*W + w, -1: zero-fill
      if (t < M) {
        pc = ir0 * W + t;
        pm = mirror_pixel(ir0, t, H, W);
      }
      pix[t] = pc;
      pix[kMixBM + t] = pm;
    }
    named_barrier(1, 128);
    const int ca = t & 7;  // A chunk: channels 8*ca of the first source (ca < 4), else the second
    const int cha = 8 * (ca & 3);
    const bf16* src0 = ca < 4 ? a.a[0][0] : a.a[0][1];  // selects: no indexed parameter reads
    // K2 reads both A tiles from one source pair: one pointer, as few producer registers
    const bf16* src1 = MODE != kMixPair ? src0 : ca < 4 ? a.a[1][0] : a.a[1][1];
    const bf16* zero_src = a.blocks;  // any valid address: a zero-fill reads nothing
    constexpr int kBRowChunks = BN / 8;        // 16-byte chunks of one B row
    constexpr int kBRows = 128 / kBRowChunks;  // B rows one pass of the warpgroup covers
    const int cb = t % kBRowChunks;
    const int col = j0 + 8 * cb;
    const uint32_t bdst = Cfg::kATiles * kMixATile + (cb >> 3) * kMixPanel;
    const long long cc = (long long)C * C;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
      const uint32_t st = ring + s * Cfg::kStage;
      const int k0 = it * kMixKC;
      const bool kin = k0 + cha < C;
#pragma unroll
      for (int i = 0; i < kMixBM / 16; ++i) {
        const int r = (t >> 3) + 16 * i;
        // both table reads before the copies: each copy's "memory" clobber
        // would otherwise hold a later read back behind it
        const int pc = pix[r];
        const int p1 = MODE == kMixMirror ? pix[kMixBM + r] : pc;  // K2: mirror pixel, K4: core
        const int nc = pc >= 0 && kin ? 16 : 0;
        cp_async16(st + sw128(r, ca), nc ? src0 + (long long)pc * C + k0 + cha : zero_src, nc);
        if constexpr (Cfg::kATiles == 2) {
          const int n1 = p1 >= 0 && kin ? 16 : 0;
          cp_async16(st + kMixATile + sw128(r, ca),
                     n1 ? src1 + (long long)p1 * C + k0 + cha : zero_src, n1);
        }
      }
#pragma unroll
      for (int i = 0; i < 64 / kBRows; ++i) {
        const int kr = t / kBRowChunks + kBRows * i;  // K-row: first source's channels, then the second's
        const int krow = k0 + (kr & (kMixKC - 1));
        const bool second = kr >= kMixKC;             // b1 / b3 rather than b0 / b2
        const int nb = krow < C && col < C ? 16 : 0;
        const long long o = (long long)krow * C + col;
        const uint32_t dst = st + bdst + sw128(kr, cb & 7);
        cp_async16(dst, nb ? a.blocks + (second ? cc : 0) + o : zero_src, nb);
        cp_async16(dst + Cfg::kBTile, nb ? a.blocks + (second ? 3 : 2) * cc + o : zero_src, nb);
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // leave no copy in flight at exit
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64*wg .. 64*wg + 63
    setmaxnreg_inc<kConsumerRegs>();
    float acc0[kAcc], acc1[Cfg::kTwoAcc ? kAcc : 1];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (Cfg::kTwoAcc ? kAcc : 1); ++i) acc1[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      fence_proxy_async();
      const uint32_t st = ring + s * Cfg::kStage;
      const uint32_t a0 = st + wg * 64 * 128;
      const uint32_t a1 = a0 + (Cfg::kATiles - 1) * kMixATile;
      const uint32_t b0 = st + Cfg::kATiles * kMixATile;
      const uint32_t b1 = b0 + Cfg::kBTile;
      fence_regs<kAcc>(acc0);
      if constexpr (Cfg::kTwoAcc) fence_regs<kAcc>(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16<BN, 0, 1>(acc0, desc_k(a0 + 32 * kk), desc_mn(b0 + 2048 * kk, kMixPanel));
        // K2: A(p*) [b2; b3]; K3: A(p) [b2; b3] into o2; K4: A'(p) [b2; b3] into the one sum
        const uint64_t da = desc_k(a1 + 32 * kk), db = desc_mn(b1 + 2048 * kk, kMixPanel);
        if constexpr (Cfg::kTwoAcc)
          wgmma_bf16<BN, 0, 1>(acc1, da, db);
        else
          wgmma_bf16<BN, 0, 1>(acc0, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<kAcc>(acc0);
      if constexpr (Cfg::kTwoAcc) fence_regs<kAcc>(acc1);
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(acc0);
    if constexpr (Cfg::kTwoAcc) fence_regs<kAcc>(acc1);

    // epilogue, straight from the fragments: row 16*warp + lane/4 (+ 8),
    // columns 8*jn + 2*(lane % 4) and the next
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * hi;
      if (row >= M) continue;
      bf16* dst0 = a.out[0] + ((long long)ir0 * W + row) * C;
      bf16* dst1 = nullptr;
      if constexpr (MODE == kMixSplit) dst1 = a.out[1] + (long long)mirror_pixel(ir0, row, H, W) * C;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int col = j0 + 8 * jn + 2 * (lane & 3);
        if (col >= C) continue;
        const int i = 4 * jn + 2 * hi;
        if constexpr (MODE == kMixMirror) {
          // out = bf16(core + bf16(mir))
          const float m0 = __bfloat162float(__float2bfloat16(acc1[i]));
          const float m1 = __bfloat162float(__float2bfloat16(acc1[i + 1]));
          *reinterpret_cast<__nv_bfloat162*>(dst0 + col) =
              __floats2bfloat162_rn(acc0[i] + m0, acc0[i + 1] + m1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst0 + col) = __floats2bfloat162_rn(acc0[i], acc0[i + 1]);
          if constexpr (MODE == kMixSplit)
            *reinterpret_cast<__nv_bfloat162*>(dst1 + col) =
                __floats2bfloat162_rn(acc1[i], acc1[i + 1]);
        }
      }
    }
  }
}

// Launch one of the callers' __global__ wrappers of wgmma_mix<BN, MODE> (each
// file names its own kernel, so profiles tell K2, K3 and K4 apart).
template <int BN, int MODE>
int launch_wgmma_mix(void (*kernel)(WgmmaMix), const WgmmaMix& a, cudaStream_t s) {
  static SmemLimit configured;  // one per instantiation, hence per kernel
  cudaError_t e = allow_smem(kernel, MixCfg<BN, MODE>::kSmem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.C + BN - 1) / BN, (a.rows + a.R - 1) / a.R);
  kernel<<<grid, kMixThreads, MixCfg<BN, MODE>::kSmem, s>>>(a);
  return (int)cudaGetLastError();
}

// The bf16 limits every entry into the mix checks: C % 8 == 0 (16-byte
// copies), bn 64 or 128, 1 <= R with R * W <= 128, ceil(N*H / R) <= 65535 row
// groups, fewer than 2^31 pixels, and parts 1 (the Hilbert pass alone), 2
// (the mix alone) or 3 (both).
inline bool wgmma_mix_args_ok(int n, int h, int w, int c, int bn, int rows, int parts) {
  return c % 8 == 0 && (bn == 64 || bn == 128) && rows >= 1 && rows * w <= kMixBM &&
         ((long long)n * h + rows - 1) / rows <= 65535 && (long long)n * h * w <= 0x7FFFFFFF &&
         parts >= 1 && parts <= 3;
}

}  // namespace
