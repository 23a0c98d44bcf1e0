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
// hilbert_rows.cuh on the tensor cores, then the channel mix below on wgmma
// (its design note is above sfconv_mix_wgmma_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hilbert_rows.cuh"
#include "hopper_async.cuh"

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
// The four blocks from the packed (2C, 2C) fp32 kernel w (w[i][o] at
// i*s0 + o*s1, any strides: the model passes a transposed view of its
// weight), in one launch instead of a chain of tensor ops:
//
//   forward (transposed = 0):  A1, -A2, B1, B2          x_bar:  A1^T, A2^T, B1^T, B2^T
//
// with A1 = (Wrr+Wii)/2, A2 = (Wri-Wir)/2, B1 = (Wrr-Wii)/2, B2 = (Wri+Wir)/2
// (sfconv_pallas.py:124-133), each formed in fp32 and rounded once to T.
// A block of 256 threads moves one 32 x 32 tile of each quadrant through
// shared memory, reading along w's contiguous index and writing rows.

constexpr int kSplitTile = 32;

template <typename T>
__global__ void __launch_bounds__(256)
split_blocks_kernel(const float* __restrict__ w, long long s0, long long s1, T* __restrict__ blocks,
                    int C, int transposed) {
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
  for (int e = threadIdx.x; e < 4 * kTileElems; e += 256) {
    const int m = e / kTileElems, rem = e % kTileElems;
    const int dk = rem / kSplitTile, dj = rem % kSplitTile;  // j fastest: row writes
    const int a = transposed ? dj : dk, b = transposed ? dk : dj;
    const int k = (transposed ? o0 : i0) + dk, j = (transposed ? i0 : o0) + dj;
    if (k >= C || j >= C) continue;
    const float rr = q[0][a][b], ri = q[1][a][b], ir = q[2][a][b], ii = q[3][a][b];
    const float v = m == 0 ? rr + ii : m == 1 ? (transposed ? ri - ir : ir - ri)
                             : m == 2 ? rr - ii : ri + ir;
    blocks[((long long)m * C + k) * C + j] = from_f32<T>(v * 0.5f);
  }
}

// ---------------------------------------------------------------------------
// bf16 channel mix on wgmma.
//
// After the Hilbert pass (hx = bf16(hm @ x) per image row, hilbert_rows.cuh),
// the mix is two products per pixel row p, with K = 2C:
//
//   core(p) = [x(p) | hx(p)] @ [b0; b1]      mir(p) = [x(p*) | hx(p*)] @ [b2; b3]
//   out(p)  = bf16(core(p) + bf16(mir(p)))
//
// where p* = (n, (-h) mod H, (-w) mod W) is the mirror pixel: loading the
// mirror operand at p* folds both the row mirror and Pw into the addresses, so
// the mirror accumulator row of p is already out's row p and the epilogue
// needs no permutation.
//
// What bounded the WMMA kernel this replaces: synchronous staging (each chunk
// through registers, two block barriers, nothing overlapped), a 64-channel
// output tile (A re-read for every 64 output channels), and mma.sync. Here:
//
//  * one block per (BN output channels, group of R image rows), R = floor(128
//    / W) image rows taken from the flattened (n, h) sequence, so a group may
//    end in one image and go on in the next: 128 - R*W rows of the tile idle
//    (W = 12: 120 of 128), none lost to a group cut short at an image's end;
//  * 384 threads: two consumer warpgroups, each owning 64 pixel rows and both
//    accumulators (2 x BN/2 fp32 registers a thread, setmaxnreg 224), and one
//    producer warpgroup (setmaxnreg 56) that keeps a ring of kStages stages in
//    flight with 16-byte cp.async copies that arrive on an mbarrier per stage;
//  * a stage holds 32 input channels of x and of hx side by side, i.e. K = 64
//    of [x | hx] in one 128-byte swizzled row: A tiles of the core and mirror
//    rows (128 x 64, K-major) and B tiles [b0; b1] and [b2; b3] (64 x BN,
//    MN-major, straight from the row-major blocks): 32 KB + 4 * BN * 64 bytes.
//    BN = 128 with 3 stages, or BN = 64 with 4 (C = 192, where 128 would pad a
//    third of the work), both 192 KB of the 227 KB. A 64-channel stage at BN =
//    128 would be 128 KB, too big for a ring; the per-stage row of 64 bf16
//    keeps the 128-byte swizzle that wgmma reads without bank conflicts;
//  * per stage each consumer issues 4 k16 steps x 2 products of m64nBNk16 and
//    releases the previous stage once its wgmma group has retired (one group
//    stays in flight);
//  * the mirror operand's addresses are computed once per tile row: TMA
//    cannot express them in one box (Pw reverses within a row, and row 0 is
//    its own mirror), so the producer uses cp.async throughout; the weights
//    could take TMA, but one mechanism keeps one barrier protocol.
//
// Rows of the tile past R*W (or past the last image) are zero-filled and feed
// only accumulator rows the epilogue drops; channels past C are zero-filled in
// both operands.

constexpr int kMixThreads = 384;
constexpr int kMixBM = 128;              // pixel rows per tile, 64 per consumer warpgroup
constexpr int kMixKC = 32;               // input channels of x (and of hx) per stage
constexpr int kMixATile = kMixBM * 128;  // bytes of one A tile: 128 rows of 64 bf16
constexpr int kMixPanel = 64 * 128;      // bytes of a 64 K-row x 64 column B panel
constexpr int kConsumerRegs = 224;  // 2 x 64 accumulators and the epilogue
constexpr int kProducerRegs = 56;   // four A row addresses, two B row addresses, loop state

template <int BN>
struct MixCfg {
  static constexpr int kBTile = BN / 64 * kMixPanel;  // one B tile: 64 K-rows x BN
  static constexpr int kStage = 2 * kMixATile + 2 * kBTile;
  static constexpr int kStages = BN == 128 ? 3 : 4;
  // + alignment, barriers, the pixel table (2 x 128 ints)
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * 8 * kStages + 2 * kMixBM * 4;
};

template <int BN>
__global__ void __launch_bounds__(kMixThreads, 1)
sfconv_mix_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ hx,
                        const __nv_bfloat16* __restrict__ blocks, __nv_bfloat16* __restrict__ out,
                        int H, int W, int C, int R, int rows) {
  using Cfg = MixCfg<BN>;
  using bf16 = __nv_bfloat16;
  constexpr int kStages = Cfg::kStages;
  constexpr int kAcc = BN / 2;  // fp32 accumulator registers a thread, per product
  extern __shared__ unsigned char mix_smem[];
  const uint32_t ring = (smem_u32(mix_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + kStages * Cfg::kStage;  // one mbarrier (8 bytes) per stage
  const uint32_t empty = full + 8 * kStages;
  // pixel of each tile row's core and mirror operand, after the barriers
  int* pix = reinterpret_cast<int*>(mix_smem + (empty + 8 * kStages - smem_u32(mix_smem)));

  const int nk = (C + kMixKC - 1) / kMixKC;
  const int j0 = blockIdx.x * BN;
  const int ir0 = blockIdx.y * R;  // first image row (n*H + h) of the group
  const int M = (rows - ir0 < R ? rows - ir0 : R) * W;  // valid pixel rows of the tile
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
    // sectors: 8 threads cover one A row (x: 64 bytes, hx: 64 bytes), 16 (or
    // 8) threads one B row. The pixel of every tile row and of its mirror
    // is computed once, into shared memory.
    setmaxnreg_dec<kProducerRegs>();
    {
      int pc = -1, pm = -1;  // flat pixel (n*H + h)*W + w, -1: zero-fill
      if (t < M) {
        const int ir = ir0 + t / W, w = t % W;
        const int n = ir / H, h = ir - n * H;
        pc = ir * W + w;
        pm = (n * H + (h ? H - h : 0)) * W + (w ? W - w : 0);
      }
      pix[t] = pc;
      pix[kMixBM + t] = pm;
    }
    named_barrier(1, 128);
    const int ca = t & 7;               // A chunk: x channels 8*ca (ca < 4), else hx
    const bf16* asrc = ca < 4 ? x : hx;
    const int cha = 8 * (ca & 3);
    constexpr int kBRowChunks = BN / 8;  // 16-byte chunks of one B row
    constexpr int kBRows = 128 / kBRowChunks;  // B rows one pass of the warpgroup covers
    const int cb = t % kBRowChunks;
    const int col = j0 + 8 * cb;
    const uint32_t bdst = 2 * kMixATile + (cb >> 3) * kMixPanel;
    const long long cc = (long long)C * C;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
      const uint32_t st = ring + s * Cfg::kStage;
      const int k0 = it * kMixKC;
#pragma unroll
      for (int i = 0; i < kMixBM / 16; ++i) {
        const int r = (t >> 3) + 16 * i;
        const int pc = pix[r], pm = pix[kMixBM + r];
        const int nc = pc >= 0 && k0 + cha < C ? 16 : 0;
        const int nm = pm >= 0 && k0 + cha < C ? 16 : 0;
        cp_async16(st + sw128(r, ca), nc ? asrc + (long long)pc * C + k0 + cha : x, nc);
        cp_async16(st + kMixATile + sw128(r, ca), nm ? asrc + (long long)pm * C + k0 + cha : x,
                   nm);
      }
#pragma unroll
      for (int i = 0; i < 64 / kBRows; ++i) {
        const int kr = t / kBRowChunks + kBRows * i;  // K-row: x channels 0..31, then hx 0..31
        const int krow = k0 + (kr & (kMixKC - 1));
        const bool second = kr >= kMixKC;             // b1 / b3 rather than b0 / b2
        const int nb = krow < C && col < C ? 16 : 0;
        const long long o = (long long)krow * C + col;
        const uint32_t dst = st + bdst + sw128(kr, cb & 7);
        cp_async16(dst, nb ? blocks + (second ? cc : 0) + o : blocks, nb);
        cp_async16(dst + Cfg::kBTile, nb ? blocks + (second ? 3 : 2) * cc + o : blocks, nb);
      }
      cp_async_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // leave no copy in flight at exit
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64*wg .. 64*wg + 63
    setmaxnreg_inc<kConsumerRegs>();
    float core[kAcc], mir[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) core[i] = mir[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      fence_proxy_async();
      const uint32_t st = ring + s * Cfg::kStage;
      const uint32_t a_core = st + wg * 64 * 128;
      const uint32_t a_mir = a_core + kMixATile;
      const uint32_t b_core = st + 2 * kMixATile;
      const uint32_t b_mir = b_core + Cfg::kBTile;
      fence_regs<kAcc>(core);
      fence_regs<kAcc>(mir);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_bf16<BN, 0, 1>(core, desc_k(a_core + 32 * kk), desc_mn(b_core + 2048 * kk, kMixPanel));
        wgmma_bf16<BN, 0, 1>(mir, desc_k(a_mir + 32 * kk), desc_mn(b_mir + 2048 * kk, kMixPanel));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<kAcc>(core);
      fence_regs<kAcc>(mir);
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs<kAcc>(core);
    fence_regs<kAcc>(mir);

    // epilogue: out = bf16(core + bf16(mir)), straight from the fragments
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = wg * 64 + warp * 16 + (lane >> 2) + 8 * hi;
      if (row >= M) continue;
      bf16* dst = out + ((long long)ir0 * W + row) * C;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int col = j0 + 8 * jn + 2 * (lane & 3);
        if (col >= C) continue;
        const int i = 4 * jn + 2 * hi;
        const float m0 = __bfloat162float(__float2bfloat16(mir[i]));
        const float m1 = __bfloat162float(__float2bfloat16(mir[i + 1]));
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(core[i] + m0, core[i + 1] + m1);
      }
    }
  }
}

template <int BN>
int launch_mix(const __nv_bfloat16* x, const __nv_bfloat16* hx, const __nv_bfloat16* blocks,
               __nv_bfloat16* out, int N, int H, int W, int C, int R, cudaStream_t s) {
  static size_t configured = 0;
  cudaError_t e = allow_smem(sfconv_mix_wgmma_kernel<BN>, MixCfg<BN>::kSmem, &configured);
  if (e != cudaSuccess) return (int)e;
  const int rows = N * H;
  dim3 grid((C + BN - 1) / BN, (rows + R - 1) / R);
  sfconv_mix_wgmma_kernel<BN><<<grid, kMixThreads, MixCfg<BN>::kSmem, s>>>(
      x, hx, blocks, out, H, W, C, R, rows);
  return (int)cudaGetLastError();
}

// parts: 1 the Hilbert pass alone, 2 the mix alone (on the hx in scratch),
// 3 both (K2).
int launch_wgmma(const void* x, const void* blocks, const void* hm, void* out, void* hx, int N,
                 int H, int W, int C, int bn, int R, int parts, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (parts & 1) {
    cudaError_t e = launch_hilbert_rows(static_cast<const bf*>(x), static_cast<const bf*>(hm),
                                        static_cast<bf*>(hx), N * H, W, C, s);
    if (e != cudaSuccess || !(parts & 2)) return (int)e;
  }
  const bf* xb = static_cast<const bf*>(x);
  const bf* hb = static_cast<const bf*>(hx);
  const bf* bb = static_cast<const bf*>(blocks);
  bf* ob = static_cast<bf*>(out);
  if (bn == 64) return launch_mix<64>(xb, hb, bb, ob, N, H, W, C, R, s);
  return launch_mix<128>(xb, hb, bb, ob, N, H, W, C, R, s);
}

}  // namespace

// x, out: (N, H, W, C); blocks: (4, C, C) = b0, b1, b2, b3 with rows = input
// channels, every block added (see the top of this file); hm: (W, W). All
// float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous, 16-byte aligned.
// scratch: an (N, H, W, C) bfloat16 buffer for the Hilbert products, required
// for bfloat16 and unused for float32. bn (64 or 128 output channels per tile)
// and rows (R image rows per tile, R * W <= 128, ceil(N*H / R) <= 65535, and
// N*H*W < 2^31 pixels) set
// the bfloat16 mix's tiles (ops/sfconv_cuda.mix_geometry) and are unused for
// float32. parts (bfloat16 only; 3 for float32) is 3 for K2, or 1 or 2 to run
// the Hilbert pass or the mix alone, for timing. Needs 1 <= W <= 128, and
// C % 8 == 0 for bfloat16. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these
// limits.
extern "C" int ud_sfconv_freq_fwd(const void* x, const void* blocks, const void* hm,
                                  void* out, void* scratch, int n, int h, int w, int c,
                                  int bf16, int bn, int rows, int parts, void* stream) {
  if (w < 1 || w > kMaxM || n < 1 || h < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (c % 8 != 0 || scratch == nullptr || (bn != 64 && bn != 128) || rows < 1 ||
        rows * w > kMixBM || ((long long)n * h + rows - 1) / rows > 65535 || parts < 1 ||
        parts > 3 || (long long)n * h * w > 0x7FFFFFFF)
      return (int)cudaErrorInvalidValue;
    return launch_wgmma(x, blocks, hm, out, scratch, n, h, w, c, bn, rows, parts, s);
  }
  if (parts != 3) return (int)cudaErrorInvalidValue;
  return launch_fma(x, blocks, hm, out, n, h, w, c, s);
}

// The (4, C, C) blocks K2 adds (b0..b3 above, rows = input channels) from the
// packed (2C, 2C) float32 kernel w with element strides s0, s1: the forward's
// (A1, -A2, B1, B2), or with transposed = 1 x_bar's (A1^T, A2^T, B1^T, B2^T).
// blocks: contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these
// limits.
extern "C" int ud_sfconv_split_blocks(const void* w, void* blocks, int c, int s0, int s1,
                                      int transposed, int bf16, void* stream) {
  if (c < 1 || s0 < 1 || s1 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (c + kSplitTile - 1) / kSplitTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles, tiles);
  const float* wf = static_cast<const float*>(w);
  if (bf16)
    split_blocks_kernel<<<grid, 256, 0, s>>>(wf, s0, s1, static_cast<__nv_bfloat16*>(blocks), c,
                                             transposed);
  else
    split_blocks_kernel<<<grid, 256, 0, s>>>(wf, s0, s1, static_cast<float*>(blocks), c,
                                             transposed);
  return (int)cudaGetLastError();
}
