// K1: fused uint8 -> normalised float input preprocessing with a per-sample
// horizontal flip.
//
// Replaces the Pallas kernel unidefense_tpu/ops/pallas_preprocess.py
// (_kernel / _normalize, called by normalize_flip and DevicePipeline). The TPU
// kernel could not reverse inside the kernel (Mosaic has no `rev`), so it
// flipped the normalised output afterwards in a second pass; here the flip is
// a reversed read along W driven by a per-sample mask, and the whole op is one
// pass: read u8 once, write the output once.
//
// out[n, h, w, c] = (x[n, h, w', c] * (1/255) - mean[c]) * inv_std[c],
//   w' = flip[n] ? W-1-w : w
//
// Bound on an H100: bytes. N*H*W*3 * (1 + out bytes) moved for 3 flops per
// element, far below the ~295 flop/byte ridge, so the least time is the bytes
// over 3.35 TB/s. What keeps a kernel from that bound here is instructions
// per byte, so the design spends as few as it can on each 16 bytes:
//
//  * Tiles of R whole image rows over the flattened (n, h) rows, R chosen in
//    Python (ops/preprocess.normalize_flip_geometry) so that a tile is a
//    multiple of 16 bytes in and out. Blocks walk the tiles in a grid-stride
//    loop; each block keeps a ring of two tiles in shared memory and loads
//    the next with 16-byte cp.async copies while it writes the current one.
//  * Every thread writes 16-byte vectors (4 fp32 or 8 bf16 values). Its index
//    arithmetic is 32-bit: one division per vector finds its row, position
//    and the three channels its values cycle through (mean and inv_std picked
//    once per vector), then each value steps its position; a vector that runs
//    past its row (3W not a multiple of the vector) steps to the next.
//    A vector inside one unflipped row takes its 4 or 8 source bytes in one
//    aligned shared load; a flipped row reads its source bytes one by one,
//    reversed, from the shared copy, so the flip costs no global traffic and
//    the loads stay whole sectors. Each row's flip bit is read from global
//    memory once per tile. Bytes become floats by a byte permute and one
//    subtraction (2^23 + v - 2^23), not the quarter-rate integer conversion,
//    and bf16 values are rounded two to an instruction.
//  * The rows after the last full tile (N*H not a multiple of R), and every
//    row of an input whose pointer is not 16-byte aligned (a contiguous view
//    at an odd offset), take a scalar path in the same kernel: one row per
//    block step, byte loads and element stores, one division per row.
//  * Rounding follows the plain version op by op (__fmul_rn, __fsub_rn,
//    __fmul_rn, then __float2bfloat16_rn), so no contraction into an FMA
//    changes a value: the kernel equals normalize_flip_plain bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileBytes = 20480;  // two tiles and their flags stay under 48 KB
constexpr int kMaxSmem = 48 * 1024;

struct Norm {
  float m0, m1, m2, s0, s1, s2;
};

__device__ __forceinline__ float pick(int c, float a, float b, float d) {
  return c == 0 ? a : (c == 1 ? b : d);
}

// u8 -> float exactly without the quarter-rate I2F: 0x4B0000vv is 2^23 + v.
__device__ __forceinline__ float u8_to_float(uint32_t v) {
  return __fsub_rn(__int_as_float(0x4B000000u | v), 8388608.0f);
}

// Byte j (0..3) of w as a float, by one byte permute and one subtraction.
__device__ __forceinline__ float byte_to_float(uint32_t w, int j) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | j)), 8388608.0f);
}

__device__ __forceinline__ float normalize(float v, float mean, float inv_std) {
  return __fmul_rn(__fsub_rn(__fmul_rn(v, 1.0f / 255.0f), mean), inv_std);
}

// Source byte of output position `pos` (channel c) in a row of row_len bytes.
__device__ __forceinline__ int source(int pos, int c, int row_len, bool flipped) {
  return flipped ? row_len - 3 - pos + 2 * c : pos;
}

template <typename T>
struct Out;

template <>
struct Out<float> {
  static constexpr int kVec = 4;
  __device__ static float one(float v) { return v; }
  __device__ static void store(float* dst, const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Out<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __nv_bfloat16 one(float v) { return __float2bfloat16_rn(v); }
  __device__ static uint32_t pack(float lo, float hi) {  // two __float2bfloat16_rn in one cvt
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
  __device__ static void store(__nv_bfloat16* dst, const float (&v)[kVec]) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
};

// Start the 16-byte copies of tile `t` into the shared buffer `dst`.
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* x, int t, int tile_bytes) {
  const uint8_t* src = x + (size_t)t * tile_bytes;
  const uint32_t s = smem_u32(dst);
  for (int i = threadIdx.x * 16; i < tile_bytes; i += kThreads * 16) cp_async16(s + i, src + i, 16);
  cp_async_commit();
}

// Normalise the tile in shared memory `tile` (its rows' flip bits in `flags`)
// into `dst`, 16 bytes a store. Value j of a vector has channel ch[j % 3]: 3W
// is a multiple of 3, so the channels cycle on across a row boundary too.
template <typename T>
__device__ __forceinline__ void store_tile(const uint8_t* tile, const uint8_t* flags, T* dst,
                                           int row_len, int tile_bytes, const Norm& p) {
  constexpr int V = Out<T>::kVec;
  for (int e0 = threadIdx.x * V; e0 < tile_bytes; e0 += kThreads * V) {
    int r = (unsigned)e0 / (unsigned)row_len;
    int pos = e0 - r * row_len;
    int ch[3];
    ch[0] = (unsigned)pos % 3u;
    ch[1] = ch[0] == 2 ? 0 : ch[0] + 1;
    ch[2] = ch[1] == 2 ? 0 : ch[1] + 1;
    float mean[3], inv_std[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mean[i] = pick(ch[i], p.m0, p.m1, p.m2);
      inv_std[i] = pick(ch[i], p.s0, p.s1, p.s2);
    }
    const uint8_t* row = tile + r * row_len;
    bool flipped = flags[r];
    float v[V];
    if (!flipped && pos + V <= row_len) {
      // one unflipped row: the sources are tile[e0, e0 + V), one aligned shared load
      uint32_t w[V / 4];
      if constexpr (V == 4) {
        w[0] = *reinterpret_cast<const uint32_t*>(tile + e0);
      } else {
        const uint2 q = *reinterpret_cast<const uint2*>(tile + e0);
        w[0] = q.x;
        w[1] = q.y;
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = normalize(byte_to_float(w[j / 4], j % 4), mean[j % 3], inv_std[j % 3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (pos == row_len) {  // the vector runs on into the next row of the tile
          pos = 0;
          row += row_len;
          flipped = flags[++r];
        }
        v[j] = normalize(u8_to_float(row[source(pos, ch[j % 3], row_len, flipped)]), mean[j % 3],
                         inv_std[j % 3]);
        ++pos;
      }
    }
    Out<T>::store(dst + e0, v);
  }
}

// Work unit u < tiles is tile u (rows u*R .. u*R+R-1); unit u >= tiles is the
// single row tiles*R + (u - tiles), on the scalar path.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    normalize_flip_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ flip,
                          T* __restrict__ out, int h, int row_len, int rows, int tiles,
                          int units, Norm p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile_bytes = rows * row_len;
  uint8_t* flags = smem + 2 * tile_bytes;
  int u = blockIdx.x;
  int buf = 0;
  if (u < tiles) load_tile(smem, x, u, tile_bytes);
  for (; u < units; u += gridDim.x) {
    if (u < tiles) {
      const int next = u + gridDim.x;
      if (next < tiles) {
        load_tile(smem + (buf ^ 1) * tile_bytes, x, next, tile_bytes);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      const int row0 = u * rows;
      for (int i = threadIdx.x; i < rows; i += kThreads)
        flags[i] = flip != nullptr && flip[(row0 + i) / h] != 0;
      __syncthreads();
      store_tile<T>(smem + buf * tile_bytes, flags, out + (size_t)u * tile_bytes, row_len,
                    tile_bytes, p);
      __syncthreads();  // the buffer and flags are rewritten next step
      buf ^= 1;
    } else {
      const int row = tiles * rows + (u - tiles);
      const uint8_t* src = x + (size_t)row * row_len;
      T* dst = out + (size_t)row * row_len;
      const bool flipped = flip != nullptr && flip[row / h] != 0;
      for (int pos = threadIdx.x; pos < row_len; pos += kThreads) {
        const int c = (unsigned)pos % 3u;
        dst[pos] = Out<T>::one(normalize(u8_to_float(__ldg(src + source(pos, c, row_len, flipped))),
                                         pick(c, p.m0, p.m1, p.m2), pick(c, p.s0, p.s1, p.s2)));
      }
    }
  }
}

// The geometry of ops/preprocess.normalize_flip_geometry: R = 0 (no tile
// fits; every row scalar) with no tiles, or tiles of R rows that are whole
// 16-byte vectors in and out, fit the shared memory, and number floor(N*H/R).
bool normalize_flip_args_ok(long long nh, int row_len, int out_bytes, int rows, int tiles,
                            int grid) {
  if (grid < 1 || rows < 0 || tiles < 0) return false;
  if (rows == 0) return tiles == 0;
  const long long tile = (long long)rows * row_len;
  return tile % 16 == 0 && tile * out_bytes % 16 == 0 && tile <= kMaxTileBytes &&
         2 * tile + rows <= kMaxSmem && tiles == nh / rows;
}

}  // namespace

// x: (N, H, W, 3) uint8; flip: (N,) uint8 or null; out: (N, H, W, 3) float32
// (out_bf16 = 0) or bfloat16 (out_bf16 = 1), 16-byte aligned; mean_inv_std: a
// host array of 6 floats. rows, tiles, grid: normalize_flip_geometry's; with
// aligned = 0 (x not 16-byte aligned) every row takes the scalar path.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// these limits.
extern "C" int ud_normalize_flip(const void* x, const void* flip, void* out,
                                 const void* mean_inv_std, int n, int h, int w, int out_bf16,
                                 int rows, int tiles, int grid, int aligned, void* stream) {
  const long long nh = (long long)n * h;
  if (n < 1 || h < 1 || w < 1 || nh > INT_MAX || 3LL * w > INT_MAX) return (int)cudaErrorInvalidValue;
  const int row_len = 3 * w;
  if (!normalize_flip_args_ok(nh, row_len, out_bf16 ? 2 : 4, rows, tiles, grid) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (aligned && (reinterpret_cast<uintptr_t>(x) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const int full = aligned ? tiles : 0;
  const int units = full + (int)(nh - (long long)full * rows);
  const size_t smem = full ? 2 * (size_t)rows * row_len + rows : 0;
  const float* m = static_cast<const float*>(mean_inv_std);
  const Norm p{m[0], m[1], m[2], m[3], m[4], m[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* xu = static_cast<const uint8_t*>(x);
  const uint8_t* fu = static_cast<const uint8_t*>(flip);
  if (out_bf16)
    normalize_flip_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        xu, fu, static_cast<__nv_bfloat16*>(out), h, row_len, rows, full, units, p);
  else
    normalize_flip_kernel<float><<<grid, kThreads, smem, s>>>(xu, fu, static_cast<float*>(out), h,
                                                              row_len, rows, full, units, p);
  return (int)cudaGetLastError();
}
