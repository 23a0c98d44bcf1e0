// host_jpeg — batched JPEG decode + crop + bilinear resize, and JPEG encode,
// for the port's host data path (unidefense_tpu's native/udjpeg.cc and the
// cv2.imencode of its transforms).
//
// One call decodes a whole batch on a pool of threads and writes fixed-size
// RGB uint8 frames into the caller's buffer, so Python makes one ctypes call
// per batch. Two backends, chosen at build time by ops/_build.py, decode the
// entropy-coded data and run the IDCT:
//
//   UD_JPEG_LIBJPEG  libjpeg (jpeglib.h, -ljpeg).
//   UD_JPEG_NVJPEG   nvJPEG of the CUDA toolkit (nvjpeg.h, -lnvjpeg), for a
//                    machine without libjpeg's header: each thread decodes
//                    on the GPU through its own nvJPEG state and stream and
//                    copies the planes back. The contexts live for the
//                    process: nvJPEG frees its buffers with cudaFree, which
//                    would wait for the training step running beside it.
//
// Both hand the YCbCr planes of a 4:4:4, 4:2:2 or 4:2:0 frame to the same
// host code: libjpeg's "fancy" chroma upsampling and its fixed-point
// YCbCr -> RGB tables (libjpeg-turbo jdsample.c, jdcolor.c). So the libjpeg
// backend equals native/udjpeg.cc bit for bit, and the nvJPEG backend parts
// from it only where nvJPEG's IDCT rounds otherwise. Other layouts (grey,
// 4:4:0, 4:1:1) take the library's own RGB output.
//
// Resize: bilinear, half-pixel centres (cv2.resize INTER_LINEAR's grid).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#if defined(UD_JPEG_LIBJPEG)
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#elif defined(UD_JPEG_NVJPEG)
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#error "define UD_JPEG_LIBJPEG or UD_JPEG_NVJPEG"
#endif

namespace {

// The component planes of one decoded frame: plane 0 is Y at the frame's
// size, planes 1 and 2 Cb and Cr, each subsampled by (hs, vs) in {1, 2}.
struct Planes {
  int width = 0, height = 0;
  int hs = 1, vs = 1;
  int w[3] = {0, 0, 0}, h[3] = {0, 0, 0};
  size_t stride[3] = {0, 0, 0};
  const uint8_t* data[3] = {nullptr, nullptr, nullptr};
};

bool supported_layout(int hs, int vs) { return vs == 1 ? (hs == 1 || hs == 2) : (vs == 2 && hs == 2); }

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) rounded
    const long one_half = 1L << 15;
    auto fix = [](double x) { return static_cast<long>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const long x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + one_half);
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One chroma row of the frame's width, upsampled as libjpeg's
// h2v2_fancy_upsample / h2v1_fancy_upsample do (edges replicated); planes
// 2 samples wide or less are replicated, as jinit_upsampler chooses.
void upsample_row(const Planes& p, int c, int y, std::vector<int>* sum, uint8_t* out) {
  const int cw = p.w[c], ch = p.h[c];
  const uint8_t* base = p.data[c];
  sum->resize(cw);
  int* cs = sum->data();
  if (p.hs == 2 && cw <= 2) {
    const uint8_t* r = base + static_cast<size_t>(p.vs == 2 ? y >> 1 : y) * p.stride[c];
    for (int x = 0; x < p.width; ++x) out[x] = r[x >> 1];
    return;
  }
  if (p.vs == 2) {
    const int i = y >> 1;
    const int nb = (y & 1) ? std::min(i + 1, ch - 1) : std::max(i - 1, 0);
    const uint8_t* r0 = base + static_cast<size_t>(i) * p.stride[c];
    const uint8_t* r1 = base + static_cast<size_t>(nb) * p.stride[c];
    for (int j = 0; j < cw; ++j) cs[j] = 3 * r0[j] + r1[j];
    for (int x = 0; x < p.width; ++x) {
      const int j = x >> 1;
      out[x] = (x & 1) ? static_cast<uint8_t>((3 * cs[j] + cs[std::min(j + 1, cw - 1)] + 7) >> 4)
                       : static_cast<uint8_t>((3 * cs[j] + cs[std::max(j - 1, 0)] + 8) >> 4);
    }
    return;
  }
  const uint8_t* r = base + static_cast<size_t>(y) * p.stride[c];
  if (p.hs == 1) {
    std::memcpy(out, r, p.width);
    return;
  }
  for (int x = 0; x < p.width; ++x) {
    const int j = x >> 1;
    out[x] = (x & 1) ? static_cast<uint8_t>((3 * r[j] + r[std::min(j + 1, cw - 1)] + 2) >> 2)
                     : static_cast<uint8_t>((3 * r[j] + r[std::max(j - 1, 0)] + 1) >> 2);
  }
}

// YCbCr planes -> interleaved RGB (jdcolor.c ycc_rgb_convert).
void planes_to_rgb(const Planes& p, std::vector<uint8_t>* pixels) {
  static const YccTables t;
  const int w = p.width, h = p.height;
  pixels->resize(static_cast<size_t>(w) * h * 3);
  std::vector<uint8_t> cb(w), cr(w);
  std::vector<int> sum;
  for (int y = 0; y < h; ++y) {
    upsample_row(p, 1, y, &sum, cb.data());
    upsample_row(p, 2, y, &sum, cr.data());
    const uint8_t* yr = p.data[0] + static_cast<size_t>(y) * p.stride[0];
    uint8_t* o = pixels->data() + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int Y = yr[x], b = cb[x], r = cr[x];
      o[3 * x + 0] = clamp255(Y + t.cr_r[r]);
      o[3 * x + 1] = clamp255(Y + ((t.cb_g[b] + t.cr_g[r]) >> 16));
      o[3 * x + 2] = clamp255(Y + t.cb_b[b]);
    }
  }
}

// Bilinear resize RGB u8 (h_in, w_in) -> (h_out, w_out), half-pixel centres.
void resize_bilinear(const uint8_t* src, int h_in, int w_in, uint8_t* dst,
                     int h_out, int w_out) {
  if (h_in == h_out && w_in == w_out) {
    std::memcpy(dst, src, static_cast<size_t>(h_in) * w_in * 3);
    return;
  }
  const float sy = static_cast<float>(h_in) / h_out;
  const float sx = static_cast<float>(w_in) / w_out;
  std::vector<int> x0(w_out), x1(w_out);
  std::vector<float> fx(w_out);
  for (int x = 0; x < w_out; ++x) {
    float pos = (x + 0.5f) * sx - 0.5f;
    pos = std::max(0.0f, std::min(pos, static_cast<float>(w_in - 1)));
    x0[x] = static_cast<int>(pos);
    x1[x] = std::min(x0[x] + 1, w_in - 1);
    fx[x] = pos - x0[x];
  }
  for (int y = 0; y < h_out; ++y) {
    float pos = (y + 0.5f) * sy - 0.5f;
    pos = std::max(0.0f, std::min(pos, static_cast<float>(h_in - 1)));
    const int y0 = static_cast<int>(pos);
    const int y1 = std::min(y0 + 1, h_in - 1);
    const float fy = pos - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * w_in * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * w_in * 3;
    uint8_t* out_row = dst + static_cast<size_t>(y) * w_out * 3;
    for (int x = 0; x < w_out; ++x) {
      const int xa = x0[x] * 3, xb = x1[x] * 3;
      const float gx = fx[x];
      for (int c = 0; c < 3; ++c) {
        const float top = r0[xa + c] + gx * (r0[xb + c] - r0[xa + c]);
        const float bot = r1[xa + c] + gx * (r1[xb + c] - r1[xa + c]);
        const float v = top + fy * (bot - top);
        out_row[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

#if defined(UD_JPEG_LIBJPEG)

const char kBackend[] = "libjpeg";

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

struct Decoder {
  bool init(int /*device*/) { return true; }

  std::vector<uint8_t> plane[3];

  bool decode(const uint8_t* blob, size_t size, std::vector<uint8_t>* pixels,
              int* height, int* width) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(blob), size);
    jpeg_read_header(&cinfo, TRUE);
    const jpeg_component_info* comp = cinfo.comp_info;
    const bool raw = cinfo.num_components == 3 && cinfo.jpeg_color_space == JCS_YCbCr &&
                     comp[0].h_samp_factor == cinfo.max_h_samp_factor &&
                     comp[0].v_samp_factor == cinfo.max_v_samp_factor &&
                     comp[1].h_samp_factor == 1 && comp[1].v_samp_factor == 1 &&
                     comp[2].h_samp_factor == 1 && comp[2].v_samp_factor == 1 &&
                     supported_layout(cinfo.max_h_samp_factor, cinfo.max_v_samp_factor);
    if (raw) {
      // the IDCT's planes, upsampled and converted by the shared code
      cinfo.raw_data_out = TRUE;
      jpeg_start_decompress(&cinfo);
      Planes p;
      p.width = cinfo.output_width;
      p.height = cinfo.output_height;
      p.hs = cinfo.max_h_samp_factor;
      p.vs = cinfo.max_v_samp_factor;
      std::vector<JSAMPROW> rows[3];
      for (int c = 0; c < 3; ++c) {
        const jpeg_component_info& cc = comp[c];
        p.stride[c] = static_cast<size_t>(cinfo.MCUs_per_row) * cc.h_samp_factor * DCTSIZE;
        const size_t n_rows = static_cast<size_t>(cinfo.total_iMCU_rows) * cc.v_samp_factor * DCTSIZE;
        plane[c].resize(p.stride[c] * n_rows);
        p.w[c] = cc.downsampled_width;
        p.h[c] = cc.downsampled_height;
        p.data[c] = plane[c].data();
        rows[c].resize(n_rows);
        for (size_t r = 0; r < n_rows; ++r) rows[c][r] = plane[c].data() + r * p.stride[c];
      }
      const int lines = cinfo.max_v_samp_factor * DCTSIZE;
      for (JDIMENSION imcu = 0; imcu < cinfo.total_iMCU_rows; ++imcu) {
        JSAMPARRAY at[3];
        for (int c = 0; c < 3; ++c) {
          at[c] = rows[c].data() + static_cast<size_t>(imcu) * comp[c].v_samp_factor * DCTSIZE;
        }
        jpeg_read_raw_data(&cinfo, at, lines);
      }
      jpeg_finish_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      planes_to_rgb(p, pixels);
      *height = p.height;
      *width = p.width;
      return true;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int w = cinfo.output_width, h = cinfo.output_height;
    pixels->resize(static_cast<size_t>(w) * h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row = pixels->data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *height = h;
    *width = w;
    return true;
  }
};

// Baseline JPEG of an RGB frame (libjpeg's defaults: 4:2:0 chroma, as
// cv2.imencode); returns the length, 0 on failure, or -needed if cap is short.
long encode(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, size_t cap,
            int /*device*/) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  unsigned char* buf = nullptr;
  unsigned long len = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::free(buf);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + static_cast<size_t>(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  long result = static_cast<long>(len);
  if (len > cap) {
    result = -result;
  } else {
    std::memcpy(out, buf, len);
  }
  std::free(buf);
  return result;
}

#else  // UD_JPEG_NVJPEG

const char kBackend[] = "nvjpeg";

nvjpegHandle_t shared_handle(int device) {
  static std::once_flag once;
  static nvjpegHandle_t handle = nullptr;
  std::call_once(once, [device] {
    if (cudaSetDevice(device) != cudaSuccess || nvjpegCreateSimple(&handle) != NVJPEG_STATUS_SUCCESS) {
      handle = nullptr;
    }
  });
  return handle;
}

// One worker's nvJPEG state, stream and buffers; never destroyed.
struct Context {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  uint8_t* host = nullptr;
  size_t host_bytes = 0;

  bool reserve(size_t bytes) {
    if (bytes > dev_bytes) {
      if (dev != nullptr) cudaFreeAsync(dev, stream);
      if (cudaMallocAsync(reinterpret_cast<void**>(&dev), bytes, stream) != cudaSuccess) {
        dev = nullptr;
        dev_bytes = 0;
        return false;
      }
      dev_bytes = bytes;
    }
    if (bytes > host_bytes) {
      if (host != nullptr) cudaFreeHost(host);
      if (cudaMallocHost(reinterpret_cast<void**>(&host), bytes) != cudaSuccess) {
        host = nullptr;
        host_bytes = 0;
        return false;
      }
      host_bytes = bytes;
    }
    return true;
  }
};

std::mutex pool_mutex;
std::vector<Context*> pool;

Context* take_context(nvjpegHandle_t handle) {
  {
    std::lock_guard<std::mutex> lock(pool_mutex);
    if (!pool.empty()) {
      Context* c = pool.back();
      pool.pop_back();
      return c;
    }
  }
  Context* c = new Context();
  if (cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) != cudaSuccess ||
      nvjpegJpegStateCreate(handle, &c->state) != NVJPEG_STATUS_SUCCESS) {
    return nullptr;  // leaked on purpose: a machine where this fails cannot decode
  }
  return c;
}

void give_back(Context* c) {
  std::lock_guard<std::mutex> lock(pool_mutex);
  pool.push_back(c);
}

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  Context* ctx = nullptr;

  bool init(int device) {
    if (cudaSetDevice(device) != cudaSuccess) return false;
    handle = shared_handle(device);
    if (handle == nullptr) return false;
    ctx = take_context(handle);
    return ctx != nullptr;
  }

  ~Decoder() {
    if (ctx != nullptr) give_back(ctx);
  }

  bool decode(const uint8_t* blob, size_t size, std::vector<uint8_t>* pixels,
              int* height, int* width) {
    int components = 0;
    nvjpegChromaSubsampling_t subsampling;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(handle, blob, size, &components, &subsampling, widths, heights) !=
        NVJPEG_STATUS_SUCCESS) {
      return false;
    }
    Planes p;
    p.width = widths[0];
    p.height = heights[0];
    bool planar = components == 3;
    if (subsampling == NVJPEG_CSS_444) {
      p.hs = 1, p.vs = 1;
    } else if (subsampling == NVJPEG_CSS_422) {
      p.hs = 2, p.vs = 1;
    } else if (subsampling == NVJPEG_CSS_420) {
      p.hs = 2, p.vs = 2;
    } else {
      planar = false;
    }
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    size_t bytes = 0;
    if (planar) {
      size_t offset[3];
      for (int c = 0; c < 3; ++c) {
        p.w[c] = widths[c];
        p.h[c] = heights[c];
        p.stride[c] = static_cast<size_t>(widths[c]);
        offset[c] = bytes;
        bytes += p.stride[c] * heights[c];
      }
      if (!ctx->reserve(bytes)) return false;
      for (int c = 0; c < 3; ++c) {
        img.channel[c] = ctx->dev + offset[c];
        img.pitch[c] = static_cast<unsigned int>(p.stride[c]);
        p.data[c] = ctx->host + offset[c];
      }
    } else {
      bytes = static_cast<size_t>(p.width) * p.height * 3;
      if (!ctx->reserve(bytes)) return false;
      img.channel[0] = ctx->dev;
      img.pitch[0] = static_cast<unsigned int>(p.width) * 3;
    }
    if (nvjpegDecode(handle, ctx->state, blob, size, planar ? NVJPEG_OUTPUT_YUV : NVJPEG_OUTPUT_RGBI,
                     &img, ctx->stream) != NVJPEG_STATUS_SUCCESS) {
      return false;
    }
    if (cudaMemcpyAsync(ctx->host, ctx->dev, bytes, cudaMemcpyDeviceToHost, ctx->stream) !=
            cudaSuccess ||
        cudaStreamSynchronize(ctx->stream) != cudaSuccess) {
      return false;
    }
    if (planar) {
      planes_to_rgb(p, pixels);
    } else {
      pixels->assign(ctx->host, ctx->host + bytes);
    }
    *height = p.height;
    *width = p.width;
    return true;
  }
};

// Baseline JPEG, 4:2:0 chroma (cv2.imencode's default), one at a time.
long encode(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, size_t cap, int device) {
  static std::mutex mutex;
  static nvjpegEncoderState_t state = nullptr;
  static nvjpegEncoderParams_t params = nullptr;
  static cudaStream_t stream = nullptr;
  static uint8_t* dev = nullptr;
  static size_t dev_bytes = 0;
  std::lock_guard<std::mutex> lock(mutex);
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  nvjpegHandle_t handle = shared_handle(device);
  if (handle == nullptr) return 0;
  if (state == nullptr) {
    if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) != cudaSuccess ||
        nvjpegEncoderStateCreate(handle, &state, stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsCreate(handle, &params, stream) != NVJPEG_STATUS_SUCCESS) {
      state = nullptr;
      return 0;
    }
  }
  const size_t bytes = static_cast<size_t>(w) * h * 3;
  if (bytes > dev_bytes) {
    if (dev != nullptr) cudaFreeAsync(dev, stream);
    if (cudaMallocAsync(reinterpret_cast<void**>(&dev), bytes, stream) != cudaSuccess) {
      dev = nullptr;
      dev_bytes = 0;
      return 0;
    }
    dev_bytes = bytes;
  }
  if (nvjpegEncoderParamsSetQuality(params, quality, stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(params, NVJPEG_CSS_420, stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(dev, rgb, bytes, cudaMemcpyHostToDevice, stream) != cudaSuccess) {
    return 0;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = dev;
  img.pitch[0] = static_cast<unsigned int>(w) * 3;
  if (nvjpegEncodeImage(handle, state, params, &img, NVJPEG_INPUT_RGBI, w, h, stream) !=
      NVJPEG_STATUS_SUCCESS) {
    return 0;
  }
  size_t len = 0;
  if (nvjpegEncodeRetrieveBitstream(handle, state, nullptr, &len, stream) !=
      NVJPEG_STATUS_SUCCESS) {
    return 0;
  }
  if (len > cap) {
    cudaStreamSynchronize(stream);
    return -static_cast<long>(len);
  }
  if (nvjpegEncodeRetrieveBitstream(handle, state, out, &len, stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(stream) != cudaSuccess) {
    return 0;
  }
  return static_cast<long>(len);
}

#endif

}  // namespace

extern "C" {

const char* ud_jpeg_backend() { return kBackend; }

// Decode `n` JPEG blobs, optionally crop each to boxes[i] = (x1, y1, x2, y2)
// (clamped; nullptr or x2 <= x1 for the full frame), resize to (out_h,
// out_w) and write RGB u8 into out (n * out_h * out_w * 3). `device` is the
// CUDA device of the nvJPEG backend. Returns the number of images decoded;
// a slot that failed is zero-filled.
int ud_decode_batch(const uint8_t** blobs, const size_t* sizes, int n,
                    const int* boxes, int out_h, int out_w, uint8_t* out,
                    int n_threads, int device) {
  std::atomic<int> next(0), ok(0);
  const size_t frame = static_cast<size_t>(out_h) * out_w * 3;
  auto worker = [&]() {
    Decoder decoder;
    const bool ready = decoder.init(device);
    std::vector<uint8_t> pixels, cropped;
    int h = 0, w = 0;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + static_cast<size_t>(i) * frame;
      if (!ready || !decoder.decode(blobs[i], sizes[i], &pixels, &h, &w)) {
        std::memset(dst, 0, frame);
        continue;
      }
      const uint8_t* src = pixels.data();
      int ch = h, cw = w;
      if (boxes != nullptr) {
        int x1 = boxes[i * 4 + 0], y1 = boxes[i * 4 + 1];
        int x2 = boxes[i * 4 + 2], y2 = boxes[i * 4 + 3];
        if (x2 > x1 && y2 > y1) {
          x1 = std::max(0, x1); y1 = std::max(0, y1);
          x2 = std::min(w, x2); y2 = std::min(h, y2);
          cw = x2 - x1; ch = y2 - y1;
          cropped.resize(static_cast<size_t>(cw) * ch * 3);
          for (int y = 0; y < ch; ++y) {
            std::memcpy(cropped.data() + static_cast<size_t>(y) * cw * 3,
                        pixels.data() + (static_cast<size_t>(y + y1) * w + x1) * 3,
                        static_cast<size_t>(cw) * 3);
          }
          src = cropped.data();
        }
      }
      resize_bilinear(src, ch, cw, dst, out_h, out_w);
      ok.fetch_add(1);
    }
  };
  const int threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

// Encode one RGB u8 frame (h, w, 3) at `quality` into out (cap bytes).
// Returns the JPEG's length; 0 on failure; -length when cap is too small.
long ud_encode_jpeg(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, size_t cap,
                    int device) {
  return encode(rgb, h, w, quality, out, cap, device);
}

}  // extern "C"
