// host_jpeg — batched JPEG and PNG decode + crop + resize, frame sizes, and
// JPEG encode, for the port's host data path (unidefense_tpu's native/udjpeg.cc and the
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
// Resize: bilinear or bicubic, half-pixel centres (cv2.resize's grid for
// INTER_LINEAR and INTER_CUBIC).
//
// PNG frames (Celeb-DF's) are decoded on the host by code of this file on
// both backends and then cropped and resized as the JPEG frames are.
//
// Encode (cv2.imencode's 4:2:0 baseline JPEG): both backends take the same
// host planes, libjpeg's colour conversion and chroma subsampling (Ycc420);
// libjpeg writes cv2's bytes from them, nvJPEG quantises them with the same
// IJG tables through its own forward DCT.

#include <algorithm>
#include <atomic>
#include <cmath>
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

// The four taps of each output position along one axis for cv2's
// INTER_CUBIC: Keys's kernel with A = -0.75 (interpolateCubic), source
// positions from cv2's double-precision scale, taps clamped to the edge.
void cubic_taps(int n_in, int n_out, std::vector<int>* at, std::vector<float>* weight) {
  const double scale = 1.0 / (static_cast<double>(n_out) / n_in);
  at->resize(static_cast<size_t>(n_out) * 4);
  weight->resize(static_cast<size_t>(n_out) * 4);
  const float a = -0.75f;
  for (int d = 0; d < n_out; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    const int s = static_cast<int>(std::floor(f));
    f -= static_cast<float>(s);
    float* w = weight->data() + static_cast<size_t>(d) * 4;
    w[0] = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a;
    w[1] = ((a + 2) * f - (a + 3)) * f * f + 1;
    w[2] = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1;
    w[3] = 1.f - w[0] - w[1] - w[2];
    for (int k = 0; k < 4; ++k) {
      (*at)[static_cast<size_t>(d) * 4 + k] = std::min(std::max(s - 1 + k, 0), n_in - 1);
    }
  }
}

// Bicubic resize RGB u8 (h_in, w_in) -> (h_out, w_out) as cv2.resize's
// INTER_CUBIC computes it for 8-bit frames: float weights, a horizontal pass
// into float rows, a vertical pass, then round to nearest and saturate.
void resize_cubic(const uint8_t* src, int h_in, int w_in, uint8_t* dst, int h_out, int w_out) {
  if (h_in == h_out && w_in == w_out) {
    std::memcpy(dst, src, static_cast<size_t>(h_in) * w_in * 3);
    return;
  }
  std::vector<int> xs, ys;
  std::vector<float> wx, wy;
  cubic_taps(w_in, w_out, &xs, &wx);
  cubic_taps(h_in, h_out, &ys, &wy);
  const size_t row = static_cast<size_t>(w_out) * 3;
  std::vector<float> rows(static_cast<size_t>(h_in) * row);
  for (int y = 0; y < h_in; ++y) {
    const uint8_t* s = src + static_cast<size_t>(y) * w_in * 3;
    float* r = rows.data() + static_cast<size_t>(y) * row;
    for (int x = 0; x < w_out; ++x) {
      const int* at = xs.data() + static_cast<size_t>(x) * 4;
      const float* w = wx.data() + static_cast<size_t>(x) * 4;
      for (int c = 0; c < 3; ++c) {
        float v = s[at[0] * 3 + c] * w[0];
        v += s[at[1] * 3 + c] * w[1];
        v += s[at[2] * 3 + c] * w[2];
        v += s[at[3] * 3 + c] * w[3];
        r[x * 3 + c] = v;
      }
    }
  }
  for (int y = 0; y < h_out; ++y) {
    const int* at = ys.data() + static_cast<size_t>(y) * 4;
    const float* w = wy.data() + static_cast<size_t>(y) * 4;
    const float* r0 = rows.data() + static_cast<size_t>(at[0]) * row;
    const float* r1 = rows.data() + static_cast<size_t>(at[1]) * row;
    const float* r2 = rows.data() + static_cast<size_t>(at[2]) * row;
    const float* r3 = rows.data() + static_cast<size_t>(at[3]) * row;
    uint8_t* o = dst + static_cast<size_t>(y) * row;
    for (size_t i = 0; i < row; ++i) {
      float v = r0[i] * w[0];
      v += r1[i] * w[1];
      v += r2[i] * w[2];
      v += r3[i] * w[3];
      o[i] = clamp255(static_cast<int>(std::lrint(v)));
    }
  }
}

// An RGB frame as the three planes libjpeg's compressor hands its forward
// DCT at 4:2:0 (jpeg_set_defaults, libjpeg-turbo): the fixed-point
// RGB -> YCbCr of jccolor.c; the right and bottom edges replicated
// (expand_right_edge and expand_bottom_edge of jcsample.c and jcprepct.c);
// the chroma averaged over 2x2 pixels with the bias 1, 2, 1, 2, ... of
// h2v2_downsample. Y is padded to whole blocks across and whole 16-row
// iMCUs down, Cb and Cr (half as wide and high) to whole blocks and 8-row
// iMCUs: what jpeg_write_raw_data takes. Both encoders start from these
// planes, so the nvJPEG encoder converts and subsamples as libjpeg does.
struct Ycc420 {
  int yw, yh, cw, ch;
  std::vector<uint8_t> y, cb, cr;

  Ycc420(const uint8_t* rgb, int h, int w)
      : yw((w + 7) / 8 * 8), yh((h + 15) / 16 * 16), cw((w + 15) / 16 * 8),
        ch((h + 15) / 16 * 8) {
    auto fix = [](double x) { return static_cast<long>(x * 65536.0 + 0.5); };
    const long one_half = 1L << 15, cbcr_offset = 128L << 16;
    const long ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const long rcb = -fix(0.16874), gcb = -fix(0.33126), half = fix(0.50000);
    const long gcr = -fix(0.41869), bcr = -fix(0.08131);
    // full-resolution YCbCr of the frame's rows, columns replicated to
    // 2 * cw (>= yw)
    const int fw = 2 * cw;
    std::vector<uint8_t> full[3];
    for (auto& plane : full) plane.resize(static_cast<size_t>(fw) * h);
    for (int r = 0; r < h; ++r) {
      for (int x = 0; x < fw; ++x) {
        const uint8_t* px = rgb + (static_cast<size_t>(r) * w + std::min(x, w - 1)) * 3;
        const long cr_ = px[0], cg = px[1], cb_ = px[2];
        const size_t at = static_cast<size_t>(r) * fw + x;
        full[0][at] = static_cast<uint8_t>((ry * cr_ + gy * cg + by * cb_ + one_half) >> 16);
        full[1][at] = static_cast<uint8_t>(
            (rcb * cr_ + gcb * cg + half * cb_ + cbcr_offset + one_half - 1) >> 16);
        full[2][at] = static_cast<uint8_t>(
            (half * cr_ + gcr * cg + bcr * cb_ + cbcr_offset + one_half - 1) >> 16);
      }
    }
    y.resize(static_cast<size_t>(yw) * yh);
    for (int r = 0; r < yh; ++r) {
      std::memcpy(&y[static_cast<size_t>(r) * yw],
                  &full[0][static_cast<size_t>(std::min(r, h - 1)) * fw], yw);
    }
    const int rows = (h + 1) / 2;  // chroma rows computed; the rest replicate the last
    for (int c = 1; c < 3; ++c) {
      std::vector<uint8_t>& out = c == 1 ? cb : cr;
      out.resize(static_cast<size_t>(cw) * ch);
      for (int r = 0; r < ch; ++r) {
        const int cr0 = std::min(r, rows - 1);
        const uint8_t* in0 = &full[c][static_cast<size_t>(2 * cr0) * fw];
        const uint8_t* in1 = &full[c][static_cast<size_t>(std::min(2 * cr0 + 1, h - 1)) * fw];
        uint8_t* o = &out[static_cast<size_t>(r) * cw];
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          o[x] = static_cast<uint8_t>((in0[2 * x] + in0[2 * x + 1] + in1[2 * x] + in1[2 * x + 1] +
                                       bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }
};

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

// The frame's size from its header alone.
bool read_dims(const uint8_t* blob, size_t size, int /*device*/, int* height, int* width) {
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
  *height = static_cast<int>(cinfo.image_height);
  *width = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Baseline JPEG of an RGB frame (libjpeg's defaults: 4:2:0 chroma, as
// cv2.imencode), fed as the Ycc420 planes through jpeg_write_raw_data: the
// bytes libjpeg writes from the RGB scanlines, so the planes are checked
// against libjpeg's own conversion wherever this backend is built. Returns
// the length, 0 on failure, or -needed if cap is short.
long encode(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, size_t cap,
            int /*device*/) {
  Ycc420 planes(rgb, h, w);
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
  cinfo.raw_data_in = TRUE;
  jpeg_start_compress(&cinfo, TRUE);
  JSAMPROW rows[3][16];
  JSAMPARRAY image[3] = {rows[0], rows[1], rows[2]};
  for (int r0 = 0; r0 < planes.yh; r0 += 16) {
    for (int i = 0; i < 16; ++i) rows[0][i] = &planes.y[static_cast<size_t>(r0 + i) * planes.yw];
    for (int i = 0; i < 8; ++i) {
      const size_t at = static_cast<size_t>(r0 / 2 + i) * planes.cw;
      rows[1][i] = &planes.cb[at];
      rows[2][i] = &planes.cr[at];
    }
    jpeg_write_raw_data(&cinfo, image, 16);
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

// The frame's size from its header alone (nvjpegGetImageInfo).
bool read_dims(const uint8_t* blob, size_t size, int device, int* height, int* width) {
  if (cudaSetDevice(device) != cudaSuccess) return false;
  nvjpegHandle_t handle = shared_handle(device);
  if (handle == nullptr) return false;
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(handle, blob, size, &components, &subsampling, widths, heights) !=
      NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  *height = heights[0];
  *width = widths[0];
  return true;
}

// Baseline JPEG, 4:2:0 chroma (cv2.imencode's default), one at a time: the
// Ycc420 planes (libjpeg's colour conversion and subsampling, on the host)
// through nvjpegEncodeYUV: nvJPEG's own RGB path converts and subsamples
// otherwise, and its round trip strays from libjpeg's (chip_smoke.py's
// [jpeg] line measures the gap). nvJPEG's forward DCT remains its own.
long encode(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, size_t cap, int device) {
  Ycc420 planes(rgb, h, w);
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
  const size_t y_bytes = planes.y.size(), c_bytes = planes.cb.size();
  const size_t bytes = y_bytes + 2 * c_bytes;
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
      cudaMemcpyAsync(dev, planes.y.data(), y_bytes, cudaMemcpyHostToDevice, stream) !=
          cudaSuccess ||
      cudaMemcpyAsync(dev + y_bytes, planes.cb.data(), c_bytes, cudaMemcpyHostToDevice,
                      stream) != cudaSuccess ||
      cudaMemcpyAsync(dev + y_bytes + c_bytes, planes.cr.data(), c_bytes,
                      cudaMemcpyHostToDevice, stream) != cudaSuccess) {
    return 0;
  }
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = dev;
  img.channel[1] = dev + y_bytes;
  img.channel[2] = dev + y_bytes + c_bytes;
  img.pitch[0] = static_cast<unsigned int>(planes.yw);
  img.pitch[1] = img.pitch[2] = static_cast<unsigned int>(planes.cw);
  if (nvjpegEncodeYUV(handle, state, params, &img, NVJPEG_CSS_420, w, h, stream) !=
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

// ---- PNG, on the host for both backends: the frames of Celeb-DF. A decoder
// of its own (RFC 1950/1951 inflate, the five row filters, every colour
// type) so that the library needs neither libpng nor zlib. The frame comes
// out as cv2.imdecode(..., IMREAD_COLOR) gives it, in RGB: alpha dropped,
// grey replicated, palettes looked up, grey of 1, 2 or 4 bits scaled to 8,
// 16-bit samples cut to their high byte. An interlaced (Adam7) frame is
// seven reduced images in turn, each unfiltered with its own row width and
// scattered into the frame.

const uint8_t kPngSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};

bool is_png(const uint8_t* blob, size_t size) {
  return size >= 8 && std::memcmp(blob, kPngSignature, 8) == 0;
}

uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

uint32_t png_crc(const uint8_t* p, size_t n) {
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// LSB-first bits of a deflate stream; reading past its end yields zeros and
// is caught by overran().
struct BitReader {
  const uint8_t* p;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int count = 0;
  BitReader(const uint8_t* data, size_t size) : p(data), n(size) {}
  void fill() {
    while (count <= 56) {
      buf |= static_cast<uint64_t>(pos < n ? p[pos] : 0) << count;
      ++pos;
      count += 8;
    }
  }
  uint32_t peek(int k) {
    if (count < k) fill();
    return static_cast<uint32_t>(buf & ((1ull << k) - 1));
  }
  void drop(int k) { buf >>= k; count -= k; }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    drop(k);
    return v;
  }
  void align() { drop(count % 8); }
  size_t consumed_bytes() const { return pos - count / 8; }  // after align()
  bool overran() const { return pos * 8 - count > n * 8; }
};

// A canonical Huffman code as one 15-bit lookup: entry (length << 16) |
// symbol at every index whose low `length` bits are the reversed code; 0
// where no code lies (an incomplete code).
constexpr int kHuffBits = 15;

bool build_huffman(const uint8_t* lengths, int n, std::vector<uint32_t>* table) {
  int count[kHuffBits + 1] = {0};
  for (int i = 0; i < n; ++i) ++count[lengths[i]];
  count[0] = 0;
  int left = 1;
  for (int len = 1; len <= kHuffBits; ++len) {
    left = (left << 1) - count[len];
    if (left < 0) return false;  // over-subscribed
  }
  int next[kHuffBits + 1] = {0};
  for (int len = 1, code = 0; len <= kHuffBits; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  table->assign(1u << kHuffBits, 0);
  for (int sym = 0; sym < n; ++sym) {
    const int len = lengths[sym];
    if (len == 0) continue;
    const int code = next[len]++;
    int rev = 0;
    for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
    const uint32_t entry = (static_cast<uint32_t>(len) << 16) | static_cast<uint32_t>(sym);
    for (int k = rev; k < (1 << kHuffBits); k += 1 << len) (*table)[k] = entry;
  }
  return true;
}

inline int huffman_symbol(BitReader* br, const std::vector<uint32_t>& table) {
  const uint32_t entry = table[br->peek(kHuffBits)];
  if (entry == 0) return -1;
  br->drop(static_cast<int>(entry >> 16));
  return static_cast<int>(entry & 0xFFFF);
}

// A zlib stream (RFC 1950) into out, at most `cap` bytes: its header, the
// deflate blocks (stored, fixed and dynamic codes), its Adler-32.
bool inflate_zlib(const uint8_t* in, size_t n, size_t cap, std::vector<uint8_t>* out) {
  static const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                        31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
  static const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                        2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
  static const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                         33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                         1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385,
                                         24577};
  static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                         6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
  static const uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  if (n < 6 || (in[0] & 0x0F) != 8 || (in[0] >> 4) > 7 || (in[1] & 0x20) != 0 ||
      ((in[0] << 8) | in[1]) % 31 != 0) {
    return false;
  }
  BitReader br(in + 2, n - 2);
  std::vector<uint32_t> lit, dist;
  out->resize(cap);
  uint8_t* o = out->data();
  size_t size = 0;
  for (bool last = false; !last;) {
    last = br.get(1) != 0;
    const uint32_t type = br.get(2);
    if (type == 0) {
      br.align();
      const uint32_t len = br.get(16), nlen = br.get(16);
      if ((len ^ 0xFFFF) != nlen || size + len > cap) return false;
      for (uint32_t i = 0; i < len; ++i) o[size++] = static_cast<uint8_t>(br.get(8));
      if (br.overran()) return false;
      continue;
    }
    uint8_t lengths[320];
    int n_lit = 288, n_dist = 30;
    if (type == 1) {
      for (int i = 0; i < 288; ++i) lengths[i] = i < 144 ? 8 : (i < 256 ? 9 : (i < 280 ? 7 : 8));
      for (int i = 0; i < 30; ++i) lengths[288 + i] = 5;
    } else if (type == 2) {
      n_lit = static_cast<int>(br.get(5)) + 257;
      n_dist = static_cast<int>(br.get(5)) + 1;
      const int n_cl = static_cast<int>(br.get(4)) + 4;
      if (n_lit > 286 || n_dist > 30) return false;
      uint8_t cl[19] = {0};
      for (int i = 0; i < n_cl; ++i) cl[kClOrder[i]] = static_cast<uint8_t>(br.get(3));
      std::vector<uint32_t> cl_table;
      if (!build_huffman(cl, 19, &cl_table)) return false;
      for (int i = 0; i < n_lit + n_dist;) {
        const int sym = huffman_symbol(&br, cl_table);
        int repeat = 0;
        uint8_t value = 0;
        if (sym < 0) return false;
        if (sym < 16) {
          lengths[i++] = static_cast<uint8_t>(sym);
          continue;
        } else if (sym == 16) {
          if (i == 0) return false;
          value = lengths[i - 1];
          repeat = 3 + static_cast<int>(br.get(2));
        } else if (sym == 17) {
          repeat = 3 + static_cast<int>(br.get(3));
        } else {
          repeat = 11 + static_cast<int>(br.get(7));
        }
        if (i + repeat > n_lit + n_dist) return false;
        while (repeat-- > 0) lengths[i++] = value;
      }
      if (lengths[256] == 0) return false;  // no end-of-block code
    } else {
      return false;
    }
    if (!build_huffman(lengths, n_lit, &lit) || !build_huffman(lengths + n_lit, n_dist, &dist)) {
      return false;
    }
    for (;;) {
      const int sym = huffman_symbol(&br, lit);
      if (sym < 0 || br.overran()) return false;
      if (sym < 256) {
        if (size >= cap) return false;
        o[size++] = static_cast<uint8_t>(sym);
        continue;
      }
      if (sym == 256) break;
      const int li = sym - 257;
      if (li >= 29) return false;
      // the length's extra bits come before the distance's code
      const size_t len = kLenBase[li] + br.get(kLenExtra[li]);
      const int di = huffman_symbol(&br, dist);
      if (di < 0 || di >= 30) return false;
      const size_t d = kDistBase[di] + br.get(kDistExtra[di]);
      if (d > size || size + len > cap) return false;
      for (size_t k = 0; k < len; ++k, ++size) o[size] = o[size - d];
    }
  }
  br.align();
  if (br.overran()) return false;
  const size_t at = 2 + br.consumed_bytes();
  if (at + 4 > n) return false;
  out->resize(size);
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < size;) {  // 5552: the most bytes before b can overflow
    for (const size_t end = std::min(size, i + 5552); i < end; ++i) {
      a += o[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return ((b << 16) | a) == be32(in + at);
}

struct PngHeader {
  int width = 0, height = 0, depth = 0, colour = 0, channels = 0;
  bool interlaced = false;
};

// The IHDR of a PNG blob: the size and the sample layout, checked.
bool png_header(const uint8_t* blob, size_t size, PngHeader* hd) {
  if (!is_png(blob, size) || size < 33 || be32(blob + 8) != 13 ||
      std::memcmp(blob + 12, "IHDR", 4) != 0 || png_crc(blob + 12, 17) != be32(blob + 29)) {
    return false;
  }
  const uint8_t* d = blob + 16;
  const uint32_t w = be32(d), h = be32(d + 4);
  hd->depth = d[8];
  hd->colour = d[9];
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  if (w == 0 || h == 0 || w > (1u << 16) || h > (1u << 16) || hd->colour > 6 ||
      kChannels[hd->colour] == 0 || d[10] != 0 || d[11] != 0 || d[12] > 1) {
    return false;  // compression and filter method 0; interlace 0 or 1 (Adam7)
  }
  hd->interlaced = d[12] == 1;
  const int depth = hd->depth;
  const bool ok_depth = hd->colour == 0 ? (depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                                           depth == 16)
                                        : (hd->colour == 3 ? (depth == 1 || depth == 2 ||
                                                              depth == 4 || depth == 8)
                                                           : (depth == 8 || depth == 16));
  if (!ok_depth) return false;
  hd->width = static_cast<int>(w);
  hd->height = static_cast<int>(h);
  hd->channels = kChannels[hd->colour];
  return true;
}

// Decode a PNG blob into interleaved RGB u8.
bool decode_png(const uint8_t* blob, size_t size, std::vector<uint8_t>* pixels, int* height,
                int* width) {
  PngHeader hd;
  if (!png_header(blob, size, &hd)) return false;
  std::vector<uint8_t> idat, palette;
  bool ended = false;
  for (size_t at = 8; !ended;) {
    if (at + 12 > size) return false;
    const uint32_t len = be32(blob + at);
    if (len > size - at - 12) return false;
    const uint8_t* type = blob + at + 4;
    const uint8_t* data = blob + at + 8;
    const bool critical = (type[0] & 0x20) == 0;
    if (critical && png_crc(type, len + 4) != be32(data + len)) return false;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len == 0 || len > 768) return false;
      palette.assign(data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      ended = true;
    } else if (critical && std::memcmp(type, "IHDR", 4) != 0) {
      return false;  // an unknown critical chunk
    } else if (critical && at != 8) {
      return false;  // a second IHDR
    }
    at += 12 + static_cast<size_t>(len);
  }
  if (hd.colour == 3 && palette.empty()) return false;
  const int w = hd.width, h = hd.height, depth = hd.depth, ch = hd.channels;
  // the reduced images in stream order: (x0, y0, dx, dy) of Adam7's seven
  // passes, or one pass of the whole frame
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = hd.interlaced ? kAdam7 : kWhole;
  const int num_passes = hd.interlaced ? 7 : 1;
  const size_t bpp = std::max<size_t>(1, static_cast<size_t>(ch) * depth / 8);
  size_t raw_size = 0;
  for (int p = 0; p < num_passes; ++p) {
    const size_t pw = (w - passes[p][0] + passes[p][2] - 1) / passes[p][2];
    const size_t ph = (h - passes[p][1] + passes[p][3] - 1) / passes[p][3];
    if (pw > 0 && ph > 0) raw_size += ph * ((pw * ch * depth + 7) / 8 + 1);
  }
  std::vector<uint8_t> raw;
  // libpng tolerates data past the last row; allow up to 64 KiB of it
  if (!inflate_zlib(idat.data(), idat.size(), raw_size + 65536, &raw) || raw.size() < raw_size) {
    return false;
  }
  pixels->resize(static_cast<size_t>(w) * h * 3);
  const int scale = depth >= 8 ? 1 : 255 / ((1 << depth) - 1);
  uint8_t* at = raw.data();
  for (int p = 0; p < num_passes; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;  // an empty pass has no rows, not even filter bytes
    const size_t stride = (static_cast<size_t>(pw) * ch * depth + 7) / 8;
    // undo the row filters in place (each row's filter byte, then its bytes)
    std::vector<uint8_t> zero(stride, 0);
    for (int y = 0; y < ph; ++y) {
      uint8_t* row = at + static_cast<size_t>(y) * (stride + 1);
      const uint8_t filter = row[0];
      uint8_t* cur = row + 1;
      const uint8_t* up = y > 0 ? cur - (stride + 1) : zero.data();
      switch (filter) {
        case 0:
          break;
        case 1:
          for (size_t x = bpp; x < stride; ++x) cur[x] = static_cast<uint8_t>(cur[x] + cur[x - bpp]);
          break;
        case 2:
          for (size_t x = 0; x < stride; ++x) cur[x] = static_cast<uint8_t>(cur[x] + up[x]);
          break;
        case 3:
          for (size_t x = 0; x < stride; ++x) {
            const int left = x >= bpp ? cur[x - bpp] : 0;
            cur[x] = static_cast<uint8_t>(cur[x] + ((left + up[x]) >> 1));
          }
          break;
        case 4:
          for (size_t x = 0; x < stride; ++x) {
            const int a = x >= bpp ? cur[x - bpp] : 0, b = up[x], c = x >= bpp ? up[x - bpp] : 0;
            const int q = a + b - c, pa = std::abs(q - a), pb = std::abs(q - b),
                      pc = std::abs(q - c);
            const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            cur[x] = static_cast<uint8_t>(cur[x] + pred);
          }
          break;
        default:
          return false;
      }
    }
    // samples -> RGB, each into its place in the frame
    for (int y = 0; y < ph; ++y) {
      const uint8_t* src = at + static_cast<size_t>(y) * (stride + 1) + 1;
      uint8_t* dst_row = pixels->data() + static_cast<size_t>(y0 + y * dy) * w * 3;
      for (int x = 0; x < pw; ++x) {
        uint8_t* dst = dst_row + static_cast<size_t>(x0 + x * dx) * 3;
        if (depth < 8) {
          const int bit = x * depth;
          const int v = (src[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
          if (hd.colour == 3) {
            if (3 * v + 2 >= static_cast<int>(palette.size())) return false;
            std::memcpy(dst, &palette[3 * v], 3);
          } else {
            dst[0] = dst[1] = dst[2] = static_cast<uint8_t>(v * scale);
          }
          continue;
        }
        const int step = depth / 8;  // the high byte comes first
        const uint8_t* s = src + static_cast<size_t>(x) * ch * step;
        if (hd.colour == 3) {
          if (3 * s[0] + 2 >= static_cast<int>(palette.size())) return false;
          std::memcpy(dst, &palette[3 * s[0]], 3);
        } else if (ch >= 3) {
          dst[0] = s[0];
          dst[1] = s[step];
          dst[2] = s[2 * step];
        } else {
          dst[0] = dst[1] = dst[2] = s[0];
        }
      }
    }
    at += static_cast<size_t>(ph) * (stride + 1);
  }
  *height = h;
  *width = w;
  return true;
}

}  // namespace

extern "C" {

const char* ud_jpeg_backend() { return kBackend; }

// Decode `n` JPEG or PNG blobs, optionally crop each to boxes[i] = (x1, y1, x2, y2)
// (clamped; nullptr or x2 <= x1 for the full frame), resize to (out_h,
// out_w) with `interp` (cv2's codes: 1 bilinear, 2 bicubic) and write RGB u8
// into out (n * out_h * out_w * 3). `device` is the CUDA device of the
// nvJPEG backend. Returns the number of images decoded, a slot that failed
// zero-filled; -1 for another interp.
int ud_decode_batch(const uint8_t** blobs, const size_t* sizes, int n,
                    const int* boxes, int out_h, int out_w, uint8_t* out,
                    int n_threads, int device, int interp) {
  if (interp != 1 && interp != 2) return -1;
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
      const bool decoded = is_png(blobs[i], sizes[i])
                               ? decode_png(blobs[i], sizes[i], &pixels, &h, &w)
                               : ready && decoder.decode(blobs[i], sizes[i], &pixels, &h, &w);
      if (!decoded) {
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
      if (interp == 2) {
        resize_cubic(src, ch, cw, dst, out_h, out_w);
      } else {
        resize_bilinear(src, ch, cw, dst, out_h, out_w);
      }
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

// Read the (height, width) of `n` JPEG or PNG blobs from their headers into
// dims[2 * i], dims[2 * i + 1]. Returns the number read; a blob whose header
// does not parse gets (0, 0).
int ud_jpeg_dims(const uint8_t** blobs, const size_t* sizes, int n, int* dims, int device) {
  int ok = 0;
  for (int i = 0; i < n; ++i) {
    int h = 0, w = 0;
    PngHeader png;
    if (is_png(blobs[i], sizes[i]) ? png_header(blobs[i], sizes[i], &png)
                                   : read_dims(blobs[i], sizes[i], device, &h, &w)) {
      if (png.width > 0) {
        h = png.height;
        w = png.width;
      }
      ++ok;
    } else {
      h = w = 0;
    }
    dims[2 * i] = h;
    dims[2 * i + 1] = w;
  }
  return ok;
}

// Encode one RGB u8 frame (h, w, 3) at `quality` into out (cap bytes).
// Returns the JPEG's length; 0 on failure; -length when cap is too small.
long ud_encode_jpeg(const uint8_t* rgb, int h, int w, int quality, uint8_t* out, size_t cap,
                    int device) {
  return encode(rgb, h, w, quality, out, cap, device);
}

}  // extern "C"
