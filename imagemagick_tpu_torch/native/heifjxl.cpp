// heifjxl.cpp — HEIC/HEIF + JPEG-XL codec bindings for the native runtime.
//
// Role parity: ImageMagick's coders/heic.c (1,529 LoC over libheif) and
// coders/jxl.c (1,236 LoC over libjxl), re-provided as a thin dlopen layer
// over the SAME system libraries (libheif.so.1, libjxl.so.0.7).  dlopen +
// hand-declared stable C ABI avoids a build-time dependency on dev headers
// (absent in this image); every entry degrades to a nonzero return code
// when a library or encoder is missing, and the Python layer falls back
// or reports the format read-only.
//
// Build: g++ -O3 -fPIC -shared heifjxl.cpp -ldl

#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// libheif stable ABI subset (enum values from the public heif.h contract)
// ---------------------------------------------------------------------------

struct heif_error {
  int code;
  int subcode;
  const char *message;
};

enum {
  HJ_HEIF_COLORSPACE_RGB = 1,
  HJ_HEIF_CHROMA_INTERLEAVED_RGB = 10,
  HJ_HEIF_CHROMA_INTERLEAVED_RGBA = 11,
  HJ_HEIF_CHANNEL_INTERLEAVED = 10,
  HJ_HEIF_COMPRESSION_HEVC = 1,
};

typedef void *(*p_heif_context_alloc)(void);
typedef void (*p_heif_context_free)(void *);
typedef heif_error (*p_heif_read_mem)(void *, const void *, size_t,
                                      const void *);
typedef heif_error (*p_heif_get_primary)(void *, void **);
typedef int (*p_heif_handle_int)(const void *);
typedef heif_error (*p_heif_decode)(const void *, void **, int, int,
                                    const void *);
typedef const uint8_t *(*p_heif_get_plane_ro)(const void *, int, int *);
typedef uint8_t *(*p_heif_get_plane)(void *, int, int *);
typedef void (*p_heif_release)(void *);
typedef heif_error (*p_heif_get_encoder)(void *, int, void **);
typedef heif_error (*p_heif_image_create)(int, int, int, int, void **);
typedef heif_error (*p_heif_add_plane)(void *, int, int, int, int);
typedef heif_error (*p_heif_encode_image)(void *, const void *, void *,
                                          const void *, void **);
struct heif_writer {
  int writer_api_version;
  heif_error (*write)(void *ctx, const void *data, size_t size,
                      void *userdata);
};
typedef heif_error (*p_heif_write)(void *, heif_writer *, void *);
typedef void (*p_heif_encoder_release)(void *);

static void *heif_lib(void) {
  static void *h = dlopen("libheif.so.1", RTLD_NOW | RTLD_LOCAL);
  return h;
}

#define HJ_SYM(lib, type, name)                     \
  type name = (type)dlsym(lib, #name);              \
  if (!(name)) return -1;

int hj_heif_available(void) { return heif_lib() != nullptr; }

// Decode primary image -> interleaved u8 RGB(A).  Caller frees *out.
int hj_decode_heif(const uint8_t *data, size_t size, uint8_t **out,
                   int *ow, int *oh, int *oc) {
  void *lib = heif_lib();
  if (!lib) return -1;
  HJ_SYM(lib, p_heif_context_alloc, heif_context_alloc);
  HJ_SYM(lib, p_heif_context_free, heif_context_free);
  HJ_SYM(lib, p_heif_read_mem, heif_context_read_from_memory_without_copy);
  HJ_SYM(lib, p_heif_get_primary, heif_context_get_primary_image_handle);
  HJ_SYM(lib, p_heif_handle_int, heif_image_handle_get_width);
  HJ_SYM(lib, p_heif_handle_int, heif_image_handle_get_height);
  HJ_SYM(lib, p_heif_handle_int, heif_image_handle_has_alpha_channel);
  HJ_SYM(lib, p_heif_decode, heif_decode_image);
  HJ_SYM(lib, p_heif_get_plane_ro, heif_image_get_plane_readonly);
  HJ_SYM(lib, p_heif_release, heif_image_release);
  HJ_SYM(lib, p_heif_release, heif_image_handle_release);

  void *ctx = heif_context_alloc();
  if (!ctx) return -2;
  heif_error err =
      heif_context_read_from_memory_without_copy(ctx, data, size, nullptr);
  if (err.code) {
    heif_context_free(ctx);
    return -3;
  }
  void *handle = nullptr;
  err = heif_context_get_primary_image_handle(ctx, &handle);
  if (err.code || !handle) {
    heif_context_free(ctx);
    return -4;
  }
  int w = heif_image_handle_get_width(handle);
  int h = heif_image_handle_get_height(handle);
  int has_alpha = heif_image_handle_has_alpha_channel(handle);
  int channels = has_alpha ? 4 : 3;
  void *img = nullptr;
  err = heif_decode_image(handle, &img, HJ_HEIF_COLORSPACE_RGB,
                          has_alpha ? HJ_HEIF_CHROMA_INTERLEAVED_RGBA
                                    : HJ_HEIF_CHROMA_INTERLEAVED_RGB,
                          nullptr);
  if (err.code || !img) {
    heif_image_handle_release(handle);
    heif_context_free(ctx);
    return -5;
  }
  int stride = 0;
  const uint8_t *plane = heif_image_get_plane_readonly(
      img, HJ_HEIF_CHANNEL_INTERLEAVED, &stride);
  if (!plane || w <= 0 || h <= 0) {
    heif_image_release(img);
    heif_image_handle_release(handle);
    heif_context_free(ctx);
    return -6;
  }
  uint8_t *buf = (uint8_t *)malloc((size_t)w * h * channels);
  if (!buf) return -7;
  for (int y = 0; y < h; y++)
    memcpy(buf + (size_t)y * w * channels, plane + (size_t)y * stride,
           (size_t)w * channels);
  heif_image_release(img);
  heif_image_handle_release(handle);
  heif_context_free(ctx);
  *out = buf;
  *ow = w;
  *oh = h;
  *oc = channels;
  return 0;
}

struct hj_membuf {
  uint8_t *data;
  size_t size;
  size_t cap;
};

static heif_error hj_mem_write(void *, const void *data, size_t size,
                               void *userdata) {
  hj_membuf *b = (hj_membuf *)userdata;
  if (b->size + size > b->cap) {
    size_t ncap = (b->cap ? b->cap * 2 : 1 << 16);
    while (ncap < b->size + size) ncap *= 2;
    b->data = (uint8_t *)realloc(b->data, ncap);
    b->cap = ncap;
  }
  memcpy(b->data + b->size, data, size);
  b->size += size;
  heif_error ok = {0, 0, nullptr};
  return ok;
}

// Encode interleaved u8 RGB(A) -> HEIC bytes.  Returns nonzero when no
// HEVC encoder plugin is present (read-only support then).
int hj_encode_heif(const uint8_t *data, int w, int h, int channels,
                   int quality, uint8_t **out, size_t *out_size) {
  void *lib = heif_lib();
  if (!lib) return -1;
  HJ_SYM(lib, p_heif_context_alloc, heif_context_alloc);
  HJ_SYM(lib, p_heif_context_free, heif_context_free);
  HJ_SYM(lib, p_heif_get_encoder, heif_context_get_encoder_for_format);
  HJ_SYM(lib, p_heif_image_create, heif_image_create);
  HJ_SYM(lib, p_heif_add_plane, heif_image_add_plane);
  HJ_SYM(lib, p_heif_get_plane, heif_image_get_plane);
  HJ_SYM(lib, p_heif_encode_image, heif_context_encode_image);
  HJ_SYM(lib, p_heif_write, heif_context_write);
  HJ_SYM(lib, p_heif_release, heif_image_release);
  HJ_SYM(lib, p_heif_release, heif_image_handle_release);
  HJ_SYM(lib, p_heif_encoder_release, heif_encoder_release);
  typedef heif_error (*p_set_q)(void *, int);
  p_set_q heif_encoder_set_lossy_quality =
      (p_set_q)dlsym(lib, "heif_encoder_set_lossy_quality");

  void *ctx = heif_context_alloc();
  if (!ctx) return -2;
  void *encoder = nullptr;
  heif_error err = heif_context_get_encoder_for_format(
      ctx, HJ_HEIF_COMPRESSION_HEVC, &encoder);
  if (err.code || !encoder) {
    heif_context_free(ctx);
    return -3;  // no HEVC encoder built in — graceful read-only
  }
  if (heif_encoder_set_lossy_quality)
    heif_encoder_set_lossy_quality(encoder, quality);
  void *img = nullptr;
  int chroma = channels == 4 ? HJ_HEIF_CHROMA_INTERLEAVED_RGBA
                             : HJ_HEIF_CHROMA_INTERLEAVED_RGB;
  err = heif_image_create(w, h, HJ_HEIF_COLORSPACE_RGB, chroma, &img);
  if (err.code || !img) {
    heif_encoder_release(encoder);
    heif_context_free(ctx);
    return -4;
  }
  err = heif_image_add_plane(img, HJ_HEIF_CHANNEL_INTERLEAVED, w, h, 8);
  if (err.code) {
    heif_image_release(img);
    heif_encoder_release(encoder);
    heif_context_free(ctx);
    return -5;
  }
  int stride = 0;
  uint8_t *plane = heif_image_get_plane(img, HJ_HEIF_CHANNEL_INTERLEAVED,
                                        &stride);
  for (int y = 0; y < h; y++)
    memcpy(plane + (size_t)y * stride, data + (size_t)y * w * channels,
           (size_t)w * channels);
  void *handle = nullptr;
  err = heif_context_encode_image(ctx, img, encoder, nullptr, &handle);
  heif_image_release(img);
  heif_encoder_release(encoder);
  if (err.code) {
    heif_context_free(ctx);
    return -6;
  }
  if (handle) heif_image_handle_release(handle);
  hj_membuf buf = {nullptr, 0, 0};
  heif_writer writer = {1, hj_mem_write};
  err = heif_context_write(ctx, &writer, &buf);
  heif_context_free(ctx);
  if (err.code) {
    free(buf.data);
    return -7;
  }
  *out = buf.data;
  *out_size = buf.size;
  return 0;
}

// ---------------------------------------------------------------------------
// libjxl 0.7 stable ABI subset.  JxlBasicInfo is accessed through its
// public field layout (codestream_header.h): xsize@4 ysize@8
// bits_per_sample@12 num_color_channels@52 alpha_bits@60.
// ---------------------------------------------------------------------------

struct JxlPixelFormat {
  uint32_t num_channels;
  int data_type;   // JXL_TYPE_UINT8 = 2
  int endianness;  // JXL_NATIVE_ENDIAN = 0
  size_t align;
};

enum {
  HJ_JXL_DEC_SUCCESS = 0,
  HJ_JXL_DEC_ERROR = 1,
  HJ_JXL_DEC_NEED_MORE_INPUT = 2,
  HJ_JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5,
  HJ_JXL_DEC_BASIC_INFO = 0x40,
  HJ_JXL_DEC_FULL_IMAGE = 0x1000,
};

typedef void *(*p_jxl_dec_create)(const void *);
typedef void (*p_jxl_dec_destroy)(void *);
typedef int (*p_jxl_dec_subscribe)(void *, int);
typedef int (*p_jxl_dec_set_input)(void *, const uint8_t *, size_t);
typedef void (*p_jxl_dec_close_input)(void *);
typedef int (*p_jxl_dec_process)(void *);
typedef int (*p_jxl_dec_get_info)(const void *, void *);
typedef int (*p_jxl_dec_outsize)(const void *, const JxlPixelFormat *,
                                 size_t *);
typedef int (*p_jxl_dec_setout)(void *, const JxlPixelFormat *, void *,
                                size_t);

static void *jxl_lib(void) {
  static void *h = dlopen("libjxl.so.0.7", RTLD_NOW | RTLD_LOCAL);
  if (!h) h = dlopen("libjxl.so", RTLD_NOW | RTLD_LOCAL);
  return h;
}

int hj_jxl_available(void) { return jxl_lib() != nullptr; }

int hj_decode_jxl(const uint8_t *data, size_t size, uint8_t **out, int *ow,
                  int *oh, int *oc) {
  void *lib = jxl_lib();
  if (!lib) return -1;
  HJ_SYM(lib, p_jxl_dec_create, JxlDecoderCreate);
  HJ_SYM(lib, p_jxl_dec_destroy, JxlDecoderDestroy);
  HJ_SYM(lib, p_jxl_dec_subscribe, JxlDecoderSubscribeEvents);
  HJ_SYM(lib, p_jxl_dec_set_input, JxlDecoderSetInput);
  HJ_SYM(lib, p_jxl_dec_process, JxlDecoderProcessInput);
  HJ_SYM(lib, p_jxl_dec_get_info, JxlDecoderGetBasicInfo);
  HJ_SYM(lib, p_jxl_dec_outsize, JxlDecoderImageOutBufferSize);
  HJ_SYM(lib, p_jxl_dec_setout, JxlDecoderSetImageOutBuffer);
  p_jxl_dec_close_input JxlDecoderCloseInput =
      (p_jxl_dec_close_input)dlsym(lib, "JxlDecoderCloseInput");

  void *dec = JxlDecoderCreate(nullptr);
  if (!dec) return -2;
  if (JxlDecoderSubscribeEvents(dec, HJ_JXL_DEC_BASIC_INFO |
                                         HJ_JXL_DEC_FULL_IMAGE)) {
    JxlDecoderDestroy(dec);
    return -3;
  }
  JxlDecoderSetInput(dec, data, size);
  if (JxlDecoderCloseInput) JxlDecoderCloseInput(dec);
  uint8_t info[512];
  memset(info, 0, sizeof(info));
  JxlPixelFormat fmt = {3, 2, 0, 0};
  uint8_t *buf = nullptr;
  size_t bufsize = 0;
  uint32_t xsize = 0, ysize = 0;
  for (;;) {
    int st = JxlDecoderProcessInput(dec);
    if (st == HJ_JXL_DEC_BASIC_INFO) {
      if (JxlDecoderGetBasicInfo(dec, info)) break;
      xsize = *(uint32_t *)(info + 4);
      ysize = *(uint32_t *)(info + 8);
      uint32_t ncolor = *(uint32_t *)(info + 52);
      uint32_t alpha_bits = *(uint32_t *)(info + 60);
      if (xsize == 0 || ysize == 0 || xsize > (1u << 24) ||
          ysize > (1u << 24))
        break;  // layout sanity guard
      fmt.num_channels = (ncolor >= 3 ? 3 : 1) + (alpha_bits ? 1 : 0);
    } else if (st == HJ_JXL_DEC_NEED_IMAGE_OUT_BUFFER) {
      if (JxlDecoderImageOutBufferSize(dec, &fmt, &bufsize)) break;
      if (bufsize != (size_t)xsize * ysize * fmt.num_channels) break;
      buf = (uint8_t *)malloc(bufsize);
      if (!buf) break;
      if (JxlDecoderSetImageOutBuffer(dec, &fmt, buf, bufsize)) break;
    } else if (st == HJ_JXL_DEC_FULL_IMAGE) {
      continue;
    } else if (st == HJ_JXL_DEC_SUCCESS) {
      if (!buf) break;
      JxlDecoderDestroy(dec);
      *out = buf;
      *ow = (int)xsize;
      *oh = (int)ysize;
      *oc = (int)fmt.num_channels;
      return 0;
    } else {
      break;  // ERROR / NEED_MORE_INPUT (we supplied everything)
    }
  }
  free(buf);
  JxlDecoderDestroy(dec);
  return -4;
}

typedef void *(*p_jxl_enc_create)(const void *);
typedef void (*p_jxl_enc_destroy)(void *);
typedef void (*p_jxl_init_info)(void *);
typedef int (*p_jxl_enc_set_info)(void *, const void *);
typedef void (*p_jxl_srgb)(void *, int);
typedef int (*p_jxl_enc_set_color)(void *, const void *);
typedef void *(*p_jxl_enc_fs_create)(void *, const void *);
typedef int (*p_jxl_enc_add_frame)(void *, const JxlPixelFormat *,
                                   const void *, size_t);
typedef void (*p_jxl_enc_close)(void *);
typedef int (*p_jxl_enc_process)(void *, uint8_t **, size_t *);

int hj_encode_jxl(const uint8_t *data, int w, int h, int channels,
                  uint8_t **out, size_t *out_size) {
  void *lib = jxl_lib();
  if (!lib) return -1;
  HJ_SYM(lib, p_jxl_enc_create, JxlEncoderCreate);
  HJ_SYM(lib, p_jxl_enc_destroy, JxlEncoderDestroy);
  HJ_SYM(lib, p_jxl_init_info, JxlEncoderInitBasicInfo);
  HJ_SYM(lib, p_jxl_enc_set_info, JxlEncoderSetBasicInfo);
  HJ_SYM(lib, p_jxl_srgb, JxlColorEncodingSetToSRGB);
  HJ_SYM(lib, p_jxl_enc_set_color, JxlEncoderSetColorEncoding);
  HJ_SYM(lib, p_jxl_enc_add_frame, JxlEncoderAddImageFrame);
  HJ_SYM(lib, p_jxl_enc_close, JxlEncoderCloseInput);
  HJ_SYM(lib, p_jxl_enc_process, JxlEncoderProcessOutput);
  p_jxl_enc_fs_create fs_create =
      (p_jxl_enc_fs_create)dlsym(lib, "JxlEncoderFrameSettingsCreate");
  if (!fs_create)  // pre-0.7 name
    fs_create = (p_jxl_enc_fs_create)dlsym(lib, "JxlEncoderOptionsCreate");
  if (!fs_create) return -1;

  void *enc = JxlEncoderCreate(nullptr);
  if (!enc) return -2;
  uint8_t info[512];
  memset(info, 0, sizeof(info));
  JxlEncoderInitBasicInfo(info);
  *(uint32_t *)(info + 4) = (uint32_t)w;
  *(uint32_t *)(info + 8) = (uint32_t)h;
  *(uint32_t *)(info + 12) = 8;  // bits_per_sample
  int ncolor = channels >= 3 ? 3 : 1;
  int nalpha = (channels == 2 || channels == 4) ? 1 : 0;
  *(uint32_t *)(info + 52) = (uint32_t)ncolor;
  *(uint32_t *)(info + 56) = (uint32_t)nalpha;
  *(uint32_t *)(info + 60) = nalpha ? 8u : 0u;
  if (JxlEncoderSetBasicInfo(enc, info)) {
    JxlEncoderDestroy(enc);
    return -3;
  }
  uint8_t cenc[512];
  memset(cenc, 0, sizeof(cenc));
  JxlColorEncodingSetToSRGB(cenc, ncolor == 1);
  if (JxlEncoderSetColorEncoding(enc, cenc)) {
    JxlEncoderDestroy(enc);
    return -4;
  }
  void *fs = fs_create(enc, nullptr);
  JxlPixelFormat fmt = {(uint32_t)channels, 2, 0, 0};
  if (JxlEncoderAddImageFrame(fs, &fmt, data,
                              (size_t)w * h * channels)) {
    JxlEncoderDestroy(enc);
    return -5;
  }
  JxlEncoderCloseInput(enc);
  size_t cap = 1 << 16;
  uint8_t *buf = (uint8_t *)malloc(cap);
  uint8_t *next_out = buf;
  size_t avail = cap;
  for (;;) {
    int st = JxlEncoderProcessOutput(enc, &next_out, &avail);
    if (st == 0) break;  // JXL_ENC_SUCCESS
    if (st == 2) {       // JXL_ENC_NEED_MORE_OUTPUT
      size_t used = next_out - buf;
      cap *= 2;
      buf = (uint8_t *)realloc(buf, cap);
      next_out = buf + used;
      avail = cap - used;
    } else {
      free(buf);
      JxlEncoderDestroy(enc);
      return -6;
    }
  }
  *out_size = next_out - buf;
  *out = buf;
  JxlEncoderDestroy(enc);
  return 0;
}

void hj_free(void *p) { free(p); }

int hj_abi_version(void) { return 1; }

}  // extern "C"
