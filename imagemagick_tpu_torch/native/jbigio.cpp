// JBIG1 codec shim over the system jbig-kit (libjbig), the same library
// ImageMagick's coders/jbig.c delegates to.  Built on first use by
// the package's native/__init__.py; exposes a flat C ABI for ctypes.
//
// Reference parity: coders/jbig.c ReadJBIGImage (incremental jbg_dec_in
// over the blob) and WriteJBIGImage (jbg_enc_init with a data-out
// callback, one bitplane, default options).

extern "C" {
#include <jbig.h>   // jbig-kit ships no C++ guards; names must stay C
}

#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Decode a JBIG blob into a packed 1-bpp bitmap (row stride = ceil(w/8)).
// Returns 0 on success; *out is malloc'd (caller frees via jb_free).
int jb_decode(const unsigned char *data, size_t len,
              unsigned char **out, int *width, int *height) {
  struct jbg_dec_state state;
  jbg_dec_init(&state);
  size_t consumed = 0;
  int result = JBG_EAGAIN;
  while (consumed < len) {
    size_t chunk_used = 0;
    result = jbg_dec_in(&state, const_cast<unsigned char *>(data) + consumed,
                        len - consumed, &chunk_used);
    consumed += chunk_used ? chunk_used : 1;
    if (result == JBG_EOK || result == JBG_EOK_INTR) break;
    if (result != JBG_EAGAIN && result != JBG_EOK_INTR) {
      jbg_dec_free(&state);
      return -1;
    }
  }
  if (result != JBG_EOK && result != JBG_EOK_INTR) {
    jbg_dec_free(&state);
    return -2;
  }
  unsigned long w = jbg_dec_getwidth(&state);
  unsigned long h = jbg_dec_getheight(&state);
  unsigned char *img = jbg_dec_getimage(&state, 0);
  if (img == nullptr || w == 0 || h == 0) {
    jbg_dec_free(&state);
    return -3;
  }
  size_t stride = (w + 7) / 8;
  unsigned char *buf = (unsigned char *)malloc(stride * h);
  if (buf == nullptr) {
    jbg_dec_free(&state);
    return -4;
  }
  memcpy(buf, img, stride * h);
  jbg_dec_free(&state);
  *out = buf;
  *width = (int)w;
  *height = (int)h;
  return 0;
}

struct jb_sink {
  std::vector<unsigned char> bytes;
};

static void jb_out(unsigned char *start, size_t len, void *file) {
  jb_sink *sink = (jb_sink *)file;
  sink->bytes.insert(sink->bytes.end(), start, start + len);
}

// Encode a packed 1-bpp bitmap (row stride = ceil(w/8), MSB first, 1 =
// foreground/black as jbig expects) into a JBIG blob.
int jb_encode(const unsigned char *bitmap, int width, int height,
              unsigned char **out, size_t *out_len) {
  jb_sink sink;
  struct jbg_enc_state state;
  unsigned char *planes[1] = {const_cast<unsigned char *>(bitmap)};
  jbg_enc_init(&state, (unsigned long)width, (unsigned long)height, 1,
               planes, jb_out, &sink);
  jbg_enc_out(&state);
  jbg_enc_free(&state);
  if (sink.bytes.empty()) return -1;
  unsigned char *buf = (unsigned char *)malloc(sink.bytes.size());
  if (buf == nullptr) return -2;
  memcpy(buf, sink.bytes.data(), sink.bytes.size());
  *out = buf;
  *out_len = sink.bytes.size();
  return 0;
}

void jb_free(unsigned char *p) { free(p); }

}  // extern "C"
