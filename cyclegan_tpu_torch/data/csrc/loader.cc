// The PyTorch port's native data loader and writer, a copy of the JAX
// package's loader (its native/loader.cc) kept with the port so that the
// port builds it from its own sources.
//
// TFRecord framing with CRC32C verification, a minimal tf.train.Example
// wire-format parser, libpng/libjpeg image decoding and half-pixel
// bilinear resize, spread over a std::thread pool sized to the host; and
// the writer: image files -> PNG-encoded Examples -> framed shards.
//
// C ABI (consumed via ctypes from cyclegan_tpu_torch/data/native.py):
//   tfr_count_records(paths, n_paths, verify_crc)          -> record count
//   tfr_decode_domain(paths, n_paths, width, out, cap, nt) -> decoded count
//   tfr_write_domain(images, n, out_dir, size, shard, nt)  -> images written
//
// Built at first use by cyclegan_tpu_torch/data/host_build.py:
//   g++ -O3 -std=c++17 -fPIC -shared loader.cc -lpng -ljpeg -lz -pthread

#include <cstddef>
#include <cstdio>

// jpeglib.h relies on stdio.h/stddef.h being included first.
#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven; TFRecord masks it as
// ((crc >> 15) | (crc << 17)) + 0xa282ead8.
// ---------------------------------------------------------------------------

uint32_t crc32c_table[256];

struct Crc32cInit {
  Crc32cInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j)
        crc = (crc >> 1) ^ (0x82f63b78u & (~(crc & 1) + 1));
      crc32c_table[i] = crc;
    }
  }
} crc32c_init;

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    crc = (crc >> 8) ^ crc32c_table[(crc ^ data[i]) & 0xff];
  return crc ^ 0xffffffffu;
}

uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// TFRecord framing: u64le length, u32 masked crc(length), data, u32 crc(data)
// ---------------------------------------------------------------------------

bool read_records(const char* path, bool verify,
                  std::vector<std::vector<uint8_t>>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t header[12];
  while (fread(header, 1, 12, f) == 12) {
    uint64_t length;
    memcpy(&length, header, 8);  // little-endian hosts only (x86/ARM)
    if (verify) {
      uint32_t expect;
      memcpy(&expect, header + 8, 4);
      if (masked_crc32c(header, 8) != expect) {
        fclose(f);
        return false;
      }
    }
    std::vector<uint8_t> record(length);
    if (length && fread(record.data(), 1, length, f) != length) {
      fclose(f);
      return false;
    }
    uint8_t footer[4];
    if (fread(footer, 1, 4, f) != 4) {
      fclose(f);
      return false;
    }
    if (verify) {
      uint32_t expect;
      memcpy(&expect, footer, 4);
      if (masked_crc32c(record.data(), record.size()) != expect) {
        fclose(f);
        return false;
      }
    }
    out->push_back(std::move(record));
  }
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// Minimal protobuf: extract the "image_raw" bytes feature out of a
// tf.train.Example (schema in cyclegan_tpu_torch/data/example_proto.py).
// ---------------------------------------------------------------------------

bool read_varint(const uint8_t* buf, size_t len, size_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t byte = buf[(*pos)++];
    result |= uint64_t(byte & 0x7f) << shift;
    if (!(byte & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

struct Slice {
  const uint8_t* data = nullptr;
  size_t len = 0;
};

// Iterate fields of a message; returns length-delimited payloads via cb.
template <typename Fn>
bool for_each_field(const uint8_t* buf, size_t len, Fn cb) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t key;
    if (!read_varint(buf, len, &pos, &key)) return false;
    uint32_t field = key >> 3, wire = key & 7;
    if (wire == 2) {  // LEN
      uint64_t size;
      if (!read_varint(buf, len, &pos, &size) || pos + size > len) return false;
      cb(field, Slice{buf + pos, size_t(size)});
      pos += size;
    } else if (wire == 0) {  // VARINT
      uint64_t v;
      if (!read_varint(buf, len, &pos, &v)) return false;
    } else if (wire == 1) {
      pos += 8;
    } else if (wire == 5) {
      pos += 4;
    } else {
      return false;
    }
  }
  return true;
}

Slice extract_image_raw(const uint8_t* example, size_t len) {
  Slice result;
  for_each_field(example, len, [&](uint32_t f1, Slice features) {
    if (f1 != 1) return;  // Example.features
    for_each_field(features.data, features.len, [&](uint32_t f2, Slice entry) {
      if (f2 != 1) return;  // Features.feature (map entry)
      Slice key, value;
      for_each_field(entry.data, entry.len, [&](uint32_t f3, Slice s) {
        if (f3 == 1) key = s;
        if (f3 == 2) value = s;
      });
      if (key.len == 9 && memcmp(key.data, "image_raw", 9) == 0) {
        // Feature.bytes_list (field 1) -> BytesList.value (field 1)
        for_each_field(value.data, value.len, [&](uint32_t f4, Slice blist) {
          if (f4 != 1) return;
          for_each_field(blist.data, blist.len, [&](uint32_t f5, Slice bytes) {
            if (f5 == 1) result = bytes;
          });
        });
      }
    });
  });
  return result;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng) -> RGB8
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png_rgb(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                    int* width, int* height) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{data, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // Normalize everything to 8-bit RGB.
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 r = 0; r < h; ++r) rows[r] = out->data() + size_t(r) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  *width = int(w);
  *height = int(h);
  return true;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) -> RGB8
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg_rgb(const uint8_t* data, size_t len,
                     std::vector<uint8_t>* out, int* width, int* height) {
  if (len < 3 || data[0] != 0xff || data[1] != 0xd8) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  out->resize(size_t(w) * h * 3);
  while (int(cinfo.output_scanline) < h) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *width = w;
  *height = h;
  return true;
}

// ---------------------------------------------------------------------------
// Half-pixel bilinear resize RGB8 -> RGB8 (cv2 INTER_LINEAR convention,
// the host-resize stage of the pipeline).
// ---------------------------------------------------------------------------

void resize_bilinear_rgb(const uint8_t* src, int sw, int sh, uint8_t* dst,
                         int dw, int dh) {
  if (sw == dw && sh == dh) {
    memcpy(dst, src, size_t(sw) * sh * 3);
    return;
  }
  const float sx = float(sw) / dw, sy = float(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(fy) - (fy < 0);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(fx) - (fx < 0);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1);
      const uint8_t* p00 = src + (size_t(y0c) * sw + x0c) * 3;
      const uint8_t* p01 = src + (size_t(y0c) * sw + x1c) * 3;
      const uint8_t* p10 = src + (size_t(y1c) * sw + x0c) * 3;
      const uint8_t* p11 = src + (size_t(y1c) * sw + x1c) * 3;
      uint8_t* o = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float v = top + (bot - top) * wy;
        o[c] = uint8_t(v + 0.5f);
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Count records across shard files. Returns -1 on I/O/CRC error.
long tfr_count_records(const char** paths, int n_paths, int verify_crc) {
  long total = 0;
  for (int i = 0; i < n_paths; ++i) {
    std::vector<std::vector<uint8_t>> records;
    if (!read_records(paths[i], verify_crc != 0, &records)) return -1;
    total += long(records.size());
  }
  return total;
}

// Decode every example in the shard list into `out` as (count, width,
// width, 3) uint8 RGB. `capacity` is the number of images `out` can hold.
// Returns the number decoded, or -1 on error.
long tfr_decode_domain(const char** paths, int n_paths, int width,
                       uint8_t* out, long capacity, int verify_crc,
                       int n_threads) {
  std::vector<std::vector<uint8_t>> records;
  for (int i = 0; i < n_paths; ++i)
    if (!read_records(paths[i], verify_crc != 0, &records)) return -1;
  long n = long(records.size());
  if (n > capacity) n = capacity;

  const size_t image_bytes = size_t(width) * width * 3;
  std::atomic<long> next(0);
  std::atomic<bool> failed(false);

  auto worker = [&]() {
    std::vector<uint8_t> decoded;
    std::vector<uint8_t> resized(image_bytes);
    while (true) {
      long idx = next.fetch_add(1);
      if (idx >= n || failed.load()) return;
      Slice img = extract_image_raw(records[idx].data(), records[idx].size());
      if (!img.data) {
        failed.store(true);
        return;
      }
      int w = 0, h = 0;
      decoded.clear();
      bool ok = decode_png_rgb(img.data, img.len, &decoded, &w, &h) ||
                decode_jpeg_rgb(img.data, img.len, &decoded, &w, &h);
      if (!ok) {
        failed.store(true);
        return;
      }
      resize_bilinear_rgb(decoded.data(), w, h, out + size_t(idx) * image_bytes,
                          width, width);
    }
  };

  int hw_threads = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw_threads > 0 ? hw_threads : 4;
  if (long(n_threads) > n) n_threads = int(n > 0 ? n : 1);
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load() ? -1 : n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Writer side: image files -> Example protos -> TFRecord shards.
// ---------------------------------------------------------------------------

namespace {

// PNG encode RGB8 -> memory (libpng write callbacks into a vector).
void png_write_fn(png_structp png, png_bytep data, png_size_t n) {
  auto* out = static_cast<std::vector<uint8_t>*>(png_get_io_ptr(png));
  out->insert(out->end(), data, data + n);
}
void png_flush_fn(png_structp) {}

bool encode_png_rgb(const uint8_t* rgb, int w, int h,
                    std::vector<uint8_t>* out) {
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    return false;
  }
  out->clear();
  png_set_write_fn(png, out, png_write_fn, png_flush_fn);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  std::vector<png_bytep> rows(h);
  for (int r = 0; r < h; ++r)
    rows[r] = const_cast<uint8_t*>(rgb) + size_t(r) * w * 3;
  png_write_image(png, rows.data());
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  return true;
}

// Minimal protobuf encoding (schema in cyclegan_tpu_torch/data/example_proto.py).
void put_varint(std::vector<uint8_t>* out, uint64_t v) {
  while (true) {
    uint8_t byte = v & 0x7f;
    v >>= 7;
    if (v) {
      out->push_back(byte | 0x80);
    } else {
      out->push_back(byte);
      return;
    }
  }
}

void put_len_delimited(std::vector<uint8_t>* out, uint32_t field,
                       const uint8_t* data, size_t n) {
  put_varint(out, (field << 3) | 2);
  put_varint(out, n);
  out->insert(out->end(), data, data + n);
}

void put_bytes_feature_entry(std::vector<uint8_t>* out, const char* key,
                             const std::vector<uint8_t>& value) {
  std::vector<uint8_t> bytes_list;
  put_len_delimited(&bytes_list, 1, value.data(), value.size());
  std::vector<uint8_t> feature;
  put_len_delimited(&feature, 1, bytes_list.data(), bytes_list.size());
  std::vector<uint8_t> entry;
  put_len_delimited(&entry, 1, reinterpret_cast<const uint8_t*>(key),
                    strlen(key));
  put_len_delimited(&entry, 2, feature.data(), feature.size());
  put_len_delimited(out, 1, entry.data(), entry.size());
}

void put_int64_feature_entry(std::vector<uint8_t>* out, const char* key,
                             int64_t value) {
  std::vector<uint8_t> packed;
  put_varint(&packed, uint64_t(value));
  std::vector<uint8_t> int_list;
  put_len_delimited(&int_list, 1, packed.data(), packed.size());
  std::vector<uint8_t> feature;
  put_len_delimited(&feature, 3, int_list.data(), int_list.size());
  std::vector<uint8_t> entry;
  put_len_delimited(&entry, 1, reinterpret_cast<const uint8_t*>(key),
                    strlen(key));
  put_len_delimited(&entry, 2, feature.data(), feature.size());
  put_len_delimited(out, 1, entry.data(), entry.size());
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 0) {
    fclose(f);
    return false;
  }
  out->resize(size_t(size));
  bool ok = size == 0 || fread(out->data(), 1, size_t(size), f) == size_t(size);
  fclose(f);
  return ok;
}

bool write_framed_record(FILE* f, const std::vector<uint8_t>& record) {
  uint8_t header[12];
  uint64_t length = record.size();
  memcpy(header, &length, 8);
  uint32_t len_crc = masked_crc32c(header, 8);
  memcpy(header + 8, &len_crc, 4);
  if (fwrite(header, 1, 12, f) != 12) return false;
  if (!record.empty() &&
      fwrite(record.data(), 1, record.size(), f) != record.size())
    return false;
  uint32_t data_crc = masked_crc32c(record.data(), record.size());
  return fwrite(&data_crc, 1, 4, f) == 4;
}

}  // namespace

extern "C" {

// Encode image files into sharded TFRecords of tf.train.Examples
// ({image_raw: PNG bytes, height, width, depth}), matching the python
// writer (cyclegan_tpu_torch/data/tfrecord.py tfrecord_writer; shard naming
// %05d.tfrecords). image_size 0 keeps original sizes. Returns the number
// of images written, or -1 on error.
long tfr_write_domain(const char** image_paths, int n_paths,
                      const char* out_dir, int image_size, int shard_size,
                      int n_threads) {
  if (shard_size <= 0 || n_paths < 0) return -1;

  // Parallel stage: file -> decode -> resize -> PNG -> Example bytes.
  std::vector<std::vector<uint8_t>> examples;
  examples.resize(static_cast<size_t>(n_paths));
  std::vector<uint8_t> ok_flags;
  ok_flags.resize(static_cast<size_t>(n_paths), 0);
  std::atomic<long> next(0);

  auto worker = [&]() {
    std::vector<uint8_t> file_bytes, decoded, resized, png;
    while (true) {
      long idx = next.fetch_add(1);
      if (idx >= n_paths) return;
      if (!read_file(image_paths[idx], &file_bytes)) continue;
      int w = 0, h = 0;
      if (!decode_png_rgb(file_bytes.data(), file_bytes.size(), &decoded, &w,
                          &h) &&
          !decode_jpeg_rgb(file_bytes.data(), file_bytes.size(), &decoded, &w,
                           &h))
        continue;
      const uint8_t* pixels = decoded.data();
      int out_w = w, out_h = h;
      if (image_size > 0 && (w != image_size || h != image_size)) {
        resized.resize(size_t(image_size) * image_size * 3);
        resize_bilinear_rgb(decoded.data(), w, h, resized.data(), image_size,
                            image_size);
        pixels = resized.data();
        out_w = out_h = image_size;
      }
      if (!encode_png_rgb(pixels, out_w, out_h, &png)) continue;
      std::vector<uint8_t>& example = examples[size_t(idx)];
      std::vector<uint8_t> features;
      put_bytes_feature_entry(&features, "image_raw", png);
      put_int64_feature_entry(&features, "height", out_h);
      put_int64_feature_entry(&features, "width", out_w);
      put_int64_feature_entry(&features, "depth", 3);
      put_len_delimited(&example, 1, features.data(), features.size());
      ok_flags[size_t(idx)] = 1;
    }
  };

  int hw_threads = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = hw_threads > 0 ? hw_threads : 4;
  if (n_threads > n_paths) n_threads = n_paths > 0 ? n_paths : 1;
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();

  // Sequential stage: framed shard files, preserving input order.
  long written = 0;
  FILE* shard = nullptr;
  int shard_index = 0, in_shard = 0;
  for (int i = 0; i < n_paths; ++i) {
    if (!ok_flags[size_t(i)]) continue;
    if (!shard) {
      char path[4096];
      snprintf(path, sizeof(path), "%s/%05d.tfrecords", out_dir, shard_index);
      shard = fopen(path, "wb");
      if (!shard) return -1;
    }
    if (!write_framed_record(shard, examples[size_t(i)])) {
      fclose(shard);
      return -1;
    }
    ++written;
    if (++in_shard == shard_size) {
      fclose(shard);
      shard = nullptr;
      in_shard = 0;
      ++shard_index;
    }
  }
  if (shard) fclose(shard);
  return written;
}

}  // extern "C"
