// Native EXR decode + parallel batch loader for the dataset pipeline.
//
// The training data path (nn/dataset.py) reads thousands of float EXRs per
// epoch; Python-side zlib decode is single-threaded per file. This library
// decodes scanline EXRs (FLOAT/HALF channels, NONE/ZIPS/ZIP compression —
// the subset io/exr.py writes and the reference tooling used) with a thread
// pool across files, exposed through a plain C ABI consumed via ctypes
// (no pybind11 in this environment).
//
// A copy of the JAX package's native/exr_native.cpp, built by
// litbox_tpu_torch/native/__init__.py. Format notes mirror
// litbox_tpu_torch/io/exr.py; ZIP pixel pre-conditioning is
// OpenEXR's delta predictor + two-half interleave.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

struct Channel {
  std::string name;
  int pixel_type;  // 0=UINT 1=HALF 2=FLOAT
};

struct ExrInfo {
  int width = 0, height = 0;
  int compression = 0;
  int ymin = 0;
  std::vector<Channel> channels;
  size_t data_offset = 0;  // offset table position
};

float half_to_float(uint16_t h) {
  uint32_t sign = (h >> 15) & 1u, exp = (h >> 10) & 0x1fu, man = h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) { f = sign << 31; }
    else {
      exp = 127 - 15 + 1;
      while ((man & 0x400u) == 0) { man <<= 1; exp--; }
      man &= 0x3ffu;
      f = (sign << 31) | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    f = (sign << 31) | 0x7f800000u | (man << 13);
  } else {
    f = (sign << 31) | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(n);
  size_t got = std::fread(buf.data(), 1, n, f);
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

bool parse_header(const std::vector<uint8_t>& buf, ExrInfo* info) {
  if (buf.size() < 8) return false;
  int32_t magic;
  std::memcpy(&magic, buf.data(), 4);
  if (magic != 0x01312f76) return false;
  size_t pos = 8;
  auto cstr = [&](std::string* out) -> bool {
    size_t start = pos;
    while (pos < buf.size() && buf[pos] != 0) pos++;
    if (pos >= buf.size()) return false;
    out->assign(reinterpret_cast<const char*>(&buf[start]), pos - start);
    pos++;
    return true;
  };
  while (true) {
    std::string name, type;
    if (!cstr(&name)) return false;
    if (name.empty()) break;
    if (!cstr(&type)) return false;
    int32_t size;
    std::memcpy(&size, &buf[pos], 4);
    pos += 4;
    const uint8_t* payload = &buf[pos];
    if (name == "channels") {
      size_t cpos = 0;
      while (payload[cpos] != 0) {
        Channel ch;
        size_t s = cpos;
        while (payload[cpos] != 0) cpos++;
        ch.name.assign(reinterpret_cast<const char*>(&payload[s]), cpos - s);
        cpos++;
        std::memcpy(&ch.pixel_type, &payload[cpos], 4);
        cpos += 16;
        info->channels.push_back(ch);
      }
    } else if (name == "compression") {
      info->compression = payload[0];
    } else if (name == "dataWindow") {
      int32_t box[4];
      std::memcpy(box, payload, 16);
      info->width = box[2] - box[0] + 1;
      info->height = box[3] - box[1] + 1;
      info->ymin = box[1];
    }
    pos += size;
  }
  info->data_offset = pos;
  return true;
}

void zip_undo_predictor(std::vector<uint8_t>& d) {
  for (size_t i = 1; i < d.size(); i++) d[i] = uint8_t(d[i - 1] + d[i] - 128);
  std::vector<uint8_t> out(d.size());
  size_t half = (d.size() + 1) / 2;
  for (size_t i = 0, a = 0, b = half; i < d.size();) {
    out[i++] = d[a++];
    if (i < d.size()) out[i++] = d[b++];
  }
  d.swap(out);
}

// Decode into interleaved RGB float32 (row-major, H*W*3).
bool decode_rgb(const std::vector<uint8_t>& buf, const ExrInfo& info, float* out) {
  int lines_per_block = (info.compression == 3) ? 16 : 1;
  if (info.compression > 3) return false;  // NONE/RLE? support NONE/ZIPS/ZIP
  if (info.compression == 1) return false; // RLE unsupported natively
  int num_blocks = (info.height + lines_per_block - 1) / lines_per_block;

  // Channel layout inside a scanline: alphabetical channel order.
  int rgb_slot[3] = {-1, -1, -1};
  std::vector<size_t> ch_size(info.channels.size());
  size_t line_bytes = 0;
  for (size_t c = 0; c < info.channels.size(); c++) {
    int bytes = info.channels[c].pixel_type == 1 ? 2 : 4;
    ch_size[c] = bytes;
    if (info.channels[c].name == "R") rgb_slot[0] = int(c);
    if (info.channels[c].name == "G") rgb_slot[1] = int(c);
    if (info.channels[c].name == "B") rgb_slot[2] = int(c);
    line_bytes += size_t(bytes) * info.width;
  }
  for (int k = 0; k < 3; k++) if (rgb_slot[k] < 0) return false;

  const uint64_t* offsets =
      reinterpret_cast<const uint64_t*>(&buf[info.data_offset]);

  std::atomic<int> next{0};
  std::atomic<bool> ok{true};
  int n_threads = std::min<int>(std::thread::hardware_concurrency(), 8);
  n_threads = std::max(1, std::min(n_threads, num_blocks));

  auto worker = [&]() {
    std::vector<uint8_t> raw;
    while (true) {
      int b = next.fetch_add(1);
      if (b >= num_blocks || !ok.load()) break;
      size_t off = offsets[b];
      int32_t y, size;
      std::memcpy(&y, &buf[off], 4);
      std::memcpy(&size, &buf[off + 4], 4);
      int y0 = y - info.ymin;
      int n_lines = std::min(lines_per_block, info.height - y0);
      size_t raw_size = line_bytes * n_lines;
      const uint8_t* payload = &buf[off + 8];
      const uint8_t* data;
      if ((info.compression == 2 || info.compression == 3)
          && size_t(size) != raw_size) {
        raw.resize(raw_size);
        uLongf dest_len = raw_size;
        if (uncompress(raw.data(), &dest_len, payload, size) != Z_OK
            || dest_len != raw_size) { ok = false; break; }
        zip_undo_predictor(raw);
        data = raw.data();
      } else {
        data = payload;
      }
      size_t rpos = 0;
      for (int line = 0; line < n_lines; line++) {
        float* dst_row = out + size_t(y0 + line) * info.width * 3;
        size_t ch_off = rpos;
        for (size_t c = 0; c < info.channels.size(); c++) {
          int k = -1;
          for (int j = 0; j < 3; j++) if (rgb_slot[j] == int(c)) k = j;
          if (k >= 0) {
            if (ch_size[c] == 4) {
              const float* src = reinterpret_cast<const float*>(&data[ch_off]);
              for (int x = 0; x < info.width; x++) dst_row[x * 3 + k] = src[x];
            } else {
              const uint16_t* src = reinterpret_cast<const uint16_t*>(&data[ch_off]);
              for (int x = 0; x < info.width; x++) dst_row[x * 3 + k] = half_to_float(src[x]);
            }
          }
          ch_off += ch_size[c] * info.width;
        }
        rpos += line_bytes;
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // namespace

extern "C" {

// Returns 0 on success; fills *width/*height. Caller then calls
// exr_read_rgb with a buffer of width*height*3 floats.
int exr_probe(const char* path, int* width, int* height) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  ExrInfo info;
  if (!parse_header(buf, &info)) return 2;
  *width = info.width;
  *height = info.height;
  return 0;
}

int exr_read_rgb(const char* path, float* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  ExrInfo info;
  if (!parse_header(buf, &info)) return 2;
  return decode_rgb(buf, info, out) ? 0 : 3;
}

// Parallel batch decode: n files, each width*height*3 floats at out+i*stride.
// Returns number of failures.
int exr_read_rgb_batch(const char** paths, int n, float* out, int64_t stride) {
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  int n_threads = std::max(1, std::min<int>(std::thread::hardware_concurrency(), n));
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (exr_read_rgb(paths[i], out + int64_t(i) * stride) != 0) failures++;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
