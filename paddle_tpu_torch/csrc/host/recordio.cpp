// RecordIO: chunked, CRC32-checked record file format.
//
// Reference: Fluid's paddle/fluid/recordio/ (chunk.cc, writer.cc,
// scanner.cc) — chunks of length-prefixed records with a CRC32 header,
// giving seekable, corruption-detecting, appendable datasets that the
// Go master shards by chunk (go/master/service.go SetDataset).
//
// A copy of the JAX package's scanner for the port's host data path: the
// input pipeline (paddle_tpu_torch/recordio.py, layers/io.py) scans chunks
// on CPU threads while the card computes.  Layout (little-endian):
//
//   file  := chunk*
//   chunk := magic:u32 crc32:u32 nrecords:u32 datalen:u32 data
//   data  := (reclen:u32 bytes)*        crc32 is over `data`
//
// Exposed as a C ABI for ctypes.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545231;  // "PTR1"

// CRC32 (IEEE), table-based — no zlib dependency.  Thread-safe init:
// concurrency.cpp's scanner workers call crc32 concurrently in the same
// shared object.
uint32_t crc_table[256];
std::once_flag crc_once;
void crc_init() {
  std::call_once(crc_once, [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  });
}
uint32_t crc32(const uint8_t* buf, size_t len) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  uint32_t nrecords = 0;
  uint32_t max_chunk_bytes = 1 << 20;

  int flush_chunk() {
    if (nrecords == 0) return 0;
    uint32_t header[4] = {kMagic, crc32(buf.data(), buf.size()), nrecords,
                          static_cast<uint32_t>(buf.size())};
    if (fwrite(header, sizeof(header), 1, f) != 1) return -1;
    if (!buf.empty() && fwrite(buf.data(), buf.size(), 1, f) != 1) return -1;
    buf.clear();
    nrecords = 0;
    return 0;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<uint8_t> chunk;
  size_t pos = 0;
  uint32_t remaining = 0;
  std::string err;

  // returns 1 ok, 0 eof, -1 error
  int load_chunk() {
    uint32_t header[4];
    size_t got = fread(header, sizeof(uint32_t), 4, f);
    if (got == 0) return 0;
    if (got != 4 || header[0] != kMagic) {
      err = "bad chunk header";
      return -1;
    }
    chunk.resize(header[3]);
    if (header[3] && fread(chunk.data(), 1, header[3], f) != header[3]) {
      err = "truncated chunk";
      return -1;
    }
    if (crc32(chunk.data(), chunk.size()) != header[1]) {
      err = "crc mismatch";
      return -1;
    }
    remaining = header[2];
    pos = 0;
    return 1;
  }
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, uint32_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  if (max_chunk_bytes) w->max_chunk_bytes = max_chunk_bytes;
  return w;
}

int rio_writer_write(void* h, const uint8_t* data, uint32_t len) {
  Writer* w = static_cast<Writer*>(h);
  uint32_t len_le = len;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&len_le);
  w->buf.insert(w->buf.end(), p, p + 4);
  w->buf.insert(w->buf.end(), data, data + len);
  w->nrecords++;
  if (w->buf.size() >= w->max_chunk_bytes) return w->flush_chunk();
  return 0;
}

int rio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  int rc = w->flush_chunk();
  fclose(w->f);
  delete w;
  return rc;
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// Returns pointer to record bytes valid until the next call; sets *len.
// NULL + *len == 0 -> EOF; NULL + *len == 1 -> error (see rio_scanner_error).
const uint8_t* rio_scanner_next(void* h, uint32_t* len) {
  Scanner* s = static_cast<Scanner*>(h);
  while (s->remaining == 0) {
    int rc = s->load_chunk();
    if (rc == 0) {
      *len = 0;
      return nullptr;
    }
    if (rc < 0) {
      *len = 1;
      return nullptr;
    }
  }
  if (s->pos + 4 > s->chunk.size()) {
    s->err = "corrupt record length";
    *len = 1;
    return nullptr;
  }
  uint32_t rec_len;
  memcpy(&rec_len, s->chunk.data() + s->pos, 4);
  s->pos += 4;
  if (s->pos + rec_len > s->chunk.size()) {
    s->err = "record overruns chunk";
    *len = 1;
    return nullptr;
  }
  const uint8_t* out = s->chunk.data() + s->pos;
  s->pos += rec_len;
  s->remaining--;
  *len = rec_len;
  return out;
}

const char* rio_scanner_error(void* h) {
  return static_cast<Scanner*>(h)->err.c_str();
}

void rio_scanner_close(void* h) {
  Scanner* s = static_cast<Scanner*>(h);
  fclose(s->f);
  delete s;
}

}  // extern "C"
