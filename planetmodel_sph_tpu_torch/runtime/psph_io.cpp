// PSPH1 snapshot writer and reader of the PyTorch port
// (planetmodel_sph_tpu_torch), a copy of the JAX package's native runtime
// (planetmodel_sph_tpu/runtime/psph_io.cpp): the same format, the same C
// interface, the same bytes. A background thread streams the queued frames
// to disk with their CRC32 while the caller queues the next one.
// runtime/native.py builds it with g++ at first use and loads it through
// ctypes; runtime/snapshot.py writes the same bytes in numpy where no
// compiler is found.
//
// Format (PSPH1): little-endian
//   [8]  magic "PSPH1\n\0\0"
//   [8]  u64 header_len, [header_len] JSON metadata (field names/shapes/dtypes)
//   per field: [8] u64 nbytes, [nbytes] raw data, [4] u32 crc32
//   [8]  u64 trailer magic 0x50535048454E4421 ("PSPHEND!")
//
// C API (ctypes-friendly):
//   void* psph_writer_open(const char* path, const char* header_json)
//   int   psph_writer_write(void* w, const void* data, uint64_t nbytes)
//   int   psph_writer_close(void* w)           // joins the flush thread
//   void* psph_reader_open(const char* path)
//   int64_t psph_reader_header(void* r, char* buf, uint64_t cap)
//   int64_t psph_reader_next(void* r, void* buf, uint64_t cap) // -1 on EOF/err
//   int   psph_reader_close(void* r)
//
// Writes are queued; a worker thread streams them to disk with CRC32
// computed off the main thread. crc32 is the zlib polynomial (table-driven).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const uint8_t* buf, size_t len, uint32_t crc = 0) {
  crc_init();
  crc = crc ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

constexpr char kMagic[8] = {'P', 'S', 'P', 'H', '1', '\n', 0, 0};
constexpr uint64_t kTrailer = 0x50535048454E4421ull;

struct Writer {
  FILE* f = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::queue<std::vector<uint8_t>> q;
  bool done = false;
  bool error = false;

  void run() {
    for (;;) {
      std::vector<uint8_t> item;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return done || !q.empty(); });
        if (q.empty()) {
          if (done) return;
          continue;
        }
        item = std::move(q.front());
        q.pop();
      }
      uint64_t n = item.size();
      uint32_t crc = crc32(item.data(), item.size());
      if (fwrite(&n, 8, 1, f) != 1 ||
          (n && fwrite(item.data(), 1, n, f) != n) ||
          fwrite(&crc, 4, 1, f) != 1) {
        std::lock_guard<std::mutex> lk(mu);
        error = true;
      }
    }
  }
};

struct Reader {
  FILE* f = nullptr;
  std::string header;
};

}  // namespace

extern "C" {

void* psph_writer_open(const char* path, const char* header_json) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  uint64_t hlen = strlen(header_json);
  if (fwrite(kMagic, 1, 8, f) != 8 || fwrite(&hlen, 8, 1, f) != 1 ||
      fwrite(header_json, 1, hlen, f) != hlen) {
    fclose(f);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  w->worker = std::thread([w] { w->run(); });
  return w;
}

int psph_writer_write(void* wp, const void* data, uint64_t nbytes) {
  Writer* w = static_cast<Writer*>(wp);
  if (!w || w->error) return -1;
  std::vector<uint8_t> item(static_cast<const uint8_t*>(data),
                            static_cast<const uint8_t*>(data) + nbytes);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->q.push(std::move(item));
  }
  w->cv.notify_one();
  return 0;
}

int psph_writer_close(void* wp) {
  Writer* w = static_cast<Writer*>(wp);
  if (!w) return -1;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->done = true;
  }
  w->cv.notify_one();
  w->worker.join();
  int rc = w->error ? -1 : 0;
  if (rc == 0) {
    if (fwrite(&kTrailer, 8, 1, w->f) != 1) rc = -1;
  }
  if (fclose(w->f) != 0) rc = -1;
  delete w;
  return rc;
}

void* psph_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  uint64_t hlen = 0;
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, kMagic, 8) != 0 ||
      fread(&hlen, 8, 1, f) != 1 || hlen > (64u << 20)) {
    fclose(f);
    return nullptr;
  }
  Reader* r = new Reader();
  r->f = f;
  r->header.resize(hlen);
  if (hlen && fread(&r->header[0], 1, hlen, f) != hlen) {
    fclose(f);
    delete r;
    return nullptr;
  }
  return r;
}

int64_t psph_reader_header(void* rp, char* buf, uint64_t cap) {
  Reader* r = static_cast<Reader*>(rp);
  if (!r) return -1;
  if (buf && cap > 0) {
    uint64_t n = r->header.size() < cap - 1 ? r->header.size() : cap - 1;
    memcpy(buf, r->header.data(), n);
    buf[n] = 0;
  }
  return static_cast<int64_t>(r->header.size());
}

// Returns the frame size (copies into buf if it fits), -1 on EOF, -2 on
// corruption (bad CRC / short read).
int64_t psph_reader_next(void* rp, void* buf, uint64_t cap) {
  Reader* r = static_cast<Reader*>(rp);
  if (!r) return -2;
  uint64_t n = 0;
  if (fread(&n, 8, 1, r->f) != 1) return -2;
  if (n == kTrailer) return -1;  // trailer sentinel can't be a real length
  if (n > (16ull << 30)) return -2;
  std::vector<uint8_t> tmp;
  uint8_t* dst;
  if (buf && n <= cap) {
    dst = static_cast<uint8_t*>(buf);
  } else {
    tmp.resize(n);
    dst = tmp.data();
  }
  if (n && fread(dst, 1, n, r->f) != n) return -2;
  uint32_t crc_file = 0;
  if (fread(&crc_file, 4, 1, r->f) != 1) return -2;
  if (crc32(dst, n) != crc_file) return -2;
  return static_cast<int64_t>(n);
}

int psph_reader_close(void* rp) {
  Reader* r = static_cast<Reader*>(rp);
  if (!r) return -1;
  fclose(r->f);
  delete r;
  return 0;
}

}  // extern "C"
