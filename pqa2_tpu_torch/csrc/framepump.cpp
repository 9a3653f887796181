// framepump — threaded y4m/raw frame reader with a prefetch ring.
//
// The native data-loader for pqa2_tpu (SURVEY.md section 2.3 N1): the
// reference pays one process spawn + pipe per decode (ffmpeg/OpenCV
// subprocesses); here a reader thread streams frames into a ring of
// preallocated buffers so the Python side (and the H2D copy) never waits on
// file I/O. Exposed as a C API consumed via ctypes (pqa2_tpu/io/native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libframepump.so framepump.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Y4MHeader {
  int width = 0;
  int height = 0;
  int fps_num = 30;
  int fps_den = 1;
  int bit_depth = 8;
  int chroma_w = 0;  // chroma plane width in samples
  int chroma_h = 0;
  char colorspace[32] = "420mpeg2";
};

bool parse_y4m_header(FILE* f, Y4MHeader* h) {
  char line[1024];
  if (!fgets(line, sizeof(line), f)) return false;
  if (strncmp(line, "YUV4MPEG2", 9) != 0) return false;
  // Tokenise " W<..> H<..> F<n>:<d> C<..>"
  char* tok = strtok(line + 9, " \n");
  std::string cs = "420mpeg2";
  while (tok) {
    switch (tok[0]) {
      case 'W': h->width = atoi(tok + 1); break;
      case 'H': h->height = atoi(tok + 1); break;
      case 'F': sscanf(tok + 1, "%d:%d", &h->fps_num, &h->fps_den); break;
      case 'C': cs = tok + 1; break;
      default: break;
    }
    tok = strtok(nullptr, " \n");
  }
  snprintf(h->colorspace, sizeof(h->colorspace), "%s", cs.c_str());
  if (h->width <= 0 || h->height <= 0) return false;
  h->bit_depth = 8;
  size_t p = cs.find('p');
  if (p != std::string::npos && p > 2) {
    int d = atoi(cs.c_str() + p + 1);
    if (d > 8) h->bit_depth = d;
  }
  if (cs.rfind("444", 0) == 0) {
    h->chroma_w = h->width;
    h->chroma_h = h->height;
  } else if (cs.rfind("422", 0) == 0) {
    h->chroma_w = h->width / 2;
    h->chroma_h = h->height;
  } else {  // 420*
    h->chroma_w = h->width / 2;
    h->chroma_h = h->height / 2;
  }
  return true;
}

struct Pump {
  FILE* f = nullptr;
  Y4MHeader hdr;
  size_t frame_bytes = 0;  // y + 2*chroma payload (no FRAME marker)
  int ring_size = 0;
  std::vector<std::vector<uint8_t>> ring;
  // ring state
  std::mutex mu;
  std::condition_variable cv_reader, cv_consumer;
  int64_t produced = 0;  // frames fully read into the ring
  int64_t consumed = 0;  // frames handed to the consumer
  bool eof = false;
  bool error = false;
  bool stop = false;
  std::thread reader;

  ~Pump() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_reader.notify_all();
    cv_consumer.notify_all();
    if (reader.joinable()) reader.join();
    if (f) fclose(f);
  }

  void reader_loop() {
    char marker[8];
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_reader.wait(lk, [&] { return stop || produced - consumed < ring_size; });
      if (stop) return;
      lk.unlock();

      // Read FRAME marker line (may carry params until '\n').
      int c;
      size_t mi = 0;
      bool got = false;
      while ((c = fgetc(f)) != EOF) {
        if (mi < 5) marker[mi] = (char)c;
        ++mi;
        if (c == '\n') {
          got = mi >= 6 && strncmp(marker, "FRAME", 5) == 0;
          break;
        }
      }
      if (c == EOF || !got) {
        std::lock_guard<std::mutex> lk2(mu);
        eof = true;
        if (c != EOF) error = true;  // junk where FRAME expected
        cv_consumer.notify_all();
        return;
      }
      auto& buf = ring[produced % ring_size];
      size_t got_bytes = fread(buf.data(), 1, frame_bytes, f);
      std::lock_guard<std::mutex> lk2(mu);
      if (got_bytes != frame_bytes) {
        eof = true;
        error = true;  // truncated frame
      } else {
        ++produced;
      }
      cv_consumer.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle or null. ring_size = prefetch depth.
void* fp_open(const char* path, int ring_size) {
  if (ring_size < 2) ring_size = 2;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* p = new Pump();
  p->f = f;
  if (!parse_y4m_header(f, &p->hdr)) {
    delete p;
    return nullptr;
  }
  int samp = p->hdr.bit_depth > 8 ? 2 : 1;
  p->frame_bytes = samp * (size_t)(p->hdr.width * p->hdr.height +
                                   2 * p->hdr.chroma_w * p->hdr.chroma_h);
  p->ring_size = ring_size;
  p->ring.resize(ring_size);
  for (auto& b : p->ring) b.resize(p->frame_bytes);
  p->reader = std::thread([p] { p->reader_loop(); });
  return p;
}

// info[0..7] = width, height, fps_num, fps_den, bit_depth, chroma_w,
//              chroma_h, frame_bytes
void fp_info(void* handle, int64_t* info) {
  auto* p = static_cast<Pump*>(handle);
  info[0] = p->hdr.width;
  info[1] = p->hdr.height;
  info[2] = p->hdr.fps_num;
  info[3] = p->hdr.fps_den;
  info[4] = p->hdr.bit_depth;
  info[5] = p->hdr.chroma_w;
  info[6] = p->hdr.chroma_h;
  info[7] = (int64_t)p->frame_bytes;
}

// Copy the next frame into dst (frame_bytes). 1 = ok, 0 = eof, -1 = error.
int fp_next(void* handle, uint8_t* dst) {
  auto* p = static_cast<Pump*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_consumer.wait(lk, [&] {
    return p->stop || p->produced > p->consumed || p->eof;
  });
  if (p->stop) return -1;
  if (p->produced > p->consumed) {
    auto& buf = p->ring[p->consumed % p->ring_size];
    memcpy(dst, buf.data(), p->frame_bytes);
    ++p->consumed;
    p->cv_reader.notify_one();
    return 1;
  }
  return p->error ? -1 : 0;  // eof
}

// Fill up to n frames contiguously; returns frames copied (may be < n at eof),
// or -1 on error. dst must hold n * frame_bytes.
int fp_next_batch(void* handle, uint8_t* dst, int n) {
  auto* p = static_cast<Pump*>(handle);
  for (int i = 0; i < n; ++i) {
    int r = fp_next(handle, dst + (size_t)i * p->frame_bytes);
    if (r < 0) return -1;
    if (r == 0) return i;
  }
  return n;
}

void fp_close(void* handle) { delete static_cast<Pump*>(handle); }

// ---------------------------------------------------------------------------
// framewriter — the write-side pump (SURVEY.md section 2.3 N1, symmetric to
// the reader): a writer thread drains a ring of queued frames to disk so the
// Python side (scoring, alignment) never blocks on file I/O. Used for the
// aligned-trim artifacts and the fake-capture backend.

namespace {

struct WPump {
  FILE* f = nullptr;
  size_t frame_bytes = 0;
  int ring_size = 0;
  std::vector<std::vector<uint8_t>> ring;
  std::mutex mu;
  std::condition_variable cv_writer, cv_producer;
  int64_t queued = 0;   // frames handed to the pump
  int64_t written = 0;  // frames flushed to disk
  bool error = false;
  bool stop = false;  // no more frames will be queued
  std::thread writer;

  ~WPump() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_writer.notify_all();
    cv_producer.notify_all();
    if (writer.joinable()) writer.join();
    if (f) fclose(f);
  }

  void writer_loop() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_writer.wait(lk, [&] { return stop || queued > written; });
      if (queued == written && stop) return;
      if (queued == written) continue;
      auto& buf = ring[written % ring_size];
      lk.unlock();
      bool ok = fwrite("FRAME\n", 1, 6, f) == 6 &&
                fwrite(buf.data(), 1, frame_bytes, f) == frame_bytes;
      lk.lock();
      if (!ok) {
        error = true;
        stop = true;
        cv_producer.notify_all();
        return;
      }
      ++written;
      cv_producer.notify_all();
    }
  }
};

}  // namespace

// Create a writer: writes the stream header immediately. header_line must be
// the full "YUV4MPEG2 ...\n" line; frame_bytes the per-frame payload size.
void* fw_open(const char* path, const char* header_line, int64_t frame_bytes,
              int ring_size) {
  if (ring_size < 2) ring_size = 2;
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  size_t hl = strlen(header_line);
  if (fwrite(header_line, 1, hl, f) != hl) {
    fclose(f);
    return nullptr;
  }
  auto* p = new WPump();
  p->f = f;
  p->frame_bytes = (size_t)frame_bytes;
  p->ring_size = ring_size;
  p->ring.resize(ring_size);
  for (auto& b : p->ring) b.resize(p->frame_bytes);
  p->writer = std::thread([p] { p->writer_loop(); });
  return p;
}

// Queue one frame payload (frame_bytes). Blocks only when the ring is full.
// 1 = queued, -1 = writer failed.
int fw_write(void* handle, const uint8_t* src) {
  auto* p = static_cast<WPump*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_producer.wait(lk, [&] {
    return p->error || p->queued - p->written < p->ring_size;
  });
  if (p->error) return -1;
  auto& buf = p->ring[p->queued % p->ring_size];
  memcpy(buf.data(), src, p->frame_bytes);
  ++p->queued;
  p->cv_writer.notify_one();
  return 1;
}

// Flush remaining frames and close. 0 = ok, -1 = a write failed.
int fw_close(void* handle) {
  auto* p = static_cast<WPump*>(handle);
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->stop = true;
    p->cv_writer.notify_all();
    p->cv_producer.wait(lk, [&] { return p->error || p->written == p->queued; });
  }
  int rc = p->error ? -1 : 0;
  // stdio buffering: the tail of the file may still live in the FILE*
  // buffer — a failed flush/close (ENOSPC) must surface, not silently
  // truncate the artifact.
  if (p->f) {
    if (fflush(p->f) != 0) rc = -1;
    if (fclose(p->f) != 0) rc = -1;
    p->f = nullptr;
  }
  delete p;
  return rc;
}

}  // extern "C"
