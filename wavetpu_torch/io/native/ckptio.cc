// Native checkpoint IO: asynchronous file writer with CRC32 and atomic
// rename.  The runtime-side counterpart of the reference's C++ IO layer
// (every reference variant is a C++ binary doing its own file IO,
// openmp_sol.cpp:216-243); here the hot path is PyTorch/CUDA and this
// library carries the *runtime* concern: getting multi-GB shard state to
// disk without stalling the solver loop or leaving torn files behind on
// preemption.
//
// Contract (C ABI, driven from Python via ctypes -
// wavetpu_torch/io/nativeio.py):
//   w = ckpt_writer_open(tmp_path)      open the temp file
//   ckpt_writer_write(w, buf, len)      enqueue a chunk (ZERO-COPY: the
//                                       caller must keep buf alive and
//                                       unmodified until finish/abort)
//   ckpt_writer_finish(w, final_path,   drain the queue, fsync, atomically
//                      &crc)            rename tmp -> final, return the
//                                       CRC32 of the whole stream
//   ckpt_writer_abort(w)                drop the queue, unlink the temp
//
// A single background thread per writer consumes the queue, so the Python
// caller overlaps the device->host copy of the next shard with the disk
// write of the current one.  CRC32 is the standard reflected polynomial
// 0xEDB88320 (zlib-compatible: crc32(data) == zlib.crc32(data)), computed
// slice-by-8.
//
// Build (nativeio.py, at first use, into the git-ignored build directory):
//   g++ -O3 -shared -fPIC -pthread ckptio.cc -o libckptio-<hash>.so

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

#include <fcntl.h>
#include <unistd.h>

namespace {

// ---- CRC32 (reflected 0xEDB88320, zlib-compatible), slice-by-8 ----------

uint32_t g_crc_tab[8][256];

void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (-(c & 1u)));
    g_crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      g_crc_tab[t][i] =
          (g_crc_tab[t - 1][i] >> 8) ^ g_crc_tab[0][g_crc_tab[t - 1][i] & 0xff];
}

struct CrcInitOnce {
  CrcInitOnce() { crc_init(); }
} g_crc_init_once;

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n >= 8) {
    crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
    uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) |
                  ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
    crc = g_crc_tab[7][crc & 0xff] ^ g_crc_tab[6][(crc >> 8) & 0xff] ^
          g_crc_tab[5][(crc >> 16) & 0xff] ^ g_crc_tab[4][crc >> 24] ^
          g_crc_tab[3][hi & 0xff] ^ g_crc_tab[2][(hi >> 8) & 0xff] ^
          g_crc_tab[1][(hi >> 16) & 0xff] ^ g_crc_tab[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ g_crc_tab[0][(crc ^ *p++) & 0xff];
  return ~crc;
}

// ---- async writer --------------------------------------------------------

struct Chunk {
  const uint8_t* data;
  size_t len;
};

struct Writer {
  int fd = -1;
  std::string tmp_path;
  std::deque<Chunk> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool closing = false;   // no more chunks will arrive
  int io_errno = 0;       // first write error, reported at finish
  uint32_t crc = 0;

  void run() {
    for (;;) {
      Chunk c;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return !queue.empty() || closing; });
        if (queue.empty()) return;
        c = queue.front();
        queue.pop_front();
      }
      if (io_errno == 0) {
        const uint8_t* p = c.data;
        size_t left = c.len;
        while (left > 0) {
          ssize_t w = ::write(fd, p, left);
          if (w < 0) {
            if (errno == EINTR) continue;
            io_errno = errno;
            break;
          }
          p += w;
          left -= (size_t)w;
        }
        if (io_errno == 0) crc = crc32_update(crc, c.data, c.len);
      }
      cv.notify_all();  // finish() waits for the queue to drain
    }
  }
};

}  // namespace

extern "C" {

void* ckpt_writer_open(const char* tmp_path) {
  int fd = ::open(tmp_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return nullptr;
  Writer* w = new Writer();
  w->fd = fd;
  w->tmp_path = tmp_path;
  w->worker = std::thread([w] { w->run(); });
  return w;
}

int ckpt_writer_write(void* handle, const void* buf, uint64_t len) {
  Writer* w = (Writer*)handle;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    if (w->closing) return -1;
    w->queue.push_back(Chunk{(const uint8_t*)buf, (size_t)len});
  }
  w->cv.notify_all();
  return 0;
}

// Drain, fsync, rename to final_path; *crc_out gets the stream CRC32.
// Returns 0 on success, -errno on the first IO failure (temp unlinked).
int ckpt_writer_finish(void* handle, const char* final_path,
                       uint64_t* crc_out) {
  Writer* w = (Writer*)handle;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->closing = true;
  }
  w->cv.notify_all();
  w->worker.join();
  int err = w->io_errno;
  if (err == 0 && ::fsync(w->fd) != 0) err = errno;
  ::close(w->fd);
  if (err == 0 && ::rename(w->tmp_path.c_str(), final_path) != 0) err = errno;
  if (err != 0) ::unlink(w->tmp_path.c_str());
  if (crc_out) *crc_out = w->crc;
  delete w;
  return err == 0 ? 0 : -err;
}

int ckpt_writer_abort(void* handle) {
  Writer* w = (Writer*)handle;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.clear();
    w->closing = true;
  }
  w->cv.notify_all();
  w->worker.join();
  ::close(w->fd);
  ::unlink(w->tmp_path.c_str());
  delete w;
  return 0;
}

}  // extern "C"
