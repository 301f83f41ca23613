// Host concurrency runtime: bounded MPMC blocking queue + a parallel
// multi-file RecordIO scanner.
//
// Reference native components being reproduced (all C++ there too):
//   - framework/threadpool.h        (worker threads; here: scanner workers)
//   - operators/reader/lod_tensor_blocking_queue.h + blocking_queue.h
//     (bounded, closable producer/consumer queue feeding the device)
//   - operators/reader/open_files_op.cc (N files scanned by M threads into
//     one stream, order nondeterministic across files)
//
// Design: records move as malloc'd byte blocks through a condition-variable
// queue; scanning (fread + CRC32 + record splitting, see recordio.cpp in
// this directory — both TUs compile into one shared object) happens on
// std::threads that never touch Python, so the GIL only gates the final
// pointer copy into Python bytes.  C ABI for ctypes.
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// recordio.cpp's C ABI (linked into the same shared object).
extern "C" {
void* rio_scanner_open(const char* path);
const uint8_t* rio_scanner_next(void* h, uint32_t* len);
const char* rio_scanner_error(void* h);
void rio_scanner_close(void* h);
}

namespace {

struct Block {
  uint8_t* data;
  uint32_t len;
};

// Bounded MPMC blocking queue of byte blocks.
struct ByteQueue {
  explicit ByteQueue(size_t capacity) : cap(capacity ? capacity : 1) {}
  ~ByteQueue() {
    for (auto& b : buf) free(b.data);
  }

  // 0 ok; 1 timeout; 2 closed.  Takes ownership of data on success.
  int push(uint8_t* data, uint32_t len, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    auto pred = [&] { return closed || buf.size() < cap; };
    if (timeout_ms < 0) {
      cv_push.wait(lk, pred);
    } else if (!cv_push.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 pred)) {
      return 1;
    }
    if (closed) return 2;
    buf.push_back({data, len});
    cv_pop.notify_one();
    return 0;
  }

  // Returns owned block; data==nullptr with status: 0 drained+closed (EOF),
  // 1 timeout.
  Block pop(int timeout_ms, int* status) {
    std::unique_lock<std::mutex> lk(mu);
    auto pred = [&] { return closed || !buf.empty(); };
    if (timeout_ms < 0) {
      cv_pop.wait(lk, pred);
    } else if (!cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                pred)) {
      *status = 1;
      return {nullptr, 0};
    }
    if (!buf.empty()) {
      Block b = buf.front();
      buf.pop_front();
      cv_push.notify_one();
      *status = 0;
      return b;
    }
    *status = 0;  // closed and drained -> EOF
    return {nullptr, 0};
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu);
    closed = true;
    cv_push.notify_all();
    cv_pop.notify_all();
  }

  size_t size() {
    std::lock_guard<std::mutex> lk(mu);
    return buf.size();
  }

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Block> buf;
  size_t cap;
  bool closed = false;
};

// Parallel scanner: M worker threads pull file paths off a shared list,
// scan each RecordIO file, and push records into one ByteQueue.
struct ParallelScanner {
  ByteQueue q;
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::mutex path_mu;
  size_t next_path = 0;
  std::mutex err_mu;
  std::string err;
  int live_workers = 0;

  ParallelScanner(size_t capacity) : q(capacity) {}

  void set_error(const std::string& e) {
    std::lock_guard<std::mutex> lk(err_mu);
    if (err.empty()) err = e;
  }

  void worker() {
    for (;;) {
      std::string path;
      {
        std::lock_guard<std::mutex> lk(path_mu);
        if (next_path >= paths.size()) break;
        path = paths[next_path++];
      }
      void* s = rio_scanner_open(path.c_str());
      if (!s) {
        set_error("cannot open " + path);
        break;
      }
      for (;;) {
        uint32_t len = 0;
        const uint8_t* rec = rio_scanner_next(s, &len);
        if (!rec) {
          if (len == 1) set_error(path + ": " + rio_scanner_error(s));
          break;
        }
        uint8_t* copy = static_cast<uint8_t*>(malloc(len ? len : 1));
        memcpy(copy, rec, len);
        if (q.push(copy, len, /*timeout_ms=*/-1) != 0) {
          free(copy);            // queue closed by consumer: stop early
          rio_scanner_close(s);
          goto done;
        }
      }
      rio_scanner_close(s);
      {
        std::lock_guard<std::mutex> lk(err_mu);
        if (!err.empty()) break;  // abort remaining files on first error
      }
    }
  done:
    std::lock_guard<std::mutex> lk(q.mu);
    if (--live_workers == 0) {
      // last worker out closes the stream -> consumer sees EOF after drain
      q.closed = true;
      q.cv_pop.notify_all();
      q.cv_push.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- ByteQueue
void* cq_create(uint32_t capacity) { return new ByteQueue(capacity); }

int cq_push(void* h, const uint8_t* data, uint32_t len, int timeout_ms) {
  uint8_t* copy = static_cast<uint8_t*>(malloc(len ? len : 1));
  memcpy(copy, data, len);
  int rc = static_cast<ByteQueue*>(h)->push(copy, len, timeout_ms);
  if (rc != 0) free(copy);
  return rc;
}

// Returns malloc'd block (caller frees via cq_free) or NULL; *len set;
// *status: 0 EOF-or-ok, 1 timeout.
uint8_t* cq_pop(void* h, uint32_t* len, int timeout_ms, int* status) {
  Block b = static_cast<ByteQueue*>(h)->pop(timeout_ms, status);
  *len = b.len;
  return b.data;
}

void cq_close(void* h) { static_cast<ByteQueue*>(h)->close(); }
uint32_t cq_size(void* h) {
  return static_cast<uint32_t>(static_cast<ByteQueue*>(h)->size());
}
void cq_free(uint8_t* p) { free(p); }
void cq_destroy(void* h) { delete static_cast<ByteQueue*>(h); }

// ---------------------------------------------------- ParallelScanner
// paths: '\n'-joined file list.  nthreads workers, queue of `capacity`
// records.
void* ps_open(const char* paths, uint32_t nthreads, uint32_t capacity) {
  auto* ps = new ParallelScanner(capacity);
  const char* p = paths;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t n = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (n) ps->paths.emplace_back(p, n);
    p += n + (nl ? 1 : 0);
    if (!nl) break;
  }
  if (nthreads == 0) nthreads = 1;
  if (nthreads > ps->paths.size() && !ps->paths.empty())
    nthreads = static_cast<uint32_t>(ps->paths.size());
  ps->live_workers = static_cast<int>(nthreads);
  for (uint32_t i = 0; i < nthreads; i++)
    ps->workers.emplace_back([ps] { ps->worker(); });
  return ps;
}

// Next record (malloc'd, caller cq_free's) or NULL: *status 0 -> EOF,
// 1 -> timeout, 2 -> error (see ps_error).
uint8_t* ps_next(void* h, uint32_t* len, int timeout_ms, int* status) {
  auto* ps = static_cast<ParallelScanner*>(h);
  Block b = ps->q.pop(timeout_ms, status);
  if (!b.data && *status == 0) {
    std::lock_guard<std::mutex> lk(ps->err_mu);
    if (!ps->err.empty()) *status = 2;
  }
  *len = b.len;
  return b.data;
}

const char* ps_error(void* h) {
  auto* ps = static_cast<ParallelScanner*>(h);
  std::lock_guard<std::mutex> lk(ps->err_mu);
  return ps->err.c_str();
}

void ps_close(void* h) {
  auto* ps = static_cast<ParallelScanner*>(h);
  ps->q.close();
  for (auto& t : ps->workers) t.join();
  delete ps;
}

}  // extern "C"
