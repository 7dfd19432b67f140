// Host-side parallel batch loader for the training input pipeline.
//
// The port's copy of bert_vits2_tpu/native/dataloader.cc: everything from
// the first #include on is that file's text (a test pins the two), so the
// two packages read a corpus into the same bytes. The reference feeds its
// trainer through torch DataLoader worker *processes*
// (train_ms.py:127-146); this library loads a whole batch of .npy / .wav
// files with a persistent thread pool, writing each item directly into its
// padded row of a preallocated numpy buffer: one pass, no intermediate
// arrays, and the interpreter lock released for the whole call (ctypes),
// so the Trainer's loading thread does not hold up the step's launches.
//
// ABI (ctypes, see native/__init__.py):
//   bv2_pool_create(n_threads) -> handle
//   bv2_pool_destroy(handle)
//   bv2_load_npy_batch(handle, paths, n, dst, row_stride, max_elems,
//                      out_rows, out_cols) -> 0 | first-error index+1
//       minimal NPY v1/v2 parser; accepts C-order <f4 (float32) arrays,
//       copies min(total, max_elems) floats into dst + i*row_stride and
//       zero-fills the remainder of the row.
//   bv2_load_wav_batch(handle, paths, n, dst, row_stride, max_samples,
//                      out_len, out_sr) -> same contract; RIFF/WAVE with
//       PCM16 / PCM32 / float32 samples, multichannel averaged to mono,
//       scaled to [-1, 1] like data/dataset.py load_wav.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    if (n < 1) n = 1;
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Run(); });
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Run() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

struct Latch {
  explicit Latch(int n) : remaining(n) {}
  void CountDown() {
    std::lock_guard<std::mutex> lk(mu);
    if (--remaining == 0) cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return remaining == 0; });
  }
  std::mutex mu;
  std::condition_variable cv;
  int remaining;
};

bool ReadFile(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(out->data(), 1, out->size(), f) : 0;
  std::fclose(f);
  return got == out->size();
}

// --- minimal .npy parsing (format spec v1.0/2.0, C-order <f4 only) ---

bool ParseNpyF32(const std::vector<uint8_t>& buf, const float** data,
                 long* rows, long* cols) {
  if (buf.size() < 10 || std::memcmp(buf.data(), "\x93NUMPY", 6) != 0)
    return false;
  int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = buf[8] | (buf[9] << 8);
    hoff = 10;
  } else {
    if (buf.size() < 12) return false;
    hlen = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
           (static_cast<size_t>(buf[11]) << 24);
    hoff = 12;
  }
  if (buf.size() < hoff + hlen) return false;
  std::string h(reinterpret_cast<const char*>(buf.data() + hoff), hlen);
  if (h.find("'<f4'") == std::string::npos &&
      h.find("\"<f4\"") == std::string::npos)
    return false;
  if (h.find("'fortran_order': True") != std::string::npos) return false;
  size_t sp = h.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t lp = h.find('(', sp), rp = h.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string dims = h.substr(lp + 1, rp - lp - 1);
  long d[4] = {1, 1, 1, 1};
  int nd = 0;
  const char* s = dims.c_str();
  while (*s && nd < 4) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    char* end;
    long v = std::strtol(s, &end, 10);
    if (end == s) break;
    d[nd++] = v;
    s = end;
  }
  if (nd == 0) return false;
  long r = d[0], c = 1;
  for (int i = 1; i < nd; ++i) c *= d[i];
  size_t need = hoff + hlen + sizeof(float) * static_cast<size_t>(r) * c;
  if (buf.size() < need) return false;
  *data = reinterpret_cast<const float*>(buf.data() + hoff + hlen);
  *rows = r;
  *cols = c;
  return true;
}

// --- minimal RIFF/WAVE parsing ---

bool ParseWav(const std::vector<uint8_t>& buf, float* dst, long max_samples,
              long* out_len, int* out_sr) {
  if (buf.size() < 44 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  int channels = 0, sr = 0, bits = 0, fmt = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;
  while (pos + 8 <= buf.size()) {
    uint32_t cklen;
    std::memcpy(&cklen, buf.data() + pos + 4, 4);
    const uint8_t* ck = buf.data() + pos;
    if (std::memcmp(ck, "fmt ", 4) == 0 && pos + 8 + 16 <= buf.size()) {
      uint16_t f, ch, b;
      uint32_t s;
      std::memcpy(&f, ck + 8, 2);
      std::memcpy(&ch, ck + 10, 2);
      std::memcpy(&s, ck + 12, 4);
      std::memcpy(&b, ck + 22, 2);
      fmt = f;
      channels = ch;
      sr = static_cast<int>(s);
      bits = b;
    } else if (std::memcmp(ck, "data", 4) == 0) {
      data = ck + 8;
      data_len = cklen;
      if (pos + 8 + data_len > buf.size()) data_len = buf.size() - pos - 8;
    }
    pos += 8 + cklen + (cklen & 1);
  }
  if (!data || channels < 1 || sr <= 0) return false;
  *out_sr = sr;
  long frames;
  if ((fmt == 1 || fmt == 0xFFFE) && bits == 16) {
    frames = static_cast<long>(data_len / (2 * channels));
    long n = frames < max_samples ? frames : max_samples;
    const int16_t* p = reinterpret_cast<const int16_t*>(data);
    for (long i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      dst[i] = acc / (channels * 32768.0f);
    }
    *out_len = n;
  } else if ((fmt == 1 || fmt == 0xFFFE) && bits == 32) {
    frames = static_cast<long>(data_len / (4 * channels));
    long n = frames < max_samples ? frames : max_samples;
    const int32_t* p = reinterpret_cast<const int32_t*>(data);
    for (long i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      dst[i] = static_cast<float>(acc / (channels * 2147483648.0));
    }
    *out_len = n;
  } else if (fmt == 3 && bits == 32) {
    frames = static_cast<long>(data_len / (4 * channels));
    long n = frames < max_samples ? frames : max_samples;
    const float* p = reinterpret_cast<const float*>(data);
    for (long i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int c = 0; c < channels; ++c) acc += p[i * channels + c];
      dst[i] = acc / channels;
    }
    *out_len = n;
  } else {
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* bv2_pool_create(int n_threads) { return new ThreadPool(n_threads); }

void bv2_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

int bv2_load_npy_batch(void* pool, const char** paths, int n, float* dst,
                       long row_stride, long max_elems, long* out_rows,
                       long* out_cols) {
  ThreadPool* tp = static_cast<ThreadPool*>(pool);
  Latch latch(n);
  std::atomic<int> err{0};
  for (int i = 0; i < n; ++i) {
    tp->Submit([=, &latch, &err] {
      std::vector<uint8_t> buf;
      const float* data;
      long rows, cols;
      float* row = dst + static_cast<size_t>(i) * row_stride;
      if (ReadFile(paths[i], &buf) && ParseNpyF32(buf, &data, &rows, &cols)) {
        long total = rows * cols;
        long ncopy = total < max_elems ? total : max_elems;
        std::memcpy(row, data, sizeof(float) * ncopy);
        std::memset(row + ncopy, 0, sizeof(float) * (row_stride - ncopy));
        out_rows[i] = rows;
        out_cols[i] = cols;
      } else {
        std::memset(row, 0, sizeof(float) * row_stride);
        out_rows[i] = -1;
        out_cols[i] = -1;
        int expected = 0;
        err.compare_exchange_strong(expected, i + 1);
      }
      latch.CountDown();
    });
  }
  latch.Wait();
  return err.load();
}

int bv2_load_wav_batch(void* pool, const char** paths, int n, float* dst,
                       long row_stride, long max_samples, long* out_len,
                       int* out_sr) {
  ThreadPool* tp = static_cast<ThreadPool*>(pool);
  Latch latch(n);
  std::atomic<int> err{0};
  for (int i = 0; i < n; ++i) {
    tp->Submit([=, &latch, &err] {
      std::vector<uint8_t> buf;
      float* row = dst + static_cast<size_t>(i) * row_stride;
      long len = 0;
      int sr = 0;
      if (ReadFile(paths[i], &buf) &&
          ParseWav(buf, row, max_samples, &len, &sr)) {
        std::memset(row + len, 0, sizeof(float) * (row_stride - len));
        out_len[i] = len;
        out_sr[i] = sr;
      } else {
        std::memset(row, 0, sizeof(float) * row_stride);
        out_len[i] = -1;
        out_sr[i] = -1;
        int expected = 0;
        err.compare_exchange_strong(expected, i + 1);
      }
      latch.CountDown();
    });
  }
  latch.Wait();
  return err.load();
}

}  // extern "C"
