// Native host runtime for deeplearning4j_tpu_torch: a copy of the JAX
// package's runtime/native/native.cpp, built and loaded by the port's
// own runtime/native_loader.py.
//
// Parity: the reference system's native layer is external — ND4J's
// jblas/JNI BLAS and Canova's record readers. The device math belongs to
// PyTorch and the CUDA kernels, so the native layer owns what runs on
// the HOST: dataset decoding (IDX/CSV) and the bounded producer/consumer
// batch queue that double-buffers input batches ahead of the device step
// (the reference's DataSetIterator prefetch role).
//
// Exposed as a plain C ABI consumed via ctypes.
// Build: g++ -O3 -shared -fPIC -std=c++17 native.cpp -o libdl4j_native.so
//        -pthread   (native_loader.py puts it under build/native/<hash>/)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- IDX IO
// Reads an IDX file (magic 0x0803 images / 0x0801 labels, big-endian
// header) into a malloc'd byte buffer. Returns 0 on success.
// dims_out must hold 4 int64 slots; ndim_out receives the rank.
int dl4j_idx_read(const char* path, uint8_t** data_out, int64_t* dims_out,
                  int* ndim_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint8_t header[4];
  if (std::fread(header, 1, 4, f) != 4) { std::fclose(f); return -2; }
  if (header[0] != 0 || header[1] != 0) { std::fclose(f); return -3; }
  const int dtype = header[2];   // 0x08 = unsigned byte (only type used)
  const int ndim = header[3];
  if (dtype != 0x08 || ndim < 1 || ndim > 4) { std::fclose(f); return -3; }
  int64_t total = 1;
  for (int i = 0; i < ndim; i++) {
    uint8_t b[4];
    if (std::fread(b, 1, 4, f) != 4) { std::fclose(f); return -2; }
    int64_t d = (int64_t(b[0]) << 24) | (int64_t(b[1]) << 16) |
                (int64_t(b[2]) << 8) | int64_t(b[3]);
    dims_out[i] = d;
    total *= d;
  }
  *ndim_out = ndim;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(total));
  if (!buf) { std::fclose(f); return -4; }
  const int64_t got = static_cast<int64_t>(std::fread(buf, 1, total, f));
  std::fclose(f);
  if (got != total) { std::free(buf); return -5; }
  *data_out = buf;
  return 0;
}

void dl4j_buffer_free(void* p) { std::free(p); }

// ---------------------------------------------------------------- CSV IO
// Parses a numeric CSV into a malloc'd float32 row-major matrix.
// Returns 0 on success; rows/cols via out params.
int dl4j_csv_read(const char* path, char delimiter, float** data_out,
                  int64_t* rows_out, int64_t* cols_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> text(static_cast<size_t>(size) + 1);
  if (std::fread(text.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  text[size] = '\0';

  std::vector<float> values;
  values.reserve(1024);
  int64_t rows = 0, cols = -1, cur_cols = 0;
  const char* p = text.data();
  const char* end = text.data() + size;
  while (p < end) {
    char* next = nullptr;
    const float v = std::strtof(p, &next);
    if (next == p) {  // no parse
      if (*p == '\n') {
        if (cur_cols > 0) {
          if (cols < 0) cols = cur_cols;
          else if (cols != cur_cols) return -3;  // ragged
          rows++;
          cur_cols = 0;
        }
        p++;
        continue;
      }
      if (*p == '\r' || *p == ' ' || *p == '\t' || *p == delimiter) {
        p++;
        continue;
      }
      return -6;  // unparsable text (e.g. header row) — match numpy, which
                  // raises on the same input rather than dropping it
    }
    values.push_back(v);
    cur_cols++;
    p = next;
    while (p < end && (*p == delimiter || *p == ' ' || *p == '\r')) p++;
    if (p < end && *p == '\n') {
      if (cols < 0) cols = cur_cols;
      else if (cols != cur_cols) return -3;
      rows++;
      cur_cols = 0;
      p++;
    }
  }
  if (cur_cols > 0) {  // final line without newline
    if (cols < 0) cols = cur_cols;
    else if (cols != cur_cols) return -3;
    rows++;
  }
  if (rows == 0 || cols <= 0) return -4;
  float* buf = static_cast<float*>(std::malloc(sizeof(float) * rows * cols));
  if (!buf) return -5;
  std::memcpy(buf, values.data(), sizeof(float) * rows * cols);
  *data_out = buf;
  *rows_out = rows;
  *cols_out = cols;
  return 0;
}

// -------------------------------------------------- bounded batch queue
// Producer/consumer ring for host-side double buffering: the Python (or
// future C++) producer decodes/assembles batches while the device step
// consumes the previous one. Blocking push/pop with shutdown.
struct Queue {
  std::deque<std::pair<uint8_t*, int64_t>> items;
  std::mutex mu;
  std::condition_variable not_empty, not_full;
  size_t capacity;
  bool closed = false;
};

void* dl4j_queue_create(int64_t capacity) {
  Queue* q = new Queue();
  q->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 2;
  return q;
}

// Copies `len` bytes; blocks while full. Returns 0, or -1 if closed.
int dl4j_queue_push(void* handle, const uint8_t* data, int64_t len) {
  Queue* q = static_cast<Queue*>(handle);
  std::unique_lock<std::mutex> lock(q->mu);
  q->not_full.wait(lock, [q] {
    return q->closed || q->items.size() < q->capacity;
  });
  if (q->closed) return -1;
  uint8_t* copy = static_cast<uint8_t*>(std::malloc(len));
  if (!copy) return -2;
  std::memcpy(copy, data, len);
  q->items.emplace_back(copy, len);
  q->not_empty.notify_one();
  return 0;
}

// Blocks while empty. Returns item length >= 0 (caller frees via
// dl4j_buffer_free), or -1 when closed AND drained.
int64_t dl4j_queue_pop(void* handle, uint8_t** data_out) {
  Queue* q = static_cast<Queue*>(handle);
  std::unique_lock<std::mutex> lock(q->mu);
  q->not_empty.wait(lock, [q] { return q->closed || !q->items.empty(); });
  if (q->items.empty()) return -1;  // closed + drained
  auto item = q->items.front();
  q->items.pop_front();
  q->not_full.notify_one();
  *data_out = item.first;
  return item.second;
}

int64_t dl4j_queue_size(void* handle) {
  Queue* q = static_cast<Queue*>(handle);
  std::lock_guard<std::mutex> lock(q->mu);
  return static_cast<int64_t>(q->items.size());
}

// Close: producers stop, consumers drain then get -1.
void dl4j_queue_close(void* handle) {
  Queue* q = static_cast<Queue*>(handle);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    q->closed = true;
  }
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

void dl4j_queue_destroy(void* handle) {
  Queue* q = static_cast<Queue*>(handle);
  {
    std::lock_guard<std::mutex> lock(q->mu);
    for (auto& item : q->items) std::free(item.first);
    q->items.clear();
    q->closed = true;
  }
  q->not_empty.notify_all();
  q->not_full.notify_all();
  delete q;
}

}  // extern "C"
