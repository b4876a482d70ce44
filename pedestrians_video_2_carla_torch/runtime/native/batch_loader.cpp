// Native batch loader: multi-threaded gather of clip rows from memory-mapped
// binary subset caches into contiguous batch buffers.
//
// A host-side core that (a) mmaps a flat binary rendering of a subset and
// (b) assembles shuffled batches with parallel memcpy, so Python only
// orchestrates and the GIL never serializes the copy bandwidth. Bound with
// ctypes (runtime/native_loader.py builds it with g++ into build/native/).
//
// Build: g++ -O3 -shared -fPIC -o libbatch_loader.so batch_loader.cpp
//        -lpthread
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

struct MappedFile {
  void *data;
  size_t size;
  int fd;
};

// Map a file read-only; returns nullptr on failure.
MappedFile *bl_open(const char *path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0)
    return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void *data = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (data == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(data, st.st_size, MADV_WILLNEED);
  return new MappedFile{data, static_cast<size_t>(st.st_size), fd};
}

void bl_close(MappedFile *f) {
  if (!f)
    return;
  munmap(f->data, f->size);
  ::close(f->fd);
  delete f;
}

// Gather `num_indices` rows of `row_bytes` each, located at
// `base_offset + index * row_bytes` in the mapped file, into `out`
// (contiguous, num_indices * row_bytes). Parallelized over `num_threads`.
// Returns 0 on success, -1 on out-of-bounds.
int bl_gather(MappedFile *f, uint64_t base_offset, uint64_t row_bytes,
              const int64_t *indices, int64_t num_indices, uint8_t *out,
              int num_threads) {
  if (!f)
    return -1;
  const uint8_t *base = static_cast<const uint8_t *>(f->data) + base_offset;
  // bounds check up front so worker threads can memcpy unconditionally
  for (int64_t i = 0; i < num_indices; ++i) {
    uint64_t end = base_offset + (indices[i] + 1) * row_bytes;
    if (indices[i] < 0 || end > f->size)
      return -1;
  }
  if (num_threads < 1)
    num_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < num_indices) {
      std::memcpy(out + i * row_bytes, base + indices[i] * row_bytes,
                  row_bytes);
    }
  };
  if (num_threads == 1 || num_indices < 4) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t)
      threads.emplace_back(worker);
    for (auto &t : threads)
      t.join();
  }
  return 0;
}

// Multi-array variant: gather the same indices from `num_arrays` arrays
// (each with its own base offset / row size) into separate output buffers.
int bl_gather_multi(MappedFile *f, const uint64_t *base_offsets,
                    const uint64_t *row_bytes, int num_arrays,
                    const int64_t *indices, int64_t num_indices,
                    uint8_t **outs, int num_threads) {
  for (int a = 0; a < num_arrays; ++a) {
    int rc = bl_gather(f, base_offsets[a], row_bytes[a], indices, num_indices,
                       outs[a], num_threads);
    if (rc != 0)
      return rc;
  }
  return 0;
}

}  // extern "C"
