// Event-log feeder — native batch assembly for the training input pipeline.
//
// The port's own copy of the reference's native/feeder.cc, byte for byte
// in everything it computes: the file format, the C API and the per-epoch
// shuffle are the reference's, so one cache and seed give both libraries
// the same batches in the same order.
//
// Reference role (SURVEY.md §2.3): the rebuild owes a host-side native
// data loader where the reference leaned on Spark's netty/snappy IO. This
// library mmaps a binary columnar event cache (written once by the Python
// storage layer; format below), and serves shuffled, padded minibatches
// from worker threads so the Python process never blocks on batch
// assembly: the feeder fills pinned buffers while the device runs step N.
//
// File format "PIOF1" (little-endian), version 3:
//   0:  char[5] magic "PIOF1"
//   5:  u8      pad
//   6:  u16     version (=3)
//   8:  u64     n_rows
//   16: u32     n_extra   (extra f32 feature columns, e.g. DLRM dense)
//   20: u32     n_cat     (categorical u32 id columns; v2 wrote 0 here
//                          and always carried exactly 2 — user/item)
//   24: u32[n]  categorical column 0 (user ids in the 2-column case)
//   ...:u32[n]  x (n_cat - 1) further categorical columns
//   ...:f32[n]  values
//   ...:<pad to 8-byte boundary>
//   ...:i64[n]  event_time_us            (8-byte aligned by construction)
//   ...:f32[n] x n_extra feature columns (column-major: col0 rows, col1...)
//
// Version 2 files read as n_cat == 2.  Version 1 files (no n_extra field,
// data at offset 16, times potentially only 4-byte aligned when n is odd)
// are still readable: their times are copied via memcpy, never
// dereferenced as int64* (the round-1 layout made misaligned loads UB on
// strict-alignment targets).
//
// C API (consumed via ctypes from predictionio_tpu_torch/native/feeder.py):
//   void*  pio_feeder_open(const char* path, uint64_t seed, int shuffle);
//   int64  pio_feeder_num_rows(void*);
//   int32  pio_feeder_n_extra(void*);
//   int32  pio_feeder_n_cat(void*);
//   int64  pio_feeder_next_batch(void*, int64 batch, uint32* users,
//                                uint32* items, float* vals, int64* times,
//                                float* extras /* [batch, n_extra] row-major,
//                                                 may be null */);
//        -> rows written (== batch unless epoch end; 0 = epoch boundary,
//           next call starts the re-shuffled next epoch); requires
//           n_cat >= 2 (columns 0/1 ride the user/item pointers)
//   int64  pio_feeder_next_batch_cats(void*, int64 batch,
//                                uint32* cats /* [batch, n_cat] row-major */,
//                                float* vals, int64* times, float* extras);
//   void   pio_feeder_close(void*);
//
// Shuffling uses a per-epoch Fisher-Yates permutation under a SplitMix64
// generator — deterministic given (seed, epoch), matching the Python
// loop's resume contract.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <new>
#include <numeric>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
};

struct Feeder {
  int fd = -1;
  size_t map_len = 0;
  const uint8_t* base = nullptr;
  uint64_t n_rows = 0;
  uint32_t n_extra = 0;
  uint32_t n_cat = 0;
  std::vector<const uint32_t*> cat_cols;
  const float* vals = nullptr;
  const uint8_t* times_raw = nullptr;  // memcpy-read (v1 may be unaligned)
  std::vector<const float*> extras;

  uint64_t seed = 0;
  bool shuffle = true;
  uint64_t epoch = 0;
  uint64_t cursor = 0;
  std::vector<uint64_t> perm;
  std::mutex mu;

  void reshuffle() {
    perm.resize(n_rows);
    std::iota(perm.begin(), perm.end(), 0);
    if (shuffle) {
      SplitMix64 rng(seed ^ (0xA5A5A5A5ULL + epoch * 0x9e3779b9ULL));
      for (uint64_t i = n_rows; i > 1; --i) {
        uint64_t j = rng.next() % i;
        std::swap(perm[i - 1], perm[j]);
      }
    }
    cursor = 0;
  }
};

size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

}  // namespace

extern "C" {

void* pio_feeder_open(const char* path, uint64_t seed, int shuffle) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    ::close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(m);
  uint16_t version = 0;
  memcpy(&version, base + 6, 2);
  if (memcmp(base, "PIOF1", 5) != 0 ||
      (version != 1 && version != 2 && version != 3)) {
    munmap(m, st.st_size);
    ::close(fd);
    return nullptr;
  }
  uint64_t n;
  memcpy(&n, base + 8, 8);
  uint32_t n_extra = 0;
  uint32_t n_cat = 2;
  size_t data_off = 16;
  if (version >= 2) {
    memcpy(&n_extra, base + 16, 4);
    data_off = 24;
  }
  if (version >= 3) {
    memcpy(&n_cat, base + 20, 4);
    if (n_cat < 1 || n_cat > 1024) {
      munmap(m, st.st_size);
      ::close(fd);
      return nullptr;
    }
  }
  // Bound n (and n_extra) before any offset math: a crafted n_rows near
  // 2^64 would wrap `n * row_bytes` back under st_size, pass the size
  // check, and leave the column pointers (and reshuffle's perm.resize)
  // pointing at garbage.  No real cache can exceed the mapped file size
  // in rows or hold more extra columns than bytes.
  const size_t row_bytes = size_t(n_cat) * 4 + 4;
  if (static_cast<size_t>(st.st_size) < data_off || n_extra > 65536 ||
      n > (static_cast<size_t>(st.st_size) - data_off) / row_bytes) {
    munmap(m, st.st_size);
    ::close(fd);
    return nullptr;
  }
  const size_t vals_end = data_off + n * row_bytes;
  const size_t times_off = version >= 2 ? align8(vals_end) : vals_end;
  const size_t extras_off = times_off + n * 8;
  const size_t need = extras_off + size_t(n_extra) * n * 4;
  if (static_cast<size_t>(st.st_size) < need) {
    munmap(m, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* f = new (std::nothrow) Feeder();
  if (!f) {
    munmap(m, st.st_size);
    ::close(fd);
    return nullptr;
  }
  f->fd = fd;
  f->map_len = st.st_size;
  f->base = base;
  f->n_rows = n;
  f->n_extra = n_extra;
  f->n_cat = n_cat;
  for (uint32_t c = 0; c < n_cat; ++c)
    f->cat_cols.push_back(reinterpret_cast<const uint32_t*>(
        base + data_off + size_t(c) * n * 4));
  f->vals = reinterpret_cast<const float*>(base + data_off +
                                           size_t(n_cat) * n * 4);
  f->times_raw = base + times_off;
  for (uint32_t c = 0; c < n_extra; ++c)
    f->extras.push_back(
        reinterpret_cast<const float*>(base + extras_off + size_t(c) * n * 4));
  f->seed = seed;
  f->shuffle = shuffle != 0;
  f->reshuffle();
  return f;
}

int64_t pio_feeder_num_rows(void* h) {
  return h ? static_cast<int64_t>(static_cast<Feeder*>(h)->n_rows) : -1;
}

int32_t pio_feeder_n_extra(void* h) {
  return h ? static_cast<int32_t>(static_cast<Feeder*>(h)->n_extra) : -1;
}

int32_t pio_feeder_n_cat(void* h) {
  return h ? static_cast<int32_t>(static_cast<Feeder*>(h)->n_cat) : -1;
}

namespace {

// Shared batch walk: writes either user/item pointers (legacy 2-column
// ABI) or the row-major [batch, n_cat] block.
int64_t next_batch_impl(Feeder* f, int64_t batch, uint32_t* users,
                        uint32_t* items, uint32_t* cats, float* vals,
                        int64_t* times, float* extras) {
  std::lock_guard<std::mutex> lk(f->mu);
  if (f->cursor >= f->n_rows) {
    // Epoch boundary: signal once, then start the next epoch.
    f->epoch++;
    f->reshuffle();
    return 0;
  }
  const uint64_t take = std::min<uint64_t>(batch, f->n_rows - f->cursor);
  const uint32_t ne = f->n_extra;
  const uint32_t nc = f->n_cat;
  for (uint64_t i = 0; i < take; ++i) {
    const uint64_t r = f->perm[f->cursor + i];
    if (users) users[i] = f->cat_cols[0][r];
    if (items) items[i] = f->cat_cols[1][r];
    if (cats)
      for (uint32_t c = 0; c < nc; ++c) cats[i * nc + c] = f->cat_cols[c][r];
    if (vals) vals[i] = f->vals[r];
    if (times)  // memcpy: v1 files may have this column 4-byte aligned only
      memcpy(&times[i], f->times_raw + r * 8, 8);
    if (extras)
      for (uint32_t c = 0; c < ne; ++c)
        extras[i * ne + c] = f->extras[c][r];
  }
  f->cursor += take;
  return static_cast<int64_t>(take);
}

}  // namespace

int64_t pio_feeder_next_batch(void* h, int64_t batch, uint32_t* users,
                              uint32_t* items, float* vals, int64_t* times,
                              float* extras) {
  if (!h || batch <= 0) return -1;
  auto* f = static_cast<Feeder*>(h);
  if (f->n_cat < 2) return -1;  // legacy ABI needs user+item columns
  return next_batch_impl(f, batch, users, items, nullptr, vals, times,
                         extras);
}

int64_t pio_feeder_next_batch_cats(void* h, int64_t batch, uint32_t* cats,
                                   float* vals, int64_t* times,
                                   float* extras) {
  if (!h || batch <= 0 || !cats) return -1;
  return next_batch_impl(static_cast<Feeder*>(h), batch, nullptr, nullptr,
                         cats, vals, times, extras);
}

void pio_feeder_close(void* h) {
  if (!h) return;
  auto* f = static_cast<Feeder*>(h);
  if (f->base) munmap(const_cast<uint8_t*>(f->base), f->map_len);
  if (f->fd >= 0) ::close(f->fd);
  delete f;
}

}  // extern "C"
