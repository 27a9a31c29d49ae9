// Native host-side runtime for the vector gallery.
//
// The reference delegated its native needs to the external Qdrant server
// (a Rust binary consumed via Docker, 02_qdrant_environment_setting.txt:1-8).
// Here the two host-side hot paths are implemented in C++ and exposed via
// ctypes:
//
//   1. filter_mask  — one-pass conjunctive filter evaluation over columnar
//      payloads (int32 dictionary codes + bool flags). NumPy evaluates K
//      predicates as K vector passes with K temporaries; this fuses them
//      into a single cache-friendly sweep.
//   2. snapshot write/read — flat binary gallery snapshots (header +
//      float32 vector blob) replacing zlib-compressed npz, which is far
//      too slow for multi-GB galleries.
//
// Build: g++ -O3 -march=native -shared -fPIC rbod_native.cc -o librbod_native.so

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

// Bulk IO via raw syscalls in large chunks: stdio's fread measured ~2x
// under the disk's sequential read speed on multi-GB snapshots.
static bool write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n > 0) {
    size_t chunk = n > (size_t)(64 << 20) ? (size_t)(64 << 20) : n;
    ssize_t w = ::write(fd, p, chunk);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= (size_t)w;
  }
  return true;
}

// 0 = ok, 1 = IO error (errno), 2 = short read (truncated file).
// The caller surfaces the distinction: truncation means the BYTES are
// bad (a torn write — prune/rewrite), an errno read failure may be
// transient (EIO — retry later, never unlink).
static int read_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n > 0) {
    size_t chunk = n > (size_t)(64 << 20) ? (size_t)(64 << 20) : n;
    ssize_t r = ::read(fd, p, chunk);
    if (r < 0) {
      if (errno == EINTR) continue;
      return 1;
    }
    if (r == 0) return 2;  // truncated file
    p += r;
    n -= (size_t)r;
  }
  return 0;
}

extern "C" {

// Conjunction of equality predicates over n rows.
//   int_cols:  n_int pointers to int32 columns; int_vals: expected codes.
//   bool_cols: n_bool pointers to uint8 columns; bool_vals: expected 0/1.
// out: uint8 mask of length n (1 = row matches all predicates).
void filter_mask(
    const int32_t** int_cols, const int32_t* int_vals, int n_int,
    const uint8_t** bool_cols, const uint8_t* bool_vals, int n_bool,
    int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint8_t ok = 1;
    for (int c = 0; c < n_int; ++c) {
      ok &= (uint8_t)(int_cols[c][i] == int_vals[c]);
    }
    for (int c = 0; c < n_bool; ++c) {
      ok &= (uint8_t)(bool_cols[c][i] == bool_vals[c]);
    }
    out[i] = ok;
  }
}

// Count matching rows without materialising a mask.
int64_t filter_count(
    const int32_t** int_cols, const int32_t* int_vals, int n_int,
    const uint8_t** bool_cols, const uint8_t* bool_vals, int n_bool,
    int64_t n) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t ok = 1;
    for (int c = 0; c < n_int; ++c) {
      ok &= (uint8_t)(int_cols[c][i] == int_vals[c]);
    }
    for (int c = 0; c < n_bool; ++c) {
      ok &= (uint8_t)(bool_cols[c][i] == bool_vals[c]);
    }
    total += ok;
  }
  return total;
}

// ---- snapshot format ------------------------------------------------
// [magic "RBOD" (4)] [version u32] [rows u64] [dim u64] [payload_bytes u64]
// [payload blob] [float32 vectors rows*dim]

static const uint32_t kMagic = 0x444F4252;  // "RBOD" little-endian
static const uint32_t kVersion = 1;

// Returns 0 on success.
int snapshot_write(const char* path, const float* vectors, int64_t rows,
                   int64_t dim, const uint8_t* payload_blob,
                   int64_t payload_bytes) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return 1;
  unsigned char header[32];
  uint64_t r = (uint64_t)rows, d = (uint64_t)dim, pb = (uint64_t)payload_bytes;
  memcpy(header, &kMagic, 4);
  memcpy(header + 4, &kVersion, 4);
  memcpy(header + 8, &r, 8);
  memcpy(header + 16, &d, 8);
  memcpy(header + 24, &pb, 8);
  bool ok = write_all(fd, header, sizeof(header));
  if (ok && payload_bytes > 0) {
    ok = write_all(fd, payload_blob, (size_t)payload_bytes);
  }
  size_t nf = (size_t)rows * (size_t)dim;
  if (ok && nf > 0) ok = write_all(fd, vectors, nf * sizeof(float));
  // Durability: the caller renames this tmp file into place; without
  // an fsync the rename can hit disk before the data blocks, leaving a
  // truncated snapshot after power loss (rename-atomicity covers
  // crashes of THIS process only).
  if (ok && ::fsync(fd) != 0) ok = false;
  if (::close(fd) != 0) ok = false;
  return ok ? 0 : 2;
}

// Reads the header. Returns 0 on success.
int snapshot_header(const char* path, int64_t* rows, int64_t* dim,
                    int64_t* payload_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint32_t magic = 0, version = 0;
  uint64_t r = 0, d = 0, pb = 0;
  int ok = 1;
  ok &= fread(&magic, 4, 1, f) == 1;
  ok &= fread(&version, 4, 1, f) == 1;
  ok &= fread(&r, 8, 1, f) == 1;
  ok &= fread(&d, 8, 1, f) == 1;
  ok &= fread(&pb, 8, 1, f) == 1;
  fclose(f);
  if (!ok || magic != kMagic || version != kVersion) return 2;
  *rows = (int64_t)r;
  *dim = (int64_t)d;
  *payload_bytes = (int64_t)pb;
  return 0;
}

// Reads blobs into caller-allocated buffers (sizes from snapshot_header).
int snapshot_read(const char* path, float* vectors, int64_t rows,
                  int64_t dim, uint8_t* payload_blob,
                  int64_t payload_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return 1;
#ifdef POSIX_FADV_SEQUENTIAL
  posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
#endif
  if (::lseek(fd, 4 + 4 + 8 + 8 + 8, SEEK_SET) < 0) {
    ::close(fd);
    return 2;
  }
  int st = 0;
  if (payload_bytes > 0) {
    st = read_all(fd, payload_blob, (size_t)payload_bytes);
  }
  size_t nf = (size_t)rows * (size_t)dim;
  if (st == 0 && nf > 0) st = read_all(fd, vectors, nf * sizeof(float));
  ::close(fd);
  // 3 = IO error (possibly transient), 4 = truncated body (torn write:
  // the bytes themselves are bad).
  if (st == 1) return 3;
  if (st == 2) return 4;
  return 0;
}

}  // extern "C"
