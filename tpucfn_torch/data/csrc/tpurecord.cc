// tpurecord native reader — the C++ half of the data-staging path.
//
// Role parity: the reference's input pipeline leaned on MXNet's C++
// RecordIO reader + DataIter threads to keep GPUs fed (SURVEY.md §3.2
// "DataIter next batch (RecordIO from EFS/local)"); this is the tpucfn
// equivalent for the tpurecord format defined (and documented) in
// tpucfn/data/records.py. Python owns the format; this library makes the
// hot read path native: one pass builds the offset index, reads validate
// CRC32, and batch reads copy straight into a caller-owned contiguous
// buffer so Python can wrap it in numpy without per-record allocations.
// All entry points are plain C ABI for ctypes; no Python.h dependency.
//
// Thread-safety: a shard handle is immutable after open; concurrent
// reads from multiple threads are safe (the Python wrapper releases the
// GIL around calls via ctypes).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>  // crc32

namespace {

constexpr uint32_t kMagic = 0x7B0CF117;
constexpr uint32_t kVersion = 1;

#pragma pack(push, 1)
struct FileHeader {
  uint32_t magic;
  uint32_t version;
  uint64_t count;
};
struct RecHeader {
  uint32_t length;
  uint32_t crc;
};
#pragma pack(pop)

struct Shard {
  // File bytes: mmap'd when possible (no upfront copy of the whole
  // file — the page cache serves reads lazily and batch copies are the
  // only data pass), fread fallback otherwise.
  const uint8_t* base = nullptr;
  size_t size = 0;
  void* map = nullptr;            // munmap target when mmap'd
  std::vector<uint8_t> owned;     // fread fallback storage
  std::vector<uint64_t> offsets;  // payload offsets
  std::vector<uint32_t> lengths;
  std::vector<uint32_t> crcs;

  ~Shard() {
    if (map != nullptr) ::munmap(map, size);
  }
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Returns an opaque handle, or null with `err` filled.
void* tpurec_open(const char* path, char* err, int errlen) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return nullptr;
  }
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    set_err(err, errlen, std::string("cannot stat ") + path);
    return nullptr;
  }
  auto shard = new Shard();
  shard->size = static_cast<size_t>(st.st_size);
  if (shard->size > 0) {
    void* m = ::mmap(nullptr, shard->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m != MAP_FAILED) {
      shard->map = m;
      shard->base = static_cast<const uint8_t*>(m);
      ::madvise(m, shard->size, MADV_SEQUENTIAL);
      ::madvise(m, shard->size, MADV_WILLNEED);
    } else {
      shard->owned.resize(shard->size);
      ssize_t got = 0;
      while (got < static_cast<ssize_t>(shard->size)) {
        ssize_t r = ::read(fd, shard->owned.data() + got,
                           shard->size - static_cast<size_t>(got));
        if (r <= 0) break;
        got += r;
      }
      if (got != static_cast<ssize_t>(shard->size)) {
        ::close(fd);
        delete shard;
        set_err(err, errlen, std::string("short read on ") + path);
        return nullptr;
      }
      shard->base = shard->owned.data();
    }
  }
  ::close(fd);

  if (shard->size < sizeof(FileHeader)) {
    delete shard;
    set_err(err, errlen, "file smaller than header");
    return nullptr;
  }
  FileHeader hdr;
  std::memcpy(&hdr, shard->base, sizeof(hdr));
  if (hdr.magic != kMagic) {
    delete shard;
    set_err(err, errlen, "bad magic — not a tpurecord shard");
    return nullptr;
  }
  if (hdr.version != kVersion) {
    delete shard;
    set_err(err, errlen, "unsupported tpurecord version");
    return nullptr;
  }
  // hdr.count is untrusted input: bound it by what the file could
  // possibly hold before reserving, so a corrupt header can't throw
  // length_error/bad_alloc across the C ABI (std::terminate).
  uint64_t max_count =
      (shard->size - sizeof(FileHeader)) / sizeof(RecHeader);
  if (hdr.count > max_count) {
    delete shard;
    set_err(err, errlen,
            "corrupt header: record count " + std::to_string(hdr.count) +
                " exceeds file capacity " + std::to_string(max_count));
    return nullptr;
  }
  uint64_t off = sizeof(FileHeader);
  shard->offsets.reserve(hdr.count);
  for (uint64_t i = 0; i < hdr.count; ++i) {
    if (off + sizeof(RecHeader) > shard->size) {
      delete shard;
      set_err(err, errlen, "truncated at record " + std::to_string(i));
      return nullptr;
    }
    RecHeader rh;
    std::memcpy(&rh, shard->base + off, sizeof(rh));
    off += sizeof(RecHeader);
    if (off + rh.length > shard->size) {
      delete shard;
      set_err(err, errlen, "truncated payload at record " + std::to_string(i));
      return nullptr;
    }
    shard->offsets.push_back(off);
    shard->lengths.push_back(rh.length);
    shard->crcs.push_back(rh.crc);
    off += rh.length;
  }
  return shard;
}

long tpurec_count(void* handle) {
  return static_cast<long>(static_cast<Shard*>(handle)->offsets.size());
}

long tpurec_length(void* handle, long idx) {
  auto* s = static_cast<Shard*>(handle);
  if (idx < 0 || idx >= static_cast<long>(s->lengths.size())) return -1;
  return static_cast<long>(s->lengths[static_cast<size_t>(idx)]);
}

// Copy record `idx` into out (capacity outcap), CRC-checked.
// Returns bytes written, -1 bad index/capacity, -2 CRC mismatch.
// NOTE: tpurec_read / tpurec_read_batch / tpurec_length are the
// copy-out C embedding API (for non-Python consumers that cannot mmap);
// the Python binding uses the zero-copy tpurec_index + tpurec_validate
// pair instead.
long tpurec_read(void* handle, long idx, uint8_t* out, long outcap) {
  auto* s = static_cast<Shard*>(handle);
  if (idx < 0 || idx >= static_cast<long>(s->offsets.size())) return -1;
  auto i = static_cast<size_t>(idx);
  uint32_t len = s->lengths[i];
  if (static_cast<long>(len) > outcap) return -1;
  const uint8_t* src = s->base + s->offsets[i];
  uint32_t crc =
      static_cast<uint32_t>(crc32(0L, reinterpret_cast<const Bytef*>(src), len));
  if (crc != s->crcs[i]) return -2;
  std::memcpy(out, src, len);
  return static_cast<long>(len);
}

// Export the whole payload index in one call: offsets_out/lengths_out
// must have tpurec_count() slots. Lets the Python binding serve
// zero-copy memoryviews over its own mmap of the file with no
// per-record FFI at all.
void tpurec_index(void* handle, long* offsets_out, long* lengths_out) {
  auto* s = static_cast<Shard*>(handle);
  for (size_t i = 0; i < s->offsets.size(); ++i) {
    offsets_out[i] = static_cast<long>(s->offsets[i]);
    lengths_out[i] = static_cast<long>(s->lengths[i]);
  }
}

// CRC-validate records indices[0..n) in place — no copy; pairs with the
// zero-copy mmap read path. Returns -1 if all pass, the first failing
// record's index on CRC mismatch, or -3 on an out-of-range index.
long tpurec_validate(void* handle, const long* indices, long n) {
  auto* s = static_cast<Shard*>(handle);
  for (long k = 0; k < n; ++k) {
    long idx = indices[k];
    if (idx < 0 || idx >= static_cast<long>(s->offsets.size())) return -3;
    auto i = static_cast<size_t>(idx);
    uint32_t len = s->lengths[i];
    const uint8_t* src = s->base + s->offsets[i];
    uint32_t crc = static_cast<uint32_t>(
        crc32(0L, reinterpret_cast<const Bytef*>(src), len));
    if (crc != s->crcs[i]) return idx;
  }
  return -1;
}

// Batch read: records `indices[0..n)` concatenated into out; offsets[k]
// receives the start of record k in out (offsets has n+1 slots, last =
// total bytes). Returns total bytes, -1 capacity/index error, -2 CRC.
long tpurec_read_batch(void* handle, const long* indices, long n, uint8_t* out,
                       long outcap, long* offsets) {
  long total = 0;
  for (long k = 0; k < n; ++k) {
    offsets[k] = total;
    long got = tpurec_read(handle, indices[k], out + total, outcap - total);
    if (got < 0) return got;
    total += got;
  }
  offsets[n] = total;
  return total;
}

void tpurec_close(void* handle) { delete static_cast<Shard*>(handle); }

}  // extern "C"
