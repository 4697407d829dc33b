// Native columnar event store: the data-ingest runtime of sxmc_jax.
//
// Replaces the reference's ROOT TTree reader (reference:
// src/io/ttree_io.{h,cpp}) with a mmap-backed columnar binary format
// ("SXNT"), and implements the hot ingest path — cut application +
// column mapping into the fit's sample layout (reference:
// src/signal.cpp:50-109, read_dataset_to_samples) — natively, so
// multi-gigabyte MC ntuples stream into the fit without a Python loop
// or intermediate copies.
//
// File layout (little-endian):
//   0x00  char[4]  magic "SXNT"
//   0x04  u32      version (1)
//   0x08  u64      nrows
//   0x10  u32      nfields
//   0x14  u32      name_block_len
//   0x18  char[]   '\0'-joined field names (name_block_len bytes)
//   ....  f32[]    column-major data: nfields arrays of nrows floats
//
// C ABI (ctypes-friendly); all functions return 0 on success or a
// negative error code.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[4] = {'S', 'X', 'N', 'T'};
constexpr uint32_t kVersion = 1;

struct Header {
  char magic[4];
  uint32_t version;
  uint64_t nrows;
  uint32_t nfields;
  uint32_t name_block_len;
};

struct Store {
  int fd = -1;
  void* map = nullptr;
  size_t map_len = 0;
  Header hdr{};
  std::vector<std::string> names;
  const float* columns = nullptr;  // start of column data
};

const float* column_ptr(const Store* s, uint32_t field) {
  return s->columns + static_cast<size_t>(field) * s->hdr.nrows;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- write

int sxnt_write(const char* path, const float* data_rowmajor,
               uint64_t nrows, uint32_t nfields,
               const char* const* names) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;

  std::string name_block;
  for (uint32_t i = 0; i < nfields; i++) {
    name_block += names[i];
    name_block.push_back('\0');
  }

  Header hdr{};
  std::memcpy(hdr.magic, kMagic, 4);
  hdr.version = kVersion;
  hdr.nrows = nrows;
  hdr.nfields = nfields;
  hdr.name_block_len = static_cast<uint32_t>(name_block.size());

  if (std::fwrite(&hdr, sizeof(hdr), 1, f) != 1 ||
      std::fwrite(name_block.data(), 1, name_block.size(), f) !=
          name_block.size()) {
    std::fclose(f);
    return -2;
  }

  // Transpose row-major input to column-major on the fly, one column
  // at a time, with a bounded buffer.
  std::vector<float> col(nrows);
  for (uint32_t j = 0; j < nfields; j++) {
    for (uint64_t i = 0; i < nrows; i++) {
      col[i] = data_rowmajor[i * nfields + j];
    }
    if (std::fwrite(col.data(), sizeof(float), nrows, f) != nrows) {
      std::fclose(f);
      return -2;
    }
  }
  std::fclose(f);
  return 0;
}

// ----------------------------------------------------------------- open

void* sxnt_open(const char* path) {
  Store* s = new Store;
  s->fd = ::open(path, O_RDONLY);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  struct stat st;
  if (fstat(s->fd, &st) != 0 ||
      static_cast<size_t>(st.st_size) < sizeof(Header)) {
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  s->map_len = st.st_size;
  s->map = mmap(nullptr, s->map_len, PROT_READ, MAP_PRIVATE, s->fd, 0);
  if (s->map == MAP_FAILED) {
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  std::memcpy(&s->hdr, s->map, sizeof(Header));
  if (std::memcmp(s->hdr.magic, kMagic, 4) != 0 ||
      s->hdr.version != kVersion) {
    munmap(s->map, s->map_len);
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  const char* p = static_cast<const char*>(s->map) + sizeof(Header);
  const char* end = p + s->hdr.name_block_len;
  while (p < end) {
    s->names.emplace_back(p);
    p += s->names.back().size() + 1;
  }
  s->columns = reinterpret_cast<const float*>(
      static_cast<const char*>(s->map) + sizeof(Header) +
      s->hdr.name_block_len);
  size_t expect = sizeof(Header) + s->hdr.name_block_len +
                  sizeof(float) * s->hdr.nrows * s->hdr.nfields;
  if (s->map_len < expect || s->names.size() != s->hdr.nfields) {
    munmap(s->map, s->map_len);
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  return s;
}

void sxnt_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  if (!s) return;
  if (s->map) munmap(s->map, s->map_len);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

uint64_t sxnt_nrows(void* handle) {
  return static_cast<Store*>(handle)->hdr.nrows;
}

uint32_t sxnt_nfields(void* handle) {
  return static_cast<Store*>(handle)->hdr.nfields;
}

// Copy field name i into buf (at most buflen bytes incl. '\0').
int sxnt_field_name(void* handle, uint32_t i, char* buf, uint32_t buflen) {
  Store* s = static_cast<Store*>(handle);
  if (i >= s->names.size()) return -1;
  std::snprintf(buf, buflen, "%s", s->names[i].c_str());
  return 0;
}

// Read the full table into a row-major float32 buffer
// (nrows * nfields floats).
int sxnt_read_all(void* handle, float* out) {
  Store* s = static_cast<Store*>(handle);
  const uint64_t n = s->hdr.nrows;
  const uint32_t m = s->hdr.nfields;
  for (uint32_t j = 0; j < m; j++) {
    const float* col = column_ptr(s, j);
    for (uint64_t i = 0; i < n; i++) {
      out[i * m + j] = col[i];
    }
  }
  return 0;
}

// The native ingest hot path (reference: signal.cpp:50-109): apply
// [lo, hi] cuts on cut_fields, then gather sel_fields into a row-major
// output with the dataset tag appended as the last column.
//
//   sel_fields:  indices of the fields to keep, in output order
//   nsel:        number of selected fields
//   cut_fields:  indices of fields with cuts
//   cut_lo/hi:   per-cut bounds (inclusive, like the reference)
//   ncuts:       number of cuts
//   dataset_tag: value for the appended DATASET column
//   out:         buffer for at least nrows * (nsel + 1) floats
//
// Returns the number of selected rows, or a negative error code.
int64_t sxnt_select(void* handle, const uint32_t* sel_fields,
                    uint32_t nsel, const uint32_t* cut_fields,
                    const float* cut_lo, const float* cut_hi,
                    uint32_t ncuts, float dataset_tag, float* out) {
  Store* s = static_cast<Store*>(handle);
  const uint64_t n = s->hdr.nrows;
  const uint32_t m = s->hdr.nfields;
  for (uint32_t j = 0; j < nsel; j++) {
    if (sel_fields[j] >= m) return -1;
  }
  for (uint32_t j = 0; j < ncuts; j++) {
    if (cut_fields[j] >= m) return -1;
  }

  std::vector<const float*> sel_cols(nsel);
  for (uint32_t j = 0; j < nsel; j++) {
    sel_cols[j] = column_ptr(s, sel_fields[j]);
  }
  std::vector<const float*> cut_cols(ncuts);
  for (uint32_t j = 0; j < ncuts; j++) {
    cut_cols[j] = column_ptr(s, cut_fields[j]);
  }

  const uint32_t ncols_out = nsel + 1;
  uint64_t k = 0;
  for (uint64_t i = 0; i < n; i++) {
    bool keep = true;
    for (uint32_t j = 0; j < ncuts; j++) {
      const float v = cut_cols[j][i];
      if (v < cut_lo[j] || v > cut_hi[j]) {
        keep = false;
        break;
      }
    }
    if (!keep) continue;
    float* row = out + k * ncols_out;
    for (uint32_t j = 0; j < nsel; j++) {
      row[j] = sel_cols[j][i];
    }
    row[nsel] = dataset_tag;
    k++;
  }
  return static_cast<int64_t>(k);
}

}  // extern "C"
