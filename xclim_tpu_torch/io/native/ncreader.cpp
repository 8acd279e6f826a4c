// Fast classic-NetCDF (CDF-1/CDF-2) reader.
//
// Native IO path for the framework's data loading (the reference delegates IO
// to xarray/netCDF4; here the hot path is a zero-copy mmap parse with
// multithreaded byte-swapping, exposed to Python through ctypes —
// xclim_tpu_torch/io/native/__init__.py).
//
// Built by xclim_tpu_torch/io/native/__init__.py into xclim_tpu_torch/_build/:
// g++ -O3 -shared -fPIC -std=c++17 -pthread ncreader.cpp -o libncreader-<hash>.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t NC_DIMENSION = 0x0A;
constexpr uint32_t NC_VARIABLE = 0x0B;
constexpr uint32_t NC_ATTRIBUTE = 0x0C;

struct Attr {
  std::string name;
  int32_t type = 0;
  std::string raw;  // big-endian packed values
  int64_t nelems = 0;
};

struct Var {
  std::string name;
  std::vector<int32_t> dimids;
  std::vector<Attr> atts;
  int32_t type = 0;
  int64_t vsize = 0;
  int64_t begin = 0;
  bool is_record = false;
  int64_t n_fixed = 1;  // product of non-record dims
};

struct File {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  int version = 1;
  int64_t numrecs = 0;
  std::vector<std::string> dim_names;
  std::vector<int64_t> dim_sizes;  // 0 = record dim placeholder
  int32_t rec_dim = -1;
  std::vector<Attr> gatts;
  std::vector<Var> vars;
  int64_t recsize = 0;
  std::string error;
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | uint32_t(p[3]);
    p += 4;
    return v;
  }
  int64_t i64() {
    uint64_t hi = u32();
    uint64_t lo = u32();
    return int64_t((hi << 32) | lo);
  }
  std::string name() {
    uint32_t n = u32();
    if (p + n > end) { ok = false; return {}; }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += (n + 3) / 4 * 4;  // 4-byte padding
    return s;
  }
};

int type_size(int32_t t) {
  switch (t) {
    case 1: case 2: return 1;  // byte, char
    case 3: return 2;          // short
    case 4: case 5: return 4;  // int, float
    case 6: return 8;          // double
  }
  return 0;
}

void parse_atts(Cursor& c, std::vector<Attr>& out) {
  uint32_t tag = c.u32();
  uint32_t n = c.u32();
  if (tag != NC_ATTRIBUTE && n != 0) { c.ok = false; return; }
  for (uint32_t i = 0; i < n && c.ok; i++) {
    Attr a;
    a.name = c.name();
    a.type = (int32_t)c.u32();
    a.nelems = (int64_t)c.u32();
    int64_t nbytes = a.nelems * type_size(a.type);
    int64_t padded = (nbytes + 3) / 4 * 4;
    if (c.p + padded > c.end) { c.ok = false; return; }
    a.raw.assign(reinterpret_cast<const char*>(c.p), nbytes);
    c.p += padded;
    out.push_back(std::move(a));
  }
}

// byte-swap `count` elements of size `es` from src to dst (may run in threads)
void swap_copy(const uint8_t* src, uint8_t* dst, int64_t count, int es) {
  switch (es) {
    case 1:
      memcpy(dst, src, count);
      break;
    case 2:
      for (int64_t i = 0; i < count; i++) {
        dst[2 * i] = src[2 * i + 1];
        dst[2 * i + 1] = src[2 * i];
      }
      break;
    case 4:
      for (int64_t i = 0; i < count; i++) {
        dst[4 * i] = src[4 * i + 3];
        dst[4 * i + 1] = src[4 * i + 2];
        dst[4 * i + 2] = src[4 * i + 1];
        dst[4 * i + 3] = src[4 * i];
      }
      break;
    case 8:
      for (int64_t i = 0; i < count; i++)
        for (int k = 0; k < 8; k++) dst[8 * i + k] = src[8 * i + 7 - k];
      break;
  }
}

void swap_copy_mt(const uint8_t* src, uint8_t* dst, int64_t count, int es) {
  const int64_t kMin = 1 << 20;
  unsigned hw = std::thread::hardware_concurrency();
  if (count * es < kMin || hw < 2) {
    swap_copy(src, dst, count, es);
    return;
  }
  unsigned nt = hw > 8 ? 8 : hw;
  std::vector<std::thread> threads;
  int64_t chunk = (count + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    int64_t s = t * chunk;
    int64_t e = s + chunk > count ? count : s + chunk;
    if (s >= e) break;
    threads.emplace_back(swap_copy, src + s * es, dst + s * es, e - s, es);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void* nc3_open(const char* path) {
  auto* f = new File();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { f->error = "cannot open file"; return f; }
  struct stat st;
  fstat(f->fd, &st);
  f->size = st.st_size;
  f->map = static_cast<const uint8_t*>(
      mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0));
  if (f->map == MAP_FAILED) { f->map = nullptr; f->error = "mmap failed"; return f; }
  Cursor c{f->map, f->map + f->size};
  if (f->size < 8 || memcmp(c.p, "CDF", 3) != 0) { f->error = "not a classic NetCDF file"; return f; }
  f->version = c.p[3];
  if (f->version != 1 && f->version != 2) { f->error = "unsupported CDF version"; return f; }
  c.p += 4;
  f->numrecs = (int64_t)c.u32();

  uint32_t tag = c.u32();
  uint32_t ndims = c.u32();
  if (tag == NC_DIMENSION) {
    for (uint32_t i = 0; i < ndims && c.ok; i++) {
      f->dim_names.push_back(c.name());
      int64_t sz = (int64_t)c.u32();
      if (sz == 0) f->rec_dim = (int32_t)i;
      f->dim_sizes.push_back(sz);
    }
  }
  parse_atts(c, f->gatts);

  tag = c.u32();
  uint32_t nvars = c.u32();
  if (tag == NC_VARIABLE) {
    for (uint32_t i = 0; i < nvars && c.ok; i++) {
      Var v;
      v.name = c.name();
      uint32_t nd = c.u32();
      for (uint32_t d = 0; d < nd; d++) v.dimids.push_back((int32_t)c.u32());
      parse_atts(c, v.atts);
      v.type = (int32_t)c.u32();
      v.vsize = (int64_t)c.u32();
      v.begin = f->version == 2 ? c.i64() : (int64_t)c.u32();
      v.is_record = !v.dimids.empty() && v.dimids[0] == f->rec_dim;
      // dim ids come from the file: validate before indexing, and guard
      // the n_fixed product against overflow from a hostile header
      for (size_t d = v.is_record ? 1 : 0; d < v.dimids.size(); d++) {
        int32_t id = v.dimids[d];
        if (id < 0 || (size_t)id >= f->dim_sizes.size()) {
          f->error = "invalid dimension id in variable header";
          return f;
        }
        int64_t sz = f->dim_sizes[id];
        if (sz < 0 || (sz > 0 && v.n_fixed > INT64_MAX / sz)) {
          f->error = "variable size overflow in header";
          return f;
        }
        v.n_fixed *= sz;
      }
      f->vars.push_back(std::move(v));
    }
  }
  if (!c.ok) { f->error = "header parse error"; return f; }
  // record slab size = sum of per-record chunks (each padded to 4)
  for (auto& v : f->vars)
    if (v.is_record) {
      int64_t chunk = v.n_fixed * type_size(v.type);
      f->recsize += (chunk + 3) / 4 * 4;
    }
  return f;
}

const char* nc3_error(void* h) { return static_cast<File*>(h)->error.c_str(); }

void nc3_close(void* h) {
  auto* f = static_cast<File*>(h);
  if (f->map) munmap(const_cast<uint8_t*>(f->map), f->size);
  if (f->fd >= 0) close(f->fd);
  delete f;
}

int32_t nc3_num_dims(void* h) { return (int32_t)static_cast<File*>(h)->dim_names.size(); }
const char* nc3_dim_name(void* h, int32_t i) { return static_cast<File*>(h)->dim_names[i].c_str(); }
int64_t nc3_dim_size(void* h, int32_t i) {
  auto* f = static_cast<File*>(h);
  return i == f->rec_dim ? f->numrecs : f->dim_sizes[i];
}

int32_t nc3_num_vars(void* h) { return (int32_t)static_cast<File*>(h)->vars.size(); }
const char* nc3_var_name(void* h, int32_t i) { return static_cast<File*>(h)->vars[i].name.c_str(); }
int32_t nc3_var_type(void* h, int32_t i) { return static_cast<File*>(h)->vars[i].type; }
int32_t nc3_var_ndims(void* h, int32_t i) { return (int32_t)static_cast<File*>(h)->vars[i].dimids.size(); }
int32_t nc3_var_dimid(void* h, int32_t i, int32_t d) { return static_cast<File*>(h)->vars[i].dimids[d]; }

int32_t nc3_var_natts(void* h, int32_t i) {
  auto* f = static_cast<File*>(h);
  return i < 0 ? (int32_t)f->gatts.size() : (int32_t)f->vars[i].atts.size();
}
const char* nc3_att_name(void* h, int32_t i, int32_t a) {
  auto* f = static_cast<File*>(h);
  return (i < 0 ? f->gatts[a] : f->vars[i].atts[a]).name.c_str();
}
int32_t nc3_att_type(void* h, int32_t i, int32_t a) {
  auto* f = static_cast<File*>(h);
  return (i < 0 ? f->gatts[a] : f->vars[i].atts[a]).type;
}
int64_t nc3_att_nelems(void* h, int32_t i, int32_t a) {
  auto* f = static_cast<File*>(h);
  return (i < 0 ? f->gatts[a] : f->vars[i].atts[a]).nelems;
}
// copies the attribute's values, byteswapped, into out (caller sizes it)
void nc3_att_values(void* h, int32_t i, int32_t a, uint8_t* out) {
  auto* f = static_cast<File*>(h);
  const Attr& at = i < 0 ? f->gatts[a] : f->vars[i].atts[a];
  swap_copy(reinterpret_cast<const uint8_t*>(at.raw.data()), out, at.nelems,
            type_size(at.type));
}

int64_t nc3_var_nelems(void* h, int32_t i) {
  auto* f = static_cast<File*>(h);
  const Var& v = f->vars[i];
  return v.is_record ? v.n_fixed * f->numrecs : v.n_fixed;
}

// read the whole variable into `out` (host endianness), returns 0 on success
int32_t nc3_read_var(void* h, int32_t i, uint8_t* out) {
  auto* f = static_cast<File*>(h);
  if (!f->map) return 1;
  const Var& v = f->vars[i];
  int es = type_size(v.type);
  if (!v.is_record) {
    if ((size_t)(v.begin + v.n_fixed * es) > f->size) return 2;
    swap_copy_mt(f->map + v.begin, out, v.n_fixed, es);
    return 0;
  }
  int64_t chunk = v.n_fixed * es;
  for (int64_t r = 0; r < f->numrecs; r++) {
    const uint8_t* src = f->map + v.begin + r * f->recsize;
    if ((size_t)(src - f->map + chunk) > f->size) return 2;
    swap_copy(src, out + r * chunk, v.n_fixed, es);
  }
  return 0;
}

}  // extern "C"
