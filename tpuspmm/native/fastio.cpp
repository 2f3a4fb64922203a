// Native text-parsing kernels for tpuspmm.
//
// Counterpart of the reference's native I/O layer: the NIST mmio
// reader tool (reference/utils/utils/mmio.c, read_matrix.cpp:8-98) and the
// C++ text loaders inside each format class
// (e.g. reference/src/formats/sparse_csr.cu:12-51).  The Python loaders in
// tpuspmm/formats/io.py call these through ctypes when the shared library
// is built, and fall back to numpy parsing otherwise.
//
// Exposed C ABI:
//   tokenize_file(path, skip_lines, &out, &n) -> 0 on success
//     whitespace-tokenized doubles of the file body after skipping
//     `skip_lines` lines; caller frees with free_buffer().
//   read_mtx_coord(path, &rows, &cols, &nnz, &r, &c, &v, &sym, &pattern)
//     MatrixMarket coordinate parser: skips the banner/comments, applies
//     the 1-based -> 0-based index shift, value 1.0 for `pattern` files
//     (reference read_matrix.cpp:62-79); symmetric expansion is left to
//     the Python caller.  Returns 0 on success.
//   free_buffer(ptr) / free_ibuffer(ptr)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

static char* read_whole_file(const char* path, size_t* size_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(size + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  size_t rd = std::fread(buf, 1, size, f);
  std::fclose(f);
  buf[rd] = '\0';
  *size_out = rd;
  return buf;
}

static const char* skip_n_lines(const char* p, int64_t n) {
  while (n > 0 && *p) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) return p + std::strlen(p);
    p = nl + 1;
    --n;
  }
  return p;
}

int tokenize_file(const char* path, int64_t skip_lines, double** out,
                  int64_t* n_out) {
  size_t size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return 1;
  const char* p = skip_n_lines(buf, skip_lines);

  std::vector<double> vals;
  vals.reserve(size / 4);
  char* end = nullptr;
  while (*p) {
    double v = std::strtod(p, &end);
    if (end == p) {  // not a number: advance past the offending byte
      ++p;
      continue;
    }
    vals.push_back(v);
    p = end;
  }
  std::free(buf);

  double* arr = static_cast<double*>(std::malloc(vals.size() * sizeof(double)));
  if (!arr && !vals.empty()) return 2;
  std::memcpy(arr, vals.data(), vals.size() * sizeof(double));
  *out = arr;
  *n_out = static_cast<int64_t>(vals.size());
  return 0;
}

int read_mtx_coord(const char* path, int64_t* rows, int64_t* cols,
                   int64_t* nnz, int32_t** r_out, int32_t** c_out,
                   double** v_out, int32_t* symmetric, int32_t* pattern) {
  size_t size = 0;
  char* buf = read_whole_file(path, &size);
  if (!buf) return 1;
  const char* p = buf;

  // banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  if (std::strncmp(p, "%%MatrixMarket", 14) != 0) {
    std::free(buf);
    return 3;
  }
  const char* nl = std::strchr(p, '\n');
  std::string banner(p, nl ? static_cast<size_t>(nl - p) : std::strlen(p));
  for (auto& ch : banner) ch = static_cast<char>(std::tolower(ch));
  if (banner.find("coordinate") == std::string::npos) {
    std::free(buf);
    return 4;  // array (dense) mtx: handled by the Python fallback
  }
  *pattern = banner.find("pattern") != std::string::npos ? 1 : 0;
  // 0 = general, 1 = symmetric, 2 = skew/hermitian (callers fall back to
  // scipy for 2 — the mirrored half needs negation/conjugation)
  if (banner.find("skew-symmetric") != std::string::npos ||
      banner.find("hermitian") != std::string::npos) {
    *symmetric = 2;
  } else if (banner.find("symmetric") != std::string::npos) {
    *symmetric = 1;
  } else {
    *symmetric = 0;
  }
  p = nl ? nl + 1 : p + std::strlen(p);

  // comment lines
  while (*p == '%') {
    nl = std::strchr(p, '\n');
    if (!nl) break;
    p = nl + 1;
  }

  char* end = nullptr;
  int64_t R = std::strtoll(p, &end, 10);
  p = end;
  int64_t C = std::strtoll(p, &end, 10);
  p = end;
  int64_t NZ = std::strtoll(p, &end, 10);
  p = end;

  int32_t* rr = static_cast<int32_t*>(std::malloc(NZ * sizeof(int32_t)));
  int32_t* cc = static_cast<int32_t*>(std::malloc(NZ * sizeof(int32_t)));
  double* vv = static_cast<double*>(std::malloc(NZ * sizeof(double)));
  if ((!rr || !cc || !vv) && NZ > 0) {
    std::free(buf);
    std::free(rr);
    std::free(cc);
    std::free(vv);
    return 2;
  }
  for (int64_t i = 0; i < NZ; ++i) {
    long ri = std::strtol(p, &end, 10);
    if (end == p) {  // truncated file
      std::free(buf);
      std::free(rr);
      std::free(cc);
      std::free(vv);
      return 5;
    }
    p = end;
    long ci = std::strtol(p, &end, 10);
    p = end;
    double v = 1.0;
    if (!*pattern) {
      v = std::strtod(p, &end);
      p = end;
      if (banner.find("complex") != std::string::npos) {
        std::strtod(p, &end);  // drop the imaginary part
        p = end;
      }
    }
    rr[i] = static_cast<int32_t>(ri - 1);  // 1-based -> 0-based
    cc[i] = static_cast<int32_t>(ci - 1);
    vv[i] = v;
  }
  std::free(buf);
  *rows = R;
  *cols = C;
  *nnz = NZ;
  *r_out = rr;
  *c_out = cc;
  *v_out = vv;
  return 0;
}

void free_buffer(double* p) { std::free(p); }
void free_ibuffer(int32_t* p) { std::free(p); }

}  // extern "C"
