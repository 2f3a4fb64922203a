// Native tile-plan builder: unstructured triplets -> fixed-size chunk plan.
//
// C++ twin of tpuspmm/formats/tiles.py::build_tile_plan (same output
// contract, bit-for-bit): group nonzeros by (row-tile, k-tile), row-tile-
// major, split groups into fixed-size chunks of E slots padded with
// row=-1 sentinels, guarantee every row tile at least one chunk, pad the
// chunk count to a multiple of 8.  This is the ingest-side hot path of the framework (the
// reference's native loaders + host prolog, reference/src/formats/*.cu);
// at tens of millions of nonzeros the numpy version's argsort+gather
// dominates preprocessing, this one is a single stable sort + linear
// walk.
//
// Exposed via ctypes (tpuspmm/native/tileplan.py); the numpy
// implementation remains the always-available fallback.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

namespace {
inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
}

namespace {
struct PlanState {
  std::vector<int64_t> key;
  std::vector<int32_t> srow, scol;
  std::vector<float> sval;
  struct Chunk { int32_t rt, kt; int64_t start, len; };
  std::vector<Chunk> chunks;
  int64_t tile_m, tile_k, chunk;
};
}  // namespace

extern "C" {

// Two-phase API (used by the ctypes binding): phase 1 sorts/groups and
// returns the padded chunk count so the caller can allocate the output
// arrays (numpy-owned — no copy-out); phase 2 fills them.
void* tile_plan_begin(
    const int64_t* rows, const int64_t* cols, const float* vals, int64_t nnz,
    int64_t m, int64_t k, int64_t tile_m, int64_t tile_k, int64_t chunk,
    int64_t* out_num_chunks) {
  const int64_t nrt = cdiv(m, tile_m);
  const int64_t nkt = cdiv(k, tile_k);
  auto* st = new PlanState();
  st->tile_m = tile_m; st->tile_k = tile_k; st->chunk = chunk;

  std::vector<std::pair<int64_t, int64_t>> ord(nnz);
  for (int64_t i = 0; i < nnz; ++i)
    ord[i] = {(rows[i] / tile_m) * nkt + cols[i] / tile_k, i};
  std::sort(ord.begin(), ord.end());
  st->key.resize(nnz); st->srow.resize(nnz);
  st->scol.resize(nnz); st->sval.resize(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    st->key[i] = ord[i].first;
    const int64_t src = ord[i].second;
    st->srow[i] = static_cast<int32_t>(rows[src]);
    st->scol[i] = static_cast<int32_t>(cols[src]);
    st->sval[i] = vals[src];
  }
  ord.clear(); ord.shrink_to_fit();

  std::vector<uint8_t> rt_present(nrt, 0);
  std::vector<PlanState::Chunk> data_chunks;
  int64_t i = 0;
  while (i < nnz) {
    const int64_t gk = st->key[i];
    int64_t j = i;
    while (j < nnz && st->key[j] == gk) ++j;
    const int32_t rt = static_cast<int32_t>(gk / nkt);
    const int32_t kt = static_cast<int32_t>(gk % nkt);
    rt_present[rt] = 1;
    for (int64_t s = i; s < j; s += chunk)
      data_chunks.push_back({rt, kt, s, std::min(chunk, j - s)});
    i = j;
  }
  size_t d = 0;
  for (int64_t rt = 0; rt < nrt; ++rt) {
    if (rt_present[rt]) {
      while (d < data_chunks.size() && data_chunks[d].rt == rt)
        st->chunks.push_back(data_chunks[d++]);
    } else {
      st->chunks.push_back({static_cast<int32_t>(rt), 0, 0, 0});
    }
  }
  const int64_t C = static_cast<int64_t>(st->chunks.size());
  *out_num_chunks = cdiv(std::max<int64_t>(C, 1), 8) * 8;
  return st;
}

// Fill caller-allocated arrays.  rows_o must be pre-filled with -1 and
// cols_o/vals_o zeroed (numpy full/zeros) — only real slots are written.
void tile_plan_fill(void* state, int64_t C_pad,
                    int32_t* rt_o, int32_t* kt_o, int32_t* first_o,
                    int32_t* rows_o, int32_t* cols_o, float* vals_o) {
  auto* st = static_cast<PlanState*>(state);
  const int64_t E = st->chunk;
  const int64_t C = static_cast<int64_t>(st->chunks.size());
  int32_t prev_rt = -1;
  for (int64_t ci = 0; ci < C; ++ci) {
    const auto& c = st->chunks[ci];
    rt_o[ci] = c.rt;
    kt_o[ci] = c.kt;
    first_o[ci] = (c.rt != prev_rt) ? 1 : 0;
    prev_rt = c.rt;
    const int32_t roff = static_cast<int32_t>(c.rt * st->tile_m);
    const int32_t koff = static_cast<int32_t>(c.kt * st->tile_k);
    for (int64_t e = 0; e < c.len; ++e) {
      const int64_t src = c.start + e;
      rows_o[ci * E + e] = st->srow[src] - roff;
      cols_o[ci * E + e] = st->scol[src] - koff;
      vals_o[ci * E + e] = st->sval[src];
    }
  }
  const int32_t last_rt = C ? st->chunks[C - 1].rt : 0;
  for (int64_t ci = C; ci < C_pad; ++ci) {
    rt_o[ci] = last_rt;
    kt_o[ci] = 0;
    first_o[ci] = 0;
  }
  delete st;
}

// Legacy single-call API (mallocs outputs; free with free_plan_buffers).
int build_tile_plan_native(
    const int64_t* rows, const int64_t* cols, const float* vals, int64_t nnz,
    int64_t m, int64_t k, int64_t tile_m, int64_t tile_k, int64_t chunk,
    int32_t** out_rt, int32_t** out_kt, int32_t** out_first,
    int32_t** out_rows, int32_t** out_cols, float** out_vals,
    int64_t* out_num_chunks) {
  const int64_t nrt = cdiv(m, tile_m);
  const int64_t nkt = cdiv(k, tile_k);
  const int64_t E = chunk;

  // stable sort by (row-tile, k-tile): sort contiguous (key, idx) pairs —
  // the idx tiebreak makes an unstable sort stable, and pair elements
  // stay cache-local (an indirect comparator over a key array is ~2x
  // slower at millions of nonzeros)
  std::vector<std::pair<int64_t, int64_t>> ord(nnz);
  for (int64_t i = 0; i < nnz; ++i)
    ord[i] = {(rows[i] / tile_m) * nkt + cols[i] / tile_k, i};
  std::sort(ord.begin(), ord.end());
  // one gather pass into sorted triplet arrays (linear reads afterwards)
  std::vector<int64_t> key(nnz);
  std::vector<int32_t> srow(nnz), scol(nnz);
  std::vector<float> sval(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    key[i] = ord[i].first;
    const int64_t src = ord[i].second;
    srow[i] = static_cast<int32_t>(rows[src]);
    scol[i] = static_cast<int32_t>(cols[src]);
    sval[i] = vals[src];
  }
  ord.clear();
  ord.shrink_to_fit();

  // chunk descriptors in rt-major order, with empty row tiles interleaved
  struct Chunk { int32_t rt, kt; int64_t start, len; };
  std::vector<Chunk> chunks;
  chunks.reserve(nnz / std::max<int64_t>(E, 1) + nrt + 8);
  std::vector<uint8_t> rt_present(nrt, 0);
  {
    std::vector<Chunk> data_chunks;
    int64_t i = 0;
    while (i < nnz) {
      const int64_t gk = key[i];
      int64_t j = i;
      while (j < nnz && key[j] == gk) ++j;
      const int32_t rt = static_cast<int32_t>(gk / nkt);
      const int32_t kt = static_cast<int32_t>(gk % nkt);
      rt_present[rt] = 1;
      for (int64_t s = i; s < j; s += E)
        data_chunks.push_back({rt, kt, s, std::min(E, j - s)});
      i = j;
    }
    // merge missing row tiles (kt=0 empty chunks) keeping rt order —
    // data_chunks are already rt-major because the sort key is rt-major
    size_t d = 0;
    for (int64_t rt = 0; rt < nrt; ++rt) {
      if (rt_present[rt]) {
        while (d < data_chunks.size() && data_chunks[d].rt == rt)
          chunks.push_back(data_chunks[d++]);
      } else {
        chunks.push_back({static_cast<int32_t>(rt), 0, 0, 0});
      }
    }
  }

  const int64_t C = static_cast<int64_t>(chunks.size());
  const int64_t C_pad = cdiv(std::max<int64_t>(C, 1), 8) * 8;
  *out_num_chunks = C_pad;

  auto* rt_o = static_cast<int32_t*>(malloc(sizeof(int32_t) * C_pad));
  auto* kt_o = static_cast<int32_t*>(malloc(sizeof(int32_t) * C_pad));
  auto* first_o = static_cast<int32_t*>(calloc(C_pad, sizeof(int32_t)));
  auto* rows_o = static_cast<int32_t*>(malloc(sizeof(int32_t) * C_pad * E));
  auto* cols_o = static_cast<int32_t*>(calloc(C_pad * E, sizeof(int32_t)));
  auto* vals_o = static_cast<float*>(calloc(C_pad * E, sizeof(float)));
  if (!rt_o || !kt_o || !first_o || !rows_o || !cols_o || !vals_o) {
    free(rt_o); free(kt_o); free(first_o);
    free(rows_o); free(cols_o); free(vals_o);
    return 1;
  }
  for (int64_t ci = 0; ci < C_pad * E; ++ci) rows_o[ci] = -1;

  int32_t prev_rt = -1;
  for (int64_t ci = 0; ci < C; ++ci) {
    const Chunk& c = chunks[ci];
    rt_o[ci] = c.rt;
    kt_o[ci] = c.kt;
    first_o[ci] = (c.rt != prev_rt) ? 1 : 0;
    prev_rt = c.rt;
    const int32_t roff = static_cast<int32_t>(c.rt * tile_m);
    const int32_t koff = static_cast<int32_t>(c.kt * tile_k);
    for (int64_t e = 0; e < c.len; ++e) {
      const int64_t src = c.start + e;  // sorted arrays: linear reads
      rows_o[ci * E + e] = srow[src] - roff;
      cols_o[ci * E + e] = scol[src] - koff;
      vals_o[ci * E + e] = sval[src];
    }
  }
  // padding chunks attach to the last visited row tile (first stays 0)
  const int32_t last_rt = C ? rt_o[C - 1] : 0;
  for (int64_t ci = C; ci < C_pad; ++ci) {
    rt_o[ci] = last_rt;
    kt_o[ci] = 0;
    first_o[ci] = 0;
  }

  *out_rt = rt_o;
  *out_kt = kt_o;
  *out_first = first_o;
  *out_rows = rows_o;
  *out_cols = cols_o;
  *out_vals = vals_o;
  return 0;
}

void free_plan_buffers(int32_t* rt, int32_t* kt, int32_t* first,
                       int32_t* rows, int32_t* cols, float* vals) {
  free(rt); free(kt); free(first); free(rows); free(cols); free(vals);
}

}  // extern "C"
