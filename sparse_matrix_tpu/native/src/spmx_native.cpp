// spmx_native: C++ host runtime for sparse_matrix_tpu.
//
// Native re-implementation (fresh design, C ABI for ctypes) of the host-side
// performance substrate that the Rust reference provides via the `linprobe`
// crate and `spam_csr::mul_hash` (spam_csr/src/mul_hash.rs): linear-probe hash
// tables with multiplicative hashing, FLOP-balanced row partitioning, and the
// two-phase (symbolic/numeric) Gustavson hash SpGEMM, threaded with
// std::thread over contiguous row chunks of ~equal intermediate-product count.
//
// Discipline shared with the whole framework:
//   * column keys are uint32 with 0xFFFFFFFF as the empty sentinel
//   * hash h(k) = k * 107 (mod 2^32), power-of-two tables, mask indexing
//   * symbolic pass tightens per-row upper bounds to exact output nnz
//   * numeric pass writes into exactly-sized disjoint output slices
//
// Build: python -m sparse_matrix_tpu.native.build

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

typedef int64_t i64;
typedef uint32_t u32;

static const u32 kEmpty = 0xFFFFFFFFu;
static const i64 kMinCap = 16;

static inline u32 hash_u32(u32 k) { return k * 107u; }

static inline i64 next_pow2(i64 n) {
  i64 p = 1;
  while (p < n) p <<= 1;
  return p;
}

static inline i64 table_capacity(i64 n) {
  // next_pow2(n) * 2, min 16 => load factor <= 1/2
  i64 c = next_pow2(n < 1 ? 1 : n) * 2;
  return c < kMinCap ? kMinCap : c;
}

// ---------------------------------------------------------------------------
// Debug instrumentation: probe-length histograms (the reference's `debug`
// cargo feature, linprobe/src/map.rs:17-18 + spam_csr/src/mul_hash.rs:18-25,
// 98-99, 188-189 — per-phase probe histograms recorded by the engine that
// actually runs). Runtime flag instead of a compile-time feature: when off,
// the hot loops pay one predictable branch. Bin i counts lookups that took
// i extra probe steps (0 = direct hit), capped at kProbeBins-1.
// ---------------------------------------------------------------------------

static const int kProbeBins = 64;
static bool g_debug_probes = false;
static std::atomic<long long> g_probe_hist_symbolic[kProbeBins];
static std::atomic<long long> g_probe_hist_numeric[kProbeBins];

extern "C" void spmx_debug_set(int on) { g_debug_probes = on != 0; }

extern "C" void spmx_debug_clear() {
  for (int i = 0; i < kProbeBins; ++i) {
    g_probe_hist_symbolic[i].store(0, std::memory_order_relaxed);
    g_probe_hist_numeric[i].store(0, std::memory_order_relaxed);
  }
}

// out_symbolic/out_numeric: caller-allocated i64[64] each.
extern "C" void spmx_debug_probe_hist(i64* out_symbolic, i64* out_numeric) {
  for (int i = 0; i < kProbeBins; ++i) {
    out_symbolic[i] = (i64)g_probe_hist_symbolic[i].load(std::memory_order_relaxed);
    out_numeric[i] = (i64)g_probe_hist_numeric[i].load(std::memory_order_relaxed);
  }
}

namespace {

// Per-thread histogram buffer; flushed to the global atomics once per chunk
// so the instrumented hot loop stays atomic-free.
struct ProbeHist {
  long long bins[kProbeBins] = {};
  inline void record(int steps) {
    ++bins[steps < kProbeBins ? steps : kProbeBins - 1];
  }
  void flush(std::atomic<long long>* global) {
    for (int i = 0; i < kProbeBins; ++i) {
      if (bins[i]) {
        global[i].fetch_add(bins[i], std::memory_order_relaxed);
        bins[i] = 0;
      }
    }
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// FLOP counting + row partitioning (the rows_to_threads analog)
// ---------------------------------------------------------------------------

extern "C" void spmx_flops_per_row(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                        const i64* rhs_offsets, i64* out_flops) {
  for (i64 i = 0; i < rows; ++i) {
    i64 acc = 0;
    for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
      u32 k = lhs_indices[p];
      acc += rhs_offsets[k + 1] - rhs_offsets[k];
    }
    out_flops[i] = acc;
  }
}

// rows_offset has num_parts+1 slots; chunks get ~equal FLOPs.
extern "C" void spmx_partition_rows(i64 rows, const i64* flops, i64 num_parts, i64* rows_offset) {
  std::vector<i64> ps(rows + 1);
  ps[0] = 0;
  for (i64 i = 0; i < rows; ++i) ps[i + 1] = ps[i] + flops[i];
  i64 total = ps[rows];
  i64 avg = num_parts > 0 ? (total + num_parts - 1) / num_parts : total;
  rows_offset[0] = 0;
  for (i64 t = 1; t < num_parts; ++t) {
    // first index with ps > avg*t, minus 1
    const i64* ub = std::upper_bound(ps.data(), ps.data() + rows + 1, avg * t);
    rows_offset[t] = (ub - ps.data()) - 1;
  }
  rows_offset[num_parts] = rows;
}

// ---------------------------------------------------------------------------
// Symbolic phase: exact per-row output nnz via a per-thread probe set
// ---------------------------------------------------------------------------

namespace {

struct ProbeSet {
  std::vector<u32> slots;
  i64 window = 0;

  void reserve_window(i64 n) {
    i64 cap = table_capacity(n);
    if ((i64)slots.size() < cap) slots.assign(cap, kEmpty);
    else std::fill(slots.begin(), slots.begin() + cap, kEmpty);
    window = cap;
  }

  // returns 1 if new
  inline int insert(u32 key) {
    i64 mask = window - 1;
    i64 idx = hash_u32(key) & mask;
    for (int steps = 0;; ++steps) {
      u32 cur = slots[idx];
      if (cur == kEmpty) {
        slots[idx] = key;
        if (g_debug_probes) hist.record(steps);
        return 1;
      }
      if (cur == key) {
        if (g_debug_probes) hist.record(steps);
        return 0;
      }
      idx = (idx + 1) & mask;
    }
  }

  ProbeHist hist;
};

template <typename V>
struct ProbeMap {
  std::vector<u32> keys;
  std::vector<V> vals;
  i64 window = 0;

  void reserve_window(i64 n) {
    i64 cap = table_capacity(n);
    if ((i64)keys.size() < cap) {
      keys.assign(cap, kEmpty);
      vals.assign(cap, V());
    } else {
      std::fill(keys.begin(), keys.begin() + cap, kEmpty);
    }
    window = cap;
  }

  inline void upsert(u32 key, V v) {
    i64 mask = window - 1;
    i64 idx = hash_u32(key) & mask;
    for (int steps = 0;; ++steps) {
      u32 cur = keys[idx];
      if (cur == kEmpty) {
        keys[idx] = key;
        vals[idx] = v;
        if (g_debug_probes) hist.record(steps);
        return;
      }
      if (cur == key) {
        vals[idx] += v;
        if (g_debug_probes) hist.record(steps);
        return;
      }
      idx = (idx + 1) & mask;
    }
  }

  ProbeHist hist;
};

void run_chunked(i64 num_parts, const i64* rows_offset, int num_threads,
                 const std::function<void(i64, i64, i64)>& body) {
  // body(chunk_id, row_lo, row_hi)
  std::vector<std::thread> threads;
  std::atomic<i64> next(0);
  int tcount = num_threads > 0 ? num_threads : (int)std::thread::hardware_concurrency();
  if (tcount < 1) tcount = 1;
  auto worker = [&]() {
    for (;;) {
      i64 c = next.fetch_add(1);
      if (c >= num_parts) break;
      body(c, rows_offset[c], rows_offset[c + 1]);
    }
  };
  for (int t = 1; t < tcount; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // namespace

// row_nz in: FLOP upper bounds; out: exact output nnz per row.
extern "C" void spmx_spgemm_symbolic(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                          const i64* rhs_offsets, const u32* rhs_indices,
                          const i64* rows_offset, i64 num_parts, int num_threads,
                          i64* row_nz) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    ProbeSet hs;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      hs.reserve_window(row_nz[i]);
      i64 count = 0;
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          count += hs.insert(rhs_indices[q]);
        }
      }
      row_nz[i] = count;
    }
    if (g_debug_probes) hs.hist.flush(g_probe_hist_symbolic);
  });
}

// Numeric phase, templated over the value type.
template <typename V>
static void spgemm_numeric_impl(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                                const V* lhs_vals, const i64* rhs_offsets,
                                const u32* rhs_indices, const V* rhs_vals,
                                const i64* out_offsets, const i64* row_nz,
                                const i64* rows_offset, i64 num_parts, int num_threads,
                                int output_sorted, u32* out_indices, V* out_vals) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    ProbeMap<V> hm;
    std::vector<std::pair<u32, V>> row_buf;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      hm.reserve_window(row_nz[i]);
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        V t = lhs_vals[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          hm.upsert(rhs_indices[q], t * rhs_vals[q]);
        }
      }
      i64 base = out_offsets[i];
      if (output_sorted) {
        row_buf.clear();
        for (i64 s = 0; s < hm.window; ++s) {
          if (hm.keys[s] != kEmpty) row_buf.emplace_back(hm.keys[s], hm.vals[s]);
        }
        std::sort(row_buf.begin(), row_buf.end(),
                  [](const auto& a, const auto& b) { return a.first < b.first; });
        for (i64 s = 0; s < (i64)row_buf.size(); ++s) {
          out_indices[base + s] = row_buf[s].first;
          out_vals[base + s] = row_buf[s].second;
        }
      } else {
        i64 w = 0;
        for (i64 s = 0; s < hm.window; ++s) {
          if (hm.keys[s] != kEmpty) {
            out_indices[base + w] = hm.keys[s];
            out_vals[base + w] = hm.vals[s];
            ++w;
          }
        }
      }
    }
    if (g_debug_probes) hm.hist.flush(g_probe_hist_numeric);
  });
}

extern "C" void spmx_spgemm_numeric_f64(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                             const double* lhs_vals, const i64* rhs_offsets,
                             const u32* rhs_indices, const double* rhs_vals,
                             const i64* out_offsets, const i64* row_nz,
                             const i64* rows_offset, i64 num_parts, int num_threads,
                             int output_sorted, u32* out_indices, double* out_vals) {
  spgemm_numeric_impl<double>(rows, lhs_offsets, lhs_indices, lhs_vals, rhs_offsets,
                              rhs_indices, rhs_vals, out_offsets, row_nz, rows_offset,
                              num_parts, num_threads, output_sorted, out_indices, out_vals);
}

extern "C" void spmx_spgemm_numeric_f32(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                             const float* lhs_vals, const i64* rhs_offsets,
                             const u32* rhs_indices, const float* rhs_vals,
                             const i64* out_offsets, const i64* row_nz,
                             const i64* rows_offset, i64 num_parts, int num_threads,
                             int output_sorted, u32* out_indices, float* out_vals) {
  spgemm_numeric_impl<float>(rows, lhs_offsets, lhs_indices, lhs_vals, rhs_offsets,
                             rhs_indices, rhs_vals, out_offsets, row_nz, rows_offset,
                             num_parts, num_threads, output_sorted, out_indices, out_vals);
}

extern "C" void spmx_spgemm_numeric_i64(i64 rows, const i64* lhs_offsets, const u32* lhs_indices,
                             const i64* lhs_vals, const i64* rhs_offsets,
                             const u32* rhs_indices, const i64* rhs_vals,
                             const i64* out_offsets, const i64* row_nz,
                             const i64* rows_offset, i64 num_parts, int num_threads,
                             int output_sorted, u32* out_indices, i64* out_vals) {
  spgemm_numeric_impl<i64>(rows, lhs_offsets, lhs_indices, lhs_vals, rhs_offsets,
                           rhs_indices, rhs_vals, out_offsets, row_nz, rows_offset,
                           num_parts, num_threads, output_sorted, out_indices, out_vals);
}

// Gustavson SPA (sparse accumulator) variants of the two phases: an
// epoch-marked dense array over the output column space replaces the hash
// probes — one array access per product instead of a probe chain. Wins
// when cols fits in per-chunk memory and products have locality (AMG
// Galerkin / smoothing chains, stencil squarings); the Python wrapper
// gates on cols and total FLOPs. Same chunking, allocation, and output
// contract as the hash phases (kept zeros, optional sorted rows).
extern "C" void spmx_spgemm_symbolic_spa(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const i64* rhs_offsets, const u32* rhs_indices, const i64* rows_offset,
    i64 num_parts, int num_threads, i64* row_nz) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    std::vector<u32> mark((size_t)cols, 0);
    u32 epoch = 0;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      if (++epoch == 0) { std::fill(mark.begin(), mark.end(), 0); epoch = 1; }
      i64 count = 0;
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          u32 c = rhs_indices[q];
          if (mark[c] != epoch) { mark[c] = epoch; ++count; }
        }
      }
      row_nz[i] = count;
    }
  });
}

template <typename V>
static void spgemm_numeric_spa_impl(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const V* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const V* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, V* out_vals) {
  run_chunked(num_parts, rows_offset, num_threads, [&](i64, i64 lo, i64 hi) {
    std::vector<V> acc((size_t)cols);
    std::vector<u32> mark((size_t)cols, 0);
    std::vector<u32> touched;
    u32 epoch = 0;
    for (i64 i = lo; i < hi; ++i) {
      if (row_nz[i] == 0) continue;
      if (++epoch == 0) { std::fill(mark.begin(), mark.end(), 0); epoch = 1; }
      touched.clear();
      for (i64 p = lhs_offsets[i]; p < lhs_offsets[i + 1]; ++p) {
        u32 k = lhs_indices[p];
        V t = lhs_vals[p];
        for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
          u32 c = rhs_indices[q];
          V pv = t * rhs_vals[q];
          if (mark[c] != epoch) {
            mark[c] = epoch;
            acc[c] = pv;
            touched.push_back(c);
          } else {
            acc[c] += pv;
          }
        }
      }
      if (output_sorted) std::sort(touched.begin(), touched.end());
      i64 base = out_offsets[i];
      for (i64 s = 0; s < (i64)touched.size(); ++s) {
        out_indices[base + s] = touched[(size_t)s];
        out_vals[base + s] = acc[touched[(size_t)s]];
      }
    }
  });
}

extern "C" void spmx_spgemm_numeric_spa_f64(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const double* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const double* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, double* out_vals) {
  spgemm_numeric_spa_impl<double>(rows, cols, lhs_offsets, lhs_indices, lhs_vals,
                                  rhs_offsets, rhs_indices, rhs_vals, out_offsets,
                                  row_nz, rows_offset, num_parts, num_threads,
                                  output_sorted, out_indices, out_vals);
}
extern "C" void spmx_spgemm_numeric_spa_f32(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const float* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const float* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, float* out_vals) {
  spgemm_numeric_spa_impl<float>(rows, cols, lhs_offsets, lhs_indices, lhs_vals,
                                 rhs_offsets, rhs_indices, rhs_vals, out_offsets,
                                 row_nz, rows_offset, num_parts, num_threads,
                                 output_sorted, out_indices, out_vals);
}
extern "C" void spmx_spgemm_numeric_spa_i64(
    i64 rows, i64 cols, const i64* lhs_offsets, const u32* lhs_indices,
    const i64* lhs_vals, const i64* rhs_offsets, const u32* rhs_indices,
    const i64* rhs_vals, const i64* out_offsets, const i64* row_nz,
    const i64* rows_offset, i64 num_parts, int num_threads, int output_sorted,
    u32* out_indices, i64* out_vals) {
  spgemm_numeric_spa_impl<i64>(rows, cols, lhs_offsets, lhs_indices, lhs_vals,
                               rhs_offsets, rhs_indices, rhs_vals, out_offsets,
                               row_nz, rows_offset, num_parts, num_threads,
                               output_sorted, out_indices, out_vals);
}

extern "C" int spmx_hardware_threads() { return (int)std::thread::hardware_concurrency(); }

// ABI version marker for the ctypes loader.
extern "C" int spmx_abi_version() { return 1; }

// ---------------------------------------------------------------------------
// Fast MatrixMarket entry scanner: parses "row col value" lines in bulk.
// The Python side handles the header/size lines and symmetry expansion;
// this handles the O(nnz) text. Returns the number of entries parsed, or
// -1 on malformed input.
// ---------------------------------------------------------------------------

#include <cstdlib>

extern "C" i64 spmx_parse_entries(const char* buf, i64 len, i64 expect,
                                  i64* rows, i64* cols, double* vals,
                                  int n_value_cols /* 0(pattern),1,2(complex) */,
                                  double* vals_imag) {
  const char* p = buf;
  const char* endp = buf + len;
  i64 count = 0;
  while (p < endp && count < expect) {
    // skip whitespace / blank lines
    while (p < endp && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= endp) break;
    char* next = nullptr;
    long long r = strtoll(p, &next, 10);
    if (next == p) return -1;
    p = next;
    long long c = strtoll(p, &next, 10);
    if (next == p) return -1;
    p = next;
    double v = 1.0, vi = 0.0;
    if (n_value_cols >= 1) {
      v = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    if (n_value_cols >= 2) {
      vi = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    rows[count] = (i64)r;
    cols[count] = (i64)c;
    vals[count] = v;
    if (vals_imag) vals_imag[count] = vi;
    ++count;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Dense-block sparsify: extract nonzeros of BSR blocks as COO, bounds-clipped.
// Pass 1 (count) then pass 2 (fill) keeps the Python side allocation-exact.
// ---------------------------------------------------------------------------

extern "C" i64 spmx_blocks_count_nnz(const float* blocks, i64 nnzb, i64 bs) {
  i64 count = 0;
  const float* p = blocks;
  const float* end = blocks + nnzb * bs * bs;
  for (; p < end; ++p) count += (*p != 0.0f);
  return count;
}

extern "C" i64 spmx_blocks_to_coo(const float* blocks, i64 nnzb, i64 bs,
                                  const i64* block_rows, const u32* block_cols,
                                  i64 rows, i64 cols,
                                  i64* out_r, i64* out_c, float* out_v) {
  i64 k = 0;
  for (i64 s = 0; s < nnzb; ++s) {
    i64 rbase = block_rows[s] * bs;
    i64 cbase = (i64)block_cols[s] * bs;
    const float* blk = blocks + s * bs * bs;
    for (i64 rr = 0; rr < bs; ++rr) {
      i64 r = rbase + rr;
      if (r >= rows) break;
      for (i64 cc = 0; cc < bs; ++cc) {
        float v = blk[rr * bs + cc];
        if (v != 0.0f) {
          i64 c = cbase + cc;
          if (c < cols) {
            out_r[k] = r;
            out_c[k] = c;
            out_v[k] = v;
            ++k;
          }
        }
      }
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// Greedy smoothed-aggregation clustering, passes 1 and 3 (solvers/amg.py).
// The natural-order greedy is a lexicographically-first MIS of the
// neighborhood-overlap conflict graph — inherently sequential (P-complete),
// so it belongs in the native runtime rather than a Python node loop
// (measured ~2.3 us/node in numpy vs ~5 ns/edge here).
// agg[] is -1 for unassigned on entry; returns the updated aggregate count.
// ---------------------------------------------------------------------------

extern "C" i64 spmx_aggregate_pass1(i64 n, const i64* so, const i64* si, i64* agg) {
  i64 na = 0;
  for (i64 i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    i64 b = so[i], e = so[i + 1];
    bool blocked = false;
    for (i64 k = b; k < e; ++k)
      if (agg[si[k]] >= 0) { blocked = true; break; }
    if (blocked) continue;
    for (i64 k = b; k < e; ++k) agg[si[k]] = na;
    agg[i] = na;
    ++na;
  }
  return na;
}

// Pass 2: attach each leftover node to the SMALLEST adjacent pass-1
// aggregate id. All decisions must read the PASS-1 state (the numpy
// vectorized form this replaces evaluated `agg >= 0` once, up front), so
// in-loop attachments are stored encoded as `-2 - id` — still negative,
// hence invisible to later nodes' `agg[j] >= 0` scans — and decoded in a
// second sweep. Returns the number of nodes attached.
extern "C" i64 spmx_aggregate_pass2(i64 n, const i64* so, const i64* si, i64* agg) {
  i64 attached = 0;
  for (i64 i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    i64 m = -1;
    for (i64 k = so[i]; k < so[i + 1]; ++k) {
      i64 aj = agg[si[k]];
      if (aj >= 0 && (m < 0 || aj < m)) m = aj;
    }
    if (m >= 0) { agg[i] = -2 - m; ++attached; }
  }
  if (attached)
    for (i64 i = 0; i < n; ++i)
      if (agg[i] < -1) agg[i] = -2 - agg[i];
  return attached;
}

extern "C" i64 spmx_aggregate_pass3(i64 n, const i64* so, const i64* si, i64 na, i64* agg) {
  for (i64 i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    agg[i] = na;
    for (i64 k = so[i]; k < so[i + 1]; ++k) {
      i64 j = si[k];
      if (agg[j] < 0) agg[j] = na;
    }
    ++na;
  }
  return na;
}

// ---------------------------------------------------------------------------
// ILU(0) factorization + exact triangular solves (solvers/ilu.py).
// IKJ row variant on the fixed CSR pattern (no fill): for each row i, fold
// in every finished row k < i present in row i. Sequential along the row
// dependency chain — native-runtime work, like the reference's host kernels
// (spam_csr/src/mul_hash.rs is the same "host does the irregular part"
// stance). Requires sorted column indices. Returns -1 on success or the
// first row with a zero pivot.
// ---------------------------------------------------------------------------

template <typename V>
static i64 ilu0_impl(i64 rows, const i64* offsets, const u32* indices, V* vals,
                     const i64* diag_pos, i64* w /* size cols, init -1 */) {
  for (i64 i = 0; i < rows; ++i) {
    i64 b = offsets[i], e = offsets[i + 1];
    for (i64 t = b; t < e; ++t) w[indices[t]] = t;
    for (i64 t = b; t < e && (i64)indices[t] < i; ++t) {
      i64 k = (i64)indices[t];
      i64 dk = diag_pos[k];
      if (dk < 0 || vals[dk] == (V)0) { return k; }
      V f = vals[t] / vals[dk];
      vals[t] = f;
      for (i64 s = dk + 1; s < offsets[k + 1]; ++s) {
        i64 p = w[indices[s]];
        if (p >= 0) vals[p] -= f * vals[s];
      }
    }
    if (diag_pos[i] < 0 || vals[diag_pos[i]] == (V)0) return i;
    for (i64 t = b; t < e; ++t) w[indices[t]] = -1;
  }
  return -1;
}

extern "C" i64 spmx_ilu0_f64(i64 rows, i64 cols, const i64* offsets,
                             const u32* indices, double* vals, const i64* diag_pos) {
  std::vector<i64> w((size_t)cols, -1);
  return ilu0_impl<double>(rows, offsets, indices, vals, diag_pos, w.data());
}

extern "C" i64 spmx_ilu0_f32(i64 rows, i64 cols, const i64* offsets,
                             const u32* indices, float* vals, const i64* diag_pos) {
  std::vector<i64> w((size_t)cols, -1);
  return ilu0_impl<float>(rows, offsets, indices, vals, diag_pos, w.data());
}

// Exact host triangular solve on CSR (x overwrites b). lower=1: forward
// sweep, rows ascending; lower=0: backward. unit=1 skips the diagonal
// divide (unit-diagonal factor). Requires sorted indices + diag_pos.
template <typename V>
static i64 trisolve_impl(i64 rows, const i64* offsets, const u32* indices,
                         const V* vals, const i64* diag_pos, V* x, int lower, int unit) {
  for (i64 step = 0; step < rows; ++step) {
    i64 i = lower ? step : rows - 1 - step;
    i64 b = offsets[i], e = offsets[i + 1];
    V acc = x[i];
    if (lower) {
      for (i64 t = b; t < e && (i64)indices[t] < i; ++t) acc -= vals[t] * x[indices[t]];
    } else {
      i64 d = diag_pos[i];
      for (i64 t = (d >= 0 ? d + 1 : b); t < e; ++t) acc -= vals[t] * x[indices[t]];
    }
    if (!unit) {
      i64 d = diag_pos[i];
      if (d < 0 || vals[d] == (V)0) return i;
      acc /= vals[d];
    }
    x[i] = acc;
  }
  return -1;
}

extern "C" i64 spmx_trisolve_f64(i64 rows, const i64* offsets, const u32* indices,
                                 const double* vals, const i64* diag_pos,
                                 double* x, int lower, int unit) {
  return trisolve_impl<double>(rows, offsets, indices, vals, diag_pos, x, lower, unit);
}

extern "C" i64 spmx_trisolve_f32(i64 rows, const i64* offsets, const u32* indices,
                                 const float* vals, const i64* diag_pos,
                                 float* x, int lower, int unit) {
  return trisolve_impl<float>(rows, offsets, indices, vals, diag_pos, x, lower, unit);
}

// ---------------------------------------------------------------------------
// ILUT(p, tau): threshold incomplete LU with per-row fill cap (solvers/ilu.py).
// Saad's IKJ row variant with a lazy min-heap driving the ascending-k
// elimination order (fill can create new L-part entries mid-row). Dual
// dropping: entries below tau * ||row||_2 vanish during elimination; then
// only the p largest-|.| survive per part (diagonal always kept).
// Outputs fixed-cap row arrays (L cap p, U cap p+1 incl. diagonal);
// columns within a row are unsorted (host sorts once). Returns the first
// zero-pivot row or -1.
// ---------------------------------------------------------------------------

#include <queue>
#include <cmath>
#include <algorithm>

template <typename V>
static i64 ilut_impl(i64 rows, const i64* offsets, const u32* indices, const V* vals,
                     double tau, i64 p,
                     i64* l_cnt, u32* l_idx, V* l_val,
                     i64* u_cnt, u32* u_idx, V* u_val,
                     i64 cols) {
  std::vector<double> w((size_t)cols, 0.0);
  std::vector<char> inw((size_t)cols, 0);
  std::vector<u32> touched;
  std::priority_queue<i64, std::vector<i64>, std::greater<i64>> heap;

  for (i64 i = 0; i < rows; ++i) {
    touched.clear();
    double norm2 = 0.0;
    for (i64 t = offsets[i]; t < offsets[i + 1]; ++t) {
      u32 j = indices[t];
      double v = (double)vals[t];
      if (!inw[j]) { inw[j] = 1; touched.push_back(j); w[j] = v; }
      else w[j] += v;
      norm2 += v * v;
      if ((i64)j < i) heap.push((i64)j);
    }
    double taui = tau * std::sqrt(norm2);

    i64 last = -1;
    while (!heap.empty()) {
      i64 k = heap.top(); heap.pop();
      if (k == last) continue;  // lazy dedup
      last = k;
      if (!inw[k]) continue;
      double wk = w[k];
      if (std::fabs(wk) < taui) { w[k] = 0.0; continue; }  // drop, stays touched
      // divide by U_kk (first stored entry of U row k is the diagonal).
      // The pivot was nonzero in the double workspace when row k was
      // committed, but can underflow to 0 when stored as V=float — guard
      // so a subnormal factor reports zero-pivot row k instead of
      // poisoning the factors with inf/NaN.
      double piv = (double)u_val[k * (p + 1)];
      if (piv == 0.0) {
        for (u32 j : touched) { inw[j] = 0; w[j] = 0.0; }
        return k;
      }
      wk /= piv;
      w[k] = wk;
      for (i64 s = 1; s < u_cnt[k]; ++s) {
        u32 j = u_idx[k * (p + 1) + s];
        double upd = wk * (double)u_val[k * (p + 1) + s];
        if (!inw[j]) {
          if (std::fabs(upd) < taui) continue;  // don't create tiny fill
          inw[j] = 1; touched.push_back(j); w[j] = -upd;
          if ((i64)j < i) heap.push((i64)j);
        } else {
          w[j] -= upd;
        }
      }
    }

    // partition touched into L (k < i) and U (j > i), diag separate
    static thread_local std::vector<std::pair<double, u32>> lpart, upart;
    lpart.clear(); upart.clear();
    double diag = 0.0;
    for (u32 j : touched) {
      double v = w[j];
      if ((i64)j == i) diag = v;
      else if (std::fabs(v) >= taui && v != 0.0) {
        if ((i64)j < i) lpart.push_back({std::fabs(v), j});
        else upart.push_back({std::fabs(v), j});
      }
    }
    // check at storage precision: a double diag that underflows to 0 when
    // stored as V would otherwise poison later rows' divisions with inf/NaN
    if ((V)diag == (V)0) {
      for (u32 j : touched) { inw[j] = 0; w[j] = 0.0; }
      return i;
    }
    auto keep_top = [](std::vector<std::pair<double, u32>>& part, i64 cap) {
      if ((i64)part.size() > cap) {
        std::nth_element(part.begin(), part.begin() + cap, part.end(),
                         [](const std::pair<double, u32>& a, const std::pair<double, u32>& b) { return a.first > b.first; });
        part.resize((size_t)cap);
      }
    };
    keep_top(lpart, p);
    keep_top(upart, p);
    i64 lc = 0;
    for (auto& pr : lpart) {
      l_idx[i * p + lc] = pr.second;
      l_val[i * p + lc] = (V)w[pr.second];
      ++lc;
    }
    l_cnt[i] = lc;
    // U row: diagonal first (factorization scans rely on this layout)
    u_idx[i * (p + 1)] = (u32)i;
    u_val[i * (p + 1)] = (V)diag;
    i64 uc = 1;
    for (auto& pr : upart) {
      u_idx[i * (p + 1) + uc] = pr.second;
      u_val[i * (p + 1) + uc] = (V)w[pr.second];
      ++uc;
    }
    u_cnt[i] = uc;

    for (u32 j : touched) { inw[j] = 0; w[j] = 0.0; }
  }
  return -1;
}

extern "C" i64 spmx_ilut_f64(i64 rows, i64 cols, const i64* offsets, const u32* indices,
                             const double* vals, double tau, i64 p,
                             i64* l_cnt, u32* l_idx, double* l_val,
                             i64* u_cnt, u32* u_idx, double* u_val) {
  return ilut_impl<double>(rows, offsets, indices, vals, tau, p,
                           l_cnt, l_idx, l_val, u_cnt, u_idx, u_val, cols);
}

extern "C" i64 spmx_ilut_f32(i64 rows, i64 cols, const i64* offsets, const u32* indices,
                             const float* vals, double tau, i64 p,
                             i64* l_cnt, u32* l_idx, float* l_val,
                             i64* u_cnt, u32* u_idx, float* u_val) {
  return ilut_impl<float>(rows, offsets, indices, vals, tau, p,
                          l_cnt, l_idx, l_val, u_cnt, u_idx, u_val, cols);
}

// ---------------------------------------------------------------------------
// AMG setup analysis (solvers/amg.py). The coarsening loop's per-level host
// passes (strength graph, diagonal extraction, Gershgorin row sums, row
// scaling) are single sweeps over nnz that numpy pays multiple temporaries
// for — at 4096^2 Poisson (84M nnz) they were ~100 s of the 600 s setup
// profile. Native runtime work, same stance as the reference's host-side
// irregular kernels (spam_csr/src/mul_hash.rs).
//
// Strength test (strength_graph, amg.py): edge (i, j), i != j, is strong
// when |a_ij| >= theta * sqrt(diag_i * diag_j) — compared in squares to
// skip the per-edge sqrt. diag[] must already have the zero/missing-row
// fallback applied (host does that from the rowmax output of the first
// pass; n-sized, cheap).
// ---------------------------------------------------------------------------

template <typename V>
static void amg_diag_abssum_impl(i64 n, const i64* offsets, const u32* indices,
                                 const V* vals, double* diag, double* abssum,
                                 double* rowmax) {
  for (i64 i = 0; i < n; ++i) {
    double d = 0.0, s = 0.0, mx = 0.0;
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      double a = (double)vals[k];
      double aa = a < 0 ? -a : a;
      s += aa;
      if (aa > mx) mx = aa;
      if ((i64)indices[k] == i) d = a;
    }
    diag[i] = d;
    abssum[i] = s;
    rowmax[i] = mx;
  }
}

extern "C" void spmx_amg_diag_abssum_f64(i64 n, const i64* offsets, const u32* indices,
                                         const double* vals, double* diag,
                                         double* abssum, double* rowmax) {
  amg_diag_abssum_impl<double>(n, offsets, indices, vals, diag, abssum, rowmax);
}

extern "C" void spmx_amg_diag_abssum_f32(i64 n, const i64* offsets, const u32* indices,
                                         const float* vals, double* diag,
                                         double* abssum, double* rowmax) {
  amg_diag_abssum_impl<float>(n, offsets, indices, vals, diag, abssum, rowmax);
}

template <typename V>
static void strength_count_impl(i64 n, const i64* offsets, const u32* indices,
                                const V* vals, double theta2, const double* diag,
                                i64* counts) {
  for (i64 i = 0; i < n; ++i) {
    i64 c = 0;
    double ti = theta2 * diag[i];
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      i64 j = (i64)indices[k];
      if (j == i) continue;
      double a = (double)vals[k];
      if (a * a >= ti * diag[j]) ++c;
    }
    counts[i] = c;
  }
}

template <typename V>
static void strength_fill_impl(i64 n, const i64* offsets, const u32* indices,
                               const V* vals, double theta2, const double* diag,
                               const i64* s_offsets, i64* s_indices) {
  for (i64 i = 0; i < n; ++i) {
    i64 c = s_offsets[i];
    double ti = theta2 * diag[i];
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      i64 j = (i64)indices[k];
      if (j == i) continue;
      double a = (double)vals[k];
      if (a * a >= ti * diag[j]) s_indices[c++] = j;
    }
  }
}

extern "C" void spmx_strength_count_f64(i64 n, const i64* offsets, const u32* indices,
                                        const double* vals, double theta2,
                                        const double* diag, i64* counts) {
  strength_count_impl<double>(n, offsets, indices, vals, theta2, diag, counts);
}

extern "C" void spmx_strength_count_f32(i64 n, const i64* offsets, const u32* indices,
                                        const float* vals, double theta2,
                                        const double* diag, i64* counts) {
  strength_count_impl<float>(n, offsets, indices, vals, theta2, diag, counts);
}

extern "C" void spmx_strength_fill_f64(i64 n, const i64* offsets, const u32* indices,
                                       const double* vals, double theta2,
                                       const double* diag, const i64* s_offsets,
                                       i64* s_indices) {
  strength_fill_impl<double>(n, offsets, indices, vals, theta2, diag, s_offsets, s_indices);
}

extern "C" void spmx_strength_fill_f32(i64 n, const i64* offsets, const u32* indices,
                                       const float* vals, double theta2,
                                       const double* diag, const i64* s_offsets,
                                       i64* s_indices) {
  strength_fill_impl<float>(n, offsets, indices, vals, theta2, diag, s_offsets, s_indices);
}

// Row-scaled copy out[k] = vals[k] * s[row(k)]  (amg.py _scale_rows: the
// prolongator-smoothing product's diag(s) @ A operand, one sweep, no
// dtype-conversion temporaries).
template <typename V>
static void scale_rows_impl(i64 n, const i64* offsets, const V* vals,
                            const double* s, V* out) {
  for (i64 i = 0; i < n; ++i) {
    double si = s[i];
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k)
      out[k] = (V)((double)vals[k] * si);
  }
}

extern "C" void spmx_scale_rows_f64(i64 n, const i64* offsets, const double* vals,
                                    const double* s, double* out) {
  scale_rows_impl<double>(n, offsets, vals, s, out);
}

extern "C" void spmx_scale_rows_f32(i64 n, const i64* offsets, const float* vals,
                                    const double* s, float* out) {
  scale_rows_impl<float>(n, offsets, vals, s, out);
}

// Jacobi smoother values out[k] = -vals[k] * ws[row(k)] + (1 at the
// diagonal) in one sweep (amg.py _jacobi_smoother_matrix: S = I -
// diag(ws) A sharing A's pattern). Returns the number of rows holding an
// explicit diagonal entry — the caller requires it to equal n.
template <typename V>
static i64 jacobi_smoother_impl(i64 n, const i64* offsets, const u32* indices,
                                const V* vals, const double* ws, V* out) {
  i64 ndiag = 0;
  for (i64 i = 0; i < n; ++i) {
    double wi = ws[i];
    bool seen = false;
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      double v = -(double)vals[k] * wi;
      if ((i64)indices[k] == i) {
        v += 1.0;
        if (!seen) { seen = true; ++ndiag; }
      }
      out[k] = (V)v;
    }
  }
  return ndiag;
}

extern "C" i64 spmx_jacobi_smoother_f64(i64 n, const i64* offsets, const u32* indices,
                                        const double* vals, const double* ws, double* out) {
  return jacobi_smoother_impl<double>(n, offsets, indices, vals, ws, out);
}

extern "C" i64 spmx_jacobi_smoother_f32(i64 n, const i64* offsets, const u32* indices,
                                        const float* vals, const double* ws, float* out) {
  return jacobi_smoother_impl<float>(n, offsets, indices, vals, ws, out);
}

// CSR transpose by counting sort (formats/csr.py transpose): count per
// column, prefix on the host, then one stable scatter sweep — row-sorted
// input makes the output's per-row columns sorted by construction. The
// lexsort path this replaces was ~2 s per 84M-nnz call.
template <typename V>
static void csr_transpose_impl(i64 rows, i64 cols, const i64* offsets,
                               const u32* indices, const V* vals,
                               i64* t_cursor /* cols, prefix-sum start positions */,
                               u32* t_indices, V* t_vals) {
  for (i64 i = 0; i < rows; ++i) {
    for (i64 k = offsets[i]; k < offsets[i + 1]; ++k) {
      i64 p = t_cursor[indices[k]]++;
      t_indices[p] = (u32)i;
      t_vals[p] = vals[k];
    }
  }
}

extern "C" void spmx_csr_transpose_f64(i64 rows, i64 cols, const i64* offsets,
                                       const u32* indices, const double* vals,
                                       i64* t_cursor, u32* t_indices, double* t_vals) {
  csr_transpose_impl<double>(rows, cols, offsets, indices, vals, t_cursor, t_indices, t_vals);
}

extern "C" void spmx_csr_transpose_f32(i64 rows, i64 cols, const i64* offsets,
                                       const u32* indices, const float* vals,
                                       i64* t_cursor, u32* t_indices, float* t_vals) {
  csr_transpose_impl<float>(rows, cols, offsets, indices, vals, t_cursor, t_indices, t_vals);
}

// ---------------------------------------------------------------------------
// Format-planning substrate (AMG setup at scale)
//
// The SpMV operator planner and the SpGEMM dispatcher analyze matrix
// structure on the host. At multi-million nnz the numpy versions of these
// analyses (np.unique over element offsets, global argsort over chunk
// keys) dominated AMG setup (the hierarchy construction plans ~15 device
// operators per 2048^2 Poisson setup). These kernels exploit what numpy
// cannot: single-pass hash histograms, and the block-locality of the
// planner's sort keys (a chunk key's high bits are the 128-row block, and
// CSR order already groups entries by block — so the "global" sort is
// really r128 independent cache-resident sorts).
// ---------------------------------------------------------------------------

typedef uint64_t u64;

static inline u32 hash_i64(i64 o) {
  u64 x = (u64)o;
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  return (u32)x;
}

// Distinct element offsets (c - r) with counts, one pass, capped.
// out_offs/out_counts must hold `cap` slots. Returns ndistinct (entries
// sorted ascending), or -1 when more than `cap` distinct offsets exist
// (early exit — the caller treats the matrix as not band-structured).
extern "C" i64 spmx_offset_hist(i64 rows, const i64* offsets, const u32* indices,
                                i64 cap, i64* out_offs, i64* out_counts) {
  i64 tcap = table_capacity(cap);
  std::vector<i64> keys((size_t)tcap, INT64_MIN);
  std::vector<i64> cnts((size_t)tcap, 0);
  i64 mask = tcap - 1;
  i64 n = 0;
  i64 last_o = INT64_MIN;
  i64 last_slot = -1;
  for (i64 i = 0; i < rows; ++i) {
    for (i64 p = offsets[i]; p < offsets[i + 1]; ++p) {
      i64 o = (i64)indices[p] - i;
      if (o == last_o) {  // runs along a diagonal hit across rows too
        ++cnts[(size_t)last_slot];
        continue;
      }
      i64 s = (i64)(hash_i64(o) & (u32)mask);
      for (;;) {
        if (keys[(size_t)s] == o) break;
        if (keys[(size_t)s] == INT64_MIN) {
          if (++n > cap) return -1;
          keys[(size_t)s] = o;
          break;
        }
        s = (s + 1) & mask;
      }
      ++cnts[(size_t)s];
      last_o = o;
      last_slot = s;
    }
  }
  // emit sorted ascending
  std::vector<std::pair<i64, i64>> out;
  out.reserve((size_t)n);
  for (i64 s = 0; s < tcap; ++s)
    if (keys[(size_t)s] != INT64_MIN) out.push_back({keys[(size_t)s], cnts[(size_t)s]});
  std::sort(out.begin(), out.end());
  for (size_t k = 0; k < out.size(); ++k) {
    out_offs[k] = out[k].first;
    out_counts[k] = out[k].second;
  }
  return n;
}

// Stable argsort of u64 keys within each contiguous block
// [starts[b], starts[b+1]); out_perm receives global indices. Blocks are
// small (entries of 128 rows), so each sort runs in cache.
extern "C" void spmx_blockwise_argsort_u64(i64 nblocks, const i64* starts,
                                           const u64* keys, i64* out_perm) {
  std::vector<std::pair<u64, i64>> buf;
  for (i64 b = 0; b < nblocks; ++b) {
    i64 lo = starts[b], hi = starts[b + 1];
    i64 len = hi - lo;
    if (len <= 0) continue;
    buf.resize((size_t)len);
    for (i64 i = 0; i < len; ++i) buf[(size_t)i] = {keys[lo + i], lo + i};
    // indices are distinct, so plain sort on (key, idx) is stable-by-key
    std::sort(buf.begin(), buf.end());
    for (i64 i = 0; i < len; ++i) out_perm[lo + i] = buf[(size_t)i].second;
  }
}

// Fused gather: out[i] = src[perm[i]] for the planner's payload arrays.
template <typename T>
static void apply_perm_impl(i64 n, const i64* perm, const T* src, T* out) {
  for (i64 i = 0; i < n; ++i) out[i] = src[perm[i]];
}

extern "C" void spmx_apply_perm_u32(i64 n, const i64* perm, const u32* src, u32* out) {
  apply_perm_impl<u32>(n, perm, src, out);
}
extern "C" void spmx_apply_perm_f32(i64 n, const i64* perm, const float* src, float* out) {
  apply_perm_impl<float>(n, perm, src, out);
}
extern "C" void spmx_apply_perm_i64(i64 n, const i64* perm, const i64* src, i64* out) {
  apply_perm_impl<i64>(n, perm, src, out);
}

// ---------------------------------------------------------------------------
// Aligned-plan substrate (formats/aligned.py). A chunk is (128-row block,
// 128-col window, layer); layer is the entry's ordinal within its (row,
// window) run, always < 128 for valid CSR (sorted within rows, no
// duplicate columns). Key = ((rb*wtot + w) << 7) | layer — same
// lexicographic (rb, w, layer) order as the Python formula.
// ---------------------------------------------------------------------------

// Call 1: per-entry chunk keys + blockwise chunk sort, one fused pass.
// Requires within-row sorted columns. out_perm receives the chunk-sorted
// entry order (global indices), out_ck the sorted keys. Returns 0, or -1
// when a layer exceeds 127 (duplicate columns — caller falls back).
// Shared blockwise (per 128-row block) stable key sort: entries of a block
// are contiguous in sorted CSR, so the global sort decomposes into
// cache-resident per-block sorts; already-sorted blocks (single-band
// structures, short rows) skip the sort entirely.
static void blockwise_key_sort(i64 rows, const i64* offsets, i64* out_perm,
                               u64* out_ck) {
  const i64 LANES = 128;
  std::vector<std::pair<u64, i64>> buf;
  std::vector<u64> packed;
  for (i64 r0 = 0; r0 < rows; r0 += LANES) {
    i64 r1 = r0 + LANES < rows ? r0 + LANES : rows;
    i64 lo = offsets[r0], hi = offsets[r1];
    i64 len = hi - lo;
    if (len <= 0) continue;
    bool sorted = true;
    for (i64 k = 1; k < len; ++k)
      if (out_ck[lo + k] < out_ck[lo + k - 1]) { sorted = false; break; }
    if (sorted) {
      for (i64 k = 0; k < len; ++k) out_perm[lo + k] = lo + k;
      continue;
    }
    // pack (key, local index) into one u64 when it fits: sorting 8-byte
    // elements runs ~1.6x the 16-byte pair sort
    if (len < (i64)(1 << 20) &&
        *std::max_element(out_ck + lo, out_ck + hi) < (1ULL << 44)) {
      packed.resize((size_t)len);
      for (i64 k = 0; k < len; ++k)
        packed[(size_t)k] = (out_ck[lo + k] << 20) | (u64)k;
      std::sort(packed.begin(), packed.end());
      for (i64 k = 0; k < len; ++k) {
        u64 pk = packed[(size_t)k];
        out_perm[lo + k] = lo + (i64)(pk & ((1ULL << 20) - 1));
        out_ck[lo + k] = pk >> 20;
      }
    } else {
      buf.resize((size_t)len);
      for (i64 k = 0; k < len; ++k) buf[(size_t)k] = {out_ck[lo + k], lo + k};
      std::sort(buf.begin(), buf.end());
      for (i64 k = 0; k < len; ++k) {
        out_perm[lo + k] = buf[(size_t)k].second;
        out_ck[lo + k] = buf[(size_t)k].first;
      }
    }
  }
}

extern "C" i64 spmx_aligned_sort(i64 rows, i64 cols, const i64* offsets,
                                 const u32* indices, i64* out_perm, u64* out_ck) {
  const i64 LANES = 128;
  u64 wtot = (u64)(cols / LANES + 2);
  for (i64 i = 0; i < rows; ++i) {
    u64 rb = (u64)(i / LANES);
    i64 prev_w = -1;
    u64 layer = 0;
    for (i64 p = offsets[i]; p < offsets[i + 1]; ++p) {
      i64 w = (i64)indices[p] / LANES;
      layer = (w == prev_w) ? layer + 1 : 0;
      if (layer > 127) return -1;
      prev_w = w;
      out_ck[p] = ((rb * wtot + (u64)w) << 7) | layer;
    }
  }
  blockwise_key_sort(rows, offsets, out_perm, out_ck);
  return 0;
}

// LanePack-plan substrate (formats/lanepack.py). Chunk key =
// ((rb*wtot + w) << 7) | dst with w = col/(kw*128), dst = row % 128,
// wtot = cols/(kw*128) + 2 — the same lexicographic (rb, w, dst) order as
// the planner's np.lexsort((dst, w, rb)), stable within ties (same row,
// same window -> original column order), replacing the planner's global
// lexsort with blockwise cache-resident sorts.
extern "C" i64 spmx_lanepack_sort(i64 rows, i64 cols, i64 kw,
                                  const i64* offsets, const u32* indices,
                                  i64* out_perm, u64* out_ck) {
  const i64 LANES = 128;
  const i64 width = kw * LANES;
  u64 wtot = (u64)(cols / width + 2);
  for (i64 i = 0; i < rows; ++i) {
    u64 base = (u64)(i / LANES) * wtot;
    u64 dst = (u64)(i % LANES);
    for (i64 p = offsets[i]; p < offsets[i + 1]; ++p) {
      u64 w = (u64)indices[p] / (u64)width;
      out_ck[p] = ((base + w) << 7) | dst;
    }
  }
  blockwise_key_sort(rows, offsets, out_perm, out_ck);
  return 0;
}

// One-pass slab fill for the LanePack planner: walks entries in
// chunk-sorted order (perm), writing vals/lane at slot position k within
// the chunk and the segmented-reduce run boundaries ends/starts at the
// destination lane (run = maximal same-dst span within a chunk;
// starts[dst] = head position - 1, ends[dst] = tail position).
template <typename VIn, typename VOut>
static void lanepack_fill_impl(i64 nchunks, const i64* chunk_cnt,
                               const i64* chunk_slab, const i64* chunk_sub,
                               const i64* perm, const i64* row_of,
                               const u32* indices, const VIn* vals, i64 kw,
                               VOut* vals_s, short* lane_s,
                               signed char* ends_s, signed char* starts_s) {
  const i64 LANES = 128, SUB = 8;
  const i64 width = kw * LANES;
  i64 p = 0;
  for (i64 ci = 0; ci < nchunks; ++ci) {
    i64 base = (chunk_slab[ci] * SUB + chunk_sub[ci]) * LANES;
    i64 cnt = chunk_cnt[ci];
    i64 run_dst = -1;
    for (i64 k = 0; k < cnt; ++k, ++p) {
      i64 e = perm[p];
      i64 dst = row_of[e] % LANES;
      vals_s[base + k] = (VOut)vals[e];
      lane_s[base + k] = (short)(indices[e] % (u32)width);
      if (dst != run_dst) {
        if (run_dst >= 0) ends_s[base + run_dst] = (signed char)(k - 1);
        starts_s[base + dst] = (signed char)(k - 1);
        run_dst = dst;
      }
    }
    if (run_dst >= 0) ends_s[base + run_dst] = (signed char)(cnt - 1);
  }
}

extern "C" void spmx_lanepack_fill_f32f32(
    i64 nchunks, const i64* cnt, const i64* slab, const i64* sub,
    const i64* perm, const i64* row_of, const u32* indices, const float* vals,
    i64 kw, float* vals_s, short* lane_s, signed char* ends_s,
    signed char* starts_s) {
  lanepack_fill_impl<float, float>(nchunks, cnt, slab, sub, perm, row_of,
                                   indices, vals, kw, vals_s, lane_s, ends_s,
                                   starts_s);
}
extern "C" void spmx_lanepack_fill_f64f32(
    i64 nchunks, const i64* cnt, const i64* slab, const i64* sub,
    const i64* perm, const i64* row_of, const u32* indices, const double* vals,
    i64 kw, float* vals_s, short* lane_s, signed char* ends_s,
    signed char* starts_s) {
  lanepack_fill_impl<double, float>(nchunks, cnt, slab, sub, perm, row_of,
                                    indices, vals, kw, vals_s, lane_s, ends_s,
                                    starts_s);
}
extern "C" void spmx_lanepack_fill_f64f64(
    i64 nchunks, const i64* cnt, const i64* slab, const i64* sub,
    const i64* perm, const i64* row_of, const u32* indices, const double* vals,
    i64 kw, double* vals_s, short* lane_s, signed char* ends_s,
    signed char* starts_s) {
  lanepack_fill_impl<double, double>(nchunks, cnt, slab, sub, perm, row_of,
                                     indices, vals, kw, vals_s, lane_s, ends_s,
                                     starts_s);
}

// Call 2: scatter kept entries into the slab arrays (plan_aligned's
// vals_s/lane_s build). kept_idx lists original entry indices in
// chunk-sorted order; chunk_cnt[ci] entries belong to kept chunk ci,
// whose slot row is chunk_slab[ci]*8 + chunk_sub[ci]. The destination
// lane is row % 128, the stored lane byte is col % 128.
template <typename VIn, typename VOut>
static void aligned_fill_impl(i64 nchunks, const i64* chunk_cnt,
                              const i64* chunk_slab, const i64* chunk_sub,
                              const i64* kept_idx, const i64* row_of,
                              const u32* indices, const VIn* vals,
                              VOut* vals_s, signed char* lane_s) {
  const i64 LANES = 128, SUB = 8;
  i64 p = 0;
  for (i64 ci = 0; ci < nchunks; ++ci) {
    i64 base = (chunk_slab[ci] * SUB + chunk_sub[ci]) * LANES;
    for (i64 k = 0; k < chunk_cnt[ci]; ++k, ++p) {
      i64 e = kept_idx[p];
      i64 dst = row_of[e] % LANES;
      vals_s[base + dst] = (VOut)vals[e];
      lane_s[base + dst] = (signed char)(indices[e] % LANES);
    }
  }
}

extern "C" void spmx_aligned_fill_f32f32(i64 nchunks, const i64* cnt, const i64* slab,
                                         const i64* sub, const i64* kept, const i64* row_of,
                                         const u32* indices, const float* vals,
                                         float* vals_s, signed char* lane_s) {
  aligned_fill_impl<float, float>(nchunks, cnt, slab, sub, kept, row_of, indices, vals, vals_s, lane_s);
}
extern "C" void spmx_aligned_fill_f64f32(i64 nchunks, const i64* cnt, const i64* slab,
                                         const i64* sub, const i64* kept, const i64* row_of,
                                         const u32* indices, const double* vals,
                                         float* vals_s, signed char* lane_s) {
  aligned_fill_impl<double, float>(nchunks, cnt, slab, sub, kept, row_of, indices, vals, vals_s, lane_s);
}
extern "C" void spmx_aligned_fill_f64f64(i64 nchunks, const i64* cnt, const i64* slab,
                                         const i64* sub, const i64* kept, const i64* row_of,
                                         const u32* indices, const double* vals,
                                         double* vals_s, signed char* lane_s) {
  aligned_fill_impl<double, double>(nchunks, cnt, slab, sub, kept, row_of, indices, vals, vals_s, lane_s);
}

// Column-range partition of a row-sorted CSR into shards
// (ops/operator.py colsplit for operators over the plan-size limit): one counting
// pass + one scatter pass, replacing ~7 numpy full-nnz passes per shard.
// bounds has nsplit+1 ascending column cuts. Outputs are shard-major:
// out_offsets holds nsplit consecutive (rows+1) offset arrays;
// out_indices/out_vals hold each shard's entries in CSR order with
// columns rebased to the shard's lower bound. Scanning row-major keeps
// every shard's entries row-grouped and column-sorted by construction.
template <typename V>
static void colsplit_impl(i64 rows, i64 nsplit, const i64* bounds,
                          const i64* offsets, const u32* indices, const V* vals,
                          i64* out_offsets, u32* out_indices, V* out_vals) {
  std::vector<i64> cnt((size_t)nsplit, 0);
  for (i64 p = 0; p < offsets[rows]; ++p) {
    i64 c = (i64)indices[p];
    i64 s = 0, hi = nsplit - 1;
    while (s < hi) { i64 mid = (s + hi + 1) >> 1; if (bounds[mid] <= c) s = mid; else hi = mid - 1; }
    ++cnt[(size_t)s];
  }
  std::vector<i64> cur((size_t)nsplit, 0), base((size_t)nsplit, 0);
  for (i64 s = 1; s < nsplit; ++s) base[(size_t)s] = base[(size_t)s - 1] + cnt[(size_t)s - 1];
  for (i64 s = 0; s < nsplit; ++s) {
    cur[(size_t)s] = base[(size_t)s];
    out_offsets[s * (rows + 1)] = 0;
  }
  for (i64 i = 0; i < rows; ++i) {
    for (i64 p = offsets[i]; p < offsets[i + 1]; ++p) {
      i64 c = (i64)indices[p];
      i64 s = 0, hi = nsplit - 1;
      while (s < hi) { i64 mid = (s + hi + 1) >> 1; if (bounds[mid] <= c) s = mid; else hi = mid - 1; }
      i64 q = cur[(size_t)s]++;
      out_indices[q] = (u32)(c - bounds[s]);
      out_vals[q] = vals[p];
    }
    for (i64 s = 0; s < nsplit; ++s)
      out_offsets[s * (rows + 1) + i + 1] = cur[(size_t)s] - base[(size_t)s];
  }
}

extern "C" void spmx_colsplit_f32(i64 rows, i64 nsplit, const i64* bounds,
                                  const i64* offsets, const u32* indices, const float* vals,
                                  i64* out_offsets, u32* out_indices, float* out_vals) {
  colsplit_impl<float>(rows, nsplit, bounds, offsets, indices, vals, out_offsets, out_indices, out_vals);
}
extern "C" void spmx_colsplit_f64(i64 rows, i64 nsplit, const i64* bounds,
                                  const i64* offsets, const u32* indices, const double* vals,
                                  i64* out_offsets, u32* out_indices, double* out_vals) {
  colsplit_impl<double>(rows, nsplit, bounds, offsets, indices, vals, out_offsets, out_indices, out_vals);
}

// DIA accept-path build (formats/dia.py): one pass scattering entries to
// band storage, binary-searching the <=64 sorted band offsets. Replaces
// the numpy c-r temporary + searchsorted + fancy scatter (three full-nnz
// passes per accepted probe).
template <typename V>
static void dia_fill_impl(i64 rows, const i64* offsets, const u32* indices,
                          const V* vals, i64 nb, const i64* boffs, V* data) {
  for (i64 i = 0; i < rows; ++i) {
    for (i64 p = offsets[i]; p < offsets[i + 1]; ++p) {
      i64 o = (i64)indices[p] - i;
      i64 lo = 0, hi = nb - 1;
      while (lo < hi) {
        i64 mid = (lo + hi) >> 1;
        if (boffs[mid] < o) lo = mid + 1; else hi = mid;
      }
      data[lo * rows + i] = vals[p];
    }
  }
}

extern "C" void spmx_dia_fill_f32(i64 rows, const i64* offsets, const u32* indices,
                                  const float* vals, i64 nb, const i64* boffs, float* data) {
  dia_fill_impl<float>(rows, offsets, indices, vals, nb, boffs, data);
}
extern "C" void spmx_dia_fill_f64(i64 rows, const i64* offsets, const u32* indices,
                                  const double* vals, i64 nb, const i64* boffs, double* data) {
  dia_fill_impl<double>(rows, offsets, indices, vals, nb, boffs, data);
}

// Colmap SpGEMM: C = A @ T where T has AT MOST ONE entry per row — the
// degenerate mul_hash case (/root/reference/spam_csr/src/mul_hash.rs) that
// needs no hash table at all: C[i, tmap[j]] += A[i,j] * tval[j], i.e. a
// column relabel + per-row duplicate merge. This is exactly the AMG
// prolongator-smoothing product (S @ T with T the tentative prolongator),
// which on a 2048^2 Poisson setup was the single largest hash-SpGEMM call.
// tmap[j] = 0xFFFFFFFF marks an empty T row (entry dropped). Rows of A must
// be short enough that an insertion-grade std::sort is cheap (always true
// for the mesh/aggregation matrices this serves). Computed zeros are KEPT,
// matching the hash engine's semantics. out_* are sized nnz(A) (upper
// bound); returns the exact output nnz, fills out_offsets[0..rows].
template <typename V>
static i64 colmap_spgemm_impl(i64 rows, const i64* offsets, const u32* indices,
                              const V* vals, const u32* tmap, const V* tval,
                              i64* out_offsets, u32* out_indices, V* out_vals) {
  std::vector<std::pair<u32, V>> buf;
  i64 w = 0;
  out_offsets[0] = 0;
  for (i64 r = 0; r < rows; ++r) {
    buf.clear();
    bool sorted = true;
    for (i64 p = offsets[r]; p < offsets[r + 1]; ++p) {
      u32 j = indices[p];
      u32 c = tmap[j];
      if (c == 0xFFFFFFFFu) continue;
      if (!buf.empty() && c < buf.back().first) sorted = false;
      buf.push_back({c, vals[p] * tval[j]});
    }
    // rows are short (mesh/aggregation matrices) and usually already
    // sorted after the relabel (aggregate ids grow with fine index):
    // insertion sort beats a std::sort call per row ~2x at 21M nnz
    if (!sorted) {
      for (size_t k = 1; k < buf.size(); ++k) {
        std::pair<u32, V> key = buf[k];
        size_t j2 = k;
        for (; j2 > 0 && buf[j2 - 1].first > key.first; --j2) buf[j2] = buf[j2 - 1];
        buf[j2] = key;
      }
    }
    for (size_t k = 0; k < buf.size();) {
      u32 c = buf[k].first;
      V acc = buf[k].second;
      for (++k; k < buf.size() && buf[k].first == c; ++k) acc += buf[k].second;
      out_indices[w] = c;
      out_vals[w] = acc;
      ++w;
    }
    out_offsets[r + 1] = w;
  }
  return w;
}

// Fused prolongator smoothing: P = (I - diag(ws) A) @ T in ONE pass over
// A, where T (tentative) has at most one entry per row (tmap/tval form,
// 0xFFFFFFFF = empty). Per A entry (r, j, a): term value
// (V)((r==j) - a*ws[r]) * tval[j] — identical per-term rounding to the
// materialize-S-then-colmap pipeline it replaces (S's write+read of
// nnz(A) values and the smoother sweep were ~1.3 s of the 2048^2 AMG
// setup). Rows of A lacking an explicit diagonal get the identity's
// T-row injected as an extra term (the unfused path could not reuse A's
// pattern there at all and fell back to a union-merge subtraction).
template <typename V>
static i64 colmap_smoothed_impl(i64 rows, const i64* offsets,
                                const u32* indices, const V* vals,
                                const double* ws, const u32* tmap,
                                const V* tval, i64* out_offsets,
                                u32* out_indices, V* out_vals) {
  std::vector<std::pair<u32, V>> buf;
  i64 w = 0;
  out_offsets[0] = 0;
  for (i64 r = 0; r < rows; ++r) {
    buf.clear();
    bool sorted = true, saw_diag = false;
    double wr = ws[r];
    for (i64 p = offsets[r]; p < offsets[r + 1]; ++p) {
      u32 j = indices[p];
      u32 c = tmap[j];
      double base = -(double)vals[p] * wr;
      if ((i64)j == r) { base += 1.0; saw_diag = true; }
      if (c == 0xFFFFFFFFu) continue;
      if (!buf.empty() && c < buf.back().first) sorted = false;
      buf.push_back({c, (V)base * tval[j]});
    }
    if (!saw_diag) {  // identity column r (caller guarantees square A)
      u32 c = tmap[r];
      if (c != 0xFFFFFFFFu) {
        if (!buf.empty() && c < buf.back().first) sorted = false;
        buf.push_back({c, tval[r]});
      }
    }
    if (!sorted) {
      for (size_t k = 1; k < buf.size(); ++k) {
        std::pair<u32, V> key = buf[k];
        size_t j2 = k;
        for (; j2 > 0 && buf[j2 - 1].first > key.first; --j2) buf[j2] = buf[j2 - 1];
        buf[j2] = key;
      }
    }
    for (size_t k = 0; k < buf.size();) {
      u32 c = buf[k].first;
      V acc = buf[k].second;
      for (++k; k < buf.size() && buf[k].first == c; ++k) acc += buf[k].second;
      out_indices[w] = c;
      out_vals[w] = acc;
      ++w;
    }
    out_offsets[r + 1] = w;
  }
  return w;
}

extern "C" i64 spmx_colmap_smoothed_f32(i64 rows, const i64* offsets,
                                        const u32* indices, const float* vals,
                                        const double* ws, const u32* tmap,
                                        const float* tval, i64* out_offsets,
                                        u32* out_indices, float* out_vals) {
  return colmap_smoothed_impl<float>(rows, offsets, indices, vals, ws, tmap,
                                     tval, out_offsets, out_indices, out_vals);
}
extern "C" i64 spmx_colmap_smoothed_f64(i64 rows, const i64* offsets,
                                        const u32* indices, const double* vals,
                                        const double* ws, const u32* tmap,
                                        const double* tval, i64* out_offsets,
                                        u32* out_indices, double* out_vals) {
  return colmap_smoothed_impl<double>(rows, offsets, indices, vals, ws, tmap,
                                      tval, out_offsets, out_indices, out_vals);
}

extern "C" i64 spmx_colmap_spgemm_f32(i64 rows, const i64* offsets,
                                      const u32* indices, const float* vals,
                                      const u32* tmap, const float* tval,
                                      i64* out_offsets, u32* out_indices,
                                      float* out_vals) {
  return colmap_spgemm_impl<float>(rows, offsets, indices, vals, tmap, tval,
                                   out_offsets, out_indices, out_vals);
}
extern "C" i64 spmx_colmap_spgemm_f64(i64 rows, const i64* offsets,
                                      const u32* indices, const double* vals,
                                      const u32* tmap, const double* tval,
                                      i64* out_offsets, u32* out_indices,
                                      double* out_vals) {
  return colmap_spgemm_impl<double>(rows, offsets, indices, vals, tmap, tval,
                                    out_offsets, out_indices, out_vals);
}

// ---------------------------------------------------------------------------
// Sparse Cholesky (simplicial, up-looking — the CSparse cs_chol family;
// solvers/cholesky.py). EXACT A = L L^T with fill, unlike IC(0)/ILUT.
// Sequential along the elimination-tree dependency chain — native-runtime
// work, same host-does-the-irregular-part stance as the reference's
// mul_hash (/root/reference/spam_csr/src/mul_hash.rs:13-36).
//
// Input: the full SYMMETRIC matrix as a sorted CSR (rows supply the lower
// part A[k, 0:k] directly). Output: L by COLUMNS, diagonal first — which
// is exactly the CSR of U = L^T with sorted rows.
// ---------------------------------------------------------------------------

// Elimination tree via Liu's algorithm with path compression.
extern "C" void spmx_etree(i64 n, const i64* offsets, const u32* indices,
                           i64* parent /* n, out */) {
  std::vector<i64> ancestor((size_t)n, -1);
  for (i64 k = 0; k < n; ++k) {
    parent[k] = -1;
    for (i64 p = offsets[k]; p < offsets[k + 1]; ++p) {
      i64 i = (i64)indices[p];
      if (i >= k) break;  // sorted row: lower part first
      while (i != -1 && i != k) {
        i64 nxt = ancestor[(size_t)i];
        ancestor[(size_t)i] = k;  // path compression
        if (nxt == -1) { parent[i] = k; break; }
        i = nxt;
      }
    }
  }
}

// Row-k reach in the etree (pattern of L(k, 0:k)), ascending order.
// w: workspace (n) holding the visit stamp; s: output stack (n).
static i64 chol_ereach(i64 k, const i64* offsets, const u32* indices,
                       const i64* parent, i64* w, i64* s, i64 n) {
  i64 top = n;
  w[k] = k;  // mark k visited
  for (i64 p = offsets[k]; p < offsets[k + 1]; ++p) {
    i64 i = (i64)indices[p];
    if (i >= k) break;
    i64 len = 0;
    for (; w[i] != k; i = parent[i]) {  // walk up to a visited node
      s[len++] = i;
      w[i] = k;
    }
    while (len > 0) s[--top] = s[--len];  // reverse onto the stack
  }
  return top;  // s[top..n) = pattern, ascending etree (hence column) order
}

// Symbolic phase: per-COLUMN nonzero counts of L (incl. diagonal).
// Returns nnz(L), or -1 on overflow.
extern "C" i64 spmx_chol_symbolic(i64 n, const i64* offsets, const u32* indices,
                                  const i64* parent, i64* colcount /* n, out */) {
  std::vector<i64> w((size_t)n, -1), s((size_t)n);
  for (i64 i = 0; i < n; ++i) colcount[i] = 1;  // diagonal
  for (i64 k = 0; k < n; ++k) {
    i64 top = chol_ereach(k, offsets, indices, parent, w.data(), s.data(), n);
    for (; top < n; ++top) ++colcount[s[(size_t)top]];
  }
  i64 nnz = 0;
  for (i64 i = 0; i < n; ++i) nnz += colcount[i];
  return nnz;
}

// Numeric phase (f64). lp: column pointers of L (prefix of colcount,
// n+1); li/lx: output (nnz). Returns -1 on success or the first column
// with a non-positive pivot (input not SPD).
extern "C" i64 spmx_chol_numeric(i64 n, const i64* offsets, const u32* indices,
                                 const double* vals, const i64* parent,
                                 const i64* lp, i64* li, double* lx) {
  std::vector<i64> w((size_t)n, -1), s((size_t)n), c((size_t)n);
  std::vector<double> x((size_t)n, 0.0);
  for (i64 i = 0; i < n; ++i) c[(size_t)i] = lp[i];
  for (i64 k = 0; k < n; ++k) {
    i64 top = chol_ereach(k, offsets, indices, parent, w.data(), s.data(), n);
    double d = 0.0;
    for (i64 p = offsets[k]; p < offsets[k + 1]; ++p) {
      i64 j = (i64)indices[p];
      if (j > k) break;
      if (j == k) d = vals[p];
      else x[(size_t)j] = vals[p];
    }
    for (; top < n; ++top) {
      i64 i = s[(size_t)top];          // pattern entry, ascending
      double lki = x[(size_t)i] / lx[lp[i]];  // L(i,i) is column i's head
      x[(size_t)i] = 0.0;
      for (i64 p = lp[i] + 1; p < c[(size_t)i]; ++p)
        x[(size_t)li[p]] -= lx[p] * lki;
      d -= lki * lki;
      i64 q = c[(size_t)i]++;
      li[q] = k;
      lx[q] = lki;  // L(k,i) appended to column i (rows ascending)
    }
    if (d <= 0.0) return k;
    i64 q = c[(size_t)k]++;
    li[q] = k;
    lx[q] = std::sqrt(d);  // diagonal first in column k
  }
  return -1;
}

// LDL^T variant (Davis's LDL algorithm): same etree/symbolic phases as
// Cholesky, no square roots — factors symmetric INDEFINITE matrices
// (no pivoting: caller documents the quasi-definite caveat). L is UNIT
// lower by columns (diagonal NOT stored; lp counts exclude it), D
// separate. Returns -1 or the first column with d == 0.
extern "C" i64 spmx_ldl_numeric(i64 n, const i64* offsets, const u32* indices,
                                const double* vals, const i64* parent,
                                const i64* lp, i64* li, double* lx,
                                double* d /* n, out */) {
  std::vector<i64> w((size_t)n, -1), s((size_t)n), c((size_t)n);
  std::vector<double> y((size_t)n, 0.0);
  for (i64 i = 0; i < n; ++i) c[(size_t)i] = lp[i];
  for (i64 k = 0; k < n; ++k) {
    i64 top = chol_ereach(k, offsets, indices, parent, w.data(), s.data(), n);
    d[k] = 0.0;
    for (i64 p = offsets[k]; p < offsets[k + 1]; ++p) {
      i64 j = (i64)indices[p];
      if (j > k) break;
      if (j == k) d[k] = vals[p];
      else y[(size_t)j] = vals[p];
    }
    for (; top < n; ++top) {
      i64 i = s[(size_t)top];
      double yi = y[(size_t)i];
      y[(size_t)i] = 0.0;
      double lki = yi / d[i];
      for (i64 p = lp[i]; p < c[(size_t)i]; ++p)
        y[(size_t)li[p]] -= lx[p] * yi;
      d[k] -= lki * yi;
      i64 q = c[(size_t)i]++;
      li[q] = k;
      lx[q] = lki;
    }
    if (d[k] == 0.0) return k;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// Sparse LU with partial pivoting (left-looking Gilbert-Peierls — the
// CSparse cs_lu family; solvers/cholesky.py::lu). Input is the matrix by
// COLUMNS (CSC = CSR of A^T); outputs L (unit diagonal stored) and U by
// columns plus the row-pivot map pinv (original row -> pivot position).
// Fill is pivot-dependent, so the caller passes capacities and retries
// on -2 (capacity exceeded); a structurally/numerically singular column
// k returns -(k+3).
// ---------------------------------------------------------------------------

// DFS from column-j start nodes over the graph of finished L columns;
// emits the reach in topological order at xi[top..n). w: visit stamps.
static i64 lu_reach(i64 n, const i64* bp, const i64* bi, i64 j,
                    const i64* lp, const i64* li, const i64* lnzc,
                    const i64* pinv, i64* w, i64 stamp, i64* xi, i64* pstack) {
  i64 top = n;
  for (i64 p = bp[j]; p < bp[j + 1]; ++p) {
    i64 i = bi[p];
    if (w[i] == stamp) continue;
    // iterative DFS
    i64 head = 0;
    xi[0] = i;
    while (head >= 0) {
      i64 node = xi[head];
      i64 jj = pinv[node];  // finished column this row pivots, or -1
      if (w[node] != stamp) {
        w[node] = stamp;
        pstack[head] = (jj < 0) ? 0 : lp[jj];
      }
      bool done = true;
      if (jj >= 0) {
        i64 pend = lnzc[jj];
        i64 q = pstack[head];
        for (; q < pend; ++q) {
          i64 nxt = li[q];
          if (w[nxt] != stamp) {
            pstack[head] = q + 1;
            xi[++head] = nxt;
            done = false;
            break;
          }
        }
      }
      if (done) {
        --head;
        xi[--top] = node;
      }
    }
  }
  return top;
}

extern "C" i64 spmx_lu(i64 n, const i64* bp, const i64* bi, const double* bx,
                       i64 cap_l, i64 cap_u, i64* lp, i64* li, double* lx,
                       i64* up, i64* ui, double* ux, i64* pinv,
                       i64* out_sizes /* 2: lnz, unz */) {
  std::vector<i64> w((size_t)n, -1), xi((size_t)n), pstack((size_t)n);
  std::vector<i64> lnzc((size_t)n, 0);  // per-column L end (reach needs it)
  std::vector<double> x((size_t)n, 0.0);
  for (i64 i = 0; i < n; ++i) pinv[i] = -1;
  i64 lnz = 0, unz = 0;
  for (i64 k = 0; k < n; ++k) {
    lp[k] = lnz;
    up[k] = unz;
    i64 top = lu_reach(n, bp, bi, k, lp, li, lnzc.data(), pinv, w.data(), k,
                       xi.data(), pstack.data());
    // numeric sparse solve x = L \ B(:,k) in topological order
    for (i64 p = bp[k]; p < bp[k + 1]; ++p) x[bi[p]] = bx[p];
    for (i64 t = top; t < n; ++t) {
      i64 i = xi[(size_t)t];
      i64 jj = pinv[i];
      if (jj < 0) continue;
      double xv = x[(size_t)i];
      if (xv == 0.0) continue;
      for (i64 p = lp[jj] + 1; p < lnzc[(size_t)jj]; ++p)
        x[(size_t)li[p]] -= lx[p] * xv;
    }
    // pivot: largest |x| among not-yet-pivotal rows
    double amax = -1.0;
    i64 ipiv = -1;
    i64 n_l = 0;
    for (i64 t = top; t < n; ++t) {
      i64 i = xi[(size_t)t];
      if (pinv[i] < 0) {
        ++n_l;
        double v = std::fabs(x[(size_t)i]);
        if (v > amax) { amax = v; ipiv = i; }
      }
    }
    if (ipiv < 0 || amax <= 0.0) {
      for (i64 t = top; t < n; ++t) x[(size_t)xi[(size_t)t]] = 0.0;
      return -(k + 3);  // singular
    }
    if (unz + (n - top) + 1 > cap_u || lnz + n_l + 1 > cap_l) return -2;
    double pivot = x[(size_t)ipiv];
    pinv[ipiv] = k;
    // U(:,k): rows already pivotal (by pivot position), then the diagonal
    for (i64 t = top; t < n; ++t) {
      i64 i = xi[(size_t)t];
      if (pinv[i] >= 0 && i != ipiv) {
        ui[unz] = pinv[i];
        ux[unz++] = x[(size_t)i];
      }
    }
    ui[unz] = k;
    ux[unz++] = pivot;
    // L(:,k): unit diagonal first, then non-pivotal rows scaled
    li[lnz] = ipiv;  // original-row index for now; remapped at the end
    lx[lnz++] = 1.0;
    for (i64 t = top; t < n; ++t) {
      i64 i = xi[(size_t)t];
      if (pinv[i] < 0) {
        li[lnz] = i;
        lx[lnz++] = x[(size_t)i] / pivot;
      }
      x[(size_t)i] = 0.0;
    }
    lnzc[(size_t)k] = lnz;
  }
  lp[n] = lnz;
  up[n] = unz;
  // remap L's row indices from original rows to pivot positions: rows
  // still unpivoted cannot remain (every row pivots exactly once)
  for (i64 p = 0; p < lnz; ++p) li[p] = pinv[li[p]];
  out_sizes[0] = lnz;
  out_sizes[1] = unz;
  return 0;
}

// ---------------------------------------------------------------------------
// Graph algorithms on CSR adjacency (sparse_matrix_tpu/graph/).
// The irregular, pointer-chasing parts of the csgraph surface run in the
// native runtime — the same stance as factorization and aggregation (the
// reference keeps its irregular kernels on the host too,
// spam_csr/src/mul_hash.rs): the host does the sequential-irregular work,
// the device does the regular relaxations (graph/device.py min-plus
// Bellman-Ford).
// ---------------------------------------------------------------------------

namespace spmx_graph {

struct UnionFind {
  std::vector<i64> parent;
  explicit UnionFind(i64 n) : parent((size_t)n) {
    for (i64 i = 0; i < n; ++i) parent[(size_t)i] = i;
  }
  i64 find(i64 x) {
    while (parent[(size_t)x] != x) {
      parent[(size_t)x] = parent[(size_t)parent[(size_t)x]];
      x = parent[(size_t)x];
    }
    return x;
  }
  bool unite(i64 a, i64 b) {
    a = find(a);
    b = find(b);
    if (a == b) return false;
    parent[(size_t)b] = a;
    return true;
  }
};

}  // namespace spmx_graph

// Weak connectivity: every edge treated as undirected, so the caller can
// pass a one-directional CSR pattern unsymmetrized. labels[i] = component
// id, numbered by first row occurrence. Returns the component count.
extern "C" i64 spmx_connected_components(i64 n, const i64* offsets,
                                         const u32* indices, i64* labels) {
  spmx_graph::UnionFind uf(n);
  for (i64 i = 0; i < n; ++i)
    for (i64 t = offsets[i]; t < offsets[i + 1]; ++t)
      uf.unite(i, (i64)indices[t]);
  i64 nc = 0;
  std::vector<i64> remap((size_t)n, -1);
  for (i64 i = 0; i < n; ++i) {
    i64 r = uf.find(i);
    if (remap[(size_t)r] < 0) remap[(size_t)r] = nc++;
    labels[i] = remap[(size_t)r];
  }
  return nc;
}

// Strongly connected components: iterative Tarjan (explicit vertex+edge
// stacks — recursion would overflow on path graphs). Labels renumbered by
// first row occurrence. Returns the component count.
extern "C" i64 spmx_scc(i64 n, const i64* offsets, const u32* indices,
                        i64* labels) {
  std::vector<i64> low((size_t)n, -1), disc((size_t)n, -1);
  std::vector<i64> stk;
  stk.reserve((size_t)n);
  std::vector<char> onstk((size_t)n, 0);
  std::vector<i64> callv, calle;
  i64 timer = 0, nc = 0;
  for (i64 s = 0; s < n; ++s) {
    if (disc[(size_t)s] >= 0) continue;
    callv.assign(1, s);
    calle.assign(1, offsets[s]);
    disc[(size_t)s] = low[(size_t)s] = timer++;
    stk.push_back(s);
    onstk[(size_t)s] = 1;
    while (!callv.empty()) {
      i64 v = callv.back();
      i64& e = calle.back();
      if (e < offsets[v + 1]) {
        i64 w = (i64)indices[e++];
        if (disc[(size_t)w] < 0) {
          disc[(size_t)w] = low[(size_t)w] = timer++;
          stk.push_back(w);
          onstk[(size_t)w] = 1;
          callv.push_back(w);
          calle.push_back(offsets[w]);
        } else if (onstk[(size_t)w] && disc[(size_t)w] < low[(size_t)v]) {
          low[(size_t)v] = disc[(size_t)w];
        }
      } else {
        callv.pop_back();
        calle.pop_back();
        if (low[(size_t)v] == disc[(size_t)v]) {
          while (true) {
            i64 w = stk.back();
            stk.pop_back();
            onstk[(size_t)w] = 0;
            labels[w] = nc;
            if (w == v) break;
          }
          ++nc;
        }
        if (!callv.empty()) {
          i64 p = callv.back();
          if (low[(size_t)v] < low[(size_t)p]) low[(size_t)p] = low[(size_t)v];
        }
      }
    }
  }
  std::vector<i64> remap((size_t)nc, -1);
  i64 k = 0;
  for (i64 i = 0; i < n; ++i) {
    if (remap[(size_t)labels[i]] < 0) remap[(size_t)labels[i]] = k++;
    labels[i] = remap[(size_t)labels[i]];
  }
  return nc;
}

// Single-source Dijkstra, binary heap over (dist, node). Lazy deletion:
// stale heap entries are skipped by the d > dist[v] test. Negative weights
// are the caller's contract violation (graph/csgraph.py routes those to
// Bellman-Ford). dist must arrive +inf-filled, pred -1-filled;
// dist[source] is set here.
extern "C" void spmx_dijkstra(i64 n, const i64* offsets, const u32* indices,
                              const double* vals, i64 source, double* dist,
                              i64* pred) {
  (void)n;
  typedef std::pair<double, i64> QE;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
  dist[source] = 0.0;
  pq.push(QE(0.0, source));
  while (!pq.empty()) {
    QE top = pq.top();
    pq.pop();
    double d = top.first;
    i64 v = top.second;
    if (d > dist[v]) continue;
    for (i64 t = offsets[v]; t < offsets[v + 1]; ++t) {
      i64 w = (i64)indices[t];
      double nd = d + vals[t];
      if (nd < dist[w]) {
        dist[w] = nd;
        pred[w] = v;
        pq.push(QE(nd, w));
      }
    }
  }
}

// BFS visitation order from source. order[] receives the visited nodes in
// BFS order (order doubles as the queue), pred[child] = parent. Returns
// the visited count. pred must arrive -1-filled.
extern "C" i64 spmx_bfs_order(i64 n, const i64* offsets, const u32* indices,
                              i64 source, i64* order, i64* pred) {
  std::vector<char> vis((size_t)n, 0);
  i64 head = 0, tail = 0;
  order[tail++] = source;
  vis[(size_t)source] = 1;
  while (head < tail) {
    i64 v = order[head++];
    for (i64 t = offsets[v]; t < offsets[v + 1]; ++t) {
      i64 w = (i64)indices[t];
      if (!vis[(size_t)w]) {
        vis[(size_t)w] = 1;
        pred[w] = v;
        order[tail++] = w;
      }
    }
  }
  return tail;
}

// DFS preorder from source, neighbors explored in CSR (ascending column)
// order via an explicit (vertex, edge-cursor) stack. Returns the visited
// count. pred must arrive -1-filled.
extern "C" i64 spmx_dfs_order(i64 n, const i64* offsets, const u32* indices,
                              i64 source, i64* order, i64* pred) {
  std::vector<char> vis((size_t)n, 0);
  std::vector<i64> sv, se;
  sv.reserve(64);
  se.reserve(64);
  i64 cnt = 0;
  vis[(size_t)source] = 1;
  order[cnt++] = source;
  sv.push_back(source);
  se.push_back(offsets[source]);
  while (!sv.empty()) {
    i64 v = sv.back();
    i64& e = se.back();
    if (e < offsets[v + 1]) {
      i64 w = (i64)indices[e++];
      if (!vis[(size_t)w]) {
        vis[(size_t)w] = 1;
        pred[w] = v;
        order[cnt++] = w;
        sv.push_back(w);
        se.push_back(offsets[w]);
      }
    } else {
      sv.pop_back();
      se.pop_back();
    }
  }
  return cnt;
}

// Kruskal accept loop. The caller extracts + sorts the undirected edge
// list (vectorized numpy work); only the inherently sequential union-find
// scan runs here. order[k] indexes ei/ej in ascending-weight order;
// keep[t] is set 1 for accepted edges. Returns the accepted count.
extern "C" i64 spmx_kruskal(i64 n, i64 ne, const i64* ei, const i64* ej,
                            const i64* order, i64* keep) {
  spmx_graph::UnionFind uf(n);
  i64 kept = 0;
  for (i64 k = 0; k < ne; ++k) {
    i64 t = order[k];
    i64 ok = uf.unite(ei[t], ej[t]) ? 1 : 0;
    keep[t] = ok;
    kept += ok;
  }
  return kept;
}

// Hopcroft-Karp maximum bipartite matching on the rows->cols CSR pattern.
// match_row[i] = matched column (-1 unmatched), match_col[j] = matched row.
// Returns the matching size (= structural rank of the matrix). Layered BFS
// + DFS augmentation, O(E sqrt(V)).
extern "C" i64 spmx_hopcroft_karp(i64 rows, i64 cols, const i64* offsets,
                                  const u32* indices, i64* match_row,
                                  i64* match_col) {
  const i64 INF = (i64)1 << 62;
  for (i64 i = 0; i < rows; ++i) match_row[i] = -1;
  for (i64 j = 0; j < cols; ++j) match_col[j] = -1;
  std::vector<i64> dist((size_t)rows);
  std::vector<i64> q((size_t)rows);
  // iterative DFS stacks (explicit — recursion overflows on long chains)
  std::vector<i64> sv, se;
  i64 matched = 0;
  while (true) {
    // BFS layers from unmatched rows
    i64 head = 0, tail = 0;
    for (i64 i = 0; i < rows; ++i) {
      if (match_row[i] < 0) {
        dist[(size_t)i] = 0;
        q[tail++] = i;
      } else {
        dist[(size_t)i] = INF;
      }
    }
    bool found_free = false;
    while (head < tail) {
      i64 v = q[head++];
      for (i64 t = offsets[v]; t < offsets[v + 1]; ++t) {
        i64 w = match_col[(i64)indices[t]];
        if (w < 0) {
          found_free = true;
        } else if (dist[(size_t)w] == INF) {
          dist[(size_t)w] = dist[(size_t)v] + 1;
          q[tail++] = w;
        }
      }
    }
    if (!found_free) break;
    // DFS augmentation along layered edges
    for (i64 s = 0; s < rows; ++s) {
      if (match_row[s] >= 0) continue;
      sv.assign(1, s);
      se.assign(1, offsets[s]);
      bool augmented = false;
      while (!sv.empty()) {
        i64 v = sv.back();
        i64& e = se.back();
        if (e < offsets[v + 1]) {
          i64 j = (i64)indices[e++];
          i64 w = match_col[j];
          if (w < 0) {
            // free column: flip the path recorded on the stack
            match_col[j] = v;
            i64 carry = j;
            for (i64 k = (i64)sv.size() - 1; k >= 0; --k) {
              i64 rv = sv[(size_t)k];
              i64 prev = match_row[rv];
              match_row[rv] = carry;
              if (k > 0) {
                // the column that led INTO rv is prev's slot via the
                // parent row's edge; recover it from match_col updates:
                // parent row's new column is the one that matched rv
                carry = prev;
                match_col[prev] = sv[(size_t)k - 1];
              }
            }
            augmented = true;
            break;
          }
          if (dist[(size_t)w] == dist[(size_t)v] + 1) {
            sv.push_back(w);
            se.push_back(offsets[w]);
          }
        } else {
          dist[(size_t)v] = INF;  // dead end: prune for this phase
          sv.pop_back();
          se.pop_back();
        }
      }
      if (augmented) ++matched;
    }
  }
  return matched;
}

// Dinic maximum flow on integer capacities (graph/csgraph.py
// maximum_flow). Edge list arrives as (eu, ev, cap); each gets a paired
// reverse edge (xor-pairing: edge 2k <-> 2k+1). Returns the max flow;
// flow_out[k] = flow pushed on input edge k (cap - residual).
extern "C" i64 spmx_maxflow(i64 n, i64 ne, const i64* eu, const i64* ev,
                            const i64* cap, i64 source, i64 sink,
                            i64* flow_out) {
  std::vector<i64> head((size_t)n + 1, 0), to((size_t)2 * ne),
      res((size_t)2 * ne), eid((size_t)2 * ne);
  // counting sort edges (forward + reverse) by tail for CSR adjacency
  for (i64 k = 0; k < ne; ++k) {
    ++head[(size_t)eu[k] + 1];
    ++head[(size_t)ev[k] + 1];
  }
  for (i64 v = 0; v < n; ++v) head[(size_t)v + 1] += head[(size_t)v];
  std::vector<i64> pos(head.begin(), head.end() - 1);
  std::vector<i64> pair_of((size_t)2 * ne);
  for (i64 k = 0; k < ne; ++k) {
    i64 f = pos[(size_t)eu[k]]++;
    i64 b = pos[(size_t)ev[k]]++;
    to[(size_t)f] = ev[k];
    res[(size_t)f] = cap[k];
    eid[(size_t)f] = k;
    to[(size_t)b] = eu[k];
    res[(size_t)b] = 0;
    eid[(size_t)b] = ~k;  // reverse marker
    pair_of[(size_t)f] = b;
    pair_of[(size_t)b] = f;
  }
  std::vector<i64> level((size_t)n), it((size_t)n), q((size_t)n);
  std::vector<i64> sv, se;  // iterative DFS for the blocking flow
  const i64 INF = (i64)1 << 62;
  i64 total = 0;
  while (true) {
    // BFS level graph
    std::fill(level.begin(), level.end(), (i64)-1);
    i64 h = 0, t = 0;
    q[t++] = source;
    level[(size_t)source] = 0;
    while (h < t) {
      i64 v = q[h++];
      for (i64 e = head[(size_t)v]; e < head[(size_t)v + 1]; ++e)
        if (res[(size_t)e] > 0 && level[(size_t)to[(size_t)e]] < 0) {
          level[(size_t)to[(size_t)e]] = level[(size_t)v] + 1;
          q[t++] = to[(size_t)e];
        }
    }
    if (level[(size_t)sink] < 0) break;
    for (i64 v = 0; v < n; ++v) it[(size_t)v] = head[(size_t)v];
    // blocking flow: repeated iterative DFS source->sink
    while (true) {
      sv.assign(1, source);
      se.clear();
      bool reached = false;
      while (!sv.empty()) {
        i64 v = sv.back();
        if (v == sink) {
          reached = true;
          break;
        }
        bool advanced = false;
        for (i64& e = it[(size_t)v]; e < head[(size_t)v + 1]; ++e) {
          i64 w = to[(size_t)e];
          if (res[(size_t)e] > 0 && level[(size_t)w] == level[(size_t)v] + 1) {
            sv.push_back(w);
            se.push_back(e);
            advanced = true;
            break;
          }
        }
        if (!advanced) {
          level[(size_t)v] = -1;  // dead end: prune from this phase
          sv.pop_back();
          if (!se.empty()) se.pop_back();
        }
      }
      if (!reached) break;
      i64 aug = INF;
      for (i64 e : se) aug = std::min(aug, res[(size_t)e]);
      for (i64 e : se) {
        res[(size_t)e] -= aug;
        res[(size_t)pair_of[(size_t)e]] += aug;
      }
      total += aug;
    }
  }
  for (i64 e = 0; e < 2 * ne; ++e)
    if (eid[(size_t)e] >= 0) flow_out[eid[(size_t)e]] = cap[eid[(size_t)e]] - res[(size_t)e];
  return total;
}

// ---------------------------------------------------------------------------
// FixedSideSpgemm plan (ops/spgemm_spmv.py): fused expand + group-by-key.
//
// The Python plan enumerated all intermediate products (expand_plan,
// ops/device_sorted.py) and lexsorted the global (out_row*cols + out_col,
// sub_order) keys — two full passes over num_products int64 temporaries
// (23 s of a Poisson-1024^2 AmgRefresh plan). This pass exploits two
// structural facts instead:
//   * products enumerate in lhs row-major order, so out_row is already
//     sorted — only WITHIN-row grouping by out_col is needed;
//   * within one output (r, c) the varying-side position ascends in
//     enumeration order (equal c across distinct k, k ascending; rhs-row
//     position ranges ascend with k), so a per-row STABLE sort by c alone
//     reproduces the (key, sub_order) lexsort exactly.
//
// Outputs, all length num_products (= sum over lhs entries of the rhs row
// nnz, computed by the caller): s_idx = selection-matrix column (varying
// side's CSR position), s_val = fixed side's value, col_sorted = output
// column per product, head = 1 at each group (output entry) start.
// Returns the number of groups (output nnz). Reference anchor: replaces
// the symbolic phase's hash-route decision (mul_hash.rs:106-143) with a
// sort, once, at plan time.
extern "C" i64 spmx_fixedside_plan(
    i64 lhs_rows,
    const i64* lhs_offsets, const u32* lhs_indices, const float* lhs_vals,
    const i64* rhs_offsets, const u32* rhs_indices, const float* rhs_vals,
    int fixed_lhs,
    u32* s_idx, float* s_val, int32_t* out_row, int32_t* out_col,
    i64* out_off) {
  // also emits the grouped output pattern directly (out_row/out_col per
  // distinct (row, col) product group, CSR offsets into the product
  // stream): the numpy post-pass (flatnonzero + searchsorted over
  // num_products) was ~40% of the host FixedSideSpgemm plan
  struct Prod {
    u32 col;
    int32_t idx;
    float w;
  };
  std::vector<Prod> buf;
  i64 p = 0;
  i64 groups = 0;
  for (i64 r = 0; r < lhs_rows; ++r) {
    buf.clear();
    for (i64 e = lhs_offsets[r]; e < lhs_offsets[r + 1]; ++e) {
      u32 k = lhs_indices[e];
      for (i64 q = rhs_offsets[k]; q < rhs_offsets[k + 1]; ++q) {
        Prod t;
        t.col = rhs_indices[q];
        if (fixed_lhs) {
          t.idx = (int32_t)q;
          t.w = lhs_vals[e];
        } else {
          t.idx = (int32_t)e;
          t.w = rhs_vals[q];
        }
        buf.push_back(t);
      }
    }
    std::stable_sort(buf.begin(), buf.end(),
                     [](const Prod& a, const Prod& b) { return a.col < b.col; });
    u32 prev = kEmpty;
    bool first = true;
    for (const Prod& t : buf) {
      if (first || t.col != prev) {
        out_row[groups] = (int32_t)r;
        out_col[groups] = (int32_t)t.col;
        out_off[groups] = p;
        ++groups;
      }
      s_idx[p] = (u32)t.idx;
      s_val[p] = t.w;
      prev = t.col;
      first = false;
      ++p;
    }
  }
  out_off[groups] = p;
  return groups;
}

// ---------------------------------------------------------------------------
// Stripe plan assembly (formats/stripe.py plan_stripe numpy-body analog).
//
// The stripe sort key (stripe, w, r, c) is monotone in `stripe` over CSR
// order (stripe = row / (L*128)), so the global lexsort decomposes into
// independent per-stripe sorts over contiguous CSR ranges — the same
// cache-resident trick as blockwise_key_sort, with stripes as the blocks.
// Two-call protocol (the slab/spill counts are unknown before planning):
//   spmx_stripe_count(...)  -> sorts, chunks, packs slabs, counts spill;
//                              retains the permutation + chunk meta in
//                              process-global state; writes
//                              [num_slabs, num_chunks, kw_g, num_spill]
//   spmx_stripe_fill(...)   -> fills the caller-allocated slab arrays from
//                              the retained state, emits spill positions,
//                              clears the state.
// NOT reentrant across interleaved plans (single state slot) — the Python
// caller does count+fill back to back under one plan_stripe call.
// ---------------------------------------------------------------------------

typedef uint8_t u8;
typedef int32_t i32;

namespace {

struct StripeState {
  i64 nnz = -1;
  i64 rows = 0, cols = 0, levels = 0, kw = 0;
  int select_mode = 0;
  int rb_bits = 0, cb_bits = 0;  // key field widths (rloc / cloc)
  i64 kw_g = 0;
  std::vector<i64> perm;        // sorted entry -> CSR position
  std::vector<u64> keys;        // sorted per-stripe keys
  std::vector<i64> stripe_off;  // per-stripe CSR entry offsets (ns+1)
  // per chunk:
  std::vector<i64> c_begin;     // entry index of chunk start (nc+1)
  std::vector<i64> c_slab;
  std::vector<u8> c_sub;
  std::vector<u32> c_stripe;
  std::vector<i32> c_coloff;    // col_off value (window units)
  std::vector<i64> c_minc;      // select: chunk min column (raw)
};

StripeState g_stripe;

static inline int ceil_log2(i64 v) {
  int b = 0;
  while ((i64(1) << b) < v) ++b;
  return b;
}

}  // namespace

extern "C" i64 spmx_stripe_count(i64 rows, i64 cols, i64 nnz,
                                 const i64* offsets, const u32* indices,
                                 i64 levels, i64 kw, int select_mode,
                                 i64* out_meta) {
  StripeState& st = g_stripe;
  st = StripeState();
  if (levels < 1 || levels > 255 || kw < 1 || kw > 255 || nnz < 0 ||
      nnz >= (i64(1) << 31))
    return -1;
  const i64 LANES = 128;
  const i64 h = levels * LANES;
  const i64 wsz = kw * LANES;
  st.rows = rows; st.cols = cols; st.nnz = nnz;
  st.levels = levels; st.kw = kw; st.select_mode = select_mode;
  const int rb = ceil_log2(h), cb = ceil_log2(wsz);
  st.rb_bits = rb; st.cb_bits = cb;
  // w needs bits(cols/wsz+1); total must fit u64
  if (ceil_log2(cols / wsz + 2) + rb + cb > 63) return -1;

  const i64 ns = rows > 0 ? (rows + h - 1) / h : 0;
  st.stripe_off.resize((size_t)ns + 1);
  for (i64 s = 0; s <= ns; ++s) {
    i64 r = s * h < rows ? s * h : rows;
    st.stripe_off[(size_t)s] = offsets[r];
  }
  st.keys.resize((size_t)nnz);
  st.perm.resize((size_t)nnz);
  // keys: scan (w, rloc, cloc); select (w, cloc, rloc) — within a stripe
  // this reproduces lexsort((c,r,w,stripe)) / ((r,c,w,stripe)) exactly
  // (c = w*wsz + cloc and r = stripe*h + rloc are monotone per field).
  for (i64 r = 0; r < rows; ++r) {
    const u64 rloc = (u64)(r % h);
    for (i64 p = offsets[r]; p < offsets[r + 1]; ++p) {
      const u64 c = indices[p];
      const u64 w = c / (u64)wsz;
      const u64 cloc = c - w * (u64)wsz;
      st.keys[(size_t)p] = select_mode
          ? (((w << cb) | cloc) << rb) | rloc
          : (((w << rb) | rloc) << cb) | cloc;
    }
  }
  // per-stripe sorts ((key, idx) packed into one u64 when the widths fit)
  {
    std::vector<std::pair<u64, i64>> buf;
    std::vector<u64> packed;
    for (i64 s = 0; s < ns; ++s) {
      const i64 lo = st.stripe_off[(size_t)s], hi = st.stripe_off[(size_t)s + 1];
      const i64 len = hi - lo;
      if (len <= 0) continue;
      bool sorted = true;
      for (i64 k = 1; k < len; ++k)
        if (st.keys[(size_t)(lo + k)] < st.keys[(size_t)(lo + k - 1)]) {
          sorted = false;
          break;
        }
      if (sorted) {
        for (i64 k = 0; k < len; ++k) st.perm[(size_t)(lo + k)] = lo + k;
        continue;
      }
      if (len < (i64)(1 << 20) &&
          *std::max_element(st.keys.begin() + lo, st.keys.begin() + hi) <
              (1ULL << 44)) {
        packed.resize((size_t)len);
        for (i64 k = 0; k < len; ++k)
          packed[(size_t)k] = (st.keys[(size_t)(lo + k)] << 20) | (u64)k;
        std::sort(packed.begin(), packed.end());
        for (i64 k = 0; k < len; ++k) {
          const u64 pk = packed[(size_t)k];
          st.perm[(size_t)(lo + k)] = lo + (i64)(pk & ((1ULL << 20) - 1));
          st.keys[(size_t)(lo + k)] = pk >> 20;
        }
      } else {
        buf.resize((size_t)len);
        for (i64 k = 0; k < len; ++k)
          buf[(size_t)k] = {st.keys[(size_t)(lo + k)], lo + k};
        std::sort(buf.begin(), buf.end());
        for (i64 k = 0; k < len; ++k) {
          st.perm[(size_t)(lo + k)] = buf[(size_t)k].second;
          st.keys[(size_t)(lo + k)] = buf[(size_t)k].first;
        }
      }
    }
  }
  // chunk pass: new chunk at window change or cap; slab packing per stripe
  const i64 cap = select_mode ? LANES - 1 : LANES;
  const int SUB = 8;
  i64 slab_base = 0, num_chunks = 0;
  for (i64 s = 0; s < ns; ++s) {
    const i64 lo = st.stripe_off[(size_t)s], hi = st.stripe_off[(size_t)s + 1];
    i64 cis = 0;       // chunks in this stripe
    u64 cur_w = ~0ULL;
    i64 in_chunk = 0;
    for (i64 p = lo; p < hi; ++p) {
      const u64 w = st.keys[(size_t)p] >> (rb + cb);
      if (w != cur_w || in_chunk == cap) {
        // close previous, open new
        st.c_begin.push_back(p);
        st.c_slab.push_back(slab_base + cis / SUB);
        st.c_sub.push_back((u8)(cis % SUB));
        st.c_stripe.push_back((u32)s);
        if (select_mode) {
          const u64 key = st.keys[(size_t)p];
          const u64 cloc = (key >> rb) & ((u64(1) << cb) - 1);
          st.c_minc.push_back((i64)(w * (u64)wsz + cloc));
          st.c_coloff.push_back(0);  // patched below (min_c >> 7)
        } else {
          st.c_coloff.push_back((i32)(w * (u64)kw));
        }
        ++cis;
        ++num_chunks;
        in_chunk = 0;
        cur_w = w;
      }
      ++in_chunk;
    }
    slab_base += (cis + SUB - 1) / SUB;
  }
  st.c_begin.push_back(nnz);
  const i64 num_slabs = slab_base;

  i64 kw_g = kw, num_spill = 0;
  if (select_mode && num_chunks > 0) {
    // spans in 128-col blocks; numpy: max_c//128 - (min_c>>7) + 1, chunk
    // entries are column-sorted so min/max are the first/last entries
    std::vector<i64> spans((size_t)num_chunks);
    for (i64 ci = 0; ci < num_chunks; ++ci) {
      const i64 first = st.c_begin[(size_t)ci];
      const i64 last = st.c_begin[(size_t)ci + 1] - 1;
      const u64 kf = st.keys[(size_t)first], kl = st.keys[(size_t)last];
      const u64 wf = kf >> (rb + cb);
      const u64 clocf = (kf >> rb) & ((u64(1) << cb) - 1);
      const u64 wl = kl >> (rb + cb);
      const u64 clocl = (kl >> rb) & ((u64(1) << cb) - 1);
      const i64 cmin = (i64)(wf * (u64)wsz + clocf);
      const i64 cmax = (i64)(wl * (u64)wsz + clocl);
      spans[(size_t)ci] = cmax / LANES - (cmin >> 7) + 1;
      st.c_coloff[(size_t)ci] = (i32)(cmin >> 7);
    }
    // numpy percentile(spans, 90), 'linear': pos = 0.9*(n-1), interpolate,
    // then int() truncation and the >=1 floor
    std::vector<i64> sorted_spans(spans);
    std::sort(sorted_spans.begin(), sorted_spans.end());
    const double pos = 0.9 * (double)(num_chunks - 1);
    const i64 fl = (i64)pos;
    const double frac = pos - (double)fl;
    double pct = (double)sorted_spans[(size_t)fl];
    if (fl + 1 < num_chunks)
      pct += frac * ((double)sorted_spans[(size_t)fl + 1] - pct);
    i64 kw_cap = (i64)pct;
    if (kw_cap < 1) kw_cap = 1;
    const i64 max_span = sorted_spans[(size_t)num_chunks - 1];
    kw_g = max_span < kw_cap ? max_span : kw_cap;
    // spill: gather-width overflow OR same-row collision within a chunk
    // (the FIRST same-(chunk,row) entry in column order is kept; numpy
    // marks later duplicates regardless of the over flag)
    std::vector<i64> last_ci((size_t)h, -1);
    for (i64 ci = 0; ci < num_chunks; ++ci) {
      const i64 base_col = ((i64)st.c_coloff[(size_t)ci]) << 7;
      for (i64 p = st.c_begin[(size_t)ci]; p < st.c_begin[(size_t)ci + 1];
           ++p) {
        const u64 key = st.keys[(size_t)p];
        const u64 rloc = key & ((u64(1) << rb) - 1);
        const u64 w = key >> (rb + cb);
        const u64 cloc = (key >> rb) & ((u64(1) << cb) - 1);
        const i64 c = (i64)(w * (u64)wsz + cloc);
        bool sp = (c - base_col) >= kw_cap * LANES;
        if (last_ci[(size_t)rloc] == ci) sp = true;
        else last_ci[(size_t)rloc] = ci;
        if (sp) ++num_spill;
      }
    }
  }
  st.kw_g = kw_g;
  out_meta[0] = num_slabs;
  out_meta[1] = num_chunks;
  out_meta[2] = kw_g;
  out_meta[3] = num_spill;
  return 0;
}

extern "C" i64 spmx_stripe_fill(const float* vals, float* vals_s, void* lane_s,
                                int lane_is_i16, signed char* ends_s,
                                signed char* starts_s, i32* col_off,
                                i32* chunk_stripe, i32* stripe_rb, u8* rb_used,
                                i64* sp_idx) {
  StripeState& st = g_stripe;
  if (st.nnz < 0) return -1;
  const i64 LANES = 128;
  const int SUB = 8;
  const i64 h = st.levels * LANES;
  const int rb = st.rb_bits, cb = st.cb_bits;
  const i64 wsz = st.kw * LANES;
  const i64 num_chunks = (i64)st.c_begin.size() - 1;
  const i64 kw_cap = st.kw_g;  // select gather width (128-col units)
  short* lane16 = (short*)lane_s;
  signed char* lane8 = (signed char*)lane_s;
  i64 nsp = 0;
  std::vector<i64> last_ci((size_t)h, -1);
  for (i64 ci = 0; ci < num_chunks; ++ci) {
    const i64 slab = st.c_slab[(size_t)ci];
    const i64 sub = st.c_sub[(size_t)ci];
    const u32 stripe = st.c_stripe[(size_t)ci];
    const i64 slot_base = (slab * SUB + sub) * LANES;
    col_off[slab * SUB + sub] = st.c_coloff[(size_t)ci];
    chunk_stripe[slab * SUB + sub] = (i32)stripe;
    stripe_rb[slab] = (i32)(stripe * (u32)st.levels);
    const i64 base_col = st.select_mode
        ? (((i64)st.c_coloff[(size_t)ci]) << 7)
        : ((i64)st.c_coloff[(size_t)ci] / st.kw) * wsz;
    i64 run_rloc = -1;
    for (i64 p = st.c_begin[(size_t)ci]; p < st.c_begin[(size_t)ci + 1];
         ++p) {
      const u64 key = st.keys[(size_t)p];
      const u64 rloc = st.select_mode ? (key & ((u64(1) << rb) - 1))
                                      : ((key >> cb) & ((u64(1) << rb) - 1));
      const u64 w = key >> (rb + cb);
      const u64 cloc = st.select_mode
          ? ((key >> rb) & ((u64(1) << cb) - 1))
          : (key & ((u64(1) << cb) - 1));
      const i64 c = (i64)(w * (u64)wsz + cloc);
      const i64 lev = (i64)(rloc / (u64)LANES);
      const i64 dst = (i64)(rloc % (u64)LANES);
      rb_used[(i64)stripe * st.levels + lev] = 1;
      const i64 k = p - st.c_begin[(size_t)ci];  // within-chunk position
      if (st.select_mode) {
        bool sp = (c - base_col) >= kw_cap * LANES;
        if (last_ci[(size_t)rloc] == ci) sp = true;
        else last_ci[(size_t)rloc] = ci;
        if (sp) {
          sp_idx[nsp++] = st.perm[(size_t)p];
          continue;
        }
        const i64 pos = k + 1;  // slot 0 reserved zero
        vals_s[slot_base + pos] = vals[st.perm[(size_t)p]];
        if (lane_is_i16) lane16[slot_base + pos] = (short)(c - base_col);
        else lane8[slot_base + pos] = (signed char)(c - base_col);
        ends_s[((slab * st.levels + lev) * SUB + sub) * LANES + dst] =
            (signed char)pos;
      } else {
        const i64 pos = k;
        vals_s[slot_base + pos] = vals[st.perm[(size_t)p]];
        if (lane_is_i16) lane16[slot_base + pos] = (short)cloc;
        else lane8[slot_base + pos] = (signed char)cloc;
        const i64 idx4 = ((slab * st.levels + lev) * SUB + sub) * LANES + dst;
        if ((i64)rloc != run_rloc) {
          starts_s[idx4] = (signed char)(pos - 1);
          run_rloc = (i64)rloc;
        }
        // last write wins = run tail (same-row entries are contiguous)
        ends_s[idx4] = (signed char)pos;
      }
    }
  }
  st = StripeState();
  return nsp;
}
