// Host runtime of the PyTorch port: the C++ engines behind explanation and
// CSV ingest, a copy of the parts of native/mmlspark_native.cpp the port
// runs (the JAX package keeps its own):
//
//   * WorkPool — the persistent worker pool both entry points run on;
//   * mm_csv_read_floats — numeric CSV text -> dense float32 rows
//     (csv_to_shards in models/gbdt/ingest.py);
//   * mm_treeshap — exact TreeSHAP for one tree, all instances, threaded
//     over instances (the host engine of models/gbdt/treeshap.py);
//   * mm_murmur3_32 / mm_murmur3_batch — MurmurHash3_x86_32, the feature
//     identity of ops/murmur.py and the VW featurizer;
//   * mm_abi_version.
//
// Exposed C-ABI for ctypes. Built at first use by
// mmlspark_tpu_torch/ops/_build.py (build_host):
//   c++ -std=c++17 -O3 -shared -fPIC -pthread mmlspark_native.cpp -o ...

#include <algorithm>
#include <atomic>
#include <charconv>
#include <clocale>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <locale.h>
#include <unistd.h>

namespace {

// Persistent worker pool shared by every threaded native entry point
// (TreeSHAP is called once per tree — hundreds of times per explain —
// and spawning + joining a thread team per call costs tens of
// microseconds each on many-core hosts). Workers
// are started once, parked on a condition variable between calls, and
// handed (job, row-range) work via a shared generation counter; calls are
// serialized by a dispatch mutex (each call already saturates the cores).
class WorkPool {
 public:
  static WorkPool& instance() {
    // deliberately leaked: a static-local would run its destructor at
    // process exit while detached workers still wait on cv_/mu_, which
    // is undefined behavior (pthread destroy with waiters)
    static WorkPool* pool = new WorkPool();
    return *pool;
  }

  // run fn(r0, r1) over [0, n) split across nt ranges (nt <= size()+1);
  // the calling thread works too, so nt == 1 never touches the pool
  void run(int64_t n, int64_t nt,
           const std::function<void(int64_t, int64_t)>& fn) {
    const int64_t step = (n + nt - 1) / nt;
    // fork safety: a child inherits workers_.size() but ZERO live worker
    // threads (only the forking thread survives fork) — publishing work
    // to them would block done_cv_.wait forever, so the child runs serial
    if (nt <= 1 || workers_.empty() || getpid() != owner_pid_) {
      fn(0, n);
      return;
    }
    std::unique_lock<std::mutex> dispatch(dispatch_mu_);
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &fn;
      job_n_ = n;
      job_step_ = step;
      job_ranges_ = nt - 1;   // pool handles all but the caller's range
      next_range_ = 0;
      done_count_ = 0;
      generation_++;
    }
    cv_.notify_all();
    fn((nt - 1) * step, std::min(n, nt * step));  // caller's share
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return done_count_ >= job_ranges_; });
    // job_ cleared under mu_ AFTER every range completed, so a late-waking
    // worker can never claim from a stale/dangling job
    job_ = nullptr;
  }

  int64_t size() const { return (int64_t)workers_.size(); }

 private:
  WorkPool() : owner_pid_(getpid()) {
    unsigned hw = std::thread::hardware_concurrency();
    const char* cap = std::getenv("MMLSPARK_TPU_NATIVE_THREADS");
    // an EXPLICIT override may exceed the core count (oversubscription is
    // harmless, and it is the only way tests on a 1-core box can exercise
    // the pool's parallel paths for real); the default stays at hw
    long want = cap ? std::strtol(cap, nullptr, 10) : (long)(hw ? hw : 1);
    want = std::max(1L, std::min(want, 256L));
    for (long t = 0; t + 1 < want; t++) {  // caller thread counts as one
      workers_.emplace_back([this] { this->loop(); });
      workers_.back().detach();  // process-lifetime pool
    }
  }

  // Range claims happen UNDER mu_ (a handful of claims per call — the
  // lock is not contended at that granularity), which makes staleness
  // impossible by construction: a claim observes (job_, generation_)
  // atomically with the counter it advances.
  void loop() {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(mu_);
    while (true) {
      cv_.wait(lk, [&] { return job_ != nullptr && generation_ != seen; });
      seen = generation_;
      while (job_ != nullptr && next_range_ < job_ranges_) {
        const int64_t r = next_range_++;
        const auto* job = job_;
        const int64_t n = job_n_, step = job_step_;
        lk.unlock();
        (*job)(r * step, std::min(n, (r + 1) * step));
        lk.lock();
        if (++done_count_ >= job_ranges_) done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  const pid_t owner_pid_;   // workers die across fork; children go serial
  std::mutex dispatch_mu_;  // one job in flight at a time
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(int64_t, int64_t)>* job_ = nullptr;
  int64_t job_n_ = 0, job_step_ = 0, job_ranges_ = 0;
  int64_t next_range_ = 0, done_count_ = 0;
  uint64_t generation_ = 0;
};

}  // namespace

extern "C" {

// Behavioral ABI version: bump on any change to native semantics. Keep in
// sync with ABI_VERSION in mmlspark_tpu_torch/native/__init__.py
// (v2: the murmur hashes).
int64_t mm_abi_version() { return 2; }

// ---------------------------------------------------------------------------
// MurmurHash3_x86_32 (Austin Appleby, public domain) — must match the JAX
// package's native/mmlspark_native.cpp and the plain Python body in
// mmlspark_tpu_torch/ops/murmur.py bit for bit: hashing defines feature
// identity.
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6b;
  h ^= h >> 13;
  h *= 0xc2b2ae35;
  h ^= h >> 16;
  return h;
}

uint32_t mm_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  const int64_t nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51;
  const uint32_t c2 = 0x1b873593;

  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + 4 * i, 4);  // little-endian hosts only
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5 + 0xe6546b64;
  }

  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= tail[1] << 8;  [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }

  h1 ^= (uint32_t)len;
  return fmix32(h1);
}

// Batch: n strings packed into one utf-8 buffer with offsets[n+1]; one seed
// per string (the VW namespace hash). Out: n uint32 hashes. Rows are
// independent — large batches fan out over the worker pool; the threshold
// keeps small calls on the caller.
void mm_murmur3_batch(const uint8_t* buf, const int64_t* offsets,
                      const uint32_t* seeds, int64_t n, uint32_t* out) {
  auto body = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; i++) {
      out[i] = mm_murmur3_32(buf + offsets[i], offsets[i + 1] - offsets[i],
                             seeds[i]);
    }
  };
  // threshold checked BEFORE touching the pool: instance() spawns the
  // permanent worker threads, which a small batch should never trigger
  if (n < 65536) {
    body(0, n);
    return;
  }
  WorkPool::instance().run(n, WorkPool::instance().size() + 1, body);
}

// ---------------------------------------------------------------------------
// Float CSV ingestion (data loader). Parses a comma/newline-delimited buffer
// of numerics into a dense float32 matrix. Returns rows parsed, or -1 on a
// column-count mismatch. Empty fields and "nan" parse to NaN.
// ---------------------------------------------------------------------------

static inline bool is_blank(const char* s, const char* e) {
  for (; s < e; s++)
    if (*s != ' ' && *s != '\t' && *s != '\r') return false;
  return true;
}

// [a, b) as one float, NaN unless the whole field parses. std::from_chars
// is locale-independent; a standard library without its float overload
// (before GCC 11) parses with strtof_l under the "C" locale instead.
static inline float parse_float(const char* a, const char* b) {
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  float v;
  auto res = std::from_chars(a, b, v);
  return (res.ec == std::errc() && res.ptr == b) ? v : NAN;
#else
  static locale_t c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  char tmp[128];
  const size_t len = (size_t)(b - a);
  if (len >= sizeof(tmp)) return NAN;
  std::memcpy(tmp, a, len);
  tmp[len] = '\0';
  char* end = nullptr;
  const float v = strtof_l(tmp, &end, c_locale);
  return (end == tmp + len) ? v : NAN;
#endif
}

// One non-blank line [p, eol) -> out_row[0..ncols); false on a
// column-count mismatch. Fields are trimmed; empty/unparseable -> NaN.
static inline bool parse_csv_line(const char* p, const char* eol,
                                  int64_t ncols, float* out_row) {
  int64_t col = 0;
  const char* f = p;
  while (true) {
    const char* fe = (const char*)memchr(f, ',', eol - f);
    const char* fend = fe ? fe : eol;
    if (col >= ncols) return false;
    // trim surrounding whitespace/CR, parse within the bounded field
    const char* a = f;
    const char* b = fend;
    while (a < b && (*a == ' ' || *a == '\t' || *a == '\r')) a++;
    while (b > a && (*(b - 1) == ' ' || *(b - 1) == '\t' || *(b - 1) == '\r'))
      b--;
    if (a == b) {
      out_row[col] = NAN;  // empty field
    } else {
      // std::from_chars: locale-independent (strtof honors LC_NUMERIC, so
      // a comma-decimal host locale would silently NaN every field while
      // the Python fallback parsed fine); bounded by [a, b), and a partial
      // parse means a bad field -> NaN. from_chars rejects a leading '+'
      // (Python's float() accepts it) — skip one explicit plus sign.
      if (*a == '+' && b - a > 1 && *(a + 1) != '-' && *(a + 1) != '+') a++;
      out_row[col] = parse_float(a, b);
    }
    col++;
    if (!fe) break;
    f = fe + 1;
  }
  return col == ncols;
}

static int64_t csv_parse_serial(const char* buf, int64_t len, int64_t ncols,
                                float* out, int64_t max_rows) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end && row < max_rows) {
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (eol == nullptr) eol = end;
    if (!is_blank(p, eol)) {  // skip blank lines (python: `if not strip()`)
      if (!parse_csv_line(p, eol, ncols, out + row * ncols)) return -1;
      row++;
    }
    p = eol + 1;
  }
  return row;
}

int64_t mm_csv_read_floats(const char* buf, int64_t len, int64_t ncols,
                           float* out, int64_t max_rows) {
  // Two-pass parallel parse for large buffers (out-of-core CSV ingest
  // feeds 64 MB chunks): split at line boundaries, count non-blank lines
  // per span, prefix-sum the row offsets, then parse every span into its
  // own output slice. Semantics identical to the serial path; a span
  // that would overflow max_rows falls back to serial (callers size
  // max_rows from the newline count, so this is the rare path).
  const int64_t kParThreshold = 4 << 20;
  // threshold BEFORE instance(): small parses must not spawn the pool
  if (len < kParThreshold)
    return csv_parse_serial(buf, len, ncols, out, max_rows);
  const int64_t nt_avail = WorkPool::instance().size() + 1;
  if (nt_avail <= 1)
    return csv_parse_serial(buf, len, ncols, out, max_rows);

  const int64_t nt = std::min<int64_t>(nt_avail, 1 + len / (1 << 20));
  std::vector<int64_t> start(nt + 1, len);
  start[0] = 0;
  for (int64_t t = 1; t < nt; t++) {
    int64_t pos = len * t / nt;
    if (pos <= start[t - 1]) pos = start[t - 1];
    const char* nl = (const char*)memchr(buf + pos, '\n', len - pos);
    start[t] = nl ? (nl - buf) + 1 : len;
  }
  // pass 1: non-blank line count per span
  std::vector<int64_t> rows(nt, 0);
  WorkPool::instance().run(nt, nt, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; t++) {
      const char* p = buf + start[t];
      const char* end = buf + start[t + 1];
      int64_t r = 0;
      while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        if (eol == nullptr) eol = end;
        if (!is_blank(p, eol)) r++;
        p = eol + 1;
      }
      rows[t] = r;
    }
  });
  std::vector<int64_t> offset(nt + 1, 0);
  for (int64_t t = 0; t < nt; t++) offset[t + 1] = offset[t] + rows[t];
  if (offset[nt] > max_rows)
    return csv_parse_serial(buf, len, ncols, out, max_rows);
  // pass 2: parse spans into disjoint output slices
  std::vector<uint8_t> bad(nt, 0);
  WorkPool::instance().run(nt, nt, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; t++) {
      const int64_t got = csv_parse_serial(
          buf + start[t], start[t + 1] - start[t], ncols,
          out + offset[t] * ncols, rows[t]);
      if (got != rows[t]) bad[t] = 1;
    }
  });
  for (int64_t t = 0; t < nt; t++)
    if (bad[t]) return -1;
  return offset[nt];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact TreeSHAP (Lundberg, Erion & Lee 2018, Algorithm 2) — the native
// engine behind predict_contrib on host. The reference's featuresShapCol
// rides LightGBM's C++ TreeSHAP (lightgbm/LightGBMBooster.scala:250-269);
// this is the same algorithm implemented from the paper against this
// repo's tree arrays. Per-instance scalar recursion (cache-friendly),
// threaded over instances; routing decisions (thresholds, categorical
// bitsets, NaN handling) are precomputed by the Python caller into a
// [M, n] go_left matrix so the numeric split semantics live in ONE place
// (models/gbdt/treeshap.py builds the same matrix for the numpy engine).
// Parity: bit-comparable op order with treeshap.py's vectorized EXTEND /
// UNWIND, pinned by tests/test_torch_treeshap.py.
// ---------------------------------------------------------------------------

namespace {

struct TsTree {
  const int32_t* feat;
  const int32_t* left;
  const int32_t* right;
  const uint8_t* is_leaf;
  const double* cover;
  const double* values;
};

// Flat per-thread arena: one row of path state per recursion level, so a
// child copies its parent's row with plain memcpy — no allocator traffic
// anywhere in the hot loop (the naive pass-vectors-by-value version
// measured 0.8x the numpy engine; this version is what makes native
// worthwhile). Row capacity = max depth + 2.
struct TsArena {
  int cap;
  std::vector<int32_t> d;
  std::vector<double> z, o, w;
  explicit TsArena(int levels, int cap_)
      : cap(cap_),
        d((size_t)levels * cap_),
        z((size_t)levels * cap_),
        o((size_t)levels * cap_),
        w((size_t)levels * cap_) {}
};

// EXTEND in place on a row holding l elements; returns the new length.
inline int ts_extend(int32_t* d, double* z, double* o, double* w, int l,
                     double pz, double po, int32_t pi) {
  d[l] = pi;
  z[l] = pz;
  o[l] = po;
  w[l] = (l == 0) ? 1.0 : 0.0;
  for (int i = l - 1; i >= 0; i--) {
    w[i + 1] += po * w[i] * (i + 1) / (l + 1);
    w[i] = pz * w[i] * (l - i) / (l + 1);
  }
  return l + 1;
}

// UNWIND element k in place (len elements); returns the new length.
inline int ts_unwind(int32_t* d, double* z, double* o, double* w, int len,
                     int k) {
  const int l = len - 1;
  const double of = o[k];
  const double zf = z[k];
  double next_one = w[l];
  for (int i = l - 1; i >= 0; i--) {
    double t;
    if (of != 0.0) {
      t = next_one * (l + 1) / ((i + 1) * of);
    } else {
      t = (zf != 0.0) ? w[i] * (l + 1) / (zf * (l - i)) : 0.0;
    }
    next_one = w[i] - t * zf * (l - i) / (l + 1);
    w[i] = t;
  }
  for (int i = k; i < l; i++) {
    d[i] = d[i + 1];
    z[i] = z[i + 1];
    o[i] = o[i + 1];
  }
  return l;
}

inline double ts_unwound_sum(const int32_t* d, const double* z,
                             const double* o, const double* w, int len,
                             int k) {
  (void)d;
  const int l = len - 1;
  const double of = o[k];
  const double zf = z[k];
  double next_one = w[l];
  double total = 0.0;
  for (int i = l - 1; i >= 0; i--) {
    double t;
    if (of != 0.0) {
      t = next_one * (l + 1) / ((i + 1) * of);
    } else {
      t = (zf != 0.0) ? w[i] * (l + 1) / (zf * (l - i)) : 0.0;
    }
    total += t;
    next_one = w[i] - t * zf * (l - i) / (l + 1);
  }
  return total;
}

// DFS from node j for one instance. Level r's path lives in arena row r;
// both children re-copy the parent row, so left's mutations never leak
// into right's view.
void ts_recurse(const TsTree& T, const uint8_t* go, int64_t n, int64_t row,
                int32_t j, double pz, double po, int32_t pi, int level,
                int plen, TsArena& A, double* phi) {
  int32_t* d = A.d.data() + (size_t)level * A.cap;
  double* z = A.z.data() + (size_t)level * A.cap;
  double* o = A.o.data() + (size_t)level * A.cap;
  double* w = A.w.data() + (size_t)level * A.cap;
  if (level > 0) {
    const size_t poff = (size_t)(level - 1) * A.cap;
    std::memcpy(d, A.d.data() + poff, plen * sizeof(int32_t));
    std::memcpy(z, A.z.data() + poff, plen * sizeof(double));
    std::memcpy(o, A.o.data() + poff, plen * sizeof(double));
    std::memcpy(w, A.w.data() + poff, plen * sizeof(double));
  }
  int len = ts_extend(d, z, o, w, plen, pz, po, pi);
  if (T.is_leaf[j]) {
    for (int i = 1; i < len; i++) {
      phi[d[i]] +=
          ts_unwound_sum(d, z, o, w, len, i) * (o[i] - z[i]) * T.values[j];
    }
    return;
  }
  const int32_t f = T.feat[j];
  double iz = 1.0, io = 1.0;
  for (int k = 1; k < len; k++) {
    if (d[k] == f) {
      iz = z[k];
      io = o[k];
      len = ts_unwind(d, z, o, w, len, k);
      break;
    }
  }
  const double cj = std::max(T.cover[j], 1e-12);
  const double gl = go[(int64_t)j * n + row] ? 1.0 : 0.0;
  const int32_t lo = T.left[j], hi = T.right[j];
  ts_recurse(T, go, n, row, lo, T.cover[lo] / cj * iz, io * gl, f,
             level + 1, len, A, phi);
  ts_recurse(T, go, n, row, hi, T.cover[hi] / cj * iz, io * (1.0 - gl), f,
             level + 1, len, A, phi);
}

// Structural backstop on tree depth: ts_recurse is true C recursion, so
// a degenerate chain (huge num_leaves with leaf_batch=1, or an imported
// deep chain) would overflow the thread stack; past this the tree routes
// to the heap-stacked numpy engine, which degrades gracefully. NOTE the
// arena budget below binds FIRST (at 256 MiB it rejects depth > ~3094),
// so this constant only matters if the budget is raised.
constexpr int kTsMaxAcceptedDepth = 4096;

// The per-thread TsArena is O(levels^2) cells of one int32 + three
// doubles, so a depth cap alone does not bound memory (depth 4000 ~=
// 450 MB per thread). Accepted trees must fit ALL threads' arenas in
// this budget: the thread count is clamped to it, and a tree whose
// single arena exceeds it is rejected outright (routed to numpy) — the
// EFFECTIVE depth cutoff, sqrt(budget/28)-2 ~= 3094 at 256 MiB.
constexpr int64_t kTsArenaBytesPerCell =
    sizeof(int32_t) + 3 * sizeof(double);
constexpr int64_t kTsArenaBudgetBytes = 256ll << 20;

// Iterative validation walk + max depth (leafwise chains can be
// ~num_leaves deep). Bounds check BEFORE the is_leaf dereference: a
// malformed imported tree with a child index of -1 / >= M must not read
// out of bounds here. Internal nodes must also carry a split feature in
// [0, F): ts_recurse writes phi[feat[j]] for every internal node on a
// path, so an out-of-range feature is an out-of-bounds heap write (the
// Python routing build does not catch a negative one — numpy wraps it).
// Returns -1 for any such tree so the caller can reject it instead of
// recursing into the same out-of-bounds walk.
int ts_max_depth(const TsTree& T, int64_t M, int64_t F) {
  std::vector<int32_t> stack_node{0};
  std::vector<int32_t> stack_depth{0};
  int maxd = 0;
  int64_t pops = 0;
  while (!stack_node.empty()) {
    const int32_t j = stack_node.back();
    const int32_t dep = stack_depth.back();
    stack_node.pop_back();
    stack_depth.pop_back();
    if (j < 0 || j >= M) return -1;
    // a valid M-node tree pops each node once; in-range child indices
    // forming a CYCLE would walk forever without this bound
    if (++pops > M) return -1;
    maxd = std::max(maxd, (int)dep);
    if (maxd > kTsMaxAcceptedDepth) return -1;
    if (!T.is_leaf[j]) {
      if (T.feat[j] < 0 || T.feat[j] >= F) return -1;
      stack_node.push_back(T.left[j]);
      stack_depth.push_back(dep + 1);
      stack_node.push_back(T.right[j]);
      stack_depth.push_back(dep + 1);
    }
  }
  return maxd;
}

}  // namespace

extern "C" {

// One tree, all instances: phi[n, F] += per-feature Shapley values.
// go_left: [M, n] row-major routing (1 = instance follows the left child).
// The expected-value column is the caller's (pure cover arithmetic).
// Returns 0, or -1 for a malformed/degenerate tree (child index out of
// [0, M), internal-node feature out of [0, F), cycle, or depth past
// kTsMaxAcceptedDepth) — the caller falls back to the checked Python
// engine.
int64_t mm_treeshap(const int32_t* feat, const int32_t* left,
                    const int32_t* right, const uint8_t* is_leaf,
                    const double* cover, const double* values,
                    const uint8_t* go_left, int64_t M, int64_t n,
                    int64_t F, int64_t n_threads, double* phi) {
  const TsTree T{feat, left, right, is_leaf, cover, values};
  if (M < 1) return -1;
  // walks the whole tree: validates every child and feature index before
  // ts_recurse dereferences any of them, and bounds the recursion depth
  const int maxd = ts_max_depth(T, M, F);
  if (maxd < 0) return -1;
  int64_t nt = n_threads > 0
                   ? n_threads
                   : (int64_t)std::thread::hardware_concurrency();
  nt = std::max<int64_t>(1, std::min(nt, n));
  nt = std::min(nt, WorkPool::instance().size() + 1);
  // path length <= depth+2 (root sentinel + one per level); one arena row
  // per recursion level, reused across all of a thread's instances
  const int levels = maxd + 2;
  const int64_t arena_bytes =
      (int64_t)levels * levels * kTsArenaBytesPerCell;
  if (arena_bytes > kTsArenaBudgetBytes) return -1;
  nt = std::min(nt, std::max<int64_t>(1, kTsArenaBudgetBytes / arena_bytes));

  WorkPool::instance().run(n, nt, [&](int64_t r0, int64_t r1) {
    TsArena arena(levels, levels);
    for (int64_t r = r0; r < r1; r++) {
      ts_recurse(T, go_left, n, r, 0, 1.0, 1.0, -1, 0, 0, arena,
                 phi + r * F);
    }
  });
  return 0;
}

}  // extern "C"
