// Long-read minimizer seed-chain mapper (raw-read mode backend).
//
// Replacement for the reference's external `rammap` crate
// (reference: src/util/mapper.rs wraps rammap; presets selected per
// sequencing tech at src/util/aligner.rs:34-41). From-scratch design:
//
//   index:  (k, w) minimizers over the target set -> postings sorted by
//           minimizer hash (flat arrays, binary-searchable), frequent-seed
//           cutoff like minimap2's -f.
//   map:    read minimizers -> anchors (target, strand, tpos, qpos) ->
//           per-(target,strand) colinear chaining DP (bounded lookback)
//           -> top `best_n` chains with target span + chaining score.
//
// Scores: chain scores approximate an alignment score (2 * chained bases,
// capped by query coverage); with rescoring on (default in transcript
// mode) the retained candidates get true base-level alignment scores —
// exact diagonal compares between anchors, banded affine-gap DP across
// indel segments, x-drop end extension — so the engine's
// `exp((score-best)/D)` weighting sees AS-like values as with rammap.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC mapper.cpp
//        -o liboarfish_mapper.so -pthread

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <sys/mman.h>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#ifdef __AVX512F__
#include <immintrin.h>
#endif
#include <vector>

namespace {

constexpr uint64_t HASH_MUL = 0x9E3779B97F4A7C15ULL;

inline uint64_t hash64(uint64_t x, uint64_t mask) {
  x = (~x + (x << 21)) & mask;
  x = x ^ (x >> 24);
  x = (x + (x << 3) + (x << 8)) & mask;
  x = x ^ (x >> 14);
  x = (x + (x << 2) + (x << 4)) & mask;
  x = x ^ (x >> 28);
  x = (x + (x << 31)) & mask;
  return x;
}

// 2-bit encode; 4 = ambiguous (flat LUT: the switch compiled to a
// branch chain that mispredicts on random genome bases — the index
// build's extraction loop reads one base per cycle through this)
struct Nt4Lut {
  int8_t t[256];
  constexpr Nt4Lut() : t{} {
    for (int i = 0; i < 256; i++) t[i] = 4;
    t['A'] = t['a'] = 0;
    t['C'] = t['c'] = 1;
    t['G'] = t['g'] = 2;
    t['T'] = t['t'] = t['U'] = t['u'] = 3;
  }
};
constexpr Nt4Lut kNt4{};
inline int nt4(uint8_t c) { return kNt4.t[c]; }

struct Minimizer {
  uint64_t key;   // hashed canonical k-mer
  uint32_t rid;   // target id (or read-local unused)
  uint32_t pos;   // start position of k-mer
  uint8_t strand; // 0 = forward canonical, 1 = reverse canonical
};

// Per-worker-thread scratch cap: the analogue of the
// reference's RAMMAP_DP_CACHE_CAP_MB / --dp-cache-cap-mb knob
// (Cargo.toml:84-87, prog_opts.rs:434-439, main.rs:347-349), which
// bounds mapper scratch memory that persists across reads on each
// worker thread. Same default: 128 MB per thread.
std::atomic<int64_t> g_scratch_cap_bytes{128ll << 20};

struct Cand {
  uint64_t key;
  uint32_t pos;
  uint8_t strand;
};

// Scratch buffers reused across reads on one worker thread (a fresh
// len-sized malloc per read would dominate the minimizer pass). A
// pathological read (e.g. one megabase-scale sequence) can balloon the
// retained capacity; trim_to_cap releases everything once the total
// exceeds the cap, restoring the reference's RSS-control semantics.
struct ThreadScratch {
  std::vector<Cand> win;      // minimizer window ring
  std::vector<size_t> deque;  // sliding-window minima indices
  std::vector<int32_t> dp, pre;  // chaining DP
  size_t bytes() const {
    return win.capacity() * sizeof(Cand) +
           deque.capacity() * sizeof(size_t) +
           (dp.capacity() + pre.capacity()) * sizeof(int32_t);
  }
  void trim_to_cap(size_t extra = 0) {
    int64_t cap = g_scratch_cap_bytes.load(std::memory_order_relaxed);
    if (int64_t(bytes() + extra) <= cap) return;
    std::vector<Cand>().swap(win);
    std::vector<size_t>().swap(deque);
    std::vector<int32_t>().swap(dp);
    std::vector<int32_t>().swap(pre);
  }
};
thread_local ThreadScratch g_scratch;

// extract (k,w) minimizers of seq into out — single pass. The
// sliding-window minimum only ever looks back w candidates, so the
// candidate store and the monotonic deque are W-slot rings (W = next
// pow2 > w) instead of len-sized vectors: the old two-pass form kept
// ~16 bytes/base of scratch per thread (~600 MB per 36 Mbp chromosome)
// and its page churn dominated genome-scale index builds.
template <class Emit>
void extract_minimizers_scalar_t(const uint8_t* seq, size_t len, int k,
                                 int w, Emit&& emit) {
  if (len < size_t(k)) return;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  uint64_t fwd = 0, rev = 0;
  int l = 0;
  uint32_t W = 1;
  while (W < uint32_t(w) + 1) W <<= 1;
  const uint32_t wm = W - 1;
  std::vector<Cand>& ring = g_scratch.win;
  if (ring.size() < W) ring.resize(W);
  std::vector<size_t>& dq = g_scratch.deque;
  if (dq.size() < W) dq.resize(W);
  // j: candidate counter; deque holds candidate indices in [dh, dt),
  // all within the last w+1 candidates (ring slots never collide)
  size_t j = 0, dh = 0, dt = 0;
  size_t last_emitted = SIZE_MAX;
  uint64_t gmin_key = ~0ULL;
  size_t gmin_idx = 0;
  Cand gmin{};
  for (size_t i = 0; i < len; i++) {
    int c = nt4(seq[i]);
    if (c >= 4) { l = 0; fwd = rev = 0; continue; }
    fwd = ((fwd << 2) | uint64_t(c)) & mask;
    rev = (rev >> 2) | (uint64_t(3 - c) << (2 * (k - 1)));
    if (++l < k) continue;
    uint64_t key; uint8_t strand;
    if (fwd < rev) { key = fwd; strand = 0; }
    else if (rev < fwd) { key = rev; strand = 1; }
    else continue;  // palindromic k-mer: skip (strand ambiguous)
    Cand cand{hash64(key, mask), uint32_t(i + 1 - k), strand};
    ring[j & wm] = cand;
    while (dt > dh && ring[dq[(dt - 1) & wm] & wm].key >= cand.key) dt--;
    dq[dt++ & wm] = j;
    if (cand.key < gmin_key) { gmin_key = cand.key; gmin_idx = j; gmin = cand; }
    if (j + 1 >= size_t(w)) {
      // window is the last w candidates [j+1-w, j]
      while (dq[dh & wm] + size_t(w) <= j) dh++;
      size_t m = dq[dh & wm];
      if (m != last_emitted) {
        const Cand& cm = ring[m & wm];
        emit(cm.key, cm.pos, cm.strand);
        last_emitted = m;
      }
    }
    j++;
  }
  if (j > 0 && j < size_t(w)) {
    // short sequence: emit the global minimum
    (void)gmin_idx;
    emit(gmin.key, gmin.pos, gmin.strand);
  }
}

// Strip-split extraction (round 5, VERDICT item 5): the all-in-one
// rolling loop above interleaves a serial dependency chain (LUT +
// k-mer shifts) with hash64 (~18 independent ops) and the deque per
// base, so nothing vectorizes. This form splits each 4096-candidate
// strip into (A) the cheap rolling candidate pass, (B) hash64 hoisted
// over a contiguous array — fully independent per element, which GCC
// auto-vectorizes 4-wide(+) under -march=native — and (C) the scalar
// windowed-minima deque whose state carries across strips.
//
// Emits the EXACT candidate stream of extract_minimizers_scalar
// (palindromes and invalid k-mers are not candidates and consume no
// window slot; N-gaps do not reset the window) — differential-tested
// against the Python transliteration in tests/test_mapper.py and
// byte-compared on full index builds (identical .otmi sha256).
template <class Emit>
void extract_minimizers_vec_t(const uint8_t* seq, size_t len, int k, int w,
                              Emit&& emit) {
  const uint64_t mask = (1ULL << (2 * k)) - 1;
  uint32_t W = 1;
  while (W < uint32_t(w) + 1) W <<= 1;
  const uint32_t wm = W - 1;
  std::vector<Cand>& ring = g_scratch.win;
  if (ring.size() < W) ring.resize(W);
  std::vector<size_t>& dq = g_scratch.deque;
  if (dq.size() < W) dq.resize(W);
  size_t j = 0, dh = 0, dt = 0;
  size_t last_emitted = SIZE_MAX;
  uint64_t gmin_key = ~0ULL;
  Cand gmin{};

  // strip buffers: canon/pos/strand from the cheap rolling pass, keys
  // from the hoisted hash loop (the expensive, fully independent part
  // -- auto-vectorizes over the contiguous array)
  constexpr size_t STRIP = 4096;
  uint64_t canon[STRIP];
  uint64_t keys[STRIP];
  uint32_t poss[STRIP];
  uint8_t strands[STRIP];

  uint64_t fwd = 0, rev = 0;
  int l = 0;
  size_t i = 0;
  while (i < len) {
    // pass A: rolling candidate generation (serial, ~10 ops/base)
    size_t nc = 0;
    while (i < len && nc < STRIP) {
      int c = nt4(seq[i]);
      i++;
      if (c >= 4) {
        l = 0;
        fwd = rev = 0;
        continue;
      }
      fwd = ((fwd << 2) | uint64_t(c)) & mask;
      rev = (rev >> 2) | (uint64_t(3 - c) << (2 * (k - 1)));
      if (++l < k) continue;
      if (fwd == rev) continue;  // palindromic k-mer: skip
      const bool f = fwd < rev;
      canon[nc] = f ? fwd : rev;
      poss[nc] = uint32_t(i - size_t(k));
      strands[nc] = f ? 0 : 1;
      nc++;
    }
    // pass B: hash64 over the strip (independent per element)
    for (size_t t = 0; t < nc; t++) keys[t] = hash64(canon[t], mask);
    // pass C: windowed minima (deque state carried across strips)
    for (size_t t = 0; t < nc; t++) {
      Cand cand{keys[t], poss[t], strands[t]};
      ring[j & wm] = cand;
      while (dt > dh && ring[dq[(dt - 1) & wm] & wm].key >= cand.key) dt--;
      dq[dt++ & wm] = j;
      if (cand.key < gmin_key) { gmin_key = cand.key; gmin = cand; }
      if (j + 1 >= size_t(w)) {
        while (dq[dh & wm] + size_t(w) <= j) dh++;
        size_t m = dq[dh & wm];
        if (m != last_emitted) {
          const Cand& cm = ring[m & wm];
          emit(cm.key, cm.pos, cm.strand);
          last_emitted = m;
        }
      }
      j++;
    }
  }
  if (j > 0 && j < size_t(w)) {
    // short sequence: emit the global minimum
    emit(gmin.key, gmin.pos, gmin.strand);
  }
}


template <class Emit>
void extract_minimizers_t(const uint8_t* seq, size_t len, int k, int w,
                          Emit&& emit) {
  if (len < size_t(k)) return;
  static const bool force_scalar = [] {
    const char* e = getenv("OARFISH_EXTRACT");
    return e && std::string(e) == "scalar";
  }();
  if (k >= 3 && k <= 31 && !force_scalar)
    extract_minimizers_vec_t(seq, len, k, w, emit);
  else
    extract_minimizers_scalar_t(seq, len, k, w, emit);
}

void extract_minimizers(const uint8_t* seq, size_t len, int k, int w,
                        uint32_t rid, std::vector<Minimizer>& out) {
  extract_minimizers_t(seq, len, k, w,
                       [&](uint64_t key, uint32_t pos, uint8_t strand) {
                         out.push_back({key, rid, pos, strand});
                       });
}

struct Index {
  int k, w;
  uint32_t n_targets;
  std::vector<std::string> names;
  std::vector<uint32_t> lengths;
  std::vector<uint8_t> seqs;        // concatenated 1-byte bases (ACGTN)
  std::vector<uint64_t> seq_off;    // n_targets + 1
  // postings sorted by key
  std::vector<uint64_t> keys;       // unique keys
  std::vector<uint64_t> key_off;    // n_keys + 1 into postings
  std::vector<uint64_t> postings;   // packed: rid(31) | pos(32) | strand(1)
  uint32_t max_occ;                 // frequent-seed cutoff
  // key lookup acceleration: hi_off[b] = first index in `keys` whose
  // top hi_bits (of the 2k-bit key domain) equal b. Shrinks the
  // per-minimizer lower_bound from ~27 cache-missing probes over the
  // full sorted key array (~1.2 GB at genome scale) to ~5 probes in a
  // <=40-key bucket — the anchors phase was 60% of mapper CPU
  // (round 5 map profile). Rebuilt at build/load; not serialized.
  std::vector<uint64_t> hi_off;
  int hi_shift = -1;
  // annotated splice junctions per target, sorted by donor: bias the
  // spliced chainer toward annotated introns and snap emitted block
  // edges (the reference feeds a junction BED into its spliced aligner,
  // main.rs:255-281)
  std::vector<int64_t> junc_off;    // n_targets + 1 (empty = no hints)
  std::vector<int32_t> junc_donor;  // intron start (0-based, exclusive exon end)
  std::vector<int32_t> junc_acc;    // intron end (next exon start)
  int32_t junc_tol = 12;
};

// Find an annotated junction whose donor is within tol of `istart` and
// whose acceptor is within tol of `iend`.
inline bool find_junction(const Index& idx, uint32_t target, int64_t istart,
                          int64_t iend, int32_t* sd, int32_t* sa) {
  if (idx.junc_off.empty()) return false;
  const int32_t tol = idx.junc_tol;
  int64_t lo = idx.junc_off[target], hi = idx.junc_off[target + 1];
  const int32_t* db = idx.junc_donor.data();
  int64_t l = lo, r = hi;
  while (l < r) {
    int64_t m = (l + r) / 2;
    if (int64_t(db[m]) < istart - tol) l = m + 1; else r = m;
  }
  for (int64_t j = l; j < hi && int64_t(db[j]) <= istart + tol; j++) {
    if (std::llabs(int64_t(idx.junc_acc[j]) - iend) <= tol) {
      *sd = db[j];
      *sa = idx.junc_acc[j];
      return true;
    }
  }
  return false;
}

inline uint64_t pack_post(uint32_t rid, uint32_t pos, uint8_t strand) {
  return (uint64_t(rid) << 33) | (uint64_t(pos) << 1) | strand;
}

// 16-byte (key, packed posting) pair: pack_post's bit layout makes
// uint64 order == (rid, pos, strand) lexicographic, so a pair sort
// reproduces the full tie-break with a third less bandwidth than
// sorting 24-byte Minimizers.
struct KP {
  uint64_t key, post;
};

// Hugepage-backed flat buffer for the index build's multi-GB minimizer
// arrays. THP here is madvise-gated; 2 MB pages cut both the ~650k
// first-touch faults per 2.6 GB and — the bigger win — TLB misses in
// the bucket scatter, whose random writes span the whole buffer
// (~1300 huge PTEs fit the STLB; 4 KB pages do not).
struct HugeBuf {
  KP* p = nullptr;
  size_t n = 0, cap = 0;
  static KP* alloc(size_t c) {
    void* m = mmap(nullptr, c * sizeof(KP), PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (m == MAP_FAILED) return nullptr;
#ifdef MADV_HUGEPAGE
    madvise(m, c * sizeof(KP), MADV_HUGEPAGE);
#endif
    return static_cast<KP*>(m);
  }
  static void release(KP* q, size_t c) {
    if (q) munmap(q, c * sizeof(KP));
  }
  void reserve(size_t c) {
    if (c <= cap) return;
    KP* np = alloc(c);
    if (!np) return;  // keep the old buffer; push() grows on demand
    if (n) memcpy(np, p, n * sizeof(KP));
    release(p, cap);
    p = np;
    cap = c;
  }
  inline void push(const KP& v) {
    if (n == cap) {
      size_t nc = cap ? cap + cap / 2 : 4096;
      KP* np = alloc(nc);
      if (!np) abort();  // allocation failure: no graceful path mid-build
      if (n) memcpy(np, p, n * sizeof(KP));
      release(p, cap);
      p = np;
      cap = nc;
    }
    p[n++] = v;
  }
  void free_all() {
    release(p, cap);
    p = nullptr;
    n = cap = 0;
  }
  ~HugeBuf() { free_all(); }
};

struct Hit {
  uint32_t target;
  uint32_t tstart, tend;   // 0-based [tstart, tend)
  uint32_t qstart, qend;
  int32_t score;
  uint8_t is_rc;
  int32_t n_anchors;
  // spliced mode: contiguous aligned blocks on the target, [s, e) 0-based.
  // Gaps between consecutive blocks are candidate introns.
  std::vector<std::pair<uint32_t, uint32_t>> blocks;
  // chain anchor (tpos, qpos) pairs, kept when base-level rescoring is on
  std::vector<std::pair<uint32_t, uint32_t>> anchors;
};

// ---------------------------------------------------------------------------
// Base-level rescoring: replace the chain-count score approximation with an
// alignment score computed against the actual bases (the reference's rammap
// reports extension-DP AS values; our chained-bases estimate was only
// statistically comparable — PARITY.md). Pieces: exact compare on the
// diagonal runs between anchors, banded affine-gap (Gotoh) DP across
// indel-containing inter-anchor segments, and banded free-end extension at
// both read ends. minimap2 map-ont-like scoring: match +2, mismatch -4,
// gap open -4, gap extend -2.
// ---------------------------------------------------------------------------

struct AlnParams {
  int32_t ma = 2, mm = 4, go = 4, ge = 2;
  int32_t band = 32;          // half-width beyond the diagonal drift
  int64_t cell_budget = 2000000;  // max DP cells per inter-anchor segment
  int32_t xlen = 512;         // end-extension window
  int32_t xdrop = 60;         // end-extension row-max drop cutoff
};

inline bool base_match(uint8_t a, uint8_t b) {
  int ca = nt4(a), cb = nt4(b);
  return ca < 4 && ca == cb;
}

inline int32_t score_diag(const uint8_t* t, const uint8_t* q, int32_t n,
                          const AlnParams& P) {
  int32_t s = 0;
  for (int32_t i = 0; i < n; i++)
    s += base_match(t[i], q[i]) ? P.ma : -P.mm;
  return s;
}

// Banded affine-gap DP of t[0..lt) vs q[0..lq). Global in both starts.
// extend_mode: free end — returns the best cell and its (i, j) extents
// with x-drop row termination; otherwise returns the (lt, lq) cell.
//
// Vectorized two-pass row recurrence (same cell values as the classic
// in-order Gotoh loop, proven by the gap-opening dominance argument):
//   pass 1 (auto-vectorizes, no intra-row deps):
//       F[c]  = max(H_up - go, F_up) - ge
//       Ht[c] = max(H_diag + sub(c), F[c])
//   pass 2 (serial scan, 3 ops/cell):
//       E[c]  = max(Ht[c-1] - go, E[c-1]) - ge
//       H[c]  = max(Ht[c], E[c])
// Using Ht (not the final H) in E's chain is exact: a gap opened FROM a
// gap cell (H[j'] == E[j']) is always dominated by extending that gap
// (go >= 0), and every extension chain bottoms out at an Ht cell.
// Row-local column c = j - i - dlo; diag = prev row same c, vertical =
// prev row c+1, horizontal = same row c-1. Arrays carry one NEG guard
// cell on each side so the c+1 reads need no branches.
int32_t banded_align(const uint8_t* t, int32_t lt, const uint8_t* q,
                     int32_t lq, const AlnParams& P, bool extend_mode,
                     int32_t* out_i = nullptr, int32_t* out_j = nullptr) {
  const int32_t NEG = INT32_MIN / 4;
  const int32_t dlo = std::min(0, lq - lt) - P.band;
  const int32_t dhi = std::max(0, lq - lt) + P.band;
  const int32_t W = dhi - dlo + 1;
  const int32_t ma = P.ma, mm = P.mm, go = P.go, ge = P.ge;

  thread_local std::vector<int32_t> bH, bF, bHn, bFn, bHt;
  thread_local std::vector<int8_t> bq4;
  // +24 slack: the AVX-512 row kernel issues full 16-lane LOADS past
  // chi (stores are masked); loads must stay in-bounds
  if ((int32_t)bH.size() < W + 24) {
    bH.resize(W + 24);
    bF.resize(W + 24);
    bHn.resize(W + 24);
    bFn.resize(W + 24);
    bHt.resize(W + 24);
  }
  if ((int32_t)bq4.size() < lq + 18) bq4.resize(lq + 18);
  // q codes shifted by one: bq4[j] is the code of q[j-1]; bq4[0] is a
  // sentinel that never matches (the j == 0 boundary cell's pass-1
  // value is overwritten, the read just has to be in bounds)
  int8_t* __restrict q4 = bq4.data();
  q4[0] = 127;
  for (int32_t j = 0; j < lq; j++) q4[j + 1] = (int8_t)nt4(q[j]);

  // index shift: array position c+1, guards at 0 and W+1..W+3
  int32_t* __restrict H = bH.data();
  int32_t* __restrict F = bF.data();
  int32_t* __restrict Hn = bHn.data();
  int32_t* __restrict Fn = bFn.data();
  int32_t* __restrict Ht = bHt.data();
  std::fill(H, H + W + 24, NEG);
  std::fill(F, F + W + 24, NEG);
  std::fill(Hn, Hn + W + 24, NEG);
  std::fill(Fn, Fn + W + 24, NEG);

  int32_t best = 0, best_i = 0, best_j = 0;
  for (int32_t j = 0; j <= std::min(lq, dhi); j++) {
    int32_t c = j - dlo;
    if (c < 0 || c >= W) continue;
    H[c + 1] = (j == 0) ? 0 : -(go + ge * j);
  }
  for (int32_t i = 1; i <= lt; i++) {
    const int32_t jbase = i + dlo;  // j at c == 0
    const int32_t clo = std::max<int32_t>(0, -jbase);
    const int32_t chi = std::min<int32_t>(W - 1, lq - jbase);
    int32_t row_best = NEG;
    if (clo <= chi) {
      const int32_t tc = nt4(t[i - 1]);
      const int8_t tcode = (tc < 4) ? (int8_t)tc : (int8_t)-1;
      const int8_t* __restrict qrow = q4 + jbase;  // qrow[c] = code(q[j-1])
      const int32_t h0 = -(go + ge * i);
#ifdef __AVX512F__
      // Fused single pass per 16-lane block: diag+F, then E through an
      // EXACT in-register inclusive prefix max with a scalar carry
      // between blocks — no lazy fix-up needed. Closed form:
      //   E[c] = max_{c'<c}(Ht[c'] - go + ge*c') - ge*c
      // so with G[c] = Ht[c] - go + ge*(c-clo) the exclusive running
      // max of G minus ge*(c-clo) is E exactly.
      {
        const __m512i vNEG = _mm512_set1_epi32(NEG);
        const __m512i vgo = _mm512_set1_epi32(go);
        const __m512i vge = _mm512_set1_epi32(ge);
        const __m512i vma = _mm512_set1_epi32(ma);
        const __m512i vmmn = _mm512_set1_epi32(-mm);
        const __m128i vtc8 = _mm_set1_epi8((char)tcode);
        const __m512i vramp = _mm512_mullo_epi32(
            _mm512_set_epi32(15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4,
                             3, 2, 1, 0),
            vge);
        __m512i vrowbest = vNEG;
        int32_t carry = NEG;
        for (int32_t c0 = clo; c0 <= chi; c0 += 16) {
          const int32_t left = chi - c0 + 1;
          const __mmask16 mk =
              left >= 16 ? (__mmask16)0xFFFF
                         : (__mmask16)((1u << left) - 1);
          const __m512i hd =
              _mm512_loadu_si512((const void*)(H + c0 + 1));
          const __m512i hu =
              _mm512_loadu_si512((const void*)(H + c0 + 2));
          const __m512i fu =
              _mm512_loadu_si512((const void*)(F + c0 + 2));
          __m512i f = _mm512_sub_epi32(
              _mm512_max_epi32(_mm512_sub_epi32(hu, vgo), fu), vge);
          const __m128i q8 =
              _mm_loadu_si128((const __m128i*)(qrow + c0));
          const __mmask16 meq = _mm_cmpeq_epi8_mask(q8, vtc8);
          const __m512i sub = _mm512_mask_blend_epi32(meq, vmmn, vma);
          __m512i ht =
              _mm512_max_epi32(_mm512_add_epi32(hd, sub), f);
          if (jbase <= 0 && c0 == clo) {
            // j == 0 boundary cell sits in lane 0 of the first block
            ht = _mm512_mask_set1_epi32(ht, 1, h0);
            f = _mm512_mask_set1_epi32(f, 1, h0);
          }
          _mm512_mask_storeu_epi32((void*)(Fn + c0 + 1), mk, f);
          ht = _mm512_mask_mov_epi32(vNEG, mk, ht);  // tail lanes inert
          const __m512i gec = _mm512_add_epi32(
              _mm512_set1_epi32(ge * (c0 - clo)), vramp);
          __m512i g = _mm512_add_epi32(_mm512_sub_epi32(ht, vgo), gec);
          g = _mm512_max_epi32(g, _mm512_alignr_epi32(g, vNEG, 15));
          g = _mm512_max_epi32(g, _mm512_alignr_epi32(g, vNEG, 14));
          g = _mm512_max_epi32(g, _mm512_alignr_epi32(g, vNEG, 12));
          g = _mm512_max_epi32(g, _mm512_alignr_epi32(g, vNEG, 8));
          const __m512i vcar = _mm512_set1_epi32(carry);
          const __m512i pfx = _mm512_max_epi32(g, vcar);
          // exclusive prefix: shift left one lane, carry enters lane 0
          const __m512i excl = _mm512_alignr_epi32(pfx, vcar, 15);
          const __m512i e = _mm512_sub_epi32(excl, gec);
          const __m512i h = _mm512_max_epi32(ht, e);
          _mm512_mask_storeu_epi32((void*)(Hn + c0 + 1), mk, h);
          vrowbest = _mm512_mask_max_epi32(vrowbest, mk, vrowbest, h);
          carry = _mm_extract_epi32(
              _mm512_extracti32x4_epi32(pfx, 3), 3);
        }
        row_best = std::max(row_best, _mm512_reduce_max_epi32(vrowbest));
      }
#else
      // pass 1: diag + F (no intra-row dependency — vectorizes)
      for (int32_t c = clo; c <= chi; c++) {
        const int32_t f =
            std::max(H[c + 2] - go, F[c + 2]) - ge;
        const int32_t sub = (qrow[c] == tcode) ? ma : -mm;
        Fn[c + 1] = f;
        Ht[c + 1] = std::max(H[c + 1] + sub, f);
      }
      // j == 0 boundary column (always c == clo when present)
      if (jbase <= 0) {
        Ht[clo + 1] = h0;
        Fn[clo + 1] = h0;
      }
      // pass 2: E scan + final H (serial, 3 ops/cell; a log-step
      // array-based prefix-max was MEASURED SLOWER at W~65)
      int32_t e = NEG, htl = NEG;
      for (int32_t c = clo; c <= chi; c++) {
        e = std::max(htl - go, e) - ge;
        const int32_t ht = Ht[c + 1];
        const int32_t h = std::max(ht, e);
        Hn[c + 1] = h;
        row_best = std::max(row_best, h);
        htl = ht;
      }
#endif
      // clear stale cells outside [clo, chi] for the next row's reads
      for (int32_t c = 0; c < clo; c++) {
        Hn[c + 1] = NEG;
        Fn[c + 1] = NEG;
      }
      for (int32_t c = chi + 1; c < W; c++) {
        Hn[c + 1] = NEG;
        Fn[c + 1] = NEG;
      }
      if (extend_mode && row_best > best) {
        for (int32_t c = clo; c <= chi; c++) {
          if (Hn[c + 1] == row_best) {
            best = row_best;
            best_i = i;
            best_j = jbase + c;
            break;
          }
        }
      }
    } else {
      std::fill(Hn, Hn + W + 2, NEG);
      std::fill(Fn, Fn + W + 2, NEG);
    }
    std::swap(H, Hn);
    std::swap(F, Fn);
    if (extend_mode && row_best < best - P.xdrop) break;
  }
  if (extend_mode) {
    if (out_i) *out_i = best_i;
    if (out_j) *out_j = best_j;
    return best;
  }
  const int32_t c_end = lq - lt - dlo;
  return (c_end >= 0 && c_end < W) ? H[c_end + 1] : NEG;
}

// Rescore one (unspliced) hit against the bases. `q` is the read in hit
// orientation (revcomp'd for is_rc). Updates score and extends the
// aligned spans with the end-extension results.
void rescore_hit(const Index& idx, Hit& h, const uint8_t* q, int32_t qlen,
                 int k, const AlnParams& P, bool verbose = false) {
  const uint8_t* tgt = idx.seqs.data() + idx.seq_off[h.target];
  int32_t tlen = int32_t(idx.lengths[h.target]);
  int64_t score = 0;
  int32_t ft = -1, fq = -1;  // aligned frontier (exclusive)
  for (auto& a : h.anchors) {
    int32_t ts = int32_t(a.first), qs = int32_t(a.second);
    int64_t score_before = score;
    if (ft < 0) {
      score += int64_t(P.ma) * k;
      ft = ts + k;
      fq = qs + k;
      continue;
    }
    int32_t dt = ts - ft, dq = qs - fq;
    if (dt == dq && dt <= 4) {
      // same-diagonal short gap/overlap: the few intervening bases are
      // exact-compared; the anchor contributes only its FRESH bases
      // (on overlap part of the k-mer was counted by the previous
      // anchor). Longer same-diagonal gaps go through the DP below —
      // zero NET drift can still hide an indel pair, and a diagonal
      // walk through one scores ~25% identity garbage.
      if (dt > 0) score += score_diag(tgt + ft, q + fq, dt, P);
      int32_t fresh = std::min(k, ts + k - ft);
      score += int64_t(P.ma) * std::max(fresh, 0);
    } else if (dt < 0 || dq < 0) {
      // crossing overlap on a different diagonal (repeat slippage):
      // count the anchor conservatively, no segment score
      score += int64_t(P.ma) * std::max(0, std::min(k, std::min(ts + k - ft, qs + k - fq)));
    } else {
      int32_t df = std::max(dt, dq) - std::min(dt, dq);
      int64_t cells =
          int64_t(std::max(dt, dq)) * (int64_t(df) + 2 * P.band + 1);
      if (cells <= P.cell_budget) {
        score += banded_align(tgt + ft, dt, q + fq, dq, P, false);
      } else {
        // beyond the cell budget: score PESSIMISTICALLY — unverified
        // bases must never award near-match-rate points, or spurious
        // chains on wrong targets outscore verified alignments
        score += int64_t(P.ma) * std::min(dt, dq) / 4 -
                 (P.go + int64_t(P.ge) * df);
      }
      score += int64_t(P.ma) * k;
    }
    if (verbose)
      fprintf(stderr, "  anchor t=%d q=%d dt=%d dq=%d -> +%lld (sum %lld)\n",
              ts, qs, ts - (ft - k), qs - (fq - k),
              (long long)(score - score_before), (long long)score);
    ft = std::max(ft, ts + k);
    fq = std::max(fq, qs + k);
  }
  // end extensions (free end toward the read ends, banded, x-drop)
  int32_t t0 = int32_t(h.anchors.front().first);
  int32_t q0 = int32_t(h.anchors.front().second);
  if (t0 > 0 && q0 > 0) {
    int32_t wt = std::min(t0, P.xlen + P.band);
    int32_t wq = std::min(q0, P.xlen);
    std::vector<uint8_t> tr(wt), qr(wq);
    for (int32_t i = 0; i < wt; i++) tr[i] = tgt[t0 - 1 - i];
    for (int32_t i = 0; i < wq; i++) qr[i] = q[q0 - 1 - i];
    int32_t bi = 0, bj = 0;
    int32_t s = banded_align(tr.data(), wt, qr.data(), wq, P, true, &bi, &bj);
    if (verbose)
      fprintf(stderr, "  left ext (wt=%d wq=%d): %d\n", wt, wq, s);
    if (s > 0) {
      score += s;
      h.tstart = uint32_t(t0 - bi);
      h.qstart = uint32_t(q0 - bj);
    }
  }
  if (ft < tlen && fq < qlen) {
    int32_t wt = std::min(tlen - ft, P.xlen + P.band);
    int32_t wq = std::min(qlen - fq, P.xlen);
    int32_t bi = 0, bj = 0;
    int32_t s = banded_align(tgt + ft, wt, q + fq, wq, P, true, &bi, &bj);
    if (verbose)
      fprintf(stderr, "  right ext (wt=%d wq=%d): %d\n", wt, wq, s);
    if (s > 0) {
      score += s;
      h.tend = uint32_t(ft + bi);
      h.qend = uint32_t(fq + bj);
    }
  }
  if (score < k) score = k;  // keep positive for the exp() weighting
  h.score = int32_t(std::min<int64_t>(score, INT32_MAX));
}

struct Anchor {
  uint32_t target;
  uint8_t strand;
  uint32_t tpos, qpos;
};

// map-time phase accumulators (per thread; summed + printed by
// oarfish_map_batch under OARFISH_MAPPER_PROF)
struct MapProf {
  double extract = 0, anchors = 0, sort = 0, chain = 0, rescore = 0;
};
thread_local MapProf g_map_prof;
thread_local bool g_map_prof_on = false;

struct ProfTick {
  double* slot;
  std::chrono::steady_clock::time_point t0;
  explicit ProfTick(double* s) : slot(s) {
    if (g_map_prof_on) t0 = std::chrono::steady_clock::now();
  }
  ~ProfTick() {
    if (g_map_prof_on)
      *slot += std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
  }
};

void map_one(const Index& idx, const uint8_t* seq, size_t len, int best_n,
             std::vector<Hit>& hits, std::vector<Minimizer>& mbuf,
             std::vector<Anchor>& abuf, bool spliced = false,
             bool rescore = false) {
  hits.clear();
  mbuf.clear();
  abuf.clear();
  {
    ProfTick t_(&g_map_prof.extract);
    extract_minimizers(seq, len, idx.k, idx.w, 0, mbuf);
  }
  if (mbuf.empty()) return;
  // collect anchors
  ProfTick* ta_ = new ProfTick(&g_map_prof.anchors);
  const bool use_hi = idx.hi_shift >= 0 && !idx.hi_off.empty();
  for (const auto& m : mbuf) {
    // binary search key (within the hi-bits bucket when available)
    const uint64_t* kb = idx.keys.data();
    const uint64_t* ke = kb + idx.keys.size();
    if (use_hi) {
      size_t b = size_t(m.key >> idx.hi_shift);
      ke = kb + idx.hi_off[b + 1];
      kb += idx.hi_off[b];
    }
    const uint64_t* it = std::lower_bound(kb, ke, m.key);
    if (it == ke || *it != m.key) continue;
    size_t ki = size_t(it - idx.keys.data());
    uint64_t lo = idx.key_off[ki], hi = idx.key_off[ki + 1];
    if (hi - lo > idx.max_occ) continue;  // repetitive seed
    for (uint64_t p = lo; p < hi; p++) {
      uint64_t v = idx.postings[p];
      uint32_t rid = uint32_t(v >> 33);
      uint32_t tpos = uint32_t((v >> 1) & 0xFFFFFFFFULL);
      uint8_t tstrand = uint8_t(v & 1);
      uint8_t rel = tstrand ^ m.strand;  // 0 = same orientation
      uint32_t q = rel ? uint32_t(len - (m.pos + idx.k)) : m.pos;
      abuf.push_back({rid, rel, tpos, q});
    }
  }
  delete ta_;
  if (abuf.empty()) return;
  {
    ProfTick t_(&g_map_prof.sort);
    std::sort(abuf.begin(), abuf.end(),
              [](const Anchor& a, const Anchor& b) {
                if (a.target != b.target) return a.target < b.target;
                if (a.strand != b.strand) return a.strand < b.strand;
                if (a.tpos != b.tpos) return a.tpos < b.tpos;
                return a.qpos < b.qpos;
              });
  }
  ProfTick* t_chain_ = new ProfTick(&g_map_prof.chain);

  // chain per (target, strand) run
  const int LOOKBACK = 48;
  // spliced (genome) chaining tolerates intron-sized target gaps with a
  // logarithmic cost; transcript-space chaining stays tight
  const int32_t MAX_GAP = spliced ? 200000 : 5000;
  const int32_t MAX_QGAP = 5000;
  const int32_t MIN_INTRON = 30;
  size_t n = abuf.size();
  std::vector<int32_t>& dp = g_scratch.dp;
  std::vector<int32_t>& pre = g_scratch.pre;
  dp.resize(n);
  pre.resize(n);
  size_t run_start = 0;
  const int k = idx.k;
  for (size_t s = 0; s <= n; s++) {
    bool flush = (s == n) || (s > run_start &&
                 (abuf[s].target != abuf[run_start].target ||
                  abuf[s].strand != abuf[run_start].strand));
    if (!flush) continue;
    // chain DP over [run_start, s)
    int32_t best_sc = 0;
    size_t best_i = run_start;
    for (size_t i = run_start; i < s; i++) {
      dp[i] = k;
      pre[i] = -1;
      size_t lb = (i >= run_start + LOOKBACK) ? i - LOOKBACK : run_start;
      for (size_t j = lb; j < i; j++) {
        int64_t dt = int64_t(abuf[i].tpos) - int64_t(abuf[j].tpos);
        int64_t dq = int64_t(abuf[i].qpos) - int64_t(abuf[j].qpos);
        if (dt <= 0 || dq <= 0 || dt > MAX_GAP || dq > MAX_QGAP) continue;
        int64_t gap = dt > dq ? dt - dq : dq - dt;
        int32_t match = int32_t(std::min<int64_t>(std::min(dt, dq), k));
        int32_t cost;
        if (spliced && gap > MIN_INTRON && dt > dq) {
          int32_t sd, sa;
          int64_t istart = int64_t(abuf[j].tpos) + k;
          if (find_junction(idx, abuf[i].target, istart, istart + gap,
                            &sd, &sa)) {
            // annotated junction: no gap penalty
            cost = 0;
          } else {
            // candidate intron: cheap logarithmic cost instead of linear
            int32_t lg = 0;
            for (int64_t g = gap; g > 0; g >>= 1) lg++;
            cost = lg;
          }
        } else {
          cost = int32_t(gap > 0 ? (gap / 50 + 1) : 0);
        }
        int32_t sc = dp[j] + match - cost;
        if (sc > dp[i]) { dp[i] = sc; pre[i] = int32_t(j); }
      }
      if (dp[i] > best_sc) { best_sc = dp[i]; best_i = i; }
    }
    if (best_sc >= k) {
      // trace back: collect the chain's anchors (reverse order)
      std::vector<size_t> chain;
      for (size_t i = best_i;; i = size_t(pre[i])) {
        chain.push_back(i);
        if (pre[i] < 0) break;
      }
      std::reverse(chain.begin(), chain.end());
      int32_t cnt = int32_t(chain.size());
      uint32_t tstart = abuf[chain.front()].tpos;
      uint32_t qstart = abuf[chain.front()].qpos;
      uint32_t tend = abuf[chain.back()].tpos + k;
      uint32_t qend = abuf[chain.back()].qpos + k;
      Hit h;
      h.target = abuf[run_start].target;
      h.tstart = tstart;
      h.tend = tend;
      h.qstart = qstart;
      h.qend = qend;
      if (spliced) {
        // split into contiguous target blocks at intron-sized gaps
        uint32_t bs = abuf[chain[0]].tpos;
        uint32_t be = abuf[chain[0]].tpos + k;
        for (size_t ci = 1; ci < chain.size(); ci++) {
          int64_t dt = int64_t(abuf[chain[ci]].tpos) -
                       int64_t(abuf[chain[ci - 1]].tpos);
          int64_t dq = int64_t(abuf[chain[ci]].qpos) -
                       int64_t(abuf[chain[ci - 1]].qpos);
          if (dt - dq > MIN_INTRON) {
            uint32_t nbs = abuf[chain[ci]].tpos;
            int32_t sd, sa;
            if (find_junction(idx, h.target, int64_t(be),
                              int64_t(be) + (dt - dq), &sd, &sa) &&
                sd > int64_t(bs) && sa > sd && uint32_t(sa) <= nbs + idx.k) {
              // snap the block edges to the annotated donor/acceptor
              be = uint32_t(sd);
              nbs = uint32_t(sa);
            }
            h.blocks.emplace_back(bs, be);
            bs = nbs;
          }
          be = std::max(be, abuf[chain[ci]].tpos + k);
        }
        h.blocks.emplace_back(bs, be);
      }
      // AS-like score: ~2 points per chained base, bounded by the spans
      int64_t covered = std::min<int64_t>(
          int64_t(h.tend) - h.tstart, int64_t(h.qend) - h.qstart);
      int64_t chained = std::min<int64_t>(best_sc, covered);
      h.score = int32_t(2 * chained);
      h.is_rc = abuf[run_start].strand;
      h.n_anchors = cnt;
      if (rescore) {
        h.anchors.reserve(chain.size());
        for (size_t ci : chain)
          h.anchors.emplace_back(abuf[ci].tpos, abuf[ci].qpos);
      }
      hits.push_back(h);
    }
    run_start = s;
  }
  // keep top best_n by score, suppressing redundant same-locus chains:
  // a chain whose target span overlaps a higher-scoring retained chain
  // on the same target by >= 50% of the shorter span is a sub-chain of
  // the same alignment locus, not an alternative mapping (minimap2
  // prunes these during chain backtracking). Without this, a partial
  // sub-chain of a spliced alignment projects onto the
  // intron-RETAINING isoform with exonic similarity 1.0 and defeats
  // the junction evidence the full chain carries
  // (scripts/genome_vs_txome_eval.py exposed per-gene isoform
  // collapse: 2436/2552 both-expressed genes).
  std::sort(hits.begin(), hits.end(),
            [](const Hit& a, const Hit& b) { return a.score > b.score; });
  {
    std::vector<Hit> keep;
    keep.reserve(std::min<size_t>(hits.size(), size_t(best_n)));
    for (auto& h : hits) {
      if (int(keep.size()) >= best_n) break;
      bool redundant = false;
      for (const auto& g : keep) {
        if (g.target != h.target) continue;
        int64_t lo = std::max<int64_t>(g.tstart, h.tstart);
        int64_t hi = std::min<int64_t>(g.tend, h.tend);
        if (hi <= lo) continue;
        int64_t span_h = int64_t(h.tend) - h.tstart;
        int64_t span_g = int64_t(g.tend) - g.tstart;
        if (2 * (hi - lo) >= std::min(span_h, span_g)) {
          redundant = true;
          break;
        }
      }
      if (!redundant) keep.push_back(std::move(h));
    }
    hits.swap(keep);
  }

  delete t_chain_;
  ProfTick t_rescore_(&g_map_prof.rescore);
  if (rescore && !spliced && !hits.empty()) {
    // base-level rescoring of the retained candidates (chain order may
    // change: re-sort after)
    AlnParams P;
    std::vector<uint8_t> rc;
    // hits are chain-score-sorted; a hit below half the best chain
    // score cannot reach the 0.95 relative-score filter even after
    // rescoring (rescored and chain scores share the ~2/base scale),
    // so skip its base-level DP — at genome scale the spurious short
    // chains best_n lets through were most of the rescore CPU
    const int32_t chain_gate = hits.front().score / 2;
    for (auto& h : hits) {
      if (h.score < chain_gate) continue;
      const uint8_t* q = seq;
      if (h.is_rc) {
        if (rc.empty()) {
          rc.resize(len);
          for (size_t i = 0; i < len; i++) {
            int c = nt4(seq[len - 1 - i]);
            rc[i] = (c < 4) ? uint8_t("ACGT"[3 - c]) : uint8_t('N');
          }
        }
        q = rc.data();
      }
      rescore_hit(idx, h, q, int32_t(len), idx.k, P);
    }
    std::sort(hits.begin(), hits.end(),
              [](const Hit& a, const Hit& b) { return a.score > b.score; });
  }
}

}  // namespace

extern "C" {

struct OarfishIndex;  // opaque

struct OarfishMapResult {
  int64_t n_hits;            // total hits across reads
  int64_t* read_off;         // n_reads + 1
  int32_t* target;           // per hit
  int64_t* tstart;           // 0-based
  int64_t* tend;             // exclusive
  int64_t* qstart;
  int64_t* qend;
  int32_t* score;
  uint8_t* is_rc;
  // spliced mode: aligned target blocks per hit ([s, e) 0-based)
  int64_t n_blocks;
  int64_t* block_off;        // n_hits + 1 (null when not spliced)
  int64_t* block_s;
  int64_t* block_e;
};

struct IndexHandle {
  Index idx;
};

// build the hi-bits bucket table (see Index::hi_off)
void build_hi_index(Index& idx) {
  int kbits = idx.k < 32 ? 2 * idx.k : 64;
  int hb = kbits < 22 ? kbits : 22;
  idx.hi_shift = kbits - hb;
  size_t nb = size_t(1) << hb;
  idx.hi_off.assign(nb + 1, 0);
  for (uint64_t key : idx.keys) idx.hi_off[(key >> idx.hi_shift) + 1]++;
  for (size_t b = 0; b < nb; b++) idx.hi_off[b + 1] += idx.hi_off[b];
}

// Build an index over concatenated target sequences.
// seqs: all bases concatenated; offsets: n_targets+1; names: \0-separated.
void* oarfish_index_build(const char* seqs, const int64_t* offsets,
                          int64_t n_targets, const char* names, int k, int w,
                          int threads, double freq_cutoff_frac) {
  auto* h = new IndexHandle();
  Index& idx = h->idx;
  idx.k = k;
  idx.w = w;
  idx.n_targets = uint32_t(n_targets);
  idx.seq_off.assign(offsets, offsets + n_targets + 1);
  idx.seqs.assign(reinterpret_cast<const uint8_t*>(seqs),
                  reinterpret_cast<const uint8_t*>(seqs) + offsets[n_targets]);
  const char* np = names;
  for (int64_t i = 0; i < n_targets; i++) {
    idx.names.emplace_back(np);
    np += idx.names.back().size() + 1;
    idx.lengths.push_back(uint32_t(offsets[i + 1] - offsets[i]));
  }
  // extract minimizers (parallel over targets)
  const bool prof = getenv("OARFISH_MAPPER_PROF") != nullptr;
  auto now_s = [] {
    return double(std::chrono::duration_cast<std::chrono::microseconds>(
                      std::chrono::steady_clock::now().time_since_epoch())
                      .count()) *
           1e-6;
  };
  double t_ex = now_s();
  int nt = threads > 0 ? threads : 1;
  // extraction emits 16-byte KP pairs directly (no intermediate 24-byte
  // Minimizer array) and counts bucket occupancy inline — this folds
  // the old standalone counting pass (a full re-read of ~3.8 GB at
  // genome scale) into the emit and cuts the scatter's source traffic
  // by a third (round 5, VERDICT item 5).
  constexpr int NBBITS = 12;  // ~40k-entry buckets at genome scale:
                              // per-bucket sorts stay cache-resident
  constexpr int NB = 1 << NBBITS;
  const int bshift =
      (k < 32) ? (2 * k > NBBITS ? 2 * k - NBBITS : 0) : 64 - NBBITS;
  std::vector<HugeBuf> parts(nt);
  std::vector<std::vector<uint64_t>> cnt(nt,
                                         std::vector<uint64_t>(NB, 0));
  {
    // pre-reserve ~minimizer density 2/(w+1) of this thread's share
    // (realloc-copying a multi-GB tail dominated page-fault time)
    size_t est = size_t(double(offsets[n_targets]) * 2.2 /
                        double(w + 1) / nt) + 1024;
    for (int t = 0; t < nt; t++) parts[t].reserve(est);
  }
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; t++) {
    pool.emplace_back([&, t] {
      auto& out = parts[t];
      auto& c = cnt[t];
      int64_t i;
      while ((i = next.fetch_add(1)) < n_targets) {
        uint32_t rid = uint32_t(i);
        extract_minimizers_t(
            idx.seqs.data() + idx.seq_off[i],
            size_t(idx.seq_off[i + 1] - idx.seq_off[i]), k, w,
            [&](uint64_t key, uint32_t pos, uint8_t strand) {
              out.push({key, pack_post(rid, pos, strand)});
              c[key >> bshift]++;
            });
      }
    });
  }
  for (auto& th : pool) th.join();
  if (prof) fprintf(stderr, "mapper-prof extract %.3fs\n", now_s() - t_ex);
  t_ex = now_s();
  size_t total = 0;
  for (auto& pvec : parts) total += pvec.n;
  // Bucketed parallel sort (at genome scale a serial std::sort over
  // ~150M 24-byte minimizers plus push_back postings assembly was the
  // index-build bottleneck). hash64 keys are uniform over [0, 2^2k), so
  // 4096 buckets by the top NBBITS=12 bits of the 2k-bit key domain
  // balance well; bucket-major order preserves the global key sort the
  // chainer's lower_bound relies on. Postings within a key are fully
  // ordered (rid, pos, strand) — deterministic for every thread count,
  // unlike the old concatenation order.
  auto parallel_for = [&](auto&& body) {
    std::vector<std::thread> ws;
    for (int t = 0; t < nt; t++) ws.emplace_back(body, t);
    for (auto& th : ws) th.join();
  };
  // region offsets: bucket-major, part-minor
  std::vector<uint64_t> boff(NB + 1, 0);
  std::vector<std::vector<uint64_t>> poff(nt,
                                          std::vector<uint64_t>(NB, 0));
  uint64_t acc = 0;
  for (int b = 0; b < NB; b++) {
    boff[b] = acc;
    for (int t = 0; t < nt; t++) {
      poff[t][b] = acc;
      acc += cnt[t][b];
    }
  }
  boff[NB] = acc;
  // raw hugepage-backed buffer, uninitialized (a vector would memset
  // ~2.6 GB the scatter immediately overwrites)
  KP* all = HugeBuf::alloc(total ? total : 1);
  if (!all) {
    delete h;
    return nullptr;
  }
  parallel_for([&](int t) {
    auto& off = poff[t];
    const KP* q = parts[t].p;
    for (size_t i = 0; i < parts[t].n; i++)
      all[off[q[i].key >> bshift]++] = q[i];
    parts[t].free_all();
  });
  if (prof) {
    fprintf(stderr, "mapper-prof   scatter %.3fs\n", now_s() - t_ex);
    t_ex = now_s();
  }
  std::atomic<int> next_b{0};
  std::vector<uint64_t> bkeys(NB, 0);  // unique keys per bucket
  idx.postings.resize(total);
  parallel_for([&](int) {
    int b;
    while ((b = next_b.fetch_add(1)) < NB) {
      std::sort(all + boff[b], all + boff[b + 1],
                [](const KP& a, const KP& c) {
                  if (a.key != c.key) return a.key < c.key;
                  return a.post < c.post;
                });
      // fill postings + count unique keys while the bucket is hot
      uint64_t nk = 0;
      for (uint64_t i = boff[b]; i < boff[b + 1]; i++) {
        if (i == boff[b] || all[i].key != all[i - 1].key) nk++;
        idx.postings[i] = all[i].post;  // postings order == sorted order
      }
      bkeys[b] = nk;
    }
  });
  if (prof) {
    fprintf(stderr, "mapper-prof   sort+postings %.3fs\n", now_s() - t_ex);
    t_ex = now_s();
  }
  std::vector<uint64_t> koff(NB + 1, 0);
  for (int b = 0; b < NB; b++) koff[b + 1] = koff[b] + bkeys[b];
  idx.keys.resize(koff[NB]);
  idx.key_off.resize(koff[NB] + 1);
  next_b.store(0);
  parallel_for([&](int) {
    int b;
    while ((b = next_b.fetch_add(1)) < NB) {
      uint64_t kpos = koff[b];
      for (uint64_t i = boff[b]; i < boff[b + 1]; i++) {
        if (i == boff[b] || all[i].key != all[i - 1].key) {
          idx.keys[kpos] = all[i].key;
          idx.key_off[kpos] = i;
          kpos++;
        }
      }
    }
  });
  idx.key_off[koff[NB]] = total;
  HugeBuf::release(all, total ? total : 1);
  if (prof) fprintf(stderr, "mapper-prof sort+assemble %.3fs\n", now_s() - t_ex);
  // frequency cutoff: drop the top freq_cutoff_frac most frequent keys
  // (O(n) quantile via nth_element; a full sort of ~100M occs is waste)
  std::vector<uint64_t> occ(idx.keys.size());
  for (size_t i = 0; i < idx.keys.size(); i++)
    occ[i] = idx.key_off[i + 1] - idx.key_off[i];
  if (occ.empty()) {
    idx.max_occ = UINT32_MAX;
  } else {
    size_t cut_idx = std::min(
        size_t(double(occ.size()) * (1.0 - freq_cutoff_frac)),
        occ.size() - 1);
    std::nth_element(occ.begin(), occ.begin() + cut_idx, occ.end());
    idx.max_occ = uint32_t(std::max<uint64_t>(occ[cut_idx], 10));
  }
  build_hi_index(idx);
  return h;
}

void oarfish_index_free(void* h) { delete static_cast<IndexHandle*>(h); }

// --dp-cache-cap-mb: cap the per-worker-thread scratch memory retained
// across reads (reference: RAMMAP_DP_CACHE_CAP_MB, default 128 MB per
// thread, Cargo.toml:84-87). mb <= 0 restores the default.
void oarfish_set_dp_cache_cap_mb(int64_t mb) {
  g_scratch_cap_bytes.store(mb > 0 ? mb * (1ll << 20) : (128ll << 20),
                            std::memory_order_relaxed);
}

// Load annotated splice junctions (per-target arrays sorted by donor).
void oarfish_index_set_junctions(void* h, const int64_t* off,
                                 const int32_t* donor, const int32_t* acc,
                                 int32_t tol) {
  auto& idx = static_cast<IndexHandle*>(h)->idx;
  idx.junc_off.assign(off, off + idx.n_targets + 1);
  int64_t n = off[idx.n_targets];
  idx.junc_donor.assign(donor, donor + n);
  idx.junc_acc.assign(acc, acc + n);
  idx.junc_tol = tol;
}

int64_t oarfish_index_num_targets(void* h) {
  return static_cast<IndexHandle*>(h)->idx.n_targets;
}

// Map a batch of reads (concatenated bases + offsets). Caller frees with
// oarfish_map_result_free.
OarfishMapResult* oarfish_map_batch(void* hptr, const char* seqs,
                                    const int64_t* offsets, int64_t n_reads,
                                    int best_n, int threads, int spliced,
                                    int rescore) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  int nt = threads > 0 ? threads : 1;
  const bool mprof = getenv("OARFISH_MAPPER_PROF") != nullptr;
  std::mutex prof_mu;
  MapProf prof_sum;
  std::vector<std::vector<Hit>> per_read(n_reads);
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; t++) {
    pool.emplace_back([&] {
      std::vector<Hit> hits;
      std::vector<Minimizer> mbuf;
      std::vector<Anchor> abuf;
      g_map_prof_on = mprof;
      int64_t i;
      while ((i = next.fetch_add(1)) < n_reads) {
        map_one(idx, reinterpret_cast<const uint8_t*>(seqs) + offsets[i],
                size_t(offsets[i + 1] - offsets[i]), best_n, hits, mbuf,
                abuf, spliced != 0, rescore != 0);
        per_read[i] = std::move(hits);  // map_one clears it on entry
        // per-thread scratch cap (--dp-cache-cap-mb): count the
        // batch-local buffers too and release everything when over
        size_t local = mbuf.capacity() * sizeof(Minimizer) +
                       abuf.capacity() * sizeof(Anchor) +
                       hits.capacity() * sizeof(Hit);
        int64_t cap = g_scratch_cap_bytes.load(std::memory_order_relaxed);
        if (int64_t(g_scratch.bytes() + local) > cap) {
          g_scratch.trim_to_cap();
          std::vector<Minimizer>().swap(mbuf);
          std::vector<Anchor>().swap(abuf);
          std::vector<Hit>().swap(hits);
        }
      }
      if (mprof) {
        std::lock_guard<std::mutex> lk(prof_mu);
        prof_sum.extract += g_map_prof.extract;
        prof_sum.anchors += g_map_prof.anchors;
        prof_sum.sort += g_map_prof.sort;
        prof_sum.chain += g_map_prof.chain;
        prof_sum.rescore += g_map_prof.rescore;
        g_map_prof = MapProf();
      }
    });
  }
  for (auto& th : pool) th.join();
  if (mprof)
    fprintf(stderr,
            "mapper-prof map cpu-s: extract %.2f anchors %.2f sort %.2f "
            "chain %.2f rescore %.2f (reads %lld)\n",
            prof_sum.extract, prof_sum.anchors, prof_sum.sort,
            prof_sum.chain, prof_sum.rescore, (long long)n_reads);

  auto* res = static_cast<OarfishMapResult*>(calloc(1, sizeof(OarfishMapResult)));
  int64_t total = 0;
  res->read_off = static_cast<int64_t*>(malloc((n_reads + 1) * sizeof(int64_t)));
  for (int64_t i = 0; i < n_reads; i++) {
    res->read_off[i] = total;
    total += int64_t(per_read[i].size());
  }
  res->read_off[n_reads] = total;
  res->n_hits = total;
  res->target = static_cast<int32_t*>(malloc(total * 4));
  res->tstart = static_cast<int64_t*>(malloc(total * 8));
  res->tend = static_cast<int64_t*>(malloc(total * 8));
  res->qstart = static_cast<int64_t*>(malloc(total * 8));
  res->qend = static_cast<int64_t*>(malloc(total * 8));
  res->score = static_cast<int32_t*>(malloc(total * 4));
  res->is_rc = static_cast<uint8_t*>(malloc(total));
  int64_t total_blocks = 0;
  if (spliced) {
    for (int64_t i = 0; i < n_reads; i++)
      for (auto& h : per_read[i]) total_blocks += int64_t(h.blocks.size());
    res->n_blocks = total_blocks;
    res->block_off =
        static_cast<int64_t*>(malloc((total + 1) * sizeof(int64_t)));
    res->block_s = static_cast<int64_t*>(malloc(total_blocks * 8));
    res->block_e = static_cast<int64_t*>(malloc(total_blocks * 8));
  }
  int64_t o = 0, bo = 0;
  for (int64_t i = 0; i < n_reads; i++) {
    for (auto& h : per_read[i]) {
      res->target[o] = int32_t(h.target);
      res->tstart[o] = h.tstart;
      res->tend[o] = h.tend;
      res->qstart[o] = h.qstart;
      res->qend[o] = h.qend;
      res->score[o] = h.score;
      res->is_rc[o] = h.is_rc;
      if (spliced) {
        res->block_off[o] = bo;
        for (auto& b : h.blocks) {
          res->block_s[bo] = b.first;
          res->block_e[bo] = b.second;
          bo++;
        }
      }
      o++;
    }
  }
  if (spliced) res->block_off[total] = bo;
  return res;
}

// Debug export: map one read with rescoring, tracing every per-anchor
// segment contribution to stderr.
void oarfish_dbg_rescore_read(void* hptr, const char* seq, int64_t len,
                              int best_n) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  std::vector<Hit> hits;
  std::vector<Minimizer> mbuf;
  std::vector<Anchor> abuf;
  map_one(idx, reinterpret_cast<const uint8_t*>(seq), size_t(len), best_n,
          hits, mbuf, abuf, false, true);
  AlnParams P;
  std::vector<uint8_t> rc;
  for (auto& h : hits) {
    fprintf(stderr, "hit %s t[%u,%u) q[%u,%u) rc=%d chain_score=%d "
            "n_anchors=%d\n",
            idx.names[h.target].c_str(), h.tstart, h.tend, h.qstart,
            h.qend, int(h.is_rc), h.score, h.n_anchors);
    const uint8_t* q = reinterpret_cast<const uint8_t*>(seq);
    if (h.is_rc) {
      if (rc.empty()) {
        rc.resize(len);
        for (int64_t i = 0; i < len; i++) {
          int c = nt4(uint8_t(seq[len - 1 - i]));
          rc[i] = (c < 4) ? uint8_t("ACGT"[3 - c]) : uint8_t('N');
        }
      }
      q = rc.data();
    }
    Hit copy = h;
    rescore_hit(idx, copy, q, int32_t(len), idx.k, P, true);
    fprintf(stderr, "  => rescored %d\n", copy.score);
  }
}

// Debug/test export: banded affine alignment score of two base strings
// (extend_mode: free-end best cell). Differential-tested against a NumPy
// Needleman/Gotoh oracle in tests/test_mapper.py.
int32_t oarfish_dbg_align(const char* t, int32_t lt, const char* q,
                          int32_t lq, int extend_mode) {
  AlnParams P;
  return banded_align(reinterpret_cast<const uint8_t*>(t), lt,
                      reinterpret_cast<const uint8_t*>(q), lq, P,
                      extend_mode != 0);
}

void oarfish_map_result_free(OarfishMapResult* r) {
  if (!r) return;
  free(r->read_off);
  free(r->target);
  free(r->tstart);
  free(r->tend);
  free(r->qstart);
  free(r->qend);
  free(r->score);
  free(r->is_rc);
  free(r->block_off);
  free(r->block_s);
  free(r->block_e);
  free(r);
}

// ---- index persistence (own binary format, "OTMI"); the OARFISHSIG
// digest footer is appended by the Python layer (digest_utils parity).
int oarfish_index_save(void* hptr, const char* path) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  bool werr = false;
  auto W = [&](const void* p, size_t nbytes) {
    if (fwrite(p, 1, nbytes, f) != nbytes) werr = true;
  };
  const char magic[8] = {'O', 'T', 'M', 'I', '\x01', 0, 0, 0};
  W(magic, 8);
  int32_t kw[2] = {idx.k, idx.w};
  W(kw, 8);
  uint64_t nt = idx.n_targets;
  W(&nt, 8);
  for (auto& s : idx.names) {
    uint32_t l = uint32_t(s.size());
    W(&l, 4);
    W(s.data(), l);
  }
  W(idx.lengths.data(), idx.lengths.size() * 4);
  uint64_t so = idx.seq_off.size();
  W(&so, 8);
  W(idx.seq_off.data(), so * 8);
  uint64_t sl = idx.seqs.size();
  W(&sl, 8);
  W(idx.seqs.data(), sl);
  uint64_t nk = idx.keys.size();
  W(&nk, 8);
  W(idx.keys.data(), nk * 8);
  W(idx.key_off.data(), (nk + 1) * 8);
  uint64_t np = idx.postings.size();
  W(&np, 8);
  W(idx.postings.data(), np * 8);
  W(&idx.max_occ, 4);
  if (fclose(f) != 0) werr = true;
  if (werr) {
    remove(path);  // never leave a truncated index behind
    return -2;
  }
  return 0;
}

// Read ONLY the name table from an OTMI header (ms vs the full load):
// lets the genome driver start the g2t build under the index load.
// Returns a malloc'd \0-joined blob (caller frees with free()); n_out
// gets the target count, blob_len_out the blob size. nullptr on any
// read problem.
char* oarfish_index_peek_names(const char* path, int64_t* n_out,
                               int64_t* blob_len_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto R = [&](void* p, size_t nbytes) -> bool {
    return fread(p, 1, nbytes, f) == nbytes;
  };
  char magic[8];
  int32_t kw[2];
  uint64_t nt;
  if (!R(magic, 8) || memcmp(magic, "OTMI\x01", 5) != 0 || !R(kw, 8) ||
      !R(&nt, 8) || nt > (1ull << 40)) {
    fclose(f);
    return nullptr;
  }
  std::string blob;
  for (uint64_t i = 0; i < nt; i++) {
    uint32_t l;
    if (!R(&l, 4) || l > (1u << 28)) {
      fclose(f);
      return nullptr;
    }
    size_t off = blob.size();
    blob.resize(off + l + 1);
    if (!R(blob.data() + off, l)) {
      fclose(f);
      return nullptr;
    }
    blob[off + l] = '\0';
  }
  fclose(f);
  char* out = static_cast<char*>(malloc(blob.size() ? blob.size() : 1));
  memcpy(out, blob.data(), blob.size());
  *n_out = int64_t(nt);
  *blob_len_out = int64_t(blob.size());
  return out;
}

void oarfish_free_blob(char* p) { free(p); }

void* oarfish_index_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* h = new IndexHandle();
  Index& idx = h->idx;
  auto R = [&](void* p, size_t nbytes) -> bool {
    return fread(p, 1, nbytes, f) == nbytes;
  };
  char magic[8];
  if (!R(magic, 8) || memcmp(magic, "OTMI\x01", 5) != 0) {
    fclose(f);
    delete h;
    return nullptr;
  }
  // every read checked: a truncated/corrupt index must return nullptr
  // (ctypes turns that into a clean Python error), never feed garbage
  // sizes into resize() or leave fields uninitialized. Size fields are
  // sanity-bounded by the remaining file length.
  auto fail = [&]() {
    fclose(f);
    delete h;
    return nullptr;
  };
  long here = ftell(f);
  fseek(f, 0, SEEK_END);
  long fend = ftell(f);
  fseek(f, here, SEEK_SET);
  const uint64_t remaining = uint64_t(fend - here);
  int32_t kw[2];
  if (!R(kw, 8)) return fail();
  idx.k = kw[0];
  idx.w = kw[1];
  uint64_t nt;
  if (!R(&nt, 8)) return fail();
  if (nt > remaining) return fail();
  idx.n_targets = uint32_t(nt);
  for (uint64_t i = 0; i < nt; i++) {
    uint32_t l;
    if (!R(&l, 4)) return fail();
    if (uint64_t(l) > remaining) return fail();
    std::string s(l, 0);
    if (!R(s.data(), l)) return fail();
    idx.names.push_back(std::move(s));
  }
  idx.lengths.resize(nt);
  if (!R(idx.lengths.data(), nt * 4)) return fail();
  uint64_t so;
  if (!R(&so, 8)) return fail();
  if (so > remaining / 8) return fail();
  idx.seq_off.resize(so);
  if (!R(idx.seq_off.data(), so * 8)) return fail();
  uint64_t sl;
  if (!R(&sl, 8)) return fail();
  if (sl > remaining) return fail();
  idx.seqs.resize(sl);
  if (!R(idx.seqs.data(), sl)) return fail();
  uint64_t nk;
  if (!R(&nk, 8)) return fail();
  if (nk > remaining / 8) return fail();
  idx.keys.resize(nk);
  if (!R(idx.keys.data(), nk * 8)) return fail();
  idx.key_off.resize(nk + 1);
  if (!R(idx.key_off.data(), (nk + 1) * 8)) return fail();
  uint64_t np;
  if (!R(&np, 8)) return fail();
  if (np > remaining / 8) return fail();
  idx.postings.resize(np);
  if (!R(idx.postings.data(), np * 8)) return fail();
  if (!R(&idx.max_occ, 4)) return fail();
  fclose(f);
  build_hi_index(idx);
  return h;
}

// target metadata accessors for the Python layer
int64_t oarfish_index_names_len(void* hptr) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  int64_t total = 0;
  for (auto& s : idx.names) total += int64_t(s.size()) + 1;
  return total;
}

void oarfish_index_get_meta(void* hptr, char* names_out, int64_t* lengths_out,
                            int32_t* kw_out) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  char* np = names_out;
  for (size_t i = 0; i < idx.names.size(); i++) {
    memcpy(np, idx.names[i].data(), idx.names[i].size());
    np += idx.names[i].size();
    *np++ = '\0';
    lengths_out[i] = idx.lengths[i];
  }
  kw_out[0] = idx.k;
  kw_out[1] = idx.w;
}

// Embedded target sequences (the index stores them for alignment
// rescoring): total concatenated length, then a copy-out of bases +
// per-target offsets. Lets the genome driver accept a prebuilt index
// via --genome (the reference's --genome takes "a genome FASTA or
// prebuilt genome index", prog_opts.rs:335) and still build its
// soft-clip RescueDb from the index's own sequences.
int64_t oarfish_index_seqs_len(void* hptr) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  return int64_t(idx.seqs.size());
}

void oarfish_index_get_seqs(void* hptr, char* seqs_out,
                            int64_t* offsets_out) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  memcpy(seqs_out, idx.seqs.data(), idx.seqs.size());
  for (size_t i = 0; i < idx.seq_off.size(); i++)
    offsets_out[i] = idx.seq_off[i];
}

// Copy + uppercase in one multithreaded pass (the projection engine's
// rescue blob wants the index's embedded genome uppercased; doing it
// host-side in NumPy costs two extra passes over ~1 GB).
void oarfish_index_get_seqs_upper(void* hptr, char* seqs_out,
                                  int64_t* offsets_out, int threads) {
  auto& idx = static_cast<IndexHandle*>(hptr)->idx;
  const uint8_t* src = idx.seqs.data();
  size_t n = idx.seqs.size();
  int nt = threads > 0 ? threads : 1;
  size_t chunk = (n + size_t(nt) - 1) / size_t(nt);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; t++) {
    size_t lo = size_t(t) * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (size_t i = lo; i < hi; i++) {
        uint8_t c = src[i];
        seqs_out[i] = char(c - (uint8_t(c - 'a') <= 25 ? 32 : 0));
      }
    });
  }
  for (auto& th : pool) th.join();
  for (size_t i = 0; i < idx.seq_off.size(); i++)
    offsets_out[i] = idx.seq_off[i];
}

}  // extern "C"
