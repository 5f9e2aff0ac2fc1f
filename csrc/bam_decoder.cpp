// Host-side streaming BAM decoder: multithreaded BGZF inflate + columnar
// record extraction.
//
// Replacement for the reference's noodles-bam/noodles-bgzf ingest
// path (reference: src/alignment_parser.rs:301-437 record streaming;
// noodles multithreaded bgzf, main.rs:408-414). Responsibilities here are
// deliberately narrow: inflate, decode the fields the quantifier needs
// (name grouping, flags, ref id, position, CIGAR reference span, sequence
// length, AS score, CB barcode), verify name-collation, and hand columnar
// arrays to Python where the vectorized filter + CSR pack run.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC bam_decoder.cpp
//        -o liboarfish_host.so -lz -pthread

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <zlib.h>

#if __has_include(<libdeflate.h>)
#include <libdeflate.h>
#else
// zlib-only build: the subset of libdeflate's API this file uses, as a
// raw-deflate zlib stream (slower, same results)
struct libdeflate_decompressor {
  z_stream zs;
};
enum { LIBDEFLATE_SUCCESS = 0, LIBDEFLATE_BAD_DATA = 1 };
static libdeflate_decompressor* libdeflate_alloc_decompressor() {
  auto* d = new libdeflate_decompressor();
  memset(&d->zs, 0, sizeof(d->zs));
  if (inflateInit2(&d->zs, -15) != Z_OK) {
    delete d;
    return nullptr;
  }
  return d;
}
static void libdeflate_free_decompressor(libdeflate_decompressor* d) {
  if (d == nullptr) return;
  inflateEnd(&d->zs);
  delete d;
}
static int libdeflate_deflate_decompress(libdeflate_decompressor* d,
                                         const void* in, size_t in_len,
                                         void* out, size_t out_avail,
                                         size_t* actual) {
  if (d == nullptr || inflateReset(&d->zs) != Z_OK) return LIBDEFLATE_BAD_DATA;
  d->zs.next_in = (Bytef*)in;
  d->zs.avail_in = (uInt)in_len;
  d->zs.next_out = (Bytef*)out;
  d->zs.avail_out = (uInt)out_avail;
  int rc = inflate(&d->zs, Z_FINISH);
  *actual = out_avail - d->zs.avail_out;
  return rc == Z_STREAM_END ? LIBDEFLATE_SUCCESS : LIBDEFLATE_BAD_DATA;
}
#endif

namespace {

// Phase timing to stderr when OARFISH_DECODE_TIMING is set.
struct PhaseTimer {
  bool on = getenv("OARFISH_DECODE_TIMING") != nullptr;
  std::chrono::steady_clock::time_point t0 = std::chrono::steady_clock::now();
  void mark(const char* what) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    fprintf(stderr, "[decode] %-10s %7.1f ms\n", what,
            std::chrono::duration<double, std::milli>(t1 - t0).count());
    t0 = t1;
  }
};

}  // namespace

namespace {

struct Block {
  size_t in_off;
  size_t in_size;   // total member size
  size_t out_off;
  size_t out_size;  // ISIZE
};

bool scan_blocks(const uint8_t* data, size_t n, std::vector<Block>& blocks,
                 size_t& total_out, std::string& err) {
  size_t pos = 0;
  total_out = 0;
  while (pos < n) {
    if (pos + 18 > n || data[pos] != 0x1f || data[pos + 1] != 0x8b) {
      err = "bad gzip magic at offset " + std::to_string(pos);
      return false;
    }
    uint8_t flg = data[pos + 3];
    if (!(flg & 0x04)) {
      err = "gzip member without FEXTRA; not a BGZF file";
      return false;
    }
    uint16_t xlen;
    memcpy(&xlen, data + pos + 10, 2);
    size_t xpos = pos + 12, xend = xpos + xlen;
    if (xend > n) {
      err = "truncated BGZF FEXTRA field";
      return false;
    }
    size_t bsize = 0;
    while (xpos + 4 <= xend) {
      uint8_t si1 = data[xpos], si2 = data[xpos + 1];
      uint16_t slen;
      memcpy(&slen, data + xpos + 2, 2);
      if (si1 == 'B' && si2 == 'C' && slen == 2 && xpos + 6 <= xend) {
        uint16_t bs;
        memcpy(&bs, data + xpos + 4, 2);
        bsize = size_t(bs) + 1;
      }
      xpos += 4 + slen;
    }
    // the compressed payload sits between the FEXTRA field and the
    // 8-byte CRC/ISIZE trailer: bsize must cover header + trailer or
    // the inflate-side length arithmetic underflows
    if (!bsize || pos + bsize > n || bsize < 12 + size_t(xlen) + 8) {
      err = "BGZF block missing/invalid BC subfield";
      return false;
    }
    uint32_t isize;
    memcpy(&isize, data + pos + bsize - 4, 4);
    blocks.push_back({pos, bsize, total_out, isize});
    total_out += isize;
    pos += bsize;
  }
  return true;
}

// libdeflate raw-deflate decompress (~3x zlib); one reusable
// decompressor per worker thread.
bool inflate_block(const uint8_t* src, const Block& b, uint8_t* dst,
                   libdeflate_decompressor* dec) {
  uint16_t xlen;
  memcpy(&xlen, src + b.in_off + 10, 2);
  const uint8_t* comp = src + b.in_off + 12 + xlen;
  size_t comp_len = b.in_size - 12 - xlen - 8;
  if (b.out_size == 0) return true;
  size_t actual = 0;
  auto rc = libdeflate_deflate_decompress(dec, comp, comp_len,
                                          dst + b.out_off, b.out_size,
                                          &actual);
  return rc == LIBDEFLATE_SUCCESS && actual == b.out_size;
}

// CIGAR ops consuming the reference: M(0) D(2) N(3) =(7) X(8)
inline bool consumes_ref(uint32_t op) {
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}

struct Columns {
  std::vector<int64_t> group_id;
  std::vector<uint16_t> flag;
  std::vector<int32_t> ref_id;
  std::vector<int64_t> pos;
  std::vector<int64_t> ref_span;
  std::vector<int64_t> seq_len;
  std::vector<int64_t> score;
  std::vector<uint8_t> has_score;
  std::vector<int64_t> cb_id;  // barcode id per record (-1 if no CB)
};

}  // namespace

extern "C" {

struct OarfishDecoded {
  int64_t n_records;
  int64_t n_groups;
  int64_t n_refs;
  int64_t num_unmapped;
  int64_t* group_id;
  uint16_t* flag;
  int32_t* ref_id;
  int64_t* pos;
  int64_t* ref_span;
  int64_t* seq_len;
  int64_t* score;
  uint8_t* has_score;
  int64_t* cb_id;
  // header
  char* header_text;
  int64_t header_text_len;
  char* ref_names;  // \0-separated, n_refs entries
  int64_t ref_names_len;
  int64_t* ref_lengths;
  // group head names (\0-separated, n_groups entries) when requested
  char* group_names;
  int64_t group_names_len;
  // distinct barcodes (\0-separated) in first-seen order, when present
  char* barcodes;
  int64_t barcodes_len;
  int64_t n_barcodes;
  // status
  char* error;  // malloc'd message on failure (all arrays null then)
  char* dup_name;  // set when the collation check failed
  // streaming API: nonzero on the last chunk of a stream (whole-file
  // decodes always set it)
  int64_t is_final;
};

void oarfish_decoded_free(OarfishDecoded* d) {
  if (!d) return;
  free(d->group_id);
  free(d->flag);
  free(d->ref_id);
  free(d->pos);
  free(d->ref_span);
  free(d->seq_len);
  free(d->score);
  free(d->has_score);
  free(d->cb_id);
  free(d->header_text);
  free(d->ref_names);
  free(d->ref_lengths);
  free(d->group_names);
  free(d->barcodes);
  free(d->error);
  free(d->dup_name);
  free(d);
}

}  // extern "C" (reopened below)

static OarfishDecoded* make_error(const std::string& msg) {
  auto* d = static_cast<OarfishDecoded*>(calloc(1, sizeof(OarfishDecoded)));
  d->error = strdup(msg.c_str());
  return d;
}

template <typename T>
static T* steal(std::vector<T>& v) {
  T* p = static_cast<T*>(malloc(v.size() * sizeof(T)));
  memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}
struct Part {
  Columns c;
  std::string names_blob;          // group-head names, \0-separated
  std::vector<size_t> name_off;    // offsets into names_blob (per group)
  std::vector<std::string> bc_order;  // local barcodes, first-seen
  int64_t num_unmapped = 0;
  int64_t n_groups = 0;
  std::string last_name;           // name of the final group (if any)
  bool parse_error = false;
};

// Parallel field extraction over contiguous record ranges of one
// window buffer. Grouping is local to each part; the sequential merge
// stitches name groups across part (and window) boundaries.
static bool scan_records(const uint8_t* p,
                         const std::vector<size_t>& rec_offs,
                         int threads, int want_barcodes,
                         int64_t /*unused*/, std::vector<Part>& parts) {
  int64_t n_recs = int64_t(rec_offs.size());
  int nt = threads > 0 ? threads : 1;
  if (nt > 16) nt = 16;
  if (n_recs < 4096) nt = 1;
  parts.assign(size_t(nt), Part());
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; t++) {
      pool.emplace_back([&, t] {
        Part& pt = parts[t];
        int64_t lo = n_recs * t / nt, hi = n_recs * (t + 1) / nt;
        std::unordered_map<std::string, int64_t> bc_local;
        int64_t group = -1;
        std::string prev_name;
        bool have_prev = false;
        for (int64_t ri = lo; ri < hi; ri++) {
          const uint8_t* r = p + rec_offs[ri] + 4;
          int32_t block_size;
          memcpy(&block_size, p + rec_offs[ri], 4);
          // within-record bounds: the offset scan only validated that
          // the record fits the buffer; a corrupt record must become a
          // clean parse error, never an out-of-bounds read
          if (block_size < 33) {  // 32 fixed bytes + >=1 name byte
            pt.parse_error = true;
            return;
          }
          const size_t rec_end = size_t(block_size);
          int32_t ref_id, pos_, l_seq;
          memcpy(&ref_id, r, 4);
          memcpy(&pos_, r + 4, 4);
          uint8_t l_read_name = r[8];
          uint16_t n_cigar, flag_;
          memcpy(&n_cigar, r + 12, 2);
          memcpy(&flag_, r + 14, 2);
          memcpy(&l_seq, r + 16, 4);
          const char* name = reinterpret_cast<const char*>(r + 32);
          if (l_read_name == 0 || l_seq < 0 ||
              32 + size_t(l_read_name) > rec_end) {
            pt.parse_error = true;
            return;
          }
          size_t name_len = size_t(l_read_name) - 1;

          if (flag_ & 0x4) {
            pt.num_unmapped++;
            continue;
          }

          size_t cig_off = 32 + l_read_name;
          size_t tag_off = cig_off + 4 * size_t(n_cigar) +
                           (size_t(l_seq) + 1) / 2 + size_t(l_seq);
          if (cig_off + 4 * size_t(n_cigar) > rec_end ||
              tag_off > rec_end) {
            pt.parse_error = true;
            return;
          }
          int64_t span = 0;
          for (uint16_t i = 0; i < n_cigar; i++) {
            uint32_t cv;
            memcpy(&cv, r + cig_off + 4 * size_t(i), 4);
            if (consumes_ref(cv & 0xF)) span += cv >> 4;
          }
          int64_t score = 0;
          bool has_score = false;
          int64_t cb = -1;
          bool tag_bad = false;
          auto fits = [&](size_t k) {
            if (tag_off + k <= rec_end) return true;
            tag_bad = true;
            return false;
          };
          while (!tag_bad && tag_off + 3 <= rec_end) {
            uint8_t t0 = r[tag_off], t1 = r[tag_off + 1], vt = r[tag_off + 2];
            tag_off += 3;
            switch (vt) {
              case 'A':
                if (!fits(1)) break;
                tag_off += 1;
                break;
              case 'c': {
                if (!fits(1)) break;
                if (t0 == 'A' && t1 == 'S') {
                  score = *reinterpret_cast<const int8_t*>(r + tag_off);
                  has_score = true;
                }
                tag_off += 1;
                break;
              }
              case 'C': {
                if (!fits(1)) break;
                if (t0 == 'A' && t1 == 'S') {
                  score = r[tag_off];
                  has_score = true;
                }
                tag_off += 1;
                break;
              }
              case 's': {
                if (!fits(2)) break;
                if (t0 == 'A' && t1 == 'S') {
                  int16_t v;
                  memcpy(&v, r + tag_off, 2);
                  score = v;
                  has_score = true;
                }
                tag_off += 2;
                break;
              }
              case 'S': {
                if (!fits(2)) break;
                if (t0 == 'A' && t1 == 'S') {
                  uint16_t v;
                  memcpy(&v, r + tag_off, 2);
                  score = v;
                  has_score = true;
                }
                tag_off += 2;
                break;
              }
              case 'i': {
                if (!fits(4)) break;
                if (t0 == 'A' && t1 == 'S') {
                  int32_t v;
                  memcpy(&v, r + tag_off, 4);
                  score = v;
                  has_score = true;
                }
                tag_off += 4;
                break;
              }
              case 'I': {
                if (!fits(4)) break;
                if (t0 == 'A' && t1 == 'S') {
                  uint32_t v;
                  memcpy(&v, r + tag_off, 4);
                  score = v;
                  has_score = true;
                }
                tag_off += 4;
                break;
              }
              case 'f':
                if (!fits(4)) break;
                tag_off += 4;
                break;
              case 'Z':
              case 'H': {
                size_t z = tag_off;
                while (z < rec_end && r[z] != 0) z++;
                if (want_barcodes && t0 == 'C' && t1 == 'B' && vt == 'Z') {
                  std::string bc(reinterpret_cast<const char*>(r + tag_off),
                                 z - tag_off);
                  auto it = bc_local.find(bc);
                  if (it == bc_local.end()) {
                    cb = int64_t(pt.bc_order.size());
                    bc_local.emplace(bc, cb);
                    pt.bc_order.push_back(bc);
                  } else {
                    cb = it->second;
                  }
                }
                tag_off = z + 1;
                break;
              }
              case 'B': {
                if (!fits(5)) break;
                uint8_t sub = r[tag_off];
                uint32_t count;
                memcpy(&count, r + tag_off + 1, 4);
                size_t esz;
                switch (sub) {
                  case 'c': case 'C': esz = 1; break;
                  case 's': case 'S': esz = 2; break;
                  case 'i': case 'I': case 'f': esz = 4; break;
                  default:
                    pt.parse_error = true;
                    return;
                }
                if (size_t(count) > (rec_end - tag_off - 5) / esz) {
                  tag_bad = true;
                  break;
                }
                tag_off += 5 + esz * size_t(count);
                break;
              }
              default:
                pt.parse_error = true;
                return;
            }
          }
          if (tag_bad) {
            pt.parse_error = true;
            return;
          }

          bool same = have_prev && prev_name.size() == name_len &&
                      memcmp(prev_name.data(), name, name_len) == 0;
          if (!same) {
            group++;
            prev_name.assign(name, name_len);
            have_prev = true;
            pt.name_off.push_back(pt.names_blob.size());
            pt.names_blob.append(name, name_len);
            pt.names_blob.push_back('\0');
          }
          if (ref_id < 0) continue;  // mapped but no reference: never pushed

          pt.c.group_id.push_back(group);
          pt.c.flag.push_back(flag_);
          pt.c.ref_id.push_back(ref_id);
          pt.c.pos.push_back(pos_);
          pt.c.ref_span.push_back(span);
          pt.c.seq_len.push_back(l_seq);
          pt.c.score.push_back(score);
          pt.c.has_score.push_back(has_score ? 1 : 0);
          if (want_barcodes) pt.c.cb_id.push_back(cb);
        }
        pt.n_groups = group + 1;
        pt.last_name = prev_name;
      });
    }
    for (auto& th : pool) th.join();
  }
  for (auto& pt : parts)
    if (pt.parse_error) return false;
  return true;
}

// Growable malloc-backed output column (released to the caller, freed
// by oarfish_decoded_free). Doubling growth; release() trims.
template <typename T>
struct GrowBuf {
  T* p = nullptr;
  size_t n = 0, cap = 0;
  void grow(size_t add) {
    if (n + add <= cap) return;
    size_t want = n + add;
    size_t c2 = cap ? cap * 2 : 4096;
    if (c2 < want) c2 = want;
    p = static_cast<T*>(realloc(p, c2 * sizeof(T)));
    cap = c2;
  }
  T* release() {
    if (p && n < cap)
      p = static_cast<T*>(realloc(p, (n ? n : 1) * sizeof(T)));
    T* q = p;
    p = nullptr;
    cap = n = 0;
    return q;
  }
  ~GrowBuf() { free(p); }
};

// ---------------------------------------------------------------------------
// Streaming decode machinery.
//
// The compressed file is memory-mapped (the OS pages it in sequentially
// and can evict behind us) and inflated in bounded WINDOWS (default
// 256 MB of inflated data; OARFISH_DECODE_WINDOW_MB overrides — tests
// use tiny windows to force many of them). Records that straddle a
// window boundary are carried as a byte tail into the next window, and
// records of a read-name GROUP that straddles a window are carried as
// columnar rows so every emitted chunk is group-aligned. Peak RSS is
// O(one window + one chunk), matching the reference's noodles record
// streaming (SURVEY: alignment_parser.rs:301-437); the chunk API
// additionally lets Python overlap filtering/packing of chunk k with
// the decode of chunk k+1 (the reference overlaps parse with its
// consumer thread the same way, bulk.rs:364-682).

namespace {

// A decode window: a raw malloc'd buffer whose live bytes sit at
// [p, p+len). Buffers are allocated with HEADROOM bytes in front of
// the inflated data so the previous window's partial-record tail can
// be stitched in with a small memcpy instead of an O(window) move —
// and, unlike std::vector::resize, malloc never zero-fills the ~GBs
// of window bytes the inflate is about to overwrite anyway.
struct Win {
  uint8_t* base = nullptr;
  size_t cap = 0;
  uint8_t* p = nullptr;
  size_t len = 0;
  bool ensure(size_t need) {  // false on allocation failure
    if (cap < need) {
      free(base);
      base = static_cast<uint8_t*>(malloc(need));
      cap = base ? need : 0;
    }
    return cap >= need;
  }
  void swap(Win& o) {
    std::swap(base, o.base);
    std::swap(cap, o.cap);
    std::swap(p, o.p);
    std::swap(len, o.len);
  }
  ~Win() { free(base); }
};

// Tail headroom default: must cover the largest partial BAM record
// that can straddle a window boundary (records are bounded by
// block_size, an int32, but sane long-read records are <16 MB).
// Tails larger than the headroom take a rare realloc+copy fallback
// path — tests shrink it (OARFISH_DECODE_HEADROOM_BYTES, read per
// stream open) to force that path.
constexpr size_t WIN_HEADROOM_DEFAULT = 32ull << 20;

struct StreamState {
  // input
  void* map = nullptr;
  size_t fsize = 0;
  const uint8_t* comp = nullptr;
  std::vector<Block> blocks;
  size_t bi = 0;  // next block to hand to a prefetch
  size_t WBYTES = 256ull << 20;
  int threads = 1;
  int keep_names = 0;
  int want_barcodes = 0;
  int64_t sort_check_num = 0;
  // double-buffered windows: cur is being scanned on the caller's
  // thread while a background pool inflates the next batch of blocks
  // into nx (the window-level pipeline; see advance_window).
  // `pipeline` gates the EAGER prefetch. An early A/B (scripts/
  // decode_ab.py 2026-08-19) measured it harmful on the 4-vCPU host,
  // but after the round-5 consumer-side changes (incremental CSR
  // assembly, persistent coverage accumulator) it wins at every
  // measured scale: R=5M pack 8.9s -> 8.3s, R=2M 4.2s -> 3.8s at
  // threads=4 (record-scan still degrades ~0.3s from LLC sharing, but
  // hiding the 1.5-2.6s serial bscan/scan/merge under inflate nets
  // out). Default ON for threads >= 3; OARFISH_DECODE_PIPELINE=1/0
  // still forces either mode.
  Win cur, nx;
  std::thread pf_th;
  bool pf_active = false;
  bool pf_ok = true;
  bool pipeline = false;
  size_t hroom = WIN_HEADROOM_DEFAULT;
  // header (parsed at open)
  std::string header_text, ref_names;
  std::vector<int64_t> ref_lengths;
  int32_t n_ref = 0;
  bool header_sent = false;
  // cross-window group/barcode/collation state
  std::unordered_map<std::string, int64_t> bc_lookup;
  std::vector<std::string> barcode_order;
  std::unordered_set<std::string> seen_names;
  int64_t checked_groups = 0;
  char* dup_name = nullptr;  // handed to the first chunk that reports it
  int64_t group = -1;        // last global group id assigned
  std::string carry_name;    // name of the still-open group
  bool have_carry = false;
  // held-back rows of the still-open trailing group
  Columns carry;
  bool done = false;
  PhaseTimer tm;
  // accumulated wall time per decode phase (reported at close when
  // OARFISH_DECODE_TIMING is set; the prefetch pool inflates in the
  // background, so inflate_s is the wall spent WAITING on it)
  double inflate_s = 0, bscan_s = 0, scan_s = 0, merge_s = 0;

  ~StreamState() {
    if (pf_active) pf_th.join();  // never free a buffer a pool is filling
    if (tm.on)
      fprintf(stderr,
              "[decode] totals: inflate-wait %.2fs  boundary-scan %.2fs  "
              "record-scan %.2fs  merge %.2fs\n",
              inflate_s, bscan_s, scan_s, merge_s);
    if (map) munmap(map, fsize);
    free(dup_name);
  }
};

struct PhaseAcc {  // adds elapsed wall to *slot on scope exit
  double* slot;
  std::chrono::steady_clock::time_point t0 =
      std::chrono::steady_clock::now();
  explicit PhaseAcc(double* s) : slot(s) {}
  ~PhaseAcc() {
    *slot += std::chrono::duration<double>(
                 std::chrono::steady_clock::now() - t0)
                 .count();
  }
};

// Inflate blocks [first, last) with S.threads workers; block i lands at
// dst + dataoff + (out_off[i] - out_off[first]).
bool inflate_range(const StreamState& S, uint8_t* dst, size_t dataoff,
                   size_t first, size_t last) {
  if (first >= last) return true;
  const size_t base = S.blocks[first].out_off;
  std::atomic<size_t> next{first};
  std::atomic<bool> ok{true};
  std::vector<std::thread> pool;
  int nt_inf = S.threads > 0 ? S.threads : 1;
  int nw = int(std::min<size_t>(size_t(nt_inf), last - first));
  for (int t = 0; t < nw; t++) {
    pool.emplace_back([&] {
      libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
      size_t i;
      while ((i = next.fetch_add(1)) < last) {
        Block b = S.blocks[i];
        b.out_off = dataoff + (b.out_off - base);
        if (!inflate_block(S.comp, b, dst, dec)) ok.store(false);
      }
      libdeflate_free_decompressor(dec);
    });
  }
  for (auto& th : pool) th.join();
  return ok.load();
}

// Inflate blocks [first, last) (sum of ISIZEs = add) into w's data
// region (base + WIN_HEADROOM).
bool inflate_batch(const StreamState& S, Win& w, size_t first, size_t last,
                   size_t add) {
  if (!w.ensure(S.hroom + add)) return false;
  w.p = w.base + S.hroom;
  w.len = add;
  if (add == 0) return true;
  return inflate_range(S, w.base, S.hroom, first, last);
}

// Start inflating the next batch of blocks into S.nx on a background
// thread (claims the block range now so the main thread's EOF checks
// use pf_active, not bi).
void launch_prefetch(StreamState& S) {
  if (S.pf_active || S.bi >= S.blocks.size()) return;
  size_t first = S.bi, add = 0;
  while (S.bi < S.blocks.size() && add < S.WBYTES) {
    add += S.blocks[S.bi].out_size;
    S.bi++;
  }
  size_t last = S.bi;
  S.pf_ok = true;
  S.pf_active = true;
  S.pf_th = std::thread([&S, first, last, add] {
    S.pf_ok = inflate_batch(S, S.nx, first, last, add);
  });
}

// The window-level pipeline step: join the in-flight prefetch, stitch
// cur's leftover partial-record tail into nx's headroom, promote nx to
// the current window, and immediately start prefetching the batch
// after it. While the caller then boundary-scans / record-scans /
// merges the new window, the pool is already inflating the next one —
// scan work rides under the inflate instead of serializing after it.
bool advance_window(StreamState& S) {  // false on inflate failure
  PhaseAcc acc_(&S.inflate_s);         // wait time, not inflate work
  if (S.pf_active) {
    // pipeline mode: the batch is already (being) inflated into nx
    S.pf_th.join();
    S.pf_active = false;
    if (!S.pf_ok) return false;
    const size_t tail = S.cur.len;
    if (tail) {
      const size_t off = size_t(S.nx.p - S.nx.base);
      if (tail <= off) {
        memcpy(S.nx.p - tail, S.cur.p, tail);
        S.nx.p -= tail;
        S.nx.len += tail;
      } else {
        // tail larger than the headroom (a >32 MB partial record):
        // rebuild contiguously in a fresh buffer
        Win big;
        if (!big.ensure(S.hroom + tail + S.nx.len)) return false;
        memcpy(big.base + S.hroom, S.cur.p, tail);
        memcpy(big.base + S.hroom + tail, S.nx.p, S.nx.len);
        big.p = big.base + S.hroom;
        big.len = tail + S.nx.len;
        big.swap(S.nx);
      }
    }
    S.cur.swap(S.nx);
    S.nx.p = S.nx.base;
    S.nx.len = 0;
    launch_prefetch(S);
    return true;
  }
  if (S.bi >= S.blocks.size()) return true;  // no input left
  // sync single-buffer mode: memmove the small tail to just before the
  // data region and inflate the next batch into cur's own (warm, same
  // physical pages every window) buffer — the page-fault-minimal path
  // for core-starved hosts
  size_t first = S.bi, add = 0;
  while (S.bi < S.blocks.size() && add < S.WBYTES) {
    add += S.blocks[S.bi].out_size;
    S.bi++;
  }
  const size_t tail = S.cur.len;
  const size_t dataoff = tail <= S.hroom ? S.hroom : tail;
  if (S.cur.cap < dataoff + add) {
    Win big;
    // slack so per-window size jitter doesn't realloc every window
    if (!big.ensure(dataoff + add + (4ull << 20))) return false;
    memcpy(big.base + dataoff - tail, S.cur.p, tail);
    big.swap(S.cur);
  } else if (tail) {
    memmove(S.cur.base + dataoff - tail, S.cur.p, tail);
  }
  S.cur.p = S.cur.base + dataoff - tail;
  S.cur.len = tail + add;
  return inflate_range(S, S.cur.base, dataoff, first, S.bi);
}

// Returns nullptr on success, or a malloc'd error chunk.
OarfishDecoded* stream_open_impl(StreamState& S, const char* path,
                                 int threads, int keep_names,
                                 int64_t sort_check_num, int want_barcodes) {
  S.threads = threads;
  S.keep_names = keep_names;
  S.sort_check_num = sort_check_num;
  S.want_barcodes = want_barcodes;
  if (const char* we = getenv("OARFISH_DECODE_WINDOW_MB")) {
    long mb = atol(we);
    if (mb > 0) S.WBYTES = size_t(mb) << 20;
  }
  if (const char* we = getenv("OARFISH_DECODE_WINDOW_BYTES")) {
    long b = atol(we);  // test hook: force many tiny windows
    if (b > 0) S.WBYTES = size_t(b);
  }
  if (const char* he = getenv("OARFISH_DECODE_HEADROOM_BYTES")) {
    long b = atol(he);  // test hook: force the giant-tail fallback
    if (b > 0) S.hroom = size_t(b);
  }

  int fd = open(path, O_RDONLY);
  if (fd < 0) return make_error(std::string("cannot open ") + path);
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return make_error(std::string("cannot stat ") + path);
  }
  S.fsize = size_t(st.st_size);
  S.map = mmap(nullptr, S.fsize, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (S.map == MAP_FAILED) {
    S.map = nullptr;
    return make_error(std::string("cannot mmap ") + path);
  }
  madvise(S.map, S.fsize, MADV_SEQUENTIAL);
  S.comp = static_cast<const uint8_t*>(S.map);
  S.tm.mark("open");

  size_t total_out = 0;
  std::string err;
  if (!scan_blocks(S.comp, S.fsize, S.blocks, total_out, err))
    return make_error(err);
  S.tm.mark("index");

  // --- header: parse straight out of the first window (headers are
  // ~MBs; if one ever spans multiple windows, the rare grow path
  // below concatenates into a larger buffer)
  size_t off = 0;
  bool first_batch = true;
  for (;;) {
    {
      size_t first = S.bi, add = 0;
      while (S.bi < S.blocks.size() && add < S.WBYTES) {
        add += S.blocks[S.bi].out_size;
        S.bi++;
      }
      if (add && first_batch) {
        if (!inflate_batch(S, S.cur, first, S.bi, add))
          return make_error("BGZF inflate failure");
        first_batch = false;
      } else if (add) {
        // grow: inflate the next batch and join it behind cur
        if (!inflate_batch(S, S.nx, first, S.bi, add))
          return make_error("BGZF inflate failure");
        Win big;
        if (!big.ensure(S.hroom + S.cur.len + S.nx.len))
          return make_error("decode window allocation failed");
        big.p = big.base + S.hroom;
        memcpy(big.p, S.cur.p, S.cur.len);
        memcpy(big.p + S.cur.len, S.nx.p, S.nx.len);
        big.len = S.cur.len + S.nx.len;
        big.swap(S.cur);
      }
    }
    const uint8_t* p = S.cur.p;
    size_t have = S.cur.len;
    if (have < 12) {
      if (S.bi >= S.blocks.size()) return make_error("missing BAM magic");
      continue;
    }
    if (memcmp(p, "BAM\x01", 4) != 0) return make_error("missing BAM magic");
    int32_t l_text;
    memcpy(&l_text, p + 4, 4);
    if (l_text < 0) return make_error("corrupt BAM header");
    size_t o = 8 + size_t(l_text);
    if (o + 4 > have) {
      if (S.bi >= S.blocks.size()) return make_error("truncated BAM header");
      continue;
    }
    memcpy(&S.n_ref, p + o, 4);
    o += 4;
    if (S.n_ref < 0) return make_error("corrupt BAM header");
    bool complete = true;
    std::string names;
    std::vector<int64_t> lens;
    lens.reserve(size_t(S.n_ref));
    for (int i = 0; i < S.n_ref; i++) {
      if (o + 4 > have) { complete = false; break; }
      int32_t l_name;
      memcpy(&l_name, p + o, 4);
      o += 4;
      if (l_name <= 0 || o + size_t(l_name) + 4 > have) {
        if (l_name <= 0) return make_error("corrupt BAM header");
        complete = false;
        break;
      }
      names.append(reinterpret_cast<const char*>(p + o),
                   size_t(l_name) - 1);
      names.push_back('\0');
      o += size_t(l_name);
      int32_t l_ref;
      memcpy(&l_ref, p + o, 4);
      o += 4;
      lens.push_back(l_ref);
    }
    if (!complete) {
      if (S.bi >= S.blocks.size()) return make_error("truncated BAM header");
      continue;
    }
    S.header_text.assign(reinterpret_cast<const char*>(p + 8),
                         size_t(l_text));
    S.ref_names = std::move(names);
    S.ref_lengths = std::move(lens);
    off = o;
    break;
  }
  // the bytes after the header become the first window's live range
  S.cur.p += off;
  S.cur.len -= off;
  S.nx.p = S.nx.base;
  S.nx.len = 0;
  S.pipeline = S.threads >= 3;
  if (const char* pe = getenv("OARFISH_DECODE_PIPELINE"))
    S.pipeline = atoi(pe) != 0;
  if (S.pipeline) launch_prefetch(S);
  S.tm.mark("header");
  return nullptr;
}

// Chunk accumulation buffers (global group ids; rebased on emit).
struct ChunkBufs {
  GrowBuf<int64_t> group_id, pos, ref_span, seq_len, score, cb_id;
  GrowBuf<uint16_t> flag;
  GrowBuf<int32_t> ref_id;
  GrowBuf<uint8_t> has_score;
  std::vector<std::string> names;  // per group (only when keep_names)
  int64_t num_unmapped = 0;
  size_t n() const { return flag.n; }
};

void append_rows(ChunkBufs& cb, const Columns& c, int64_t gid_base,
                 int want_barcodes, const std::vector<int64_t>* bc_map) {
  const size_t m = c.flag.size();
  if (!m) return;
  cb.group_id.grow(m);
  cb.flag.grow(m);
  cb.ref_id.grow(m);
  cb.pos.grow(m);
  cb.ref_span.grow(m);
  cb.seq_len.grow(m);
  cb.score.grow(m);
  cb.has_score.grow(m);
  for (size_t i = 0; i < m; i++)
    cb.group_id.p[cb.group_id.n + i] = c.group_id[i] + gid_base;
  memcpy(cb.flag.p + cb.flag.n, c.flag.data(), m * 2);
  memcpy(cb.ref_id.p + cb.ref_id.n, c.ref_id.data(), m * 4);
  memcpy(cb.pos.p + cb.pos.n, c.pos.data(), m * 8);
  memcpy(cb.ref_span.p + cb.ref_span.n, c.ref_span.data(), m * 8);
  memcpy(cb.seq_len.p + cb.seq_len.n, c.seq_len.data(), m * 8);
  memcpy(cb.score.p + cb.score.n, c.score.data(), m * 8);
  memcpy(cb.has_score.p + cb.has_score.n, c.has_score.data(), m);
  if (want_barcodes) {
    cb.cb_id.grow(m);
    for (size_t i = 0; i < m; i++) {
      int64_t v = c.cb_id[i];
      cb.cb_id.p[cb.cb_id.n + i] =
          v < 0 ? -1 : (bc_map ? (*bc_map)[size_t(v)] : v);
    }
    cb.cb_id.n += m;
  }
  cb.group_id.n += m;
  cb.flag.n += m;
  cb.ref_id.n += m;
  cb.pos.n += m;
  cb.ref_span.n += m;
  cb.seq_len.n += m;
  cb.score.n += m;
  cb.has_score.n += m;
}

// Package a chunk: group ids rebased to [0, n_groups); header attached
// to the first chunk of the stream; barcodes attached to the final one.
OarfishDecoded* emit_chunk(StreamState& S, ChunkBufs& cb, int64_t g0,
                           int64_t n_groups, bool final_chunk) {
  auto* d = static_cast<OarfishDecoded*>(calloc(1, sizeof(OarfishDecoded)));
  const size_t tot = cb.n();
  d->n_records = int64_t(tot);
  d->n_groups = n_groups;
  d->num_unmapped = cb.num_unmapped;
  for (size_t i = 0; i < tot; i++) cb.group_id.p[i] -= g0;
  d->group_id = cb.group_id.release();
  d->flag = cb.flag.release();
  d->ref_id = cb.ref_id.release();
  d->pos = cb.pos.release();
  d->ref_span = cb.ref_span.release();
  d->seq_len = cb.seq_len.release();
  d->score = cb.score.release();
  d->has_score = cb.has_score.release();
  d->cb_id = S.want_barcodes ? cb.cb_id.release() : nullptr;
  if (!S.header_sent) {
    S.header_sent = true;
    d->n_refs = S.n_ref;
    d->header_text = static_cast<char*>(malloc(S.header_text.size()));
    memcpy(d->header_text, S.header_text.data(), S.header_text.size());
    d->header_text_len = int64_t(S.header_text.size());
    d->ref_names = static_cast<char*>(malloc(S.ref_names.size()));
    memcpy(d->ref_names, S.ref_names.data(), S.ref_names.size());
    d->ref_names_len = int64_t(S.ref_names.size());
    d->ref_lengths = steal(S.ref_lengths);
  }
  if (S.keep_names) {
    std::string blob;
    for (int64_t g = 0; g < n_groups; g++) {
      blob.append(cb.names[size_t(g)]);
      blob.push_back('\0');
    }
    d->group_names = static_cast<char*>(malloc(blob.size() ? blob.size() : 1));
    memcpy(d->group_names, blob.data(), blob.size());
    d->group_names_len = int64_t(blob.size());
  }
  if (final_chunk && S.want_barcodes) {
    std::string bb;
    for (auto& bc : S.barcode_order) {
      bb.append(bc);
      bb.push_back('\0');
    }
    d->barcodes = static_cast<char*>(malloc(bb.size() ? bb.size() : 1));
    memcpy(d->barcodes, bb.data(), bb.size());
    d->barcodes_len = int64_t(bb.size());
    d->n_barcodes = int64_t(S.barcode_order.size());
  }
  d->dup_name = S.dup_name;  // ownership moves to the chunk
  S.dup_name = nullptr;
  d->is_final = final_chunk ? 1 : 0;
  return d;
}

// Produce the next group-aligned chunk. Processes whole windows until at
// least one COMPLETE group is available (or EOF); the still-open trailing
// group's rows are held back in S.carry for the next call.
OarfishDecoded* stream_next_impl(StreamState& S) {
  if (S.done) {
    ChunkBufs empty;
    return emit_chunk(S, empty, 0, 0, true);
  }
  auto fail = [&](const char* msg) {
    S.done = true;  // a failed stream never resumes
    return make_error(msg);
  };
  ChunkBufs cb;
  // first group of this chunk: the open carried group, or the next id
  const int64_t g0 = S.have_carry ? S.group : S.group + 1;
  if (S.have_carry) {
    // seed with the held-back rows of the open group (carry gids are 0)
    append_rows(cb, S.carry, S.group, S.want_barcodes, nullptr);
    S.carry = Columns();
    if (S.keep_names) cb.names.push_back(S.carry_name);
  }

  std::vector<size_t> rec_offs;
  std::vector<Part> parts;
  auto more_input = [&S] {
    return S.pf_active || S.bi < S.blocks.size();
  };
  for (;;) {
    if (S.cur.len == 0 && !more_input()) {
      // EOF: everything accumulated (incl. the open group) is final
      S.done = true;
      S.tm.mark("scan+merge");
      return emit_chunk(S, cb, g0, S.group - g0 + 1, true);
    }
    // record boundaries within this window; leftover bytes carry over
    rec_offs.clear();
    const uint8_t* p = S.cur.p;
    const size_t have = S.cur.len;
    size_t o = 0;
    {
      PhaseAcc acc_(&S.bscan_s);
      while (o + 4 <= have) {
        int32_t block_size;
        memcpy(&block_size, p + o, 4);
        if (block_size < 0) return fail("corrupt BAM record");
        if (o + 4 + size_t(block_size) > have) break;
        rec_offs.push_back(o);
        o += 4 + size_t(block_size);
      }
    }
    if (rec_offs.empty() && !more_input())
      return fail("truncated BAM record");

    if (!rec_offs.empty()) {
      {
        PhaseAcc acc_(&S.scan_s);
        if (!scan_records(p, rec_offs, S.threads, S.want_barcodes,
                          S.sort_check_num, parts))
          return fail(
              "corrupt BAM record (bad field bounds or unknown tag type)");
      }
      PhaseAcc accm_(&S.merge_s);

      // merge this window's parts: group-id bases with boundary
      // stitching, global barcode remap (first-seen order), collation
      // check over the first `sort_check_num` names
      for (auto& pt : parts) {
        cb.num_unmapped += pt.num_unmapped;
        int64_t group_base = 0;
        if (pt.n_groups > 0) {
          const char* first = pt.names_blob.data() + pt.name_off[0];
          bool stitch = S.have_carry && S.carry_name == first;
          group_base = S.group + (stitch ? 0 : 1);
          for (int64_t g = stitch ? 1 : 0; g < pt.n_groups; g++) {
            const char* nm = pt.names_blob.data() + pt.name_off[size_t(g)];
            if (S.keep_names) cb.names.emplace_back(nm);
            if (S.checked_groups < S.sort_check_num) {
              auto ins = S.seen_names.insert(nm);
              if (!ins.second && !S.dup_name) S.dup_name = strdup(nm);
              S.checked_groups++;
            }
          }
          S.group = group_base + pt.n_groups - 1;
          S.carry_name = pt.last_name;
          S.have_carry = true;
        }
        std::vector<int64_t> bc_map(pt.bc_order.size());
        for (size_t i = 0; i < pt.bc_order.size(); i++) {
          auto it = S.bc_lookup.find(pt.bc_order[i]);
          if (it == S.bc_lookup.end()) {
            bc_map[i] = int64_t(S.barcode_order.size());
            S.bc_lookup.emplace(pt.bc_order[i], bc_map[i]);
            S.barcode_order.push_back(pt.bc_order[i]);
          } else {
            bc_map[i] = it->second;
          }
        }
        append_rows(cb, pt.c, group_base, S.want_barcodes, &bc_map);
        pt = Part();  // release
      }
    }

    // drop the consumed bytes (the partial-record tail stays live in
    // cur's buffer; advance_window stitches it in front of the next
    // window) and pipeline-step to the already-inflating next batch
    S.cur.p += o;
    S.cur.len -= o;
    if (!more_input()) {
      if (S.cur.len) return fail("truncated BAM record");
    } else if (!advance_window(S)) {
      return fail("BGZF inflate failure (or decode window allocation)");
    }

    // emit once at least one complete group is buffered: hold back the
    // rows of the still-open trailing group (gid == S.group)
    if (S.group > g0 ||
        (S.group == g0 && !more_input() && S.cur.len == 0)) {
      if (!more_input() && S.cur.len == 0) {
        S.done = true;
        S.tm.mark("scan+merge");
        return emit_chunk(S, cb, g0, S.group - g0 + 1, true);
      }
      // split the trailing open group's rows into carry
      size_t tot = cb.n();
      size_t split = tot;
      while (split > 0 && cb.group_id.p[split - 1] == S.group) split--;
      S.carry = Columns();
      for (size_t i = split; i < tot; i++) {
        S.carry.group_id.push_back(0);
        S.carry.flag.push_back(cb.flag.p[i]);
        S.carry.ref_id.push_back(cb.ref_id.p[i]);
        S.carry.pos.push_back(cb.pos.p[i]);
        S.carry.ref_span.push_back(cb.ref_span.p[i]);
        S.carry.seq_len.push_back(cb.seq_len.p[i]);
        S.carry.score.push_back(cb.score.p[i]);
        S.carry.has_score.push_back(cb.has_score.p[i]);
        if (S.want_barcodes) S.carry.cb_id.push_back(cb.cb_id.p[i]);
      }
      cb.group_id.n = split;
      cb.flag.n = split;
      cb.ref_id.n = split;
      cb.pos.n = split;
      cb.ref_span.n = split;
      cb.seq_len.n = split;
      cb.score.n = split;
      cb.has_score.n = split;
      if (S.want_barcodes) cb.cb_id.n = split;
      if (S.keep_names && !cb.names.empty()) cb.names.pop_back();
      S.tm.mark("chunk");
      return emit_chunk(S, cb, g0, S.group - g0, false);
    }
  }
}

}  // namespace

extern "C" {

// --- chunked streaming API ---
// open → repeated next (each returns a malloc'd group-aligned chunk;
// header fields are populated on the first chunk, the barcode table on
// the final one, is_final marks it) → close. A chunk with `error` set
// aborts the stream. The caller frees every chunk with
// oarfish_decoded_free and the stream with oarfish_stream_close.

void* oarfish_stream_open(const char* path, int threads, int keep_names,
                          int64_t sort_check_num, int want_barcodes,
                          OarfishDecoded** err_out) {
  auto* S = new StreamState();
  OarfishDecoded* err = stream_open_impl(*S, path, threads, keep_names,
                                         sort_check_num, want_barcodes);
  if (err) {
    delete S;
    if (err_out) *err_out = err;
    else oarfish_decoded_free(err);
    return nullptr;
  }
  if (err_out) *err_out = nullptr;
  return S;
}

OarfishDecoded* oarfish_stream_next(void* handle) {
  return stream_next_impl(*static_cast<StreamState*>(handle));
}

void oarfish_stream_close(void* handle) {
  delete static_cast<StreamState*>(handle);
}

// --- whole-file decode (layered over the stream) ---
OarfishDecoded* oarfish_decode_bam(const char* path, int threads,
                                   int keep_names, int64_t sort_check_num,
                                   int want_barcodes) {
  OarfishDecoded* err = nullptr;
  void* h =
      oarfish_stream_open(path, threads, keep_names, sort_check_num,
                          want_barcodes, &err);
  if (!h) return err;
  StreamState& S = *static_cast<StreamState*>(h);

  ChunkBufs all;
  std::string group_names;
  int64_t group_base = 0;
  char* dup_name = nullptr;
  OarfishDecoded* hdr_chunk = nullptr;  // first chunk (owns header arrays)
  std::string barcodes_blob;
  int64_t n_barcodes = 0;
  for (;;) {
    OarfishDecoded* c = oarfish_stream_next(h);
    if (c->error) {
      free(dup_name);
      if (hdr_chunk) oarfish_decoded_free(hdr_chunk);
      oarfish_stream_close(h);
      return c;
    }
    const size_t m = size_t(c->n_records);
    all.group_id.grow(m);
    all.flag.grow(m);
    all.ref_id.grow(m);
    all.pos.grow(m);
    all.ref_span.grow(m);
    all.seq_len.grow(m);
    all.score.grow(m);
    all.has_score.grow(m);
    for (size_t i = 0; i < m; i++)
      all.group_id.p[all.group_id.n + i] = c->group_id[i] + group_base;
    if (m) {
      memcpy(all.flag.p + all.flag.n, c->flag, m * 2);
      memcpy(all.ref_id.p + all.ref_id.n, c->ref_id, m * 4);
      memcpy(all.pos.p + all.pos.n, c->pos, m * 8);
      memcpy(all.ref_span.p + all.ref_span.n, c->ref_span, m * 8);
      memcpy(all.seq_len.p + all.seq_len.n, c->seq_len, m * 8);
      memcpy(all.score.p + all.score.n, c->score, m * 8);
      memcpy(all.has_score.p + all.has_score.n, c->has_score, m);
    }
    if (want_barcodes && m) {
      all.cb_id.grow(m);
      memcpy(all.cb_id.p + all.cb_id.n, c->cb_id, m * 8);
      all.cb_id.n += m;
    }
    all.group_id.n += m;
    all.flag.n += m;
    all.ref_id.n += m;
    all.pos.n += m;
    all.ref_span.n += m;
    all.seq_len.n += m;
    all.score.n += m;
    all.has_score.n += m;
    all.num_unmapped += c->num_unmapped;
    group_base += c->n_groups;
    if (keep_names && c->group_names_len)
      group_names.append(c->group_names, size_t(c->group_names_len));
    if (c->dup_name && !dup_name) dup_name = strdup(c->dup_name);
    bool final_chunk = c->is_final != 0;
    if (final_chunk && want_barcodes) {
      if (c->barcodes_len)
        barcodes_blob.assign(c->barcodes, size_t(c->barcodes_len));
      n_barcodes = c->n_barcodes;
    }
    if (c->header_text) {
      hdr_chunk = c;  // keep: owns header_text/ref_names/ref_lengths
    } else {
      oarfish_decoded_free(c);
    }
    if (final_chunk) break;
  }

  auto* d = static_cast<OarfishDecoded*>(calloc(1, sizeof(OarfishDecoded)));
  d->n_records = int64_t(all.n());
  d->n_groups = group_base;
  d->n_refs = S.n_ref;
  d->num_unmapped = all.num_unmapped;
  d->group_id = all.group_id.release();
  d->flag = all.flag.release();
  d->ref_id = all.ref_id.release();
  d->pos = all.pos.release();
  d->ref_span = all.ref_span.release();
  d->seq_len = all.seq_len.release();
  d->score = all.score.release();
  d->has_score = all.has_score.release();
  d->cb_id = want_barcodes ? all.cb_id.release() : nullptr;
  if (hdr_chunk) {
    d->header_text = hdr_chunk->header_text;
    d->header_text_len = hdr_chunk->header_text_len;
    d->ref_names = hdr_chunk->ref_names;
    d->ref_names_len = hdr_chunk->ref_names_len;
    d->ref_lengths = hdr_chunk->ref_lengths;
    hdr_chunk->header_text = nullptr;
    hdr_chunk->ref_names = nullptr;
    hdr_chunk->ref_lengths = nullptr;
    oarfish_decoded_free(hdr_chunk);
  }
  if (keep_names) {
    d->group_names =
        static_cast<char*>(malloc(group_names.size() ? group_names.size() : 1));
    memcpy(d->group_names, group_names.data(), group_names.size());
    d->group_names_len = int64_t(group_names.size());
  }
  if (want_barcodes) {
    d->barcodes = static_cast<char*>(
        malloc(barcodes_blob.size() ? barcodes_blob.size() : 1));
    memcpy(d->barcodes, barcodes_blob.data(), barcodes_blob.size());
    d->barcodes_len = int64_t(barcodes_blob.size());
    d->n_barcodes = n_barcodes;
  }
  d->dup_name = dup_name;
  d->is_final = 1;
  oarfish_stream_close(h);
  return d;
}

}  // extern "C"
