// Native coverage-model pass: logistic per-bin probabilities +
// per-read coverage-probability normalization.
//
// Equivalent of the reference's rayon-parallel coverage model
// (`src/util/logistic_probability.rs:40-79`,
// `src/util/normalize_probability.rs:5-74`), fused into two
// multithreaded passes over the flat bin CSR. The NumPy implementation
// in oarfish_tpu/models/coverage.py is the differential oracle; this
// pass replicates its arithmetic ORDER exactly (sequential per-segment
// sums, serial prefix sum matching np.cumsum, no FMA contraction) so
// outputs are bit-identical up to libm-vs-numpy exp ulp differences in
// the logistic.
//
// Build: g++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC covmodel.cpp
//        -o liboarfish_covmodel.so -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <functional>
#include <limits>
#include <thread>
#include <vector>

namespace {

void run_pool(int nt, const std::function<void(int)>& fn) {
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; t++) pool.emplace_back(fn, t);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// logistic_prob (`logistic_probability.rs:40-79`): mutates `bins` by the
// pseudo-count total_weight/100 (as the reference mutates coverage_bins
// in place) and fills `out` with per-bin probabilities. Parallel over
// transcripts; within a transcript the count sum is sequential
// (bit-matching np.add.reduceat's in-order segment reduction).
void oarfish_logistic_prob(double* bins, const double* total_weight,
                           const int64_t* bin_offsets, int64_t T,
                           double growth_rate, double* out, int threads) {
  int nt = std::max(1, std::min(threads, 16));
  std::atomic<int64_t> next{0};
  const int64_t CHUNK = 1024;  // transcripts per grab
  run_pool(nt, [&](int) {
    int64_t c;
    while ((c = next.fetch_add(1) * CHUNK) < T) {
      int64_t hi = std::min(c + CHUNK, T);
      for (int64_t t = c; t < hi; t++) {
        int64_t s = bin_offsets[t], e = bin_offsets[t + 1];
        double pseudo = total_weight[t] / 100.0;
        double sum = 0.0;
        for (int64_t b = s; b < e; b++) {
          bins[b] += pseudo;
          sum += double(float(bins[b]));  // f64 -> f32 counts -> f64
        }
        if (sum > 1e-8) {
          double expected = sum / double(e - s);
          for (int64_t b = s; b < e; b++) {
            double c64 = double(float(bins[b]));
            double diff = (expected - c64) / expected;
            double v = 1.0 / (1.0 + std::exp(-growth_rate * diff));
            // np.clip order: max then min, NaN propagates
            v = std::min(std::max(v, 1e-8), 0.99999);
            out[b] = v;
          }
        } else {
          for (int64_t b = s; b < e; b++) out[b] = 0.0;
        }
      }
    }
  });
}

// normalize_read_probs (`normalize_probability.rs:5-74`): per-alignment
// expected coverage probability (fractional first bin, end bin excluded
// — the reference quirk), then normalized to sum 1 within each read.
// Interior sums use prefix-sum differences over a serial cumsum,
// bit-matching the NumPy oracle's np.cumsum formulation. Returns 0 on
// success, 1 if any expected value is non-finite (caller raises, as the
// reference panics).
int oarfish_normalize_read_probs(
    const int32_t* tid, const int64_t* start, const int64_t* end, int64_t A,
    const int64_t* boundaries, int64_t R, const int64_t* bin_offsets,
    const int64_t* nbins, const double* lenf, const double* cov_prob_flat,
    int64_t NB, double bl, double* out, int threads) {
  if (A == 0) return 0;
  int nt = std::max(1, std::min(threads, 16));

  // serial prefix sum (np.cumsum order)
  std::vector<double> csum(size_t(NB) + 1);
  csum[0] = 0.0;
  {
    double acc = 0.0;
    for (int64_t i = 0; i < NB; i++) {
      acc += cov_prob_flat[i];
      csum[size_t(i) + 1] = acc;
    }
  }

  std::atomic<int> nonfinite{0};
  std::vector<double> expected(static_cast<size_t>(A), 0.0);
  {
    std::atomic<int64_t> next{0};
    const int64_t CHUNK = 65536;
    run_pool(nt, [&](int) {
      int64_t c;
      bool bad = false;
      while ((c = next.fetch_add(1) * CHUNK) < A) {
        int64_t hi = std::min(c + CHUNK, A);
        for (int64_t i = c; i < hi; i++) {
          int64_t t = tid[i];
          double st = double(start[i]), en = double(end[i]);
          int64_t nb = nbins[t];
          int64_t sb = int64_t(st / bl);
          int64_t eb = std::min(int64_t(en / bl), nb - 1);
          int64_t off = bin_offsets[t];
          double exp_i;
          if (sb == eb) {
            double w = (en - st) / bl;
            exp_i = (w != 0.0) ? cov_prob_flat[off + sb]
                               : std::numeric_limits<double>::quiet_NaN();
          } else {
            int64_t a = off + sb + 1, b = off + eb;
            double n_interior = std::max(double(b - a), 0.0);
            double interior = (a < b) ? csum[size_t(b)] - csum[size_t(a)] : 0.0;
            double bin_end_first = std::min(bl * double(sb) + bl, lenf[t]);
            double w_first = (bin_end_first - st) / bl;
            double cp_first = cov_prob_flat[off + sb];
            exp_i = (w_first * cp_first + interior) / (w_first + n_interior);
          }
          if (!std::isfinite(exp_i)) bad = true;
          expected[size_t(i)] = exp_i;
        }
      }
      if (bad) nonfinite.store(1);
    });
  }
  if (nonfinite.load()) return 1;

  // per-read normalization: sequential per-read sums (reduceat order)
  {
    std::atomic<int64_t> next{0};
    const int64_t CHUNK = 16384;
    run_pool(nt, [&](int) {
      int64_t c;
      while ((c = next.fetch_add(1) * CHUNK) < R) {
        int64_t hi = std::min(c + CHUNK, R);
        for (int64_t r = c; r < hi; r++) {
          int64_t s = boundaries[r], e = boundaries[r + 1];
          double nsum = 0.0;
          for (int64_t i = s; i < e; i++) nsum += expected[size_t(i)];
          double denom = (nsum > 0.0) ? nsum : 1.0;
          for (int64_t i = s; i < e; i++)
            out[i] = expected[size_t(i)] / denom;
        }
      }
    });
  }
  return 0;
}

}  // extern "C"
