// Native host kernels of action_detection_torch: temporal NMS and the TAG
// box search, C ABI functions bound with ctypes
// (action_detection_torch/utils/native.py). The same functions as
// native/adt_native.cpp of the JAX package, kept as the port's own copy.
// The numpy bodies in ops/nms.py and ops/tag.py are their plain versions.
//
// Build (done by utils/native.py at first use, into _build/):
//   g++ -O2 -std=c++17 -shared -fPIC -o libadt_native_<hash>.so adt_native.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Greedy temporal NMS.
//
// starts/ends/scores: n elements. duration_offset selects the interval
// convention (0.0 continuous spans, 1.0 inclusive frame indices).
// out_indices must hold n int64. Returns the number of kept indices
// (descending score order).
int64_t adt_temporal_nms(const double* starts, const double* ends,
                         const double* scores, int64_t n, double thresh,
                         double duration_offset, int64_t* out_indices) {
  // plain-version parity: stable ascending sort, reversed — on tied scores
  // the LARGER original index is visited first. NaN scores sort LAST
  // ascending (numpy convention) and the NaN-aware comparator keeps the
  // ordering a strict weak order (raw operator< on NaN is not).
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    const bool na = std::isnan(scores[a]), nb = std::isnan(scores[b]);
    if (na || nb) return !na && nb;  // non-NaN before NaN; NaNs equivalent
    return scores[a] < scores[b];
  });
  std::reverse(order.begin(), order.end());

  std::vector<char> suppressed(n, 0);
  int64_t n_keep = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    out_indices[n_keep++] = i;
    const double dur_i = ends[i] - starts[i] + duration_offset;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      const double inter = std::min(ends[i], ends[j]) -
                           std::max(starts[i], starts[j]) + duration_offset;
      const double dur_j = ends[j] - starts[j] + duration_offset;
      const double iou = inter / (dur_i + dur_j - inter);
      // keep rule is `iou <= thresh` exactly like the numpy plain version: a NaN
      // IoU (degenerate zero-length boxes) suppresses on both paths
      if (!(iou <= thresh)) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// TAG bottom-up box search (one labeled sequence, all tolerances).
//
// labels: length ints (0/1); scores: length doubles; up/down: n_up transition
// indices; tol: n_tol tolerances. out rows are (start, end, score) triples;
// capacity must be >= 2 * n_up * n_tol rows. Returns rows written.
//
// Matches the reference semantics exactly, including the backward-scan
// fallback score slice that includes one extra frame
// (sequence_funcs.py:134).
int64_t adt_tag_box_search(const int64_t* labels, const double* scores,
                           int64_t length, const int64_t* up,
                           const int64_t* down, int64_t n_up,
                           const double* tol, int64_t n_tol,
                           double* out, int64_t capacity_rows) {
  if (n_up == 0) return 0;

  // prefix sums: background count and raw scores
  std::vector<double> cs(length + 1, 0.0);        // cumsum(1 - labels), 1-based
  std::vector<double> score_prefix(length + 1, 0.0);
  for (int64_t t = 0; t < length; ++t) {
    cs[t + 1] = cs[t] + (1.0 - static_cast<double>(labels[t]));
    score_prefix[t + 1] = score_prefix[t] + scores[t];
  }
  auto span_score = [&](int64_t a, int64_t b) {
    const int64_t hi = std::min(b, length);
    return score_prefix[hi] - score_prefix[a];
  };

  int64_t rows = 0;
  auto emit = [&](int64_t s, int64_t e, double sc) {
    if (rows < capacity_rows) {
      out[rows * 3 + 0] = static_cast<double>(s);
      out[rows * 3 + 1] = static_cast<double>(e);
      out[rows * 3 + 2] = sc;
      ++rows;
    }
  };

  for (int64_t ti = 0; ti < n_tol; ++ti) {
    const double t = tol[ti];
    // signal[i] = cs(i) - t * i, evaluated lazily (cs here is cumsum up to
    // and including index i, i.e. the reference's cs[i] = cumsum(1-labels)[i])
    auto signal = [&](int64_t i) { return cs[i + 1] - t * static_cast<double>(i); };

    // forward: close each start at the first later start with higher signal
    for (int64_t x = 0; x < n_up; ++x) {
      const double s = signal(up[x]);
      bool closed = false;
      for (int64_t y = x + 1; y < n_up; ++y) {
        if (signal(up[y]) > s) {
          emit(up[x], down[y - 1] + 1, span_score(up[x], down[y - 1] + 1));
          closed = true;
          break;
        }
      }
      if (!closed) {
        emit(up[x], down[n_up - 1] + 1, span_score(up[x], down[n_up - 1] + 1));
      }
    }
    // backward: open each end at the last earlier end with lower signal
    for (int64_t x = n_up - 1; x >= 0; --x) {
      const double s = (down[x] < length) ? signal(down[x])
                                          : (signal(length - 1) - t);
      bool opened = false;
      for (int64_t y = x - 1; y >= 0; --y) {
        if (signal(down[y]) < s) {
          emit(up[y + 1], down[x] + 1, span_score(up[y + 1], down[x] + 1));
          opened = true;
          break;
        }
      }
      if (!opened) {
        // reference quirk: score includes one extra frame
        emit(up[0], down[x] + 1, span_score(0, down[x] + 1 + 1));
      }
    }
  }
  return rows;
}

}  // extern "C"
