// Host-side data-path loops of pvcnn_tpu_torch (a copy of
// pvcnn_tpu/native/ptio.cpp with the same C ABI and tokenization; the port
// builds its own, pvcnn_tpu_torch/native/__init__.py):
//   * parse_float_table / count_float_table: whitespace-separated float
//     tables (ShapeNet's item files), each token rounded once to float32 by
//     strtof (np.loadtxt(dtype=float32) rounds to float64 first, then to
//     float32, and differs on tokens near a float32 tie);
//   * vote_reduce_max: max-confidence vote reduction for the ShapeNet and
//     S3DIS voting evaluators (reference: evaluate/shapenet/eval.py:176-185,
//     evaluate/s3dis/eval.py:188-203), the first of equal votes winning.
//
// Plain C ABI, loaded with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse whitespace/newline-separated floats from buf[0:len).
// Returns the number of values written (<= max_vals); if the input holds more
// than max_vals values, returns -1.
int64_t parse_float_table(const char* buf, int64_t len, float* out,
                          int64_t max_vals) {
  int64_t n = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    // skip whitespace
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      ++p;
    }
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {  // unparsable token: skip it
      while (p < end && !(*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
        ++p;
      }
      continue;
    }
    if (n >= max_vals) return -1;
    out[n++] = v;
    p = next;
  }
  return n;
}

// Count values (same tokenization) so callers can size the output exactly.
int64_t count_float_table(const char* buf, int64_t len) {
  int64_t n = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      ++p;
    }
    if (p >= end) break;
    ++n;
    while (p < end && !(*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) {
      ++p;
    }
  }
  return n;
}

// Max-confidence vote reduction: for each vote v, point_idx[v] gets
// (conf[v], pred[v]) iff conf[v] is strictly greater than what it holds —
// first vote wins ties, matching the reference's `>` scan order.
void vote_reduce_max(const float* vote_conf, const int64_t* vote_pred,
                     const int64_t* point_idx, int64_t num_votes,
                     float* out_conf, int64_t* out_pred) {
  for (int64_t v = 0; v < num_votes; ++v) {
    int64_t p = point_idx[v];
    if (vote_conf[v] > out_conf[p]) {
      out_conf[p] = vote_conf[v];
      out_pred[p] = vote_pred[v];
    }
  }
}

}  // extern "C"
