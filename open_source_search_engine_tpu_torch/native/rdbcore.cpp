// rdbcore — native host core for the Rdb-lite storage engine.
//
// Reference: the byte-level list machinery of RdbList.cpp (merge_r /
// indexMerge_r: n-way merge of sorted key runs with newest-wins dedup and
// +/- tombstone annihilation) and the key compares of types.h
// (KEYCMP over key96/key128/key144). Re-designed, not ported: our keys are
// little-endian structured records whose field order is least-significant
// first, so one generic reversed-byte compare covers every database's key
// width (posdb 18B, titledb 12B, clusterdb 16B, linkdb 12B, ...), and the
// delbit is always bit 0 of byte 0.
//
// Grown from a copy of the JAX package's native/rdbcore.cpp, carried so
// that the port builds from its own sources; its key search takes many
// probes a call.
//
// Build: g++ -O3 -shared -fPIC rdbcore.cpp -o librdbcore_<hash>.so
// (driven by native/__init__.py into build/torch_native/; the numpy
// merge of index/rdblite.py computes the same function)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// compare keys as little-endian integers: bytes from most-significant
// (last) down; ignores the delbit (bit 0 of byte 0) so +/- versions of
// one record compare equal (the "identity" compare of annihilation)
inline int cmp_ident(const uint8_t* a, const uint8_t* b, int ks) {
  for (int i = ks - 1; i > 0; --i) {
    if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
  }
  uint8_t a0 = a[0] & 0xFEu, b0 = b[0] & 0xFEu;
  if (a0 != b0) return a0 < b0 ? -1 : 1;
  return 0;
}

}  // namespace

extern "C" {

// N-way merge of sorted runs (oldest..newest) of fixed-size keys.
// Newest-wins on identity-equal keys; surviving tombstones (delbit==0)
// are dropped unless keep_tombstones. Returns records written to out
// (caller allocates sum(counts)*key_size bytes — the worst case).
int64_t osse_merge_runs(const uint8_t** runs, const int64_t* counts,
                        int32_t n_runs, int32_t key_size,
                        int32_t keep_tombstones, uint8_t* out) {
  std::vector<int64_t> pos(n_runs, 0);
  int64_t written = 0;
  for (;;) {
    // find the smallest head; among identity-equal heads the NEWEST run
    // (highest index) supplies the surviving record
    int best = -1;
    const uint8_t* best_key = nullptr;
    for (int r = 0; r < n_runs; ++r) {
      if (pos[r] >= counts[r]) continue;
      const uint8_t* k = runs[r] + pos[r] * key_size;
      if (best < 0 || cmp_ident(k, best_key, key_size) < 0) {
        best = r;
        best_key = k;
      }
    }
    if (best < 0) break;  // all runs exhausted
    // advance every run past records identity-equal to best_key,
    // remembering the newest version
    const uint8_t* winner = nullptr;
    for (int r = 0; r < n_runs; ++r) {
      while (pos[r] < counts[r]) {
        const uint8_t* k = runs[r] + pos[r] * key_size;
        if (cmp_ident(k, best_key, key_size) != 0) break;
        winner = k;  // runs are oldest..newest; later r overrides
        ++pos[r];
      }
    }
    const bool positive = (winner[0] & 1u) != 0;
    if (positive || keep_tombstones) {
      std::memcpy(out + written * key_size, winner, key_size);
      ++written;
    }
  }
  return written;
}

// lower(side[j] = 0) or upper(side[j] = 1) bound of each of m probes in a
// sorted run, into out[j], comparing full keys (delbit included, as the
// least-significant bit).
void osse_searchsorted_many(const uint8_t* run, int64_t n, int32_t key_size,
                            const uint8_t* probes, int64_t m,
                            const uint8_t* side, int64_t* out) {
  for (int64_t j = 0; j < m; ++j) {
    const uint8_t* probe = probes + j * key_size;
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = lo + ((hi - lo) >> 1);
      const uint8_t* k = run + mid * key_size;
      int c = 0;
      for (int i = key_size - 1; i >= 0; --i) {
        if (k[i] != probe[i]) {
          c = k[i] < probe[i] ? -1 : 1;
          break;
        }
      }
      if (c < 0 || (side[j] == 1 && c == 0)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[j] = lo;
  }
}

}  // extern "C"
