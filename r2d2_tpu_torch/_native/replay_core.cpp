// Native replay core: the host-side data-plane hot ops as C++ (the port's
// own copy of the JAX package's replay core, with the same C ABI).
//
// The sum-tree update/sample, the IS weights and the window-gather batch
// assembly, loaded via ctypes (r2d2_tpu_torch/_native/__init__.py) and used
// by replay/sum_tree.py and replay/replay_buffer.py when
// config.use_native_replay is set (the default).
//
// Layout contract (matches replay/sum_tree.py): a complete binary tree in
// one double array; num_layers layers; node 0 is the root; node i's
// children are 2i+1, 2i+2; leaf k lives at k + 2^(num_layers-1) - 1.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -fopenmp (_native/__init__.py,
// at first use).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Set leaf priorities to |td|^alpha and resum ancestors bottom-up.
// Duplicate idxes are fine: parents are recomputed from child values, so
// the last write per leaf wins and every touched ancestor is exact.
void tree_update(double* tree, int64_t num_layers, const int64_t* idxes,
                 const double* td, int64_t n, double alpha) {
  if (n <= 0) return;
  const int64_t leaf_offset = (int64_t{1} << (num_layers - 1)) - 1;
  std::vector<int64_t> nodes(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t node = idxes[i] + leaf_offset;
    tree[node] = std::pow(td[i], alpha);
    nodes[i] = node;
  }
  // layer-by-layer parent resummation over the deduplicated frontier
  for (int64_t layer = 0; layer < num_layers - 1; ++layer) {
    for (auto& node : nodes) node = (node - 1) / 2;
    std::sort(nodes.begin(), nodes.end());
    nodes.erase(std::unique(nodes.begin(), nodes.end()), nodes.end());
    for (const int64_t node : nodes)
      tree[node] = tree[2 * node + 1] + tree[2 * node + 2];
  }
}

// Stratified descent: for each prefix sum, walk root->leaf. Writes the
// absolute node index (caller subtracts leaf_offset).
void tree_sample(const double* tree, int64_t num_layers, const double* prefix,
                 int64_t n, int64_t* out_nodes) {
  for (int64_t i = 0; i < n; ++i) {
    double p = prefix[i];
    int64_t node = 0;
    for (int64_t layer = 0; layer < num_layers - 1; ++layer) {
      const int64_t left = 2 * node + 1;
      const double left_sum = tree[left];
      if (p < left_sum) {
        node = left;
      } else {
        node = left + 1;
        p -= left_sum;
      }
    }
    out_nodes[i] = node;
  }
}

// Batch assembly: gather B windows of T rows each from a (num_blocks, slot)
// row-major store of row_bytes-sized rows into a contiguous (B, T,
// row_bytes) output. Row index win_start[i] + t is clamped to [0, slot-1]
// (a fixed-shape window instead of a ragged one). Works for any dtype: the caller passes raw
// bytes.
void gather_windows(const uint8_t* store, int64_t slot, int64_t row_bytes,
                    const int64_t* b, const int64_t* win_start, int64_t B,
                    int64_t T, uint8_t* out) {
  const int64_t block_bytes = slot * row_bytes;
  const int64_t out_window = T * row_bytes;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < B; ++i) {
    const uint8_t* block = store + b[i] * block_bytes;
    uint8_t* dst = out + i * out_window;
    const int64_t start = win_start[i];
    // contiguous fast path: whole window in range -> one memcpy
    if (start >= 0 && start + T <= slot) {
      std::memcpy(dst, block + start * row_bytes, out_window);
      continue;
    }
    for (int64_t t = 0; t < T; ++t) {
      int64_t row = start + t;
      row = row < 0 ? 0 : (row >= slot ? slot - 1 : row);
      std::memcpy(dst + t * row_bytes, block + row * row_bytes, row_bytes);
    }
  }
}

// Multi-field window gather: one call gathers the SAME (b, win_start)
// windows from num_fields stores that share the slot axis (e.g. the
// obs/last_action/last_reward group, or the action/reward/gamma learning
// group), crossing ctypes once per field group; the single OMP region load-balances the whole slab
// (fields have wildly different row sizes — obs rows are ~7 KB, scalar
// rows 1-4 bytes — so collapsing fields x windows into one schedule keeps
// every thread busy). Field f is a (num_blocks, slot, ...) store of
// row_bytes[f]-sized rows; clamp semantics identical to gather_windows.
void gather_windows_multi(const uint8_t* const* stores,
                          const int64_t* row_bytes, int64_t num_fields,
                          int64_t slot, const int64_t* b,
                          const int64_t* win_start, int64_t B, int64_t T,
                          uint8_t* const* outs) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t f = 0; f < num_fields; ++f) {
    for (int64_t i = 0; i < B; ++i) {
      const int64_t rb = row_bytes[f];
      const uint8_t* block = stores[f] + b[i] * slot * rb;
      uint8_t* dst = outs[f] + i * T * rb;
      const int64_t start = win_start[i];
      if (start >= 0 && start + T <= slot) {
        std::memcpy(dst, block + start * rb, T * rb);
        continue;
      }
      for (int64_t t = 0; t < T; ++t) {
        int64_t row = start + t;
        row = row < 0 ? 0 : (row >= slot ? slot - 1 : row);
        std::memcpy(dst + t * rb, block + row * rb, rb);
      }
    }
  }
}

// Priority-of-leaves lookup plus IS-weight computation in one pass:
// w_i = (max(p_i, min_positive_p) / min_positive_p)^-beta
// (with the zero-leaf clamp of replay/sum_tree.py). Returns the number of positive-priority leaves.
int64_t is_weights(const double* tree, int64_t num_layers,
                   const int64_t* nodes, int64_t n, double beta,
                   float* out_w) {
  double min_p = 0.0;
  int64_t positive = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double p = tree[nodes[i]];
    if (p > 0.0 && (positive == 0 || p < min_p)) min_p = p;
    if (p > 0.0) ++positive;
  }
  if (positive == 0) min_p = 1.0;
  for (int64_t i = 0; i < n; ++i) {
    const double p = std::max(tree[nodes[i]], min_p);
    out_w[i] = static_cast<float>(std::pow(p / min_p, -beta));
  }
  return positive;
}

// The threads an OpenMP region of the gathers runs on (1 in a build
// without OpenMP).
int64_t gather_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
