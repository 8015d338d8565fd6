// Native host-side graph kernels (C++/OpenMP) for the TPU framework.
//
// TPU-native counterpart of the reference's CPU sampling/compaction core:
//  * rowwise neighbor sampling    (reference: src/array/cpu/
//    rowwise_sampling.cc + rowwise_pick.h, OpenMP over seed rows)
//  * to_block bipartite compaction (reference: src/graph/transform/
//    to_bipartite.cc:31, IdHashMap-based, CPU-only there too)
//
// The device computes; the host feeds it.  These loops sit on the
// sampler->device critical path of minibatch training, so they are native
// exactly where the reference is native.  Exposed via a tiny C ABI and
// loaded with ctypes (no pybind11 dependency).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <random>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Counter-based per-row RNG (splitmix64).  Each seed row draws from a
// stream keyed on (global seed, row index), so the sample is a pure
// function of (graph, seeds, seed) — identical across thread counts,
// OpenMP schedules, and processes (multi-process sampler workers must
// reproduce the trainer's stream; the reference gets this implicitly by
// running one RNG per row batch in rowwise_pick.h).
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline uint64_t row_stream(uint64_t seed, int64_t row) {
  uint64_t s = seed ^ (0xD1B54A32D192ED03ULL * (uint64_t)(row + 1));
  (void)splitmix64(&s);  // burn one step to decorrelate nearby rows
  return s;
}

// Sample up to `fanout` in-edges for each seed without replacement.
// indptr (n+1), src (E): CSC arrays.  out_pos must hold seeds*fanout
// entries; out_counts holds per-seed sample counts.  Returns total edges.
int64_t rowwise_sample(const int32_t* indptr, const int32_t* /*src*/,
                       const int32_t* seeds, int64_t num_seeds,
                       int32_t fanout, uint64_t seed,
                       int64_t* out_pos, int32_t* out_counts) {
#pragma omp parallel
  {
    std::vector<int64_t> res(fanout);
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < num_seeds; ++i) {
      const int64_t lo = indptr[seeds[i]];
      const int64_t hi = indptr[seeds[i] + 1];
      const int64_t deg = hi - lo;
      int64_t* out = out_pos + i * fanout;
      if (deg <= fanout) {
        for (int64_t j = 0; j < deg; ++j) out[j] = lo + j;
        out_counts[i] = static_cast<int32_t>(deg);
      } else {
        // reservoir sampling (reference rowwise_pick.h uses the same
        // pattern for the without-replacement case)
        uint64_t s = row_stream(seed, i);
        for (int32_t j = 0; j < fanout; ++j) res[j] = lo + j;
        for (int64_t j = fanout; j < deg; ++j) {
          const uint64_t k = splitmix64(&s) % static_cast<uint64_t>(j + 1);
          if (k < static_cast<uint64_t>(fanout)) res[k] = lo + j;
        }
        std::memcpy(out, res.data(), sizeof(int64_t) * fanout);
        out_counts[i] = fanout;
      }
    }
  }
  int64_t total = 0;
  for (int64_t i = 0; i < num_seeds; ++i) total += out_counts[i];
  return total;
}

// Sample `fanout` in-edges WITH replacement (always exactly fanout for
// seeds with degree > 0; zero-degree seeds get count 0).
int64_t rowwise_sample_replace(const int32_t* indptr, const int32_t* seeds,
                               int64_t num_seeds, int32_t fanout,
                               uint64_t seed, int64_t* out_pos,
                               int32_t* out_counts) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < num_seeds; ++i) {
    const int64_t lo = indptr[seeds[i]];
    const int64_t deg = indptr[seeds[i] + 1] - lo;
    int64_t* out = out_pos + i * fanout;
    if (deg == 0) {
      out_counts[i] = 0;
      continue;
    }
    uint64_t s = row_stream(seed, i);
    for (int32_t j = 0; j < fanout; ++j)
      out[j] = lo + static_cast<int64_t>(splitmix64(&s) % (uint64_t)deg);
    out_counts[i] = fanout;
  }
  int64_t total = 0;
  for (int64_t i = 0; i < num_seeds; ++i) total += out_counts[i];
  return total;
}

// Relabel frontier endpoints into block-local ids.  dst_nodes (n_dst) are
// assigned 0..n_dst-1; unseen src endpoints get fresh ids after them.
// mapping: scratch array of size num_nodes initialised to -1 (int64).
// Returns the number of src nodes (n_dst + new).
int64_t compact_block(const int32_t* src, const int32_t* dst, int64_t E,
                      const int32_t* dst_nodes, int64_t n_dst,
                      int64_t* mapping, int32_t* out_src, int32_t* out_dst,
                      int32_t* out_src_ids) {
  for (int64_t i = 0; i < n_dst; ++i) {
    mapping[dst_nodes[i]] = i;
    out_src_ids[i] = dst_nodes[i];
  }
  int64_t next_id = n_dst;
  for (int64_t e = 0; e < E; ++e) {
    const int32_t u = src[e];
    if (mapping[u] < 0) {
      mapping[u] = next_id;
      out_src_ids[next_id] = u;
      ++next_id;
    }
    out_src[e] = static_cast<int32_t>(mapping[u]);
    out_dst[e] = static_cast<int32_t>(mapping[dst[e]]);
  }
  // reset mapping for reuse
  for (int64_t i = 0; i < next_id; ++i) mapping[out_src_ids[i]] = -1;
  return next_id;
}

// Streaming Fennel partitioning (the METIS_PartGraphKway stand-in;
// reference: src/graph/metis_partition.cc:35).  Sequential by nature;
// native because the per-node greedy loop is Python-prohibitive at 1M+
// nodes.  indptr_in/src = CSC (in-nbrs); indptr_out/dst = out-nbrs
// (dst_by_src).  order = visit order (caller shuffles).  parts in/out,
// initialised to -1.
void fennel_partition(const int32_t* indptr_in, const int32_t* src,
                      const int32_t* indptr_out, const int32_t* dst,
                      const int32_t* order, int64_t n, int64_t E,
                      int32_t k, double gamma, double slack,
                      int32_t num_passes, int32_t* parts) {
  std::vector<int64_t> sizes(k, 0);
  std::vector<double> score(k, 0.0);
  std::vector<double> size_penalty(k, 0.0);
  const double alpha =
      E * std::pow((double)k, gamma - 1.0) / std::pow((double)n, gamma);
  const double cap = slack * (double)n / k;
  for (int32_t pass = 0; pass < num_passes; ++pass) {
    for (int64_t i = 0; i < n; ++i) {
      const int32_t v = order[i];
      const int32_t old = parts[v];
      if (old >= 0) sizes[old] -= 1;
      std::fill(score.begin(), score.end(), 0.0);
      for (int64_t e = indptr_in[v]; e < indptr_in[v + 1]; ++e) {
        const int32_t p = parts[src[e]];
        if (p >= 0) score[p] += 1.0;
      }
      for (int64_t e = indptr_out[v]; e < indptr_out[v + 1]; ++e) {
        const int32_t p = parts[dst[e]];
        if (p >= 0) score[p] += 1.0;
      }
      int32_t best = 0;
      double best_s = -1e300;
      for (int32_t p = 0; p < k; ++p) {
        if (sizes[p] >= cap) continue;
        const double s = score[p] - alpha * gamma * 0.5 *
            std::pow((double)std::max<int64_t>(sizes[p], 1), gamma - 1.0);
        if (s > best_s) { best_s = s; best = p; }
      }
      parts[v] = best;
      sizes[best] += 1;
    }
  }
}

// Weighted Fennel: node v carries weight vw[v] (callers use 1 + in-degree
// so that per-part OWNED-EDGE counts are balanced alongside node counts —
// the spatial plan pads every part to the max part's edge count, so edge
// imbalance is a direct padded-FLOPs tax; see SCALING_CPU.json).  Greedy
// objective is the standard vertex-weighted generalisation: marginal
// balance penalty scales with the node's weight, and a HARD weighted cap
// (slack * total_w / k) bounds the max part weight; if every part is
// capped (can happen late in a pass with skewed weights) the node falls
// back to the lightest part.  Reference quality bar: METIS with vwgt
// (src/graph/metis_partition.cc:35 passes vwgt=NULL; we go one better
// because padding, not just comm, is the TPU cost).
void fennel_partition_w(const int32_t* indptr_in, const int32_t* src,
                        const int32_t* indptr_out, const int32_t* dst,
                        const int32_t* order, const int32_t* vw,
                        int64_t n, int64_t E, int32_t k, double gamma,
                        double slack, int32_t num_passes, int32_t* parts) {
  std::vector<double> sizes(k, 0.0);
  std::vector<double> score(k, 0.0);
  double total_w = 0.0;
  for (int64_t i = 0; i < n; ++i) total_w += vw[i];
  const double alpha =
      E * std::pow((double)k, gamma - 1.0) /
      std::pow(std::max(total_w, 1.0), gamma);
  const double cap = slack * total_w / k;
  for (int32_t pass = 0; pass < num_passes; ++pass) {
    for (int64_t i = 0; i < n; ++i) {
      const int32_t v = order[i];
      const double w = (double)vw[v];
      const int32_t old = parts[v];
      if (old >= 0) sizes[old] -= w;
      std::fill(score.begin(), score.end(), 0.0);
      for (int64_t e = indptr_in[v]; e < indptr_in[v + 1]; ++e) {
        const int32_t p = parts[src[e]];
        if (p >= 0) score[p] += 1.0;
      }
      for (int64_t e = indptr_out[v]; e < indptr_out[v + 1]; ++e) {
        const int32_t p = parts[dst[e]];
        if (p >= 0) score[p] += 1.0;
      }
      int32_t best = -1;
      double best_s = -1e300;
      for (int32_t p = 0; p < k; ++p) {
        if (sizes[p] + w > cap) continue;
        const double s = score[p] - alpha * gamma * 0.5 * w *
            std::pow(std::max(sizes[p], 1.0), gamma - 1.0);
        if (s > best_s) { best_s = s; best = p; }
      }
      if (best < 0) {  // all capped: lightest part
        best = 0;
        for (int32_t p = 1; p < k; ++p)
          if (sizes[p] < sizes[best]) best = p;
      }
      parts[v] = best;
      sizes[best] += w;
    }
  }
}

}  // extern "C"
