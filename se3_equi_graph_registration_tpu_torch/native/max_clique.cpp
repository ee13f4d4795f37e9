// Exact maximum-clique search (pmc-style branch & bound with greedy-coloring
// bound) — the native component behind the reference's ctypes wrapper
// (the reference's utils/max_clique.py loads utils/libpmc.so, whose binary is
// NOT shipped in the snapshot). This is a from-scratch implementation of the
// classic correspondence-consistency outlier-pruning step (cf. MAC/TEASER).
//
// C ABI matches the reference wrapper exactly (max_clique.py:31-36):
//   int32 max_clique(int32 nedges, const int32* ei, const int32* ej,
//                    int32 offset, int32 outsize, int32* output)
// ei/ej are an undirected edge list (0-based, any order/duplication; `offset`
// subtracted from ids per the pmc convention); the clique vertex ids are
// written to `output` (capacity `outsize`) and the clique size returned.
//
// Algorithm: vertices ordered by degeneracy (smallest-last); per root vertex a
// Tomita-style expansion over its later-ordered neighborhood with a greedy
// graph-coloring upper bound for pruning. Exact for arbitrary graphs; fast on
// the sparse consistency graphs of registration problems.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

using std::vector;

struct Graph {
  int n = 0;
  vector<vector<int32_t>> adj;   // sorted neighbor lists, no self loops/dups

  bool connected(int32_t a, int32_t b) const {
    const auto &la = adj[a].size() < adj[b].size() ? adj[a] : adj[b];
    const int32_t key = adj[a].size() < adj[b].size() ? b : a;
    return std::binary_search(la.begin(), la.end(), key);
  }
};

// Greedy coloring of candidate set in given order; returns per-vertex color
// numbers (1-based). max color over a set bounds its clique number.
void color_sort(const Graph &g, vector<int32_t> &cand, vector<int32_t> &colors) {
  // bucket[c] holds vertices assigned color c (0-based internally)
  static thread_local vector<vector<int32_t>> buckets;
  size_t used = 0;
  colors.resize(cand.size());
  for (size_t idx = 0; idx < cand.size(); ++idx) {
    int32_t v = cand[idx];
    size_t c = 0;
    for (; c < used; ++c) {
      bool clash = false;
      for (int32_t u : buckets[c]) {
        if (g.connected(u, v)) { clash = true; break; }
      }
      if (!clash) break;
    }
    if (c == used) {
      if (buckets.size() <= used) buckets.emplace_back();
      buckets[used].clear();
      ++used;
    }
    buckets[c].push_back(v);
  }
  // rewrite cand sorted by color ascending (classic Tomita ordering) and
  // record colors aligned with the rewritten order
  size_t pos = 0;
  for (size_t c = 0; c < used; ++c) {
    for (int32_t v : buckets[c]) {
      cand[pos] = v;
      colors[pos] = static_cast<int32_t>(c + 1);
      ++pos;
    }
    buckets[c].clear();
  }
}

void expand(const Graph &g, vector<int32_t> &cand, vector<int32_t> &clique,
            vector<int32_t> &best) {
  static thread_local vector<vector<int32_t>> pool;   // scratch per depth
  vector<int32_t> colors;
  color_sort(g, cand, colors);
  // iterate candidates from highest color down
  for (size_t i = cand.size(); i-- > 0;) {
    if (clique.size() + colors[i] <= best.size()) return;  // bound prune
    int32_t v = cand[i];
    clique.push_back(v);

    if (pool.size() <= clique.size()) pool.resize(clique.size() + 1);
    vector<int32_t> &next = pool[clique.size()];
    next.clear();
    for (size_t j = 0; j < i; ++j) {
      if (g.connected(v, cand[j])) next.push_back(cand[j]);
    }
    if (next.empty()) {
      if (clique.size() > best.size()) best = clique;
    } else {
      vector<int32_t> next_copy = next;  // expand mutates order
      expand(g, next_copy, clique, best);
    }
    clique.pop_back();
  }
}

vector<int32_t> degeneracy_order(const Graph &g) {
  vector<int32_t> deg(g.n), order;
  vector<char> removed(g.n, 0);
  order.reserve(g.n);
  for (int i = 0; i < g.n; ++i) deg[i] = static_cast<int32_t>(g.adj[i].size());
  for (int it = 0; it < g.n; ++it) {
    int32_t best_v = -1, best_d = INT32_MAX;
    for (int v = 0; v < g.n; ++v)
      if (!removed[v] && deg[v] < best_d) { best_d = deg[v]; best_v = v; }
    removed[best_v] = 1;
    order.push_back(best_v);
    for (int32_t u : g.adj[best_v]) if (!removed[u]) --deg[u];
  }
  return order;
}

}  // namespace

extern "C" int32_t max_clique(int32_t nedges, const int32_t *ei,
                              const int32_t *ej, int32_t offset,
                              int32_t outsize, int32_t *output) {
  if (nedges <= 0) return 0;
  int32_t n = 0;
  for (int32_t e = 0; e < nedges; ++e) {
    n = std::max(n, std::max(ei[e] - offset, ej[e] - offset) + 1);
  }
  Graph g;
  g.n = n;
  g.adj.assign(n, {});
  for (int32_t e = 0; e < nedges; ++e) {
    int32_t a = ei[e] - offset, b = ej[e] - offset;
    if (a == b || a < 0 || b < 0) continue;
    g.adj[a].push_back(b);
    g.adj[b].push_back(a);
  }
  for (auto &l : g.adj) {
    std::sort(l.begin(), l.end());
    l.erase(std::unique(l.begin(), l.end()), l.end());
  }

  vector<int32_t> order = degeneracy_order(g);
  vector<int32_t> rank(n);
  for (int i = 0; i < n; ++i) rank[order[i]] = i;

  vector<int32_t> best, clique;
  for (int i = 0; i < n; ++i) {
    int32_t v = order[i];
    // candidates: later-ordered neighbors of v
    vector<int32_t> cand;
    for (int32_t u : g.adj[v]) if (rank[u] > i) cand.push_back(u);
    if (cand.size() + 1 <= best.size()) continue;
    clique.assign(1, v);
    if (cand.empty()) {
      if (clique.size() > best.size()) best = clique;
    } else {
      expand(g, cand, clique, best);
    }
  }

  int32_t out_n = std::min<int32_t>(static_cast<int32_t>(best.size()), outsize);
  for (int32_t i = 0; i < out_n; ++i) output[i] = best[i] + offset;
  return out_n;
}
