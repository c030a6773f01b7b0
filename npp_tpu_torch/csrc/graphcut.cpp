// Alpha-expansion multi-label graph cut (host CPU).
//
// A copy of npp_tpu/native/graphcut.cpp for the PyTorch port, built by
// npp_tpu_torch/kernels/build.py::build_host_library with g++ and bound
// with ctypes (npp_tpu_torch/segmentation/graphcut.py). It stands in for
// the external pyGCO/gco-v3 C++ dependency the reference imports (reference: NPP_segmentation/imsegm/graph_cuts.py:11-15,
// 736-748: cut_general_graph(edges, edge_weights, unary, pairwise,
// algorithm='expansion')). Graph cut is irregular, branchy and tiny
// (superpixel graphs: O(10^3) nodes) — a host-native solver is the right
// tool; the dense work (SLIC) runs on the accelerator.
//
// Energy: E(L) = sum_v unary[v][L_v] + sum_{(u,v) in edges} w_uv *
//                pairwise[L_u][L_v]
// minimised by iterated alpha-expansion moves (Boykov-Veksler-Zabih, PAMI'01),
// each move solved exactly as an s-t min cut. The binary subproblem uses the
// standard auxiliary-node construction for neighbours with differing labels
// and requires pairwise to be a semi-metric (diag 0, symmetric, triangle
// inequality) — satisfied by the Potts matrices the pipeline builds
// (graph_cuts.py:485-520 with uniform gc_regul).
//
// Max-flow: Dinic with arc mirroring; exact for these graph sizes.

#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct Dinic {
  struct Arc {
    int to;
    double cap;
    int rev;
  };
  std::vector<std::vector<Arc>> g;
  std::vector<int> level, iter;

  explicit Dinic(int n) : g(n), level(n), iter(n) {}

  void add_edge(int u, int v, double cap_uv, double cap_vu) {
    if (cap_uv <= 0 && cap_vu <= 0) return;
    g[u].push_back({v, cap_uv, static_cast<int>(g[v].size())});
    g[v].push_back({u, cap_vu, static_cast<int>(g[u].size()) - 1});
  }

  bool bfs(int s, int t) {
    std::fill(level.begin(), level.end(), -1);
    std::queue<int> q;
    level[s] = 0;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Arc& a : g[v]) {
        if (a.cap > 1e-12 && level[a.to] < 0) {
          level[a.to] = level[v] + 1;
          q.push(a.to);
        }
      }
    }
    return level[t] >= 0;
  }

  double dfs(int v, int t, double f) {
    if (v == t) return f;
    for (int& i = iter[v]; i < static_cast<int>(g[v].size()); ++i) {
      Arc& a = g[v][i];
      if (a.cap > 1e-12 && level[v] < level[a.to]) {
        double d = dfs(a.to, t, std::min(f, a.cap));
        if (d > 0) {
          a.cap -= d;
          g[a.to][a.rev].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  double max_flow(int s, int t) {
    double flow = 0;
    const double inf = std::numeric_limits<double>::infinity();
    while (bfs(s, t)) {
      std::fill(iter.begin(), iter.end(), 0);
      double f;
      while ((f = dfs(s, t, inf)) > 0) flow += f;
    }
    return flow;
  }

  // nodes reachable from s in the residual graph -> source side (x = 0)
  void min_cut_side(int s, std::vector<char>* side) const {
    std::fill(side->begin(), side->end(), 0);
    std::queue<int> q;
    (*side)[s] = 1;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Arc& a : g[v]) {
        if (a.cap > 1e-12 && !(*side)[a.to]) {
          (*side)[a.to] = 1;
          q.push(a.to);
        }
      }
    }
  }
};

double total_energy(int n_nodes, int n_edges, int n_labels,
                    const int32_t* edges, const double* w,
                    const double* unary, const double* pw,
                    const int32_t* labels) {
  double e = 0;
  for (int v = 0; v < n_nodes; ++v) e += unary[v * n_labels + labels[v]];
  for (int i = 0; i < n_edges; ++i) {
    int u = edges[2 * i], v = edges[2 * i + 1];
    e += w[i] * pw[labels[u] * n_labels + labels[v]];
  }
  return e;
}

}  // namespace

extern "C" {

// Returns the number of expansion sweeps performed; labels_out holds the
// argmin labelling. max_sweeps < 0 means run to convergence.
int alpha_expansion(int n_nodes, int n_edges, int n_labels,
                    const int32_t* edges, const double* edge_weights,
                    const double* unary, const double* pairwise,
                    int max_sweeps, int32_t* labels_out) {
  std::vector<int32_t> labels(n_nodes);
  // init: per-node argmin of unary (graph_cuts.py initialises via argmax
  // proba which equals argmin unary)
  for (int v = 0; v < n_nodes; ++v) {
    int best = 0;
    for (int l = 1; l < n_labels; ++l)
      if (unary[v * n_labels + l] < unary[v * n_labels + best]) best = l;
    labels[v] = best;
  }

  double energy = total_energy(n_nodes, n_edges, n_labels, edges, edge_weights,
                               unary, pairwise, labels.data());
  int sweeps = 0;
  const int limit = max_sweeps < 0 ? 64 : max_sweeps;
  bool improved = true;
  while (improved && sweeps < limit) {
    improved = false;
    ++sweeps;
    for (int alpha = 0; alpha < n_labels; ++alpha) {
      // binary problem: x_v = 1 -> switch to alpha, 0 -> keep label
      // graph nodes: [0, n_nodes) vars, then one aux node per differing edge,
      // then source s, sink t.
      int n_aux = 0;
      for (int i = 0; i < n_edges; ++i)
        if (labels[edges[2 * i]] != labels[edges[2 * i + 1]]) ++n_aux;
      int s = n_nodes + n_aux, t = s + 1;
      Dinic din(t + 1);
      // convention: source side (reachable) => x = 0 (keep);
      // t-link source->v with cap = cost(x_v = 1), v->sink cap = cost(x_v = 0)
      // (cutting the source arc puts v on sink side => pays cost(1)).
      auto add_unary = [&](int v, double cost0, double cost1) {
        // normalise: only the difference matters
        if (cost1 > cost0)
          din.add_edge(s, v, cost1 - cost0, 0);
        else
          din.add_edge(v, t, cost0 - cost1, 0);
      };
      const double kInf = 1e30;
      for (int v = 0; v < n_nodes; ++v) {
        double c0 = unary[v * n_labels + labels[v]];
        double c1 = unary[v * n_labels + alpha];
        if (labels[v] == alpha) c0 = kInf;  // already alpha: force x = 1
        add_unary(v, c0, c1);
      }
      int aux = n_nodes;
      for (int i = 0; i < n_edges; ++i) {
        int u = edges[2 * i], v = edges[2 * i + 1];
        double w = edge_weights[i];
        int lu = labels[u], lv = labels[v];
        double v_ua = w * pairwise[lu * n_labels + alpha];
        double v_av = w * pairwise[alpha * n_labels + lv];
        if (lu == lv) {
          // E(0,0)=0, E(0,1)=V(l,a), E(1,0)=V(a,l), E(1,1)=0: submodular;
          // arc u->v is cut when (x_u, x_v) = (0, 1) -> cap E(0,1) = V(lu, a)
          din.add_edge(u, v, v_ua, v_av);
        } else {
          double v_uv = w * pairwise[lu * n_labels + lv];
          // auxiliary construction (BVZ fig. 4): cutting isolates the
          // configuration costs exactly for a semi-metric
          din.add_edge(u, aux, v_ua, v_ua);
          din.add_edge(v, aux, v_av, v_av);
          din.add_edge(aux, t, v_uv, 0);
          ++aux;
        }
      }
      din.max_flow(s, t);
      std::vector<char> side(t + 1);
      din.min_cut_side(s, &side);
      std::vector<int32_t> trial(labels);
      for (int v = 0; v < n_nodes; ++v)
        if (!side[v]) trial[v] = alpha;  // sink side -> x = 1 -> switch
      double e2 = total_energy(n_nodes, n_edges, n_labels, edges, edge_weights,
                               unary, pairwise, trial.data());
      if (e2 < energy - 1e-9) {
        energy = e2;
        labels.swap(trial);
        improved = true;
      }
    }
  }
  std::memcpy(labels_out, labels.data(), n_nodes * sizeof(int32_t));
  return sweeps;
}

double graphcut_energy(int n_nodes, int n_edges, int n_labels,
                       const int32_t* edges, const double* edge_weights,
                       const double* unary, const double* pairwise,
                       const int32_t* labels) {
  return total_energy(n_nodes, n_edges, n_labels, edges, edge_weights, unary,
                      pairwise, labels);
}
}
