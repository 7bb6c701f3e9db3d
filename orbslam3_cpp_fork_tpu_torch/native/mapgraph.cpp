// Native map-graph core: the host-side keyframe/landmark graph.
//
// The reference maintains this state inside mutex-guarded objects
// (KeyFrame::UpdateConnections src/KeyFrame.cc:476-575, covisibility
// ordering :293-332, spanning tree + culling re-parenting
// SetBadFlag :657-759, loop/merge edges :617-637; MapPoint observation
// maps src/MapPoint.cc:198-269). This system keeps numeric state in
// SoA arrays on device; the *graph* bookkeeping — observation lists,
// incremental covisibility weights, spanning tree, essential-graph edge
// enumeration — is pure pointer-chasing the accelerator is bad at and
// Python is slow at, so it lives here as a small C++ core with a C ABI
// (loaded via ctypes, see native/__init__.py).
//
// Design: per-keyframe and per-landmark observation vectors plus
// per-keyframe covisibility weight maps, all updated incrementally on
// add/remove (the reference recomputes UpdateConnections from scratch
// per call). Queries never allocate; callers pass output buffers.

#include <algorithm>
#include <mutex>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MapGraph {
  // One mutex for the whole graph: every extern "C" entry locks it.
  // The SLAM runtime mutates this graph from BOTH the track thread
  // (keyframe insertion, depth seeding) and the mapping worker
  // (triangulation, fusion, culling) while the other side reads —
  // std::vector reallocation under a concurrent reader is heap
  // corruption, not just a stale answer. Contention is negligible:
  // every operation is microseconds.
  std::mutex mu;
  int32_t max_kf;
  int32_t max_lm;
  // observations
  std::vector<std::vector<int32_t>> kf_lms;  // per-kf landmark ids
  std::vector<std::vector<int32_t>> lm_kfs;  // per-lm observing kfs
  // covisibility: weight[a][b] = #shared landmarks
  std::vector<std::unordered_map<int32_t, int32_t>> weight;
  // spanning tree (reference mpParent/mspChildrens)
  std::vector<int32_t> parent;  // -1 = root/none
  // loop & merge edges (kept symmetric)
  std::vector<std::vector<int32_t>> loop_edges;
  std::vector<uint8_t> kf_alive;
  std::vector<uint8_t> lm_alive;

  explicit MapGraph(int32_t K, int32_t L)
      : max_kf(K), max_lm(L), kf_lms(K), lm_kfs(L), weight(K), parent(K, -1),
        loop_edges(K), kf_alive(K, 0), lm_alive(L, 0) {}
};

inline bool erase_value(std::vector<int32_t>& v, int32_t x) {
  auto it = std::find(v.begin(), v.end(), x);
  if (it == v.end()) return false;
  *it = v.back();
  v.pop_back();
  return true;
}

void bump(MapGraph* g, int32_t a, int32_t b, int32_t d) {
  auto& wa = g->weight[a];
  auto it = wa.find(b);
  if (it == wa.end()) {
    if (d > 0) wa.emplace(b, d);
  } else {
    it->second += d;
    if (it->second <= 0) wa.erase(it);
  }
}

}  // namespace

extern "C" {

MapGraph* mg_create(int32_t max_kf, int32_t max_lm) {
  return new MapGraph(max_kf, max_lm);
}

void mg_destroy(MapGraph* g) { delete g; }

void mg_add_keyframe(MapGraph* g, int32_t kf) { std::lock_guard<std::mutex> lk(g->mu); g->kf_alive[kf] = 1; }

// Add observations kf -> lm_ids[0..n). Updates covisibility weights
// incrementally and sets the spanning-tree parent on first connection
// (reference Tracking/LocalMapping call UpdateConnections after
// binding observations; parent = strongest covisible, KeyFrame.cc:563).
void mg_add_observations(MapGraph* g, int32_t kf, const int32_t* lm_ids,
                         int32_t n) { std::lock_guard<std::mutex> lk(g->mu);
  g->kf_alive[kf] = 1;
  auto& mine = g->kf_lms[kf];
  for (int32_t i = 0; i < n; ++i) {
    int32_t lm = lm_ids[i];
    if (lm < 0 || lm >= g->max_lm) continue;
    auto& obs = g->lm_kfs[lm];
    if (std::find(obs.begin(), obs.end(), kf) != obs.end()) continue;
    g->lm_alive[lm] = 1;
    for (int32_t other : obs) {
      bump(g, kf, other, 1);
      bump(g, other, kf, 1);
    }
    obs.push_back(kf);
    mine.push_back(lm);
  }
  if (g->parent[kf] < 0) {
    // strongest covisible becomes parent (if any)
    int32_t best = -1, bw = 0;
    for (auto& [other, w] : g->weight[kf])
      if (w > bw && g->kf_alive[other] && other != kf) { bw = w; best = other; }
    g->parent[kf] = best;
  }
}

static void remove_observations_impl(MapGraph* g, int32_t kf,
                                     const int32_t* lm_ids, int32_t n) {
  auto& mine = g->kf_lms[kf];
  for (int32_t i = 0; i < n; ++i) {
    int32_t lm = lm_ids[i];
    if (lm < 0 || lm >= g->max_lm) continue;
    auto& obs = g->lm_kfs[lm];
    if (!erase_value(obs, kf)) continue;
    erase_value(mine, lm);
    for (int32_t other : obs) {
      bump(g, kf, other, -1);
      bump(g, other, kf, -1);
    }
  }
}

void mg_remove_observations(MapGraph* g, int32_t kf, const int32_t* lm_ids,
                            int32_t n) { std::lock_guard<std::mutex> lk(g->mu);
  remove_observations_impl(g, kf, lm_ids, n);
}

// Remove a landmark everywhere (MapPoint::SetBadFlag).
void mg_remove_landmark(MapGraph* g, int32_t lm) { std::lock_guard<std::mutex> lk(g->mu);
  auto& obs = g->lm_kfs[lm];
  for (size_t i = 0; i < obs.size(); ++i) {
    int32_t a = obs[i];
    erase_value(g->kf_lms[a], lm);
    for (size_t j = i + 1; j < obs.size(); ++j) {
      int32_t b = obs[j];
      bump(g, a, b, -1);
      bump(g, b, a, -1);
    }
  }
  obs.clear();
  g->lm_alive[lm] = 0;
}

// Remove a keyframe: drop observations, re-parent spanning-tree
// children to the best-connected alive candidate (the reference walks
// candidate parents maximizing covisibility, KeyFrame::SetBadFlag
// :657-759; grandparent fallback).
void mg_remove_keyframe(MapGraph* g, int32_t kf) { std::lock_guard<std::mutex> lk(g->mu);
  // drop observations (weights) — unlocked impl: mu is already held
  auto lms = g->kf_lms[kf];  // copy
  remove_observations_impl(g, kf, lms.data(), (int32_t)lms.size());
  g->kf_lms[kf].clear();
  // symmetric loop edges
  for (int32_t other : g->loop_edges[kf]) erase_value(g->loop_edges[other], kf);
  g->loop_edges[kf].clear();
  int32_t gp = g->parent[kf];
  g->kf_alive[kf] = 0;
  g->weight[kf].clear();
  // re-parent children
  for (int32_t c = 0; c < g->max_kf; ++c) {
    if (!g->kf_alive[c] || g->parent[c] != kf) continue;
    int32_t best = -1, bw = -1;
    for (auto& [other, w] : g->weight[c]) {
      if (!g->kf_alive[other] || other == c) continue;
      if (w > bw) { bw = w; best = other; }
    }
    g->parent[c] = best >= 0 ? best : gp;
  }
  g->parent[kf] = -1;
}

int32_t mg_covis_weight(MapGraph* g, int32_t a, int32_t b) { std::lock_guard<std::mutex> lk(g->mu);
  auto& wa = g->weight[a];
  auto it = wa.find(b);
  return it == wa.end() ? 0 : it->second;
}

// All covisibility weights of kf into out[max_kf] (dense row).
void mg_covis_row(MapGraph* g, int32_t kf, int32_t* out) { std::lock_guard<std::mutex> lk(g->mu);
  std::memset(out, 0, sizeof(int32_t) * g->max_kf);
  for (auto& [other, w] : g->weight[kf])
    if (g->kf_alive[other]) out[other] = w;
}

// Top covisible neighbors with weight >= min_w, sorted by descending
// weight (GetBestCovisibilityKeyFrames / GetCovisiblesByWeight).
// Returns count written (<= cap).
int32_t mg_covis_neighbors(MapGraph* g, int32_t kf, int32_t min_w,
                           int32_t cap, int32_t* out) { std::lock_guard<std::mutex> lk(g->mu);
  std::vector<std::pair<int32_t, int32_t>> ws;  // (-w, id) for stable sort
  ws.reserve(g->weight[kf].size());
  for (auto& [other, w] : g->weight[kf])
    if (w >= min_w && g->kf_alive[other]) ws.emplace_back(-w, other);
  std::sort(ws.begin(), ws.end());
  int32_t n = std::min<int32_t>((int32_t)ws.size(), cap);
  for (int32_t i = 0; i < n; ++i) out[i] = ws[i].second;
  return n;
}

int32_t mg_parent(MapGraph* g, int32_t kf) { std::lock_guard<std::mutex> lk(g->mu); return g->parent[kf]; }
void mg_set_parent(MapGraph* g, int32_t kf, int32_t p) { std::lock_guard<std::mutex> lk(g->mu); g->parent[kf] = p; }

void mg_add_loop_edge(MapGraph* g, int32_t a, int32_t b) { std::lock_guard<std::mutex> lk(g->mu);
  auto& ea = g->loop_edges[a];
  if (std::find(ea.begin(), ea.end(), b) == ea.end()) ea.push_back(b);
  auto& eb = g->loop_edges[b];
  if (std::find(eb.begin(), eb.end(), a) == eb.end()) eb.push_back(a);
}

// Essential-graph edges (OptimizeEssentialGraph edge set,
// src/Optimizer.cc:1489-1789): spanning tree + loop edges + covisibility
// >= min_w. Pairs (a < b) written to out as [a0,b0,a1,b1,...].
// Returns pair count (<= cap).
int32_t mg_essential_edges(MapGraph* g, int32_t min_w, int32_t cap,
                           int32_t* out) { std::lock_guard<std::mutex> lk(g->mu);
  int32_t n = 0;
  auto push = [&](int32_t a, int32_t b) {
    if (a > b) std::swap(a, b);
    for (int32_t i = 0; i < n; ++i)
      if (out[2 * i] == a && out[2 * i + 1] == b) return;
    if (n < cap) { out[2 * n] = a; out[2 * n + 1] = b; ++n; }
  };
  for (int32_t k = 0; k < g->max_kf; ++k) {
    if (!g->kf_alive[k]) continue;
    if (g->parent[k] >= 0 && g->kf_alive[g->parent[k]]) push(k, g->parent[k]);
    for (int32_t other : g->loop_edges[k])
      if (g->kf_alive[other]) push(k, other);
    for (auto& [other, w] : g->weight[k])
      if (w >= min_w && g->kf_alive[other] && other > k) push(k, other);
  }
  return n;
}

// Landmark observers into out[cap]; returns count.
int32_t mg_lm_observers(MapGraph* g, int32_t lm, int32_t cap, int32_t* out) { std::lock_guard<std::mutex> lk(g->mu);
  auto& obs = g->lm_kfs[lm];
  int32_t n = std::min<int32_t>((int32_t)obs.size(), cap);
  for (int32_t i = 0; i < n; ++i) out[i] = obs[i];
  return n;
}

int32_t mg_kf_landmarks(MapGraph* g, int32_t kf, int32_t cap, int32_t* out) { std::lock_guard<std::mutex> lk(g->mu);
  auto& v = g->kf_lms[kf];
  int32_t n = std::min<int32_t>((int32_t)v.size(), cap);
  for (int32_t i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

int32_t mg_n_obs(MapGraph* g, int32_t lm) { std::lock_guard<std::mutex> lk(g->mu);
  return (int32_t)g->lm_kfs[lm].size();
}

}  // extern "C"
