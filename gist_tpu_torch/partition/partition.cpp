// Native graph partitioner: multilevel k-way over CSR.
//
// TPU-native replacement for the METIS dependency behind
// dgl.transform.metis_partition (reference: partition_utils.py:11-18).
// `greedy_partition` is the single-level BFS graph-growing heuristic;
// `refined_partition` is the METIS-grade multilevel pipeline
// (heavy-edge-matching coarsening -> BFS initial partition -> greedy
// k-way boundary refinement at every uncoarsening level), which cuts
// 30-60% more edges than plain BFS on clustered graphs.  Partition
// quality drives both Cluster-GCN accuracy and the SpMM kernel's
// per-tile sender dedup factor.
//
// Build: make -C gist_tpu/partition  (produces libgistpart.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
  }
  void shuffle(std::vector<int64_t>& v) {
    for (int64_t i = (int64_t)v.size() - 1; i > 0; --i)
      std::swap(v[i], v[(int64_t)(next() % (uint64_t)(i + 1))]);
  }
};

// Weighted CSR graph owned level-by-level during coarsening.
struct CGraph {
  std::vector<int64_t> indptr, adj, ewgt, vwgt;
  int64_t n() const { return (int64_t)indptr.size() - 1; }
};

// Heavy-edge matching: each unmatched node pairs with its heaviest
// unmatched neighbor.  Returns coarse node count; fills cmap.
int64_t hem_match(const CGraph& g, Rng& rng, std::vector<int64_t>& cmap) {
  const int64_t n = g.n();
  cmap.assign(n, -1);
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  rng.shuffle(order);
  int64_t nc = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t u = order[oi];
    if (cmap[u] >= 0) continue;
    int64_t best = -1, bw = -1;
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      const int64_t v = g.adj[e];
      if (v != u && cmap[v] < 0 && g.ewgt[e] > bw) { bw = g.ewgt[e]; best = v; }
    }
    cmap[u] = nc;
    if (best >= 0) cmap[best] = nc;
    ++nc;
  }
  return nc;
}

// Contract g by cmap into out (aggregating edge/node weights).
void contract(const CGraph& g, const std::vector<int64_t>& cmap, int64_t nc,
              CGraph& out) {
  const int64_t n = g.n();
  out.vwgt.assign(nc, 0);
  for (int64_t u = 0; u < n; ++u) out.vwgt[cmap[u]] += g.vwgt[u];
  // bucket fine nodes by coarse id
  std::vector<int64_t> cnt(nc + 1, 0), members(n);
  for (int64_t u = 0; u < n; ++u) ++cnt[cmap[u] + 1];
  for (int64_t c = 0; c < nc; ++c) cnt[c + 1] += cnt[c];
  {
    std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
    for (int64_t u = 0; u < n; ++u) members[pos[cmap[u]]++] = u;
  }
  out.indptr.assign(nc + 1, 0);
  out.adj.clear(); out.ewgt.clear();
  // dense marker with epoch trick for neighbor dedup
  std::vector<int64_t> mark(nc, -1), slot(nc, 0);
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t start = (int64_t)out.adj.size();
    for (int64_t mi = cnt[c]; mi < cnt[c + 1]; ++mi) {
      const int64_t u = members[mi];
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        const int64_t vc = cmap[g.adj[e]];
        if (vc == c) continue;  // internal edge disappears
        if (mark[vc] != c) {
          mark[vc] = c;
          slot[vc] = (int64_t)out.adj.size();
          out.adj.push_back(vc);
          out.ewgt.push_back(g.ewgt[e]);
        } else {
          out.ewgt[slot[vc]] += g.ewgt[e];
        }
      }
    }
    (void)start;
    out.indptr[c + 1] = (int64_t)out.adj.size();
  }
}

// BFS graph growing on a weighted graph (initial partition).
void grow_initial(const CGraph& g, int64_t psize, Rng& rng,
                  std::vector<int64_t>& part) {
  const int64_t n = g.n();
  part.assign(n, -1);
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) total += g.vwgt[u];
  std::vector<int64_t> visit(n);
  for (int64_t i = 0; i < n; ++i) visit[i] = i;
  rng.shuffle(visit);
  std::vector<int64_t> frontier;
  int64_t visit_ptr = 0;
  int64_t remaining = total;
  for (int64_t pid = 0; pid < psize; ++pid) {
    // dynamic target: earlier parts' BFS overshoot would otherwise
    // starve the last parts into emptiness
    const int64_t target =
        std::max<int64_t>(1, remaining / (psize - pid));
    int64_t w = 0;
    frontier.clear();
    while (w < target) {
      if (frontier.empty()) {
        while (visit_ptr < n && part[visit[visit_ptr]] >= 0) ++visit_ptr;
        if (visit_ptr >= n) return;
        const int64_t sd = visit[visit_ptr];
        part[sd] = pid; w += g.vwgt[sd];
        frontier.push_back(sd);
        continue;
      }
      const int64_t u = frontier.back(); frontier.pop_back();
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        const int64_t v = g.adj[e];
        if (part[v] < 0) {
          part[v] = pid; w += g.vwgt[v];
          frontier.push_back(v);
          if (w >= target) break;
        }
      }
    }
    remaining -= w;
  }
  // stragglers: attach to an assigned neighbor, else round-robin
  for (int64_t u = 0; u < n; ++u) {
    if (part[u] >= 0) continue;
    int64_t best = -1, bw = -1;
    for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
      const int64_t v = g.adj[e];
      if (part[v] >= 0 && g.ewgt[e] > bw) { bw = g.ewgt[e]; best = part[v]; }
    }
    part[u] = best >= 0 ? best : (int64_t)(rng.next() % (uint64_t)psize);
  }
}

// Greedy k-way boundary refinement (bounded FM without rollback):
// move a node to the adjacent part with max connectivity gain, subject
// to a balance ceiling.  Sequential with immediate updates.
void refine(const CGraph& g, int64_t psize, std::vector<int64_t>& part,
            int max_passes) {
  const int64_t n = g.n();
  std::vector<int64_t> pw(psize, 0);
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) { pw[part[u]] += g.vwgt[u]; total += g.vwgt[u]; }
  const int64_t maxw =
      (int64_t)((double)total / (double)psize * 1.05) + 1;
  // don't let refinement empty a part (cluster samplers expect psize
  // non-empty clusters)
  const int64_t minw =
      std::max<int64_t>(1, (int64_t)((double)total / (double)psize * 0.5));
  std::vector<int64_t> conn(psize, 0), touched;
  touched.reserve(64);
  for (int pass = 0; pass < max_passes; ++pass) {
    int64_t moves = 0;
    for (int64_t u = 0; u < n; ++u) {
      const int64_t pu = part[u];
      touched.clear();
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        const int64_t pv = part[g.adj[e]];
        if (conn[pv] == 0) touched.push_back(pv);
        conn[pv] += g.ewgt[e];
      }
      int64_t best = pu, bg = 0;
      const int64_t internal = conn[pu];
      for (int64_t ti = 0; ti < (int64_t)touched.size(); ++ti) {
        const int64_t p = touched[ti];
        if (p == pu) continue;
        const int64_t gain = conn[p] - internal;
        if (gain > bg && pw[p] + g.vwgt[u] <= maxw
            && pw[pu] - g.vwgt[u] >= minw) { bg = gain; best = p; }
      }
      for (int64_t ti = 0; ti < (int64_t)touched.size(); ++ti)
        conn[touched[ti]] = 0;
      if (best != pu) {
        pw[pu] -= g.vwgt[u];
        pw[best] += g.vwgt[u];
        part[u] = best;
        ++moves;
      }
    }
    if (moves == 0) break;
  }
}

// Explicit balance phase.  refine() only accepts cut-improving moves
// inside the weight band, so parts that ARRIVE over the ceiling (lumpy
// coarse vwgt overshooting grow_initial's target, wholesale fragment
// migration) stay there — observed 0.5x-1.4x spread at small psize.
// Diffusion: an overweight part pushes boundary nodes DOWNHILL into
// any strictly-lighter adjacent part (least cut damage first).  The
// target may transiently exceed the ceiling — excess then propagates
// outward on later passes (each move lowers sum(pw^2), so this
// terminates) — which is what lets a heavy part drain through
// already-full neighbors instead of stalling and scattering nodes to
// arbitrary light parts (that fragmentation blew the lattice edge cut
// 5x in testing).  Balance feeds n_loc_pad padding and the
// slowest-device edge share in the sharded path (projected_scaling).
void balance(const CGraph& g, int64_t psize, std::vector<int64_t>& part,
             double tol) {
  const int64_t n = g.n();
  std::vector<int64_t> pw(psize, 0);
  int64_t total = 0;
  for (int64_t u = 0; u < n; ++u) {
    pw[part[u]] += g.vwgt[u];
    total += g.vwgt[u];
  }
  const int64_t maxb = (int64_t)((double)total / (double)psize * tol) + 1;
  std::vector<int64_t> conn(psize, 0), touched;
  touched.reserve(64);
  for (int pass = 0; pass < 32; ++pass) {
    bool over = false;
    for (int64_t p = 0; p < psize; ++p) over |= pw[p] > maxb;
    if (!over) return;
    int64_t moves = 0;
    for (int64_t u = 0; u < n; ++u) {
      const int64_t pu = part[u];
      if (pw[pu] <= maxb) continue;
      touched.clear();
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        const int64_t pv = part[g.adj[e]];
        if (conn[pv] == 0) touched.push_back(pv);
        conn[pv] += g.ewgt[e];
      }
      const int64_t internal = conn[pu];
      int64_t best = -1, bg = 0;
      bool have = false;
      for (int64_t ti = 0; ti < (int64_t)touched.size(); ++ti) {
        const int64_t p = touched[ti];
        // downhill only: the pair's weight gap must shrink
        if (p == pu || pw[p] + g.vwgt[u] > pw[pu] - g.vwgt[u]) continue;
        const int64_t gain = conn[p] - internal;
        if (!have || gain > bg
            || (gain == bg && pw[p] < pw[best])) {
          bg = gain; best = p; have = true;
        }
      }
      for (int64_t ti = 0; ti < (int64_t)touched.size(); ++ti)
        conn[touched[ti]] = 0;
      if (!have) continue;
      pw[pu] -= g.vwgt[u];
      pw[best] += g.vwgt[u];
      part[u] = best;
      ++moves;
    }
    if (moves == 0) break;  // only interior/stranded nodes left
  }
  // spill: still-overweight parts shed arbitrary nodes to the lightest
  // part (disconnected overweight parts, tiny graphs)
  for (int64_t u = 0; u < n && psize > 1; ++u) {
    const int64_t pu = part[u];
    if (pw[pu] <= maxb) continue;
    int64_t lightest = 0;
    for (int64_t p = 1; p < psize; ++p)
      if (pw[p] < pw[lightest]) lightest = p;
    if (pw[lightest] + g.vwgt[u] > maxb) break;  // nothing fits anywhere
    pw[pu] -= g.vwgt[u];
    pw[lightest] += g.vwgt[u];
    part[u] = lightest;
  }
}

// Connectivity cleanup: a part should be one connected region (FM moves
// strand satellite fragments, which hurts cluster semantics and halo
// locality).  Any fragment smaller than half its part migrates to the
// neighboring part it touches most.
void fragment_cleanup(const CGraph& g, int64_t psize,
                      std::vector<int64_t>& part) {
  const int64_t n = g.n();
  std::vector<int64_t> comp(n, -1), stack, comp_part, comp_size;
  int64_t ncomp = 0;
  for (int64_t u = 0; u < n; ++u) {
    if (comp[u] >= 0) continue;
    const int64_t p = part[u];
    int64_t size = 0;
    comp[u] = ncomp;
    stack.assign(1, u);
    while (!stack.empty()) {
      const int64_t v = stack.back(); stack.pop_back();
      ++size;
      for (int64_t e = g.indptr[v]; e < g.indptr[v + 1]; ++e) {
        const int64_t w = g.adj[e];
        if (comp[w] < 0 && part[w] == p) { comp[w] = ncomp; stack.push_back(w); }
      }
    }
    comp_part.push_back(p);
    comp_size.push_back(size);
    ++ncomp;
  }
  std::vector<int64_t> part_main(psize, -1), best_size(psize, -1);
  for (int64_t c = 0; c < ncomp; ++c)
    if (comp_size[c] > best_size[comp_part[c]]) {
      best_size[comp_part[c]] = comp_size[c];
      part_main[comp_part[c]] = c;
    }
  // bucket nodes by component (counting sort), then migrate non-main
  // fragments to their strongest adjacent part
  std::vector<int64_t> cstart(ncomp + 1, 0), cnodes(n);
  for (int64_t u = 0; u < n; ++u) ++cstart[comp[u] + 1];
  for (int64_t c = 0; c < ncomp; ++c) cstart[c + 1] += cstart[c];
  {
    std::vector<int64_t> pos(cstart.begin(), cstart.end() - 1);
    for (int64_t u = 0; u < n; ++u) cnodes[pos[comp[u]]++] = u;
  }
  std::vector<int64_t> conn(psize, 0), touched;
  std::vector<int64_t> members;
  for (int64_t c = 0; c < ncomp; ++c) {
    if (c == part_main[comp_part[c]]) continue;
    members.assign(cnodes.begin() + cstart[c], cnodes.begin() + cstart[c + 1]);
    touched.clear();
    for (int64_t u : members)
      for (int64_t e = g.indptr[u]; e < g.indptr[u + 1]; ++e) {
        const int64_t pv = part[g.adj[e]];
        if (pv == comp_part[c]) continue;
        if (conn[pv] == 0) touched.push_back(pv);
        conn[pv] += g.ewgt[e];
      }
    int64_t best = -1, bw = 0;
    for (int64_t p : touched) {
      if (conn[p] > bw) { bw = conn[p]; best = p; }
      conn[p] = 0;
    }
    if (best >= 0)
      for (int64_t u : members) part[u] = best;
  }
}

}  // namespace

extern "C" {

// Multilevel k-way partition (coarsen -> grow -> refine each level).
void refined_partition(const int64_t* indptr, const int64_t* nbrs,
                       int64_t n_nodes, int64_t psize, uint64_t seed,
                       int64_t* assignment) {
  if (psize <= 1) {
    std::memset(assignment, 0, sizeof(int64_t) * n_nodes);
    return;
  }
  Rng rng(seed);
  std::vector<CGraph> levels(1);
  CGraph& g0 = levels[0];
  g0.indptr.assign(indptr, indptr + n_nodes + 1);
  g0.adj.assign(nbrs, nbrs + indptr[n_nodes]);
  g0.ewgt.assign(indptr[n_nodes], 1);
  g0.vwgt.assign(n_nodes, 1);

  // Coarsen until small enough for the initial heuristic or matching stalls.
  const int64_t stop_n = std::max<int64_t>(psize * 8, 4096);
  std::vector<std::vector<int64_t>> cmaps;
  while (levels.back().n() > stop_n) {
    const CGraph& g = levels.back();
    cmaps.emplace_back();
    const int64_t nc = hem_match(g, rng, cmaps.back());
    if (nc > (int64_t)((double)g.n() * 0.95)) { cmaps.pop_back(); break; }
    CGraph coarse;
    contract(g, cmaps.back(), nc, coarse);
    levels.push_back(std::move(coarse));
  }

  std::vector<int64_t> part;
  grow_initial(levels.back(), psize, rng, part);
  refine(levels.back(), psize, part, 8);

  // Uncoarsen: project and refine at every level.
  for (int64_t li = (int64_t)cmaps.size() - 1; li >= 0; --li) {
    const std::vector<int64_t>& cmap = cmaps[li];
    std::vector<int64_t> fine(cmap.size());
    for (size_t u = 0; u < cmap.size(); ++u) fine[u] = part[cmap[u]];
    part.swap(fine);
    refine(levels[li], psize, part, li == 0 ? 4 : 6);
  }
  fragment_cleanup(levels[0], psize, part);
  // Balance once at the finest level (unit weights -> lands within
  // tol), then let a short refine pass recover cut along the moved
  // boundaries inside the 1.05 band.
  balance(levels[0], psize, part, 1.03);
  refine(levels[0], psize, part, 2);

  // Repair empty parts (cluster samplers expect psize non-empty
  // clusters): BFS-split half of the currently largest part into each.
  {
    // NB: re-reference level 0 here — the `g0` reference from before the
    // coarsening loop dangles once levels.push_back reallocates.
    const CGraph& gf = levels[0];
    std::vector<int64_t> sizes(psize, 0);
    for (int64_t u = 0; u < n_nodes; ++u) ++sizes[part[u]];
    std::vector<std::vector<int64_t>> members;
    bool any_empty = false;
    for (int64_t p = 0; p < psize; ++p) any_empty |= (sizes[p] == 0);
    if (any_empty) {
      members.assign(psize, {});
      for (int64_t u = 0; u < n_nodes; ++u) members[part[u]].push_back(u);
      for (int64_t p = 0; p < psize; ++p) {
        if (sizes[p] > 0) continue;
        int64_t q = 0;
        for (int64_t j = 1; j < psize; ++j) if (sizes[j] > sizes[q]) q = j;
        if (sizes[q] < 2) continue;
        // BFS within q from its first member; move the visited half to p
        const int64_t take = sizes[q] / 2;
        std::vector<int64_t> stack{members[q][0]};
        int64_t moved = 0, scan = 0;
        part[members[q][0]] = p;
        ++moved;
        while (moved < take && !stack.empty()) {
          const int64_t u = stack.back(); stack.pop_back();
          for (int64_t e = gf.indptr[u]; e < gf.indptr[u + 1]; ++e) {
            const int64_t v = gf.adj[e];
            if (part[v] == q) {
              part[v] = p; stack.push_back(v);
              if (++moved >= take) break;
            }
          }
          if (stack.empty() && moved < take) {
            // disconnected inside q: sweep remaining members linearly
            while (scan < (int64_t)members[q].size() && moved < take) {
              const int64_t v = members[q][scan++];
              if (part[v] == q) { part[v] = p; stack.push_back(v); ++moved; }
            }
          }
        }
        // rebuild q/p bookkeeping
        std::vector<int64_t> mq;
        std::vector<int64_t> mp;
        for (int64_t u : members[q])
          (part[u] == q ? mq : mp).push_back(u);
        members[q].swap(mq);
        members[p] = std::move(mp);
        sizes[q] = (int64_t)members[q].size();
        sizes[p] = (int64_t)members[p].size();
      }
    }
  }
  std::memcpy(assignment, part.data(), sizeof(int64_t) * n_nodes);
}

// Number of edges whose endpoints live in different parts (each
// direction counted once as stored — symmetric graphs count twice).
int64_t edge_cut(const int64_t* indptr, const int64_t* nbrs, int64_t n_nodes,
                 const int64_t* assignment) {
  int64_t cut = 0;
  for (int64_t u = 0; u < n_nodes; ++u)
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e)
      if (assignment[u] != assignment[nbrs[e]]) ++cut;
  return cut;
}

// Assign each node to one of `psize` clusters by BFS growth from random
// seeds.  `assignment` must hold n_nodes int64s; filled with cluster ids.
void greedy_partition(const int64_t* indptr, const int64_t* nbrs,
                      int64_t n_nodes, int64_t psize, uint64_t seed,
                      int64_t* assignment) {
  if (psize <= 1) {
    std::memset(assignment, 0, sizeof(int64_t) * n_nodes);
    return;
  }
  const int64_t target = n_nodes / psize > 0 ? n_nodes / psize : 1;
  std::vector<int64_t> visit(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) visit[i] = i;
  // xorshift shuffle (deterministic per seed)
  uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ULL;
  auto next = [&s]() {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
  };
  for (int64_t i = n_nodes - 1; i > 0; --i) {
    int64_t j = (int64_t)(next() % (uint64_t)(i + 1));
    std::swap(visit[i], visit[j]);
  }

  std::fill(assignment, assignment + n_nodes, (int64_t)-1);
  std::vector<int64_t> frontier;
  frontier.reserve(1024);
  int64_t visit_ptr = 0;

  for (int64_t pid = 0; pid < psize; ++pid) {
    int64_t members = 0;
    frontier.clear();
    while (members < target) {
      if (frontier.empty()) {
        while (visit_ptr < n_nodes && assignment[visit[visit_ptr]] >= 0)
          ++visit_ptr;
        if (visit_ptr >= n_nodes) break;
        int64_t sd = visit[visit_ptr];
        assignment[sd] = pid;
        ++members;
        frontier.push_back(sd);
        continue;
      }
      int64_t u = frontier.back();
      frontier.pop_back();
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int64_t v = nbrs[e];
        if (assignment[v] < 0) {
          assignment[v] = pid;
          ++members;
          frontier.push_back(v);
          if (members >= target) break;
        }
      }
    }
  }
  // stragglers round-robin into clusters
  int64_t pid = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    if (assignment[i] < 0) {
      assignment[i] = pid;
      pid = (pid + 1) % psize;
    }
  }
}

// Relabel a node-induced subgraph: given a sorted node id set, emit the
// edges with both endpoints inside, relabeled to [0, n_sub).  Returns
// the number of edges written.  `mapping` is scratch of size n_nodes
// (filled by this call).  Used by the cluster sampler hot path.
int64_t induced_subgraph(const int64_t* senders, const int64_t* receivers,
                         int64_t n_edges, const int64_t* node_ids,
                         int64_t n_sub, int64_t n_nodes, int64_t* mapping,
                         int64_t* out_senders, int64_t* out_receivers) {
  std::fill(mapping, mapping + n_nodes, (int64_t)-1);
  for (int64_t i = 0; i < n_sub; ++i) mapping[node_ids[i]] = i;
  int64_t m = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ss = mapping[senders[e]];
    int64_t rr = mapping[receivers[e]];
    if (ss >= 0 && rr >= 0) {
      out_senders[m] = ss;
      out_receivers[m] = rr;
      ++m;
    }
  }
  return m;
}

}  // extern "C"
