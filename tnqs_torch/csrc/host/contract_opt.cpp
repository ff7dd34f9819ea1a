// Native contraction-order planner of the flex tier: the port's copy of
// `tnqs/native/contract_opt.cpp`, the same search, so that both packages
// pick the same contraction sequences.  Planning runs on the host: every BP
// message update and local expectation contraction is planned once per
// (vertex, edge) key.
//
// Representation: each tensor is a bitmask over the index universe (w 64-bit
// words).  Every index sits on at most two tensors, so the open-index set of
// a subtree is the XOR of its members' masks, and the multiply count of a
// pairwise contraction is the product of the dims of the union of the two
// open sets.  Sizes are accumulated in log space (doubles).
//
// C ABI (ctypes, `tnqs_torch/ops/_build.py::host_library`):
//   tnqs_optimal_order  - exact DP over subsets (O(3^n)), n <= 20
//   tnqs_greedy_order   - pairwise greedy on (result size, union size)
//   tnqs_sa_order       - Boltzmann-randomized greedy with restarts
//
// Build: g++ -O3 -shared -fPIC -std=c++17, with loop_enum.cpp.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <random>

namespace {

inline double mask_logsize(const uint64_t* m, int w, const double* logdims) {
    double s = 0.0;
    for (int j = 0; j < w; ++j) {
        uint64_t word = m[j];
        while (word) {
            int b = __builtin_ctzll(word);
            s += logdims[j * 64 + b];
            word &= word - 1;
        }
    }
    return s;
}

}  // namespace

extern "C" {

// Exact subset DP.  masks: n*w words (tensor index bitmasks); logdims: m
// doubles.  out_split: array of length (1<<n); out_split[mask] = the chosen
// left submask for every multi-tensor subset reachable in the optimal tree
// (0 elsewhere).  Returns 0 on success, -1 on bad input.
int tnqs_optimal_order(int n, int w, const uint64_t* masks, const double* logdims,
                       int m, int32_t* out_split) {
    if (n < 2 || n > 20 || w < 1) return -1;
    const uint32_t full = (n == 32) ? 0xffffffffu : ((1u << n) - 1u);
    const size_t nmask = size_t(full) + 1;

    // open-index set of every subset = XOR of members (incremental)
    std::vector<uint64_t> rset(nmask * w, 0);
    for (int k = 0; k < n; ++k)
        std::memcpy(&rset[(size_t(1) << k) * w], &masks[size_t(k) * w],
                    sizeof(uint64_t) * w);
    for (uint32_t mask = 1; mask <= full; ++mask) {
        if ((mask & (mask - 1)) == 0) continue;
        uint32_t low = mask & (~mask + 1);
        uint32_t rest = mask ^ low;
        for (int j = 0; j < w; ++j)
            rset[size_t(mask) * w + j] =
                rset[size_t(rest) * w + j] ^ rset[size_t(low) * w + j];
    }

    const double INF = 1e300;
    std::vector<double> cost(nmask, INF);
    for (int k = 0; k < n; ++k) cost[size_t(1) << k] = 0.0;
    std::vector<uint64_t> u(w);

    for (uint32_t mask = 1; mask <= full; ++mask) {
        if ((mask & (mask - 1)) == 0) continue;
        double best = INF;
        uint32_t best_sub = 0;
        // enumerate unordered splits once (sub < other)
        for (uint32_t sub = (mask - 1) & mask; sub; sub = (sub - 1) & mask) {
            uint32_t other = mask ^ sub;
            if (sub > other) continue;
            double c1 = cost[sub], c2 = cost[other];
            if (c1 >= INF || c2 >= INF) continue;
            for (int j = 0; j < w; ++j)
                u[j] = rset[size_t(sub) * w + j] | rset[size_t(other) * w + j];
            // exp of log-size: compare in linear space like the reference's
            // multiply-count objective; stays finite for any sane network
            double step = std::exp(mask_logsize(u.data(), w, logdims));
            double c = c1 + c2 + step;
            if (c < best) { best = c; best_sub = sub; }
        }
        cost[mask] = best;
        out_split[mask] = (int32_t)best_sub;
    }
    return cost[full] >= INF ? -1 : 0;
}

// Greedy pairwise contraction.  Chooses, among pairs sharing an index, the
// one minimizing (log result size, log union size); if no pair shares an
// index, merges the two smallest.  out_pairs: 2*(n-1) int32 ids — leaves are
// 0..n-1, the merge at step s creates id n+s.  Returns 0 on success.
int tnqs_greedy_order(int n, int w, const uint64_t* masks, const double* logdims,
                      int m, int32_t* out_pairs) {
    if (n < 2 || w < 1) return -1;
    struct Node { std::vector<uint64_t> r; int id; double logsz; };
    std::vector<Node> live(n);
    for (int k = 0; k < n; ++k) {
        live[k].r.assign(&masks[size_t(k) * w], &masks[size_t(k) * w] + w);
        live[k].id = k;
        live[k].logsz = mask_logsize(live[k].r.data(), w, logdims);
    }
    std::vector<uint64_t> tmp(w);
    int next_id = n;
    int step = 0;
    while ((int)live.size() > 1) {
        int bi = -1, bj = -1;
        double b_res = 0, b_uni = 0;
        for (size_t a = 0; a < live.size(); ++a) {
            for (size_t b = a + 1; b < live.size(); ++b) {
                bool share = false;
                for (int j = 0; j < w; ++j)
                    if (live[a].r[j] & live[b].r[j]) { share = true; break; }
                if (!share) continue;
                for (int j = 0; j < w; ++j) tmp[j] = live[a].r[j] ^ live[b].r[j];
                double res = mask_logsize(tmp.data(), w, logdims);
                for (int j = 0; j < w; ++j) tmp[j] = live[a].r[j] | live[b].r[j];
                double uni = mask_logsize(tmp.data(), w, logdims);
                if (bi < 0 || res < b_res || (res == b_res && uni < b_uni)) {
                    bi = (int)a; bj = (int)b; b_res = res; b_uni = uni;
                }
            }
        }
        if (bi < 0) {
            // disconnected network: merge the two smallest components
            int s0 = 0, s1 = 1;
            if (live[s1].logsz < live[s0].logsz) std::swap(s0, s1);
            for (size_t a = 2; a < live.size(); ++a) {
                if (live[a].logsz < live[s0].logsz) { s1 = s0; s0 = (int)a; }
                else if (live[a].logsz < live[s1].logsz) { s1 = (int)a; }
            }
            bi = s0 < s1 ? s0 : s1;
            bj = s0 < s1 ? s1 : s0;
        }
        out_pairs[2 * step] = live[bi].id;
        out_pairs[2 * step + 1] = live[bj].id;
        for (int j = 0; j < w; ++j) live[bi].r[j] ^= live[bj].r[j];
        live[bi].logsz = mask_logsize(live[bi].r.data(), w, logdims);
        live[bi].id = next_id++;
        live.erase(live.begin() + bj);
        ++step;
    }
    return 0;
}

// Stochastic greedy with restarts (a stand-in for a TreeSA-class
// simulated-annealing optimizer): each
// restart picks contraction pairs Boltzmann-randomly among the candidates,
// keeping the tree with the smallest total contraction cost.  Returns 0 on
// success; out_pairs as in tnqs_greedy_order.
int tnqs_sa_order(int n, int w, const uint64_t* masks, const double* logdims,
                  int m, int32_t* out_pairs, int32_t n_restarts,
                  double temperature, uint64_t seed) {
    if (n < 2 || w < 1 || n_restarts < 1) return -1;
    std::mt19937_64 rng(seed);
    std::vector<int32_t> best(2 * (n - 1));
    double best_cost = 1e300;
    std::vector<int32_t> cur(2 * (n - 1));
    struct Node { std::vector<uint64_t> r; int id; };
    std::vector<uint64_t> tmp(w);

    for (int rs = 0; rs < n_restarts; ++rs) {
        std::vector<Node> live(n);
        for (int k = 0; k < n; ++k) {
            live[k].r.assign(&masks[size_t(k) * w], &masks[size_t(k) * w] + w);
            live[k].id = k;
        }
        int next_id = n, step = 0;
        double total = 0.0;
        while ((int)live.size() > 1) {
            // candidate pairs sharing an index, scored by log result size
            std::vector<std::pair<double, std::pair<int, int>>> cands;
            for (size_t a = 0; a < live.size(); ++a)
                for (size_t b = a + 1; b < live.size(); ++b) {
                    bool share = false;
                    for (int j = 0; j < w; ++j)
                        if (live[a].r[j] & live[b].r[j]) { share = true; break; }
                    if (!share) continue;
                    for (int j = 0; j < w; ++j) tmp[j] = live[a].r[j] ^ live[b].r[j];
                    cands.push_back({mask_logsize(tmp.data(), w, logdims),
                                     {(int)a, (int)b}});
                }
            int bi, bj;
            if (cands.empty()) {
                bi = 0; bj = 1;
            } else {
                double mn = cands[0].first;
                for (auto& c : cands) mn = std::min(mn, c.first);
                std::vector<double> wts(cands.size());
                double tot = 0;
                for (size_t i = 0; i < cands.size(); ++i) {
                    wts[i] = std::exp(-(cands[i].first - mn) /
                                      std::max(temperature, 1e-9));
                    tot += wts[i];
                }
                std::uniform_real_distribution<double> U(0.0, tot);
                double x = U(rng);
                size_t pick = 0;
                for (; pick + 1 < cands.size(); ++pick) {
                    if (x < wts[pick]) break;
                    x -= wts[pick];
                }
                bi = cands[pick].second.first;
                bj = cands[pick].second.second;
            }
            // step cost = size of the union of open sets
            for (int j = 0; j < w; ++j) tmp[j] = live[bi].r[j] | live[bj].r[j];
            total += std::exp(mask_logsize(tmp.data(), w, logdims));
            cur[2 * step] = live[bi].id;
            cur[2 * step + 1] = live[bj].id;
            for (int j = 0; j < w; ++j) live[bi].r[j] ^= live[bj].r[j];
            live[bi].id = next_id++;
            live.erase(live.begin() + bj);
            ++step;
        }
        if (total < best_cost) {
            best_cost = total;
            best = cur;
        }
    }
    std::memcpy(out_pairs, best.data(), sizeof(int32_t) * 2 * (n - 1));
    return 0;
}

}  // extern "C"
