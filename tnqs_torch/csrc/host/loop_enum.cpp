// Native enumeration of leafless edge-induced subgraphs (the port's copy of
// tnqs/native/loop_enum.cpp; `tnqs_torch/ops/_build.py::host_library` compiles
// it with g++ into build/tnqs_torch/ and loads it by ctypes).
//
// The BP loop-series correction (reference
// `src/MessagePassing/loopcorrection.jl:10-11`) sums over all
// edge-induced subgraphs with no degree-1 vertices and at most W edges.  The
// enumeration is host-side combinatorics executed once per (graph, W) — a
// runtime component, implemented natively: edge sets are fixed-width bitsets,
// deduplication is an open-addressing hash set, and connected configurations
// are grown with a canonical minimum-seed-edge rule and a leaf-repair pruning
// bound (each added edge can fix at most two degree-1 vertices).
// Disconnected configurations are vertex-disjoint unions of connected ones.
//
// C ABI (ctypes):
//   tnqs_leafless_subgraphs(nv, ne, edges[2*ne], max_edges,
//                           out[cap], &written) -> count or -1
//   `out` receives records: len, edge_idx_0, ..., edge_idx_{len-1}.

#include <cstdint>
#include <cstring>
#include <vector>
#include <unordered_set>
#include <algorithm>

namespace {

constexpr int MAXW = 16;  // up to 1024 edges

struct Bits {
    uint64_t w[MAXW];
    bool operator==(const Bits& o) const {
        return std::memcmp(w, o.w, sizeof(w)) == 0;
    }
};

struct BitsHash {
    size_t operator()(const Bits& b) const {
        uint64_t h = 1469598103934665603ull;
        for (int i = 0; i < MAXW; ++i) {
            h ^= b.w[i];
            h *= 1099511628211ull;
        }
        return (size_t)h;
    }
};

inline void set_bit(Bits& b, int i) { b.w[i >> 6] |= (1ull << (i & 63)); }
inline bool get_bit(const Bits& b, int i) { return (b.w[i >> 6] >> (i & 63)) & 1; }
inline int popcount(const Bits& b) {
    int c = 0;
    for (int i = 0; i < MAXW; ++i) c += __builtin_popcountll(b.w[i]);
    return c;
}
inline bool intersects(const Bits& a, const Bits& b) {
    for (int i = 0; i < MAXW; ++i)
        if (a.w[i] & b.w[i]) return true;
    return false;
}
inline Bits unite(const Bits& a, const Bits& b) {
    Bits r;
    for (int i = 0; i < MAXW; ++i) r.w[i] = a.w[i] | b.w[i];
    return r;
}

struct Ctx {
    int nv, ne, max_edges;
    const int32_t* edges;                  // [ne][2]
    std::vector<std::vector<int>> incident;  // vertex -> edge ids
    std::unordered_set<Bits, BitsHash> seen;
    std::unordered_set<Bits, BitsHash> results;
    std::vector<Bits> result_list;
    std::vector<int16_t> degree;           // scratch per state

    bool leafless_and_big(const Bits& es, int count) {
        if (count < 3) return false;
        std::fill(degree.begin(), degree.end(), 0);
        for (int e = 0; e < ne; ++e)
            if (get_bit(es, e)) {
                degree[edges[2 * e]]++;
                degree[edges[2 * e + 1]]++;
            }
        for (int v = 0; v < nv; ++v)
            if (degree[v] == 1) return false;
        return true;
    }

    int n_leaves(const Bits& es) {
        std::fill(degree.begin(), degree.end(), 0);
        for (int e = 0; e < ne; ++e)
            if (get_bit(es, e)) {
                degree[edges[2 * e]]++;
                degree[edges[2 * e + 1]]++;
            }
        int l = 0;
        for (int v = 0; v < nv; ++v) l += (degree[v] == 1);
        return l;
    }

    void grow(const Bits& current, int count, int min_idx, const Bits& frontier) {
        if (!seen.insert(current).second) return;
        if (leafless_and_big(current, count)) {
            if (results.insert(current).second) result_list.push_back(current);
        }
        if (count >= max_edges) return;
        if (count + (n_leaves(current) + 1) / 2 > max_edges) return;
        for (int e = min_idx; e < ne; ++e) {
            if (!get_bit(frontier, e) || get_bit(current, e)) continue;
            Bits nxt = current;
            set_bit(nxt, e);
            Bits nf = frontier;
            for (int side = 0; side < 2; ++side)
                for (int e2 : incident[edges[2 * e + side]]) set_bit(nf, e2);
            grow(nxt, count + 1, min_idx, nf);
        }
    }
};

}  // namespace

extern "C" {

// Returns the number of subgraphs found, or -1 on bad input / -2 if `out`
// is too small (re-call with a bigger buffer).
int64_t tnqs_leafless_subgraphs(int32_t nv, int32_t ne, const int32_t* edges,
                                int32_t max_edges, int32_t* out, int64_t cap,
                                int64_t* written) {
    if (nv <= 0 || ne <= 0 || ne > 64 * MAXW || max_edges < 0) return -1;
    Ctx ctx;
    ctx.nv = nv;
    ctx.ne = ne;
    ctx.max_edges = max_edges;
    ctx.edges = edges;
    ctx.degree.assign(nv, 0);
    ctx.incident.assign(nv, {});
    for (int e = 0; e < ne; ++e) {
        ctx.incident[edges[2 * e]].push_back(e);
        ctx.incident[edges[2 * e + 1]].push_back(e);
    }
    // connected leafless subgraphs, canonical seed = smallest edge index
    for (int seed = 0; seed < ne; ++seed) {
        Bits cur{};
        std::memset(cur.w, 0, sizeof(cur.w));
        set_bit(cur, seed);
        Bits frontier{};
        std::memset(frontier.w, 0, sizeof(frontier.w));
        for (int side = 0; side < 2; ++side)
            for (int e2 : ctx.incident[edges[2 * seed + side]]) set_bit(frontier, e2);
        ctx.grow(cur, 1, seed, frontier);
    }
    std::vector<Bits> connected = ctx.result_list;

    // vertex bitsets of each connected component
    auto vbits = [&](const Bits& es) {
        Bits vb{};
        std::memset(vb.w, 0, sizeof(vb.w));
        for (int e = 0; e < ne; ++e)
            if (get_bit(es, e)) {
                set_bit(vb, edges[2 * e]);
                set_bit(vb, edges[2 * e + 1]);
            }
        return vb;
    };
    std::vector<Bits> cverts(connected.size());
    std::vector<int> csize(connected.size());
    for (size_t i = 0; i < connected.size(); ++i) {
        cverts[i] = vbits(connected[i]);
        csize[i] = popcount(connected[i]);
    }
    // grow vertex-disjoint unions breadth-first
    std::vector<std::pair<Bits, Bits>> level;
    for (size_t i = 0; i < connected.size(); ++i) level.push_back({connected[i], cverts[i]});
    while (!level.empty()) {
        std::vector<std::pair<Bits, Bits>> next;
        for (auto& [es, vs] : level) {
            int base = popcount(es);
            for (size_t i = 0; i < connected.size(); ++i) {
                if (base + csize[i] > max_edges) continue;
                if (intersects(vs, cverts[i])) continue;
                Bits u = unite(es, connected[i]);
                if (ctx.results.insert(u).second) {
                    ctx.result_list.push_back(u);
                    next.push_back({u, unite(vs, cverts[i])});
                }
            }
        }
        level.swap(next);
    }

    // serialize, sorted by size then lexicographically (stable output)
    std::sort(ctx.result_list.begin(), ctx.result_list.end(),
              [&](const Bits& a, const Bits& b) {
                  int pa = popcount(a), pb = popcount(b);
                  if (pa != pb) return pa < pb;
                  return std::memcmp(a.w, b.w, sizeof(a.w)) < 0;
              });
    int64_t pos = 0;
    for (const Bits& es : ctx.result_list) {
        int cnt = popcount(es);
        if (pos + 1 + cnt > cap) return -2;
        out[pos++] = cnt;
        for (int e = 0; e < ne; ++e)
            if (get_bit(es, e)) out[pos++] = e;
    }
    *written = pos;
    return (int64_t)ctx.result_list.size();
}

}  // extern "C"
