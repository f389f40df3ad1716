// flowcost — negative-cycle cancellation for the layout optimizer.
//
// The same computation as rpc/graph_algo.py Graph.optimize_flow_with_cost
// (ref graph_algo.rs:269), step for step, so the flows it leaves are the
// Python loop's to the bit: each round runs Bellman-Ford over the
// residual graph from an all-zero distance vector, relaxing edges in
// adjacency order with the distances updated in place, for as many
// passes as there are vertices (stopping early when a pass relaxes
// nothing: no negative cycle, done); the last vertex relaxed in the last
// pass is walked back n predecessors onto the cycle, the cycle is read
// off the predecessor edges and its bottleneck pushed around it.  Only
// the speed differs: the layout solve of a one-node loss on a 24-node
// cluster cancels hundreds of cycles, each n passes over every edge.
//
// The graph comes in CSR form in adjacency order: the edges of vertex u
// are first[u] .. first[u + 1] - 1, each with its destination, capacity,
// flow (updated in place), cost and the index of its reverse edge.
//
// Exposed as a C ABI consumed by rpc/graph_algo.py over ctypes.

#include <cstdint>
#include <vector>

extern "C" {

// Returns the number of cycles cancelled (the loop stops at max_rounds),
// or -1 when a predecessor walk meets a vertex with no predecessor (the
// Python loop raises there too).
int64_t flow_cancel_negative_cycles(int64_t n, const int64_t* first,
                                    const int64_t* dst, const int64_t* cap,
                                    int64_t* flow, const int64_t* cost,
                                    const int64_t* rev, int64_t max_rounds) {
    const int64_t INF = (int64_t)1 << 60;
    std::vector<int64_t> dist(n), pred_u(n), pred_e(n);
    std::vector<int64_t> cycle;
    int64_t rounds = 0;
    for (; rounds < max_rounds; rounds++) {
        for (int64_t i = 0; i < n; i++) {
            dist[i] = 0;
            pred_u[i] = -1;
            pred_e[i] = -1;
        }
        int64_t x = -1;
        for (int64_t pass = 0; pass < n; pass++) {
            x = -1;
            for (int64_t u = 0; u < n; u++) {
                for (int64_t e = first[u]; e < first[u + 1]; e++) {
                    int64_t d = dist[u] + cost[e];
                    if (cap[e] - flow[e] > 0 && d < dist[dst[e]]) {
                        dist[dst[e]] = d > -INF ? d : -INF;
                        pred_u[dst[e]] = u;
                        pred_e[dst[e]] = e;
                        x = dst[e];
                    }
                }
            }
            if (x == -1) return rounds;  // no negative cycle left
        }
        for (int64_t i = 0; i < n; i++) {
            if (pred_u[x] < 0) return -1;
            x = pred_u[x];
        }
        cycle.clear();
        int64_t v = x;
        do {
            if (pred_u[v] < 0) return -1;
            cycle.push_back(pred_e[v]);
            v = pred_u[v];
        } while (v != x);
        int64_t bottleneck = INF;
        for (int64_t e : cycle)
            if (cap[e] - flow[e] < bottleneck) bottleneck = cap[e] - flow[e];
        for (int64_t e : cycle) {
            flow[e] += bottleneck;
            flow[rev[e]] -= bottleneck;
        }
    }
    return rounds;
}

}  // extern "C"
