"""Flow graphs for the layout optimizer.

Equivalent of reference src/rpc/graph_algo.rs: a generic directed flow graph
with `compute_maximal_flow` (Dinic: BFS level graph + DFS blocking flow,
graph_algo.rs:175) and `optimize_flow_with_cost` (negative-cycle
cancellation on the residual graph, graph_algo.rs:269).  Vertices are
arbitrary hashable handles.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Hashable, List, Optional, Tuple

Vertex = Hashable


class _Edge:
    __slots__ = ("dst", "cap", "flow", "cost", "rev")

    def __init__(self, dst: int, cap: int, cost: int, rev: int):
        self.dst = dst
        self.cap = cap
        self.flow = 0
        self.cost = cost
        self.rev = rev  # index of reverse edge in adj[dst]


class Graph:
    """Flow network over hashable vertex handles (ref graph_algo.rs:46)."""

    def __init__(self):
        self._id: Dict[Vertex, int] = {}
        self._vertex: List[Vertex] = []
        self.adj: List[List[_Edge]] = []

    def vertex_id(self, v: Vertex) -> int:
        i = self._id.get(v)
        if i is None:
            i = len(self._vertex)
            self._id[v] = i
            self._vertex.append(v)
            self.adj.append([])
        return i

    def add_edge(self, u: Vertex, v: Vertex, cap: int, cost: int = 0) -> None:
        ui, vi = self.vertex_id(u), self.vertex_id(v)
        self.adj[ui].append(_Edge(vi, cap, cost, len(self.adj[vi])))
        self.adj[vi].append(_Edge(ui, 0, -cost, len(self.adj[ui]) - 1))

    # --- max flow (Dinic) ---

    def compute_maximal_flow(self, source: Vertex, sink: Vertex) -> int:
        s, t = self.vertex_id(source), self.vertex_id(sink)
        total = 0
        n = len(self.adj)
        while True:
            level = [-1] * n
            level[s] = 0
            q = deque([s])
            while q:
                u = q.popleft()
                for e in self.adj[u]:
                    if e.cap - e.flow > 0 and level[e.dst] < 0:
                        level[e.dst] = level[u] + 1
                        q.append(e.dst)
            if level[t] < 0:
                return total
            it = [0] * n

            def dfs(u: int, pushed: int) -> int:
                if u == t:
                    return pushed
                while it[u] < len(self.adj[u]):
                    e = self.adj[u][it[u]]
                    if e.cap - e.flow > 0 and level[e.dst] == level[u] + 1:
                        got = dfs(e.dst, min(pushed, e.cap - e.flow))
                        if got > 0:
                            e.flow += got
                            self.adj[e.dst][e.rev].flow -= got
                            return got
                    it[u] += 1
                return 0

            while True:
                pushed = dfs(s, 1 << 60)
                if pushed == 0:
                    break
                total += pushed

    # --- cost optimization (negative cycle cancellation) ---

    def optimize_flow_with_cost(self, max_rounds: int = 1000) -> None:
        """Cancel negative-cost cycles in the residual graph until none
        remain (ref graph_algo.rs:269): keeps the flow value, minimizes
        total cost.  Bellman-Ford finds a vertex on a negative cycle; we
        walk predecessors to extract it.

        Runs in native/flowcost.cpp, which repeats this loop step for step
        (the same cycles in the same order, so the same flows).  The loop
        below exists only for a host without a C++ compiler, where
        ops/native cannot build the library, as the CPU codec keeps its
        numpy floor.  A one-node loss on a 24-node cluster cancels
        hundreds of cycles of n Bellman-Ford passes each."""
        import numpy as np

        from ..ops.native import get_native_flow_cancel

        cancel = get_native_flow_cancel()
        if cancel is None:
            return self._optimize_flow_with_cost_py(max_rounds)
        n = len(self.adj)
        edges = [e for adj in self.adj for e in adj]
        first = np.cumsum([0] + [len(adj) for adj in self.adj])
        dst = np.fromiter((e.dst for e in edges), np.int64, len(edges))
        rev = first[dst] + np.fromiter((e.rev for e in edges), np.int64,
                                       len(edges))
        flow = np.fromiter((e.flow for e in edges), np.int64, len(edges))
        rounds = cancel(
            n, first, dst,
            np.fromiter((e.cap for e in edges), np.int64, len(edges)),
            flow, np.fromiter((e.cost for e in edges), np.int64, len(edges)),
            rev, max_rounds)
        if rounds < 0:
            raise RuntimeError("negative-cycle walk met a vertex with no "
                               "predecessor")
        for e, f in zip(edges, flow.tolist()):
            e.flow = f

    def _optimize_flow_with_cost_py(self, max_rounds: int = 1000) -> None:
        n = len(self.adj)
        for _ in range(max_rounds):
            cycle = self._find_negative_cycle(n)
            if cycle is None:
                return
            bottleneck = min(e.cap - e.flow for e in cycle)
            for e in cycle:
                e.flow += bottleneck
                self.adj[e.dst][e.rev].flow -= bottleneck

    def _find_negative_cycle(self, n: int) -> Optional[List[_Edge]]:
        INF = 1 << 60
        dist = [0] * n  # all-zero init finds cycles reachable from anywhere
        pred: List[Optional[Tuple[int, _Edge]]] = [None] * n
        x = -1
        for _ in range(n):
            x = -1
            for u in range(n):
                for e in self.adj[u]:
                    if e.cap - e.flow > 0 and dist[u] + e.cost < dist[e.dst]:
                        dist[e.dst] = max(dist[u] + e.cost, -INF)
                        pred[e.dst] = (u, e)
                        x = e.dst
            if x == -1:
                return None
        # x is on or downstream of a negative cycle; walk back n steps
        for _ in range(n):
            x = pred[x][0]  # type: ignore[index]
        cycle: List[_Edge] = []
        v = x
        while True:
            u, e = pred[v]  # type: ignore[misc]
            cycle.append(e)
            v = u
            if v == x:
                break
        cycle.reverse()
        return cycle

    # --- inspection ---

    def positive_flow_edges(self) -> List[Tuple[Vertex, Vertex, int]]:
        out = []
        for u, edges in enumerate(self.adj):
            for e in edges:
                if e.flow > 0 and e.cap > 0:
                    out.append((self._vertex[u], self._vertex[e.dst], e.flow))
        return out

    def flow_cost(self) -> int:
        return sum(
            e.flow * e.cost for edges in self.adj for e in edges if e.flow > 0
        )
