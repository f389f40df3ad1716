"""The layout optimizer's negative-cycle cancellation in the port
(native/flowcost.cpp through rpc/graph_algo.py) against the reference's
Python loop (garage_tpu.rpc.graph_algo) and the port's own copy of it.

Seeded random flow networks go through max flow and cost optimisation
in all three: every edge's flow and the total cost must be equal.  Then
whole layout solves (an initial assignment and the loss of one node) of
both packages from the same node ids must give the same ring.
"""

import random

import pytest

import garage_tpu.rpc.graph_algo as r_ga
import garage_tpu.rpc.layout as r_layout
import garage_tpu_torch.ops.native as native
import garage_tpu_torch.rpc.graph_algo as p_ga
import garage_tpu_torch.rpc.layout as p_layout

SEED = 20261024


def _network(mod, seed):
    """A random assignment network: source → items → groups → sinks,
    with random capacities and costs, in one fixed edge order."""
    rng = random.Random(seed)
    g = mod.Graph()
    items = rng.randrange(8, 40)
    groups = rng.randrange(3, 7)
    for i in range(items):
        g.add_edge("src", ("item", i), rng.randrange(1, 4))
        for j in rng.sample(range(groups), rng.randrange(1, groups + 1)):
            g.add_edge(("item", i), ("group", j), rng.randrange(1, 3),
                       rng.randrange(-3, 4))
    for j in range(groups):
        g.add_edge(("group", j), "sink", rng.randrange(items // 2, items + 1),
                   rng.randrange(-2, 3))
    return g


def _solve(g):
    total = g.compute_maximal_flow("src", "sink")
    g.optimize_flow_with_cost()
    return total, g.flow_cost(), [e.flow for adj in g.adj for e in adj]


@pytest.mark.parametrize("seed", range(12))
def test_cycle_cancelling_equals_reference(seed, monkeypatch):
    assert native.get_native_flow_cancel() is not None
    ref = _solve(_network(r_ga, seed))
    port = _solve(_network(p_ga, seed))
    monkeypatch.setitem(native._resolved, "flow_cancel", None)
    loop = _solve(_network(p_ga, seed))
    assert port == ref == loop


def _ring(mod, n, z, drop=None):
    rng = random.Random(SEED + n)
    ids = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(n + 1)]
    lay = mod.ClusterLayout(3)
    lay.stage_parameters(mod.LayoutParameters("maximum"))
    lay.stage_role(ids[0], mod.NodeRole("z1", None, ["gateway"]))
    for i in range(1, n + 1):
        lay.stage_role(ids[i], mod.NodeRole(f"z{(i - 1) % z + 1}", 1000))
    lay.apply_staged_changes()
    out = [(list(lay.node_id_vec), list(lay.ring_assignment_data))]
    if drop is not None:
        lay.stage_role(ids[drop], None)
        lay.apply_staged_changes()
        out.append((list(lay.node_id_vec), list(lay.ring_assignment_data)))
    return out


@pytest.mark.parametrize("n,z,drop", [(4, 2, 2), (4, 2, 4), (6, 3, None)])
def test_layout_solve_equals_reference(n, z, drop):
    port = _ring(p_layout, n, z, drop)
    assert port == _ring(r_layout, n, z, drop)
    assert len(port[-1][1]) == 256 * 3
