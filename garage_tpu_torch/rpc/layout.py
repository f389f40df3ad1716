"""Cluster layout: CRDT'd role assignment + flow-optimized partition placement.

Equivalent of reference src/rpc/layout.rs (SURVEY.md §2.3): node roles
(zone, capacity, tags) are staged through an LwwMap and applied with an
explicit version bump (`apply_staged_changes`, ref layout.rs:307); the
partition→nodes assignment is computed by **dichotomy on the partition size
combined with max-flow feasibility** (ref layout.rs:592-680,783), then
**movement vs the previous layout is minimized** by cost-optimizing the
flow (edges that keep a replica where it was cost 0, moves cost 1; ref
layout.rs:819-980 + graph_algo negative-cycle cancellation).

Zone redundancy: every partition must span at least
min(zone_redundancy, n_zones) distinct zones; enforced in the flow graph by
capping each partition→zone edge at factor − zr + 1 replicas.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from ..utils.crdt import Lww, LwwMap
from ..utils.data import Hash, blake2sum
from ..utils.error import LayoutError
from ..utils.migrate import Migrated, pack
from .graph_algo import Graph

N_PARTITIONS = 256  # 2^PARTITION_BITS, ref rpc/ring.rs:20


@dataclasses.dataclass
class NodeRole:
    """A node's assigned role (ref layout.rs NodeRole)."""

    zone: str
    capacity: Optional[int]  # None = gateway (no data stored)
    tags: List[str] = dataclasses.field(default_factory=list)

    def pack(self):
        return [self.zone, self.capacity, list(self.tags)]

    @classmethod
    def unpack(cls, v):
        if v is None:
            return None
        return cls(zone=v[0], capacity=v[1], tags=list(v[2]))

    def capacity_string(self) -> str:
        return "gateway" if self.capacity is None else str(self.capacity)


ZoneRedundancy = Union[int, str]  # int or "maximum"


@dataclasses.dataclass
class LayoutParameters:
    zone_redundancy: ZoneRedundancy = "maximum"

    def pack(self):
        return [self.zone_redundancy]

    @classmethod
    def unpack(cls, v):
        return cls(zone_redundancy=v[0])


class ClusterLayout(Migrated):
    """The full cluster layout (ref layout.rs:88-129 v09 struct)."""

    VERSION_MARKER = b"GT01layout"

    def __init__(self, replication_factor: int = 3):
        self.version = 0
        self.replication_factor = replication_factor
        self.parameters = LayoutParameters()
        self.roles: LwwMap = LwwMap()            # node_id bytes -> NodeRole | None
        self.staging_parameters: Lww = Lww(LayoutParameters().pack(), ts=0)
        self.staging_roles: LwwMap = LwwMap()
        self.node_id_vec: List[bytes] = []
        self.ring_assignment_data: List[int] = []  # flat: partition p replica r
                                                   # -> index into node_id_vec

    # --- serialization ---

    def fields(self):
        return {
            "version": self.version,
            "replication_factor": self.replication_factor,
            "parameters": self.parameters.pack(),
            "roles": [[k, e.pack()] for k, e in self.roles.sorted_items()],
            "staging_parameters": self.staging_parameters.pack(),
            "staging_roles": [
                [k, e.pack()] for k, e in self.staging_roles.sorted_items()
            ],
            "node_id_vec": list(self.node_id_vec),
            "ring_assignment_data": list(self.ring_assignment_data),
        }

    @classmethod
    def from_fields(cls, d):
        lay = cls(replication_factor=d["replication_factor"])
        lay.version = d["version"]
        lay.parameters = LayoutParameters.unpack(d["parameters"])
        lay.roles = LwwMap({k: Lww(e[1], ts=e[0]) for k, e in d["roles"]})
        sp = d["staging_parameters"]
        lay.staging_parameters = Lww(sp[1], ts=sp[0])
        lay.staging_roles = LwwMap({k: Lww(e[1], ts=e[0]) for k, e in d["staging_roles"]})
        lay.node_id_vec = [bytes(x) for x in d["node_id_vec"]]
        lay.ring_assignment_data = list(d["ring_assignment_data"])
        return lay

    # --- inspection ---

    def node_roles(self) -> Dict[bytes, NodeRole]:
        """Current (applied) roles, removed nodes excluded."""
        out = {}
        for k, e in self.roles.items.items():
            role = NodeRole.unpack(e.value)
            if role is not None:
                out[bytes(k)] = role
        return out

    def zone_map(self) -> Dict[bytes, str]:
        """node id → zone for every node in the COMMITTED layout (the
        routing/quorum layers' source of topology truth)."""
        return {nid: r.zone for nid, r in self.node_roles().items()}

    def hard_zone_redundancy(self) -> Optional[int]:
        """The integer zone_redundancy when the layout DEMANDS zone
        spread from write quorums; None for "maximum", which asks
        placement for the widest spread but keeps writes
        availability-first when a whole zone is dark."""
        zr = self.parameters.zone_redundancy
        if isinstance(zr, int):
            return min(zr, self.replication_factor)
        return None

    def staged_roles(self) -> Dict[bytes, Optional[NodeRole]]:
        return {
            bytes(k): NodeRole.unpack(e.value)
            for k, e in self.staging_roles.items.items()
        }

    def staging_hash(self) -> Hash:
        return blake2sum(
            pack([
                [[k, e.pack()] for k, e in self.staging_roles.sorted_items()],
                self.staging_parameters.pack(),
            ])
        )

    def partition_nodes(self, partition: int) -> List[bytes]:
        f = self.replication_factor
        idxs = self.ring_assignment_data[partition * f : (partition + 1) * f]
        return [self.node_id_vec[i] for i in idxs]

    def all_nodes(self) -> List[bytes]:
        return [bytes(k) for k in self.node_roles()]

    # --- staging (ref layout.rs:307-335) ---

    def stage_role(self, node_id: bytes, role: Optional[NodeRole]):
        self.staging_roles.update(bytes(node_id), role.pack() if role else None)

    def stage_parameters(self, params: LayoutParameters):
        self.staging_parameters.update(params.pack())

    def apply_staged_changes(self, version: Optional[int] = None) -> List[str]:
        expected = self.version + 1
        if version is not None and version != expected:
            raise LayoutError(
                f"expected version {expected} to apply staged changes, got {version}"
            )
        self.roles.merge(self.staging_roles)
        # drop removed nodes from the map entirely once applied
        self.parameters = LayoutParameters.unpack(self.staging_parameters.value)
        msgs = self.calculate_partition_assignment()
        self.staging_roles = LwwMap()
        self.staging_parameters = Lww(self.parameters.pack(), ts=0)
        self.version = expected
        return msgs

    def revert_staged_changes(self, version: Optional[int] = None):
        expected = self.version + 1
        if version is not None and version != expected:
            raise LayoutError(
                f"expected version {expected} to revert staged changes, got {version}"
            )
        self.staging_roles = LwwMap()
        self.staging_parameters = Lww(self.parameters.pack(), ts=0)
        self.version = expected

    # --- CRDT merge (ref layout.rs:286-305) ---

    def merge(self, other: "ClusterLayout") -> bool:
        if other.version > self.version:
            self.version = other.version
            self.replication_factor = other.replication_factor
            self.parameters = other.parameters
            self.roles = other.roles
            self.staging_parameters = other.staging_parameters
            self.staging_roles = other.staging_roles
            self.node_id_vec = list(other.node_id_vec)
            self.ring_assignment_data = list(other.ring_assignment_data)
            return True
        if other.version == self.version:
            before = self.staging_hash()
            self.staging_roles.merge(other.staging_roles)
            self.staging_parameters.merge(other.staging_parameters)
            return self.staging_hash() != before
        return False

    # --- validation (ref layout.rs:467) ---

    def check(self) -> List[str]:
        errors = []
        f = self.replication_factor
        if self.version > 0 and self.ring_assignment_data:
            if len(self.ring_assignment_data) != N_PARTITIONS * f:
                errors.append(
                    f"ring_assignment_data has {len(self.ring_assignment_data)} "
                    f"entries, expected {N_PARTITIONS * f}"
                )
            else:
                roles = self.node_roles()
                for p in range(N_PARTITIONS):
                    nodes = self.partition_nodes(p)
                    if len(set(nodes)) != f:
                        errors.append(f"partition {p} has duplicate nodes")
                        break
                    for n in nodes:
                        role = roles.get(n)
                        if role is None or role.capacity is None:
                            errors.append(
                                f"partition {p} assigned to non-storage node"
                            )
                            break
        return errors

    # --- partition assignment (ref layout.rs:592-680) ---

    def _storage_nodes(self) -> Dict[bytes, NodeRole]:
        return {
            nid: role
            for nid, role in self.node_roles().items()
            if role.capacity is not None
        }

    def effective_zone_redundancy(self) -> int:
        zones = {r.zone for r in self._storage_nodes().values()}
        zr = self.parameters.zone_redundancy
        if zr == "maximum":
            return min(self.replication_factor, max(len(zones), 1))
        return min(int(zr), self.replication_factor)

    def calculate_partition_assignment(
        self, n_partitions: int = N_PARTITIONS
    ) -> List[str]:
        f = self.replication_factor
        storage = self._storage_nodes()
        if len(storage) < f:
            raise LayoutError(
                f"not enough storage nodes: {len(storage)} < replication factor {f}"
            )
        zr = self.effective_zone_redundancy()
        zones = sorted({r.zone for r in storage.values()})
        if len(zones) < zr:
            raise LayoutError(
                f"not enough zones: {len(zones)} < zone redundancy {zr}"
            )

        # previous assignment, for movement minimization
        old_nodes_of: List[set] = [set() for _ in range(n_partitions)]
        if self.ring_assignment_data and self.node_id_vec:
            old_f = (
                len(self.ring_assignment_data) // n_partitions
                if len(self.ring_assignment_data) % n_partitions == 0
                else 0
            )
            for p in range(n_partitions if old_f else 0):
                for i in self.ring_assignment_data[p * old_f : (p + 1) * old_f]:
                    if i < len(self.node_id_vec):
                        old_nodes_of[p].add(self.node_id_vec[i])

        s_opt = compute_optimal_partition_size(storage, f, zr, n_partitions)

        g = _assignment_graph(storage, f, zr, n_partitions, s_opt, old_nodes_of)
        flow = g.compute_maximal_flow("src", "sink")
        assert flow == n_partitions * f, (flow, n_partitions * f)
        g.optimize_flow_with_cost()

        new_node_id_vec = sorted(storage.keys())
        idx_of = {nid: i for i, nid in enumerate(new_node_id_vec)}
        assignment: List[List[int]] = [[] for _ in range(n_partitions)]
        usage: Dict[bytes, int] = {nid: 0 for nid in storage}
        for u, v, fl in g.positive_flow_edges():
            if isinstance(u, tuple) and u[0] == "pz" and isinstance(v, tuple) and v[0] == "n":
                p, nid = u[1], v[1]
                assignment[p].append(idx_of[nid])
                usage[nid] += 1
        moved = 0
        for p in range(n_partitions):
            assert len(assignment[p]) == f, (p, assignment[p])
            assignment[p].sort()
            new_set = {new_node_id_vec[i] for i in assignment[p]}
            moved += len(new_set - old_nodes_of[p])
        had_old = any(old_nodes_of[p] for p in range(n_partitions))

        self.node_id_vec = new_node_id_vec
        self.ring_assignment_data = [i for p in assignment for i in p]

        msgs = [
            f"partition size: {s_opt}",
            f"zone redundancy: {zr} (zones: {', '.join(zones)})",
        ]
        if had_old:
            msgs.append(f"{moved} partition replicas moved")
        for nid in new_node_id_vec:
            cap = storage[nid].capacity
            msgs.append(
                f"  node {nid.hex()[:16]} zone={storage[nid].zone} "
                f"usage={usage[nid]}/{cap // s_opt} partitions "
                f"({usage[nid] * s_opt * 100 // max(cap, 1)}% of capacity)"
            )
        return msgs


def _assignment_graph(
    storage: Dict[bytes, NodeRole],
    f: int,
    zr: int,
    n_partitions: int,
    partition_size: int,
    old_nodes_of: List[set],
) -> Graph:
    """Flow network (ref layout.rs:819-980):
      src → ("p", p)                     cap f
      ("p", p) → ("pz", p, zone)         cap f − zr + 1   (zone redundancy)
      ("pz", p, z) → ("n", node)         cap 1, cost 0 if node held p else 1
      ("n", node) → sink                 cap ⌊capacity / partition_size⌋
    """
    g = Graph()
    by_zone: Dict[str, List[bytes]] = {}
    for nid, role in storage.items():
        by_zone.setdefault(role.zone, []).append(nid)
    for p in range(n_partitions):
        g.add_edge("src", ("p", p), f)
        for z, nids in by_zone.items():
            g.add_edge(("p", p), ("pz", p, z), f - zr + 1)
            for nid in nids:
                cost = 0 if nid in old_nodes_of[p] else 1
                g.add_edge(("pz", p, z), ("n", nid), 1, cost)
    for nid, role in storage.items():
        g.add_edge(("n", nid), "sink", role.capacity // partition_size)
    return g


def _feasible(
    storage: Dict[bytes, NodeRole],
    f: int,
    zr: int,
    n_partitions: int,
    partition_size: int,
) -> bool:
    if partition_size <= 0:
        return True
    g = _assignment_graph(
        storage, f, zr, n_partitions, partition_size, [set()] * n_partitions
    )
    return g.compute_maximal_flow("src", "sink") == n_partitions * f


def compute_optimal_partition_size(
    storage: Dict[bytes, NodeRole],
    f: int,
    zr: int,
    n_partitions: int = N_PARTITIONS,
) -> int:
    """Largest partition size with a feasible assignment, by dichotomy
    (ref layout.rs:783 compute_optimal_partition_size)."""
    if not _feasible(storage, f, zr, n_partitions, 1):
        raise LayoutError(
            "layout infeasible even at partition size 1: not enough "
            "capacity/zones for the requested replication"
        )
    lo, hi = 1, max(r.capacity for r in storage.values()) + 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _feasible(storage, f, zr, n_partitions, mid):
            lo = mid
        else:
            hi = mid - 1
        if lo == hi:
            break
    return lo
