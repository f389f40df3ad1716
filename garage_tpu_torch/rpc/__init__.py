"""rpc — cluster membership, partition ring, layout optimizer, quorum calls.

Equivalent of reference src/rpc (SURVEY.md §2.3): `System` (membership,
gossip, discovery, health), `Ring` (2^8-partition table), `ClusterLayout`
(CRDT'd staged role assignment with flow-optimized partition placement),
`RpcHelper` (quorum fan-out with interrupt-after-quorum reads and
latency-ordered sends), and `graph_algo` (max-flow / min-cost flow used by
the layout optimizer).
"""
