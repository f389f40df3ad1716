"""Test harnesses that ship in-tree: the synthetic-link device codec the
transport, pool and hybrid tests drive."""
