"""Sharding vocabulary of the port.  Only the logical names of the
one-dimensional rank world are ported so far (`rules.py`); mesh
shardings are later work (ROADMAP.md)."""
