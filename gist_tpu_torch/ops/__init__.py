"""Aggregation ops: the segment path and the K1 dedup SpMM kernel."""
