"""The benchmark's harness: the manifest, the traffic generator, the
weights, the FLOP and byte counts, the trace reduction, the comparison that
decides ``correct``, and one driver per kind of traffic."""
