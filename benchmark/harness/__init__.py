"""The benchmark's harness: spec lookup, traffic generation, seeded
weights, the yardstick's arithmetic, tracing and the comparison."""
