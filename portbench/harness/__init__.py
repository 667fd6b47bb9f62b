"""The benchmark's machinery: cells found by name, seeded inputs, probes, checks."""
