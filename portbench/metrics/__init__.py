"""Metric readers, one module a metric of BENCHMARK.json, each with
`read(run) -> float | None`: None where it finds nothing to read (never 0
for a share of a roofline)."""
