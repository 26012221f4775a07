"""Per-layer metrics, one reader a metric: ``read(ctx)`` takes the run's
`harness.Context` and returns the number, or None where the run holds
nothing for it to read (the harness then leaves the metric out)."""
