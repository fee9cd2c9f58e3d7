"""The benchmark's general code: the run's command line, the registry that
finds cells, configurations, traffic mixes and metrics by name, seeded
weights and audio, spans and the profiler's stretch, and the judge."""
