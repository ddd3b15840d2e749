"""Parameter conversion and seeded initialisation, checkpoints, the metrics,
and the commands' run directory, summaries, timing and tracing."""
