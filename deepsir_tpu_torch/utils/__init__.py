"""Parameter conversion and seeded initialisation."""
