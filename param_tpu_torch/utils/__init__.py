"""Host-side utilities of the port (device resolution, native data
generation, dtypes, timers, chip constants)."""
