"""Per-row KV-cache scatter (the decode step's cache write)."""
