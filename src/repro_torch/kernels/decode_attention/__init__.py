"""Length-aware flash-decode attention (one new token per row)."""
