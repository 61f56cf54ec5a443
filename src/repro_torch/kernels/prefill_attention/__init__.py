"""Chunked-prefill attention (chunk queries over cache prefix + chunk)."""
