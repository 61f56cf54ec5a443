"""Flash attention (full-sequence, causal / window / softcap, GQA)."""
