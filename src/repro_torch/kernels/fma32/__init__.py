"""FMA32, the paper's FLOP burner: a dependent chain of fused
multiply-adds per element."""
