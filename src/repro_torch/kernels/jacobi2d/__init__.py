"""JACOBI2D, the paper's Polybench 5-point stencil: one sweep."""
