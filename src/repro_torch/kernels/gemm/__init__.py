"""GEMM, the paper's Polybench matrix product, summed in float32."""
