"""STREAM triad, the paper's memory-bandwidth probe: ``a + s * b``."""
