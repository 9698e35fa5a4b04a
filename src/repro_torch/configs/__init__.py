"""Problem configurations (paper Table 3)."""
