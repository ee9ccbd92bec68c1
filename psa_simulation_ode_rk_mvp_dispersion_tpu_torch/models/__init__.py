"""Physics models built on ``ops``."""
