"""Model configurations (the dense GQA family)."""
