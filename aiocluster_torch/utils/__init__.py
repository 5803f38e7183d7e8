"""Small shared utilities of the port (the clock seam)."""
