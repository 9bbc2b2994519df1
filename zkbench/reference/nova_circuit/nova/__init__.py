"""Nova's augmented step circuit (a copy of the port's host code)."""
