"""Background cosmology: expansion, distances, recombination."""
