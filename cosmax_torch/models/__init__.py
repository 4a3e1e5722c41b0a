"""Background cosmology: expansion, distances, recombination, growth; the emulators."""
