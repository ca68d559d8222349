"""Seeded input generators: terrains."""
