"""Geometry, plain back-projectors, filtering and planning primitives."""
