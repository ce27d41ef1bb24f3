"""Data layer of the port: entity indexing and the storage needed to
deploy a trained generation."""
