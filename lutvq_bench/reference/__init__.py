"""Plain float32 references of the served models."""
