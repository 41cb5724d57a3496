"""Host-only helpers copied from the JAX package (prompt templates, the
tokenizer loader with its offline byte-level fallback)."""
