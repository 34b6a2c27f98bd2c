"""The plain training step (JAX counterpart: train/)."""
