"""The VGG19 perceptual loss (JAX counterpart: losses/)."""
