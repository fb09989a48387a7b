"""The port's own numpy-only scene host code: camera math, the input-format
DSL and the scene-manifest loader, copied from ``read_tpu/scene`` (only
what the port calls), so the port imports nothing of the JAX package."""
