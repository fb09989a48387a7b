"""The port's own numpy-only scene host code: camera math, the input-format
DSL, the scene-manifest loader, the trackball, camera trajectories and the
composition tools (stitch, edit, panorama), copied from ``read_tpu/scene``
so the port imports nothing of the JAX package."""
