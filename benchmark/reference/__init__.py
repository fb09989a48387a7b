"""The benchmark's plain reference: what decides ``correct``.

Plain PyTorch, written from the published READ model and the
configuration files under ``benchmark/configs``: the exact z-buffer and
its pyramid (:mod:`.raster`), the MIMO-UNet in both its eval and its
training form (:mod:`.unet`), and the VGG loss, the pixel loss and the
two optimizers of a fitting step (:mod:`.fit`). Every convolution goes
through :func:`.prec.conv2d`, in float32 with TF32 off, or with its
operands rounded to TF32 for the control.

Nothing here imports ``jax``, the JAX package or the PyTorch port: the
reference is the yardstick the port is held to, and takes from it only
its outputs.
"""
