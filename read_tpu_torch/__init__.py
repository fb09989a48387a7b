"""read_tpu_torch — the PyTorch/CUDA port of ``read_tpu``.

The serving frame of ``read_tpu`` (project 1M points, packed-key
z-buffer, 4-level index pyramid, descriptor gather, MIMO-UNet eval
forward) in plain PyTorch, with the three Pallas kernels of that path
rewritten by hand in CUDA C++ for Hopper (``csrc/``). ``read_tpu`` stays
the reference: the port reads its checkpoints and is held against it by
the ``tests/test_torch_*.py`` parity tests.

Subpackages mirror ``read_tpu``'s layout:

- ``read_tpu_torch.ops``       — projection, z-buffer (K1), pools, and the
                                 gated-conv kernels (K2, K3) with their
                                 plain PyTorch twins.
- ``read_tpu_torch.models``    — descriptor gather and the UNet.
- ``read_tpu_torch.pipelines`` — the checkpoint config and pyramid build.
- ``read_tpu_torch.utils``     — checkpoint IO and the weight bridge.
- ``read_tpu_torch.render``    — the checkpoint-driven renderer.
- ``read_tpu_torch.frame``     — the benchmark frame.

Importing the package imports neither JAX nor Triton and builds nothing:
kernels are compiled on first use by :mod:`read_tpu_torch._build`.
"""

__version__ = "0.1.0"
