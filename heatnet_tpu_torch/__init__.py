"""heatnet_tpu_torch — the PyTorch/CUDA port of ``heatnet_tpu`` for one NVIDIA H100.

Module names mirror the JAX package, so ``heatnet_tpu.X.Y`` has its
counterpart at ``heatnet_tpu_torch.X.Y``. The port imports torch and numpy,
never JAX or anything of ``heatnet_tpu``: what it needs from a module there
it keeps as its own copy.

Conventions:

- Public functions take and return the JAX package's NHWC layout, so tests
  compare like with like. Inside the modules activations are NCHW tensors in
  ``torch.channels_last`` memory, which is the same bytes: a contiguous NHWC
  tensor ``.permute(0, 3, 1, 2)`` is channels_last with no copy.
- Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
  with no card and no CPU request they raise (``device.resolve``).
- The TPU's Pallas kernels are CUDA C++ kernels under ``csrc/``, built on
  first use by ``kernels/build.py``. Each has a plain PyTorch version in the
  same ops module; a wrapper takes the plain version only for a CPU tensor.

Package map:

- ``ops``     ingest normalisers and the grouped 3x3 conv (kernels + plain)
- ``models``  eval-mode layers, ``ResNeXtSeg`` and the registry
- ``kernels`` the nvcc build and ctypes binding of ``csrc/*.cu``
- ``io``      JAX parameter trees → the port's ``state_dict``
- ``data``    heatnet-pack-v1 frame packs
- ``eval``    batched inference to uint8 class maps
- ``cli``     the ``inference`` entry point
"""

__version__ = "0.1.0"
