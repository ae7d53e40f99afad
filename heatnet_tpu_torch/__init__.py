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

- ``ops``     ingest normalisers, the grouped 3x3 conv and its autograd
              Function, the int8 conv (kernels + plain; the kernels also
              as ``torch.ops.heatnet.*`` custom ops, which a traced
              program calls), train augmentation, IoU counts
- ``models``  layers (eval and train mode), ``ResNeXtSeg``, PSPNet, the
              CycleGAN nets, the MFNet harness's baselines (MFNet, RTFNet,
              SegNet) and UNets, and the registry
- ``kernels`` the nvcc build and ctypes binding of ``csrc/*.cu``
- ``io``      JAX parameter trees → ``state_dict``; checkpoints; run logs;
              serving artifacts (``torch.export``)
- ``data``    inference and train packs and their packers, a PNG codec
              (zlib + numpy), eval and training loaders of PNG trees
              (Freiburg, Vistas, MFNet, KAIST,
              the MFNet harness with its augmentation suite) with numpy
              copies of cv2's and Pillow's image calls, batches,
              augmentation on the device
- ``train``   loss, train/eval steps, optimizers and schedules, train state
- ``eval``    the validators (per-class IoU), the confusion-matrix IoU
              metric, and batched inference to uint8 class maps
- ``utils``   experiment configs, label colour coding and PNG dumps
- ``cli``     the ``inference``, ``main`` (Vistas pretraining),
              ``train_plain``, ``train_conf``, ``train_cyclegan``,
              ``test_cyclegan``, ``train_uncertainty``, ``train_baseline``
              and ``run_demo`` (the MFNet harness), ``eval_hotnet`` and
              ``dataset_qa``, ``pack_frames`` and ``export_model`` entry
              points (``train_conf`` also evaluates and infers)
- ``tools``   profilers of the forward and the training steps on the card,
              the PNG decoder's timing
"""

__version__ = "0.1.0"
