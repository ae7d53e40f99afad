"""Native C++ runtime components (ctypes-bound), built with ``g++`` on first use.

Counterpart of ``heatnet_tpu/native/``, whose four C++ files are copied here:
- ``relabeller.cpp``: the Cython label-remap kernel (c_relabeller);
- ``burst_sampler.cpp``: the image_sampler ROS node's ApproximateTime
  multi-stream synchronizer and burst gate, ROS-free;
- ``thermal_preproc.cpp``: combinedNode's 16-bit thermal contrast and
  binarization operators;
- ``pubsub.cpp``: an in-process pub/sub bus.

The shared library builds into ``heatnet_tpu_torch/_build/`` on the first
call that needs it; see :mod:`heatnet_tpu_torch.native.bindings`.
"""

from .bindings import (  # noqa: F401
    BurstSampler,
    MessageBus,
    Synchronizer,
    gray_binarize,
    relabel_image_native,
    relabel_vistas_image_native,
    thermal_to_8bit,
)
