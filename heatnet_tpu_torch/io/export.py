"""Serving artifacts: a model exported with ``torch.export``, weights included.

Counterpart of ``heatnet_tpu/io/export.py:35-112``:

- ``export_inference`` traces optional in-graph normalisation (raw uint8 RGB
  / uint16 IR → [-1, 1], the eval loaders' convention, one launch of the
  ingest kernel), the forward and the argmax to an int32 class map (logits
  with ``argmax=False``) with ``torch.export.export``. The batch is one
  symbolic ``torch.export.Dim`` shared by the inputs unless
  ``symbolic_batch=False``, so one artifact serves any batch size.
- ``save_exported`` / ``load_exported`` write and read it with
  ``torch.export.save`` / ``torch.export.load``; ``exported_info``
  summarises it.

What serving needs differs from JAX's artifact. JAX's is StableHLO and its
loader needs only ``jax``. The port's graph calls the port's CUDA kernels as
custom ops (``torch.ops.heatnet.*``, ``ops/library.py``), so its loader
needs ``torch`` and ``heatnet_tpu_torch.ops``, which registers the ops and
builds the kernels at their first launch (``nvcc`` on the serving machine);
no model code and no checkpoint::

    import torch, heatnet_tpu_torch.ops
    serve = torch.export.load("heatnet.pt2").module()
    classes = serve(rgb_uint8, ir_uint16)     # any batch size, on the card

An artifact is traced on the device its model lives on, and holds its
weights there: export on ``cuda`` to serve on the card. An int8 model
(``ops/quant.py``) is exported with its weights quantized and its scales
fixed; at a symbolic batch its layers follow JAX's rule for an exported
artifact (the throughput regime, ``models/layers.py::int8_batch_ok``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..eval.validate import normalize_frames
from ..models.layers import _Int8Layer


class ServingGraph(nn.Module):
    """``normalize → model → argmax`` as one module, the function exported."""

    def __init__(self, model: nn.Module, normalize: bool, argmax: bool):
        super().__init__()
        self.model = model
        self.normalize = normalize
        self.argmax = argmax

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        dtype = self.model.compute_dtype
        if self.normalize:
            x = normalize_frames(inputs, dtype, getattr(self.model, "late_fusion", False))
        else:
            x = tuple(t.to(dtype) for t in inputs)
        seg = self.model(*x)[0]  # (seg, taps, cert) → the logits
        return seg.argmax(dim=-1).to(torch.int32) if self.argmax else seg


def export_inference(model: nn.Module, input_shapes: Sequence[Tuple[int, ...]],
                     input_dtypes: Optional[Sequence[torch.dtype]] = None, *,
                     symbolic_batch: bool = True, normalize: bool = False,
                     argmax: bool = True) -> torch.export.ExportedProgram:
    """Export ``model`` (prepared for inference on its device) for serving.

    ``input_shapes`` are per input ``(batch, H, W, C)``, RGB before IR;
    with ``symbolic_batch`` the batch entries become one symbolic
    dimension. ``normalize=True`` takes uint8 RGB / uint16 IR and
    normalises in the graph. ``argmax=True`` returns the int32 class map.
    """
    if input_dtypes is None:
        input_dtypes = [torch.float32] * len(input_shapes)
    device = next(model.parameters()).device
    # a symbolic batch traces at 2 frames: a traced size of 1 would be fixed
    n = 2 if symbolic_batch else input_shapes[0][0]
    # uint16 has few CUDA kernels: its zeros are int16 zeros, viewed
    example = tuple(torch.zeros((n,) + tuple(s[1:]), device=device,
                                dtype=torch.int16 if d == torch.uint16 else d).view(d)
                    for s, d in zip(input_shapes, input_dtypes))
    dynamic = None
    if symbolic_batch:
        b = torch.export.Dim("b", min=1)
        dynamic = {"inputs": tuple({0: b} for _ in example)}
    int8 = [m for m in model.modules() if isinstance(m, _Int8Layer)]
    for m in int8:
        m.freeze(model.compute_dtype)
    try:
        with torch.no_grad():
            return torch.export.export(ServingGraph(model, normalize, argmax).eval(),
                                       example, dynamic_shapes=dynamic, strict=False)
    finally:
        for m in int8:
            m.thaw()


def save_exported(path: str, artifact: torch.export.ExportedProgram) -> None:
    torch.export.save(artifact, path)


def load_exported(path: str) -> Callable:
    """Load a serving artifact; returns the callable module. Importing
    ``heatnet_tpu_torch.ops`` registers the kernels' ops it calls."""
    from .. import ops  # noqa: F401

    return torch.export.load(path).module()


def _spec(val) -> str:
    return f"{str(val.dtype).replace('torch.', '')}[{','.join(str(s) for s in val.shape)}]"


def exported_info(path: str) -> dict:
    """A summary of an artifact: its inputs' and outputs' dtypes and shapes
    (the symbolic batch by its symbol), the device of its weights, its
    size."""
    from .. import ops  # noqa: F401

    ep = torch.export.load(path)
    sig = ep.graph_signature
    nodes = {node.name: node for node in ep.graph.nodes}
    outputs = next(node for node in ep.graph.nodes if node.op == "output").args[0]
    tensors = list(ep.state_dict.values()) + list(ep.constants.values())
    devices = sorted({t.device.type for t in tensors if isinstance(t, torch.Tensor)})
    return {
        "fn_name": ServingGraph.__name__,
        "platforms": devices,
        "in_avals": [_spec(nodes[name].meta["val"]) for name in sig.user_inputs],
        "out_avals": [_spec(o.meta["val"]) for o in outputs],
        "bytes": os.path.getsize(path),
    }
