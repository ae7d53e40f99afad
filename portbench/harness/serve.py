"""Serving cells: a closed loop of host batches through ``eval.validate.predict``.

One batch in flight: host frames (a pool of distinct batches made from the
seed, cycled) go through ``predict`` (ingest, the segnet, argmax) and the
class maps come back to the host. Each batch is timed from the call to its
maps on the host. The window runs until the first batch that ends past
``seconds``; every batch in it has completed. The frames per second are
reported under the name the traffic file gives (``rate_metric``): cells whose
runs spread very differently hold their rates to bounds of their own.

Correctness: a sample of the window's answers, drawn from the seed by
reservoir sampling over every batch served, is judged by the float32
reference on the same frames and weights: per pixel the gap by which the
reference's logit of the served class lies below its best, in units of the
frame's largest |logit|; ``gap_max`` is the widest, ``gap_mean`` the mean,
``flip_share`` the share of pixels served another class than the
reference's best. The cell's limits file names those that decide
``correct``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..reference import augment as ref_aug
from ..reference.lowp import fp8
from ..reference.segnet import Ctx, segnet_from_config
from . import common, roofline
from .trace import Readout, Tracer
from .traffic import serve_pool
from .weights import load_reference, make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _reference(cfg: dict) -> torch.nn.Module:
    with torch.device("meta"):
        return segnet_from_config(cfg)


def yardstick(cfg: dict, tr: dict) -> Dict[str, Dict[str, float]]:
    """FLOPs and the grouped conv's bound of one batch, counted on the
    reference at the cell's shapes (meta tensors: nothing is computed)."""
    net = _reference(cfg)
    shapes = roofline.GroupedConvShapes(net)
    x = torch.empty(tr["batch"], tr["height"], tr["width"],
                    cfg["segnet"]["input_channels"], device="meta")
    flops = roofline.count_flops(lambda: net(x, Ctx(False, cfg["segnet"]["activation"])))
    shapes.remove()
    return {"flops": {"batch": flops},
            "bound.grouped_conv3x3": {"batch": roofline.sum_bounds(shapes.shapes, True)}}


def _weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(_reference(cfg), common.sub_seed(seed, 0), device,
                        DTYPES[cfg["dtype"]])


def port_model(cfg: dict, weights, device, int8: bool = False):
    """The program's segnet with the benchmark's weights, as served."""
    from heatnet_tpu_torch.models.layers import NormAct, prepare_for_inference
    from heatnet_tpu_torch.models.trgb_segnet import ResNeXtSeg

    s = cfg["segnet"]
    with torch.device("meta"):
        model = ResNeXtSeg(structure=tuple(s["structure"]), groups=s["groups"],
                           classes=s["classes"], dilation=tuple(s["dilation"]),
                           base_channels=tuple(s["base_channels"]),
                           input_channels=s["input_channels"],
                           norm_act=NormAct(activation=s["activation"]))
    if int8:  # the int8 layers quantize a float32 weight
        from heatnet_tpu_torch.ops.quant import convert_int8
        weights = {k: v.float() if v.is_floating_point() else v for k, v in weights.items()}
        model.load_state_dict(weights, assign=True)
        convert_int8(model)
    else:
        model.load_state_dict(weights, assign=True)
    return prepare_for_inference(model, device)


def predictor(cfg: dict, weights, device, control: str = "") -> Tuple[Callable, Callable]:
    """(run, to_host): ``run(batch)`` serves a host batch and returns its maps
    on the device; ``to_host`` brings them back. The program unless
    ``control`` names the control in its place: ``int8``, the program's
    own int8 path (calibrated on the first frame, as ``cli.inference``
    does), or ``fp8``, the reference in fp8."""
    from heatnet_tpu_torch.eval import validate

    mods = cfg["modalities"]
    if control == "fp8":
        ref = load_reference(_reference(cfg), weights)
        act = cfg["segnet"]["activation"]

        def run(batch):
            with torch.no_grad():
                x = ref_aug.ingest(*_ref_frames(batch, device))
                return ref(x, Ctx(False, act, quant=fp8))[0].argmax(-1).to(torch.uint8)
    else:
        model = port_model(cfg, weights, device, int8=control == "int8")

        def run(batch):
            return validate.predict(model, batch, mods, device)

        if control == "int8":
            from heatnet_tpu_torch.ops.quant import calibrate_int8

            run.calibrate = lambda batch: calibrate_int8(model, [validate.ingest(
                {k: v[:1] for k, v in batch.items()}, mods, device, model.compute_dtype)])
    return run, lambda maps: maps.cpu().numpy()


def _ref_frames(batch: Dict[str, np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor]:
    rgb = torch.from_numpy(np.ascontiguousarray(batch["rgb"])).to(device)
    ir = torch.from_numpy(batch["ir"].astype(np.int32)).to(device)
    return rgb, ir


class Reservoir:
    """A uniform sample of ``k`` of the answers served, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, np.random.default_rng(seed), 0
        self.items: List[Tuple[int, np.ndarray]] = []

    def offer(self, index: int, answer: np.ndarray) -> None:
        if len(self.items) < self.k:
            self.items.append((index, answer))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = (index, answer)
        self.seen += 1


def judge(cfg: dict, tr: dict, weights, pool, sample, device) -> Dict[str, float]:
    """``gap_max``, ``gap_mean`` and ``flip_share`` of the sampled answers against the float32
    reference, in blocks of ``check.block`` frames."""
    common.reference_precision()
    ref = load_reference(_reference(cfg), weights)
    act = cfg["segnet"]["activation"]
    block = tr["check"]["block"]
    gap_max, gap_sum, flips, pixels = 0.0, 0.0, 0, 0
    with torch.no_grad():
        for index, answer in sample:
            rgb, ir = _ref_frames(pool[index % len(pool)], device)
            served = torch.from_numpy(answer).to(device).long()
            for s in range(0, rgb.shape[0], block):
                logits, _ = ref(ref_aug.ingest(rgb[s:s + block], ir[s:s + block]), Ctx(False, act))
                best = logits.max(-1).values
                got = torch.gather(logits, -1, served[s:s + block, ..., None])[..., 0]
                scale = logits.abs().flatten(1).max(1).values.clamp(min=1e-30).view(-1, 1, 1)
                gap = (best - got) / scale
                gap_max = max(gap_max, float(gap.max()))
                gap_sum += float(gap.double().sum())
                flips += int((gap > 0).sum())
                pixels += gap.numel()
    return {"gap_max": gap_max, "gap_mean": gap_sum / max(pixels, 1),
            "flip_share": flips / max(pixels, 1)}


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        control: str = "") -> dict:
    cfg, tr = cell.config, cell.traffic
    readout = Readout("serve")
    readout.work = yardstick(cfg, tr)
    pool = serve_pool(tr, common.sub_seed(seed, 1), device)
    weights = _weights(cfg, seed, device)
    run_batch, to_host = predictor(cfg, weights, device, control)
    if hasattr(run_batch, "calibrate"):
        run_batch.calibrate(pool[0])
    del weights
    for b in pool[:tr["warmup_batches"]]:
        to_host(run_batch(b))
    common.sync(device)

    tracer = Tracer(readout, device) if trace else None
    every, active = tr["trace"]["every"], tr["trace"]["active"]
    sample = Reservoir(tr["check"]["batches"], common.sub_seed(seed, 3))
    latencies: List[float] = []
    host_s = [0.0, 0.0]  # untraced batches: in the predict call, then in bringing the maps back
    t_start_wall = time.time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    end = t0
    while end < deadline:
        traced = tracer is not None and i % every == 0
        span = tracer.span(batch=active) if traced else contextlib.nullcontext()
        with span:
            for _ in range(active if traced else 1):
                s = time.perf_counter()
                with torch.profiler.record_function("pb.predict"):
                    maps = run_batch(pool[i % len(pool)])
                mid = time.perf_counter()
                with torch.profiler.record_function("pb.to_host"):
                    answer = to_host(maps)
                end = time.perf_counter()
                latencies.append(end - s)
                if not traced:
                    host_s[0] += mid - s
                    host_s[1] += end - mid
                sample.offer(i, answer)
                i += 1
    elapsed = end - t0
    readout.run_units, readout.run_s = {"batch": i}, elapsed
    peak = common.memory_peak(device)
    del run_batch, to_host
    common.free(device)

    readings = judge(cfg, tr, _weights(cfg, seed, device), pool, sample.items, device)
    frames = i * tr["batch"]
    return {"window_start": t_start_wall, "window_s": elapsed, "attempted": i, "failed": 0,
            "end_to_end": {tr["rate_metric"]: frames / elapsed,
                           "serve_p95_ms": 1e3 * float(np.percentile(latencies, 95))},
            "readout": readout, "readings": readings, "memory_peak_bytes": peak,
            "host_ms": dict({k: 1e3 * v / max(i - readout.n_units, 1)
                             for k, v in zip(("predict", "to_host"), host_s)},
                            **{f"latency_{h}_half": 1e3 * float(np.mean(part))
                               for h, part in zip(("first", "second"),
                                                  np.array_split(latencies, 2))})}
