"""JSON experiment configs with a recursive merge of defaults.

The port's copy of ``heatnet_tpu/utils/config.py`` (the reference's
``helper/config.py:3-58``): a nested ``DEFAULTS`` dict with ``network``,
``optimizer`` and ``input`` sections, merged into a user config so that the
user's keys win and missing keys come from the defaults.

The ``tpu`` section stays, so that configuration files written for the JAX
package load unchanged. The port reads only its ``compute_dtype``:
``"bfloat16"`` means bf16 activations on the card (the port's default, as
its other CLIs compute), ``"float32"`` float32 there too. The CPU computes
in float32 either way.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    "network": {
        "arch": "resnet101",
        "activation": "relu",  # supported: relu, leaky_relu, elu, none
        "leaky_relu_slope": 0.01,
        "input_3x3": False,
        "bn_mode": "standard",  # supported: standard (sync/inplace are GPU-era knobs)
        "classes": 13,
        "dilation": [1, 1, 2, 4],
        "weight_gain_multiplier": 1,  # ignored if weight_init == kaiming_*
        "weight_init": "xavier_normal",
        # the reference's CUDA device ids (the port runs on one card)
        "devices": [0, 1, 2, 3],
    },
    "optimizer": {
        "batch_size": 256,
        "type": "SGD",  # supported: SGD, Adam
        "momentum": 0.9,
        "weight_decay": 0.0,
        "clip": 1.0,
        "learning_rate": 1e-8,
        "classifier_lr": -1.0,  # if -1 use the same lr as the rest of the network
        "nesterov": False,
        "schedule": {
            "type": "constant",  # constant, step, multistep, exponential, linear
            "mode": "epoch",  # epoch, step
            "epochs": 10,
            "params": {},
        },
    },
    "input": {
        "scale_train": -1,  # if -1 do not scale
        "crop_train": 224,
        "color_jitter_train": False,
        "lighting_train": False,
        "scale_val": 256,  # if -1 do not scale
        "crop_val": 224,
        "mean": [0.485, 0.456, 0.406],
        "std": [0.229, 0.224, 0.225],
    },
    # the JAX package's additions (absent from the reference); old configs stay valid
    "tpu": {
        "mesh": {"data": -1},  # -1: use all local devices on the data axis
        "compute_dtype": "bfloat16",  # dtype for conv/matmul activations
        "param_dtype": "float32",
    },
}


def _merge(src: Dict[str, Any], dst: Dict[str, Any]) -> None:
    """Recursively fill ``dst`` with keys from ``src`` without overwriting.

    Same semantics as the reference ``_merge`` (helper/config.py:46-52):
    keys present in ``dst`` win; dict values recurse.
    """
    for k, v in src.items():
        if k in dst:
            if isinstance(v, dict) and isinstance(dst[k], dict):
                _merge(src[k], dst[k])
        else:
            dst[k] = copy.deepcopy(v)


def load_config(config_file: str, defaults: Dict[str, Any] = DEFAULTS) -> Dict[str, Any]:
    """Load a JSON experiment config, filling gaps from ``defaults``."""
    with open(config_file, "r") as fd:
        config = json.load(fd)
    _merge(defaults, config)
    return config


def load_config_dict(config: Dict[str, Any], defaults: Dict[str, Any] = DEFAULTS) -> Dict[str, Any]:
    """Same as :func:`load_config` but from an in-memory dict (for tests/tools)."""
    config = copy.deepcopy(config)
    _merge(defaults, config)
    return config
