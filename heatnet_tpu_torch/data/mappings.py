"""Class-label mappings and the palette of the HeatNet label space.

The port's copy of ``heatnet_tpu/data/mappings.py``: the 13-class space
(+12 background, +13 ignore), the Mapillary Vistas → HeatNet relabelling
(``VISTAS_TO_HEATNET``, ``c_relabeller/mapping.py``, and
``relabel_vistas_image``, the numpy form of ``c_relabeller/relabeller.pyx``),
the HeatNet → MFNet and BDD → HeatNet maps of ``validation_bdd_mf.py:9-37``,
their lookup tables, and the reference's palette (``vis_utils.py:26-41``).
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 13
BACKGROUND_CLASS = 12
IGNORE_CLASS = 13

CLASS_NAMES = [
    "road,parking",
    "ground,sidewalk",
    "building,",
    "curb",
    "fence",
    "pole,traffic light,traffic sign",
    "vegetation",
    "terrain",
    "sky",
    "person,rider",
    "car,truck,bus,train",
    "motorcycle,bicycle",
    "background",
    "ignore",
]

# Mapillary Vistas class id → HeatNet class (c_relabeller/mapping.py)
VISTAS_TO_HEATNET = {
    10: 0, 12: 0, 13: 0, 14: 0, 23: 0, 24: 0,
    7: 1, 8: 0, 11: 1, 15: 1,
    6: 2, 17: 2, 16: 2, 18: 2,
    2: 3, 9: 3, 5: 3,
    3: 4, 4: 4,
    44: 5, 45: 5, 46: 5, 47: 5, 48: 5, 49: 5, 50: 5,
    30: 6,
    25: 7, 26: 7, 28: 7, 29: 7, 31: 7,
    27: 8,
    0: 9, 20: 9, 21: 9, 22: 9, 19: 9,
    53: 10, 54: 10, 55: 10, 56: 10, 58: 10, 59: 10, 60: 10, 61: 10, 62: 10,
    52: 11, 57: 11,
    65: 13,
}

# HeatNet class → MFNet class, for evaluating HeatNet preds on MFNet GT
# (validation_bdd_mf.py:9-14)
HEATNET_TO_MFNET = {3: 4, 9: 2, 10: 1, 11: 3}

# BDD100K train-id → HeatNet class (validation_bdd_mf.py:16-37)
BDD_TO_HEATNET = {
    0: 0, 1: 1, 2: 2, 3: 2, 4: 4, 5: 5, 6: 5, 7: 5, 8: 6, 9: 7, 10: 8,
    11: 9, 12: 9, 13: 10, 14: 10, 15: 10, 16: 10, 17: 11, 18: 11, 255: 13,
}


def mapping_to_lut(mapping: dict, num_src: int = 256,
                   default: int = BACKGROUND_CLASS) -> np.ndarray:
    """Dense lookup table for a sparse class mapping."""
    lut = np.full(num_src, default, dtype=np.int32)
    for src, dst in mapping.items():
        if src < num_src:
            lut[src] = dst
    return lut


def remap_labels(labels: np.ndarray, mapping: dict,
                 default: int = BACKGROUND_CLASS) -> np.ndarray:
    """Class labels through ``mapping`` (``default`` where it has none), as a
    lookup table gathered at every pixel (``heatnet_tpu/data/mappings.py:82``)."""
    lut = mapping_to_lut(mapping, num_src=max(int(labels.max(initial=0)) + 1, 256),
                         default=default)
    return lut[labels.astype(np.int64)]


def relabel_vistas_image(img_u16: np.ndarray, mapping: dict = VISTAS_TO_HEATNET
                         ) -> np.ndarray:
    """Panoptic relabel: uint16 ``class*256 + instance`` → ``mapped*256 +
    dense instance id`` (relabeller.pyx:4-36). Unmapped classes become
    ``background*256``. Instance ids are renumbered densely in the order
    each (class, instance) pair is first met in a column-major scan, as the
    Cython loop meets them."""
    cls = (img_u16 // 256).astype(np.int64)
    inst = (img_u16 % 256).astype(np.int64)
    mapped = cls.copy()
    keep = np.zeros_like(cls, dtype=bool)
    for src, dst in mapping.items():
        sel = cls == src
        mapped[sel] = dst
        keep |= sel

    combo = cls * 256 + inst
    combo_t = combo.T.reshape(-1)
    keep_t = keep.T.reshape(-1)
    uniq, first_idx = np.unique(combo_t[keep_t], return_index=True)
    new_inst = np.zeros_like(combo_t)
    if uniq.size:
        dense = np.zeros(int(uniq.max()) + 1, dtype=np.int64)
        dense[uniq[np.argsort(first_idx)]] = np.arange(uniq.size)
        new_inst[keep_t] = dense[combo_t[keep_t]]
    new_inst = new_inst.reshape(combo.T.shape).T
    out = np.where(keep, mapped * 256 + new_inst, BACKGROUND_CLASS * 256)
    return out.astype(np.uint16)


# fixed semantic palette of the reference ColorCode.get_coding_1, RGB order;
# classes 12/13 are black
HEATNET_PALETTE = np.array([
    [70, 70, 70],      # 0 road,parking
    [244, 35, 232],    # 1 ground,sidewalk
    [128, 64, 128],    # 2 building
    [168, 168, 168],   # 3 curb
    [0, 255, 255],     # 4 fence
    [255, 165, 0],     # 5 pole,traffic light,traffic sign
    [107, 142, 35],    # 6 vegetation
    [255, 255, 0],     # 7 terrain
    [70, 130, 180],    # 8 sky
    [220, 20, 60],     # 9 person,rider
    [0, 255, 0],       # 10 car,truck,bus,train
    [190, 153, 153],   # 11 motorcycle,bicycle
    [0, 0, 0],         # 12 background
    [0, 0, 0],         # 13 ignore
], dtype=np.uint8)


def color_palette(n: int = 256, seed: int = 0) -> np.ndarray:
    """RGB palette: the fixed semantic colours for classes 0-13, then
    deterministic random colours for any ids beyond."""
    rng = np.random.RandomState(seed)
    pal = rng.randint(0, 255, size=(n, 3)).astype(np.uint8)
    k = min(n, len(HEATNET_PALETTE))
    pal[:k] = HEATNET_PALETTE[:k]
    return pal
