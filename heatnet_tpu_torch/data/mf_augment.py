"""The MFNet harness's augmentation suite (numpy only).

The port's copy of ``heatnet_tpu/data/mf_augment.py``
(``models/external_models/mfnet/util/augmentation.py:1-96`` of the
reference): five callable classes with the ``(image, label) -> (image,
label)`` protocol, applied on the host before batching (train.py:22-26 of
the reference enables RandomFlip + RandomCrop), each with its own
``RandomState`` (the reference draws from the global ``np.random`` state).

The reference unpacks ``w, h, c = image.shape`` (so its "w" is the row
count) and crops rows by the "w" bounds: rows are cropped by ``crop_rate``
of the row count and columns by ``crop_rate`` of the column count, which is
what these classes do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class _Aug:
    def __init__(self, prob: float, seed: Optional[int] = None):
        self.prob = prob
        self._rng = np.random.RandomState(seed)


class RandomFlip(_Aug):
    """Horizontal flip of image + label (augmentation.py:7-16)."""

    def __init__(self, prob: float = 0.5, seed: Optional[int] = None):
        super().__init__(prob, seed)

    def __call__(self, image: np.ndarray, label: np.ndarray) -> Tuple:
        if self._rng.rand() < self.prob:
            image = image[:, ::-1]
            label = label[:, ::-1]
        return image, label


class RandomCrop(_Aug):
    """Crop up to ``crop_rate`` off each border, keeping the rest
    (augmentation.py:19-37). Output size varies — resize downstream."""

    def __init__(self, crop_rate: float = 0.1, prob: float = 1.0,
                 seed: Optional[int] = None):
        super().__init__(prob, seed)
        self.crop_rate = crop_rate

    def __call__(self, image: np.ndarray, label: np.ndarray) -> Tuple:
        if self._rng.rand() < self.prob:
            h, w = image.shape[0], image.shape[1]
            r1 = self._rng.randint(0, max(int(h * self.crop_rate), 1))
            c1 = self._rng.randint(0, max(int(w * self.crop_rate), 1))
            r2 = self._rng.randint(h - int(h * self.crop_rate), h + 1)
            c2 = self._rng.randint(w - int(w * self.crop_rate), w + 1)
            image = image[r1:r2, c1:c2]
            label = label[r1:r2, c1:c2]
        return image, label


class RandomCropOut(_Aug):
    """Zero out a ``crop_rate``-sized rectangle in image AND label
    (augmentation.py:40-58)."""

    def __init__(self, crop_rate: float = 0.2, prob: float = 1.0,
                 seed: Optional[int] = None):
        super().__init__(prob, seed)
        self.crop_rate = crop_rate

    def __call__(self, image: np.ndarray, label: np.ndarray) -> Tuple:
        if self._rng.rand() < self.prob:
            image = np.array(image, copy=True)
            label = np.array(label, copy=True)
            h, w = image.shape[0], image.shape[1]
            r1 = self._rng.randint(0, max(int(h * self.crop_rate), 1))
            c1 = self._rng.randint(0, max(int(w * self.crop_rate), 1))
            r2 = int(r1 + h * self.crop_rate)
            c2 = int(c1 + w * self.crop_rate)
            image[r1:r2, c1:c2] = 0
            label[r1:r2, c1:c2] = 0
        return image, label


class RandomBrightness(_Aug):
    """Scale brightness by U[1-range, 1+range] (augmentation.py:61-72)."""

    def __init__(self, bright_range: float = 0.15, prob: float = 0.9,
                 seed: Optional[int] = None):
        super().__init__(prob, seed)
        self.bright_range = bright_range

    def __call__(self, image: np.ndarray, label: np.ndarray) -> Tuple:
        if self._rng.rand() < self.prob:
            factor = self._rng.uniform(1 - self.bright_range,
                                       1 + self.bright_range)
            image = (image * factor).astype(image.dtype)
        return image, label


class RandomNoise(_Aug):
    """Add integer noise in [-range, range], clip to [0, 255]
    (augmentation.py:75-96)."""

    def __init__(self, noise_range: int = 5, prob: float = 0.9,
                 seed: Optional[int] = None):
        super().__init__(prob, seed)
        self.noise_range = noise_range

    def __call__(self, image: np.ndarray, label: np.ndarray) -> Tuple:
        if self._rng.rand() < self.prob:
            noise = self._rng.randint(-self.noise_range, self.noise_range,
                                      image.shape)
            image = (image + noise).clip(0, 255).astype(image.dtype)
        return image, label


# train.py:22-26 default pipeline (RandomCropOut/Brightness/Noise are
# defined but commented out in the reference)
def default_train_augmentations(seed: Optional[int] = None):
    return [RandomFlip(prob=0.5, seed=seed),
            RandomCrop(crop_rate=0.1, prob=1.0,
                       seed=None if seed is None else seed + 1)]
