"""Preprocessing components.

The port's own copy of the image-classification and token parts of
``zookeeper_tpu/data/preprocessing.py``: a component that maps a raw
example to ``{"input", "target"}`` on the host, in numpy, before
batching. ``TokenPreprocessing`` passes token windows through and takes
its ``input_shape`` from ``seq_len``. Augmentation (CIFAR-style pad+crop or Inception-style
RandomResizedCrop, then a horizontal flip) draws from the counter RNG of
``data/augrng.py`` keyed by (pipeline seed, example index, epoch), with
the same draw order and arithmetic as the JAX package, so the same
example gives the same float32 bytes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from zookeeper_tpu_torch.core import Field, component
from zookeeper_tpu_torch.data.augrng import AugRng, recipe_exp
from zookeeper_tpu_torch.data.source import Example


@component
class Preprocessing:
    """Abstract preprocessing: ``input(example, training)`` is the model
    input, ``output(example, training)`` the target, ``input_shape`` the
    per-example input shape (no batch dim)."""

    def input(self, example: Example, training: bool) -> np.ndarray:
        raise NotImplementedError

    def output(self, example: Example, training: bool) -> np.ndarray:
        raise NotImplementedError

    @property
    def input_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def input_dtype(self) -> Optional[str]:
        """Numpy dtype name of the model input, or None when unknown."""
        return None

    def __call__(self, example: Example, training: bool) -> Example:
        return {
            "input": np.asarray(self.input(example, training)),
            "target": np.asarray(self.output(example, training)),
        }

    def native_batch_spec(self, training: bool):
        """The spec of the pipeline's native batch assembly
        (``data.pipeline``, ``zookeeper_tpu_torch.native``) when this
        preprocessing reduces to it in this mode over a uint8 store;
        None keeps the per-example path."""
        return None


@component
class PassThroughPreprocessing(Preprocessing):
    """Forwards ``example[input_key]`` and ``example[target_key]``
    unchanged. ``example_shape`` declares the per-example input shape for
    an experiment that sizes its model from it; it raises when asked and
    not set."""

    input_key: str = Field("image")
    target_key: str = Field("label")
    example_shape: Optional[Tuple[int, ...]] = Field(None)

    def input(self, example: Example, training: bool) -> np.ndarray:
        return example[self.input_key]

    def output(self, example: Example, training: bool) -> np.ndarray:
        return example[self.target_key]

    @property
    def input_shape(self) -> Tuple[int, ...]:
        if self.example_shape is None:
            raise ValueError(
                "PassThroughPreprocessing.input_shape was asked for but "
                "example_shape is not configured: set e.g. "
                "preprocessing.example_shape=(seq_len,) so the experiment "
                "can size the model."
            )
        return tuple(self.example_shape)


@component
class TokenPreprocessing(PassThroughPreprocessing):
    """Token windows through unchanged (``tokens`` in, ``next`` as the
    target), int32 inputs, ``input_shape`` ``(seq_len,)`` unless
    ``example_shape`` is set. ``seq_len`` is a field, so it is inherited
    from the task like the dataset's."""

    input_key: str = Field("tokens")
    target_key: str = Field("next")
    seq_len: int = Field(64)

    @property
    def input_dtype(self) -> str:
        return "int32"

    @property
    def input_shape(self) -> Tuple[int, ...]:
        if self.example_shape is not None:
            return tuple(self.example_shape)
        return (self.seq_len,)


@component
class ImageClassificationPreprocessing(Preprocessing):
    """Scale uint8 pixels to [-1, 1] (or [0, 1]), optionally augment at
    train time, and emit the integer label."""

    image_key: str = Field("image")
    label_key: str = Field("label")
    height: int = Field(32)
    width: int = Field(32)
    channels: int = Field(3)
    zero_center: bool = Field(True)
    augment: bool = Field(False)
    pad_pixels: int = Field(4)
    random_flip: bool = Field(True)
    #: Inception-style RandomResizedCrop: a crop covering
    #: ``crop_scale_range`` of the source area at an aspect ratio in
    #: ``crop_aspect_range``, bilinear-resized to (height, width)
    #: (half-pixel centers, clamped edges). Replaces pad+crop when on.
    random_resized_crop: bool = Field(False)
    crop_scale_range: Tuple[float, float] = Field((0.08, 1.0))
    crop_aspect_range: Tuple[float, float] = Field((0.75, 4.0 / 3.0))

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return (self.height, self.width, self.channels)

    def _validated_rrc_ranges(self):
        """``(scale_lo, scale_hi, log_aspect_lo, log_aspect_hi)``, or a
        ValueError naming the configured ranges."""
        s_lo, s_hi = self.crop_scale_range
        a_lo, a_hi = self.crop_aspect_range
        if not (0.0 < s_lo <= s_hi <= 1.0) or not (0.0 < a_lo <= a_hi):
            raise ValueError(
                f"Invalid RandomResizedCrop ranges: crop_scale_range="
                f"{(s_lo, s_hi)} must satisfy 0 < lo <= hi <= 1 and "
                f"crop_aspect_range={(a_lo, a_hi)} must satisfy "
                "0 < lo <= hi."
            )
        return float(s_lo), float(s_hi), math.log(a_lo), math.log(a_hi)

    def _random_resized_crop(self, image: np.ndarray, rng: AugRng) -> np.ndarray:
        lo, hi, log_lo, log_hi = self._validated_rrc_ranges()
        h, w = image.shape[:2]
        area = float(h * w)
        # Ten rejection-sampled tries, then a center-square fallback.
        for _ in range(10):
            target_area = area * rng.uniform(lo, hi)
            aspect = recipe_exp(rng.uniform(log_lo, log_hi))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = rng.randint(h - ch + 1)
                left = rng.randint(w - cw + 1)
                crop = image[top : top + ch, left : left + cw]
                return _resize_bilinear(crop, self.height, self.width)
        side = min(h, w)
        crop = _center_crop_or_pad(image, side, side)
        return _resize_bilinear(crop, self.height, self.width)

    def _augment(self, image: np.ndarray, rng: AugRng) -> np.ndarray:
        if self.random_resized_crop:
            image = self._random_resized_crop(image, rng)
        else:
            p = self.pad_pixels
            if p > 0:
                padded = np.pad(image, ((p, p), (p, p), (0, 0)), mode="reflect")
                oy = rng.randint(2 * p + 1)
                ox = rng.randint(2 * p + 1)
                image = padded[oy : oy + self.height, ox : ox + self.width]
        if self.random_flip and rng.randint(2) == 1:
            image = image[:, ::-1]
        return image

    def input(self, example: Example, training: bool) -> np.ndarray:
        image = np.asarray(example[self.image_key])
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        else:
            image = image.astype(np.float32)
        if image.ndim == 2:
            image = image[..., None]
        if training and self.augment:
            rng = AugRng(
                int(example.get("_seed", 0)),
                int(example.get("_index", 0)),
                int(example.get("_epoch", 0)),
            )
            image = self._augment(image, rng)
        if image.shape[:2] != (self.height, self.width):
            image = _center_crop_or_pad(image, self.height, self.width)
        if self.zero_center:
            image = image * 2.0 - 1.0
        return np.ascontiguousarray(image)

    def output(self, example: Example, training: bool) -> np.ndarray:
        return np.asarray(example[self.label_key], dtype=np.int32)

    def native_batch_spec(self, training: bool):
        """The JAX package's spec. Training with ``augment``: the
        "augment" mode, the whole recipe, which the native kernel replays
        bit for bit through the shared counter RNG. Otherwise the
        "normalize" mode: the affine over the uint8 pixels, as JAX's
        ``scale``/``shift`` and as this package assembles it,
        ``post_scale``/``post_shift`` after the division by 255 (the
        per-example path's order, ``data.pipeline``)."""
        if training and self.augment:
            spec = {
                "image_key": self.image_key,
                "label_key": self.label_key,
                "mode": "augment",
                "expected_shape": self.input_shape,
                "random_resized_crop": bool(self.random_resized_crop),
                "pad_pixels": int(self.pad_pixels),
                "random_flip": bool(self.random_flip),
                "post_scale": 2.0 if self.zero_center else 1.0,
                "post_shift": -1.0 if self.zero_center else 0.0,
                "crop_scale_range": (0.0, 0.0),
                "log_aspect_range": (0.0, 0.0),
            }
            if self.random_resized_crop:
                s_lo, s_hi, log_lo, log_hi = self._validated_rrc_ranges()
                spec["crop_scale_range"] = (s_lo, s_hi)
                spec["log_aspect_range"] = (log_lo, log_hi)
            return spec
        if self.zero_center:
            scale, shift = 2.0 / 255.0, -1.0
        else:
            scale, shift = 1.0 / 255.0, 0.0
        return {
            "image_key": self.image_key,
            "label_key": self.label_key,
            "mode": "normalize",
            "scale": scale,
            "shift": shift,
            "post_scale": 2.0 if self.zero_center else 1.0,
            "post_shift": -1.0 if self.zero_center else 0.0,
            "expected_shape": self.input_shape,
        }


def _center_crop_or_pad(image: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = image.shape[:2]
    if h > height:
        top = (h - height) // 2
        image = image[top : top + height]
    if w > width:
        left = (w - width) // 2
        image = image[:, left : left + width]
    h, w = image.shape[:2]
    if h < height or w < width:
        image = np.pad(
            image,
            ((0, height - h), (0, width - w), (0, 0)),
            mode="constant",
        )
    return image


def _resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize, half-pixel centers (align_corners=False), clamped
    edges: source coordinates in float64, weights in float32, and the
    fixed op order ``(p00*wx0 + p01*fx)*wy0 + (p10*wx0 + p11*fx)*fy``."""
    h, w = image.shape[:2]
    img = np.ascontiguousarray(image, dtype=np.float32)
    sy = (np.arange(height, dtype=np.float64) + 0.5) * (h / height) - 0.5
    sx = (np.arange(width, dtype=np.float64) + 0.5) * (w / width) - 0.5
    y0 = np.floor(sy)
    x0 = np.floor(sx)
    fy = (sy - y0).astype(np.float32)[:, None, None]
    fx = (sx - x0).astype(np.float32)[None, :, None]
    y0 = y0.astype(np.int64)
    x0 = x0.astype(np.int64)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    r0 = img[y0c]
    r1 = img[y1c]
    p00 = r0[:, x0c]
    p01 = r0[:, x1c]
    p10 = r1[:, x0c]
    p11 = r1[:, x1c]
    wy0 = np.float32(1.0) - fy
    wx0 = np.float32(1.0) - fx
    top = p00 * wx0 + p01 * fx
    bot = p10 * wx0 + p11 * fx
    return top * wy0 + bot * fy

