"""Vision transforms — the counterpart of ``paddle_tpu/vision/transforms.py``
(reference: ``python/paddle/vision/transforms/``).

Host-side numpy preprocessing of HWC uint8 or float images, run in the
DataLoader's workers; the random transforms draw from Python's ``random``
in the reference's order. ``Resize`` is ``jax.image.resize``'s linear
method, as the JAX package calls it: antialiased when it shrinks (a
triangle kernel widened by the scale, weights normalised per output
pixel; ``nn.functional.linear_resize_weights``), computed in float32 and
cast back to the input's type (truncating, for uint8).
"""
from __future__ import annotations

import numbers
import random

import numpy as np

from ..nn.functional import linear_resize_weights


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] -> CHW float32 [0,1] numpy (Tensor conversion happens
    at collate)."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = np.transpose(arr, (2, 0, 1))
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            return (img - self.mean[:, None, None]) / self.std[:, None, None]
        return (img - self.mean) / self.std


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = self.size
        chw = img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[2] not in (1, 3)
        if chw:
            out_shape = (img.shape[0], h, w)
        elif img.ndim == 3:
            out_shape = (h, w, img.shape[2])
        else:
            out_shape = (h, w)
        return _resize_linear(img.astype(np.float32),
                              out_shape).astype(img.dtype)


def _resize_linear(img, out_shape):
    """Each dim whose size changes, contracted in float32 with its
    ``linear_resize_weights`` matrix."""
    out = img
    for ax, (n, m) in enumerate(zip(img.shape, out_shape)):
        if n != m:
            out = np.moveaxis(np.tensordot(out, linear_resize_weights(n, m),
                                           axes=([ax], [0])), -1, ax)
    return out


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = np.asarray(img)
        hwc = not (img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[2] not in (1, 3))
        H, W = (img.shape[0], img.shape[1]) if hwc else (img.shape[1], img.shape[2])
        th, tw = self.size
        i = max((H - th) // 2, 0)
        j = max((W - tw) // 2, 0)
        if hwc:
            return img[i:i + th, j:j + tw]
        return img[:, i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        img = np.asarray(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, int) else self.padding[0]
            pads = [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pads)
        H, W = img.shape[0], img.shape[1]
        th, tw = self.size
        i = random.randint(0, max(H - th, 0))
        j = random.randint(0, max(W - tw, 0))
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            img = np.asarray(img)
            return img[:, ::-1].copy() if img.ndim >= 2 else img
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            img = np.asarray(img)
            return img[::-1].copy()
        return np.asarray(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        img = np.asarray(img)
        H, W = img.shape[0], img.shape[1]
        area = H * W
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            w = int(round(np.sqrt(target * ar)))
            h = int(round(np.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                i = random.randint(0, H - h)
                j = random.randint(0, W - w)
                return self._resize(img[i:i + h, j:j + w])
        return self._resize(CenterCrop(min(H, W))(img))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        return np.transpose(np.asarray(img), self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        factor = 1.0 + random.uniform(-self.value, self.value)
        return np.clip(np.asarray(img, np.float32) * factor, 0,
                       255 if np.asarray(img).dtype == np.uint8 else None)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


# ---------------------------------------------------------- r4 parity batch
# (reference: remaining python/paddle/vision/transforms/transforms.py †;
# all HWC-numpy host-side like the rest of this module)
def _as_float(img):
    a = np.asarray(img)
    return a.astype(np.float32), a.dtype


def _clip_back(out, dtype):
    if dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return out


def adjust_brightness(img, brightness_factor):
    a, dt = _as_float(img)
    return _clip_back(a * brightness_factor, dt)


def adjust_contrast(img, contrast_factor):
    a, dt = _as_float(img)
    mean = _rgb_to_gray(a).mean()
    return _clip_back((a - mean) * contrast_factor + mean, dt)


def adjust_saturation(img, saturation_factor):
    a, dt = _as_float(img)
    gray = _rgb_to_gray(a)[..., None]
    return _clip_back(gray + (a - gray) * saturation_factor, dt)


def _rgb_to_gray(a):
    if a.ndim == 2:
        return a
    return (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])


def adjust_hue(img, hue_factor):
    """Rotate hue by hue_factor (in [-0.5, 0.5] turns) via HSV roundtrip."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    a, dt = _as_float(img)
    scale = 255.0 if dt == np.uint8 else 1.0
    x = a / scale
    mx, mn = x.max(-1), x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == r, ((g - b) / diff) % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    v = mx
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return _clip_back(out * scale, dt)


def to_grayscale(img, num_output_channels=1):
    a, dt = _as_float(img)
    gray = _rgb_to_gray(a)
    out = np.repeat(gray[..., None], num_output_channels, axis=-1)
    return _clip_back(out, dt)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate counter-clockwise by `angle` degrees about the center
    (inverse-map nearest/bilinear sampling, constant fill). ``expand``
    enlarges the canvas to hold the whole rotated image (PIL contract)."""
    a, dt = _as_float(img)
    h, w = a.shape[:2]
    theta = np.deg2rad(angle)
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    c, s = np.cos(theta), np.sin(theta)
    if expand:
        # epsilon before ceil: cos(90deg) is ~6e-17, not 0, and without it
        # a right-angle rotation grows the canvas by a phantom pixel
        oh = int(np.ceil(abs(h * c) + abs(w * s) - 1e-9))
        ow = int(np.ceil(abs(w * c) + abs(h * s) - 1e-9))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    # inverse rotation of output coords into the source image
    sx = (xx - ocx) * c - (yy - ocy) * s + cx
    sy = (xx - ocx) * s + (yy - ocy) * c + cy
    if interpolation == "bilinear":
        x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
        wx, wy = sx - x0, sy - y0

        def fetch(xi, yi):
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            v = a[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            m = inside if a.ndim == 2 else inside[..., None]
            return np.where(m, v, fill)

        out = (fetch(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
               + fetch(x0 + 1, y0) * (wx * (1 - wy))[..., None]
               + fetch(x0, y0 + 1) * ((1 - wx) * wy)[..., None]
               + fetch(x0 + 1, y0 + 1) * (wx * wy)[..., None]) \
            if a.ndim == 3 else \
            (fetch(x0, y0) * (1 - wx) * (1 - wy)
             + fetch(x0 + 1, y0) * wx * (1 - wy)
             + fetch(x0, y0 + 1) * (1 - wx) * wy
             + fetch(x0 + 1, y0 + 1) * wx * wy)
    else:
        xi, yi = np.round(sx).astype(int), np.round(sy).astype(int)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = a[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        m = inside if a.ndim == 2 else inside[..., None]
        out = np.where(m, v, fill)
    return _clip_back(out, dt)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return adjust_contrast(img, 1.0 + random.uniform(-self.value,
                                                         self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return adjust_saturation(img, 1.0 + random.uniform(-self.value,
                                                           self.value))


class HueTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        return adjust_hue(img, random.uniform(-self.value, self.value))


class AdjustBrightness(BaseTransform):
    def __init__(self, brightness_factor):
        self.brightness_factor = brightness_factor

    def _apply_image(self, img):
        return adjust_brightness(img, self.brightness_factor)


class AdjustContrast(BaseTransform):
    def __init__(self, contrast_factor):
        self.contrast_factor = contrast_factor

    def _apply_image(self, img):
        return adjust_contrast(img, self.contrast_factor)


class AdjustHue(BaseTransform):
    def __init__(self, hue_factor):
        self.hue_factor = hue_factor

    def _apply_image(self, img):
        return adjust_hue(img, self.hue_factor)


class ColorJitter(BaseTransform):
    """Random brightness/contrast/saturation/hue in random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _range(value, center=1.0, lo_floor=0.0):
        """number v -> (max(floor, center-v), center+v); (lo, hi) passes
        through (the reference accepts both forms)."""
        if isinstance(value, (list, tuple)):
            return (float(value[0]), float(value[1]))
        return (max(lo_floor, center - value), center + value)

    def _apply_image(self, img):
        ops = []
        if self.brightness:
            f = random.uniform(*self._range(self.brightness))
            ops.append(lambda im, f=f: adjust_brightness(im, f))
        if self.contrast:
            f = random.uniform(*self._range(self.contrast))
            ops.append(lambda im, f=f: adjust_contrast(im, f))
        if self.saturation:
            f = random.uniform(*self._range(self.saturation))
            ops.append(lambda im, f=f: adjust_saturation(im, f))
        if self.hue:
            f = random.uniform(*self._range(self.hue, center=0.0,
                                            lo_floor=-0.5))
            ops.append(lambda im, f=f: adjust_hue(im, f))
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        if isinstance(padding, numbers.Number):
            padding = (padding,) * 4
        elif len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding  # (left, top, right, bottom)
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        a = np.asarray(img)
        l, t, r, b = self.padding
        pad_width = [(t, b), (l, r)] + [(0, 0)] * (a.ndim - 2)
        if self.padding_mode == "constant":
            return np.pad(a, pad_width, mode="constant",
                          constant_values=self.fill)
        mode = {"edge": "edge", "reflect": "reflect",
                "symmetric": "symmetric"}[self.padding_mode]
        return np.pad(a, pad_width, mode=mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, self.interpolation, expand=self.expand,
                      center=self.center, fill=self.fill)


class RandomErasing(BaseTransform):
    """Erase a random rectangle (reference RandomErasing: area scale,
    aspect ratio, constant or random fill)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        a = np.array(img, copy=True)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            eh, ew = int(round(np.sqrt(target * ar))), \
                int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                y = random.randint(0, h - eh)
                x = random.randint(0, w - ew)
                if self.value == "random":
                    a[y:y + eh, x:x + ew] = np.random.rand(
                        eh, ew, *a.shape[2:]) * (
                        255 if a.dtype == np.uint8 else 1.0)
                else:
                    a[y:y + eh, x:x + ew] = self.value
                return a
        return a


class GaussianBlur(BaseTransform):
    def __init__(self, kernel_size=3, sigma=(0.1, 2.0)):
        self.kernel_size = (kernel_size, kernel_size) \
            if isinstance(kernel_size, numbers.Number) else tuple(kernel_size)
        for k in self.kernel_size:  # even taps would shift by half a pixel
            if k <= 0 or k % 2 == 0:
                raise ValueError(
                    f"GaussianBlur kernel_size must be positive odd, got "
                    f"{self.kernel_size}")
        self.sigma = (sigma, sigma) if isinstance(sigma, numbers.Number) \
            else tuple(sigma)

    def _apply_image(self, img):
        a, dt = _as_float(img)
        sigma = random.uniform(*self.sigma)

        def kernel1d(k):
            r = np.arange(k) - (k - 1) / 2.0
            g = np.exp(-(r ** 2) / (2 * sigma ** 2))
            return g / g.sum()

        kh, kw = self.kernel_size
        gy, gx = kernel1d(kh), kernel1d(kw)
        # separable blur with edge padding (torch/paddle use reflect; edge
        # is visually equivalent at these kernel sizes)
        ph, pw = kh // 2, kw // 2
        pad_width = [(ph, ph), (0, 0)] + [(0, 0)] * (a.ndim - 2)
        out = np.pad(a, pad_width, mode="reflect")
        out = sum(gy[i] * out[i:i + a.shape[0]] for i in range(kh))
        pad_width = [(0, 0), (pw, pw)] + [(0, 0)] * (a.ndim - 2)
        out = np.pad(out, pad_width, mode="reflect")
        out = sum(gx[j] * out[:, j:j + a.shape[1]] for j in range(kw))
        return _clip_back(out, dt)
