"""AI background removal (BiRefNet / U2-Net / IS-Net via ONNX Runtime).

Behavioral contract: src/ops/ai.rs — the reference dlopens onnxruntime and
drives a hand-rolled OrtApi vtable (:178-447) to run saliency models whose
mask becomes the layer's alpha (README.md:106-112).  Here onnxruntime is an
optional Python dependency; absent, a clear gated error explains what to
install.  Pre/post-processing matches the standard recipes for these models
(resize to the model's square input, ImageNet-ish normalization, sigmoid
mask back-scaled and min-max normalized, applied to alpha).

The session is injectable (any object with `run` and `get_inputs`), so the
numeric pipeline runs under CI with a fake session where onnxruntime isn't
installed — mirroring how ai.rs keeps its whole OrtApi surface exercised.

The port's copy of paintfe_tpu/ops/ai.py.  Where the work runs: the PIL
resizes, the sigmoid and the min-max stay host numpy, the JAX package's
own calls (ROADMAP C2: a per-pixel exp of continuous values), so the same
host gives its bytes; the normalisation, the mask's divide by 255 and the
alpha step run on the image's device, every divide a true f32 divide.  The
session takes and returns numpy: the normalised input is downloaded once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from paintfe_tpu_torch.ops.common import as_image
from paintfe_tpu_torch.utils.quant import ieee_div

f32 = np.float32


class AiUnavailable(Exception):
    pass


_MODEL_INPUT_SIZES = {
    "birefnet": 1024,
    "u2net": 320,
    "isnet": 1024,
}


def _require_ort():
    try:
        import onnxruntime  # noqa: F401

        return onnxruntime
    except ImportError as e:
        raise AiUnavailable(
            "background removal needs the onnxruntime package (the reference "
            "dlopens libonnxruntime the same way); install onnxruntime and "
            "provide a BiRefNet/U2-Net/IS-Net .onnx model file"
        ) from e


@dataclasses.dataclass
class BackgroundRemover:
    """Saliency-mask background removal on `device` (the card unless the
    caller passes "cpu"; CUDA with no card raises).

    `session` accepts any onnxruntime-InferenceSession-compatible object
    (`get_inputs() -> [obj with .name]`, `run(None, feeds) -> [array]`);
    when None, a real onnxruntime session is constructed from
    `model_path` (raising AiUnavailable if onnxruntime is missing).
    """

    model_path: str = ""
    model_kind: str = "u2net"  # birefnet | u2net | isnet
    session: Optional[Any] = None
    device: Any = "cuda"

    def __post_init__(self):
        from paintfe_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(self.device)
        if self.session is None:
            ort = _require_ort()
            self.session = ort.InferenceSession(
                self.model_path, providers=["CPUExecutionProvider"]
            )
        self.input_name = self.session.get_inputs()[0].name
        self.size = _MODEL_INPUT_SIZES.get(self.model_kind, 320)

    def preprocess(self, img) -> torch.Tensor:
        """RGBA u8 [H, W, 4] (a tensor, or numpy moved to the remover's
        device) -> normalized NCHW f32 [1, 3, S, S] on the image's
        device."""
        x = as_image(img, self.device)
        return _normalize(_resize_rgb(x, self.size), x.device)

    def postprocess(self, out: np.ndarray, h: int, w: int, device=None) -> torch.Tensor:
        """Raw model output -> f32 saliency mask [H, W] in [0, 1] on
        `device` (the remover's by default): sigmoid when the output is in
        logit range, min-max normalize, resize back to the source size (on
        the host); the divide by 255 on the device."""
        return _unit_mask(_mask_u8(out, h, w), self.device if device is None else device)

    def infer_mask(self, img) -> torch.Tensor:
        """RGBA u8 [H, W, 4] -> f32 saliency mask [H, W] in [0, 1] on the
        image's device; the session gets the normalised input as one numpy
        array, downloaded once."""
        x = as_image(img, self.device)
        h, w = x.shape[:2]
        feed = self.preprocess(x).cpu().numpy()
        out = self.session.run(None, {self.input_name: feed})[0]
        return self.postprocess(out, h, w, x.device)

    def remove_background(self, img, threshold: Optional[float] = None) -> torch.Tensor:
        """Multiply the alpha channel by the saliency mask; a u8 tensor on
        the image's device."""
        x = as_image(img, self.device)
        return _apply_mask(x, self.infer_mask(x), threshold)


# The steps, each on one side: the host's (_resize_rgb, _mask_u8) and the
# device's (_normalize, _unit_mask, _apply_mask).


def _resize_rgb(img: torch.Tensor, size: int) -> np.ndarray:
    """The RGB of u8 [H, W, 4], downloaded once and resized by PIL to u8
    [S, S, 3] (bilinear, PIL's bytes)."""
    from PIL import Image

    rgb = np.ascontiguousarray(img[..., 0:3].cpu().numpy())
    return np.array(Image.fromarray(rgb, "RGB").resize((size, size), Image.BILINEAR))


def _normalize(rgb: np.ndarray, device) -> torch.Tensor:
    """u8 [S, S, 3] -> NCHW f32 [1, 3, S, S] on `device`: `/ 255`, then
    `(x - mean) / std`, each a true f32 divide."""
    s = ieee_div(torch.from_numpy(rgb).to(device).float(), 255.0)
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32, device=device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32, device=device)
    s = (s - mean) / std  # a divisor tensor on the device: a true divide
    return s.permute(2, 0, 1)[None].contiguous()


def _mask_u8(out: np.ndarray, h: int, w: int) -> np.ndarray:
    """Raw model output -> u8 mask [H, W] on the host, the JAX package's
    numpy: sigmoid when in logit range, min-max, truncation to u8, PIL's
    bilinear resize to the source size."""
    from PIL import Image

    mask = np.asarray(out).reshape(out.shape[-2], out.shape[-1]).astype(f32)
    if mask.min() < 0 or mask.max() > 1:
        mask = 1.0 / (1.0 + np.exp(-mask))
    lo, hi = float(mask.min()), float(mask.max())
    if hi > lo:
        mask = (mask - lo) / (hi - lo)
    back = Image.fromarray((mask * 255).astype(np.uint8), "L").resize(
        (w, h), Image.BILINEAR
    )
    return np.array(back)


def _unit_mask(mask: np.ndarray, device) -> torch.Tensor:
    """u8 mask [H, W] -> f32 [H, W] in [0, 1] on `device` (a true divide)."""
    return ieee_div(torch.from_numpy(mask).to(device).float(), 255.0)


def _apply_mask(img: torch.Tensor, mask: torch.Tensor,
                threshold: Optional[float] = None) -> torch.Tensor:
    """u8 [H, W, 4] with its alpha multiplied by the f32 mask [H, W] (or by
    `mask >= threshold`), rounded half up and clamped, on the image's
    device."""
    if threshold is not None:
        mask = (mask >= threshold).float()
    a = img[..., 3].float() * mask
    out = img.clone()
    out[..., 3] = torch.clamp(torch.floor(a + 0.5), 0.0, 255.0).to(torch.uint8)
    return out


def available() -> bool:
    try:
        _require_ort()
        return True
    except AiUnavailable:
        return False
