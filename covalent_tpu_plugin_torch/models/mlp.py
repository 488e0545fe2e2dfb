"""MNIST-class models (BASELINE configs 3-4) and synthetic data.

Counterpart of ``covalent_tpu_plugin/models/mlp.py``.  The data is
generated, not downloaded; ``synthetic_mnist`` is a numpy-only copy of the
reference's, so both packages see byte-identical batches from one seed.

Inputs are NHWC ``(B, 28, 28, 1)`` as in the reference.  The layers are
PyTorch's (``nn.Linear`` ``(out, in)`` weights, ``nn.Conv2d`` on NCHW with
OIHW weights); ``models/convert.py`` turns the reference's Flax params into
their state dicts.  Initialisation follows Flax's defaults (LeCun normal
kernels, zero biases) from an explicit ``torch.Generator``; parity with the
reference comes from converted weights, not from matching its RNG.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .transformer import resolve_device

#: Standard deviation of a unit normal truncated to [-2, 2]: Flax's
#: ``lecun_normal`` divides by it so the truncated draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def _dense(in_features: int, out_features: int, device, generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, device=device)
    with torch.no_grad():
        _lecun_normal_(layer.weight, in_features, generator)
        layer.bias.zero_()
    return layer


def _conv(in_channels: int, out_channels: int, device, generator) -> nn.Conv2d:
    # Flax Conv defaults to padding="SAME": at 3x3 stride 1 that is 1 a side.
    layer = nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device)
    with torch.no_grad():
        _lecun_normal_(layer.weight, in_channels * 9, generator)
        layer.bias.zero_()
    return layer


def _check_width(x: torch.Tensor, layer: nn.Linear, name: str) -> None:
    """The reference refuses an input whose width differs from the one its
    params were made for (Flax's ``ScopeParamShapeError``)."""
    if x.shape[-1] != layer.in_features:
        raise ValueError(
            f'For parameter "weight" in "{name}", the input has {x.shape[-1]} '
            f"features, but the layer was made for {layer.in_features}"
        )


class MLP(nn.Module):
    """Flatten, ReLU dense layers of ``features``, then the logits: the north
    star's "MLP on MNIST" electron body.  Takes ``(B, 28, 28, 1)`` or flat
    ``(B, in_features)`` input."""

    def __init__(self, features: tuple[int, ...] = (256, 128), num_classes: int = 10,
                 in_features: int = 28 * 28, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        widths = (in_features, *features)
        self.hidden = nn.ModuleList(
            _dense(i, o, device, generator) for i, o in zip(widths[:-1], widths[1:])
        )
        self.head = _dense(widths[-1], num_classes, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        first, name = (self.hidden[0], "hidden.0") if len(self.hidden) else (self.head, "head")
        _check_width(x, first, name)
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.head(x)


class MnistCNN(nn.Module):
    """conv 32 3x3, ReLU, avg-pool 2/2, conv 64 3x3, ReLU, avg-pool 2/2,
    flatten, dense 256, ReLU, dense ``num_classes`` (BASELINE config 4).

    Takes NHWC ``(B, 28, 28, 1)``.  The convolutions run NCHW; the feature
    map is permuted back to channels-last before the flatten, so ``fc``'s
    input rows are in the reference's NHWC order and its converted kernel is
    a plain transpose.
    """

    def __init__(self, num_classes: int = 10, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = _conv(1, 32, device, generator)
        self.conv2 = _conv(32, 64, device, generator)
        self.fc = _dense(7 * 7 * 64, 256, device, generator)
        self.head = _dense(256, num_classes, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != self.conv1.in_channels:
            raise ValueError(
                f'For parameter "weight" in "conv1", the input has shape '
                f"{tuple(x.shape)}, but the layer takes NHWC input with "
                f"{self.conv1.in_channels} channel(s)"
            )
        x = x.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.conv1(x)), 2)  # VALID, as nn.avg_pool
        x = F.avg_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        _check_width(x, self.fc, "fc")
        return self.head(F.relu(self.fc(x)))


def synthetic_mnist(
    batch_size: int, *, seed: int = 0, flat: bool = False
) -> dict[str, np.ndarray]:
    """Class-conditional 28x28 images: each class is a distinct low-frequency
    template plus noise, so small models separate them quickly."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=(batch_size,))
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 28.0
    templates = np.stack(
        [
            np.sin(2 * np.pi * (xx * (1 + c % 5) + yy * (1 + c // 5)) + c)
            for c in range(10)
        ]
    )
    images = templates[labels] + 0.3 * rng.standard_normal((batch_size, 28, 28)).astype(
        np.float32
    )
    images = images.astype(np.float32)[..., None]  # NHWC
    if flat:
        images = images.reshape(batch_size, -1)
    return {"image": images, "label": labels.astype(np.int32)}
