"""InceptionV3 feature extractor for the generative image metrics.

Counterpart of ``metrics_tpu/image/inception_net.py``: the Flax network
carried across to a torch ``nn.Module`` in NCHW, with the same topology
(``inception_net.py:80-212``) and the same feature taps:

* ``64``   — stem features after the first max-pool, globally average-pooled
* ``192``  — stem features after the second max-pool, globally average-pooled
* ``768``  — ``Mixed_6e`` output, globally average-pooled
* ``2048`` — ``Mixed_7c`` output after global average pooling (the FID layer)
* ``logits_unbiased`` — the final linear layer without its bias; its width
  follows the checkpoint (1008 for the TF-compatible FID nets, 1000 for
  torchvision's).

``BasicConv2d`` is a convolution with no bias, a batch norm with eps 1e-3 on
its running statistics, and a ReLU. The max pools are 3x3, stride 2, VALID;
the same-padded 3x3 average pools count the padding, as flax ``avg_pool``
does. The parameter names are torchvision's ``Inception3`` state-dict names,
so a torchvision checkpoint loads with no map (its ``AuxLogits.*`` and
``fc.bias`` are not used). :func:`flax_variables_to_state_dict` carries the
JAX package's Flax variables across (the inverse of its
``torch_state_dict_to_flat``, ``inception_net.py:308-384``; this module keeps
its own copy of the name map).

Pretrained weights are not bundled. The extractor reads them from
``weights_path=`` or ``$METRICS_TPU_INCEPTION_WEIGHTS``, as the JAX package
does (``inception_net.py:45,68-76``): a torch ``state_dict`` file or the JAX
package's flat ``.npz`` export. Without weights it raises unless
``allow_random_weights=True``, which fills the net from a seeded
``torch.Generator`` (He-scaled convolutions, identity batch norms).

The convolutions run in full float32 on the card (cuDNN defaults to TF32),
so the card's features match the CPU's. They are ``F.conv2d`` calls: the JAX
net computes them outside any Pallas kernel.
"""
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metrics_tpu_torch.utilities.data import Tensor, full_fp32, resolve_device

VALID_FEATURE_TAPS = ("logits_unbiased", 64, 192, 768, 2048)

#: feature width of the TF-compat logits tap
_LOGITS_DIM = 1008

_WEIGHTS_ENV_VAR = "METRICS_TPU_INCEPTION_WEIGHTS"


def feature_dim_of(feature: Any, feature_dim: Optional[int] = None) -> int:
    """A ``feature`` argument's output width, to size the fixed-shape
    states (streaming FID moments, KID/IS capacity buffers): int taps name
    their own width, the logits tap is 1008 wide, and a callable must
    declare ``feature_dim=``."""
    if feature_dim is not None:
        return int(feature_dim)
    if isinstance(feature, int):
        return feature
    if feature == "logits_unbiased":
        return _LOGITS_DIM
    raise ValueError(
        "`streaming=True`/`capacity=` needs the feature dimensionality to size"
        " fixed-shape states; pass `feature_dim=` when `feature` is a callable."
    )


def _inception_weights_path() -> Optional[str]:
    path = os.environ.get(_WEIGHTS_ENV_VAR)
    return path if path and os.path.exists(path) else None


def inception_weights_available() -> bool:
    """True when a pretrained-weights file is discoverable for the default extractor."""
    return _inception_weights_path() is not None


class BasicConv2d(nn.Module):
    """Convolution (no bias) + BatchNorm(eps=1e-3, running statistics) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, **conv_kwargs: Any) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, bias=False, **conv_kwargs)
        self.bn = nn.BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.bn(self.conv(x)))


def _max_pool_3x3_s2(x: Tensor) -> Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool_3x3_s1_same(x: Tensor) -> Tensor:
    # the zero padding counts in the mean, as flax ``avg_pool`` counts it
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1_same(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int) -> None:
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1_same(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int) -> None:
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x: Tensor) -> Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avg_pool_3x3_s1_same(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3(nn.Module):
    """The Inception-V3 trunk emitting every feature tap in one forward.

    Input: NCHW float images already normalized to about ``[-1, 1]``.
    Output: dict ``{"64", "192", "768", "2048", "logits_unbiased"} -> (N, d)``.
    """

    def __init__(self, num_logits: int = _LOGITS_DIM) -> None:
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, pool_features=32)
        self.Mixed_5c = InceptionA(256, pool_features=64)
        self.Mixed_5d = InceptionA(288, pool_features=64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, channels_7x7=128)
        self.Mixed_6c = InceptionC(768, channels_7x7=160)
        self.Mixed_6d = InceptionC(768, channels_7x7=160)
        self.Mixed_6e = InceptionC(768, channels_7x7=192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_logits, bias=False)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:
        taps: Dict[str, Tensor] = {}
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        taps["64"] = x.mean(dim=(2, 3))
        x = _max_pool_3x3_s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        taps["192"] = x.mean(dim=(2, 3))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = block(x)
        taps["768"] = x.mean(dim=(2, 3))
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))
        taps["2048"] = pooled
        taps["logits_unbiased"] = self.fc(pooled)
        return taps


def _bilinear_resize(imgs: Tensor, size: int = 299) -> Tensor:
    """Bilinear resize to ``size`` x ``size``, as ``jax.image.resize(...,
    "bilinear")`` does (``inception_net.py:215-218``): half-pixel centres,
    and an antialiasing triangle filter when it shrinks (``antialias=True``
    changes nothing when it grows)."""
    if imgs.shape[2] == size and imgs.shape[3] == size:
        return imgs
    return F.interpolate(imgs, size=(size, size), mode="bilinear", align_corners=False, antialias=True)


class InceptionFeatureExtractor:
    """Callable ``(N, 3, H, W) -> (N, d)`` feature extractor on InceptionV3.

    Frozen (inference-only batch norm), resizes any input to 299x299 and
    normalizes to ``[-1, 1]``: integer images are read as ``[0, 255]`` and
    mapped by ``(x - 128) / 128``, float images as ``[0, 1]`` and mapped by
    ``2x - 1`` (``inception_net.py:273-285``). Returns the requested tap as a
    flat float32 ``(N, d)`` matrix on ``device``.

    Args:
        feature: one of ``64 | 192 | 768 | 2048 | 'logits_unbiased'``.
        weights_path: a torch ``state_dict`` file with torchvision's names, or
            the JAX package's flat ``.npz`` export; defaults to
            ``$METRICS_TPU_INCEPTION_WEIGHTS``.
        allow_random_weights: without weights, fill the net from a
            ``torch.Generator`` seeded by ``rng_seed`` (architecture tests and
            the smoke run) instead of raising.
        net: an :class:`InceptionV3` to share (weights given once for
            several taps); ``weights_path`` and the random fill then do not
            apply.
        device: where the net runs (default ``"cuda"``; raises without a card).
    """

    def __init__(
        self,
        feature: Any = 2048,
        weights_path: Optional[str] = None,
        allow_random_weights: bool = False,
        rng_seed: int = 0,
        net: Optional[InceptionV3] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if feature not in VALID_FEATURE_TAPS:
            raise ValueError(
                f"Integer input to argument `feature` must be one of {VALID_FEATURE_TAPS}, but got {feature}."
            )
        self.feature = feature
        self.device = resolve_device(device)
        if net is None:
            weights_path = weights_path or _inception_weights_path()
            if weights_path is not None:
                state = load_inception_state_dict(weights_path)
                # the checkpoint's fc width decides the logits head
                net = InceptionV3(num_logits=state["fc.weight"].shape[0])
                _load(net, state)
            elif allow_random_weights:
                net = seeded_inception(rng_seed)
            else:
                raise ValueError(
                    "The default InceptionV3 feature extractor needs pretrained weights: pass"
                    f" `weights_path=...`, set ${_WEIGHTS_ENV_VAR}, or supply a custom feature"
                    " extractor callable instead."
                )
        self.net = net.to(self.device).eval().requires_grad_(False)

    def __call__(self, imgs: Tensor) -> Tensor:
        if imgs.is_floating_point():
            imgs = imgs.to(torch.float32) * 2.0 - 1.0
        else:
            imgs = (imgs.to(torch.float32) - 128.0) / 128.0
        imgs = _bilinear_resize(imgs, 299)
        with torch.no_grad(), full_fp32(self.device):
            taps = self.net(imgs)
        return taps[str(self.feature)].reshape(imgs.shape[0], -1)


def seeded_inception(seed: int = 0, num_logits: int = _LOGITS_DIM) -> InceptionV3:
    """An :class:`InceptionV3` filled from a CPU ``torch.Generator`` seeded by
    ``seed``: He-normal convolutions (``std = sqrt(2 / fan_in)``, which keeps
    the activations' scale through the 94 convolutions), identity batch
    norms (scale 1, bias 0, mean 0, variance 1), a LeCun-normal head."""
    gen = torch.Generator().manual_seed(seed)
    net = InceptionV3(num_logits=num_logits)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.weight[0].numel()
                module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
        net.fc.weight.copy_(torch.randn(net.fc.weight.shape, generator=gen) * (1.0 / net.fc.in_features) ** 0.5)
    return net.eval()


def _load(net: InceptionV3, state: Dict[str, Tensor]) -> None:
    """Load ``state`` (torchvision names); keys the trunk lacks (``AuxLogits.*``,
    ``fc.bias``) are ignored, a key it needs and does not find raises."""
    missing, _unexpected = net.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint is missing {len(missing)} expected keys, e.g. {missing[:3]}")


def load_inception_state_dict(path: str) -> Dict[str, Tensor]:
    """The torchvision-named state dict in ``path``: a torch ``state_dict``
    file, or the JAX package's flat ``.npz`` export (carried across by
    :func:`flax_variables_to_state_dict`)."""
    if path.endswith(".npz"):
        with np.load(path) as flat:
            return flax_variables_to_state_dict(_unflatten_params(dict(flat)))
    return torch.load(path, map_location="cpu", weights_only=True)


def _unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The nested ``{'params': ..., 'batch_stats': ...}`` tree from
    ``/``-joined keys (the ``.npz`` export format)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def flax_variables_to_state_dict(variables: Dict[str, Any]) -> Dict[str, Tensor]:
    """The JAX package's Flax InceptionV3 variables (numpy ``params`` and
    ``batch_stats``) as this module's torchvision-named state dict:
    convolution kernels HWIO -> OIHW, the Dense kernel transposed,
    BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and ``mean``/``var``
    -> ``running_mean``/``running_var``. Raises ``KeyError`` listing the
    missing variables if any."""
    state: Dict[str, Tensor] = {}
    missing = []
    for flax_key, torch_key in _torchvision_name_map().items():
        node: Any = variables
        for part in flax_key.split("/"):
            node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                break
        if node is None:
            missing.append(flax_key)
            continue
        array = np.array(node, dtype=np.float32)  # a writable copy
        if flax_key.endswith("Conv_0/kernel"):
            array = array.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif flax_key.endswith("Dense_0/kernel"):
            array = array.transpose(1, 0)
        state[torch_key] = torch.from_numpy(np.ascontiguousarray(array))
    if missing:
        raise KeyError(f"variables are missing {len(missing)} expected entries, e.g. {missing[:3]}")
    return state


_BRANCHES_A = ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3",
               "branch_pool"]
_BRANCHES_C = ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1", "branch7x7dbl_2",
               "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"]
_BRANCHES_E = ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1", "branch3x3dbl_2",
               "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"]


def _module_paths() -> Sequence[Tuple[str, str]]:
    """(Flax submodule path, torchvision module name) of every BasicConv2d,
    in the Flax net's creation order (``inception_net.py:363-384``)."""
    pairs = [
        ("BasicConv2d_0", "Conv2d_1a_3x3"),
        ("BasicConv2d_1", "Conv2d_2a_3x3"),
        ("BasicConv2d_2", "Conv2d_2b_3x3"),
        ("BasicConv2d_3", "Conv2d_3b_1x1"),
        ("BasicConv2d_4", "Conv2d_4a_3x3"),
    ]
    blocks = [
        ("InceptionA_0", "Mixed_5b", _BRANCHES_A),
        ("InceptionA_1", "Mixed_5c", _BRANCHES_A),
        ("InceptionA_2", "Mixed_5d", _BRANCHES_A),
        ("InceptionB_0", "Mixed_6a", ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]),
        ("InceptionC_0", "Mixed_6b", _BRANCHES_C),
        ("InceptionC_1", "Mixed_6c", _BRANCHES_C),
        ("InceptionC_2", "Mixed_6d", _BRANCHES_C),
        ("InceptionC_3", "Mixed_6e", _BRANCHES_C),
        ("InceptionD_0", "Mixed_7a", ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                                      "branch7x7x3_3", "branch7x7x3_4"]),
        ("InceptionE_0", "Mixed_7b", _BRANCHES_E),
        ("InceptionE_1", "Mixed_7c", _BRANCHES_E),
    ]
    for flax_mod, torch_mod, branches in blocks:
        for i, branch in enumerate(branches):
            pairs.append((f"{flax_mod}/BasicConv2d_{i}", f"{torch_mod}.{branch}"))
    return pairs


def _torchvision_name_map() -> Dict[str, str]:
    """Flax flat variable key -> torchvision ``Inception3`` state-dict key."""
    mapping: Dict[str, str] = {}
    for flax_mod, torch_mod in _module_paths():
        mapping[f"params/{flax_mod}/Conv_0/kernel"] = f"{torch_mod}.conv.weight"
        mapping[f"params/{flax_mod}/BatchNorm_0/scale"] = f"{torch_mod}.bn.weight"
        mapping[f"params/{flax_mod}/BatchNorm_0/bias"] = f"{torch_mod}.bn.bias"
        mapping[f"batch_stats/{flax_mod}/BatchNorm_0/mean"] = f"{torch_mod}.bn.running_mean"
        mapping[f"batch_stats/{flax_mod}/BatchNorm_0/var"] = f"{torch_mod}.bn.running_var"
    mapping["params/Dense_0/kernel"] = "fc.weight"
    return mapping


def resolve_feature_extractor(
    feature: Any, allow_random_weights: bool = False, device: Union[str, torch.device] = "cuda"
) -> Callable:
    """The metric's ``feature`` argument as an ``(N,3,H,W) -> (N,d)`` callable:
    an int/str selects an InceptionV3 tap on ``device`` (raising without
    pretrained weights), a callable is used as it is."""
    if isinstance(feature, (int, str)):
        return InceptionFeatureExtractor(feature, allow_random_weights=allow_random_weights, device=device)
    if callable(feature):
        return feature
    raise TypeError("Got unknown input to argument `feature`")
