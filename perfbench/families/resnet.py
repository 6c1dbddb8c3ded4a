"""The program's ResNet for a ``resnet`` configuration: the port's
``models/resnet.py::ResNet`` at the configuration's widths, with the
benchmark's weights loaded."""

from __future__ import annotations

import torch


def build_model(cfg: dict, traffic: dict, weights: dict, device) -> torch.nn.Module:
    """The port's model, allocated on ``device`` without an initialisation
    of its own and holding a copy of ``weights``.

    Raises:
        ValueError: If the configuration asks for a stem the port's ResNet
            does not build (it builds a 7x7 stride-2 stem).
    """
    from curvlinops_tpu_torch.models.resnet import ResNet

    if (cfg["stem_kernel"], cfg["stem_stride"], cfg["block"]) != (7, 2, "basic"):
        raise ValueError("the port's ResNet builds a 7x7/s2 stem and basic blocks here")
    with torch.device("meta"):
        model = ResNet("basic", tuple(cfg["layers"]), tuple(cfg["widths"]),
                       cfg["num_classes"], stem_width=cfg["stem_width"])
    model = model.to_empty(device=device).to(getattr(torch, cfg["dtype"]))
    model.load_state_dict(weights)
    return model
