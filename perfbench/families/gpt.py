"""The program's GPT for a ``gpt`` configuration: the port's unrolled
``models/gpt.py::GPT`` at the configuration's widths, with the attention
implementation the traffic mix names and the benchmark's weights loaded."""

from __future__ import annotations

import torch


def build_model(cfg: dict, traffic: dict, weights: dict, device) -> torch.nn.Module:
    """The port's model, allocated on ``device`` without an initialisation
    of its own and holding a copy of ``weights``.

    Raises:
        ValueError: If the configuration ties the head to the token table
            (the port's GPT has no weight tying).
    """
    from curvlinops_tpu_torch.models.gpt import GPT, GPTConfig

    if cfg.get("tie_word_embeddings"):
        raise ValueError("the port's GPT has no weight tying: set tie_word_embeddings false")

    config = GPTConfig(
        block_size=cfg["block_size"], vocab_size=cfg["vocab_size"], n_layer=cfg["n_layer"],
        n_head=cfg["n_head"], n_embd=cfg["n_embd"],
        attention_impl=traffic.get("attention_impl", "einsum"),
    )
    with torch.device("meta"):
        model = GPT(config)
    model = model.to_empty(device=device).to(getattr(torch, cfg["dtype"]))
    model.load_state_dict(weights)
    return model
