"""Plain PyTorch reference of the GPT configurations (GPT-2 small as
nanoGPT's ``model.py`` sets it out), written from the configuration file
alone.

Learned token and position embeddings, ``n_layer`` pre-norm blocks (a
LayerNorm, causal multi-head self-attention through one fused ``qkv``
projection and an output projection, a residual; a LayerNorm, a ``4 C`` MLP
with tanh-approximated GELU, a residual), a final LayerNorm and an untied
linear head without bias. Logits come out flattened to ``[B * T, vocab]``.
Attention is the textbook softmax of masked scores in float32.

Parameter names are the ones the benchmark uses on both sides
(``h3.attn_qkv.weight``, ``ln_f.scale``, ``wte.weight``). Nothing here
imports the program; only ``torch``.
"""

from __future__ import annotations

import math

import torch

LN_EPS = 1e-5
DENSE = ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")


def dense_shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    """``(out, in)`` of each dense layer of a block."""
    C = cfg["n_embd"]
    return {"attn_qkv": (3 * C, C), "attn_proj": (C, C), "mlp_fc": (4 * C, C),
            "mlp_proj": (C, 4 * C)}


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """Every parameter's name and shape."""
    C, V = cfg["n_embd"], cfg["vocab_size"]
    shapes = {"wte.weight": (V, C), "wpe.weight": (cfg["block_size"], C)}
    for i in range(cfg["n_layer"]):
        for ln in ("ln1", "ln2"):
            shapes[f"h{i}.{ln}.scale"] = (C,)
            shapes[f"h{i}.{ln}.bias"] = (C,)
        for name, (o, n_in) in dense_shapes(cfg).items():
            shapes[f"h{i}.{name}.weight"] = (o, n_in)
            shapes[f"h{i}.{name}.bias"] = (o,)
    shapes["ln_f.scale"] = (C,)
    shapes["ln_f.bias"] = (C,)
    shapes["lm_head.weight"] = (V, C)
    return shapes


def kfac_layers(cfg: dict) -> list[tuple[str, str | None]]:
    """``(weight, bias)`` of each layer KFAC covers: the four dense layers
    of every block (the embeddings, norms and the head are left out)."""
    return [(f"h{i}.{name}.weight", f"h{i}.{name}.bias")
            for i in range(cfg["n_layer"]) for name in DENSE]


def kfac_shapes(cfg: dict) -> list[dict]:
    """Each layer :func:`kfac_layers` names as ``perfbench/work.py`` counts
    it: its rows (every token), input width, output width and its bias."""
    rows, shapes = cfg["batch_size"] * cfg["block_size"], dense_shapes(cfg)
    return [dict(rows=rows, d_in=shapes[n][1], d_out=shapes[n][0], bias=True)
            for _ in range(cfg["n_layer"]) for n in DENSE]


def forward_flops(cfg: dict) -> float:
    """One forward pass of a batch: the dense layers, ``q k^T`` and ``P v``
    over the causal pairs (``T (T + 1) / 2`` a head, ``hd`` each), and the
    head, two operations a multiply-add."""
    B, T, C = cfg["batch_size"], cfg["block_size"], cfg["n_embd"]
    dense = sum(2 * layer["rows"] * layer["d_in"] * layer["d_out"] for layer in kfac_shapes(cfg))
    attention = cfg["n_layer"] * 2 * 2 * B * C * T * (T + 1) / 2
    head = 2 * B * T * C * cfg["vocab_size"]
    return dense + attention + head


def attention_shape(cfg: dict) -> tuple[int, int, int, int]:
    """``[B, H, T, hd]`` of every attention call."""
    return (cfg["batch_size"], cfg["n_head"], cfg["block_size"], cfg["n_embd"] // cfg["n_head"])


def init_weights(cfg: dict, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """GPT-2's initialisation, drawn in one call on ``device``: every
    matrix normal with standard deviation 0.02 (0.02 / sqrt(2 n_layer) for
    the residual projections ``attn_proj`` and ``mlp_proj``), position table
    0.01; small normal biases and norm offsets (standard deviation 0.02) and
    norm scales 1 + N(0, 0.02^2), so that no bias or norm sits at an exact
    constant."""
    shapes = param_shapes(cfg)
    dtype = getattr(torch, cfg["dtype"])
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=generator,
                       dtype=dtype, device=device)
    resid = 0.02 / math.sqrt(2 * cfg["n_layer"])
    out, at = {}, 0
    for n, shape in shapes.items():
        size = math.prod(shape)
        t = flat[at:at + size].view(shape)
        at += size
        if n == "wpe.weight":
            t.mul_(0.01)
        elif n.endswith(("attn_proj.weight", "mlp_proj.weight")):
            t.mul_(resid)
        else:
            t.mul_(0.02)
        if n.endswith(".scale"):
            t.add_(1.0)
        out[n] = t
    return out


def make_batches(cfg: dict, generator: torch.Generator, count: int, device) -> list[tuple]:
    """``count`` batches of uniform random tokens: inputs ``[B, T]`` and the
    next tokens ``[B * T]`` as targets."""
    B, T = cfg["batch_size"], cfg["block_size"]
    tokens = torch.randint(0, cfg["vocab_size"], (count, B, T + 1), generator=generator,
                           device=device)
    return [(tokens[i, :, :T], tokens[i, :, 1:].reshape(-1)) for i in range(count)]


def layer_norm(x, scale, bias):
    """LayerNorm over the last axis with the biased variance."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * scale + bias


def gelu_tanh(x):
    """GELU, tanh approximation (GPT-2's)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def forward(params: dict, tokens: torch.Tensor, cfg: dict,
            taps: dict | None = None) -> torch.Tensor:
    """Logits ``[B * T, vocab]``. ``taps`` (if given) receives each dense
    layer's ``(input, output)`` under its weight's name."""
    B, T = tokens.shape
    C, H = cfg["n_embd"], cfg["n_head"]
    hd = C // H
    x = params["wte.weight"][tokens] + params["wpe.weight"][:T][None]
    mask = torch.ones((T, T), dtype=torch.bool, device=tokens.device).tril()

    def dense(prefix, h):
        out = h @ params[f"{prefix}.weight"].T + params[f"{prefix}.bias"]
        if taps is not None:
            taps[f"{prefix}.weight"] = (h, out)
        return out

    for i in range(cfg["n_layer"]):
        p = f"h{i}"
        h = layer_norm(x, params[f"{p}.ln1.scale"], params[f"{p}.ln1.bias"])
        qkv = dense(f"{p}.attn_qkv", h)
        q, k, v = (t.reshape(B, T, H, hd).transpose(1, 2) for t in qkv.split(C, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~mask, float("-inf"))
        att = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, T, C)
        x = x + dense(f"{p}.attn_proj", att)
        h = dense(f"{p}.mlp_fc", layer_norm(x, params[f"{p}.ln2.scale"], params[f"{p}.ln2.bias"]))
        x = x + dense(f"{p}.mlp_proj", gelu_tanh(h))
    x = layer_norm(x, params["ln_f.scale"], params["ln_f.bias"])
    return (x @ params["lm_head.weight"].T).reshape(B * T, -1)


def layer_rows(name: str, x: torch.Tensor, out_grad: torch.Tensor, cfg: dict) -> tuple:
    """A dense layer's input rows ``a`` and output-gradient rows ``g`` (one
    row per token), and the positions per datum."""
    return x.reshape(-1, x.shape[-1]), out_grad.reshape(-1, out_grad.shape[-1]), x.shape[1]


def canonical(name: str, w: torch.Tensor) -> torch.Tensor:
    """A dense weight is its own ``[out, in]`` matrix."""
    return w


def from_canonical(name: str, m: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Inverse of :func:`canonical`."""
    return m
