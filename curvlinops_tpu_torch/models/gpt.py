"""nanoGPT-class decoder-only transformer as an ``nn.Module``.

PyTorch counterpart of ``curvlinops_tpu/models/gpt.py``: GPT-2-small
geometry by default (12 layers, 12 heads, 768 wide, block 1024, vocab
50304), no weight tying, logits flattened to ``[(B*T), V]`` for
cross-entropy. Parameter names follow the JAX pytree paths
(``h3.attn_qkv.weight`` for ``['h3']['attn_qkv']['W']``, ``wte``,
``ln_f.scale``), so :func:`~curvlinops_tpu_torch.models.common.from_jax_params`
carries weights across. The dense layers are ``nn.Linear`` modules, which
the KFAC collector recognises; attention uses no parameters.

``attention_impl``:

- ``"einsum"``: explicit einsum softmax with a causal mask (the plain path).
- ``"flash"``: :func:`~curvlinops_tpu_torch.models.flash_attention.flash_attention`,
  hand-written Hopper kernels on CUDA, reverse mode only (gradients and
  KFAC factor builds).
- ``"fused"`` (JAX's ``jax.nn.dot_product_attention``) and the scan-stacked
  block form (``stack_gpt_blocks``, ``remat_blocks``) are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F
from torch import nn

from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.common import Problem, lecun_normal, resolve_device
from curvlinops_tpu_torch.models.flash_attention import flash_attention
from curvlinops_tpu_torch.models.resnet import kfac_restricted

_LN_EPS = 1e-5
ATTENTION_IMPLS = ("einsum", "flash")


@dataclass(frozen=True)
class GPTConfig:
    """Model geometry (defaults = nanoGPT's GPT-2 small)."""

    block_size: int = 1024
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    attention_impl: str = "einsum"


class LayerNorm(nn.Module):
    """LayerNorm with JAX's ``scale``/``bias`` names: biased variance, eps 1e-5."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, _LN_EPS)


def causal_attention(qkv: torch.Tensor, n_head: int, impl: str) -> torch.Tensor:
    """Causal self-attention of a fused ``[B, T, 3C]`` projection -> ``[B, T, C]``."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    hd = C // n_head
    q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2) for t in qkv.split(C, dim=-1))
    if impl == "flash":
        out = flash_attention(q, k, v, causal=True, sm_scale=1.0 / math.sqrt(hd))
    else:
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        mask = torch.ones((T, T), dtype=torch.bool, device=qkv.device).tril()
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", att, v)
    return out.transpose(1, 2).reshape(B, T, C)


class Block(nn.Module):
    """Pre-norm transformer block: attention and a tanh-GELU MLP, residuals."""

    def __init__(self, c: int, n_head: int, attention_impl: str):
        super().__init__()
        self.n_head, self.attention_impl = n_head, attention_impl
        self.ln1 = LayerNorm(c)
        self.attn_qkv = nn.Linear(c, 3 * c)
        self.attn_proj = nn.Linear(c, c)
        self.ln2 = LayerNorm(c)
        self.mlp_fc = nn.Linear(c, 4 * c)
        self.mlp_proj = nn.Linear(4 * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # noqa: D102
        qkv = self.attn_qkv(self.ln1(x))
        x = x + self.attn_proj(causal_attention(qkv, self.n_head, self.attention_impl))
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(self.mlp_fc(self.ln2(x)), approximate="tanh")
        return x + self.mlp_proj(h)


class GPT(nn.Module):
    """Forward pass ``[B, T]`` int tokens -> ``[(B*T), vocab]`` flattened logits.

    Raises:
        NotImplementedError: For ``attention_impl="fused"`` (not ported).
        ValueError: For any other unknown ``attention_impl``.
    """

    def __init__(self, config: GPTConfig):
        super().__init__()
        if config.attention_impl == "fused":
            raise NotImplementedError(
                "attention_impl='fused' (jax.nn.dot_product_attention) is not ported; "
                "use 'einsum' or 'flash'."
            )
        if config.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}.")
        self.config = config
        C, V = config.n_embd, config.vocab_size
        self.wte = nn.Parameter(torch.zeros(V, C))
        self.wpe = nn.Parameter(torch.zeros(config.block_size, C))
        for i in range(config.n_layer):
            setattr(self, f"h{i}", Block(C, config.n_head, config.attention_impl))
        self.ln_f = LayerNorm(C)
        self.lm_head = nn.Linear(C, V, bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # noqa: D102
        B, T = tokens.shape
        x = self.wte[tokens] + self.wpe[:T]
        for i in range(self.config.n_layer):
            x = getattr(self, f"h{i}")(x)
        return self.lm_head(self.ln_f(x)).reshape(B * T, -1)


def init_gpt(
    config: GPTConfig, generator: torch.Generator, dtype=torch.float32, device="cuda"
) -> GPT:
    """Build a GPT with the JAX package's initialisation, drawn on the CPU from
    ``generator`` and moved to ``device`` (raises without a CUDA device unless
    the caller asks for the CPU): token table N(0, 0.02^2), position table
    N(0, 0.01^2), LeCun-normal dense weights, zero biases, identity norms."""
    device = resolve_device(device)
    model = GPT(config)
    with torch.no_grad():
        model.wte.copy_(0.02 * torch.randn(model.wte.shape, generator=generator))
        model.wpe.copy_(0.01 * torch.randn(model.wpe.shape, generator=generator))
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(lecun_normal(tuple(mod.weight.shape), mod.in_features, generator))
                if mod.bias is not None:
                    mod.bias.zero_()
    return model.to(device=device, dtype=dtype)


def shakespeare_nanogpt(
    batch_size: int = 4,
    config: GPTConfig | None = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    attention_impl: str | None = None,
) -> Problem:
    """Synthetic-Shakespeare nanoGPT problem (random tokens, next-token CE).

    ``attention_impl`` overrides the config's attention implementation
    (``"flash"`` = the Hopper kernels, reverse mode only). KFAC covers the
    four dense layers of every block (``kfac_restricted``); the embeddings,
    norms and the 50304-wide ``lm_head`` stay in the module.
    """
    config = config or GPTConfig()
    if attention_impl is not None:
        config = replace(config, attention_impl=attention_impl)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_gpt(config, gen, dtype, device)
    T = config.block_size
    tokens = torch.randint(0, config.vocab_size, (batch_size, T + 1), generator=gen).to(device)
    X, y = tokens[:, :T], tokens[:, 1:].reshape(-1)
    _, kfac_params = kfac_restricted(model)
    return Problem(
        "synthetic_shakespeare_nanogpt", model, CrossEntropyLoss("mean"),
        dict(model.named_parameters()), [(X, y)], kfac_params,
    )


TINY_GPT = GPTConfig(block_size=16, vocab_size=32, n_layer=2, n_head=2, n_embd=16)
