"""nanoGPT-class decoder-only transformer as an ``nn.Module``.

PyTorch counterpart of ``curvlinops_tpu/models/gpt.py``: GPT-2-small
geometry by default (12 layers, 12 heads, 768 wide, block 1024, vocab
50304), no weight tying, logits flattened to ``[(B*T), V]`` for
cross-entropy. Parameter names follow the JAX pytree paths
(``h3.attn_qkv.weight`` for ``['h3']['attn_qkv']['W']``, ``ln_f.scale``);
the token and position tables are ``nn.Embedding`` modules ``wte`` and
``wpe`` (``wte.weight`` for ``['wte']``), which the KFAC collector
recognises as lookups. :func:`~curvlinops_tpu_torch.models.common.from_jax_params`
carries weights across. The dense layers are ``nn.Linear`` modules;
attention uses no parameters.

``scan_blocks=True`` is the scan-stacked block form (JAX's ``h`` subtree
whose leaves carry a leading ``n_layer`` axis): one block ``h`` with
:class:`~curvlinops_tpu_torch.models.stack.StackedLinear` layers and stacked
norms, applied by :func:`~curvlinops_tpu_torch.models.stack.scan` (same
math, KFAC factors batched over the stack). ``remat_blocks`` (the default,
as in ``gpt_apply``) rematerialises each block of that loop, the port's
``jax.checkpoint``: reverse mode keeps only the block inputs and recomputes
each block in its pullback, under plain autograd and under the
``torch.func`` transforms of the curvature operators alike (see
``models/stack.py``; the KFAC collector's forward runs the loop without
it). The unrolled model has no remat.

``attention_impl``:

- ``"einsum"``: explicit einsum softmax with a causal mask (the plain path).
- ``"flash"``: :func:`~curvlinops_tpu_torch.models.flash_attention.flash_attention`,
  hand-written Hopper kernels on CUDA, reverse mode only (gradients and
  KFAC factor builds).
- ``"fused"``: ``F.scaled_dot_product_attention(is_causal=True)`` (JAX's
  ``jax.nn.dot_product_attention``) with the math backend pinned by
  ``torch.nn.attention.sdpa_kernel``. It is the one float32 backend through
  which forward mode flows (the Hessian, GGN and MC Fisher need it): on an
  H100 with PyTorch 2.11 the memory-efficient backend raises
  ``NotImplementedError`` under ``torch.func.jvp`` and the flash and cuDNN
  backends take no float32 (``chip_smoke.py``'s fused phase prints each
  backend's outcome). A backend that cannot run raises; there is no silent
  switch to another one.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from curvlinops_tpu_torch.losses import CrossEntropyLoss
from curvlinops_tpu_torch.models.common import Problem, lecun_normal, resolve_device
from curvlinops_tpu_torch.models.flash_attention import flash_attention
from curvlinops_tpu_torch.models.resnet import kfac_restricted
from curvlinops_tpu_torch.models.stack import StackedLinear, scan

_LN_EPS = 1e-5
ATTENTION_IMPLS = ("einsum", "flash", "fused")
SDPA_BACKEND = SDPBackend.MATH  # the backend "fused" pins (module docstring)


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
    """LayerNorm with JAX's ``scale``/``bias`` names: biased variance, eps
    1e-5. With ``stack``, the parameters are ``[stack, c]`` and
    ``forward(x, layer)`` uses slice ``layer``."""

    def __init__(self, c: int, stack: int | None = None):
        super().__init__()
        shape = (c,) if stack is None else (stack, c)
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, *layer: int) -> torch.Tensor:  # noqa: D102
        scale, bias = self.scale[layer], self.bias[layer]
        if x.dtype in (torch.bfloat16, torch.float16):
            # in float32, rounded once: CUDA's fused kernel keeps its
            # statistics in float32, so under forward mode (torch.func.jvp)
            # its output's tangent came out float32, and the next reduced
            # precision layer refused it
            out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), _LN_EPS)
            return out.to(x.dtype)
        return F.layer_norm(x, (x.shape[-1],), scale, bias, _LN_EPS)


def attention(qkv: torch.Tensor, n_head: int, impl: str, causal: bool = True) -> torch.Tensor:
    """Self-attention of a fused ``[B, T, 3C]`` projection -> ``[B, T, C]``
    (causal, or bidirectional for the ViT)."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    hd = C // n_head
    q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2) for t in qkv.split(C, dim=-1))
    if impl == "flash":
        out = flash_attention(q, k, v, causal=causal, sm_scale=1.0 / math.sqrt(hd))
    elif impl == "fused":
        with sdpa_kernel([SDPA_BACKEND]):
            out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    else:
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        if causal:
            mask = torch.ones((T, T), dtype=torch.bool, device=qkv.device).tril()
            att = att.masked_fill(~mask, float("-inf"))
        out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(att, dim=-1), v)
    return out.transpose(1, 2).reshape(B, T, C)


class Block(nn.Module):
    """Pre-norm transformer block: attention and a tanh-GELU MLP, residuals.

    With ``stack``, the block holds ``stack`` blocks' parameters
    (:class:`~curvlinops_tpu_torch.models.stack.StackedLinear` layers and
    stacked norms) and ``forward(x, layer)`` applies block ``layer``.
    """

    def __init__(
        self, c: int, n_head: int, attention_impl: str, causal: bool = True,
        stack: int | None = None,
    ):
        super().__init__()
        self.n_head, self.attention_impl, self.causal = n_head, attention_impl, causal
        dense = nn.Linear if stack is None else partial(StackedLinear, stack)
        self.ln1 = LayerNorm(c, stack)
        self.attn_qkv = dense(c, 3 * c)
        self.attn_proj = dense(c, c)
        self.ln2 = LayerNorm(c, stack)
        self.mlp_fc = dense(c, 4 * c)
        self.mlp_proj = dense(4 * c, c)

    def forward(self, x: torch.Tensor, *layer: int) -> torch.Tensor:  # noqa: D102
        qkv = self.attn_qkv(self.ln1(x, *layer), *layer)
        att = attention(qkv, self.n_head, self.attention_impl, self.causal)
        x = x + self.attn_proj(att, *layer)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(self.mlp_fc(self.ln2(x, *layer), *layer), approximate="tanh")
        return x + self.mlp_proj(h, *layer)


def stack_blocks(model: nn.Module, stacked: nn.Module) -> nn.Module:
    """``stacked`` (a model's scan-stacked form) with the weights of the
    unrolled ``model``: slice ``i`` of its block ``h`` is block ``h{i}``; the
    counterpart of JAX's ``stack_*_blocks``."""
    ref = next(model.parameters())
    stacked = stacked.to(device=ref.device, dtype=ref.dtype)
    state = model.state_dict()
    stacked.load_state_dict(
        {k: v for k, v in state.items() if not re.match(r"h\d+\.", k)}, strict=False
    )
    n_layer = model.config.n_layer
    with torch.no_grad():
        for name, p in stacked.h.named_parameters():
            p.copy_(torch.stack([state[f"h{i}.{name}"] for i in range(n_layer)]))
    return stacked


class GPT(nn.Module):
    """Forward pass ``[B, T]`` int tokens -> ``[(B*T), vocab]`` flattened logits.

    Raises:
        ValueError: For an unknown ``attention_impl``.
    """

    def __init__(self, config: GPTConfig, scan_blocks: bool = False, remat_blocks: bool = True):
        super().__init__()
        if config.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}.")
        self.config, self.scan_blocks, self.remat_blocks = config, scan_blocks, remat_blocks
        C, V = config.n_embd, config.vocab_size
        self.wte = nn.Embedding(V, C)
        self.wpe = nn.Embedding(config.block_size, C)
        if scan_blocks:
            self.h = Block(C, config.n_head, config.attention_impl, stack=config.n_layer)
        else:
            for i in range(config.n_layer):
                setattr(self, f"h{i}", Block(C, config.n_head, config.attention_impl))
        self.ln_f = LayerNorm(C)
        self.lm_head = nn.Linear(C, V, bias=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # noqa: D102
        B, T = tokens.shape
        x = self.wte(tokens) + self.wpe(torch.arange(T, device=tokens.device))
        if self.scan_blocks:
            x = scan(self.h, x, self.config.n_layer, remat=self.remat_blocks)
        else:
            for i in range(self.config.n_layer):
                x = getattr(self, f"h{i}")(x)
        return self.lm_head(self.ln_f(x)).reshape(B * T, -1)


def stack_gpt_blocks(model: GPT) -> GPT:
    """The scan-stacked GPT with the weights of the unrolled ``model``."""
    return stack_blocks(model, GPT(model.config, scan_blocks=True))


def init_gpt(
    config: GPTConfig,
    generator: torch.Generator,
    dtype=torch.float32,
    device="cuda",
    scan_blocks: bool = False,
) -> GPT:
    """Build a GPT with the JAX package's initialisation, drawn on the CPU from
    ``generator`` and moved to ``device`` (raises without a CUDA device unless
    the caller asks for the CPU): token table N(0, 0.02^2), position table
    N(0, 0.01^2), LeCun-normal dense weights, zero biases, identity norms.
    ``scan_blocks`` stacks the drawn blocks (:func:`stack_gpt_blocks`), so
    both forms of one seed carry the same weights."""
    device = resolve_device(device)
    model = GPT(config)
    with torch.no_grad():
        model.wte.weight.copy_(0.02 * torch.randn(model.wte.weight.shape, generator=generator))
        model.wpe.weight.copy_(0.01 * torch.randn(model.wpe.weight.shape, generator=generator))
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(lecun_normal(tuple(mod.weight.shape), mod.in_features, generator))
                if mod.bias is not None:
                    mod.bias.zero_()
    if scan_blocks:
        model = stack_gpt_blocks(model)
    return model.to(device=device, dtype=dtype)


def shakespeare_nanogpt(
    batch_size: int = 4,
    config: GPTConfig | None = None,
    seed: int = 0,
    dtype=torch.float32,
    device="cuda",
    attention_impl: str | None = None,
    scan_blocks: bool = False,
    remat_blocks: bool = True,
    include_embeddings: bool = False,
) -> Problem:
    """Synthetic-Shakespeare nanoGPT problem (random tokens, next-token CE).

    ``attention_impl`` overrides the config's attention implementation
    (``"flash"`` = the Hopper kernels, reverse mode only; ``"fused"`` =
    SDPA's math backend). ``scan_blocks=True`` stacks the blocks into one
    scanned block (same weights as the unrolled form of the seed), which
    ``remat_blocks`` (default ``True``) rematerialises block by block. KFAC
    covers the four dense layers of every block (``kfac_restricted``), and
    with ``include_embeddings`` the ``wte``/``wpe`` tables; the norms and the
    50304-wide ``lm_head`` stay in the module.
    """
    config = config or GPTConfig()
    if attention_impl is not None:
        config = replace(config, attention_impl=attention_impl)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_gpt(config, gen, dtype, device, scan_blocks)
    model.remat_blocks = remat_blocks
    T = config.block_size
    tokens = torch.randint(0, config.vocab_size, (batch_size, T + 1), generator=gen).to(device)
    X, y = tokens[:, :T], tokens[:, 1:].reshape(-1)
    _, kfac_params = kfac_restricted(model, include_embeddings)
    return Problem(
        "synthetic_shakespeare_nanogpt", model, CrossEntropyLoss("mean"),
        dict(model.named_parameters()), [(X, y)], kfac_params,
    )


TINY_GPT = GPTConfig(block_size=16, vocab_size=32, n_layer=2, n_head=2, n_embd=16)
