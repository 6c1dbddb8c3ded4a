"""Held-linearization curvature operators: the model's linearization is
traced once and its residuals kept on the device.

PyTorch counterpart of ``curvlinops_tpu/curvature/held.py``. The base
operators run the model's primal forward (and, for the Hessian, its
backward) inside every product. ``op.linearized()`` instead holds, per
batch, the linear function of the tangents that the JAX package gets from
``jax.linearize`` and ``jax.linear_transpose``, so that every later product
is the tangent computation alone: no primal forward, no module call. That
is the trade for iterative work against fixed data (CG, LSMR, Lanczos,
LOBPCG, the estimators), at the memory cost of one batch's residuals.

How a linear function is held (:class:`HeldLinear`):

1. ``make_fx`` traces ``t -> torch.func.jvp(f, (params,), (t,))`` (or any
   other function linear in ``t``) into an aten-level FX graph. The
   parameters and the data enter it as constants.
2. Every node that depends on constants only is the primal computation.
   It is evaluated once, and the values that the tangent nodes read are
   registered as buffers of the graph module (booleans too, such as a
   mask); the primal nodes are then dead and removed. This is
   ``torch.func.linearize``'s constant folding, done here so that a policy
   can choose what to hold, and so that no value is cloned.
3. The transpose ``J^T`` is the same construction applied to
   ``w -> torch.func.vjp(J, 0)[1](w)``: its forward at zero is constant and
   folds away, and the backward nodes read the held residuals of ``J``. It
   runs no forward either.

``remat`` bounds what is held, as ``jax.checkpoint`` does in the JAX
package. ``None`` holds every residual. ``True`` holds nothing but the
graph's own constants (the parameters and the data) and recomputes the
primal values inside each product. A callable is a selective-checkpoint
policy with torch's signature, ``policy(ctx, op, *args, **kwargs)``
returning a :class:`torch.utils.checkpoint.CheckpointPolicy` (or a bool,
true to hold), called with ``ctx=None`` and fake tensors for the operands
of each primal op. A value is held when its policy says save; otherwise it
is recomputed in every product from the values that are held. Torch's own
selective checkpointing (``create_selective_checkpoint_contexts``) decides
what autograd saves for a backward pass; a held forward-mode linearization
has no backward pass, so the policy is applied to the traced graph.

The flash GPT refuses: its attention Function has no forward mode
(:data:`~curvlinops_tpu_torch.models.flash_attention.FORWARD_MODE_REFUSAL`),
as the JAX kernel's ``custom_vjp`` refuses ``jax.linearize``.

On an operator built with ``mesh=``, each process holds the linearization
of its slice of every batch, and a product is summed over the mesh's data
axis once (``J`` gathers its rows instead), as the base's products are.
"""

from __future__ import annotations

import operator
from typing import Any, Callable

import torch
from torch.fx.node import map_arg
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import CheckpointPolicy

from curvlinops_tpu_torch.ops.base import LinearOperator
from curvlinops_tpu_torch.utils.flatten import tree_add, tree_scale, vmap_columns

_SAVE = (CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_SAVE)
_aten = torch.ops.aten
# matrix products: their output is counted besides their operands, as the
# JAX package's policy counts ``dot_general``'s
_PRODUCT_OUT = {
    _aten.mm.default: lambda a, b: (a.shape[0], b.shape[1]),
    _aten.bmm.default: lambda a, b: (a.shape[0], a.shape[1], b.shape[2]),
    _aten.addmm.default: lambda c, a, b: (a.shape[0], b.shape[1]),
    _aten.baddbmm.default: lambda c, a, b: (a.shape[0], a.shape[1], b.shape[2]),
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def save_smaller_than(limit_bytes: int) -> Callable:
    """A selective-checkpoint policy holding only small residuals.

    A primal op's value is held iff none of its tensor operands (and, for a
    matrix product, its output) reaches ``limit_bytes``. On a transformer
    this drops the ``[B, H, T, T]`` attention products, the residuals that
    blow up held memory at long sequence lengths, and holds the
    activation-sized ones; the dropped values are recomputed from the held
    ones inside each product.
    """

    def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        del ctx
        tensors = [a for a in pytree.tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        sizes = [_nbytes(t) for t in tensors]
        if op in _PRODUCT_OUT:
            shape = _PRODUCT_OUT[op](*args[:3])
            sizes.append(int(torch.Size(shape).numel()) * tensors[0].element_size())
        if max(sizes, default=0) < limit_bytes:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


# The two helpers below hold every use of torch's private API in the held
# operators, so a torch upgrade that changes it touches them alone.


def _trace(flat_fn: Callable, example: list) -> torch.fx.GraphModule:
    """``make_fx`` of ``flat_fn`` at ``example``, every node's metadata from
    one shared fake mode: without a tracing context ``make_fx`` makes a mode
    (and formats a stack) for every value."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    context = TracingContext(FakeTensorMode(allow_fallback_kernels=True))
    with torch.no_grad(), tracing(context):
        return make_fx(flat_fn)(*example)


def _has_storage(value) -> bool:
    """A tensor with memory of its own (``aten._efficientzerotensor``'s has none)."""
    return isinstance(value, torch.Tensor) and not value._is_zerotensor()


def _attr(module: torch.nn.Module, target: str):
    return operator.attrgetter(target)(module)


def _saveable(node, remat) -> bool:
    """Whether ``remat`` lets the value of the primal ``node`` be held."""
    if remat is None:
        return True
    if remat is True:
        return False
    if node.target is operator.getitem:  # one output of a multi-output op
        return _saveable(node.args[0], remat)
    args, kwargs = map_arg((node.args, node.kwargs), lambda n: n.meta.get("val"))
    decision = remat(None, node.target, *args, **kwargs)
    return decision in _SAVE if isinstance(decision, CheckpointPolicy) else bool(decision)


def _fold(gm: torch.fx.GraphModule, n_aux: int, remat) -> tuple[list, int]:
    """Evaluate the primal part of a traced graph once and hold what its
    tangent part (and ``remat``) needs, in place.

    The first ``n_aux`` outputs must not depend on the inputs; they are
    evaluated and dropped from the graph's outputs.

    Returns:
        ``(aux values, held bytes)``: the bytes of the held values' storages
        that are not the graph's own constants.
    """
    graph = gm.graph
    nodes = list(graph.nodes)
    const: set = set()
    for node in nodes:
        if node.op == "get_attr" or (
            node.op == "call_function" and all(a in const for a in node.all_input_nodes)
        ):
            const.add(node)
    out_node = nodes[-1]
    outs = list(out_node.args[0])
    aux = outs[:n_aux]
    if not all(a in const for a in aux):
        raise ValueError("The auxiliary outputs of a held function must not depend on its input.")

    # what to hold: the computed constants that a tangent node (or the
    # output) reads, unless remat recomputes them from their own inputs
    held, held_set, recomputed = [], set(), set()
    stack = [n for n in nodes if n.op == "call_function" and n in const
             and any(u not in const for u in n.users)]
    while stack:
        node = stack.pop()
        if node in recomputed or node in held_set:
            continue
        if node in aux or _saveable(node, remat):
            held.append(node)
            held_set.add(node)
        else:
            recomputed.add(node)
            stack += [a for a in node.all_input_nodes if a.op == "call_function"]

    # evaluate the ancestors of the held nodes once, in graph order,
    # dropping each value after its last use
    needed, stack = set(), list(held)
    while stack:
        node = stack.pop()
        if node not in needed:
            needed.add(node)
            stack += node.all_input_nodes
    order = [n for n in nodes if n in needed]
    last_use = {}
    for i, node in enumerate(order):
        for a in node.all_input_nodes:
            last_use[a] = i
    env, own = {}, set()
    with torch.no_grad():
        for i, node in enumerate(order):
            if node.op == "get_attr":
                env[node] = _attr(gm, node.target)
                if _has_storage(env[node]):
                    own.add(env[node].untyped_storage().data_ptr())
            else:
                args, kwargs = map_arg((node.args, node.kwargs), env.__getitem__)
                env[node] = node.target(*args, **kwargs)
            for a in node.all_input_nodes:
                if last_use[a] == i and a not in held_set:
                    del env[a]

    aux_values = [env[a] for a in aux]
    storages: dict = {}
    for k, node in enumerate(held):
        value = env.pop(node)
        name = f"_held{k}"
        if isinstance(value, torch.Tensor):
            gm.register_buffer(name, value)
            ptr = value.untyped_storage().data_ptr() if _has_storage(value) else None
            if ptr is not None and ptr not in own:
                storages[ptr] = value.untyped_storage().nbytes()
        else:
            setattr(gm, name, value)
        with graph.inserting_before(node):
            attr = graph.get_attr(name)
        node.replace_all_uses_with(attr)
    out_node.args = (list(out_node.args[0])[n_aux:],)
    graph.eliminate_dead_code()
    used = {n.target for n in graph.nodes if n.op == "get_attr"}
    for name in [n for n, _ in gm.named_buffers()] + list(vars(gm)):
        if name.startswith(("_tensor_constant", "_held")) and name not in used:
            delattr(gm, name)
    graph.lint()
    gm.recompile()
    return aux_values, sum(storages.values())


class HeldLinear:
    """A function linear in one tree argument, held: traced once, its
    primal values evaluated once (see the module docstring).

    Args:
        fn: ``t -> (aux, out)``, linear in ``t``; ``aux`` must not depend on
            ``t`` (e.g. the primal output of a ``torch.func.jvp``).
        example: A tree of tensors shaped as ``t``.
        remat: ``None``, ``True`` or a selective-checkpoint policy.

    Attributes:
        aux: ``aux``, evaluated once.
        held_bytes: Bytes of the held values beyond the traced constants.
    """

    def __init__(self, fn: Callable[[Any], tuple[Any, Any]], example: Any, remat=None):
        leaves, self._in_tree = pytree.tree_flatten(example)
        self._in_leaves = [(t.shape, t.dtype, t.device) for t in leaves]
        self._remat = remat
        trees = {}

        def flat_fn(*flat):
            aux, out = fn(pytree.tree_unflatten(list(flat), self._in_tree))
            aux_leaves, trees["aux"] = pytree.tree_flatten(aux)
            out_leaves, trees["out"] = pytree.tree_flatten(out)
            trees["n_aux"] = len(aux_leaves)
            return aux_leaves + out_leaves

        self._gm = _trace(flat_fn, [torch.zeros_like(t) for t in leaves])
        aux_values, self.held_bytes = _fold(self._gm, trees["n_aux"], remat)
        self.aux = pytree.tree_unflatten(aux_values, trees["aux"])
        self._out_tree = trees["out"]

    def __call__(self, t: Any) -> Any:
        return pytree.tree_unflatten(self._gm(*pytree.tree_leaves(t)), self._out_tree)

    def transpose(self) -> "HeldLinear":
        """The held adjoint ``w -> J^T w`` of this linear function."""
        zeros = pytree.tree_unflatten(
            [torch.zeros(shape, dtype=dtype, device=device)
             for shape, dtype, device in self._in_leaves],
            self._in_tree,
        )
        return HeldLinear(
            lambda w: ((), torch.func.vjp(self, zeros)[1](w)[0]), self(zeros), self._remat
        )


def _jvp_of(f: Callable, params: Any) -> Callable:
    """``t -> (f(params), J_f(params) t)``."""
    return lambda t: torch.func.jvp(f, (params,), (t,))


def _ggn_build(op, remat) -> Callable:
    """Exact GGN per batch: held ``J``, ``J^T``; the loss Hessian at the held
    prediction per product (held analogue of ``ggn.py``'s kernel)."""
    loss_fn, params = op._loss_fn, op._params

    def build(X, y, generator):
        J = HeldLinear(_jvp_of(lambda p: op._model_fn(p, X), params), params, remat)
        JT, pred = J.transpose(), J.aux
        loss_grad = torch.func.grad(lambda q: loss_fn(q, y))

        def ggnvp(v):
            _, hjv = torch.func.jvp(loss_grad, (pred,), (J(v),))
            return JT(hjv)

        return ggnvp, J.held_bytes + JT.held_bytes

    return build


def _ggn_mc_build(op, remat) -> Callable:
    """MC Fisher per batch: the grad-output samples are drawn once, at hold
    time, from the base operator's per-batch generator, so the held matrix
    is the base's matrix with the same samples."""
    from curvlinops_tpu_torch.curvature.loss_hessian import (
        FisherType,
        make_grad_output_fn,
        mean_rescale,
    )

    loss_fn, params = op._loss_fn, op._params
    grad_output_fn = make_grad_output_fn(loss_fn, FisherType.MC, op._mc_samples)

    def build(X, y, generator):
        J = HeldLinear(_jvp_of(lambda p: op._model_fn(p, X), params), params, remat)
        JT, pred = J.transpose(), J.aux
        G = grad_output_fn(pred, y, generator)
        c_batch = float(pred.shape[0]) if loss_fn.reduction == "mean" else 1.0
        c_batch = c_batch / mean_rescale(loss_fn, y)

        def fishervp(v):
            jv = J(v)
            coeff = torch.einsum("nk...,n...->nk", G, jv.to(G.dtype))
            tangent = torch.einsum("nk...,nk->n...", G, coeff) / c_batch
            return JT(tangent.to(jv.dtype))

        return fishervp, J.held_bytes + JT.held_bytes

    return build


def _ef_build(op, remat) -> Callable:
    """Empirical Fisher per batch (held analogue of ``ef.py``'s kernel)."""
    from curvlinops_tpu_torch.curvature.ef import flatten_prediction, flatten_target, make_row_grad
    from curvlinops_tpu_torch.losses import CrossEntropyLoss

    loss_fn, params = op._loss_fn, op._params
    row_grad = make_row_grad(loss_fn)

    def build(X, y, generator):
        J = HeldLinear(
            _jvp_of(lambda p: flatten_prediction(loss_fn, op._model_fn(p, X)), params),
            params, remat,
        )
        JT, pred_flat = J.transpose(), J.aux
        y_flat = flatten_target(loss_fn, y)
        G = row_grad(pred_flat, y_flat)
        L, C = pred_flat.shape
        R = 1.0
        if loss_fn.reduction == "mean":
            if isinstance(loss_fn, CrossEntropyLoss):
                # the mean divides by the non-ignored loss-term count
                R = (y_flat != loss_fn.ignore_index).sum().clamp(min=1).to(pred_flat.dtype)
            else:
                R = float(L * C)

        def efvp(v):
            coeff = torch.einsum("lc,lc->l", G, J(v))
            return JT(coeff[:, None] * G / R)

        return efvp, J.held_bytes + JT.held_bytes

    return build


def _jacobian_build(op, remat) -> Callable:
    """``J`` per batch: the pure tangent push-forward."""

    def build(X, y, generator):
        J = HeldLinear(_jvp_of(lambda p: op._model_fn(p, X), op._params), op._params, remat)
        return J, J.held_bytes

    return build


def _jacobian_t_build(op, remat) -> Callable:
    """``J^T`` per batch: the held transpose of the held ``J``."""

    def build(X, y, generator):
        J = HeldLinear(_jvp_of(lambda p: op._model_fn(p, X), op._params), op._params, remat)
        JT = J.transpose()
        return JT, J.held_bytes + JT.held_bytes

    return build


def _hessian_build(op, remat) -> Callable:
    """Hessian per batch: the held linearization of the batch loss's
    gradient, so a product runs neither the primal forward nor the primal
    backward."""
    loss_fn, params = op._loss_fn, op._params

    def build(X, y, generator):
        grad_fn = torch.func.grad(lambda p: loss_fn(op._model_fn(p, X), y))
        H = HeldLinear(lambda t: ((), torch.func.jvp(grad_fn, (params,), (t,))[1]), params, remat)
        return H, H.held_bytes

    return build


def _kernels_for(op, remat) -> tuple[Callable, str]:
    """``(build, combine)`` for a base operator: ``build(X, y, generator)``
    holds one batch and returns ``(per-vector product, held bytes)``.

    Raises:
        NotImplementedError: For an operator without a held form.
    """
    from curvlinops_tpu_torch.curvature.ef import EFLinearOperator
    from curvlinops_tpu_torch.curvature.ggn import GGNLinearOperator
    from curvlinops_tpu_torch.curvature.hessian import HessianLinearOperator
    from curvlinops_tpu_torch.curvature.jacobian import (
        JacobianLinearOperator,
        TransposedJacobianLinearOperator,
    )

    if isinstance(op, HessianLinearOperator):
        return _hessian_build(op, remat), "accumulate"
    if isinstance(op, GGNLinearOperator):
        build = _ggn_mc_build if op._mc_samples > 0 else _ggn_build
        return build(op, remat), "accumulate"
    if isinstance(op, EFLinearOperator):
        return _ef_build(op, remat), "accumulate"
    if isinstance(op, JacobianLinearOperator):
        return _jacobian_build(op, remat), "concat_rows"
    if isinstance(op, TransposedJacobianLinearOperator):
        return _jacobian_t_build(op, remat), "slice_rows"
    raise NotImplementedError(
        f"linearized() supports Hessian/GGN/MC-Fisher/EF/Jacobian operators, not "
        f"{type(op).__name__} (KFAC-family operators already precompute their "
        "factors; their matvecs never touch the model)."
    )


class HeldLinearizationOperator(LinearOperator):
    """The same matrix as ``base``, with each batch's linearization held on
    the device (see the module docstring). Built by ``base.linearized()``.

    Attributes:
        held_bytes: Bytes held beyond the parameters and the data.
    """

    def __init__(self, base, remat=None) -> None:
        super().__init__(base.in_spec, base.out_spec)
        self.SELF_ADJOINT = base.SELF_ADJOINT
        self._base, self._remat = base, remat
        build, self._combine = _kernels_for(base, remat)
        self._held: list[tuple[Callable, float]] = []
        self._batch_sizes: list[int] = []  # this process's rows of each batch
        self.held_bytes = 0
        for X, y, c, gen in base._shard_loop(desc="hold"):
            product, nbytes = build(X, y, gen)
            self._held.append((product, c))
            self._batch_sizes.append(base._batch_size_fn(X))
            self.held_bytes += nbytes
        if not self._held:
            raise ValueError("Empty dataset: nothing to hold.")

    @property
    def capturable(self) -> bool:
        """Whether a program may capture the products inline: the held
        products read nothing to the host, and no sum over a mesh follows."""
        return self._base._mesh is None

    @torch.no_grad()
    def _matmat(self, M: Any) -> Any:
        maxcols, shards = self._base._max_vmap_columns, self._base._shards
        if self._combine == "concat_rows":  # J: stack the batches' prediction rows
            blocks = [vmap_columns(f, M, maxcols) for f, _ in self._held]
            return torch.cat([shards.gather_rows(b) for b in blocks], dim=0)
        index, count = shards.index, shards.count
        out, offset = None, 0
        for (f, c), B in zip(self._held, self._batch_sizes):
            if self._combine == "slice_rows":  # J^T: pull back each batch's rows
                start = offset + index * B
                res = vmap_columns(f, M[start:start + B], maxcols)
                offset += B * count
            else:
                res = tree_scale(c, vmap_columns(f, M, maxcols))
            out = res if out is None else tree_add(out, res)
        return shards.all_reduce(out)

    def _adjoint(self) -> LinearOperator:
        """The held linearization of the base's adjoint (the Jacobian pair;
        the curvature operators are self-adjoint and never reach this)."""
        return self._base.adjoint().linearized(remat=self._remat)
