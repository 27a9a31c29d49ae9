"""A dense layer whose output stays f32 for a bf16 input, as the JAX
package's ``jnp.dot(..., preferred_element_type=jnp.float32) + b`` does
before an activation.

torch's bf16 ``addmm`` rounds its f32 sums to bf16 at the store. Where JAX
applies a GELU to the f32 sum (CLIP's ``w_fc``, SAM's encoder ``fc1``), that
rounding comes before the activation and not after it. ``dense_f32`` keeps
the sum in f32:

- f32 inputs: the ordinary ``addmm``, unchanged;
- bf16 on the CPU: the f32 product of the upcast operands (bf16 products
  are exact in f32);
- bf16 on CUDA: a bf16 product with an f32 output (``torch.mm`` with
  ``out_dtype``), inside an ``autograd.Function`` because that overload has
  no derivative; its backward is the two bf16 products.
"""

from __future__ import annotations

import torch


class _MatmulF32Out(torch.autograd.Function):
    """[N, K] @ [K, M] of bf16 operands → f32 [N, M] on CUDA."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dw


def dense_f32(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """x @ w + b over the last axis, in f32 whatever x's dtype (f32 or
    bf16); ``w`` and ``b`` are in x's dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = torch.addmm(b, x2, w)
    elif x.device.type == "cuda":
        out = _MatmulF32Out.apply(x2, w) + b.float()
    else:
        out = torch.addmm(b.float(), x2.float(), w.float())
    return out.reshape(*x.shape[:-1], w.shape[1])
