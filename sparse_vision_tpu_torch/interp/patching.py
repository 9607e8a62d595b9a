"""Attribution-patching gradient primitives (port of
sparse_vision_tpu/interp/patching.py).

Attribution patching (Marks et al., "Sparse Feature Circuits") splices
``decoder_out + sae_error.detach()`` into a layer's output and overwrites that
output's gradient with the clean model's gradient. The semantics it relies on:

  1. without the detach, the gradient w.r.t. the SAE encoder output is exactly
     zero (the splice is the identity, so no gradient flows through the
     reconstruction path);
  2. with the detach, the encoder-output gradient equals the layer-output
     gradient chained through the decoder;
  3. with pass-through, the gradient arriving at the spliced layer output equals
     the clean model's gradient regardless of downstream interventions.

Here: a detaching splice, a pass-through ``autograd.Function`` (written with
``setup_context``, so ``torch.func`` transforms it), and a helper that returns
the loss gradient w.r.t. every tapped intermediate in one backward pass.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from sparse_vision_tpu_torch.models.layers import SeqNet


def splice_with_error(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """``recon + (x - recon).detach()``: value is exactly ``x``, gradient flows
    only through ``recon``."""
    return recon + (x - recon).detach()


class PassThrough(torch.autograd.Function):
    """Identity on ``y`` whose backward replaces the incoming cotangent with
    ``grad_clean``; ``grad_clean`` itself, a constant saved from the clean pass,
    gets no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(y, grad_clean):
        return y.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, ct):
        (grad_clean,) = ctx.saved_tensors
        return grad_clean, None


def pass_through(y: torch.Tensor, grad_clean: torch.Tensor) -> torch.Tensor:
    return PassThrough.apply(y, grad_clean)


def loss_and_tap_grads(
    net: SeqNet,
    params: dict,
    state: Optional[dict],
    images: torch.Tensor,
    labels: torch.Tensor,
    criterion: Callable,
    layers: Iterable[str],
) -> tuple:
    """Clean-model loss, taps, and d(loss)/d(tap) for every layer in ``layers``,
    all detached.

    One forward + one backward: a zero perturbation (NHWC, the tap's shape from
    ``net.shapes``) is added after each requested stage, and the loss is
    differentiated w.r.t. the perturbations."""
    layers = list(layers)
    shapes = net.shapes(tuple(images.shape[1:]))
    eps = {name: torch.zeros((images.shape[0], *shapes[name]), dtype=images.dtype,
                             device=images.device, requires_grad=True)
           for name in layers}
    splice = {name: (lambda a, e=eps[name]: a + e) for name in layers}
    with torch.enable_grad():
        logits, taps, _ = net.apply(params, images, state=state, splice=splice)
        loss = criterion(logits, labels)
        grads = torch.autograd.grad(loss, [eps[name] for name in layers])
    return (loss.detach(), {k: v.detach() for k, v in taps.items()},
            dict(zip(layers, grads)))
