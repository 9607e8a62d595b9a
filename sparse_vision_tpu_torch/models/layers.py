"""Stage-based sequential backbone with explicit taps and splices (port of
sparse_vision_tpu/models/layers.py: the stages GoogLeNet needs, and relu,
flatten and conv).

A backbone is a sequence of named stages; ``apply`` returns ``(output, taps,
state)`` where ``taps[name]`` is every stage's output, and a splice
``(layer_name, fn)`` replaces a stage's output with ``fn(output)`` before the next
stage runs. ``apply_segment`` runs the sub-network between two stages.

Layout: the public functions take and return NHWC tensors, as the JAX package
does (taps, splice arguments, ``apply_segment`` input), so tokens keep their
(b, h, w) order. Inside, a 4-D activation is the NCHW permutation of that NHWC
memory, i.e. a ``torch.channels_last`` tensor, which is the layout cuDNN prefers;
converting at the boundary is a permutation of strides, not a copy.

Stage inits follow torch's defaults: U(±1/sqrt(fan_in)) for weights and biases.
Stages run in inference mode (frozen backbone); parameters are in torch layout
(conv OIHW, linear [out, in]).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Stage(NamedTuple):
    name: str
    init: Callable  # (generator, in_shape) -> (params | None, state | None)
    apply: Callable  # (params, state, x) -> y
    out_shape: Callable  # in_shape (h, w, c) or (d,) -> out_shape


def uniform(generator: torch.Generator, shape: tuple, bound: float) -> torch.Tensor:
    return torch.empty(shape, device=generator.device).uniform_(
        -bound, bound, generator=generator)


def _to_internal(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _to_public(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.ndim == 4 else x


def linear(name: str, out_features: int) -> Stage:
    def init(gen, in_shape):
        (d,) = in_shape
        bound = 1.0 / math.sqrt(d)
        return {"w": uniform(gen, (out_features, d), bound),
                "b": uniform(gen, (out_features,), bound)}, None

    def apply(params, state, x):
        return F.linear(x, params["w"], params["b"])

    return Stage(name, init, apply, lambda s: (out_features,))


def relu(name: str) -> Stage:
    return Stage(name, lambda gen, s: (None, None),
                 lambda params, state, x: torch.relu(x), lambda s: s)


def flatten(name: str) -> Stage:
    """[B, ...] -> [B, prod(...)], flattening a 4-D activation in NHWC order as
    the JAX stage does, so a following linear layer reads the same features."""
    return Stage(name, lambda gen, s: (None, None),
                 lambda params, state, x: _to_public(x).reshape(x.shape[0], -1),
                 lambda s: (math.prod(s),))


def conv(name: str, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
         use_bias: bool = True) -> Stage:
    """A square convolution; weight [out, in, k, k] (OIHW), optional bias."""

    def init(gen, in_shape):
        fan_in = in_shape[-1] * kernel * kernel
        bound = 1.0 / math.sqrt(fan_in)
        params = {"w": uniform(gen, (out_ch, in_shape[-1], kernel, kernel), bound)}
        if use_bias:
            params["b"] = uniform(gen, (out_ch,), bound)
        return params, None

    def apply(params, state, x):
        return F.conv2d(x, params["w"], params.get("b"), stride, padding)

    def out_shape(s):
        h, w, _ = s
        return ((h + 2 * padding - kernel) // stride + 1,
                (w + 2 * padding - kernel) // stride + 1, out_ch)

    return Stage(name, init, apply, out_shape)


def pool_out_dim(n: int, window: int, stride: int, padding: int, ceil_mode: bool) -> int:
    """Output size of a max pool, with torch's ceil_mode rule: the last window
    must start within the input or the left padding, otherwise it is dropped."""
    eff = n + 2 * padding - window
    out = (math.ceil(eff / stride) if ceil_mode else eff // stride) + 1
    if ceil_mode and (out - 1) * stride >= n + padding:
        out -= 1
    return out


def maxpool(name: str, window: int, stride: Optional[int] = None,
            padding: int = 0, ceil_mode: bool = False) -> Stage:
    stride = stride or window

    def apply(params, state, x):
        return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)

    def out_shape(s):
        h, w, c = s
        return (pool_out_dim(h, window, stride, padding, ceil_mode),
                pool_out_dim(w, window, stride, padding, ceil_mode), c)

    return Stage(name, lambda gen, s: (None, None), apply, out_shape)


def global_avgpool(name: str) -> Stage:
    return Stage(name, lambda gen, s: (None, None),
                 lambda params, state, x: x.mean(dim=(2, 3)), lambda s: (s[-1],))


def fn_stage(name: str, f: Callable[[torch.Tensor], torch.Tensor],
             out_shape_fn: Callable[[tuple], tuple] = lambda s: s) -> Stage:
    return Stage(name, lambda gen, s: (None, None),
                 lambda params, state, x: f(x), out_shape_fn)


class SeqNet:
    """A sequence of named stages operating on a single activation tensor."""

    def __init__(self, stages: list):
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate stage names: {names}")
        self.stages = tuple(stages)
        self.stage_names = tuple(names)

    def index_of(self, name: str) -> int:
        return self.stage_names.index(name)

    def init(self, generator: torch.Generator, input_shape: tuple):
        """Returns (params, state) on the generator's device; entries only for
        stages that have them."""
        params, state = {}, {}
        shape = tuple(input_shape)
        for st in self.stages:
            p, s = st.init(generator, shape)
            shape = tuple(st.out_shape(shape))
            if p is not None:
                params[st.name] = p
            if s is not None:
                state[st.name] = s
        return params, state

    def shapes(self, input_shape: tuple) -> dict:
        """Stage name -> output shape without the batch dim (NHWC order)."""
        out, shape = {}, tuple(input_shape)
        for st in self.stages:
            shape = tuple(st.out_shape(shape))
            out[st.name] = shape
        return out

    @staticmethod
    def _splices(splice) -> dict:
        return dict([splice]) if isinstance(splice, tuple) else (splice or {})

    def apply(self, params: dict, x: torch.Tensor, state: Optional[dict] = None,
              splice=None, stop_at: Optional[str] = None):
        """Run the network on NHWC input. Returns (output, taps, state); taps hold
        every stage's (possibly spliced) output in NHWC, the value the next stage
        consumes. ``splice`` is a ``(layer_name, fn)`` pair or a dict of them."""
        state = state or {}
        splices = self._splices(splice)
        taps = {}
        h = _to_internal(x)
        for st in self.stages:
            h = st.apply(params.get(st.name), state.get(st.name), h)
            if st.name in splices:
                h = _to_internal(splices[st.name](_to_public(h)))
            taps[st.name] = _to_public(h)
            if stop_at is not None and st.name == stop_at:
                break
        return _to_public(h), taps, state

    def apply_segment(self, params: dict, x: torch.Tensor, after: Optional[str],
                      upto: str, state: Optional[dict] = None, splice=None) -> torch.Tensor:
        """Run the stages strictly after ``after`` (or from the start if None)
        through ``upto`` inclusive, on NHWC input."""
        state = state or {}
        splices = self._splices(splice)
        start = 0 if after is None else self.index_of(after) + 1
        end = self.index_of(upto)
        h = _to_internal(x)
        for st in self.stages[start : end + 1]:
            h = st.apply(params.get(st.name), state.get(st.name), h)
            if st.name in splices:
                h = _to_internal(splices[st.name](_to_public(h)))
        return _to_public(h)
