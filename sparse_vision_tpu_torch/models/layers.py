"""Stage-based sequential backbone with explicit taps and splices (port of
sparse_vision_tpu/models/layers.py).

A backbone is a sequence of named stages; ``apply`` returns ``(output, taps,
new_state)`` where ``taps[name]`` is every stage's output, and a splice
``(layer_name, fn)`` replaces a stage's output with ``fn(output)`` before the next
stage runs. A stage may return sub-taps, recorded as ``taps[f"{stage}.{sub}"]``.
``apply_segment`` runs the sub-network between two stages.

Stage contract, as the JAX package's: ``apply(params, state, x, train) -> (y,
new_state, subtaps | None)``. ``train`` only changes batch norm (batch
statistics and a running update in train mode, running statistics in eval).

Layout: the public functions take and return NHWC tensors, as the JAX package
does (taps, splice arguments, ``apply_segment`` input), so tokens keep their
(b, h, w) order. Inside, a 4-D activation is the NCHW permutation of that NHWC
memory, i.e. a ``torch.channels_last`` tensor, which is the layout cuDNN prefers;
converting at the boundary is a permutation of strides, not a copy. Token
activations ``[B, N, D]`` and vectors ``[B, D]`` pass the boundary untouched.

Stage inits follow torch's defaults: U(±1/sqrt(fan_in)) for weights and biases.
Parameters are in torch layout (conv OIHW, linear [out, in]).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


class Stage(NamedTuple):
    name: str
    init: Callable  # (generator, in_shape) -> (params | None, state | None)
    apply: Callable  # (params, state, x, train) -> (y, new_state, subtaps | None)
    out_shape: Callable  # in_shape (h, w, c), (n, d) or (d,) -> out_shape


def uniform(generator: torch.Generator, shape: tuple, bound: float) -> torch.Tensor:
    return torch.empty(shape, device=generator.device).uniform_(
        -bound, bound, generator=generator)


def state_dict_reader(sd: dict) -> Callable[[str], torch.Tensor]:
    """Key -> an f32 CPU tensor copy of ``sd[key]`` (a tensor or an array): the
    converters' reader of torchvision and HF state dicts."""
    return lambda k: torch.as_tensor(sd[k]).detach().to("cpu", torch.float32).clone()


def _to_internal(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2) if x.ndim == 4 else x


def _to_public(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.ndim == 4 else x


def fn_stage(name: str, f: Callable[[torch.Tensor], torch.Tensor],
             out_shape_fn: Callable[[tuple], tuple] = lambda s: s) -> Stage:
    """A stage without parameters or state: ``f`` on the internal tensor."""
    return Stage(name, lambda gen, s: (None, None),
                 lambda params, state, x, train: (f(x), state, None), out_shape_fn)


def linear(name: str, out_features: int) -> Stage:
    def init(gen, in_shape):
        (d,) = in_shape
        bound = 1.0 / math.sqrt(d)
        return {"w": uniform(gen, (out_features, d), bound),
                "b": uniform(gen, (out_features,), bound)}, None

    def apply(params, state, x, train):
        return F.linear(x, params["w"], params["b"]), state, None

    return Stage(name, init, apply, lambda s: (out_features,))


def relu(name: str) -> Stage:
    return fn_stage(name, torch.relu)


def flatten(name: str) -> Stage:
    """[B, ...] -> [B, prod(...)], flattening a 4-D activation in NHWC order as
    the JAX stage does, so a following linear layer reads the same features."""
    return fn_stage(name, lambda x: _to_public(x).reshape(x.shape[0], -1),
                    lambda s: (math.prod(s),))


def conv_out(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


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

    def apply(params, state, x, train):
        return F.conv2d(x, params["w"], params.get("b"), stride, padding), state, None

    def out_shape(s):
        h, w, _ = s
        return conv_out(h, kernel, stride, padding), conv_out(w, kernel, stride, padding), out_ch

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

    def out_shape(s):
        h, w, c = s
        return (pool_out_dim(h, window, stride, padding, ceil_mode),
                pool_out_dim(w, window, stride, padding, ceil_mode), c)

    return fn_stage(name, lambda x: F.max_pool2d(x, window, stride, padding,
                                                 ceil_mode=ceil_mode), out_shape)


def global_avgpool(name: str) -> Stage:
    return fn_stage(name, lambda x: x.mean(dim=(2, 3)), lambda s: (s[-1],))


def bn_init(c: int, device) -> tuple:
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def bn_apply(p: dict, s: dict, x: torch.Tensor, train: bool, eps: float,
             momentum: float = 0.1) -> tuple:
    """Batch norm over the channel axis (dim 1 of an internal NCHW or [B, C]
    tensor, the last of a [B, N, D] one) with torch's semantics: in train mode
    the batch statistics (biased variance) normalize and the running statistics
    move by ``momentum`` toward them (the unbiased variance); in eval the
    running statistics normalize. Returns (y, new_state)."""
    if x.ndim == 3:
        y, new_s = _bn_channels_first(p, s, x.transpose(1, 2), train, eps, momentum)
        return y.transpose(1, 2), new_s
    return _bn_channels_first(p, s, x, train, eps, momentum)


def _bn_channels_first(p, s, x, train, eps, momentum):
    if not train:
        return F.batch_norm(x, s["mean"], s["var"], p["scale"], p["bias"], training=False,
                            eps=eps), s
    # differentiable through the batch statistics; the running ones move in
    # copies of the state, which torch updates in place
    new_s = {"mean": s["mean"].clone(), "var": s["var"].clone()}
    y = F.batch_norm(x, new_s["mean"], new_s["var"], p["scale"], p["bias"], training=True,
                     momentum=momentum, eps=eps)
    return y, new_s


def batchnorm(name: str, eps: float = 1e-5, momentum: float = 0.1) -> Stage:
    """BatchNorm over the channel axis (bn_apply)."""

    def init(gen, in_shape):
        return bn_init(in_shape[-1], gen.device)

    def apply(params, state, x, train):
        y, new_state = bn_apply(params, state, x, train, eps, momentum)
        return y, new_state, None

    return Stage(name, init, apply, lambda s: s)


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
              train: bool = False, splice=None, stop_at: Optional[str] = None):
        """Run the network on NHWC input. Returns (output, taps, new_state); taps
        hold every stage's (possibly spliced) output in NHWC, the value the next
        stage consumes, and each stage's sub-taps as ``"{stage}.{sub}"``.
        ``splice`` is a ``(layer_name, fn)`` pair or a dict of them; ``train``
        runs batch norm on batch statistics and updates the running ones in
        ``new_state``."""
        state = state or {}
        splices = self._splices(splice)
        taps = {}
        new_state = dict(state)
        h = _to_internal(x)
        for st in self.stages:
            h, ns, subtaps = st.apply(params.get(st.name), state.get(st.name), h, train)
            if ns is not None and st.name in state:
                new_state[st.name] = ns
            if st.name in splices:
                h = _to_internal(splices[st.name](_to_public(h)))
            taps[st.name] = _to_public(h)
            for sub, v in (subtaps or {}).items():
                taps[f"{st.name}.{sub}"] = _to_public(v)
            if stop_at is not None and st.name == stop_at:
                break
        return _to_public(h), taps, new_state

    def apply_segment(self, params: dict, x: torch.Tensor, after: Optional[str],
                      upto: str, state: Optional[dict] = None, splice=None) -> torch.Tensor:
        """Run the stages strictly after ``after`` (or from the start if None)
        through ``upto`` inclusive, on NHWC input, in eval mode."""
        state = state or {}
        splices = self._splices(splice)
        start = 0 if after is None else self.index_of(after) + 1
        end = self.index_of(upto)
        h = _to_internal(x)
        for st in self.stages[start : end + 1]:
            h, _, _ = st.apply(params.get(st.name), state.get(st.name), h, False)
            if st.name in splices:
                h = _to_internal(splices[st.name](_to_public(h)))
        return _to_public(h)
