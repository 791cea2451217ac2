"""The small module system the models are written in.

It covers exactly the part of ``flax.linen`` this package used, and keeps
flax's conventions so that parameter trees, initial values and outputs are
the same as flax's for the same inputs and keys:

- a module is a dataclass; its children are created in ``setup()`` (named
  by the attribute they are assigned to) or inside a method (named by the
  ``name=`` argument, else ``ClassName_<i>``, counted per class and per
  call of the parent);
- ``init(rngs, *args, method=...)`` returns ``{"params": tree}``;
  ``apply(variables, *args, rngs=..., method=...)`` runs a method, given as
  an unbound method, a name, or a function of the bound module;
- the key of every parameter and of every ``make_rng`` call is flax's:
  the root key of its stream, folded with the first 4 bytes of the SHA-1
  of the module path and a per-module call counter;
- the layers ``Conv``, ``ConvTranspose``, ``Dense``, ``GroupNorm``,
  ``LayerNorm`` and ``Dropout`` and ``max_pool`` have flax's parameter names,
  shapes, default initialisers and sequence of operations.

``compact`` is only a marker: children may be created in any method.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import inspect
import threading
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers
Dtype = Any

_CONTEXT = threading.local()


def _module_stack() -> list:
    """The modules whose methods are running in this thread, innermost last."""
    if not hasattr(_CONTEXT, "stack"):
        _CONTEXT.stack = []
    return _CONTEXT.stack


def compact(fn: Callable) -> Callable:
    return fn


def _fold_in_path(key: jax.Array, path: tuple) -> jax.Array:
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


class _Frame:
    """The state of one ``init`` or ``apply`` call."""

    def __init__(self, params: dict, rngs: dict, initializing: bool):
        self.params = params
        self.rngs = rngs
        self.initializing = initializing
        self.rng_counts: dict = {}


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._frame is None:
            raise RuntimeError(
                f"{type(self).__name__} is unbound: call it through init or apply"
            )
        self._ensure_setup()
        stack = _module_stack()
        if not any(m is self for m in stack):
            self._child_counts.clear()  # each outer call names children anew
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


@dataclasses.dataclass(eq=True, unsafe_hash=True)
class Module:
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = vars(cls).get("__annotations__", {})
        for attr, value in list(vars(cls).items()):
            if inspect.isfunction(value) and attr not in fields and attr != "setup" and (
                attr == "__call__" or not attr.startswith("_")
            ):
                setattr(cls, attr, _wrap_method(value))
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True)

    def __post_init__(self):
        for attr, value in (
            ("_frame", None), ("_path", ()), ("_child_counts", {}),
            ("_setup_done", False), ("_in_setup", False),
        ):
            object.__setattr__(self, attr, value)
        stack = _module_stack()
        if stack and not stack[-1]._in_setup:
            parent = stack[-1]
            if self.name is None:
                prefix = type(self).__name__
                i = parent._child_counts.get(prefix, 0)
                parent._child_counts[prefix] = i + 1
                object.__setattr__(self, "name", f"{prefix}_{i}")
            parent._adopt(self, self.name)

    def __setattr__(self, attr, value):
        if isinstance(value, Module) and getattr(self, "_in_setup", False):
            self._adopt(value, attr)
        object.__setattr__(self, attr, value)

    def _adopt(self, child: "Module", name: str) -> None:
        object.__setattr__(child, "name", name)
        object.__setattr__(child, "_frame", self._frame)
        object.__setattr__(child, "_path", self._path + (name,))

    def _ensure_setup(self) -> None:
        if self._setup_done:
            return
        object.__setattr__(self, "_setup_done", True)
        object.__setattr__(self, "_in_setup", True)
        stack = _module_stack()
        stack.append(self)
        try:
            self.setup()
        finally:
            stack.pop()
            object.__setattr__(self, "_in_setup", False)

    def setup(self) -> None:
        pass

    # ------------------------------------------------------------ variables
    def param(self, name: str, init_fn: Callable, *init_args) -> jax.Array:
        """The parameter ``name`` of this module; created by
        ``init_fn(key, *init_args)`` while initialising. ``init_args[0]`` is
        the shape; a given parameter of another shape is an error."""
        frame = self._frame
        node = frame.params
        for p in self._path:
            if frame.initializing:
                node = node.setdefault(p, {})
            elif p not in node:
                raise KeyError(f"no parameters for module {'/'.join(self._path)}")
            else:
                node = node[p]
        if name in node:
            value = node[name]
            if tuple(jnp.shape(value)) != tuple(init_args[0]):
                raise ValueError(
                    f"parameter {'/'.join(self._path + (name,))} has shape "
                    f"{tuple(jnp.shape(value))}, the module needs {tuple(init_args[0])}"
                )
            return value
        if not frame.initializing:
            raise KeyError(f"missing parameter {'/'.join(self._path + (name,))}")
        node[name] = init_fn(self.make_rng("params"), *init_args)
        return node[name]

    def make_rng(self, stream: str = "params") -> jax.Array:
        frame = self._frame
        if stream not in frame.rngs:
            raise ValueError(
                f"module {'/'.join(self._path) or type(self).__name__} needs "
                f"an rng for {stream!r}"
            )
        counter = frame.rng_counts.get((self._path, stream), 0) + 1
        frame.rng_counts[(self._path, stream)] = counter
        return _fold_in_path(frame.rngs[stream], self._path + (counter,))

    # ------------------------------------------------------------ entry points
    def _run(self, frame: _Frame, method, args, kwargs):
        bound = copy.copy(self)
        for attr, value in (
            ("_frame", frame), ("_path", ()), ("_child_counts", {}),
            ("_setup_done", False), ("_in_setup", False),
        ):
            object.__setattr__(bound, attr, value)
        if method is None:
            method = type(self).__call__
        elif isinstance(method, str):
            method = getattr(type(self), method)
        elif inspect.ismethod(method) and isinstance(method.__self__, Module):
            method = method.__func__
        saved = _module_stack()[:]
        _CONTEXT.stack = []
        try:
            bound._ensure_setup()
            _CONTEXT.stack.append(bound)
            return method(bound, *args, **kwargs)
        finally:
            _CONTEXT.stack = saved

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, dict(rngs), initializing=True)
        self._run(frame, method, args, kwargs)
        return {"params": frame.params} if frame.params else {}

    def apply(self, variables: dict, *args, rngs: Optional[dict] = None, method=None, **kwargs):
        frame = _Frame(variables.get("params", {}), dict(rngs or {}), initializing=False)
        return self._run(frame, method, args, kwargs)


# ---------------------------------------------------------------- layers


def promote_dtype(*args, dtype: Optional[Dtype] = None):
    """Cast every non-None argument to ``dtype`` (default: their result type)."""
    if dtype is None:
        dtype = jnp.result_type(*[jnp.asarray(a) for a in args if a is not None])
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


def _tuple(x, n: int) -> tuple:
    return (x,) * n if isinstance(x, int) else tuple(x)


def _conv_dimension_numbers(ndim: int) -> lax.ConvDimensionNumbers:
    lhs = (0, ndim - 1) + tuple(range(1, ndim - 1))
    rhs = (ndim - 1, ndim - 2) + tuple(range(0, ndim - 2))
    return lax.ConvDimensionNumbers(lhs, rhs, lhs)


def _params_promoted(mdl: Module, x, kernel_shape, kernel_init, use_bias: bool, dtype):
    """The layer's ``kernel`` (and zero-initialised ``bias``), float32, then
    ``x``, kernel and bias cast to ``dtype``."""
    kernel = mdl.param("kernel", kernel_init, kernel_shape, jnp.float32)
    bias = (
        mdl.param("bias", initializers.zeros, (kernel_shape[-1],), jnp.float32)
        if use_bias
        else None
    )
    return promote_dtype(x, kernel, bias, dtype=dtype)


def _add_bias(y, bias):
    return y if bias is None else y + bias.reshape((1,) * (y.ndim - 1) + (-1,))


class Conv(Module):
    """Channels-last convolution; kernel (*kernel_size, in, features)."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = initializers.lecun_normal()

    def __call__(self, x):
        ks = tuple(self.kernel_size)
        x, kernel, bias = _params_promoted(
            self, x, ks + (x.shape[-1], self.features), self.kernel_init, self.use_bias,
            self.dtype,
        )
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides, len(ks)), self.padding,
            dimension_numbers=_conv_dimension_numbers(x.ndim),
        )
        return _add_bias(y, bias)


class ConvTranspose(Module):
    """Channels-last ``lax.conv_transpose``; kernel (*kernel_size, in, features)."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: str = "SAME"
    use_bias: bool = True
    dtype: Optional[Dtype] = None

    def __call__(self, x):
        ks = tuple(self.kernel_size)
        x, kernel, bias = _params_promoted(
            self, x, ks + (x.shape[-1], self.features), initializers.lecun_normal(),
            self.use_bias, self.dtype,
        )
        y = lax.conv_transpose(x, kernel, _tuple(self.strides, len(ks)), self.padding)
        return _add_bias(y, bias)


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None

    def __call__(self, x):
        x, kernel, bias = _params_promoted(
            self, x, (x.shape[-1], self.features), initializers.lecun_normal(),
            self.use_bias, self.dtype,
        )
        return _add_bias(lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ()))), bias)


def _normalize(mdl: Module, x, mean, var, reduction_axes, epsilon, dtype):
    """Shift, scale by rsqrt(var + eps), then the learned per-channel scale
    and bias (statistics and arithmetic in float32), cast to ``dtype``."""
    feature_shape = (1,) * (x.ndim - 1) + (x.shape[-1],)
    mean = jnp.expand_dims(mean, reduction_axes)
    var = jnp.expand_dims(var, reduction_axes)
    y = x - mean
    mul = lax.rsqrt(var + epsilon)
    scale = mdl.param("scale", initializers.ones, (x.shape[-1],), jnp.float32)
    mul *= scale.reshape(feature_shape)
    y *= mul
    bias = mdl.param("bias", initializers.zeros, (x.shape[-1],), jnp.float32)
    y += bias.reshape(feature_shape)
    if dtype is None:
        dtype = jnp.result_type(x, scale, bias)
    return jnp.asarray(y, dtype)


def _mean_var(x, axes, dtype):
    """Mean and E[x^2] - E[x]^2 variance (clipped at 0), in at least float32."""
    x = x.astype(jnp.promote_types(dtype or x.dtype, jnp.float32))
    mu = x.mean(axes)
    mu2 = lax.square(x).mean(axes)
    return mu, jnp.maximum(0.0, mu2 - lax.square(mu))


class GroupNorm(Module):
    """Normalise each sample over its spatial axes and groups of channels."""

    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None

    def __call__(self, x):
        channels = x.shape[-1]
        if channels % self.num_groups:
            raise ValueError(f"{self.num_groups} groups do not divide {channels} channels")
        group_size = channels // self.num_groups
        spatial = tuple(range(1, x.ndim - 1))
        mean, var = _mean_var(
            x.reshape(x.shape[:-1] + (self.num_groups, group_size)),
            spatial + (x.ndim,),
            self.dtype,
        )
        mean = jnp.repeat(mean, group_size, axis=-1)
        var = jnp.repeat(var, group_size, axis=-1)
        return _normalize(self, x, mean, var, spatial, self.epsilon, self.dtype)


class LayerNorm(Module):
    """Normalise over the last axis."""

    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None

    def __call__(self, x):
        mean, var = _mean_var(x, (x.ndim - 1,), self.dtype)
        return _normalize(self, x, mean, var, (x.ndim - 1,), self.epsilon, self.dtype)


class Dropout(Module):
    """Inverted dropout drawing its mask from the ``dropout`` rng stream."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        if self.rate == 0.0 or self.deterministic:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep_prob = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), p=keep_prob, shape=x.shape)
        return lax.select(mask, x / keep_prob, jnp.zeros_like(x))


def max_pool(x, window_shape: Sequence[int], strides: Sequence[int], padding="SAME"):
    """Max over windows of the spatial axes of a (batch, *spatial, channel) array."""
    dims = (1,) + tuple(window_shape) + (1,)
    return lax.reduce_window(x, -jnp.inf, lax.max, dims, (1,) + tuple(strides) + (1,), padding)
