"""A small module system in plain JAX.

The models are written against flax.linen's calling convention, which this
file provides with nothing but ``jax``:

- a ``Module`` is a dataclass of hyper-parameters; calling one of its public
  methods inside ``init``/``apply`` runs it in a *scope* named after the
  module (an explicit ``name=``, the attribute it was assigned to in
  ``setup``, or ``ClassName_<n>`` in call order within the parent call);
- ``init(rng, *args)`` returns the variable collections it created, e.g.
  ``{"params": ..., "batch_stats": ...}``;
- ``apply(variables, *args, mutable=[...])`` returns the output, plus the
  updated mutable collections when ``mutable`` is given.

So the parameter trees keep flax's names (``encoder/ResNet_0/layer1_0/
Conv_0/kernel``, ``projector/Dense_0``, ``BatchNorm_0/mean``), which the
checkpoint hand-off (`core/checkpoint.py`) and the tensor-parallel rules
(`parallel/tp.py`) address by path.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu

_TLS = threading.local()


def _runs() -> list:
    if not hasattr(_TLS, "runs"):
        _TLS.runs = []
    return _TLS.runs


def _fold_static(key: jax.Array, parts: Tuple) -> jax.Array:
    """Fold a scope path and a call count into ``key``: one ``fold_in`` of
    the SHA-1 of the parts, as flax.linen derives its RNGs, so a model
    initializes to the same values as its flax original."""
    m = hashlib.sha1()
    for x in parts:
        m.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def _get_subtree(tree: dict, path: Tuple[str, ...]) -> Optional[dict]:
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _make_subtree(tree: dict, path: Tuple[str, ...]) -> dict:
    for k in path:
        tree = tree.setdefault(k, {})
    return tree


def _copy_dicts(tree):
    """Copy the dict structure (not the leaves), so writes stay local."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Run:
    """One ``init`` or ``apply``: the collections it reads and writes."""

    def __init__(self, variables: dict, rngs: dict, initializing: bool, mutable):
        self.variables = variables
        self.rngs = rngs
        self.initializing = initializing
        self.mutable = mutable  # set of collection names, or True (all)
        self.frames: list = []
        self.setup_done: set = set()
        self.rng_counts: dict = {}  # (stream, scope path) -> keys drawn

    def next_key(self, stream: str, path: Tuple[str, ...]) -> jax.Array:
        n = self.rng_counts[(stream, path)] = self.rng_counts.get((stream, path), 0) + 1
        return _fold_static(self.rngs[stream], path + (n,))

    def is_mutable(self, collection: str) -> bool:
        return self.mutable is True or collection in self.mutable


class _Frame:
    """One module call: its scope path and the auto-name counters of the
    submodules it creates."""

    def __init__(self, module: "Module", path: Tuple[str, ...]):
        self.module = module
        self.path = path
        self.counts: dict = {}
        self.auto: dict = {}

    def name_of(self, child: "Module") -> str:
        if child.name is not None:
            return child.name
        # the entry holds the child, so its id is not reused within the call
        _, name = self.auto.get(id(child), (None, None))
        if name is None:
            cls = type(child).__name__
            i = self.counts.get(cls, 0)
            self.counts[cls] = i + 1
            name = f"{cls}_{i}"
            self.auto[id(child)] = (child, name)
        return name


def _enter(run: _Run, module: "Module", fn, path, args, kwargs):
    run.frames.append(_Frame(module, path))
    try:
        key = (id(module), path)
        if key not in run.setup_done:
            run.setup_done.add(key)
            module.setup()
        return fn(module, *args, **kwargs)
    finally:
        run.frames.pop()


def _remat_call(run: _Run, module: "Module", fn, path, args, kwargs):
    """Run a module call under ``jax.checkpoint``: its variables go in as
    arguments and its updated mutable collections come back as outputs,
    so the call is a pure function of what it reads."""
    colls = {}
    for c, tree in run.variables.items():
        sub = _get_subtree(tree, path)
        if sub is not None:
            colls[c] = sub
    arr_idx = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

    def body(colls_in, *arrays):
        a = list(args)
        for i, v in zip(arr_idx, arrays):
            a[i] = v
        nested = {}
        for c, sub in colls_in.items():
            root: dict = {}
            if path:
                _make_subtree(root, path[:-1])[path[-1]] = sub
            else:
                root = sub
            nested[c] = root
        inner = _Run(nested, run.rngs, False, run.mutable)
        _runs().append(inner)
        try:
            out = _enter(inner, module, fn, path, a, kwargs)
        finally:
            _runs().pop()
        new = {c: _get_subtree(inner.variables[c], path)
               for c in colls_in if run.is_mutable(c)}
        return out, new

    out, new = jax.checkpoint(body)(colls, *[args[i] for i in arr_idx])
    for c, sub in new.items():
        parent = _make_subtree(run.variables[c], path[:-1])
        parent[path[-1]] = sub
    return out


def _scoped(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        runs = _runs()
        if not runs:
            raise RuntimeError(
                f"{type(self).__name__}.{fn.__name__} must run inside init() or apply()")
        run = runs[-1]
        parent = run.frames[-1] if run.frames else None
        if parent is not None and parent.module is self:
            return fn(self, *args, **kwargs)  # a method calling its sibling
        path = () if parent is None else parent.path + (parent.name_of(self),)
        if self._remat and not run.initializing:
            return _remat_call(run, self, fn, path, args, kwargs)
        return _enter(run, self, fn, path, args, kwargs)

    wrapped._scoped = True
    return wrapped


class _Variable:
    """A handle on one variable of a collection, read and written by ``value``."""

    def __init__(self, run: _Run, collection: str, path, name: str):
        self._run, self._collection, self._path, self._name = run, collection, path, name

    @property
    def value(self):
        return _get_subtree(self._run.variables[self._collection], self._path)[self._name]

    @value.setter
    def value(self, v):
        if not self._run.is_mutable(self._collection):
            raise ValueError(
                f"collection {self._collection!r} is not mutable; pass "
                f"mutable=[{self._collection!r}] to apply()")
        _make_subtree(self._run.variables[self._collection], self._path)[self._name] = v


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses declare their hyper-parameters as annotated
    fields and become dataclasses; every public method and ``__call__`` runs
    in the module's scope."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)
    _remat = False

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        fields = cls.__dict__.get("__annotations__", {})
        for attr, fn in list(vars(cls).items()):
            public = attr == "__call__" or not attr.startswith("_")
            if (public and attr != "setup" and attr not in fields and callable(fn)
                    and not isinstance(fn, type) and not getattr(fn, "_scoped", False)):
                setattr(cls, attr, _scoped(fn))
        dataclasses.dataclass(eq=False)(cls)

    def __setattr__(self, key, value):
        # submodules assigned in setup() take the attribute's name
        if isinstance(value, Module) and value.name is None and not key.startswith("_"):
            object.__setattr__(value, "name", key)
        object.__setattr__(self, key, value)

    def setup(self) -> None:
        """Create submodules as attributes (runs once per scope)."""

    # -- inside a call -------------------------------------------------------
    def _frame(self) -> Tuple[_Run, _Frame]:
        run = _runs()[-1]
        frame = run.frames[-1]
        if frame.module is not self:
            raise RuntimeError(f"{type(self).__name__} variables accessed outside its call")
        return run, frame

    def is_initializing(self) -> bool:
        return _runs()[-1].initializing

    def variable(self, collection: str, name: str, init_fn: Callable, *init_args) -> _Variable:
        run, frame = self._frame()
        tree = run.variables.get(collection)
        sub = None if tree is None else _get_subtree(tree, frame.path)
        if sub is None or name not in sub:
            if not run.initializing:
                raise KeyError(f"missing variable {collection}/{'/'.join(frame.path + (name,))}")
            _make_subtree(run.variables.setdefault(collection, {}), frame.path)[name] = init_fn(*init_args)
        return _Variable(run, collection, frame.path, name)

    def param(self, name: str, init_fn: Callable, *init_args):
        run, frame = self._frame()
        tree = run.variables.get("params")
        sub = None if tree is None else _get_subtree(tree, frame.path)
        if sub is not None and name in sub:
            return sub[name]
        if not run.initializing:
            raise KeyError(f"missing param {'/'.join(frame.path + (name,))}")
        value = init_fn(run.next_key("params", frame.path), *init_args)
        _make_subtree(run.variables.setdefault("params", {}), frame.path)[name] = value
        return value

    def make_rng(self, stream: str) -> jax.Array:
        run, frame = self._frame()
        return run.next_key(stream, frame.path)

    # -- entry points --------------------------------------------------------
    def _run(self, run: _Run, method, args, kwargs):
        fn = type(self).__call__ if method is None else method
        _runs().append(run)
        try:
            return fn(self, *args, **kwargs)
        finally:
            _runs().pop()

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        """Create the variables by running ``method`` (default ``__call__``)."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        run = _Run({}, rngs, initializing=True, mutable=True)
        self._run(run, method, args, kwargs)
        return {c: t for c, t in run.variables.items() if t}

    def apply(self, variables: dict, *args, method=None, mutable=False, rngs=None, **kwargs):
        """Run ``method`` (default ``__call__``) with ``variables``. With
        ``mutable`` (a collection name or a list of them), also return the
        updated collections."""
        if isinstance(mutable, str):
            mutable = [mutable]
        mutable = set(mutable or ())
        variables = {c: (_copy_dicts(t) if c in mutable else t) for c, t in variables.items()}
        run = _Run(variables, dict(rngs or {}), initializing=False, mutable=mutable)
        out = self._run(run, method, args, kwargs)
        if not mutable:
            return out
        return out, {c: run.variables[c] for c in sorted(mutable) if c in run.variables}


def remat(module_cls):
    """The same module, its calls rematerialized in the backward pass."""
    if isinstance(module_cls, functools.partial):
        return functools.partial(remat(module_cls.func), *module_cls.args, **module_cls.keywords)
    return type(module_cls.__name__, (module_cls,), {"_remat": True})


def _pairs(v, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init, (x.shape[-1], self.features), self.param_dtype)
        dt = self.dtype or jnp.result_type(x.dtype, self.param_dtype)
        y = lax.dot_general(x.astype(dt), kernel.astype(dt), (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,), self.param_dtype).astype(dt)
        return y


class Conv(Module):
    """N-d convolution over channels-last inputs (NHWC, NDHWC)."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    padding: Union[int, str, Sequence[Tuple[int, int]]] = "SAME"
    use_bias: bool = True
    feature_group_count: int = 1
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        nd = len(self.kernel_size)
        kernel = self.param(
            "kernel", self.kernel_init,
            (*self.kernel_size, x.shape[-1] // self.feature_group_count, self.features),
            self.param_dtype)
        padding = self.padding
        if isinstance(padding, int):
            padding = ((padding, padding),) * nd
        dt = self.dtype or jnp.result_type(x.dtype, self.param_dtype)
        spatial = tuple(range(1, nd + 1))
        dn = lax.ConvDimensionNumbers(
            lhs_spec=(0, nd + 1, *spatial), rhs_spec=(nd + 1, nd, *range(nd)),
            out_spec=(0, nd + 1, *spatial))
        y = lax.conv_general_dilated(
            x.astype(dt), kernel.astype(dt), _pairs(self.strides, nd), padding,
            dimension_numbers=dn, feature_group_count=self.feature_group_count)
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,), self.param_dtype).astype(dt)
        return y


class BatchNorm(Module):
    """Batch normalization over every axis but the last, statistics in
    float32. Under ``jit`` with the batch sharded, the statistics are global
    (synchronized BatchNorm)."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        feat = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean", jnp.zeros, feat, jnp.float32)
        ra_var = self.variable("batch_stats", "var", jnp.ones, feat, jnp.float32)
        scale = self.param("scale", initializers.ones, feat, self.param_dtype)
        bias = self.param("bias", initializers.zeros, feat, self.param_dtype)
        if self.use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            axes = tuple(range(x.ndim - 1))
            xf = x.astype(jnp.float32)
            mean = jnp.mean(xf, axes)
            var = jnp.maximum(0.0, jnp.mean(jnp.square(xf), axes) - jnp.square(mean))
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1.0 - m) * mean
                ra_var.value = m * ra_var.value + (1.0 - m) * var
        y = (x.astype(jnp.float32) - mean) * (lax.rsqrt(var + self.epsilon) * scale) + bias
        return y.astype(self.dtype or jnp.result_type(x.dtype, self.param_dtype))


class GroupNorm(Module):
    """Group normalization: per sample, over the spatial axes and the
    channels of each group, statistics in float32."""

    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32

    def __call__(self, x):
        c = x.shape[-1]
        g = self.num_groups
        if c % g:
            raise ValueError(f"{c} channels do not split into {g} groups")
        scale = self.param("scale", initializers.ones, (c,), self.param_dtype)
        bias = self.param("bias", initializers.zeros, (c,), self.param_dtype)
        xf = x.astype(jnp.float32).reshape(*x.shape[:-1], g, c // g)
        axes = tuple(range(1, xf.ndim - 2)) + (xf.ndim - 1,)
        mean = jnp.mean(xf, axes, keepdims=True)
        var = jnp.maximum(0.0, jnp.mean(jnp.square(xf), axes, keepdims=True) - jnp.square(mean))
        y = ((xf - mean) * lax.rsqrt(var + self.epsilon)).reshape(x.shape)
        y = y * scale + bias
        return y.astype(self.dtype or jnp.result_type(x.dtype, self.param_dtype))


class Dropout(Module):
    rate: float
    deterministic: bool = False

    def __call__(self, x):
        if self.deterministic or self.rate == 0.0:
            return x
        keep = jax.random.bernoulli(self.make_rng("dropout"), 1.0 - self.rate, x.shape)
        return jnp.where(keep, x / (1.0 - self.rate), jnp.zeros_like(x))


def max_pool(x, window: Sequence[int], strides: Sequence[int], padding):
    """Max pooling over the spatial axes of a channels-last array."""
    pad = padding if isinstance(padding, str) else ((0, 0), *padding, (0, 0))
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, *window, 1), (1, *strides, 1), pad)
