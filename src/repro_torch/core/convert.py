"""Carry state across packages: the JAX package's state tuples (with numpy
leaves, e.g. from ``jax.device_get``) to the port's tuples on a device, the
port's tuples back to numpy, and a leaf-by-leaf comparison.

The tuples are matched by class name and field name (``SimState``,
``HostState``, ...), so this module needs nothing of the JAX package: the
caller hands it numpy leaves.  The JAX ``SimState.rng`` leaf has no
counterpart in the port and is dropped.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import (
    ContainerState, HostState, NetState, PolicyParams, RunParams, SchedState,
    SimState, TickMetrics, resolve_device,
)

PORT_TYPES = {cls.__name__: cls for cls in (
    SimState, HostState, ContainerState, NetState, SchedState, PolicyParams,
    RunParams, TickMetrics)}
DROPPED_FIELDS = {"rng"}


def _is_tuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def to_torch(obj, device=None):
    """The port's counterpart of ``obj`` (a state tuple with numpy leaves)
    on ``device``; leaves keep their dtype."""
    device = resolve_device(device)
    if _is_tuple(obj):
        cls = PORT_TYPES[type(obj).__name__]
        return cls(**{f: to_torch(getattr(obj, f), device)
                      for f in cls._fields})
    return torch.tensor(np.asarray(obj), device=device)


def to_numpy(obj):
    """``obj`` (a port state tuple) with every leaf as a numpy array."""
    if _is_tuple(obj):
        return type(obj)(*(to_numpy(x) for x in obj))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _leaf(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_state_close(a, b, rtol: float = 1e-5, atol: float = 1e-4,
                       path: str = "") -> None:
    """Compare two state tuples leaf by leaf (either package, numpy or
    torch leaves): integer and bool leaves exactly, float leaves within
    ``rtol``/``atol`` (infinities must match).  Fields named in
    ``DROPPED_FIELDS`` may be missing on one side."""
    if _is_tuple(a) or _is_tuple(b):
        fa, fb = set(a._fields), set(b._fields)
        extra = (fa ^ fb) - DROPPED_FIELDS
        if extra:
            raise AssertionError(f"{path or 'state'}: fields differ: "
                                 f"{sorted(extra)}")
        for f in a._fields:
            if f in fb:
                assert_state_close(getattr(a, f), getattr(b, f), rtol, atol,
                                   f"{path}.{f}" if path else f)
        return
    x, y = _leaf(a), _leaf(b)
    if x.shape != y.shape:
        raise AssertionError(f"{path}: shape {x.shape} != {y.shape}")
    if np.issubdtype(x.dtype, np.floating) or np.issubdtype(y.dtype,
                                                            np.floating):
        np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64),
                                   rtol=rtol, atol=atol, err_msg=path)
    else:
        np.testing.assert_array_equal(x, y, err_msg=path)
