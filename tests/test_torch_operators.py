"""Port DS operators: the torch device backend (on the CPU) vs the JAX
package's device backend and vs the port's numpy host backend; the port's
host backend vs the reference's host backend."""

import numpy as np
import pytest
import torch

from repro.pipeline import operators as ref_ops
from repro_torch.convert import from_reference, to_numpy
from repro_torch.kernels.kmeans import kmeans_assign
from repro_torch.kernels.window_agg import window_agg
from repro_torch.pipeline import operators as ops

TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (96, 6)).astype(np.float32)
    a[5, 3] = np.nan
    return a


def _args(op, x):
    clean = np.nan_to_num(x)
    if op in ("ingest", "clean_missing"):
        return (x,)
    if op == "train_cluster":
        return (clean, clean[:4])
    if op == "score":
        w, b = ref_ops.host_backend("linreg")(clean)
        return (clean, w, b)
    if op == "join":
        return (x[:8], x[:4, :2])
    return (clean,)


def _flat(res):
    return res if isinstance(res, tuple) else (res,)


def test_same_operator_catalogue():
    assert ops.OPERATORS == ref_ops.OPERATORS


@pytest.mark.parametrize("op", ref_ops.OPERATORS)
def test_device_backend_matches_jax_and_host(op, x):
    args = _args(op, x)
    dev = ops.device_backend(op)(*from_reference(args, "cpu"))
    jax_dev = ref_ops.device_backend(op)(*args)
    host = ops.host_backend(op)(*args)
    got = _flat(to_numpy(dev))
    for want in (_flat(jax_dev), _flat(host)):
        assert len(got) == len(want)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("op", ref_ops.OPERATORS)
def test_host_backend_is_the_reference_host_backend(op, x):
    args = _args(op, x)
    got = _flat(ops.host_backend(op)(*args))
    want = _flat(ref_ops.host_backend(op)(*args))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_device_kmeans_and_window_go_through_the_kernel_wrappers(x, monkeypatch):
    calls = {"kmeans_assign": 0, "window_agg": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return wrapped

    monkeypatch.setattr(ops, "kmeans_assign", counting("kmeans_assign", kmeans_assign))
    monkeypatch.setattr(ops, "window_agg", counting("window_agg", window_agg))
    t = torch.from_numpy(np.nan_to_num(x))
    ops.device_backend("sweep_clustering")(t[:, :2].contiguous())
    ops.device_backend("train_cluster")(t, t[:4].clone())
    ops.device_backend("window_agg")(t, window=8)
    ops.device_backend("anomaly")(t, window=16)
    assert calls == {"kmeans_assign": 4 * 10 + 20, "window_agg": 3}


def test_device_median_refuses_nothing_quantile_would():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 8):
        v = rng.normal(0, 1, (n, 3)).astype(np.float32)
        got = ops.device_backend("summarize")(torch.from_numpy(v))[4].numpy()
        np.testing.assert_allclose(got, np.quantile(v, 0.5, axis=0), rtol=1e-6)
