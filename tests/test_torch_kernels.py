"""Port kernels (plain versions on the CPU) vs the JAX package's Pallas
kernels (interpret mode) and their jnp oracles. The CUDA kernels are held
against the plain versions on the card in test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.kmeans import kmeans_assign as jax_kmeans_assign
from repro.kernels.kmeans import kmeans_assign_ref as jax_kmeans_assign_ref
from repro.kernels.window_agg import window_agg as jax_window_agg
from repro.kernels.window_agg import window_agg_ref as jax_window_agg_ref
from repro_torch.kernels.kmeans import kmeans_assign
from repro_torch.kernels.kmeans.ops import STAGE_BYTES, centroid_chunk
from repro_torch.kernels.window_agg import window_agg, window_agg_ref
from repro_torch.kernels.window_agg.ops import SMEM_BYTES, TILE_ELEMS, tile_rows

KMEANS_CASES = [(100, 8, 4), (512, 16, 7), (1000, 3, 13), (64, 128, 32), (8, 2, 2)]
WINDOW_CASES = [
    (100, 4, 8, "mean"),
    (256, 3, 16, "sum"),
    (300, 5, 7, "max"),
    (64, 2, 64, "mean"),
    (128, 1, 1, "max"),
    (40, 2, 5, "sum"),
]


@pytest.mark.parametrize("N,D,K", KMEANS_CASES)
def test_kmeans_assign_matches_jax(N, D, K):
    rng = np.random.default_rng(N * 1000 + K)
    x = rng.normal(0, 1, (N, D)).astype(np.float32)
    c = rng.normal(0, 1, (K, D)).astype(np.float32)
    a, d2 = kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert a.dtype == torch.int32 and d2.dtype == torch.float32
    for ja, jd in (
        jax_kmeans_assign(jnp.asarray(x), jnp.asarray(c), block_n=64),
        jax_kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c)),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_allclose(d2.numpy(), np.asarray(jd), rtol=1e-3, atol=1e-3)


def test_kmeans_assign_first_index_wins_ties():
    x = torch.zeros((3, 2))
    c = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    a, d2 = kmeans_assign(x, c)
    assert a.tolist() == [0, 0, 0]
    assert d2.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("S,C,w,agg", WINDOW_CASES)
def test_window_agg_matches_jax(S, C, w, agg):
    rng = np.random.default_rng(S * 10 + C)
    x = rng.normal(0, 1, (S, C)).astype(np.float32)
    out = window_agg(torch.from_numpy(x), window=w, agg=agg)
    assert out.dtype == torch.float32 and out.shape == (S, C)
    for ref in (
        jax_window_agg(jnp.asarray(x), window=w, agg=agg, block_s=64),
        jax_window_agg_ref(jnp.asarray(x), window=w, agg=agg),
    ):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_centroid_chunk_fits_shared_memory():
    assert centroid_chunk(6, 2) == 6
    assert centroid_chunk(300, 64) == STAGE_BYTES // (4 * 64) == 192
    assert centroid_chunk(3, STAGE_BYTES // 4 + 1) == 0  # one row too big


def test_tile_rows_and_window_limit():
    assert tile_rows(500_000, 4, 16) == TILE_ELEMS // 4
    assert tile_rows(10, 4, 4) == 10
    c = 1000
    big_w = SMEM_BYTES // (4 * c)  # halo of big_w - 1 rows leaves one row
    assert tile_rows(10_000, c, big_w) == 1
    with pytest.raises(ValueError, match="shared memory"):
        tile_rows(10_000, c, big_w + 1)
    with pytest.raises(ValueError, match="shared memory"):
        window_agg(torch.zeros((10_000, c)), window=big_w + 1)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((8, 2))
    with pytest.raises(TypeError):
        kmeans_assign(x.double(), x.double())
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros((3, 4)))
    with pytest.raises(ValueError):
        kmeans_assign(x.T, torch.zeros((3, 8)))  # not contiguous
    with pytest.raises(TypeError):
        window_agg(x.double(), window=2)
    with pytest.raises(ValueError):
        window_agg(x, window=2, agg="median")


def test_cpu_path_counts_no_launches():
    before = (kmeans_assign.launches, window_agg.launches)
    kmeans_assign(torch.zeros((8, 2)), torch.ones((2, 2)))
    window_agg(torch.zeros((8, 2)), window=2)
    assert (kmeans_assign.launches, window_agg.launches) == before


def test_window_agg_plain_version_sums_in_float64():
    """At 500,000 rows the float32 prefix-sum form drifts; the plain
    version's float64 sums stay at the direct float32 sum's accuracy."""
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 1, (200_000, 1)) ** 2).astype(np.float32)
    out = window_agg_ref(torch.from_numpy(x), window=16, agg="mean").numpy()
    direct = np.lib.stride_tricks.sliding_window_view(x[:, 0].astype(np.float64), 16)
    np.testing.assert_allclose(out[15:, 0], direct.mean(1), rtol=1e-6, atol=1e-6)
