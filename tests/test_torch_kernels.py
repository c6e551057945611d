"""Port kernels (plain versions on the CPU) vs the JAX package's Pallas
kernels (interpret mode) and their jnp oracles. The CUDA kernels are held
against the plain versions on the card in test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.kmeans import kmeans_assign as jax_kmeans_assign
from repro.kernels.kmeans import kmeans_assign_ref as jax_kmeans_assign_ref
from repro.kernels.window_agg import window_agg as jax_window_agg
from repro.kernels.window_agg import window_agg_ref as jax_window_agg_ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.ops import decode_variant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import flash_variant, padded_head_dim
from repro_torch.kernels.kmeans import kmeans_assign
from repro_torch.kernels.kmeans.ops import STAGE_BYTES, centroid_chunk
from repro_torch.kernels.window_agg import window_agg, window_agg_ref
from repro_torch.kernels.window_agg.ops import SMEM_BYTES, TILE_ELEMS, tile_rows, window_plan

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
    # past the general kernel's limit the wrapper still answers (the card
    # takes the global kernel; the CPU the plain version)
    x = torch.arange(10_000 * c, dtype=torch.float32).reshape(10_000, c) % 7
    out = window_agg(x, window=big_w + 1, agg="max")
    assert torch.equal(out, window_agg_ref(x, window=big_w + 1, agg="max"))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((8, 2))
    with pytest.raises(TypeError):
        kmeans_assign(x.double(), x.double())
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros((3, 4)))
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


# -- inputs the JAX wrappers take: any strides, any window, any head dim ------


def _f1_x():
    return np.random.default_rng(11).normal(0, 1, (1000, 8)).astype(np.float32)


def test_kmeans_assign_takes_a_column_slice_as_jax_does():
    x = _f1_x()
    c = np.random.default_rng(12).normal(0, 1, (5, 2)).astype(np.float32)
    view = torch.from_numpy(x)[:, :2]
    assert not view.is_contiguous()
    a, d2 = kmeans_assign(view, torch.from_numpy(c))
    ja, jd = jax_kmeans_assign(jnp.asarray(x[:, :2]), jnp.asarray(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_window_agg_takes_a_column_slice_as_jax_does(agg):
    x = _f1_x()
    view = torch.from_numpy(x)[:, :4]
    assert not view.is_contiguous()
    out = window_agg(view, window=4, agg=agg)
    want = jax_window_agg(jnp.asarray(x[:, :4]), window=4, agg=agg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_window_agg_takes_a_halo_over_shared_memory_as_jax_does(agg):
    """(300, 1000) at window 100: 400,000 bytes of halo, past a block's
    shared memory. The card takes the global kernel; here the plain
    version answers as the JAX wrapper does (it grows its block to the
    window)."""
    x = np.random.default_rng(13).normal(0, 1, (300, 1000)).astype(np.float32)
    assert window_plan(300, 1000, 100, agg, 1 << 20).variant == "global"
    out = window_agg(torch.from_numpy(x), window=100, agg=agg)
    want = jax_window_agg(jnp.asarray(x), window=100, agg=agg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def _attention_inputs(shapes, dtype, seed):
    """numpy normals as (JAX, torch) pairs of the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.normal(0, 1, shape), jdt)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)))
    return out


def _attention_tol(dtype):
    # tests/test_kernels.py:17
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_head_dim_288_as_jax_does(dtype):
    assert flash_variant(288) == "wide" and flash_variant(256) == "tile"
    assert padded_head_dim(288, torch.bfloat16) == 288  # the wide kernel pads nothing
    (qj, q), (kj, k), (vj, v) = _attention_inputs(
        [(1, 40, 4, 288), (1, 40, 2, 288), (1, 40, 2, 288)], dtype, 14
    )
    out = flash_attention(q, k, v, causal=True, window=16, softcap=30.0)
    want = jax_flash_attention(qj, kj, vj, causal=True, window=16, softcap=30.0)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(want.astype(jnp.float32)), **_attention_tol(dtype)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_takes_head_dim_288_as_jax_does(dtype):
    assert decode_variant(288) == "wide" and decode_variant(256) == "split"
    (qj, q), (kj, k), (vj, v) = _attention_inputs(
        [(2, 4, 288), (2, 50, 2, 288), (2, 50, 2, 288)], dtype, 15
    )
    valid = np.random.default_rng(16).random((2, 50)) > 0.3
    out = decode_attention(q, k, v, torch.from_numpy(valid), softcap=20.0)
    want = jax_decode_attention(qj, kj, vj, jnp.asarray(valid), softcap=20.0)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(want.astype(jnp.float32)), **_attention_tol(dtype)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_a_transposed_q_as_jax_does(dtype):
    """q made (B, H, S, D) and handed over as its (B, S, H, D) transpose;
    k and v as views too."""
    (qj, q), (kj, k), (vj, v) = _attention_inputs(
        [(1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)], dtype, 17
    )
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    assert not qt.is_contiguous()
    out = flash_attention(qt, kt, vt, causal=True)
    want = jax_flash_attention(*(x.transpose(0, 2, 1, 3) for x in (qj, kj, vj)), causal=True)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(want.astype(jnp.float32)), **_attention_tol(dtype)
    )
