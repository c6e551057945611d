"""Launch plans of the DS kernels (which kernel a call takes, and how), and
a numpy float32 model of the window scan kernel's order of summation.

The plans are plain Python, so the CPU checks every route; the kernels
themselves run on the card (the ``gpu`` tests here and in
test_torch_kernels_gpu.py). Imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.kmeans.ops import (
    TILED_KMAX,
    TILED_POINTS,
    TILED_THREADS,
    centroid_chunk,
    kmeans_plan,
)
from repro_torch.kernels.window_agg import window_agg, window_agg_ref
from repro_torch.kernels.window_agg.ops import (
    SCAN_BLOCK_ROWS,
    SMEM_BYTES,
    tile_rows,
    window_plan,
)

ROWS = 500_000
ALIGNED = 1 << 20  # a 16-byte aligned address
#: the pipeline's calls: sweep_clustering (D = 2) and train_cluster (D = 3);
#: window_agg (w = 8) and anomaly's two rolling means (w = 16)
PATH_KMEANS = [(ROWS, 2, k) for k in (2, 3, 4, 6)] + [(ROWS, 3, 4)]
PATH_WINDOW = [(ROWS, 4, 8, "mean"), (ROWS, 4, 16, "mean")]
#: resident blocks on an H100 for one wave: 132 SMs, 16 blocks of 128
#: threads each
ONE_WAVE = 132 * 16


@pytest.mark.parametrize("n,d,k", PATH_KMEANS)
def test_kmeans_plan_takes_the_tiled_kernel_on_the_path(n, d, k):
    plan = kmeans_plan(n, d, k, ALIGNED)
    assert plan.variant == "tiled" and plan.vector
    assert plan.kmax == (4 if k <= 4 else 8)
    threads = -(-n // TILED_POINTS)
    assert plan.blocks == -(-threads // TILED_THREADS) == 977
    assert plan.blocks <= ONE_WAVE


@pytest.mark.parametrize("n,d,k", [(4097, 64, 300), (1000, 13_000, 3), (1000, 1000, 50)])
def test_kmeans_plan_takes_the_general_kernel_beyond_the_templates(n, d, k):
    plan = kmeans_plan(n, d, k, ALIGNED)
    assert plan.variant == "general"
    assert plan.chunk_k == centroid_chunk(k, d)


@pytest.mark.parametrize("k", [1, 4, 5, 8, 9, 16, 17])
def test_kmeans_plan_bounds_k_by_the_least_template(k):
    plan = kmeans_plan(1000, 3, k, ALIGNED)
    if k > TILED_KMAX[-1]:  # just above the templates' maximum
        assert plan.variant == "general"
    else:
        assert plan.variant == "tiled" and plan.kmax == min(b for b in TILED_KMAX if b >= k)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_kmeans_plan_reads_a_misaligned_x_in_scalar_loads(d):
    assert not kmeans_plan(ROWS, d, 4, ALIGNED + 4).vector  # a 4-byte offset
    base = torch.zeros((1001, d))
    assert base.data_ptr() % 16 == 0
    view = base[1:]  # contiguous, 4 * d bytes past the allocation
    plan = kmeans_plan(1000, d, 4, view.data_ptr())
    assert plan.variant == "tiled" and plan.vector == (4 * d % 16 == 0)


@pytest.mark.parametrize("s,c,w,agg", PATH_WINDOW)
def test_window_plan_takes_the_scan_kernel_on_the_path(s, c, w, agg):
    plan = window_plan(s, c, w, agg, ALIGNED)
    assert plan.variant == "scan" and plan.w == w
    assert plan.blocks == -(-s // SCAN_BLOCK_ROWS) == 489 <= ONE_WAVE


@pytest.mark.parametrize(
    "s,c,w,why",
    [
        (1000, 1000, 50, "wide"),
        (3000, 1, 8, "C = 1"),
        (3000, 3, 8, "C = 3"),
        (3000, 5, 8, "C = 5"),
        (3000, 4, 33, "window above two chunks"),
    ],
)
def test_window_plan_takes_the_general_kernel_beyond_the_scan(s, c, w, why):
    plan = window_plan(s, c, w, "sum", ALIGNED)
    assert plan.variant == "general", why
    assert plan.tile_rows == tile_rows(s, c, plan.w)


def test_window_plan_takes_the_general_kernel_for_a_misaligned_x():
    assert window_plan(ROWS, 4, 8, "mean", ALIGNED + 4).variant == "general"
    view = torch.zeros((1001, 4))[1:]  # 16 bytes past: still aligned
    assert window_plan(1000, 4, 8, "mean", view.data_ptr()).variant == "scan"
    flat = torch.zeros(4001)[1:].view(1000, 4)  # 4 bytes past
    assert window_plan(1000, 4, 8, "mean", flat.data_ptr()).variant == "general"


@pytest.mark.parametrize("s,window", [(5, 16), (1, 8), (40, 40), (40, 100)])
def test_window_plan_clamps_the_window_to_the_rows(s, window):
    plan = window_plan(s, 4, window, "max", ALIGNED)
    assert plan.w == max(1, min(window, s))
    assert plan.variant == ("scan" if plan.w <= 32 else "general")


def test_window_plan_raises_on_a_halo_that_does_not_fit():
    c = 1000
    big_w = SMEM_BYTES // (4 * c)  # a one-row tile and its halo just fit
    assert window_plan(10_000, c, big_w, "sum", ALIGNED).tile_rows == 1
    with pytest.raises(ValueError, match="shared memory"):
        window_plan(10_000, c, big_w + 1, "sum", ALIGNED)
    with pytest.raises(ValueError, match="unknown agg"):
        window_plan(10_000, 4, 8, "median", ALIGNED)


def scan_window_model(x: np.ndarray, w: int, agg: str) -> np.ndarray:
    """The scan kernel's sum or mean in numpy float32, operation for
    operation: chunks of 32 rows, each chunk's inclusive prefix by the warp's
    Hillis-Steele scan, and S = P_m[l] - P_m[l - w] when l >= w, else
    P_m[l] + (P_{m-1}[31] - P_{m-1}[32 + l - w]); the mean divides by
    min(t + 1, w). ``w`` is the clamped window, 1 <= w <= 32."""
    s, c = x.shape
    chunks = -(-s // 32)
    p = np.zeros((chunks + 1, 32, c), np.float32)  # chunk -1 first: zeros
    p.reshape(-1, c)[32 : 32 + s] = x
    for d in (1, 2, 4, 8, 16):
        p[:, d:] = p[:, d:] + p[:, :-d]
    prev, cur = p[:-1], p[1:]
    lane = np.arange(32)
    src = (lane - w) % 32
    inside = (lane >= w)[None, :, None]
    out = np.where(inside, cur - cur[:, src], cur + (prev[:, 31:32] - prev[:, src]))
    out = out.reshape(-1, c)[:s]
    if agg == "mean":
        out = out / np.minimum(np.arange(1, s + 1), w).astype(np.float32)[:, None]
    return out


@pytest.mark.parametrize("square", [False, True], ids=["x", "x*x"])
@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_scan_order_stays_near_the_float64_plain_version(agg, w, square):
    """At the pipeline's (500,000, 4) the kernel's chunk-local prefix
    differences stay within 1e-4 of the plain version's float64 sums, on x
    and on x*x (anomaly's second moment)."""
    x = np.random.default_rng(0).normal(0, 1, (ROWS, 4)).astype(np.float32)
    if square:
        x = x * x
    got = scan_window_model(x, w, agg)
    want = window_agg_ref(torch.from_numpy(x), window=w, agg=agg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,w", [(1, 1), (5, 5), (31, 16), (33, 32), (300, 1), (300, 7), (1000, 32)])
def test_scan_model_computes_the_window_sums(s, w):
    x = np.random.default_rng(s + w).normal(0, 1, (s, 4)).astype(np.float32)
    want = np.stack([x[max(t - w + 1, 0) : t + 1].astype(np.float64).sum(0) for t in range(s)])
    np.testing.assert_allclose(scan_window_model(x, w, "sum"), want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s,w", [(ROWS, 8), (ROWS, 16), (ROWS + 3, 16), (1007, 32), (40, 1)])
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_scan_kernel_equals_its_numpy_model_bit_for_bit(cuda, s, w, agg):
    x = np.random.default_rng(s).normal(0, 1, (s, 4)).astype(np.float32)
    for data in (x, x * x):
        xt = torch.from_numpy(data).to(cuda)
        assert window_plan(s, 4, w, agg, xt.data_ptr()).variant == "scan"
        got = window_agg(xt, window=w, agg=agg).cpu().numpy()
        np.testing.assert_array_equal(got, scan_window_model(data, w, agg))
