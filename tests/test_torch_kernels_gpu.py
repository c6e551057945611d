"""The CUDA kernels vs their plain versions on the card (``gpu`` marker;
skipped without one). Imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from repro_torch.kernels.kmeans import kmeans_assign, kmeans_assign_ref
from repro_torch.kernels.kmeans.ref import kmeans_distances
from repro_torch.kernels.window_agg import window_agg, window_agg_ref

KMEANS_CASES = [(100, 8, 4), (512, 16, 7), (1000, 3, 13), (64, 128, 32), (8, 2, 2)]
WINDOW_CASES = [
    (100, 4, 8, "mean"),
    (256, 3, 16, "sum"),
    (300, 5, 7, "max"),
    (64, 2, 64, "mean"),
    (128, 1, 1, "max"),
    (40, 2, 5, "sum"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "N,D,K", KMEANS_CASES + [(500_000, 2, 6), (4097, 64, 300), (1000, 13_000, 3)]
)
def test_kmeans_assign_kernel_vs_plain(cuda, N, D, K):
    g = torch.Generator(device="cpu").manual_seed(N + K)
    x = torch.randn((N, D), generator=g).to(cuda)
    c = torch.randn((K, D), generator=g).to(cuda)
    before = kmeans_assign.launches
    a, d2 = kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert kmeans_assign.launches == before + 1
    ar, d2r = kmeans_assign_ref(x, c)
    two = kmeans_distances(x, c).topk(min(2, K), dim=1, largest=False).values
    differ = a != ar
    if K > 1:  # a near tie of the two smallest distances may go either way
        differ &= (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()
    assert not differ.any()
    torch.testing.assert_close(d2, d2r, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "S,C,w,agg",
    WINDOW_CASES
    + [(500_000, 4, 16, "mean"), (500_003, 4, 8, "max"), (1000, 1000, 50, "sum")],
)
def test_window_agg_kernel_vs_plain(cuda, S, C, w, agg):
    g = torch.Generator(device="cpu").manual_seed(S + C)
    x = torch.randn((S, C), generator=g).to(cuda)
    before = window_agg.launches
    out = window_agg(x, window=w, agg=agg)
    torch.cuda.synchronize()
    assert window_agg.launches == before + 1
    ref = window_agg_ref(x, window=w, agg=agg)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_tensors_never_take_the_plain_version(cuda):
    before = (kmeans_assign.launches, window_agg.launches)
    x = torch.zeros((64, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kmeans_assign(x.T, torch.zeros((3, 64), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        window_agg(x.T, window=4)
    with pytest.raises(ValueError, match="but cent on"):
        kmeans_assign(x, torch.zeros((3, 8)))  # centroids left on the CPU
    assert (kmeans_assign.launches, window_agg.launches) == before


@pytest.mark.gpu
def test_pipeline_on_the_card_launches_the_kernels_and_matches_host(cuda):
    import numpy as np

    from repro_torch import convert, quickstart

    kmeans_assign.launches = window_agg.launches = 0
    _, (rep,) = quickstart.run(device=cuda, rows=4096, instances=1)
    assert (kmeans_assign.launches, window_agg.launches) == (60, 3)
    _, (host,) = quickstart.run(
        device=cuda, rows=4096, instances=1, backend_of=lambda pe: "host"
    )
    assert host.by_backend == {"host": 16}
    got = np.asarray(convert.to_numpy(rep.outputs["export"]))
    np.testing.assert_allclose(got, host.outputs["export"], rtol=1e-3)
