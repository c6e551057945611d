"""The CUDA kernels vs their plain versions on the card (``gpu`` marker;
skipped without one). Imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    split_plan,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
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
@pytest.mark.parametrize(
    "N,D,K,offset,variant",
    [
        (500_000, 3, 4, 1, "tiled"),  # x[1:]: 12 bytes past, scalar loads
        (500_001, 2, 6, 0, "tiled"),  # N % 4 = 1, 2, 3: the ragged tail
        (500_002, 2, 6, 0, "tiled"),
        (500_003, 2, 6, 0, "tiled"),
        (7, 3, 4, 0, "tiled"),
        (100_000, 1, 5, 0, "tiled"),
        (100_000, 4, 5, 0, "tiled"),
        (10_000, 3, 1, 0, "tiled"),
        (10_000, 3, 16, 0, "tiled"),
        (10_000, 3, 17, 0, "general"),  # just above the templates' maximum
    ],
)
def test_kmeans_assign_kernel_edge_cases(cuda, N, D, K, offset, variant):
    """Each case twice: bit-identical runs, and the plain version's answer."""
    from repro_torch.kernels.kmeans.ops import kmeans_plan

    g = torch.Generator(device="cpu").manual_seed(N + D + K)
    x = torch.randn((N + offset, D), generator=g).to(cuda)[offset:]
    c = torch.randn((K, D), generator=g).to(cuda)
    assert kmeans_plan(N, D, K, x.data_ptr()).variant == variant
    a, d2 = kmeans_assign(x, c)
    a2, d22 = kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert torch.equal(a, a2) and torch.equal(d2, d22)
    ar, d2r = kmeans_assign_ref(x, c)
    differ = a != ar
    if K > 1:
        two = kmeans_distances(x, c).topk(2, dim=1, largest=False).values
        differ &= (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()
    assert not differ.any()
    torch.testing.assert_close(d2, d2r, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize(
    "S,C,w,variant",
    [
        (500_003, 4, 16, "scan"),  # S % 32 != 0 and S % 1024 != 0
        (1007, 4, 8, "scan"),
        (255, 4, 32, "scan"),
        (5, 4, 16, "scan"),  # S < w: the window clamps to S
        (3000, 1, 8, "general"),
        (3000, 3, 8, "general"),
        (3000, 5, 8, "general"),
        (3000, 4, 1, "scan"),  # w = 1
        (3000, 3, 1, "general"),
        (3000, 4, 33, "general"),
    ],
)
def test_window_agg_kernel_edge_cases(cuda, S, C, w, variant, agg):
    """Each case twice: bit-identical runs; max equals the plain version
    exactly, sum and mean within 1e-4."""
    from repro_torch.kernels.window_agg.ops import window_plan

    g = torch.Generator(device="cpu").manual_seed(S + C + w)
    x = torch.randn((S, C), generator=g).to(cuda)
    assert window_plan(S, C, w, agg, x.data_ptr()).variant == variant
    out = window_agg(x, window=w, agg=agg)
    again = window_agg(x, window=w, agg=agg)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = window_agg_ref(x, window=w, agg=agg)
    if agg == "max":
        assert torch.equal(out, ref)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ds_kernel_attributes(cuda):
    from repro_torch.kernels.kmeans.ops import kernel_attributes as kmeans_attrs
    from repro_torch.kernels.kmeans.ops import kmeans_plan
    from repro_torch.kernels.window_agg.ops import kernel_attributes as window_attrs
    from repro_torch.kernels.window_agg.ops import window_plan

    aligned = 1 << 20
    for d, k in ((2, 6), (3, 4), (64, 300)):
        for ptr in (aligned, aligned + 4):
            attrs = kmeans_attrs(kmeans_plan(500_000, d, k, ptr), d)
            assert 0 < attrs["registers"] <= 255 and attrs["local_bytes"] == 0
    for c, w in ((4, 16), (4, 1), (5, 8)):
        for agg in ("sum", "mean", "max"):
            attrs = window_attrs(window_plan(500_000, c, w, agg, aligned), agg)
            assert 0 < attrs["registers"] <= 255 and attrs["local_bytes"] == 0


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


HEAD_DIMS = [16, 32, 48, 64, 112, 128, 256]
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _randn(shape, seed, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,Hq,Hkv,D,causal,window,cap",
    [(1, 200, 4, 2, d, True, 0, 0.0) for d in HEAD_DIMS]
    + [
        (2, 96, 4, 2, 64, True, 0, 50.0),
        (1, 128, 2, 1, 48, True, 16, 0.0),
        (1, 200, 1, 1, 128, False, 0, 0.0),
        (1, 33, 8, 4, 16, True, 5, 30.0),
        (1, 1536, 16, 8, 128, True, 0, 0.0),  # the serving path's longest prompt
        (1, 1, 16, 8, 128, True, 0, 0.0),
    ],
)
def test_flash_attention_kernel_vs_plain(cuda, B, S, Hq, Hkv, D, causal, window, cap, dtype):
    q = _randn((B, S, Hq, D), S + D, dtype, cuda)
    k = _randn((B, S, Hkv, D), S + D + 1, dtype, cuda)
    v = _randn((B, S, Hkv, D), S + D + 2, dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(
        q.transpose(1, 2),
        k.transpose(1, 2),
        v.transpose(1, 2),
        causal=causal,
        window=window,
        softcap=cap,
    ).transpose(1, 2)
    torch.testing.assert_close(out, ref, **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,C,D,cap",
    [(2, 4, 2, 300, d, 0.0) for d in HEAD_DIMS]
    + [
        (1, 8, 2, 100, 64, 50.0),
        (3, 2, 2, 256, 128, 0.0),
        (1, 16, 8, 40, 112, 0.0),
        (2, 48, 8, 70, 128, 0.0),  # G = 6: two passes over the cache
        (8, 16, 8, 2048, 128, 0.0),  # the serving path's decode
    ],
)
def test_decode_attention_kernel_vs_plain(cuda, B, Hq, Hkv, C, D, cap, dtype):
    q = _randn((B, Hq, D), C + D, dtype, cuda)
    k = _randn((B, C, Hkv, D), C + D + 1, dtype, cuda)
    v = _randn((B, C, Hkv, D), C + D + 2, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(C)
    valid = (torch.rand((B, C), generator=g) > 0.3).to(cuda)
    valid[0] = False  # an all-invalid row gives 0
    before = decode_attention.launches
    out = decode_attention(q, k, v, valid, softcap=cap)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref = decode_attention_ref(q, k, v, valid, softcap=cap)
    torch.testing.assert_close(out, ref, **TOL[dtype])


def _flash_vs_plain(q, k, v, **kw):
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, again)  # deterministic: bit-identical reruns
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
    torch.testing.assert_close(out, ref.transpose(1, 2), **TOL[q.dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,S,Hq,Hkv,D,window,cap",
    [
        (1, 200, 4, 2, 8, 0, 0.0),  # D < 16: TMA zero-fills the columns
        (1, 200, 4, 2, 40, 0, 0.0),
        (1, 200, 4, 2, 72, 0, 0.0),
        (2, 100, 4, 2, 20, 0, 0.0),  # D not a multiple of 8: the wrapper pads
        (1, 1536, 16, 8, 256, 512, 50.0),  # gemma2-9b's heads; the window bites
        (1, 1, 16, 8, 256, 0, 0.0),
        (1, 77, 8, 8, 96, 30, 0.0),  # S not a multiple of the 64-row tile
        (3, 300, 4, 2, 128, 100, 20.0),
    ],
)
def test_flash_attention_tensor_core_cases(cuda, B, S, Hq, Hkv, D, window, cap, dtype):
    q = _randn((B, S, Hq, D), S + D, dtype, cuda)
    k = _randn((B, S, Hkv, D), S + D + 1, dtype, cuda)
    v = _randn((B, S, Hkv, D), S + D + 2, dtype, cuda)
    _flash_vs_plain(q, k, v, causal=True, window=window, softcap=cap)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,Hq,Hkv,C,D,mask",
    [
        (8, 16, 8, 2048, 128, "scattered"),
        (8, 16, 8, 2048, 128, "split_hole"),  # a whole split invalid in valid rows
        (2, 4, 2, 40, 128, "scattered"),  # C smaller than one split
        (2, 4, 2, 333, 128, "split_hole"),  # C not a multiple of the split
        (2, 8, 8, 300, 64, "scattered"),  # G = 1
        (2, 16, 8, 300, 64, "scattered"),  # G = 2
        (2, 8, 2, 300, 64, "scattered"),  # G = 4
        (2, 12, 2, 300, 64, "scattered"),  # G = 6
        (2, 16, 2, 300, 64, "scattered"),  # G = 8
        (2, 32, 2, 300, 32, "scattered"),  # G = 16: two passes
        (2, 4, 2, 300, 50, "scattered"),  # D without 16-byte loads
        (2, 4, 2, 300, 256, "split_hole"),
    ],
)
def test_decode_attention_split_cases(cuda, B, Hq, Hkv, C, D, mask, dtype):
    q = _randn((B, Hq, D), C + D, dtype, cuda)
    k = _randn((B, C, Hkv, D), C + D + 1, dtype, cuda)
    v = _randn((B, C, Hkv, D), C + D + 2, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(C + Hq)
    valid = torch.rand((B, C), generator=g) > 0.5  # scattered, not a prefix
    n_split, split = split_plan(B, Hkv, C, _sm_count(cuda))
    if mask == "split_hole":
        assert n_split > 1
        valid[:, split : 2 * split] = False
    valid[0] = False  # an all-invalid row gives 0
    valid = valid.to(cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    again = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2  # calls, not kernels
    assert torch.equal(out, again)  # deterministic: no atomics
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, valid), **TOL[dtype])


@pytest.mark.gpu
def test_decode_split_plan_fills_the_card_at_the_serving_shape(cuda):
    n_split, _ = split_plan(8, 8, 2048, _sm_count(cuda))
    assert 8 * 8 * n_split > _sm_count(cuda)


@pytest.mark.gpu
def test_attention_kernel_attributes(cuda):
    from repro_torch.kernels.decode_attention.ops import kernel_attributes as decode_attrs
    from repro_torch.kernels.flash_attention.ops import kernel_attributes as flash_attrs

    for dtype in (torch.float32, torch.bfloat16):
        for attrs in (flash_attrs(dtype, 128), decode_attrs(dtype, 128, 2)):
            assert 0 < attrs["registers"] <= 255
            assert attrs["local_bytes"] == 0  # no spills at the serving shape


@pytest.mark.gpu
def test_attention_wrappers_raise_instead_of_taking_the_plain_version(cuda):
    before = (flash_attention.launches, decode_attention.launches)
    x = torch.zeros((1, 16, 8, 2, 8), device=cuda)[..., 0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(x, x, x)
    q = torch.zeros((2, 4, 32), device=cuda)
    kv = torch.zeros((2, 10, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="valid on"):
        decode_attention(q, kv, kv, torch.ones((2, 10), dtype=torch.bool))
    assert (flash_attention.launches, decode_attention.launches) == before


@pytest.mark.gpu
def test_serve_engine_on_the_card_launches_the_kernels_and_matches_plain(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import EngineConfig, RequestSpec, ServeEngine

    cfg = get_config("gemma2-9b", smoke=True)  # local rings, softcaps
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    outs, counts = [], []
    for plain in (False, True):
        flash_attention.launches = decode_attention.launches = 0
        eng = ServeEngine(
            cfg, params, EngineConfig(max_batch=2, max_seq=32, plain_attention=plain)
        )
        for i in range(3):
            prompt = torch.arange(2 + i, 14 + i, dtype=torch.int32).numpy()
            eng.submit(RequestSpec(rid=i, prompt=prompt, max_new_tokens=10))
        outs.append({r.rid: r.output for r in eng.run()})
        counts.append((flash_attention.launches, decode_attention.launches, eng.ticks))
    (flash, decode, ticks), (pf, pd, _) = counts
    assert flash == 3 * cfg.n_layers and decode == ticks * cfg.n_layers
    assert (pf, pd) == (0, 0)
    assert outs[0] == outs[1]
