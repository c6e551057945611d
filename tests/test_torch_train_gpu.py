"""Training on the card (``gpu`` marker; skipped without a card). Imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

The flash kernel under autograd (``FlashAttentionFn``): its output against
the plain ``chunked_attention`` and its q, k, v gradients against autograd
through that function, at qwen3-0.6b's and gemma2-9b's head shapes with a
biting window and softcap, and at D = 72 (f32 2e-4, bf16 2e-2); the Mamba
scan's out-of-place form against its in-place one; the wrappers with no
backward refusing inputs that require grad; and a SMOKE training step on
the card against the same step on the CPU.
"""

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.loader import LoaderConfig, TokenBatchLoader
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.kmeans import kmeans_assign
from repro_torch.kernels.window_agg import window_agg
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import build_train_step, init_train_state
from repro_torch.train.tree import leaves, tree_map

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,window,softcap",
    [
        (2, 300, 16, 8, 128, 0, 0.0),  # qwen3-0.6b
        (1, 520, 16, 8, 256, 128, 50.0),  # gemma2-9b, window biting at S = 520
        (2, 77, 4, 2, 72, 0, 0.0),  # a head dim the bf16 kernel pads
    ],
)
def test_flash_function_gradients(cuda, dtype, b, s, hq, hkv, d, window, softcap):
    q = _randn((b, s, hq, d), 1, dtype, cuda).requires_grad_()
    k = _randn((b, s, hkv, d), 2, dtype, cuda).requires_grad_()
    v = _randn((b, s, hkv, d), 3, dtype, cuda).requires_grad_()
    w = _randn((b, s, hq, d), 4, dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
    assert out.grad_fn is not None and flash_attention.launches == before + 1
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    assert flash_attention.launches == before + 1  # the backward launches nothing
    pos = torch.arange(s, dtype=torch.int32, device=cuda)[None].expand(b, s)
    ref = L.chunked_attention(
        q, k, v, q_positions=pos, kv_positions=pos, window=window, softcap=softcap,
        scale=1.0 / math.sqrt(d),
    )
    torch.testing.assert_close(out, ref, **TOL[dtype])
    want = torch.autograd.grad((ref.float() * w.float()).sum(), (q, k, v))
    for a, r in zip(got, want, strict=True):
        assert a.dtype == dtype
        torch.testing.assert_close(a, r, **TOL[dtype])


@pytest.mark.gpu
def test_flash_without_grad_launches_directly(cuda):
    q = _randn((1, 64, 4, 128), 5, torch.bfloat16, cuda).requires_grad_()
    with torch.no_grad():
        out = flash_attention(q, q, q)
    assert out.grad_fn is None
    out = flash_attention(q.detach(), q.detach(), q.detach())
    assert out.grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 16, 256])
def test_mamba_scan_out_of_place_equals_in_place(cuda, chunk):
    da = torch.rand((2, chunk, 64, 16), device=cuda) * 0.5 + 0.5
    dbu = torch.randn((2, chunk, 64, 16), device=cuda)
    h0 = torch.randn((2, 64, 16), device=cuda)
    h_in, last_in = ssm._scan_chunk(da.clone(), dbu.clone(), h0)
    a, b = da.clone().requires_grad_(), dbu.clone().requires_grad_()
    h_out, last_out = ssm._scan_chunk(a, b, h0)
    assert torch.equal(h_out, h_in) and torch.equal(last_out, last_in)
    assert torch.equal(a, da) and torch.equal(b, dbu)
    ga, gb = torch.autograd.grad(h_out.sum(), (a, b))
    assert torch.isfinite(ga).all() and torch.isfinite(gb).all()


@pytest.mark.gpu
def test_kernels_without_backward_refuse_grad(cuda):
    """decode, k-means and window raise on an input that requires grad
    while grad is enabled, rather than return an output cut from the
    graph; under no_grad they run."""
    q = _randn((2, 4, 128), 6, torch.bfloat16, cuda).requires_grad_()
    kv = _randn((2, 32, 2, 128), 7, torch.bfloat16, cuda)
    valid = torch.ones((2, 32), dtype=torch.bool, device=cuda)
    x = _randn((1000, 4), 8, torch.float32, cuda).requires_grad_()
    c = _randn((3, 4), 9, torch.float32, cuda)
    calls = [
        lambda: decode_attention(q, kv, kv, valid),
        lambda: kmeans_assign(x, c),
        lambda: window_agg(x, window=8, agg="mean"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True])
def test_smoke_train_step_on_card_matches_cpu(cuda, remat):
    """qwen3-0.6b's SMOKE config in float32: one AdamW step on the card
    (flash kernel forward, plain backward) against the same step on the
    CPU from the same weights: loss within 2e-4, every updated leaf within
    2e-4 relative to its largest magnitude; one flash launch per layer,
    two with remat."""
    cfg = get_config("qwen3-0.6b", smoke=True)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cpu = init_train_state(cfg, oc, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    batch = next(iter(TokenBatchLoader(LoaderConfig(batch_size=4, seq_len=64, vocab_size=cfg.vocab_size))))
    step = build_train_step(cfg, oc, remat=remat)
    want, wm = step(cpu, batch)
    before = flash_attention.launches
    got, gm = step(card, batch)
    assert flash_attention.launches - before == cfg.n_layers * (2 if remat else 1)
    torch.testing.assert_close(gm["loss"].cpu(), wm["loss"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(gm["grad_norm"].cpu(), wm["grad_norm"], rtol=2e-4, atol=2e-4)
    for a, r in zip(leaves(got["opt"]["m"]), leaves(want["opt"]["m"]), strict=True):
        scale = float(r.abs().max()) or 1.0
        assert float((a.cpu() - r).abs().max()) / scale <= 2e-4
