"""The host side of the redesigned attention kernels, on the CPU: the decode
kernel's split plan, its split-and-combine algorithm in plain torch
(``decode_attention_split_ref``) against the JAX package's Pallas kernel
(interpret mode) and the port's plain version, and the flash wrapper's
head-dim padding against the JAX wrapper. The kernels themselves are held
against the plain versions on the card in test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention import (
    decode_attention_ref as jax_decode_attention_ref,
)
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels.decode_attention import (
    decode_attention_ref,
    decode_attention_split_ref,
    split_plan,
)
from repro_torch.kernels.decode_attention.ops import BLOCKS_PER_SM, MIN_SPLIT
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import pad_head_dim, padded_head_dim

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py:17
TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}

PLAN_SHAPES = [
    (b, hkv, c, n_sm)
    for b in (1, 3, 8, 64)
    for hkv in (1, 2, 8)
    for c in (0, 1, 40, 63, 64, 65, 300, 2048, 2049, 32768)
    for n_sm in (1, 132)
]


def _slots(plan, c):
    n_split, split = plan
    return [list(range(s * split, min(c, (s + 1) * split))) for s in range(n_split)]


@pytest.mark.parametrize("b,hkv,c,n_sm", PLAN_SHAPES)
def test_split_plan_covers_every_slot_once(b, hkv, c, n_sm):
    """Exact cover, no empty split unless C is 0, splits of a multiple of
    16 slots and at least MIN_SPLIT (or C), and at least BLOCKS_PER_SM
    blocks an SM wherever the cache is long enough."""
    n_split, split = split_plan(b, hkv, c, n_sm)
    ranges = _slots((n_split, split), c)
    assert sorted(s for r in ranges for s in r) == list(range(c))
    assert all(ranges) or (c == 0 and n_split == 1)
    if c:
        assert split >= min(MIN_SPLIT, c) and split % 16 == 0
    if c >= 2 * BLOCKS_PER_SM * n_sm * MIN_SPLIT:
        assert b * hkv * n_split >= BLOCKS_PER_SM * n_sm


def test_split_plan_fills_the_card_at_the_serving_shape():
    # qwen3-0.6b decode: B 8, Hkv 8, C 2048 on 132 SMs → 8 splits of 256
    assert split_plan(8, 8, 2048, 132) == (8, 256)
    assert 8 * 8 * 8 > 132


def _both(a, name):
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


SPLIT_CASES = [
    # B, Hq, Hkv, C, D, cap, n_sm: the plan's splits of 64 slots at n_sm 132
    (2, 4, 2, 300, 32, 0.0, 132),  # C not a multiple of the split
    (1, 8, 2, 100, 64, 50.0, 132),  # softcap
    (3, 2, 2, 256, 16, 0.0, 132),
    (2, 12, 2, 200, 16, 0.0, 1),  # G = 6, one split
    (1, 16, 8, 40, 112, 0.0, 132),  # C smaller than one split
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,C,D,cap,n_sm", SPLIT_CASES)
def test_decode_split_ref_matches_jax_and_plain(B, Hq, Hkv, C, D, cap, n_sm, dtype):
    """Scattered valid slots, a whole split invalid inside a valid row, and
    an all-invalid row (0, as the TPU kernel gives)."""
    rng = np.random.default_rng(C + D)
    qj, q = _both(rng.normal(0, 1, (B, Hq, D)), dtype)
    kj, k = _both(rng.normal(0, 1, (B, C, Hkv, D)), dtype)
    vj, v = _both(rng.normal(0, 1, (B, C, Hkv, D)), dtype)
    n_split, split = split_plan(B, Hkv, C, n_sm)
    valid_np = rng.random((B, C)) > 0.4
    if n_split > 1:
        valid_np[-1, :split] = False  # a whole split inside a valid row
    valid_np[0] = False  # an all-invalid row
    valid = torch.from_numpy(valid_np)
    got = decode_attention_split_ref(
        q, k, v, valid, n_split=n_split, split=split, softcap=cap
    )
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    plain = decode_attention_ref(q, k, v, valid, softcap=cap)
    np.testing.assert_allclose(_np(got), _np(plain), **TOL[dtype])
    kern = jax_decode_attention(qj, kj, vj, jnp.asarray(valid_np), softcap=cap, block_c=32)
    np.testing.assert_allclose(_np(got), _np(kern), **TOL[dtype])
    # the JAX oracle differs on the all-invalid row only (mean of v there)
    oracle = jax_decode_attention_ref(qj, kj, vj, jnp.asarray(valid_np), softcap=cap)
    np.testing.assert_allclose(_np(got)[1:], _np(oracle)[1:], **TOL[dtype])


def test_decode_split_ref_all_invalid_cache_gives_zero():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(0, 1, (2, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(0, 1, (2, 130, 2, 16)).astype(np.float32))
    valid = torch.zeros((2, 130), dtype=torch.bool)
    n_split, split = split_plan(2, 2, 130, 132)
    assert n_split == 3
    got = decode_attention_split_ref(q, kv, kv, valid, n_split=n_split, split=split)
    assert torch.equal(got, torch.zeros_like(got))


def test_padded_head_dim():
    assert [padded_head_dim(d, torch.bfloat16) for d in (1, 8, 13, 16, 100, 256)] == [
        8,
        8,
        16,
        16,
        104,
        256,
    ]
    assert padded_head_dim(13, torch.float32) == 13
    x = torch.ones((1, 2, 3, 13))
    y = pad_head_dim(x, 16)
    assert y.shape == (1, 2, 3, 16) and torch.equal(y[..., :13], x) and not y[..., 13:].any()
    assert pad_head_dim(x, 13) is x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,window,cap", [(13, 0, 0.0), (5, 7, 30.0), (100, 0, 50.0)])
def test_flash_head_dim_padding_matches_jax(D, window, cap, dtype):
    """What the wrapper does for the bf16 kernel at a D that is not a
    multiple of 8 (zero-pad q, k and v, keep the scale of the true D, slice
    the output) gives JAX's flash_attention, which pads to 128 lanes."""
    rng = np.random.default_rng(D)
    B, S, H, Hkv = 1, 40, 4, 2
    qj, q = _both(rng.normal(0, 1, (B, S, H, D)), dtype)
    kj, k = _both(rng.normal(0, 1, (B, S, Hkv, D)), dtype)
    vj, v = _both(rng.normal(0, 1, (B, S, Hkv, D)), dtype)
    d_pad = padded_head_dim(D, torch.bfloat16)
    assert d_pad % 8 == 0 and d_pad != D
    padded = [pad_head_dim(t, d_pad) for t in (q, k, v)]
    out = flash_attention(
        *padded, causal=True, window=window, softcap=cap, scale=1.0 / np.sqrt(D)
    )[..., :D]
    want = jax_flash_attention(
        qj, kj, vj, causal=True, window=window, softcap=cap, block_q=32, block_k=32
    )
    np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])
    plain = flash_attention(q, k, v, causal=True, window=window, softcap=cap)
    np.testing.assert_allclose(_np(out), _np(plain), **TOL[dtype])
