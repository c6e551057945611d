"""Port attention kernels (plain versions on the CPU) vs the JAX package's
Pallas kernels (interpret mode) and their jnp oracles, over the shape
sweeps of tests/test_kernels.py. The CUDA kernels are held against the
plain versions on the card in test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.decode_attention import (
    decode_attention_ref as jax_decode_attention_ref,
)
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models.layers import chunked_attention as jax_chunked_attention
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.models.layers import chunked_attention

FLASH_CASES = [
    (1, 2, 2, 64, 32, True, 0, 0.0),
    (2, 4, 2, 96, 64, True, 0, 50.0),  # GQA + softcap + ragged S
    (1, 2, 1, 128, 48, True, 16, 0.0),  # sliding window + odd D
    (1, 1, 1, 200, 128, False, 0, 0.0),  # non-causal
    (1, 8, 4, 33, 16, True, 5, 30.0),  # everything at once, tiny
]
DECODE_CASES = [
    (2, 4, 2, 64, 32, 0.0),
    (1, 8, 2, 100, 64, 50.0),
    (3, 2, 2, 256, 128, 0.0),
    (1, 16, 8, 40, 112, 0.0),  # ragged C + odd head_dim
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # tests/test_kernels.py:17
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=2e-4)


def _both(a, name):
    """One numpy array as a JAX and a torch array of the same values."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,cap", FLASH_CASES)
def test_flash_attention_matches_jax(B, H, Hkv, S, D, causal, window, cap, dtype):
    rng = np.random.default_rng(S * 100 + D)
    qj, q = _both(rng.normal(0, 1, (B, S, H, D)), dtype)
    kj, k = _both(rng.normal(0, 1, (B, S, Hkv, D)), dtype)
    vj, v = _both(rng.normal(0, 1, (B, S, Hkv, D)), dtype)
    out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    assert out.shape == q.shape and out.dtype == q.dtype
    kern = jax_flash_attention(
        qj, kj, vj, causal=causal, window=window, softcap=cap, block_q=32, block_k=32
    )
    kr = jnp.repeat(kj, H // Hkv, 2).transpose(0, 2, 1, 3)
    vr = jnp.repeat(vj, H // Hkv, 2).transpose(0, 2, 1, 3)
    ref = jax_flash_ref(
        qj.transpose(0, 2, 1, 3), kr, vr, causal=causal, window=window, softcap=cap
    ).transpose(0, 2, 1, 3)
    for want in (kern, ref):
        np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


def test_flash_ref_takes_the_jax_ref_layout():
    """With Hq == Hkv the port's plain version is the JAX oracle's
    function on the same (B, H, S, D) layout."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, (2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    got = flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=7, softcap=20.0
    )
    want = jax_flash_ref(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=7, softcap=20.0
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,C,D,cap", DECODE_CASES)
def test_decode_attention_matches_jax(B, Hq, Hkv, C, D, cap, dtype):
    rng = np.random.default_rng(C * 10 + D)
    qj, q = _both(rng.normal(0, 1, (B, Hq, D)), dtype)
    kj, k = _both(rng.normal(0, 1, (B, C, Hkv, D)), dtype)
    vj, v = _both(rng.normal(0, 1, (B, C, Hkv, D)), dtype)
    valid_np = rng.random((B, C)) > 0.3
    out = decode_attention(q, k, v, torch.from_numpy(valid_np), softcap=cap)
    assert out.shape == q.shape and out.dtype == q.dtype
    valid = jnp.asarray(valid_np)
    kern = jax_decode_attention(qj, kj, vj, valid, softcap=cap, block_c=32)
    ref = jax_decode_attention_ref(qj, kj, vj, valid, softcap=cap)
    for want in (kern, ref):
        np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


def test_decode_all_invalid_row_gives_zero_like_the_tpu_kernel():
    """A row with no valid slot: the TPU kernel (and the port) give 0, the
    JAX oracle gives mean(v)."""
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (2, 4, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 48, 2, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 48, 2, 32)).astype(np.float32)
    valid = np.ones((2, 48), bool)
    valid[1] = False
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, valid)))
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    kern = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v, valid)), block_c=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=2e-4, atol=2e-4)
    oracle = jax_decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, valid)))
    mean_v = v[1].mean(0).repeat(2, axis=0)  # (Hq, D): kv head h // 2
    np.testing.assert_allclose(np.asarray(oracle)[1], mean_v, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 0.0), (0, 50.0), (5, 30.0)])
def test_decode_with_folded_masks_equals_chunked_attention(window, cap):
    """The model's decode route (causal and window folded into ``valid``)
    equals chunked_attention at Sq = 1 over a ring cache, in the port and
    in the JAX package."""
    rng = np.random.default_rng(window + 7)
    B, Hq, Hkv, C, D = 3, 4, 2, 24, 16
    q = rng.normal(0, 1, (B, 1, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, Hkv, D)).astype(np.float32)
    qpos = np.array([[30], [9], [3]], np.int32)
    # ring slots hold positions up to qpos (some empty, some from the future
    # of row 2, which the causal mask must drop)
    pos = np.stack([np.arange(C) + 7, np.arange(C) - 14, np.arange(C) - 2]).astype(np.int32)
    pos[1, :14] = -1
    kv_valid = pos >= 0
    t = {n: torch.from_numpy(a) for n, a in dict(q=q, k=k, v=v, pos=pos, qpos=qpos).items()}
    valid = torch.from_numpy(kv_valid) & (t["pos"] <= t["qpos"])
    if window:
        valid &= t["pos"] > t["qpos"] - window
    got = decode_attention(t["q"][:, 0], t["k"], t["v"], valid, softcap=cap)
    kw = dict(causal=True, window=window, softcap=cap, chunk=8)
    plain = chunked_attention(
        t["q"],
        t["k"],
        t["v"],
        q_positions=t["qpos"],
        kv_positions=t["pos"],
        kv_valid=torch.from_numpy(kv_valid),
        **kw,
    )
    jax_plain = jax_chunked_attention(
        jnp.asarray(q),
        jnp.asarray(k),
        jnp.asarray(v),
        q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(pos),
        kv_valid=jnp.asarray(kv_valid),
        **kw,
    )
    np.testing.assert_allclose(got.numpy(), plain[:, 0].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jax_plain), rtol=2e-4, atol=2e-4)


def test_flash_equals_chunked_attention_on_prefill_positions():
    """Prefill's route: the flash wrapper on positions 0..S-1 equals
    chunked_attention (tests/test_kernels.py's cross-check, in the port)."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv, D = 2, 64, 4, 2, 32
    q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    a = flash_attention(q, k, v, causal=True, window=8)
    b = chunked_attention(
        q, k, v, q_positions=pos, kv_positions=pos, causal=True, window=8, chunk=16
    )
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.zeros((1, 8, 2, 0)),) * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(*(torch.zeros((1, 8, 2, 16), dtype=torch.float64),) * 3)
    qd = torch.zeros((2, 4, 16))
    kd = torch.zeros((2, 10, 2, 16))
    with pytest.raises(ValueError, match="valid must be bool"):
        decode_attention(qd, kd, kd, torch.ones((2, 10), dtype=torch.int32))
    before = (flash_attention.launches, decode_attention.launches)
    decode_attention(qd, kd, kd)  # the CPU takes the plain version: no launch
    flash_attention(*(torch.zeros((1, 8, 2, 16)),) * 3)
    assert (flash_attention.launches, decode_attention.launches) == before
    assert torch.equal(decode_attention_ref(qd, kd, kd), torch.zeros_like(qd))
