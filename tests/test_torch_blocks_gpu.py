"""jamba-v0.1's and llama-3.2-vision's attention shapes through the CUDA
kernels against their plain versions, and the MoE, Mamba and
cross-attention blocks on the card against the same blocks on the CPU
(``gpu`` marker; skipped without a card). Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_blocks_gpu.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.models import model as M
from repro_torch.models import moe, ssm
from repro_torch.models import transformer as T

TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
#: both archs' self-attention: 32 query and 8 KV heads of 128 (jamba's is
#: NoPE, which changes nothing the kernels see)
HQ, HKV, D = 32, 8, 128


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
@pytest.mark.parametrize("S", [32, 97, 256])
def test_flash_at_the_block_archs_prefill_shapes(cuda, S, dtype):
    q = _randn((1, S, HQ, D), S, dtype, cuda)
    k = _randn((1, S, HKV, D), S + 1, dtype, cuda)
    v = _randn((1, S, HKV, D), S + 2, dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    torch.testing.assert_close(out, ref.transpose(1, 2), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_at_the_block_archs_decode_shape(cuda, dtype):
    """8 slots over a 512-slot cache, each filled to its own depth."""
    b, c = 8, 512
    q = _randn((b, HQ, D), 1, dtype, cuda)
    k = _randn((b, c, HKV, D), 2, dtype, cuda)
    v = _randn((b, c, HKV, D), 3, dtype, cuda)
    depth = torch.tensor([33, 270, 97, 512, 1, 150, 256, 0])
    valid = (torch.arange(c)[None] < depth[:, None]).to(cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert torch.equal(out[7], torch.zeros_like(out[7]))  # an empty row gives 0
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, valid), **TOL[dtype])


def _to(tree, device):
    return T.tree_map(lambda t: t.to(device), tree)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_on_the_card_matches_the_cpu(cuda, capacity_factor):
    """Routing, capacity drops and the dense dispatch on the card, float32,
    with ties in the router (a zeroed expert column pair) resolved to the
    lower expert as on the CPU."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), capacity_factor=capacity_factor)
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    p["router"][:, 2:] = 0.0  # experts 2 and 3 tie on every token
    x = torch.randn(3, 40, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, aux = moe.apply_moe(cfg, p, x)
    gy, gaux = moe.apply_moe(cfg, _to(p, cuda), x.to(cuda))
    torch.testing.assert_close(gy.cpu(), y, **TOL[torch.float32])
    assert float(gaux["dropped_frac"]) == float(aux["dropped_frac"])
    for k in ("aux_loss", "z_loss"):
        torch.testing.assert_close(gaux[k].cpu(), aux[k], **TOL[torch.float32])
    w, ids = moe._top_k(torch.full((5, 16), 1 / 16, device=cuda), 2)
    assert ids.tolist() == [[0, 1]] * 5


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 48, 20])
def test_mamba_on_the_card_matches_the_cpu(cuda, s):
    cfg = get_config("falcon-mamba-7b", smoke=True)
    p = ssm.init_mamba(cfg, torch.Generator().manual_seed(s), "cpu")
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator().manual_seed(s + 1))
    st = ssm.init_ssm_state(cfg, 2)
    st["h"].normal_(generator=torch.Generator().manual_seed(s + 2))
    y, new = ssm.apply_mamba(cfg, p, x, state=st)
    gy, gnew = ssm.apply_mamba(cfg, _to(p, cuda), x.to(cuda), state=_to(st, cuda))
    torch.testing.assert_close(gy.cpu(), y, **TOL[torch.float32])
    for k in new:
        torch.testing.assert_close(gnew[k].cpu(), new[k], **TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama-3.2-vision-11b"])
def test_block_archs_serve_on_the_card_through_the_kernels(cuda, arch):
    """The SMOKE configs through the card's engine: one flash launch per
    prefill and one decode launch per tick for each self-attention layer,
    and the tokens of plain attention."""
    from repro_torch.models import frontends
    from repro_torch.serve import EngineConfig, RequestSpec, ServeEngine

    cfg = get_config(arch, smoke=True)
    params = M.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    vision = frontends.fake_patch_embeddings(cfg, 1)[0] if cfg.family == "vlm" else None
    n_attn = sum(cfg.block_spec(i).mixer in ("attn", "local") for i in range(cfg.n_layers))
    outs, counts = [], []
    for plain in (False, True):
        flash_attention.launches = decode_attention.launches = 0
        ecfg = EngineConfig(max_batch=2, max_seq=48, plain_attention=plain)
        eng = ServeEngine(cfg, params, ecfg, vision=vision)
        for i in range(3):
            prompt = torch.arange(2 + i, 14 + 3 * i, dtype=torch.int32).numpy()
            eng.submit(RequestSpec(rid=i, prompt=prompt, max_new_tokens=10))
        outs.append({r.rid: r.output for r in eng.run()})
        counts.append((flash_attention.launches, decode_attention.launches, eng.ticks))
    (flash, decode, ticks), (pf, pd, _) = counts
    assert flash == 3 * n_attn and decode == ticks * n_attn and decode > 0
    assert (pf, pd) == (0, 0)
    assert outs[0] == outs[1]
