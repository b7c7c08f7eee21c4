"""Card-only tests of the port: the CUDA paged-attention kernel against
its plain PyTorch version, its launch count and its refusals, and the
engine on the card against generate().  They skip without a CUDA device.
On a machine with a card (and without jax, which tests/conftest.py
imports):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from workloads_torch.generate import generate
from workloads_torch.model import ModelConfig, init_params
from workloads_torch.ops import paged_attention as pa
from workloads_torch.serve import ServeEngine

pytestmark = pytest.mark.gpu

# Kernel against plain version: both compute in float32 from the same
# inputs and round the output once; bf16 outputs may differ by one bf16
# ulp (2^-8 at magnitude 1).
ATOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dtype, heads, kv_heads, hd, ps, lengths, layers=2, seed=0):
    g = torch.Generator("cuda").manual_seed(seed)
    max_pages = max(1, -(-max(lengths) // ps))
    n_pages = len(lengths) * max_pages + 1
    shape = (layers, n_pages, kv_heads, ps, hd)
    k = torch.randn(shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    q = torch.randn((len(lengths), heads, hd), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n_pages - 1, generator=g, device="cuda")
    tables = perm[: len(lengths) * max_pages].reshape(len(lengths), max_pages)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, tables.to(torch.int32).contiguous(), lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "heads, kv_heads, hd, ps, window",
    [
        (16, 16, 128, 64, None),
        (16, 4, 128, 64, None),
        (16, 2, 128, 64, 100),
        (8, 8, 64, 16, None),
        (4, 2, 16, 4, 5),
        (8, 8, 32, 16, 7),
    ],
)
def test_kernel_matches_plain_version(cuda, dtype, heads, kv_heads, hd, ps, window):
    lengths = [0, 1, ps - 1, ps, ps + 1, 5 * ps + 3]
    q, k, v, tables, lens = _inputs(dtype, heads, kv_heads, hd, ps, lengths)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, lens, layer=1, window=window)
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_reference(q, k, v, tables, lens, layer=1, window=window)
    torch.cuda.synchronize()
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, lens = _inputs(torch.float32, 4, 4, 48, 4, [3, 5])
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match="head_dim in"):
        pa.paged_attention(q, k, v, tables, lens)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), tables.long(), lens)
    with pytest.raises(ValueError, match="on cpu"):
        pa.paged_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), tables.cpu(), lens)
    assert pa.paged_attention.launches == before


def test_engine_on_the_card_matches_generate(cuda):
    """float32 tiny model on the card: the engine's greedy streams (paged
    decode through the kernel) equal generate()'s (dense cached decode)."""
    config = ModelConfig(max_seq_len=64, n_layers=2, n_kv_heads=2, dtype=torch.float32)
    params = init_params(config, torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(params, config, slots=2, page_size=4, prompt_bucket=12,
                         chunk=4)
    prompts = [[5, 9, 13], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [42]]
    rids = [engine.submit(p, 10) for p in prompts]
    before = pa.paged_attention.launches
    served = engine.run()
    assert pa.paged_attention.launches - before == (
        config.n_layers * engine.chunks_run * engine.chunk
    )
    for rid, p in zip(rids, prompts):
        want = generate(params, torch.tensor([p]), config, 10)[0].tolist()
        assert served[rid] == want
    assert engine.ctrl.used_pages == 0
