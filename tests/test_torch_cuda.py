"""Card-only tests of the port (``gpu`` marker; each skips without a CUDA
card).  No JAX here, so the file runs where only torch is installed.
The plain versions these tests hold the kernels against are themselves
held against the JAX package by ``tests/test_torch_kernels.py`` on the
CPU.

Run on the GPU machine with ``python -m pytest -q -m gpu
tests/test_torch_cuda.py``.

Tolerance: kernel and plain version both accumulate in f32 and differ
only in the order of the softmax sums; bf16 outputs may round one bf16
ulp apart (2**-8 relative).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.act_quant import kv_quant_rows
from repro_torch.kernels.paged_decode_attn import paged_decode_attention
from repro_torch.kernels.ref import paged_decode_attn_ref
from repro_torch.models import init_params
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)

torch.set_num_threads(2)

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, *, slots, kvh, group, hd, bs, mb, pool, q_dtype, layers=3):
    """A paged-decode problem whose pool interleaves ``layers`` layers;
    the kernel reads layer 1 in place through the block stride."""
    rng = np.random.default_rng(seed)
    nb = slots * mb + 1
    k = torch.from_numpy(rng.standard_normal((nb, layers, bs, kvh, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((nb, layers, bs, kvh, hd))
                         .astype(np.float32))
    scales = {}
    if pool == torch.int8:
        k, ks = kv_quant_rows(k)
        v, vs = kv_quant_rows(v)
        scales = dict(k_scale=ks.cuda()[:, 1], v_scale=vs.cuda()[:, 1])
    else:
        k, v = k.to(pool), v.to(pool)
    pos = rng.integers(0, mb * bs + 1, slots).astype(np.int32)
    pos[0], pos[-1] = 0, mb * bs

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q = normal(slots, kvh * group, hd).to(q_dtype)
    tables = torch.from_numpy(rng.integers(0, nb, (slots, mb))
                              .astype(np.int32))
    kn = normal(slots, kvh, hd).to(q_dtype)
    vn = normal(slots, kvh, hd).to(q_dtype)
    args = [q.cuda(), k.cuda()[:, 1], v.cuda()[:, 1], tables.cuda(),
            torch.from_numpy(pos).cuda(), kn.cuda(), vn.cuda()]
    return args, scales


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,group", [(8, 1), (2, 4), (1, 3)])
@pytest.mark.parametrize("window", [0, 5])
def test_kernel_matches_plain_version(cuda, pool, q_dtype, kvh, group,
                                      window):
    args, sc = _case(kvh * 10 + group, slots=8, kvh=kvh, group=group,
                     hd=32, bs=16, mb=32, pool=pool, q_dtype=q_dtype)
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, **sc, window=window)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    ref = paged_decode_attn_ref(*args, **sc, window=window)
    torch.testing.assert_close(out, ref, **TOL[q_dtype])


@pytest.mark.gpu
def test_kernel_pos_zero_returns_v_new(cuda):
    args, sc = _case(3, slots=4, kvh=2, group=4, hd=32, bs=16, mb=4,
                     pool=torch.int8, q_dtype=torch.float32)
    args[4].zero_()
    out = paged_decode_attention(*args, **sc)
    assert torch.equal(out, args[6].repeat_interleave(4, dim=1))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    args, sc = _case(5, slots=2, kvh=2, group=2, hd=16, bs=8, mb=2,
                     pool=torch.int8, q_dtype=torch.float32)
    with pytest.raises(ValueError):                 # int8 without scales
        paged_decode_attention(*args)
    bad = list(args)
    bad[3] = bad[3].long()                          # int64 tables
    with pytest.raises(ValueError):
        paged_decode_attention(*bad, **sc)
    bad = list(args)
    bad[0] = bad[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):                 # non-contiguous q
        paged_decode_attention(*bad, **sc)


@pytest.mark.gpu
def test_engine_on_card_matches_cpu_and_counts_launches(cuda):
    """Tiny paper-backbone, f32 activations: the card's greedy and
    sampled streams equal the port's CPU streams, and the kernel runs
    once per layer per decode step."""
    cfg = get_config("paper-backbone").with_updates(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=300, activation_dtype="float32")
    opts = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 300, n).astype(np.int32) for n in (5, 20, 33)]
    streams = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(cfg, init_params(cfg, seed=1, device=device),
                            slots=2, max_seq=64, opts=opts,
                            compile_cache=CompileCache(), device=device)
        before = paged_decode_attention.launches
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6,
                        sampling=SamplingOpts(temperature=0.8 * (i % 2),
                                              seed=3))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[device] = [tuple(r.generated) for r in reqs]
        if device == "cuda":
            assert paged_decode_attention.launches - before == \
                eng.stats.decode_calls * cfg.num_layers
    assert streams["cuda"] == streams["cpu"]
