"""Card-only tests of the port (``gpu`` marker; each skips without a CUDA
card).  No JAX here, so the file runs where only torch is installed.
The plain versions these tests hold the kernels against are themselves
held against the JAX package by ``tests/test_torch_kernels.py`` on the
CPU.

Run on the GPU machine with ``python -m pytest -q -m gpu
tests/test_torch_cuda.py``.

Tolerance: kernel and plain version both accumulate in f32 and differ
only in the order of the sums (the softmax's, or the FFN's over D and
F); bf16 outputs may round one bf16 ulp apart (2**-8 relative).  The
FFN's f32 sums run over up to D + F = 5120 terms, so its f32 tolerance
is a little wider.  The SSD scan's outputs reach |y| ~ 20 after sums of
up to 256 x 128 terms, so its f32 atol is 1e-3 (about 5e-5 of the
largest output).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.act_quant import kv_quant_rows
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.fused_ffn import fused_ffn
from repro_torch.kernels.paged_decode_attn import paged_decode_attention
from repro_torch.kernels.ref import (flash_attn_ref, fused_ffn_ref,
                                     paged_decode_attn_ref,
                                     ssd_scan_kernel_ref, ssd_scan_ref)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import init_params
from repro_torch.models.runtime import RuntimeOptions
from repro_torch.serving import (CompileCache, Request, SamplingOpts,
                                 ServingEngine)

torch.set_num_threads(2)

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
FFN_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
SSD_TOL = {torch.float32: dict(atol=1e-3, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}
STATE_TOL = dict(atol=1e-4, rtol=1e-4)


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
    sampled streams equal the port's CPU streams; the paged decode
    kernel runs once per layer per decode step, the flash kernel once
    per layer per prefill call and the fused FFN once per layer per
    either."""
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
                            decode_mode="paged",
                            compile_cache=CompileCache(), device=device)
        before = [fn.launches for fn in (paged_decode_attention,
                                         flash_attention, fused_ffn)]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6,
                        sampling=SamplingOpts(temperature=0.8 * (i % 2),
                                              seed=3))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[device] = [tuple(r.generated) for r in reqs]
        if device == "cuda":
            decode, prefill = eng.stats.decode_calls, eng.stats.prefill_calls
            assert [fn.launches - b for fn, b in zip(
                (paged_decode_attention, flash_attention, fused_ffn),
                before)] == [n * cfg.num_layers for n in
                             (decode, prefill, decode + prefill)]
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("kvh,group", [(8, 1), (2, 4)])
def test_kernel_at_max_seq_2048_tables(cuda, pool, kvh, group):
    """mb 128: the block tables of max_seq 2048 at block size 16."""
    args, sc = _case(kvh + 128, slots=8, kvh=kvh, group=group, hd=32,
                     bs=16, mb=128, pool=pool, q_dtype=torch.bfloat16)
    out = paged_decode_attention(*args, **sc)
    ref = paged_decode_attn_ref(*args, **sc)
    torch.testing.assert_close(out, ref, **TOL[torch.bfloat16])


# ------------------------------------------------------------ flash (K2) --
def _qkv(seed, b, h, kvh, s, hd, dtype):
    """q (B,S,H,hd) and k/v (B,S,K,hd) as the model holds them, passed as
    (B,H,S,hd) / (B,K,S,hd) transposed views."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype).cuda()

    q, k, v = normal(b, s, h, hd), normal(b, s, kvh, hd), normal(b, s, kvh,
                                                                 hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


FLASH_MASKS = [dict(causal=True), dict(causal=True, window=1),
               dict(causal=True, window=64), dict(causal=True, window=4096),
               dict(causal=True, kv_len=0), dict(causal=True, kv_len=37),
               dict(causal=False), dict(causal=False, window=64)]


@pytest.mark.gpu
@pytest.mark.parametrize("mask", FLASH_MASKS,
                         ids=["-".join(f"{k}{v}" for k, v in m.items())
                              for m in FLASH_MASKS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,s", [(8, 8, 32, 16), (8, 2, 64, 1024),
                                        (8, 8, 128, 200), (4, 2, 16, 77)])
def test_flash_kernel_matches_plain_version(cuda, mask, dtype, h, kvh, hd,
                                            s):
    q, k, v = _qkv(s + hd, 2, h, kvh, s, hd, dtype)
    before = flash_attention.launches
    out = ops.attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attn_ref(q, k.repeat_interleave(h // kvh, 1),
                         v.repeat_interleave(h // kvh, 1), **mask)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    if mask.get("kv_len") == 0:
        assert bool((out == 0).all())
    # the output's transpose is the model's contiguous (B,S,H,hd)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.gpu
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 1, 4, 2, 32, 32, torch.float32)
    with pytest.raises(ValueError):                 # mixed dtypes
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):                 # head_dim 48
        flash_attention(*_qkv(1, 1, 4, 2, 32, 48, torch.float32))
    with pytest.raises(ValueError):                 # 3 kv heads for 4
        flash_attention(*_qkv(1, 1, 4, 3, 32, 32, torch.float32))
    with pytest.raises(ValueError):                 # k on the CPU
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):                 # f16
        flash_attention(q.half(), k.half(), v.half())


# ------------------------------------------------------------- ffn (K3) --
def _ffn(seed, m, d, f, dtype):
    rng = np.random.default_rng(seed)

    def normal(scale, *shape):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dtype).cuda()

    return (normal(1.0, m, d), normal(d ** -0.5, d, f),
            normal(d ** -0.5, d, f), normal(f ** -0.5, f, d))


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f", [(8, 256, 1024), (100, 256, 1024),
                                   (4096, 256, 1024), (8, 1024, 4096),
                                   (100, 64, 128), (33, 96, 200)])
def test_ffn_kernel_matches_plain_version(cuda, activation, dtype, m, d, f):
    x, wg, wu, wd = _ffn(m + d, m, d, f, dtype)
    before = fused_ffn.launches
    out = ops.gated_ffn(x, wg, wu, wd, activation)
    torch.cuda.synchronize()
    assert fused_ffn.launches == before + 1
    ref = fused_ffn_ref(x, wg, wu, wd, activation)
    torch.testing.assert_close(out, ref, **FFN_TOL[dtype])
    again = ops.gated_ffn(x, wg, wu, wd, activation)
    assert torch.equal(out, again)                  # no atomics


@pytest.mark.gpu
def test_ffn_kernel_rejects_what_it_does_not_take(cuda):
    x, wg, wu, wd = _ffn(2, 16, 64, 128, torch.float32)
    with pytest.raises(ValueError):                 # w_down transposed
        fused_ffn(x, wg, wu, wd.t().contiguous().t())
    with pytest.raises(ValueError):                 # mixed dtypes
        fused_ffn(x, wg.to(torch.bfloat16), wu, wd)
    with pytest.raises(ValueError):                 # 3-d x
        fused_ffn(x[None], wg, wu, wd)
    with pytest.raises(ValueError):                 # unknown activation
        fused_ffn(x, wg, wu, wd, "relu")
    with pytest.raises(ValueError):                 # wrong F
        fused_ffn(x, wg, wu, wd[:64])


# -------------------------------------------------------- ssd scan (K6) --
def _ssd(seed, b, s, h, g, p, n, dtype):
    """x (B,S,H,P), dt (B,S,H) f32 after softplus, a (H,) < 0, b, c
    (B,S,G,N), all on the card; b and c are views of one (B,S,2,G,N)
    buffer, as the model's are views of the conv output."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    x = normal(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(normal(b, s, h) - 1.0)
    a = -torch.exp(normal(h) * 0.5)
    bc = (normal(b, s, 2, g, n) * n ** -0.25).to(dtype)
    return x, dt, a, bc[:, :, 0], bc[:, :, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", [(64, 128), (32, 32)])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("s", [16, 200, 256, 1000])
def test_ssd_kernel_matches_plain_version(cuda, dtype, p, n, g, s):
    args = _ssd(s + p + g, 2, s, 8, g, p, n, dtype)
    before = ssd_scan.launches
    y, st = ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yr, str_ = ssd_scan_ref(*args, chunk=256)
    assert y.dtype == dtype and st.dtype == torch.float32
    torch.testing.assert_close(y, yr, **SSD_TOL[dtype])
    torch.testing.assert_close(st, str_, **STATE_TOL)
    y2, st2 = ssd_scan(*args, chunk=256)
    assert torch.equal(y, y2) and torch.equal(st, st2)    # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 64, 100])
def test_ssd_kernel_chunks_and_initial_state(cuda, chunk):
    args = _ssd(chunk, 1, 300, 4, 2, 64, 64, torch.float32)
    init = torch.randn(1, 4, 64, 64, device="cuda")
    y, st = ssd_scan(*args, chunk=chunk, initial_state=init)
    yr, str_ = ssd_scan_ref(*args, chunk=chunk, initial_state=init)
    torch.testing.assert_close(y, yr, **SSD_TOL[torch.float32])
    torch.testing.assert_close(st, str_, **STATE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_layout_of_ops_ssd(cuda, dtype):
    """ops.ssd takes the Pallas layout (BH, S, P) and returns f32 y."""
    x, dt, a, b, c = _ssd(9, 1, 512, 6, 6, 32, 128, dtype)
    kx, kdt = x[0].transpose(0, 1), dt[0].transpose(0, 1)
    kb, kc = b[0].transpose(0, 1), c[0].transpose(0, 1)
    y, st = ops.ssd(kx, kdt, a, kb, kc, chunk=128)
    yr, str_ = ssd_scan_kernel_ref(kx.float(), kdt, a, kb, kc, 128)
    assert y.dtype == torch.float32 and y.shape == kx.shape
    torch.testing.assert_close(y, yr, **SSD_TOL[torch.float32])
    torch.testing.assert_close(st, str_, **STATE_TOL)


@pytest.mark.gpu
def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, a, b, c = _ssd(2, 1, 64, 4, 2, 64, 128, torch.float32)
    with pytest.raises(ValueError):                 # mixed dtypes
        ssd_scan(x, dt, a, b.to(torch.bfloat16), c, chunk=64)
    with pytest.raises(ValueError):                 # 3 groups for 4 heads
        ssd_scan(x, dt, a, b[:, :, :1].expand(1, 64, 3, 128),
                 c[:, :, :1].expand(1, 64, 3, 128), chunk=64)
    with pytest.raises(ValueError):                 # head_dim 48
        ssd_scan(x[..., :48], dt, a, b, c, chunk=64)
    with pytest.raises(ValueError):                 # f32 in, bf16 out
        ssd_scan(x, dt, a, b, c, chunk=64, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                 # dt on the CPU
        ssd_scan(x, dt.cpu(), a, b, c, chunk=64)
    with pytest.raises(ValueError):                 # chunk above 1024
        ssd_scan(*_ssd(3, 1, 1100, 4, 2, 64, 128, torch.float32),
                 chunk=2048)


# ------------------------------------------------------ batched engine --
@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba2-370m", "paper-backbone"])
def test_batched_engine_on_card_matches_cpu(cuda, name):
    """The batched mode on a tiny f32 variant: card and CPU streams are
    equal; the SSM stack runs the SSD kernel once per layer per prefill
    call, the dense stack the flash kernel once per layer per prefill
    call and the fused FFN once per layer per prefill call or step."""
    base = get_config(name)
    cfg = (base.reduced(d_model=64).with_updates(vocab_size=300,
                                                 ssm_chunk=16)
           if name == "mamba2-370m" else base.with_updates(
               num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=128, vocab_size=300))
    cfg = cfg.with_updates(activation_dtype="float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 300, n).astype(np.int32)
               for n in (5, 20, 40)]
    kernels = (ssd_scan, flash_attention, fused_ffn, paged_decode_attention)
    streams = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(cfg, init_params(cfg, seed=2, device=device),
                            slots=2, max_seq=64,
                            compile_cache=CompileCache(), device=device)
        before = [fn.launches for fn in kernels]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6,
                        sampling=SamplingOpts(temperature=0.8 * (i % 2),
                                              seed=3))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        streams[device] = [tuple(r.generated) for r in reqs]
        if device == "cuda":
            n, pf = cfg.num_layers, eng.stats.prefill_calls
            dc = eng.stats.decode_calls
            want = ([n * pf, 0, 0, 0] if name == "mamba2-370m"
                    else [0, n * pf, n * (pf + dc), 0])
            assert [fn.launches - b for fn, b in zip(kernels, before)] \
                == want
    assert streams["cuda"] == streams["cpu"]
