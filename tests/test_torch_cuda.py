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
largest output).  The activation-quantization kernels (K4 int8, K5
int4) compute the plain version's f32 arithmetic element by element, so
their codes, packed bytes, scales and dequantized values must be
bit-equal to it, on the card and against the CPU: no tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.engine import act_compress
from repro_torch.engine.swap import Swapper
from repro_torch.kernels import (act_dequant, act_dequant4, act_quant,
                                 act_quant4)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.act_quant import kv_quant_rows
from repro_torch.kernels.flash_attn import attention_route, flash_attention
from repro_torch.kernels.fused_ffn import ffn_plan, fused_ffn
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


class _EagerStep:
    """Stands in for ``StepGraph``: runs the step eagerly every time."""

    def __init__(self, step, device):
        self._step = step

    def __call__(self):
        return self._step()


@pytest.mark.gpu
@pytest.mark.parametrize("name,mode", [("paper-backbone", "paged"),
                                       ("paper-backbone", "batched"),
                                       ("mamba2-370m", "batched"),
                                       ("olmoe-1b-7b", "paged"),
                                       ("olmoe-1b-7b", "batched")])
def test_graph_replayed_engine_matches_eager_steps(cuda, monkeypatch, name,
                                                   mode):
    """On the card the paged block-table step and the batched decode and
    decode_greedy steps are replayed as CUDA graphs.  Over a short wave
    of greedy and sampled requests (slots recycled, so the graphs replay
    after admissions write into their buffers) the graph-replayed
    engine's streams equal those of an engine whose steps run eagerly,
    and the kernels' launch counts, replays included, are equal too.
    The MoE decode step (dense dispatch, stable top-k) replays too."""
    from repro_torch.serving import engine as engine_mod
    if name == "mamba2-370m":
        cfg = get_config(name).reduced(d_model=64).with_updates(
            vocab_size=300, ssm_chunk=16, activation_dtype="float32")
    elif name == "olmoe-1b-7b":
        cfg = get_config(name).reduced(d_model=64, max_experts=16) \
            .with_updates(vocab_size=300, activation_dtype="float32")
    else:
        cfg = get_config(name).with_updates(
            num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=300,
            activation_dtype="float32")
    params = init_params(cfg, seed=1, device=cuda)
    kw = dict(decode_mode=mode)
    if mode == "paged":
        kw["opts"] = RuntimeOptions(paged_kernel=True, kv_dtype="int8")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 300, n).astype(np.int32)
               for n in (5, 20, 33, 9, 14)]
    fns = (paged_decode_attention, flash_attention, fused_ffn, ssd_scan)
    runs = {}
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(engine_mod, "StepGraph", _EagerStep)
        eng = ServingEngine(cfg, params, slots=2, max_seq=64,
                            compile_cache=CompileCache(), device=cuda, **kw)
        before = [fn.launches for fn in fns]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=7,
                        sampling=SamplingOpts(temperature=0.8 * (i % 2),
                                              seed=3))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.drain()
        torch.cuda.synchronize()
        runs[eager] = ([tuple(r.generated) for r in reqs],
                       [fn.launches - b for fn, b in zip(fns, before)],
                       eng.stats.decode_calls)
        if not eager:
            assert eng.metrics.counter("engine.graph_captures").value >= 1
            assert all(g._graph is not None for g in eng._graphs.values())
    assert runs[False] == runs[True]


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


def _k1_repeats(args, sc, window=0):
    """K1 once and again: the two outputs must be bit for bit equal (the
    splits merge in a fixed order, with no atomics on values)."""
    out = paged_decode_attention(*args, **sc, window=window)
    again = paged_decode_attention(*args, **sc, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pos,window", [
    (128, 0), (256, 0), (129, 0), (140, 20), (260, 8), (2048, 0),
    (2048, 300)])
def test_kernel_split_edges(cuda, pool, pos, window):
    """Positions on and beside a 128-column split boundary, windows that
    cross one, and tables full to their last row (mb 128)."""
    args, sc = _case(pos + window, slots=4, kvh=2, group=4, hd=32, bs=16,
                     mb=128, pool=pool, q_dtype=torch.bfloat16)
    args[4].fill_(pos)
    out = _k1_repeats(args, sc, window)
    ref = paged_decode_attn_ref(*args, **sc, window=window)
    torch.testing.assert_close(out, ref, **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_one_block_tables(cuda, q_dtype):
    """mb 1: one split, positions 0..16, pos 0 giving v_new exactly."""
    args, sc = _case(17, slots=8, kvh=2, group=2, hd=32, bs=16, mb=1,
                     pool=torch.int8, q_dtype=q_dtype)
    args[4].copy_(torch.tensor([0, 1, 2, 5, 8, 15, 16, 16],
                               dtype=torch.int32))
    out = _k1_repeats(args, sc)
    ref = paged_decode_attn_ref(*args, **sc)
    torch.testing.assert_close(out, ref, **TOL[q_dtype])
    assert torch.equal(out[0], args[6][0].repeat_interleave(2, dim=0))


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


@pytest.mark.gpu
@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True,
                                                          window=100),
                                  dict(causal=True, kv_len=150),
                                  dict(causal=False, kv_len=0)],
                         ids=["causal", "window100", "kv_len150", "kv_len0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_256(cuda, mask, dtype):
    """hd 256 (gemma-7b, gemma3-12b) on both routes, GQA 4 over 2."""
    q, k, v = _qkv(256, 2, 4, 2, 333, 256, dtype)
    out = flash_attention(q, k, v, **mask)
    ref = flash_attn_ref(q, k.repeat_interleave(2, 1),
                         v.repeat_interleave(2, 1), **mask)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    if mask.get("kv_len") == 0:
        assert bool((out == 0).all())


TC_FLASH_MASKS = [dict(causal=True), dict(causal=True, window=1),
                  dict(causal=True, kv_len=0), dict(causal=True, kv_len=37),
                  dict(causal=False, window=70)]


@pytest.mark.gpu
@pytest.mark.parametrize("mask", TC_FLASH_MASKS,
                         ids=["-".join(f"{k}{v}" for k, v in m.items())
                              for m in TC_FLASH_MASKS])
@pytest.mark.parametrize("s,hd", [(1, 32), (63, 16), (130, 64),
                                  (1000, 32), (257, 128)])
def test_flash_tensor_core_route(cuda, mask, s, hd):
    """The bf16 route: S not a multiple of the 64-row tile, 8 heads over
    2 KV heads, the masks at the edges, and a repeat bit for bit."""
    assert attention_route(torch.bfloat16) == "tensor_cores"
    q, k, v = _qkv(s * hd, 2, 8, 2, s, hd, torch.bfloat16)
    out = flash_attention(q, k, v, **mask)
    ref = flash_attn_ref(q, k.repeat_interleave(4, 1),
                         v.repeat_interleave(4, 1), **mask)
    torch.testing.assert_close(out, ref, **TOL[torch.bfloat16])
    if mask.get("kv_len") == 0:
        assert bool((out == 0).all())
    assert torch.equal(out, flash_attention(q, k, v, **mask))


@pytest.mark.gpu
def test_flash_tensor_core_route_rejects_misaligned_rows(cuda):
    q, k, v = _qkv(3, 1, 4, 4, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError):                 # rows 2 bytes off
        flash_attention(q[..., 1:17], k[..., 1:17], v[..., 1:17])


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


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,f", [(1, 256, 1024), (64, 256, 1000),
                                   (65, 256, 1024), (127, 264, 200),
                                   (8195, 256, 1024), (300, 512, 1032),
                                   (200, 1024, 4096), (16, 1024, 4096)])
def test_ffn_bf16_routes_ragged_and_wide(cuda, m, d, f):
    """The bf16 routes (small M and tiles, x resident or streamed): ragged
    M and F, D above 256 over several output tiles, and a repeat bit for
    bit (no atomics; the small-M counters reset themselves)."""
    x, wg, wu, wd = _ffn(m + f, m, d, f, torch.bfloat16)
    plan = ffn_plan(torch.bfloat16, m, d, f)
    assert plan.route == ("small_m" if m <= 64 else "tiles")
    out = fused_ffn(x, wg, wu, wd, "gelu")
    ref = fused_ffn_ref(x, wg, wu, wd, "gelu")
    torch.testing.assert_close(out, ref, **FFN_TOL[torch.bfloat16])
    for _ in range(2):
        assert torch.equal(out, fused_ffn(x, wg, wu, wd, "gelu"))


@pytest.mark.gpu
def test_ffn_bf16_rejects_what_it_does_not_take(cuda):
    x, wg, wu, wd = _ffn(3, 16, 64, 128, torch.bfloat16)
    with pytest.raises(ValueError):                 # F not a multiple of 8
        fused_ffn(x, wg[:, :100].contiguous(), wu[:, :100].contiguous(),
                  wd[:100])
    with pytest.raises(ValueError):                 # x 2 bytes off
        fused_ffn(torch.empty(17 * 64, dtype=torch.bfloat16,
                              device="cuda")[1:1025].view(16, 64), wg, wu,
                  wd)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [255, 256, 257, 4096])
def test_ssd_kernel_chunk_split_edges(cuda, dtype, s):
    """S one short of a chunk, a chunk, one past it, and 16 chunks, with
    an initial state carried through the state pass; each repeats bit
    for bit."""
    args = _ssd(s, 2, s, 4, 1, 64, 128, dtype)
    init = torch.randn(2, 4, 64, 128, device="cuda")
    for initial in (None, init):
        y, st = ssd_scan(*args, chunk=256, initial_state=initial)
        y2, st2 = ssd_scan(*args, chunk=256, initial_state=initial)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(st, st2)
        yr, str_ = ssd_scan_ref(*args, chunk=256, initial_state=initial)
        torch.testing.assert_close(y, yr, **SSD_TOL[dtype])
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


# -------------------------------------------- activation quantization --
def _act_x(m, n, dtype, seed, scale=3.0):
    x = torch.randn(m, n, generator=torch.Generator().manual_seed(seed))
    x = x * scale
    x[0, :min(n, 128)] = 0.0                    # an all-zero block
    return x.to(dtype)


def _assert_codec_bit_equal(x):
    """K4 and K5 on the card against the plain version on the card and on
    the CPU: codes, packed bytes, scales and both dequantized dtypes."""
    n = x.shape[1]
    xc = x.cuda()
    for quant, dequant, pq, pdq, kw in (
            (act_quant, act_dequant, kref.act_quant_ref,
             kref.act_dequant_ref, {}),
            (act_quant4, act_dequant4, kref.act_quant4_ref,
             kref.act_dequant4_ref, {"n": n})):
        before = (quant.launches, dequant.launches)
        q, s = quant(xc)
        qr, sr = pq(xc)
        qc, sc = pq(x)
        torch.cuda.synchronize()
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
        for od in (torch.bfloat16, torch.float32):
            d = dequant(q, s, od, **kw)
            assert d.dtype == od and d.shape == x.shape
            assert torch.equal(d, pdq(qr, sr, od, **kw))
            assert torch.equal(d.cpu(), pdq(qc, sc, od, **kw))
        assert (quant.launches, dequant.launches) == (before[0] + 1,
                                                      before[1] + 2)
        if quant is act_quant4 and n % 128:
            assert bool((q[:, (n + 1) // 2:] == 0x88).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [128, 256, 2048, 50280])
@pytest.mark.parametrize("m", [1, 7, 256])
def test_act_quant_kernels_bit_equal(cuda, m, n, dtype):
    _assert_codec_bit_equal(_act_x(m, n, dtype, m * 7 + n))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 130, 201, 50281])
def test_act_quant_kernels_odd_rows(cuda, n):
    """n % 4 != 0: the masked scalar path of loads and stores."""
    _assert_codec_bit_equal(_act_x(5, n, torch.float32, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_quant_kernels_misaligned_input(cuda, dtype):
    """A contiguous view that starts one element into its buffer: the
    vector loads are off, the results the same."""
    buf = _act_x(1, 1 + 6 * 256, dtype, 5).cuda()
    x = buf[0, 1:].view(6, 256)
    q, s = act_quant(x)
    p, s4 = act_quant4(x)
    q2, s2 = kref.act_quant_ref(x)
    p2, s42 = kref.act_quant4_ref(x)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert torch.equal(p, p2) and torch.equal(s4, s42)


@pytest.mark.gpu
def test_act_quant_kernels_ties_and_range(cuda):
    """Values on exact half-steps round half to even like torch.round;
    int4 nibbles stay in [1, 15]; large and tiny magnitudes."""
    base = torch.arange(-127, 128, dtype=torch.float32) + 0.5
    x = torch.cat([base[:128], base[127:255], torch.full((128,), 1e-30),
                   torch.full((128,), 3e30)]).reshape(4, 128)
    x[0, 0] = 127.0                             # amax 127: scale ~1
    _assert_codec_bit_equal(x)
    p, _ = act_quant4(x.cuda())
    assert int((p & 0xF).min()) >= 1 and int((p >> 4).min()) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_compress_on_card_matches_cpu(cuda, dtype):
    """The codec through ``act_compress`` with leading dimensions and a
    ragged last axis: card == CPU bit for bit; ``compression_error``
    within 1e-5 relative (sums in another order)."""
    x = torch.randn(2, 3, 50280, generator=torch.Generator().manual_seed(9))
    x = x.to(dtype)
    xc = x.cuda()
    before = [f.launches for f in (act_quant, act_dequant,
                                   act_quant4, act_dequant4)]
    q, s = act_compress.quantize_int8(xc)
    p, s4 = act_compress.quantize_int4(xc)
    assert q.shape == x.shape and s.shape == (2, 3, 393)
    assert p.shape == (2, 3, 393 * 64)
    q0, s0 = act_compress.quantize_int8(x)
    p0, s40 = act_compress.quantize_int4(x)
    assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    assert torch.equal(p.cpu(), p0) and torch.equal(s4.cpu(), s40)
    assert torch.equal(act_compress.dequantize_int8(q, s).cpu(),
                       act_compress.dequantize_int8(q0, s0))
    assert torch.equal(act_compress.dequantize_int4(p, s4, 50280).cpu(),
                       act_compress.dequantize_int4(p0, s40, 50280))
    for bits in (8, 4):
        a = act_compress.compression_error(xc, bits)
        b = act_compress.compression_error(x, bits)
        assert abs(a - b) <= 1e-5 * b
    assert [f.launches - b for f, b in zip(
        (act_quant, act_dequant, act_quant4, act_dequant4),
        before)] == [2, 2, 2, 2]


@pytest.mark.gpu
def test_act_quant_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(4, 256, device="cuda")
    q, s = act_quant(x)
    p, s4 = act_quant4(x)
    with pytest.raises(ValueError):                 # f16 input
        act_quant(x.half())
    with pytest.raises(ValueError):                 # 3-D input
        act_quant4(x[None])
    with pytest.raises(ValueError):                 # scales of another shape
        act_dequant(q, s[:, :1])
    with pytest.raises(ValueError):                 # scales on the CPU
        act_dequant(q, s.cpu())
    with pytest.raises(ValueError):                 # f16 output
        act_dequant4(p, s4, torch.float16)
    with pytest.raises(ValueError):                 # packed too narrow for n
        act_dequant4(p, s4, n=300)
    with pytest.raises(ValueError):                 # codes not int8
        act_dequant(q.to(torch.int16), s)


# --------------------------------------------------------------- swap --
@pytest.mark.gpu
def test_swapper_round_trip_through_pinned_memory(cuda):
    """A real move: the host copy lies in pinned memory and holds the
    bits; ``fetch`` brings them back to the card bit for bit; the books
    count both directions."""
    x = torch.randn(1000, 256, device="cuda")
    q, s = act_compress.quantize_int8(x)
    sw = Swapper(use_memory_kinds=True)
    hq = sw.offload("q", q)
    hs = sw.offload("s", s)
    assert hq.device.type == "cpu" and hq.is_pinned() and hs.is_pinned()
    torch.cuda.synchronize()
    assert torch.equal(hq, q.cpu()) and torch.equal(hs, s.cpu())
    bq, bs = sw.fetch("q"), sw.fetch("s")
    assert bq.device == q.device and bs.device == s.device
    assert torch.equal(bq, q) and torch.equal(bs, s)
    nbytes = q.numel() + s.numel() * 4
    assert sw.total_bytes() == 2 * nbytes
    assert [r.direction for r in sw.records] == ["out", "out", "in", "in"]
    assert sw.resident_host == {}


@pytest.mark.gpu
def test_swapper_orders_copies_against_the_callers_stream(cuda):
    """The offload copy waits for the work that writes its source, and
    the caller's later work waits for the fetch."""
    sw = Swapper(use_memory_kinds=True)
    x = torch.zeros(1 << 22, device="cuda")
    x.add_(1.0)                                 # queued before the offload
    sw.offload("x", x)
    del x                                       # its memory outlives the copy
    y = torch.full((1 << 22,), 5.0, device="cuda")
    back = sw.fetch("x")
    back.mul_(3.0)                              # after the fetch
    torch.cuda.synchronize()
    assert bool((back == 3.0).all()) and bool((y == 5.0).all())


@pytest.mark.gpu
def test_swapper_failed_move_raises(cuda):
    sw = Swapper(use_memory_kinds=True)
    with pytest.raises(ValueError):             # not on a card
        sw.offload("x", torch.zeros(8))
    with pytest.raises(KeyError):               # never offloaded
        sw.fetch("y")
    assert Swapper().offload("z", torch.zeros(8, device="cuda")).is_cuda


@pytest.mark.gpu
def test_swapper_reuses_pinned_buffers(cuda):
    """A second offload of the same size page-locks nothing new, even
    right after the fetch (its copy waits on the side stream for the
    copy out of the buffer); another size gets a buffer of its own;
    ``release`` unpins the pool."""
    sw = Swapper(use_memory_kinds=True)
    x = torch.randn(1 << 20, device="cuda")
    first = sw.offload("x", x)
    ptr = first.data_ptr()
    back = sw.fetch("x")
    y = x * 2
    again = sw.offload("y", y)          # no synchronize in between
    assert sw.pinned_allocations == 1 and again.data_ptr() == ptr
    assert torch.equal(back, x) and torch.equal(sw.fetch("y"), y)
    z = torch.zeros(7, device="cuda")
    sw.offload("z", z)
    assert sw.pinned_allocations == 2
    sw.release()
    assert torch.equal(sw.fetch("z"), z)
    sw.offload("x", x)
    assert sw.pinned_allocations == 3


# ------------------------------------------------ K2/K3 under autograd ----
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,mask", [(8, 8, dict(causal=True)),
                                        (8, 2, dict(causal=True, window=9)),
                                        (4, 1, dict(causal=False,
                                                    kv_len=20))])
def test_flash_attention_gradients_on_card(cuda, dtype, h, kvh, mask):
    """With inputs that require grad the wrapper still launches the kernel
    (once), and its backward gives the CPU autograd gradients of the plain
    version: f32 within the f32 kernel tolerance times 10 (a backward
    sums over S more terms than the forward), bf16 within 3e-2."""
    rng = np.random.default_rng(h + kvh)
    b, s, hd = 2, 40, 32

    def leaf(n):
        t = torch.from_numpy(rng.standard_normal((b, s, n, hd)).astype(
            np.float32)).to(dtype).cuda().transpose(1, 2)
        return t.detach().requires_grad_()
    q, k, v = leaf(h), leaf(kvh), leaf(kvh)
    dout = torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(
        np.float32))
    before = flash_attention.launches
    out = flash_attention(q, k, v, **mask)
    assert flash_attention.launches == before + 1 and out.requires_grad
    got = torch.autograd.grad(out, (q, k, v), dout.to(dtype).cuda())
    assert flash_attention.launches == before + 1   # backward: no launch
    cq, ck, cv = (t.detach().cpu().float().requires_grad_()
                  for t in (q, k, v))
    g = h // kvh
    ref = flash_attn_ref(cq, ck.repeat_interleave(g, 1),
                         cv.repeat_interleave(g, 1), **mask)
    want = torch.autograd.grad(ref, (cq, ck, cv), dout)
    tol = (dict(atol=2e-4, rtol=1e-3) if dtype == torch.float32
           else dict(atol=3e-2, rtol=3e-2))
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        torch.testing.assert_close(a.cpu().float(), w, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_fused_ffn_gradients_on_card(cuda, dtype, activation):
    """The fused FFN's launch under autograd: one launch, and the CPU
    autograd gradients of the plain version (f32 within 1e-4 relative to
    each gradient's scale, bf16 within 3e-2)."""
    x, wg, wu, wd = (t.detach().requires_grad_()
                     for t in _ffn(9, 64, 256, 1024, dtype))
    dy = torch.randn(64, 256, generator=torch.Generator().manual_seed(1))
    before = fused_ffn.launches
    y = ops.gated_ffn(x, wg, wu, wd, activation)
    assert fused_ffn.launches == before + 1 and y.requires_grad
    got = torch.autograd.grad(y, (x, wg, wu, wd), dy.to(dtype).cuda())
    cpu = [t.detach().cpu().float().requires_grad_()
           for t in (x, wg, wu, wd)]
    want = torch.autograd.grad(fused_ffn_ref(*cpu, activation), cpu, dy)
    for a, w in zip(got, want):
        scale = float(w.abs().max())
        rel = 1e-4 if dtype == torch.float32 else 3e-2
        torch.testing.assert_close(a.cpu().float(), w, atol=rel * scale,
                                   rtol=rel)


@pytest.mark.gpu
def test_crowd_migration_on_card(cuda):
    """The chaos suite's crash migration on the card, tiny paper-backbone
    in f32: a paged engine-backed helper crashes, the detector evicts it,
    its decoding requests freeze and thaw on a batched peer and its
    waiting ones move.  Streams equal an unfaulted engine's on the card;
    thaws equal freezes; no re-prefill; K1 ran on the paged helper."""
    from repro_torch.core.monitor import ResourceContext, constant_trace
    from repro_torch.faults import (CRASH, DetectorConfig, FaultInjector,
                                    FaultSpec, summarize_faults)
    from repro_torch.fleet import FleetController, make_device
    from repro_torch.models.configs import InputShape
    from repro_torch.obs import TraceRecorder
    cfg = get_config("paper-backbone").with_updates(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=300, activation_dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    f32 = RuntimeOptions(kv_cache_dtype="float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 300, 5 + i).astype(np.int32)
               for i in range(4)]

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=30,
                        sampling=SamplingOpts(temperature=0.0))
                for i, p in enumerate(prompts)]

    base = ServingEngine(cfg, params, slots=2, max_seq=64, opts=f32,
                         compile_cache=CompileCache(), device="cuda")
    want = requests()
    for r in want:
        base.submit(r)
    base.drain()
    fleet = [make_device("pixel_6_cpu", 0, site="home"),
             make_device("jetson_agx_orin", 0, site="home"),
             make_device("jetson_agx_orin", 1, site="home"),
             make_device("edge_server_a100", 0, site="dc")]
    loaded = ResourceContext(cpu_temp_derate=0.45, competing_procs=4)
    rec = TraceRecorder()
    ctl = FleetController(
        fleet, get_config("paper-backbone"),
        InputShape("chaos_t", 256, 4, "prefill"), trace_ticks=4000,
        trace_factory=lambda spec, n: constant_trace(
            loaded if spec.device_id == "pixel_6_cpu#0"
            else ResourceContext(), n),
        placement=True, allow_offload=False, warmup_ticks=4,
        detector_config=DetectorConfig(suspect_after=2.5, dead_after=5.0),
        recorder=rec)
    ctl.set_sla("pixel_6_cpu#0", 0.5)
    src = ctl.build_engine("jetson_agx_orin#0", params, cfg=cfg, slots=2,
                           max_seq=64, decode_mode="paged",
                           opts=f32.replace(paged_kernel=True),
                           steps_per_tick=1)
    dst = ctl.build_engine("jetson_agx_orin#1", params, cfg=cfg, slots=2,
                           max_seq=64, opts=f32, steps_per_tick=4)
    reqs = requests()
    for r in reqs:
        src.submit(r)
    k1 = paged_decode_attention.launches
    src.step()
    src.step()
    FaultInjector(ctl, [FaultSpec(CRASH, "jetson_agx_orin#0",
                                  at_s=ctl.now_s + 0.5)]).arm()
    ctl.run_for(20.0)
    dst.drain()
    assert [tuple(r.generated) for r in reqs] == \
        [tuple(r.generated) for r in want]
    assert src.stats.freezes == 2 and dst.stats.thaws == 2
    assert ctl.migrations == 4
    assert summarize_faults(rec.events)["migrated_reprefills"] == 0
    assert paged_decode_attention.launches - k1 == \
        src.stats.decode_calls * cfg.num_layers > 0
