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
from repro_torch.kernels.flash_attn import (attention_route, flash_attention,
                                            flash_plan)
from repro_torch.kernels.fused_ffn import (ffn_plan, fused_ffn,
                                          fused_ffn_backward)
from repro_torch.kernels.paged_decode_attn import (decode_plan,
                                                   paged_decode_attention)
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
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_group_6_at_hd_128(cuda, q_dtype):
    """internvl2-26b's decode: 48 heads of 128 over 8 KV heads (group 6),
    an int8 pool, mb 64."""
    args, sc = _case(6, slots=8, kvh=8, group=6, hd=128, bs=16, mb=64,
                     pool=torch.int8, q_dtype=q_dtype)
    out = paged_decode_attention(*args, **sc)
    torch.testing.assert_close(out, paged_decode_attn_ref(*args, **sc),
                               **TOL[q_dtype])
    assert torch.equal(out, paged_decode_attention(*args, **sc))


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
                                       ("zamba2-1.2b", "batched"),
                                       ("olmoe-1b-7b", "paged"),
                                       ("olmoe-1b-7b", "batched"),
                                       ("whisper-small", "paged"),
                                       ("whisper-small", "batched")])
def test_graph_replayed_engine_matches_eager_steps(cuda, monkeypatch, name,
                                                   mode):
    """On the card the paged block-table step and the batched decode and
    decode_greedy steps are replayed as CUDA graphs.  Over a short wave
    of greedy and sampled requests (slots recycled, so the graphs replay
    after admissions write into their buffers) the graph-replayed
    engine's streams equal those of an engine whose steps run eagerly,
    and the kernels' launch counts, replays included, are equal too.
    The MoE decode step (dense dispatch, stable top-k) replays too, and
    so does the hybrid's (5 layers at period 2: two sites of the shared
    block, each writing its own K/V in place, and a leftover layer), and
    the encoder-decoder's (its cross blocks over the slot cache's cross
    K/V, admitted in place)."""
    from repro_torch.serving import engine as engine_mod
    if name == "mamba2-370m":
        cfg = get_config(name).reduced(d_model=64).with_updates(
            vocab_size=300, ssm_chunk=16, activation_dtype="float32")
    elif name == "zamba2-1.2b":
        cfg = get_config(name).reduced(num_layers=5, d_model=64) \
            .with_updates(shared_attn_period=2, vocab_size=300,
                          ssm_chunk=16, activation_dtype="float32")
    elif name == "olmoe-1b-7b":
        cfg = get_config(name).reduced(d_model=64, max_experts=16) \
            .with_updates(vocab_size=300, activation_dtype="float32")
    elif name == "whisper-small":
        cfg = get_config(name).reduced(d_model=64).with_updates(
            vocab_size=300, activation_dtype="float32")
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


# ------------------------------------------- K1's bf16 route on wgmma --
# (heads, kv heads, hd, mb): the served decode shapes (paper-backbone at
# max_seq 512 and 2048, olmoe-1b-7b, whisper-small, internvl2-26b group 6,
# gemma3-12b group 2, phi3-mini hd 96, gemma-7b and gemma3 hd 256, yi-34b
# group 7, qwen1.5-32b), 8 slots, block 16
K1_SERVED = [(8, 8, 32, 32), (8, 8, 32, 128), (16, 16, 128, 64),
             (12, 12, 64, 32), (48, 8, 128, 64), (16, 8, 256, 128),
             (32, 32, 96, 64), (16, 16, 256, 64), (56, 8, 128, 64),
             (40, 40, 128, 64)]
# (mb, positions of the 8 slots, window): split and tile edges (64-column
# tiles, splits of whole tiles), windows starting on and beside them,
# tables full to their last row, one-block tables
K1_WG_EDGES = [
    (128, [128, 256, 127, 129, 384, 1, 2047, 2048], 0),
    (128, [140, 130, 260, 2048, 300, 129, 1000, 16], 20),
    (128, [2048] * 8, 0),
    (128, [2048] * 8, 300),
    (128, [1, 129, 1023, 1150, 1151, 1152, 1279, 2048], 1024),
    (128, [64, 65, 63, 192, 193, 191, 0, 1024], 64),
    (1, [0, 1, 2, 5, 8, 15, 16, 16], 0),
    (1, [0, 1, 2, 5, 8, 15, 16, 16], 4),
]


def _k1_checked(args, sc, window=0):
    """One bf16 call on the wgmma route: exactly one launch, equal to the
    plain version within the bf16 tolerance, bit for bit on a repeat and
    inside a CUDA graph (captured on a side stream, replayed), pos 0
    giving v_new exactly."""
    q, kb = args[0], args[1]
    slots, h, hd = q.shape
    _, bs, kvh, _ = kb.shape
    assert decode_plan(slots, h, kvh, hd, bs, args[3].shape[1], kb.dtype,
                       q.dtype).route == "wgmma"
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args, **sc, window=window)
    assert paged_decode_attention.launches == before + 1
    again = paged_decode_attention(*args, **sc, window=window)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_decode_attention(*args, **sc, window=window)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = paged_decode_attention(*args, **sc, window=window)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, captured)
    ref = paged_decode_attn_ref(*args, **sc, window=window)
    torch.testing.assert_close(out, ref, **TOL[torch.bfloat16])
    group = h // kvh
    for slot in range(slots):
        if int(args[4][slot]) == 0:
            assert torch.equal(out[slot],
                               args[6][slot].repeat_interleave(group, dim=0))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,hd,mb", K1_SERVED, ids=[
    f"H{h}-kvh{k}-hd{d}-mb{m}" for h, k, d, m in K1_SERVED])
def test_k1_wgmma_route_at_served_shapes(cuda, pool, h, kvh, hd, mb):
    """K1's bf16 route at every served (H, kvh, hd): groups 1, 2, 6 and
    7, hd 32, 64, 96, 128 and 256, int8 and bf16 pools; ragged
    positions, one slot at 0 and one full to its last row."""
    args, sc = _case(h + hd + mb, slots=8, kvh=kvh, group=h // kvh, hd=hd,
                     bs=16, mb=mb, pool=pool, q_dtype=torch.bfloat16)
    _k1_checked(args, sc)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("kvh,group,hd", [(2, 4, 32), (8, 7, 128),
                                          (8, 2, 256), (4, 1, 96),
                                          (2, 16, 64), (1, 12, 128)])
@pytest.mark.parametrize("edge", range(len(K1_WG_EDGES)))
def test_k1_wgmma_route_edges(cuda, pool, kvh, group, hd, edge):
    """Positions on and beside the tile and split edges, windows whose
    first column falls on and beside them, full tables, one-block
    tables; groups 1 to 16 (N 8 and 16)."""
    mb, pos, window = K1_WG_EDGES[edge]
    args, sc = _case(edge * 31 + hd + group, slots=8, kvh=kvh, group=group,
                     hd=hd, bs=16, mb=mb, pool=pool, q_dtype=torch.bfloat16,
                     layers=2)
    args[4].copy_(torch.tensor(pos, dtype=torch.int32))
    _k1_checked(args, sc, window)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,mb", [(4, 64), (8, 32), (16, 16)])
def test_k1_wgmma_route_block_sizes(cuda, bs, mb):
    """Block sizes 4 and 8 (16 and 8 TMA boxes a 64-column tile)."""
    args, sc = _case(bs, slots=4, kvh=2, group=4, hd=64, bs=bs, mb=mb,
                     pool=torch.int8, q_dtype=torch.bfloat16)
    _k1_checked(args, sc)


@pytest.mark.gpu
def test_k1_f32_takes_the_cuda_core_route(cuda):
    """f32 q, and bf16 q over an f32 pool, keep the CUDA-core kernel
    (the plan says so, and it holds the f32 tolerance)."""
    for q_dtype, pool in ((torch.float32, torch.int8),
                          (torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.float32)):
        args, sc = _case(9, slots=8, kvh=2, group=4, hd=64, bs=16, mb=32,
                         pool=pool, q_dtype=q_dtype)
        assert decode_plan(8, 8, 2, 64, 16, 32, pool, q_dtype).route \
            == "cuda_cores"
        out = paged_decode_attention(*args, **sc)
        torch.testing.assert_close(out, paged_decode_attn_ref(*args, **sc),
                                   **TOL[q_dtype])


@pytest.mark.gpu
def test_k1_wgmma_route_rejects_what_it_does_not_take(cuda):
    """A CUDA call the bf16 route cannot take raises; nothing falls back
    to the CUDA-core kernel or the plain version."""
    cases = []
    args, sc = _case(1, slots=2, kvh=1, group=17, hd=64, bs=16, mb=2,
                     pool=torch.int8, q_dtype=torch.bfloat16)
    cases.append((args, sc))                          # group 17
    args, sc = _case(2, slots=2, kvh=2, group=2, hd=24, bs=16, mb=2,
                     pool=torch.bfloat16, q_dtype=torch.bfloat16)
    cases.append((args, sc))                          # hd 24
    args, sc = _case(3, slots=2, kvh=2, group=2, hd=64, bs=2, mb=8,
                     pool=torch.int8, q_dtype=torch.bfloat16)
    cases.append((args, sc))                          # 8-byte scale boxes
    args, sc = _case(4, slots=2, kvh=2, group=2, hd=64, bs=16, mb=2,
                     pool=torch.int8, q_dtype=torch.bfloat16)
    nb = sc["k_scale"].shape[0]
    bad = {}
    for name, t in sc.items():                        # 68-byte scale stride
        bad[name] = torch.zeros(nb, 17, device="cuda")[:, :16]
        bad[name].copy_(t)
    cases.append((args, bad))
    for args, sc in cases:
        before = paged_decode_attention.launches
        with pytest.raises(ValueError):
            paged_decode_attention(*args, **sc)
        assert paged_decode_attention.launches == before


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
@pytest.mark.parametrize("sq,sk,kv_len", [(16, 1500, None), (448, 1500, None),
                                          (1, 7, None), (100, 65, 40),
                                          (64, 200, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_cross_lengths(cuda, dtype, sq, sk, kv_len):
    """A key length apart from the query length (a decoder's
    cross-attention over encoder frames) on both routes, GQA 8 over 2:
    ragged query and key tiles, with and without ``kv_len``, equal to the
    plain version and repeating bit for bit; causal or windowed masks at
    unequal lengths raise."""
    q, _, _ = _qkv(sq, 2, 8, 2, sq, 64, dtype)
    _, k, v = _qkv(sk + 1, 2, 8, 2, sk, 64, dtype)
    mask = dict(causal=False, kv_len=kv_len)
    out = flash_attention(q, k, v, **mask)
    ref = flash_attn_ref(q, k.repeat_interleave(4, 1),
                         v.repeat_interleave(4, 1), **mask)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert torch.equal(out, flash_attention(q, k, v, **mask))
    if kv_len == 0:
        assert bool((out == 0).all())
    for bad in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError):
            flash_attention(q, k, v, **bad)


HD96_MASKS = [dict(causal=True), dict(causal=True, window=100),
              dict(causal=True, kv_len=150), dict(causal=True, window=1,
                                                  kv_len=37),
              dict(causal=False, kv_len=0)]


@pytest.mark.gpu
@pytest.mark.parametrize("mask", HD96_MASKS,
                         ids=["-".join(f"{k}{v}" for k, v in m.items())
                              for m in HD96_MASKS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,s", [(4, 4, 16), (4, 2, 1000), (2, 2, 257)])
def test_flash_kernel_head_dim_96(cuda, mask, dtype, h, kvh, s):
    """hd 96 (phi3-mini) on both routes: 12 16-byte chunks a row, so the
    bf16 route's K/V copies leave threads idle and a pass ends past the
    tile; MHA and GQA, ragged S; equal to the plain version and
    repeating bit for bit."""
    q, k, v = _qkv(96 + s + h, 2, h, kvh, s, 96, dtype)
    out = flash_attention(q, k, v, **mask)
    ref = flash_attn_ref(q, k.repeat_interleave(h // kvh, 1),
                         v.repeat_interleave(h // kvh, 1), **mask)
    torch.testing.assert_close(out, ref, **TOL[dtype])
    assert torch.equal(out, flash_attention(q, k, v, **mask))
    if mask.get("kv_len") == 0:
        assert bool((out == 0).all())


# 8 decode positions at mb 128 (max_seq 2048): with window 1024 the
# window's first column lands on, before and after the 128-column split
# boundaries 128 and 256; 129 crosses a boundary with no window cut
DENSE_FAMILY_POS = [1, 129, 1023, 1150, 1151, 1152, 1279, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("kvh,group,hd,window", [
    (32, 1, 96, 0),          # phi3-mini
    (16, 1, 256, 0),         # gemma-7b
    (8, 2, 256, 0),          # gemma3-12b, global layers
    (8, 2, 256, 1024),       # gemma3-12b, local layers
    (16, 1, 256, 1024),
    (8, 7, 128, 0),          # yi-34b
])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_dense_family_shapes(cuda, kvh, group, hd, window, q_dtype):
    """K1 at the dense families' decode shapes: hd 96 (48 columns a lane
    in a score, 3 output columns a lane), hd 256 with and without the
    1024-column window, group 7; an int8 pool, mb 128; equal to the
    plain version and repeating bit for bit."""
    args, sc = _case(hd + group + window, slots=8, kvh=kvh, group=group,
                     hd=hd, bs=16, mb=128, pool=torch.int8,
                     q_dtype=q_dtype, layers=2)
    args[4].copy_(torch.tensor(DENSE_FAMILY_POS, dtype=torch.int32))
    out = _k1_repeats(args, sc, window)
    ref = paged_decode_attn_ref(*args, **sc, window=window)
    torch.testing.assert_close(out, ref, **TOL[q_dtype])


WG_MASKS = [dict(causal=True), dict(causal=True, window=1),
            dict(causal=True, window=64), dict(causal=True, window=1007),
            dict(causal=True, kv_len=0), dict(causal=True, kv_len=671),
            dict(causal=True, window=64, kv_len=100),
            dict(causal=True, window=300, kv_len=500),
            dict(causal=False)]


def _wgmma_case(q, k, v, mask):
    """One bf16 call on the wgmma route: its plan, exactly one launch,
    the plain version within TOL, 0 where kv_len is 0, and a repeat
    equal bit for bit."""
    plan = flash_plan(q.dtype, q.shape[3], q.shape[2], k.shape[2],
                      q.shape[1], k.shape[1])
    assert plan.route == "wgmma"
    before = flash_attention.launches
    out = flash_attention(q, k, v, **mask)
    assert flash_attention.launches == before + 1
    g = q.shape[1] // k.shape[1]
    ref = flash_attn_ref(q, k.repeat_interleave(g, 1),
                         v.repeat_interleave(g, 1), **mask)
    torch.testing.assert_close(out, ref, **TOL[torch.bfloat16])
    if mask.get("kv_len") == 0:
        assert bool((out == 0).all())
    assert torch.equal(out, flash_attention(q, k, v, **mask))


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh", [(8, 8), (8, 4), (48, 8), (56, 8)],
                         ids=["group1", "group2", "group6", "group7"])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_flash_wgmma_route(cuda, hd, h, kvh):
    """K2's wgmma route (hd 64..256) at a ragged S of 1000 over every mask
    of chip_smoke's phase 2, at groups 1, 2, 6 (internvl2-26b) and 7
    (yi-34b)."""
    q, k, v = _qkv(hd + h, 1, h, kvh, 1000, hd, torch.bfloat16)
    for mask in WG_MASKS:
        _wgmma_case(q, k, v, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [16, 448])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_flash_wgmma_route_cross_lengths(cuda, hd, sq):
    """16 and 448 queries over 1500 keys (whisper-small's
    cross-attention) on the wgmma route, with and without kv_len."""
    q, _, _ = _qkv(sq + hd, 2, 8, 2, sq, hd, torch.bfloat16)
    _, k, v = _qkv(1500 + hd, 2, 8, 2, 1500, hd, torch.bfloat16)
    for mask in (dict(causal=False), dict(causal=False, kv_len=999),
                 dict(causal=False, kv_len=0)):
        _wgmma_case(q, k, v, mask)


# every mask of chip_smoke's phase 2 at S, for the hd 16/32 kernel
def _narrow_masks(s):
    return [dict(causal=True), dict(causal=True, window=1),
            dict(causal=True, window=64), dict(causal=True, window=s + 7),
            dict(causal=True, kv_len=0),
            dict(causal=True, kv_len=s * 2 // 3 + 5),
            dict(causal=True, window=64, kv_len=100),
            dict(causal=True, window=300, kv_len=500),
            dict(causal=False)]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 15, 63, 64, 65, 127, 129, 1000, 2048])
@pytest.mark.parametrize("kvh", [8, 2, 1], ids=["group1", "group4",
                                                "group8"])
@pytest.mark.parametrize("hd", [16, 32])
def test_flash_narrow_route(cuda, hd, kvh, s):
    """K2's hd 16/32 kernel (wgmma fed by TMA through the 32- and 64-byte
    swizzles) over every mask of chip_smoke's phase 2 at S around its
    query and key tiles, 8 heads over groups of 1, 4 and 8: the plain
    version within TOL, one launch a call, 0 where kv_len is 0, a repeat
    equal bit for bit."""
    q, k, v = _qkv(s + hd + kvh, 2, 8, kvh, s, hd, torch.bfloat16)
    for mask in _narrow_masks(s):
        _wgmma_case(q, k, v, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [16, 448])
@pytest.mark.parametrize("hd", [16, 32])
def test_flash_narrow_route_cross_lengths(cuda, hd, sq):
    """16 and 448 queries over 1500 keys on the hd 16/32 kernel, with and
    without kv_len."""
    q, _, _ = _qkv(sq + hd, 2, 8, 2, sq, hd, torch.bfloat16)
    _, k, v = _qkv(1500 + hd, 2, 8, 2, 1500, hd, torch.bfloat16)
    for mask in (dict(causal=False), dict(causal=False, kv_len=999),
                 dict(causal=False, kv_len=0)):
        _wgmma_case(q, k, v, mask)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32])
def test_flash_narrow_route_repeats(cuda, hd):
    """20 calls at a ragged shape (3 x 1000 rows, 8 heads over 2, causal
    under a window past kv_len) equal bit for bit: each tile is computed
    whole by one block in a fixed order, whatever block takes it."""
    q, k, v = _qkv(hd, 3, 8, 2, 1000, hd, torch.bfloat16)
    mask = dict(causal=True, window=300, kv_len=777)
    first = flash_attention(q, k, v, **mask)
    for _ in range(20):
        assert torch.equal(first, flash_attention(q, k, v, **mask))


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
@pytest.mark.parametrize("m,d,f", [
    (1, 256, 1024), (64, 256, 1000), (65, 256, 1024), (127, 264, 200),
    (8195, 256, 1024), (300, 512, 1032), (200, 1024, 4096),
    (16, 1024, 4096),
    # D > 512: stream (M <= 24) and two_pass, ragged M and F
    (1, 2048, 8192), (8, 2048, 8192), (63, 2048, 8192), (64, 2048, 8192),
    (65, 2048, 8192), (2049, 2048, 8192), (8, 2048, 1000),
    (65, 2048, 1032), (1, 6144, 16384), (8, 6144, 16384),
    (64, 6144, 16384), (65, 6144, 2056), (2049, 6144, 16384)])
def test_ffn_bf16_routes_ragged_and_wide(cuda, m, d, f):
    """The bf16 routes (small_m up to M 64 at D <= 512, stream for the
    other M <= 24, two_pass above): ragged M and F, D over several output
    tiles and chunks, and a repeat bit for bit (no atomics; the arrival
    counters reset themselves)."""
    x, wg, wu, wd = _ffn(m + f, m, d, f, torch.bfloat16)
    plan = ffn_plan(torch.bfloat16, m, d, f)
    if d <= 512:
        assert plan.route == ("small_m" if m <= 64 else "two_pass")
    elif plan.route != "small_m":
        assert plan.route == ("stream" if m <= 24 else "two_pass")
    out = fused_ffn(x, wg, wu, wd, "gelu")
    ref = fused_ffn_ref(x, wg, wu, wd, "gelu")
    torch.testing.assert_close(out, ref, **FFN_TOL[torch.bfloat16])
    for _ in range(2):
        assert torch.equal(out, fused_ffn(x, wg, wu, wd, "gelu"))


# small_m at its edges: every M <= 64 at D 16..512 (multiples of 8, some
# not of 64), and D 1024 at M <= 32 (F split over clusters); F not a
# multiple of the 64-column unit
SMALL_M_CASES = ([(m, d, 1000) for m in (1, 7, 8, 9, 16, 24, 33, 48, 64)
                  for d in (16, 24, 96, 256, 264, 512)]
                 + [(m, 1024, 4104) for m in (1, 8, 17, 32)]
                 + [(64, 512, 2056), (8, 256, 200), (48, 576, 3080)])


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("m,d,f", SMALL_M_CASES)
def test_ffn_small_m_route(cuda, m, d, f, activation):
    """The small_m route (one launch of thread-block clusters, the F split
    summed through distributed shared memory) against the plain version
    under FFN_TOL: one count a call, and three repeats bit for bit (the
    cluster's sum and the F ranges' sums go in a fixed order; the
    counters reset themselves)."""
    x, wg, wu, wd = _ffn(m * 3 + d + f, m, d, f, torch.bfloat16)
    assert ffn_plan(torch.bfloat16, m, d, f).route == "small_m"
    before = fused_ffn.launches
    out = fused_ffn(x, wg, wu, wd, activation)
    torch.cuda.synchronize()
    assert fused_ffn.launches == before + 1
    assert fused_ffn.last_route == "small_m"
    torch.testing.assert_close(out, fused_ffn_ref(x, wg, wu, wd, activation),
                               **FFN_TOL[torch.bfloat16])
    for _ in range(3):
        assert torch.equal(out, fused_ffn(x, wg, wu, wd, activation))


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,f", [(8, 256, 1024), (16, 1024, 4104)])
def test_ffn_small_m_route_in_a_cuda_graph(cuda, m, d, f):
    """The small_m route captured in a CUDA graph (a cluster launch; at D
    1024 with F split over clusters, its workspace from the graph's pool
    and its counters) and replayed on new inputs copied in place: each
    replay equals the eager call bit for bit, and counts as one launch."""
    x, wg, wu, wd = _ffn(11, m, d, f, torch.bfloat16)
    fused_ffn(x, wg, wu, wd)                       # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = fused_ffn.launches
    with torch.cuda.graph(graph):
        y = fused_ffn(x, wg, wu, wd)
    assert fused_ffn.launches == before + 1
    for seed in (12, 13):
        fresh = _ffn(seed, m, d, f, torch.bfloat16)[0]
        x.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, fused_ffn(fresh, wg, wu, wd))


@pytest.mark.gpu
def test_ffn_small_m_repeats_with_f_split(cuda):
    """A shape whose F is split over clusters (D 1024): 20 calls give the
    first call's output bit for bit (the last range to arrive adds the
    ranges in order and resets its counter)."""
    x, wg, wu, wd = _ffn(14, 32, 1024, 4096, torch.bfloat16)
    assert ffn_plan(torch.bfloat16, 32, 1024, 4096).small.fsplits > 1
    out = fused_ffn(x, wg, wu, wd, "gelu")
    for _ in range(20):
        assert torch.equal(out, fused_ffn(x, wg, wu, wd, "gelu"))


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("f", [1000, 1032])
@pytest.mark.parametrize("d", [2048, 3072, 5120, 6144, 7168, 1544])
@pytest.mark.parametrize("m", [1, 8, 24])
def test_ffn_stream_route(cuda, m, d, f, activation):
    """The stream route (M <= 24 at D > 512) against the plain version:
    each served D, one that is a multiple of 8 but not of 64 (1544: a
    ragged output tile and D chunk), ragged F (1000: a ragged unit and F
    chunk; 1032: a unit and a chunk of 8), both activations; one count a
    call (its two launches count once) and a repeat bit for bit (the
    split items' partials are added in block order; the counters reset
    themselves)."""
    x, wg, wu, wd = _ffn(m * d + f, m, d, f, torch.bfloat16)
    assert ffn_plan(torch.bfloat16, m, d, f).route == "stream"
    before = fused_ffn.launches
    out = fused_ffn(x, wg, wu, wd, activation)
    torch.cuda.synchronize()
    assert fused_ffn.launches == before + 1
    assert fused_ffn.last_route == "stream"
    torch.testing.assert_close(out, fused_ffn_ref(x, wg, wu, wd, activation),
                               **FFN_TOL[torch.bfloat16])
    for _ in range(2):
        assert torch.equal(out, fused_ffn(x, wg, wu, wd, activation))


@pytest.mark.gpu
def test_ffn_stream_route_in_a_cuda_graph(cuda):
    """The stream route captured in a CUDA graph (its workspaces from the
    graph's pool, its tensor maps encoded at capture) and replayed twice
    on new inputs copied in place: each replay equals the eager call on
    the same inputs, bit for bit, so the arrival counters are back at
    zero after every replay."""
    m, d, f = 8, 2048, 8192
    x, wg, wu, wd = _ffn(5, m, d, f, torch.bfloat16)
    fused_ffn(x, wg, wu, wd)                       # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fused_ffn(x, wg, wu, wd)
    for seed in (6, 7):
        fresh = _ffn(seed, m, d, f, torch.bfloat16)[0]
        x.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, fused_ffn(fresh, wg, wu, wd))


@pytest.mark.gpu
@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("m,d,f", [
    (25, 2048, 1000), (65, 2048, 1032), (129, 1544, 1000),
    (300, 1544, 1032), (129, 2048, 8192), (300, 1544, 4104),
    (32, 7168, 20480), (64, 6144, 16384), (1024, 256, 1024),
    (127, 264, 200), (4096, 2048, 8192), (2048, 1544, 4104),
    (4096, 2056, 1032)])
def test_ffn_two_pass_route(cuda, m, d, f, activation):
    """The two_pass route against the plain version: ragged M (rows past
    M zero-filled and never stored), ragged F (1000, 1032) and D (1544, 264:
    boxes partly or wholly past the edge), a pass whose last wave is cut
    into K parts (M 129 at F 8192: pass 2's 16 tiles in 8 parts; M 300 at
    F 4104: both passes), the 32- and 64-row decode steps at yi-34b's and
    internvl2-26b's widths, paper-backbone's D 256, a train step's M
    4096, and last column tiles that store one of their boxes (D mod 256
    = 8, F mod 128 = 8) over several tiles a block; one count a call and
    20 repeats bit for bit (the parts' shares are summed in part order,
    the counters reset themselves, a staging box is rewritten only once
    the store that read it is done)."""
    x, wg, wu, wd = _ffn(m * 7 + f, m, d, f, torch.bfloat16)
    plan = ffn_plan(torch.bfloat16, m, d, f)
    assert plan.route == "two_pass"
    before = fused_ffn.launches
    out = fused_ffn(x, wg, wu, wd, activation)
    torch.cuda.synchronize()
    assert fused_ffn.launches == before + 1
    assert fused_ffn.last_route == "two_pass"
    torch.testing.assert_close(out, fused_ffn_ref(x, wg, wu, wd, activation),
                               **FFN_TOL[torch.bfloat16])
    for _ in range(20):
        assert torch.equal(out, fused_ffn(x, wg, wu, wd, activation))


@pytest.mark.gpu
def test_ffn_two_pass_route_in_a_cuda_graph(cuda):
    """The two_pass route at a 32-row decode step (both passes' last
    waves cut into K parts, so the arrival counters and the f32 shares
    are used) captured in a CUDA graph and replayed twice on new inputs
    copied in place: each replay equals the eager call bit for bit, so
    the counters are back at zero after every replay."""
    m, d, f = 32, 2048, 8192
    assert max(ffn_plan(torch.bfloat16, m, d, f).two_pass.parts) > 1
    x, wg, wu, wd = _ffn(8, m, d, f, torch.bfloat16)
    fused_ffn(x, wg, wu, wd)                       # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fused_ffn(x, wg, wu, wd)
    for seed in (9, 10):
        fresh = _ffn(seed, m, d, f, torch.bfloat16)[0]
        x.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, fused_ffn(fresh, wg, wu, wd))


@pytest.mark.gpu
def test_fused_ffn_op_two_pass_under_autograd(cuda):
    """K3's custom operator at a train step's shape (M 4096, D 2048, F
    8192, bf16: the two_pass route) under autograd: one launch, the plain
    version's output within FFN_TOL, and the gradients of
    ``fused_ffn_backward`` on the same inputs, bit for bit."""
    m, d, f = 4096, 2048, 8192
    assert ffn_plan(torch.bfloat16, m, d, f).route == "two_pass"
    x, wg, wu, wd = (t.detach().requires_grad_()
                     for t in _ffn(14, m, d, f, torch.bfloat16))
    dy = torch.randn(m, d, generator=torch.Generator().manual_seed(3)
                     ).to(torch.bfloat16).cuda()
    before = fused_ffn.launches
    y = torch.ops.repro_torch.fused_ffn(x, wg, wu, wd, "gelu")
    assert fused_ffn.launches == before + 1 and y.requires_grad
    assert fused_ffn.last_route == "two_pass"
    torch.testing.assert_close(
        y.detach().float(),
        fused_ffn_ref(x.detach(), wg.detach(), wu.detach(), wd.detach(),
                      "gelu").float(), **FFN_TOL[torch.bfloat16])
    got = torch.autograd.grad(y, (x, wg, wu, wd), dy)
    want = fused_ffn_backward(x.detach(), wg.detach(), wu.detach(),
                              wd.detach(), dy, "gelu")
    assert fused_ffn.launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


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


def _conv_case(seed, b, s, h, g, p, n):
    """x, b and c as views of one bf16 conv row (the model's layout, read
    in place), dt after softplus, a < 0, on the card."""
    gen = torch.Generator().manual_seed(seed)
    conv = torch.randn(b, s, h * p + 2 * g * n, generator=gen)
    conv[..., h * p:] *= n ** -0.25
    conv = conv.to(torch.bfloat16).cuda()
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen) - 1.0).cuda()
    a = -torch.exp(torch.randn(h, generator=gen) * 0.5).cuda()
    return x, dt, a, bm, cm


def _k6_checked(args, init=None, out_dtype=None):
    """One call of K6's wgmma route: one launch, a bit-for-bit repeat, a
    CUDA graph replay equal to the eager call, and the plain version
    within SSD_TOL (y in its dtype; f32 y against the plain version on
    f32 x) and STATE_TOL."""
    from repro_torch.kernels.ssd_scan import ssd_plan
    x, dt, a, bm, cm = args
    bsz, s, h, p = x.shape
    assert ssd_plan(x.dtype, bsz, s, h, p, bm.shape[3],
                    256).route == "wgmma"

    def call():
        return ssd_scan(x, dt, a, bm, cm, chunk=256, initial_state=init,
                        out_dtype=out_dtype)

    before = ssd_scan.launches
    y, st = call()
    assert ssd_scan.launches == before + 1
    y2, st2 = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        yg, sg = call()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert torch.equal(y, yg) and torch.equal(st, sg)
    f32_y = out_dtype == torch.float32
    yr, sr = ssd_scan_ref(x.float() if f32_y else x, dt, a, bm, cm,
                          chunk=256, initial_state=init)
    assert y.dtype == (out_dtype or x.dtype)
    torch.testing.assert_close(y, yr.to(y.dtype), **SSD_TOL[y.dtype])
    torch.testing.assert_close(st, sr, **STATE_TOL)
    return y, st


# (B, S, H, G, P, N): the served calls (mamba2-370m's burst and one
# prompt, zamba2-1.2b's prefill, ragged prefill and train step)
K6_SERVED = [(8, 2048, 32, 1, 64, 128), (1, 2048, 32, 1, 64, 128),
             (8, 1024, 64, 1, 64, 64), (8, 1000, 64, 1, 64, 64),
             (4, 1024, 64, 1, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K6_SERVED, ids=str)
def test_k6_wgmma_served_shapes(cuda, shape):
    _k6_checked(_conv_case(sum(shape), *shape))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [32, 64])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("out", [None, torch.float32])
def test_k6_wgmma_every_head_and_state_dim(cuda, p, n, out):
    _k6_checked(_conv_case(p + n, 2, 257, 4, 1, p, n), out_dtype=out)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 4, 8])
def test_k6_wgmma_groups(cuda, g):
    """G 1, 4 (two heads a group) and G = H (ops.ssd's grouping)."""
    _k6_checked(_conv_case(g, 2, 1000, 8, g, 64, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 16, 200, 255, 256, 257, 1000, 4096])
@pytest.mark.parametrize("with_state", [False, True])
def test_k6_wgmma_lengths_and_initial_state(cuda, s, with_state):
    """Below one tile, ragged, the chunk split's edges and 16 chunks,
    with and without an initial state carried through the chain."""
    args = _conv_case(s, 2, s, 4, 1, 64, 128)
    init = (torch.randn(2, 4, 64, 128, generator=torch.Generator()
                        .manual_seed(s)).cuda() if with_state else None)
    _k6_checked(args, init=init)


@pytest.mark.gpu
def test_k6_wgmma_ops_ssd_layout(cuda):
    """ops.ssd's layout (BH, S, P): transposed views, one head a group,
    f32 y, against ref.ssd_scan_kernel_ref on f32 x."""
    x, dt, a, b, c = _conv_case(9, 1, 512, 6, 6, 32, 128)
    kx, kdt = x[0].transpose(0, 1), dt[0].transpose(0, 1)
    kb, kc = b[0].transpose(0, 1), c[0].transpose(0, 1)
    before = ssd_scan.launches
    y, st = ops.ssd(kx, kdt, a, kb, kc, chunk=128)
    y2, st2 = ops.ssd(kx, kdt, a, kb, kc, chunk=128)
    assert ssd_scan.launches == before + 2
    yr, sr = ssd_scan_kernel_ref(kx.float(), kdt, a, kb, kc, 128)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert y.dtype == torch.float32 and y.shape == kx.shape
    torch.testing.assert_close(y, yr, **SSD_TOL[torch.float32])
    torch.testing.assert_close(st, sr, **STATE_TOL)


@pytest.mark.gpu
def test_k6_f32_takes_the_cuda_core_route(cuda, monkeypatch):
    """f32 inputs never reach the wgmma entry."""
    import importlib
    k6 = importlib.import_module("repro_torch.kernels.ssd_scan")
    assert k6.ssd_plan(torch.float32, 2, 300, 4, 64, 64, 256).route == \
        "cuda_cores"

    def refuse():
        raise AssertionError("f32 reached the wgmma route")

    monkeypatch.setattr(k6, "_wg_fn", refuse)
    args = _ssd(5, 2, 300, 4, 1, 64, 64, torch.float32)
    y, st = ssd_scan(*args, chunk=256)
    yr, sr = ssd_scan_ref(*args, chunk=256)
    torch.testing.assert_close(y, yr, **SSD_TOL[torch.float32])


@pytest.mark.gpu
def test_k6_wgmma_refuses_what_tma_cannot_read(cuda):
    """A view whose base is off 16 bytes, a conv row whose stride is not a
    multiple of 16 bytes, and a bf16 chunk above 256 rows raise
    ValueError; nothing falls back."""
    x, dt, a, bm, cm = _conv_case(3, 2, 256, 4, 1, 64, 64)
    before = ssd_scan.launches
    flat = torch.zeros(2 * 256 * 384 + 8, dtype=torch.bfloat16,
                       device="cuda")
    off = flat[1:1 + 2 * 256 * 384].view(2, 256, 6, 64)[:, :, :4]
    with pytest.raises(ValueError):
        ssd_scan(off, dt, a, bm, cm, chunk=256)
    odd = torch.zeros(2, 256, 388, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        ssd_scan(odd[..., :256].unflatten(-1, (4, 64)), dt, a, bm, cm,
                 chunk=256)
    with pytest.raises(ValueError):
        ssd_scan(*_conv_case(5, 1, 600, 4, 1, 64, 64), chunk=512)
    assert ssd_scan.launches == before


@pytest.mark.gpu
def test_k6_wgmma_autograd_forward_equals_no_grad(cuda):
    """_SsdScan's forward launches the same kernel: bit for bit the
    no-grad call."""
    x, dt, a, bm, cm = _conv_case(4, 2, 512, 8, 1, 64, 64)
    with torch.no_grad():
        y0, s0 = ssd_scan(x, dt, a, bm, cm, chunk=256)
    xg = x.detach().clone().requires_grad_()
    y1, s1 = ssd_scan(xg, dt, a, bm, cm, chunk=256)
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_op_on_card(cuda, dtype):
    """K3's custom operator ``repro_torch::fused_ffn`` on the card: one
    launch, the plain version's output within FFN_TOL, and the gradients
    of ``fused_ffn_backward`` on the same inputs, bit for bit."""
    x, wg, wu, wd = (t.detach().requires_grad_()
                     for t in _ffn(13, 128, 256, 1024, dtype))
    dy = torch.randn(128, 256, generator=torch.Generator().manual_seed(2)
                     ).to(dtype).cuda()
    before = fused_ffn.launches
    y = torch.ops.repro_torch.fused_ffn(x, wg, wu, wd, "gelu")
    assert fused_ffn.launches == before + 1 and y.requires_grad
    torch.testing.assert_close(
        y.detach().float(),
        fused_ffn_ref(x.detach(), wg.detach(), wu.detach(), wd.detach(),
                      "gelu").float(), **FFN_TOL[dtype])
    got = torch.autograd.grad(y, (x, wg, wu, wd), dy)
    want = fused_ffn_backward(x.detach(), wg.detach(), wu.detach(),
                              wd.detach(), dy, "gelu")
    assert fused_ffn.launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w)


@pytest.mark.gpu
def test_recomputation_gradients_on_card(cuda):
    """The reduced hybrid (5 layers, period 2: two periods closed by the
    shared block, one leftover layer) in bf16 activations over f32
    weights: one train step's loss and gradients under ``dots`` and
    ``full`` equal ``none``'s bit for bit, and each backward relaunches
    the regions' K6 and K2, and K3 under ``full`` only."""
    from repro_torch.launch.steps import loss_and_grads
    cfg = get_config("zamba2-1.2b").reduced(num_layers=5).with_updates(
        shared_attn_period=2)
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    batch = {"tokens": toks.cuda(), "labels": toks.roll(-1, 1).cuda()}
    fwd = (5, 2, 2)                  # K6, K2, K3 a forward
    extra = {"none": (0, 0, 0), "dots": (4, 2, 0), "full": (4, 2, 2)}
    kernels = (ssd_scan, flash_attention, fused_ffn)
    out = {}
    for remat, more in extra.items():
        before = [k.launches for k in kernels]
        out[remat] = loss_and_grads(params, cfg, RuntimeOptions(remat=remat),
                                    batch)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == [
            a + b for a, b in zip(fwd, more)], remat
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for (k, a), (_, b) in zip(_flat(out[remat][1]),
                                  _flat(out["none"][1])):
            assert torch.equal(a, b), (remat, k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flat(v, f"{prefix}{k}/")]
    return [(prefix, tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,p,n", [(64, 64, 64), (32, 64, 128)])
def test_ssd_scan_grads_on_card(cuda, dtype, h, p, n):
    """K6 under autograd at the trainer's shape (4 x 1024, zamba2-1.2b's
    H 64, P 64, N 64 and mamba2-370m's H 32, P 64, N 128; G 1, chunk 256;
    x, b and c views of one conv row): one launch, and the gradients of
    the row, dt and a equal autograd through the plain scan on the card
    (both differentiate the same f32 graph: f32 within 1e-4, bf16 row
    gradients within one bf16 ulp, 2e-2 / 1e-2)."""
    gen = torch.Generator().manual_seed(h + n)
    bsz, s = 4, 1024
    row = (torch.randn(bsz, s, h * p + 2 * n, generator=gen) * 0.5).to(
        dtype).cuda().requires_grad_()
    dt = torch.nn.functional.softplus(torch.randn(
        bsz, s, h, generator=gen) - 1.0).cuda().requires_grad_()
    a = (-torch.exp(torch.randn(h, generator=gen) * 0.5)).cuda() \
        .requires_grad_()
    x = row[..., :h * p].reshape(bsz, s, h, p)
    bm = row[..., h * p:h * p + n].reshape(bsz, s, 1, n)
    cm = row[..., h * p + n:].reshape(bsz, s, 1, n)
    dy = torch.randn(x.shape, generator=gen).to(dtype).cuda()
    dst = torch.randn((bsz, h, p, n), generator=gen).cuda()
    before = ssd_scan.launches
    y, st = ssd_scan(x, dt, a, bm, cm, chunk=256)
    assert ssd_scan.launches == before + 1 and y.grad_fn is not None
    got = torch.autograd.grad([y, st], [row, dt, a], [dy, dst])
    assert ssd_scan.launches == before + 1          # backward: no launch
    yr, sr = ssd_scan_ref(x.float(), dt, a, bm, cm, chunk=256)
    want = torch.autograd.grad([yr.to(dtype), sr], [row, dt, a], [dy, dst])
    for name, g, w in zip(("row", "dt", "a"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = (dict(atol=2e-2, rtol=1e-2) if g.dtype == torch.bfloat16
               else dict(atol=1e-4, rtol=1e-4))
        torch.testing.assert_close(g, w, **tol, msg=name)


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


# ------------------------------------------------ profiler ranking (P6) --
@pytest.mark.gpu
def test_profiler_ranks_reference_ladder_by_device_time(cuda):
    """The card twin of ``test_profiler_calibration.py``: the reference's
    ladder of paper-backbone variants (full, width 0.75, width 0.5 at
    depth 0.75 and 0.5; bf16 weights, tokens 2 x 256) ranked by its
    ``H100_SXM`` estimates (eps 0.5) against each forward's device time
    (the profiler's kernel sum over 20 calls) meets the reference's bar,
    ``rank_consistency >= 0.79``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (H100_SXM, estimate_latency, layer_costs,
                                  rank_consistency)
    from repro_torch.elastic import VariantSpec, derive_variant
    from repro_torch.models import forward
    from repro_torch.models.layers import cast_params
    cfg = get_config("paper-backbone")
    params = cast_params(init_params(cfg, seed=0, device="cuda"),
                         torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int32)).cuda()
    ladder = (dict(), dict(width_ratio=0.75),
              dict(width_ratio=0.5, depth_ratio=0.75),
              dict(width_ratio=0.5, depth_ratio=0.5))
    est, dev = [], []
    for kw in ladder:
        vcfg, vparams = derive_variant(cfg, params, VariantSpec(**kw))
        est.append(estimate_latency(layer_costs(vcfg, 2, 256), 0.5,
                                    H100_SXM))
        with torch.no_grad():
            forward(vparams, vcfg, tokens)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    forward(vparams, vcfg, tokens)
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in kernels if "flash_attn" in e.key) \
            == 20 * vcfg.num_layers
        dev.append(sum(e.self_device_time_total for e in kernels))
    rho = rank_consistency(est, dev)
    assert rho >= 0.79, f"profiler ranking broke: est={est} dev={dev}"
